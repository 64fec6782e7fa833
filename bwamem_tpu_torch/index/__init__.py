from bwamem_tpu_torch.index.build import build_index
from bwamem_tpu_torch.index.fmindex import BwaIndex


def _npz_matches_bwt(prefix: str) -> bool:
    """Cheap consistency check: the native .bt.npz sidecar may be stale
    relative to reference-format files sharing the prefix (e.g. the .bwt was
    regenerated for a different genome).  Compare primary/seq_len from the
    .bwt header (first 40 bytes, bwt.c:385-394) against the npz metadata."""
    import json
    import numpy as np
    try:
        with open(prefix + ".bwt", "rb") as f:
            hdr = np.fromfile(f, dtype=np.uint64, count=5)
        z = np.load(prefix + ".bt.npz")
        meta = json.loads(bytes(z["meta"]).decode())
        return (int(hdr[0]) == meta["primary"]
                and int(hdr[4]) == meta["seq_len"])
    except Exception:
        return False


def load_index(prefix: str) -> BwaIndex:
    """bwa_idx_load (bwa.c:488-509): shared-memory fast path when the
    prefix was staged with `shm` (by either package), else disk.  Accepts
    either the native .bt.npz or a stock bwa .pac/.ann/.amb/.bwt/.sa
    prefix; when both exist the native sidecar is used only if consistent
    with the .bwt."""
    import os
    import sys
    from bwamem_tpu_torch.index import shm
    idx = shm.load_staged(prefix)
    if idx is not None:
        return idx
    have_npz = os.path.exists(prefix + ".bt.npz")
    have_ref = os.path.exists(prefix + ".bwt")
    if have_npz and have_ref and not _npz_matches_bwt(prefix):
        sys.stderr.write(f"[load_index] {prefix}.bt.npz is inconsistent "
                         "with the .bwt alongside it; using the reference-"
                         "format files\n")
        have_npz = False
    if have_npz:
        return BwaIndex.load(prefix)
    if have_ref:
        return BwaIndex.load_reference_format(prefix)
    raise FileNotFoundError(
        f"no index at {prefix} (.bt.npz or .pac/.ann/.amb/.bwt/.sa)")


__all__ = ["build_index", "BwaIndex", "load_index"]
