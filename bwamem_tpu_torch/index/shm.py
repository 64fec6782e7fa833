"""Shared-memory index staging — the `shm` subcommand.

Analog of the reference's POSIX-shm index sharing (bwashm.c:12-213) and the
single-blob index serialization pair bwa_idx2mem/bwa_mem2idx
(bwa.c:373-467): `bwamem_tpu shm <prefix>` flattens the loaded index into
ONE contiguous blob under /dev/shm, and every subsequent index load in any
process memory-maps it — the kernel shares the physical pages, so N
concurrent aligner processes hold one copy of the index in RAM and cold
loads skip all parsing/decompression.

Blob layout: magic, u64 header length, JSON header (scalars, contig/amb
tables, per-array dtype/shape/offset), then 64-byte-aligned raw array
bytes.  This doubles as the idx2mem format: `pack_bytes`/`unpack` work on
any bytes-like object, not just shm files.

The format, the key of a prefix and BWAMEM_TPU_SHM_DIR are those of the JAX
package's index/shm.py, so a blob staged by either package loads in the
other.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from bwamem_tpu_torch.index.fmindex import AmbRun, BwaIndex, Contig

MAGIC = b"BWTSHM01"
SHM_DIR = os.environ.get("BWAMEM_TPU_SHM_DIR", "/dev/shm/bwamem_tpu")

_ARRAYS = ("L2", "bwt_words", "occ", "sa_samples", "pac",
           "kmer_x0", "kmer_x1", "kmer_size")


def _key(prefix: str) -> str:
    """One shm segment per absolute index prefix (bwa_shm_stage keys by
    basename, bwashm.c:52; the absolute path avoids collisions)."""
    return os.path.abspath(prefix).replace("/", "%") + ".shm"


def _meta(idx: BwaIndex) -> dict:
    return dict(
        l_pac=idx.l_pac, seq_len=idx.seq_len, primary=idx.primary,
        sa_intv=idx.sa_intv,
        contig_names=[c.name for c in idx.contigs],
        contig_annos=[c.anno for c in idx.contigs],
        contig_offsets=[c.offset for c in idx.contigs],
        contig_lens=[c.len for c in idx.contigs],
        contig_n_ambs=[c.n_ambs for c in idx.contigs],
        contig_is_alt=[c.is_alt for c in idx.contigs],
        amb_offsets=[a.offset for a in idx.ambs],
        amb_lens=[a.len for a in idx.ambs],
        amb_chars=[a.amb for a in idx.ambs],
    )


def pack_bytes(idx: BwaIndex) -> bytes:
    """bwa_idx2mem analog (bwa.c:373-440): index -> one contiguous blob."""
    arrays = dict(L2=idx.L2, bwt_words=idx.bwt_words, occ=idx.occ,
                  sa_samples=idx.sa_samples, pac=idx.pac)
    if idx.kmer_table is not None:
        arrays.update(kmer_x0=idx.kmer_table[0], kmer_x1=idx.kmer_table[1],
                      kmer_size=idx.kmer_table[2])
    meta = _meta(idx)
    specs = {}
    pos = 0
    blobs = []
    for name in _ARRAYS:
        if name not in arrays:
            continue
        a = np.ascontiguousarray(arrays[name])
        pos = (pos + 63) & ~63
        specs[name] = dict(dtype=a.dtype.str, shape=list(a.shape),
                           offset=pos)
        blobs.append((pos, a))
        pos += a.nbytes
    meta["arrays"] = specs
    hdr = json.dumps(meta).encode()
    head = MAGIC + np.uint64(len(hdr)).tobytes() + hdr
    base = (len(head) + 63) & ~63
    out = bytearray(base + pos)
    out[:len(head)] = head
    for off, a in blobs:
        out[base + off: base + off + a.nbytes] = a.tobytes()
    return bytes(out)


def unpack(buf, copy: bool = False) -> BwaIndex:
    """bwa_mem2idx analog (bwa.c:442-467): blob -> index, arrays as
    zero-copy views into `buf` (np.memmap or bytes) unless copy=True."""
    mv = memoryview(buf)
    if bytes(mv[:8]) != MAGIC:
        raise ValueError("not a bwamem_tpu shm blob")
    hlen = int(np.frombuffer(mv[8:16], np.uint64)[0])
    meta = json.loads(bytes(mv[16:16 + hlen]).decode())
    base = (16 + hlen + 63) & ~63
    arr = {}
    for name, spec in meta["arrays"].items():
        dt = np.dtype(spec["dtype"])
        n = int(np.prod(spec["shape"], dtype=np.int64))
        off = base + spec["offset"]
        a = np.frombuffer(mv[off: off + n * dt.itemsize], dt).reshape(
            spec["shape"])
        arr[name] = a.copy() if copy else a
    contigs = [Contig(name=n, anno=a, offset=o, len=l, n_ambs=na, is_alt=al)
               for n, a, o, l, na, al in zip(
                   meta["contig_names"], meta["contig_annos"],
                   meta["contig_offsets"], meta["contig_lens"],
                   meta["contig_n_ambs"], meta["contig_is_alt"])]
    ambs = [AmbRun(offset=o, len=l, amb=c) for o, l, c in zip(
        meta["amb_offsets"], meta["amb_lens"], meta["amb_chars"])]
    kmer = None
    if "kmer_x0" in arr:
        kmer = (arr["kmer_x0"], arr["kmer_x1"], arr["kmer_size"])
    return BwaIndex(l_pac=meta["l_pac"], seq_len=meta["seq_len"],
                    primary=meta["primary"], L2=arr["L2"],
                    bwt_words=arr["bwt_words"], occ=arr["occ"],
                    sa_samples=arr["sa_samples"], sa_intv=meta["sa_intv"],
                    pac=arr["pac"], contigs=contigs, ambs=ambs,
                    kmer_table=kmer)


def stage(prefix: str, force: bool = False) -> str:
    """bwa_shm_stage (bwashm.c:33-98): load from disk, write the blob under
    SHM_DIR atomically.  Returns the blob path."""
    path = os.path.join(SHM_DIR, _key(prefix))
    if os.path.exists(path) and not force:
        return path
    idx = BwaIndex.load(prefix)
    os.makedirs(SHM_DIR, exist_ok=True)
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(pack_bytes(idx))
    os.replace(tmp, path)
    return path


def test(prefix: str) -> bool:
    """bwa_shm_test (bwashm.c:100-126): is this prefix staged?"""
    return os.path.exists(os.path.join(SHM_DIR, _key(prefix)))


def load_staged(prefix: str) -> Optional[BwaIndex]:
    """Memory-mapped load when staged, else None (the bwa_idx_load shm
    fast path, bwa.c:488-509)."""
    path = os.path.join(SHM_DIR, _key(prefix))
    if not os.path.exists(path):
        return None
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    return unpack(mm)


def list_staged() -> list[str]:
    """bwa_shm_list (bwashm.c:128-149)."""
    if not os.path.isdir(SHM_DIR):
        return []
    return sorted(k[:-4].replace("%", "/")
                  for k in os.listdir(SHM_DIR) if k.endswith(".shm"))


def destroy(prefix: Optional[str] = None) -> int:
    """bwa_shm_destroy (bwashm.c:151-177); prefix=None drops everything."""
    n = 0
    if not os.path.isdir(SHM_DIR):
        return 0
    for k in os.listdir(SHM_DIR):
        if not k.endswith(".shm"):
            continue
        if prefix is None or k == _key(prefix):
            os.unlink(os.path.join(SHM_DIR, k))
            n += 1
    return n
