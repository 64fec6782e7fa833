"""Low-level index micro-commands: fa2pac / pac2bwt / pac2bwtgen /
bwtupdate / bwt2sa.

File-identical reimplementations of the reference's debugging subcommands
(main.c:105-109): each step of `bwa index` exposed separately.  Formats:

  .pac        2-bit packed bases + pad byte + (l % 4) trailer
              (bns_fasta2bntseq, bntseq.c:315-327)
  .bwt (raw)  primary, L2[1..4], packed BWT words — pac2bwt output,
              unusable until bwtupdate interleaves occ counts
              (bwt_dump_bwt, bwt.c:385-394)
  .bwt (upd)  the occ-interleaved layout (bwt_bwtupdate_core,
              bwtindex.c:150-172)
  .sa         primary, L2[1..4], sa_intv, seq_len, sa[1:]
              (bwt_dump_sa, bwt.c:396-407)
"""
from __future__ import annotations

import numpy as np

from bwamem_tpu_torch.index import build as bld

OCC_INTERVAL = 128


def _write_pac(path: str, codes: np.ndarray) -> None:
    """2-bit pack + the reference's trailer convention
    (bntseq.c:315-327)."""
    pac = bld.pack_2bit(codes)
    l = len(codes)
    with open(path, "wb") as f:
        f.write(pac.tobytes())
        if l % 4 == 0:
            f.write(b"\0")
        f.write(bytes([l % 4]))


def _read_pac(path: str) -> np.ndarray:
    """pac file → nt4 codes (bwa_seq_len, bwtindex.c:51-63)."""
    raw = np.fromfile(path, dtype=np.uint8)
    seq_len = (len(raw) - 2) * 4 + int(raw[-1])
    return bld.unpack_2bit(raw, seq_len)


def _dump_bwt_raw(path: str, primary: int, L2: np.ndarray,
                  words: np.ndarray) -> None:
    with open(path, "wb") as f:
        np.asarray([primary], np.uint64).tofile(f)
        L2[1:5].astype(np.uint64).tofile(f)
        words.astype(np.uint32).tofile(f)


def _restore_bwt_raw(path: str):
    """Raw (pre-bwtupdate) .bwt → (primary, L2, words)
    (bwt_restore_bwt, bwt.c:443-461)."""
    with open(path, "rb") as f:
        primary = int(np.fromfile(f, np.uint64, 1)[0])
        l2_tail = np.fromfile(f, np.uint64, 4).astype(np.int64)
        words = np.fromfile(f, np.uint32)
    L2 = np.zeros(5, np.int64)
    L2[1:] = l2_tail
    return primary, L2, words


def fa2pac(fasta: str, prefix: str, for_only: bool = False) -> None:
    """bwa fa2pac (bntseq.c:335-353): default appends the reverse
    complement (the .ann/.amb headers then carry the DOUBLED l_pac, exactly
    like the reference's in-memory bns at dump time)."""
    fwd, contigs, ambs = bld.pack_fasta(fasta)
    l_fwd = len(fwd)
    codes = fwd if for_only else np.concatenate([fwd, 3 - fwd[::-1]])
    _write_pac(prefix + ".pac", codes)
    l_hdr = l_fwd if for_only else 2 * l_fwd
    with open(prefix + ".ann", "w") as f:
        f.write(f"{l_hdr} {len(contigs)} 11\n")
        for c in contigs:
            anno = c.anno if c.anno else "(null)"
            f.write(f"{c.gi} {c.name} {anno}\n")
            f.write(f"{c.offset} {c.len} {c.n_ambs}\n")
    with open(prefix + ".amb", "w") as f:
        f.write(f"{l_hdr} {len(contigs)} {len(ambs)}\n")
        for a in ambs:
            f.write(f"{a.offset} {a.len} {a.amb}\n")


def pac2bwt(pac_path: str, bwt_path: str) -> None:
    """bwa pac2bwt (bwtindex.c:64-147).  The BWT of a string is unique, so
    the -d (ropebwt) construction flag only selects an algorithm in the
    reference; we always build via SA-IS."""
    codes = _read_pac(pac_path)
    sa = bld.suffix_array(codes)
    bwt, primary, _ = bld.bwt_from_sa(codes, sa)
    counts = np.bincount(codes, minlength=4).astype(np.int64)
    L2 = np.zeros(5, np.int64)
    np.cumsum(counts, out=L2[1:])
    _dump_bwt_raw(bwt_path, primary, L2, bld.pack_bwt_words(bwt))


def bwtupdate(bwt_path: str) -> None:
    """bwa bwtupdate (bwtindex.c:150-186): insert occ checkpoints every 128
    bases, in place."""
    primary, L2, words = _restore_bwt_raw(bwt_path)
    seq_len = int(L2[4])
    bwt = bld.unpack_bwt_words(words, seq_len)
    occ = bld.occ_checkpoints(bwt)
    n = seq_len
    n_words = (n + 15) >> 4
    n_ckpt = (n + OCC_INTERVAL - 1) // OCC_INTERVAL + 1
    out = np.zeros(n_words + n_ckpt * 8, dtype=np.uint32)
    occ64 = occ.astype(np.uint64)
    k = w = 0
    for b in range(n_ckpt - 1):
        out[k:k + 8] = occ64[b].view(np.uint32)
        k += 8
        w_end = min(w + 8, n_words)
        out[k:k + (w_end - w)] = words[w:w_end]
        k += w_end - w
        w = w_end
    out[k:k + 8] = occ64[n_ckpt - 1].view(np.uint32)
    _dump_bwt_raw(bwt_path, primary, L2, out)


def bwt2sa(bwt_path: str, sa_path: str, sa_intv: int = 32) -> None:
    """bwa bwt2sa (bwtindex.c:188-208 + bwt_cal_sa, bwt.c:62-84): sampled
    suffix array from the (updated) .bwt via the inverse-Psi walk."""
    with open(bwt_path, "rb") as f:
        primary = int(np.fromfile(f, np.uint64, 1)[0])
        l2_tail = np.fromfile(f, np.uint64, 4).astype(np.int64)
        inter = np.fromfile(f, np.uint32)
    L2 = np.zeros(5, np.int64)
    L2[1:] = l2_tail
    seq_len = int(L2[4])
    # de-interleave (load_reference_format's .bwt logic)
    n_words = (seq_len + 15) >> 4
    nb = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    words = np.zeros(n_words, np.uint32)
    k = w = 0
    for b in range(nb):
        k += 8
        w_end = min(w + 8, n_words)
        words[w:w_end] = inter[k:k + (w_end - w)]
        k += w_end - w
        w = w_end
    bwt = bld.unpack_bwt_words(words, seq_len)
    # vectorized inverse-Psi table over ranks [0, seq_len]:
    # ipsi[k] = L2[B[kk]] + rank_B(kk) + 1 with kk = k - (k > primary);
    # ipsi[primary] = 0 (bwt_invPsi, bwt.c:53-59)
    excl = np.zeros(seq_len, np.int64)
    for c in range(4):
        hits = bwt == c
        r = np.cumsum(hits) - 1
        excl[hits] = r[hits]
    vals = L2[bwt] + excl + 1
    ipsi = np.empty(seq_len + 1, np.int64)
    ipsi[: primary] = vals[: primary]
    ipsi[primary] = 0
    ipsi[primary + 1:] = vals[primary:]
    # the walk (bwt_cal_sa): isa starts at rank of the full suffix
    n_sa = (seq_len + sa_intv) // sa_intv
    sa = np.zeros(n_sa, np.uint64)
    isa = 0
    sa_val = seq_len
    ipl = ipsi.tolist()          # list indexing ~3x faster than np scalar
    for _ in range(seq_len):
        if isa % sa_intv == 0:
            sa[isa // sa_intv] = sa_val
        sa_val -= 1
        isa = ipl[isa]
    if isa % sa_intv == 0:
        sa[isa // sa_intv] = sa_val
    sa[0] = np.uint64(0xFFFFFFFFFFFFFFFF)       # (bwtint_t)-1, bwt.c:82
    with open(sa_path, "wb") as f:
        np.asarray([primary], np.uint64).tofile(f)
        L2[1:5].astype(np.uint64).tofile(f)
        np.asarray([sa_intv, seq_len], np.uint64).tofile(f)
        sa[1:].tofile(f)
