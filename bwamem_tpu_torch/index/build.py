"""Index construction: FASTA → pac / BWT / occ checkpoints / SA samples.

Host-side (NumPy) one-time construction, equivalent to `bwa index`
(reference bwtindex.c:209-323 + bntseq.c:232-333 + bwt.c:42-84).  Produces
bit-identical .pac/.ann/.amb/.bwt/.sa files to the reference for the same
FASTA (including the seeded lrand48 N→random-base replacement), plus a
de-interleaved layout (separate packed-BWT words and occ
checkpoint arrays) used by the device kernels.

The BWT is built over the concatenation of the forward and reverse-complement
strands (seq_len = 2*l_pac), which is what gives bwa's single index its
bidirectional-search capability (bwt_extend, bwt.c:262-275).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from bwamem_tpu_torch.index.fmindex import BwaIndex, Contig, AmbRun

OCC_INTERVAL = 128
SA_INTERVAL = 32        # the reference's on-disk stride (bwt_cal_sa(bwt,32))
KMER_K = 12


def runtime_sa_interval(seq_len: int) -> int:
    """SA sample stride for OUR index (.bt.npz).  The device SA lookup is a
    lockstep inverse-Psi walk of up to sa_intv-1 steps (ops/fm.sa_lookup) and
    was the most expensive seeding op at the reference's stride of 32
    (bwt.c:62-84) — denser samples trade HBM for a 4-8x shorter walk.  The
    .sa FILE keeps stride 32 for bit-parity (save_reference_format
    subsamples).  Policy: densest power-of-two stride >= 4 whose table stays
    under ~1 GB of device memory."""
    for intv in (4, 8, 16, 32):
        if (seq_len // intv + 1) * 8 <= (1 << 30):
            return intv
    return SA_INTERVAL

# nst_nt4_table semantics (bntseq.c:46): A/a→0 C/c→1 G/g→2 T/t→3, else 4
_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _NT4[ord(_c)] = _i
    _NT4[ord(_c.lower())] = _i


class Lrand48:
    """POSIX drand48-family LCG; add1 (bntseq.c:266) replaces each N with
    lrand48()&3 after srand48(11) (bntseq.c:295-296).  Emulated so our pac
    is bit-identical to the reference's."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int = 11):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def next_batch(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.int64)
        x = self.x
        for i in range(n):
            x = (self.A * x + self.C) & self.MASK
            out[i] = x >> 17
        self.x = x
        return out


def parse_fasta(path: str):
    """Yield (name, comment, seq_bytes) per record."""
    name = comment = None
    chunks: list[bytes] = []
    opener = open
    if path.endswith(".gz"):
        import gzip
        opener = gzip.open
    with opener(path, "rb") as f:
        for line in f:
            line = line.rstrip()
            if line.startswith(b">"):
                if name is not None:
                    yield name, comment, b"".join(chunks)
                hdr = line[1:].split(None, 1)
                name = hdr[0].decode()
                comment = hdr[1].decode() if len(hdr) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        yield name, comment, b"".join(chunks)


def pack_fasta(path: str):
    """FASTA → forward-strand nt4 codes + contig/amb metadata.

    Equivalent to bns_fasta2bntseq/add1 (bntseq.c:232-333): N (and any
    non-ACGT) recorded as an ambiguity run and replaced by a seeded-random
    base in the packed sequence.
    """
    rng = Lrand48(11)
    contigs: list[Contig] = []
    ambs: list[AmbRun] = []
    parts: list[np.ndarray] = []
    offset = 0
    for name, comment, seq in parse_fasta(path):
        raw = np.frombuffer(seq, dtype=np.uint8)
        codes = _NT4[raw]
        ambi = codes >= 4
        n_amb_runs = 0
        if ambi.any():
            # runs of identical ambiguous characters (add1 merges only
            # *identical* consecutive ambiguity letters, bntseq.c:249)
            idx = np.flatnonzero(ambi)
            brk = np.flatnonzero((np.diff(idx) != 1) |
                                 (raw[idx[1:]] != raw[idx[:-1]])) + 1
            starts = np.concatenate([[0], brk])
            ends = np.concatenate([brk, [len(idx)]])
            for s, e in zip(starts, ends):
                ambs.append(AmbRun(offset=offset + int(idx[s]),
                                   len=int(e - s), amb=chr(raw[idx[s]])))
            n_amb_runs = len(starts)
            # seeded random replacement, in sequence order
            codes = codes.copy()
            codes[idx] = (rng.next_batch(len(idx)) & 3).astype(np.uint8)
        contigs.append(Contig(name=name, anno=comment or "", offset=offset,
                              len=len(seq), n_ambs=n_amb_runs, is_alt=False))
        parts.append(codes)
        offset += len(seq)
    fwd = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
    return fwd, contigs, ambs


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """nt4 codes (must be <4) → reference .pac byte layout: base i at bits
    ((~i & 3) << 1) of byte i>>2 (bntseq.c:229)."""
    n = len(codes)
    pad = (-n) % 4
    c = np.concatenate([codes, np.zeros(pad, dtype=np.uint8)]).reshape(-1, 4)
    return (c[:, 0] << 6 | c[:, 1] << 4 | c[:, 2] << 2 | c[:, 3]).astype(np.uint8)


def unpack_2bit(pac: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_2bit: the first n nt4 codes of a .pac byte array."""
    b = pac[: (n + 3) // 4]
    out = np.empty(len(b) * 4, dtype=np.uint8)
    out[0::4] = b >> 6 & 3
    out[1::4] = b >> 4 & 3
    out[2::4] = b >> 2 & 3
    out[3::4] = b & 3
    return out[:n]


def suffix_array(t: np.ndarray) -> np.ndarray:
    """Suffix array of t (codes) with implicit terminal sentinel smaller than
    all symbols; returns ranks→positions for the n real suffixes (the sentinel
    suffix is NOT included).  Prefix-doubling (Manber–Myers) in NumPy; a
    native SA-IS drop-in lives in index/native for large genomes."""
    n = len(t)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    try:
        from bwamem_tpu_torch.index import native
        if native.available():
            return native.suffix_array_sais(np.ascontiguousarray(t, np.uint8))
    except Exception:
        pass  # no compiler / load failure: NumPy path below
    rank = t.astype(np.int64)
    k = 1
    tmp = np.full(n, -1, dtype=np.int64)
    while True:
        tmp[:] = -1
        if k < n:
            tmp[: n - k] = rank[k:]
        order = np.lexsort((tmp, rank))
        r1 = rank[order]
        r2 = tmp[order]
        changed = np.empty(n, dtype=np.int64)
        changed[0] = 0
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank = np.cumsum(changed)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank
        if new_rank[-1] == n - 1 or k >= n:
            return order
        k <<= 1


_CHUNK = 1 << 26      # streaming block for giga-scale builds (0.5 GB i64)


def suffix_array_full(t: np.ndarray) -> np.ndarray:
    """SA over ranks 0..n of the sentinel-terminated text: [0] == n (the
    sentinel suffix), [1:] == suffix_array(t).  The native SA-IS buffer
    already has exactly this layout, so giga-scale builds avoid an
    n-sized int64 copy."""
    n = len(t)
    try:
        from bwamem_tpu_torch.index import native
        if n and native.available():
            return native.suffix_array_sais(
                np.ascontiguousarray(t, np.uint8), full=True)
    except Exception:
        pass
    sa_full = np.empty(n + 1, dtype=np.int64)
    sa_full[0] = n
    sa_full[1:] = suffix_array(t)
    return sa_full


def _bwt_from_sa_full(t: np.ndarray, sa_full: np.ndarray):
    """(bwt, primary) from the full rank array, chunked, no big copies."""
    n = len(t)
    primary = int(np.flatnonzero(sa_full == 0)[0])
    bwt = np.empty(n, dtype=np.uint8)
    for s in range(0, n + 1, _CHUNK):
        blk = sa_full[s: s + _CHUNK]
        prev = blk - 1                       # BWT char = t[SA[r]-1]
        if s == 0:
            prev[0] = n - 1                  # rank 0 → t[n-1]
        vals = t[prev]                       # prev == -1 only at primary
        ranks = np.arange(s, s + len(blk), dtype=np.int64)
        out = ranks - (ranks > primary)      # np.delete(x, primary) slots
        keep = ranks != primary
        bwt[out[keep]] = vals[keep]
    return bwt, primary


def bwt_from_sa(t: np.ndarray, sa: np.ndarray):
    """BWT string (sentinel removed) + primary + SA_full, matching is_bwt
    (reference is.c:208-223): BWT over ranks 0..n of the sentinel-terminated
    text, with the rank whose suffix starts at 0 (the sentinel output
    position, `primary`) removed."""
    n = len(t)
    sa_full = np.empty(n + 1, dtype=np.int64)
    sa_full[0] = n          # sentinel suffix is rank 0
    sa_full[1:] = sa
    return (*_bwt_from_sa_full(t, sa_full), sa_full)


def pack_bwt_words(bwt: np.ndarray) -> np.ndarray:
    """BWT codes → uint32 words, base i at bits ((15-(i&15))<<1) of word i>>4
    (reference bwt.h:74-80 layout, occ-interleave removed).  Chunked: the
    one-shot u32 widening was a 4x-sized temporary at giga-scale."""
    n = len(bwt)
    nw = (n + 15) // 16
    out = np.empty(nw, dtype=np.uint32)
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    step = _CHUNK           # multiple of 16
    for s in range(0, nw, step // 16):
        b = bwt[s * 16: s * 16 + step]
        pad = (-len(b)) % 16
        if pad:
            b = np.concatenate([b, np.zeros(pad, dtype=np.uint8)])
        c = b.astype(np.uint32).reshape(-1, 16)
        out[s: s + len(c)] = (c << shifts).sum(axis=1, dtype=np.uint32)
    return out


def unpack_bwt_words(words: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_bwt_words: uint32 words → n BWT codes."""
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    c = (words[:, None] >> shifts[None, :]) & 3
    return c.reshape(-1)[:n].astype(np.uint8)


def occ_checkpoints(bwt: np.ndarray) -> np.ndarray:
    """[n_blocks+1, 4] cumulative counts of each base before every
    OCC_INTERVAL-base block (de-interleaved bwt_bwtupdate_core,
    bwtindex.c:150-172)."""
    n = len(bwt)
    nb = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    pad = nb * OCC_INTERVAL - n
    b = np.concatenate([bwt, np.full(pad, 255, dtype=np.uint8)])
    per_block = np.zeros((nb, 4), dtype=np.int64)
    blocks = b.reshape(nb, OCC_INTERVAL)
    for c in range(4):
        per_block[:, c] = (blocks == c).sum(axis=1)
    ckpt = np.zeros((nb + 1, 4), dtype=np.int64)
    np.cumsum(per_block, axis=0, out=ckpt[1:])
    return ckpt


def build_kmer_table(sa_full: np.ndarray, t: np.ndarray, k: int = KMER_K):
    """Precomputed first-k-bases bidirectional intervals (x0, x1, size) per
    k-mer code (equivalent of kmers_index/hashKMer.hpp:58-81, built directly
    from the suffix array instead of 4^k FM extensions).

    Interval convention matches bwt_set_intv (bwt.h:82): x0 = first rank in
    SA_full of a suffix starting with the k-mer (sentinel is rank 0, so
    ranks are ≥1); x1 = same for the reverse-complement k-mer; size = count.
    """
    n = len(t)
    if n < k:
        z = np.zeros(4 ** k, dtype=np.int64)
        return z, z.copy(), z.copy()
    # Group ranks by code: suffixes sharing a k-mer prefix are contiguous
    # in rank order, so the per-code first rank (x0) and count (size) can
    # be accumulated streaming over rank blocks — the old formulation
    # materialized four n-sized int64 arrays (codes, rank_codes, vr, vc),
    # ~60 GB at 1 Gbp.
    x0 = np.zeros(4 ** k, dtype=np.int64)
    size = np.zeros(4 ** k, dtype=np.int64)
    t64 = t  # u8; gathered per chunk
    for s in range(0, n + 1, _CHUNK):
        blk = sa_full[s: s + _CHUNK]
        validm = blk <= n - k
        pos = blk[validm]
        if pos.size == 0:
            continue
        code = np.zeros(pos.size, dtype=np.int64)
        for i in range(k):
            code = code * 4 + t64[pos + i]
        ranks = s + np.flatnonzero(validm)
        uniq, first_idx, counts = np.unique(code, return_index=True,
                                            return_counts=True)
        new = size[uniq] == 0
        x0[uniq[new]] = ranks[first_idx[new]]
        size[uniq] += counts
    # x1 = x0 of reverse-complement code
    digits = np.arange(4 ** k, dtype=np.int64)
    rc = np.zeros(4 ** k, dtype=np.int64)
    for _ in range(k):
        rc = rc * 4 + (3 - digits % 4)
        digits //= 4
    x1 = x0[rc]
    return x0, x1, size


def build_index(fasta_path: str, with_kmer_table: bool = False,
                sa_interval: int | None = None) -> BwaIndex:
    fwd, contigs, ambs = pack_fasta(fasta_path)
    l_pac = len(fwd)
    both = np.concatenate([fwd, 3 - fwd[::-1]])  # + reverse complement
    pac = pack_2bit(fwd)
    del fwd
    sa_full = suffix_array_full(both)
    bwt, primary = _bwt_from_sa_full(both, sa_full)
    counts = np.bincount(both, minlength=4).astype(np.int64)
    l2 = np.zeros(5, dtype=np.int64)
    np.cumsum(counts, out=l2[1:])

    n = len(both)
    if sa_interval is None:
        sa_interval = runtime_sa_interval(n)
    sa_samples = sa_full[::sa_interval].copy()  # ranks 0, intv, 2*intv, ...

    kmer = None
    if with_kmer_table:
        kmer = build_kmer_table(sa_full, both)
    del sa_full, both
    bwt_words = pack_bwt_words(bwt)
    occ = occ_checkpoints(bwt)
    del bwt

    idx = BwaIndex(
        l_pac=l_pac,
        seq_len=n,
        primary=primary,
        L2=l2,
        bwt_words=bwt_words,
        occ=occ,
        sa_samples=sa_samples,
        sa_intv=sa_interval,
        pac=pac,
        contigs=contigs,
        ambs=ambs,
        kmer_table=kmer,
    )
    return idx
