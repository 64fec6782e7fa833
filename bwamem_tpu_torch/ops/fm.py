"""FM-index primitives as batched tensor ops.

The reference computes occ() one rank at a time with 64-bit popcount tricks
inside each thread (bwt.c:98-220).  Here the same math is a batched gather
of one combined occ-checkpoint + BWT-block row per query, followed by
vectorized 2-bit-match popcounts — no per-element loops.

Layout (built by bwamem_tpu_torch.index.build):
  bwt  : uint32 [n_blocks, 8]   — 128 bases per block, base i of word w at
                                  bit (15-(i&15))*2 (same packing as bwt.h:74)
  occ  : it    [n_blocks+1, 4]  — counts of each base in B[0:128*b)
  L2   : it    [5]              — cumulative symbol counts, C() array
  sa   : it    [n_sa]           — SA_full[r] for r % sa_intv == 0
`it` is int32 for seq_len < 2^31 (small genomes) else int64 — the reference
always uses uint64 (bwtint_t, bwt.h:46).

Unsigned 32-bit words (the combined rows, the packed reference) are held in
int64 tensors: PyTorch implements no shifts or bitwise NOT on uint32 on the
CPU, and has no popcount, so counting is a SWAR popcount on the int64
words — the same code on the CPU and the GPU.

Conventions match the reference exactly:
  * occ4(k) counts B[0..k] INCLUSIVE with the $-position adjustment
    k -= (k >= primary) and occ4(-1) == 0 (bwt_occ4, bwt.c:169-186);
  * extend() is the bidirectional bwt_extend (bwt.c:262-275): intervals are
    (x0, x1, size) triples; is_back=False extends the match on the RIGHT via
    the reverse-complement coordinate x1 (callers pass c = 3 - base).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

OCC_INTV_SHIFT = 7
OCC_INTERVAL = 128
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FM:
    """Device FM-index.

    cmb packs the occ checkpoint row AND the 128-base BWT block into ONE
    row so every occ query is a single gather.  Layout per row (uint32
    values in int64):
      words 0-3   occ counts of A/C/G/T in B[0 : 128*b)  (low 32 bits)
      words 4-11  the 2-bit-packed BWT block
      words 12-15 (i64 indexes only) high 32 bits of the occ counts
    """
    cmb: torch.Tensor        # int64 [nb, 12] (or [nb, 16] when i64)
    L2: torch.Tensor         # it [5]
    sa: torch.Tensor         # it [n_sa]
    pac: torch.Tensor        # int64 [ceil(l_pac/16)] packed forward 2-bit ref
    primary: int
    seq_len: int
    l_pac: int
    # optional k-mer-12 fast-start table [4^12, 3] it (x0, x1, size): the
    # bi-interval after the first 12 forward extensions of an SMEM search.
    kmer: torch.Tensor | None = None
    sa_intv: int = 32        # power of two
    i64: bool = False        # 64-bit occ counts (genomes >= 2^31)

    @property
    def itype(self) -> torch.dtype:
        return self.L2.dtype

    @property
    def device(self) -> torch.device:
        return self.cmb.device


def _host_arrays(idx) -> dict:
    """BwaIndex -> the FM's arrays as numpy (the reference package's FM
    leaves, field for field)."""
    it = idx.itype
    i64 = it == np.int64
    nb = (idx.seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
    words = np.zeros((nb, 8), dtype=np.uint32)
    flat = idx.bwt_words
    words.reshape(-1)[: len(flat)] = flat
    occ = idx.occ[:nb].astype(np.uint64)
    cols = [occ.astype(np.uint32), words]
    if i64:
        cols.append((occ >> 32).astype(np.uint32))
    cmb = np.concatenate(cols, axis=1)
    pac_bytes = np.concatenate(
        [idx.pac, np.zeros((-len(idx.pac)) % 4, dtype=np.uint8)])
    kmer = None
    if idx.kmer_table is not None:
        x0, x1, sz = idx.kmer_table
        kmer = np.stack([x0.astype(it), x1.astype(it), sz.astype(it)],
                        axis=1)
    return dict(cmb=cmb, L2=idx.L2.astype(it), sa=idx.sa_samples.astype(it),
                primary=np.asarray(idx.primary, it),
                seq_len=np.asarray(idx.seq_len, it),
                l_pac=np.asarray(idx.l_pac, it), pac=pac_bytes.view(np.uint32),
                kmer=kmer, sa_intv=idx.sa_intv, i64=i64)


def fm_from_arrays(arrays: dict, device) -> FM:
    """FM from numpy arrays keyed by the FM field names (cmb, L2, sa,
    primary, seq_len, l_pac, pac, kmer, sa_intv, i64) — the layout of the
    reference package's FM, so both packages can be shown to hold the same
    index."""
    dev = torch.device(device)
    it = torch.int64 if bool(arrays["i64"]) else torch.int32

    def words(a):
        return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64)
                                ).to(dev)

    def ints(a):
        return torch.from_numpy(np.array(a)).to(dev, it)

    kmer = arrays.get("kmer")
    return FM(cmb=words(arrays["cmb"]), L2=ints(arrays["L2"]),
              sa=ints(arrays["sa"]), pac=words(arrays["pac"]),
              primary=int(arrays["primary"]), seq_len=int(arrays["seq_len"]),
              l_pac=int(arrays["l_pac"]),
              kmer=None if kmer is None else ints(kmer),
              sa_intv=int(arrays["sa_intv"]), i64=bool(arrays["i64"]))


def fm_from_index(idx, device) -> FM:
    """Host BwaIndex -> FM tensors on `device`."""
    return fm_from_arrays(_host_arrays(idx), device)


_WORD_OFFS = torch.arange(8, dtype=torch.int64) * 16  # base offset per word


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of non-negative 32-bit values held in int64 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _prefix_mask(m: torch.Tensor) -> torch.Tensor:
    """Word masks [..., 8] keeping the first m bases of a 128-base block."""
    cnt = (m[..., None] - _WORD_OFFS.to(m.device)).clamp(0, 16)
    shift = ((16 - cnt) * 2).clamp(0, 31)
    full = torch.full_like(shift, _M32)
    return torch.where(cnt == 0, torch.zeros_like(shift),
                       (full << shift) & _M32)


def _block_counts(words: torch.Tensor, m: torch.Tensor, it) -> torch.Tensor:
    """Counts of each base among the first `m` bases of a 128-base block.

    words: int64 [..., 8]; m: int [...] in [0, 128].  Returns it [..., 4].
    """
    m = m.to(torch.int64)
    w = words & _prefix_mask(m)
    outs = []
    for c in range(4):
        y1 = w if c & 2 else ~w
        y0 = w if c & 1 else ~w
        match = (y1 >> 1) & y0 & 0x55555555
        outs.append(popcount32(match).sum(-1).to(it))
    outs[0] = outs[0] - (128 - m).to(it)  # masked-out zero bits read as A
    return torch.stack(outs, dim=-1)


def _row(fm: FM, blk: torch.Tensor):
    """ONE combined-row gather -> (occ_base it [...,4], bwt words [...,8])."""
    row = fm.cmb[blk]
    if fm.i64:
        base = (row[..., 12:16] << 32) | row[..., :4]
    else:
        base = row[..., :4]
    return base.to(fm.itype), row[..., 4:12]


def _select4(vals: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """vals[..., c] for a per-lane index c (a gather along the last axis)."""
    return torch.gather(vals, -1, c.to(torch.int64)[..., None])[..., 0]


def occ4(fm: FM, k: torch.Tensor) -> torch.Tensor:
    """Counts of each base in B[0..k] inclusive; k == -1 -> 0.  [..., 4]."""
    valid = k >= 0
    kk = k - (k >= fm.primary).to(k.dtype)
    kk = kk.clamp(0, fm.seq_len - 1).to(torch.int64)
    base, words = _row(fm, kk >> OCC_INTV_SHIFT)
    m = (kk & (OCC_INTERVAL - 1)) + 1
    out = base + _block_counts(words, m, fm.itype)
    return torch.where(valid[..., None], out, torch.zeros_like(out))


def extend(fm: FM, x0, x1, x2, is_back: bool):
    """Bidirectional interval extension for all 4 symbols at once
    (bwt_extend, bwt.c:262-275).

    Returns (n0, n1, ns) each [..., 4] indexed by symbol c; the caller picks
    c = base for backward extension or c = 3 - base for forward extension.
    """
    it = fm.itype
    p = x0 if is_back else x1
    other = x1 if is_back else x0
    tkl = occ4(fm, torch.stack([p - 1, p - 1 + x2]))
    tk, tl = tkl[0], tkl[1]
    ns = tl - tk
    crosses = ((p <= fm.primary) & (p + x2 - 1 >= fm.primary)).to(it)
    o3 = other + crosses
    o2 = o3 + ns[..., 3]
    o1 = o2 + ns[..., 2]
    o0 = o1 + ns[..., 1]
    new_p = fm.L2[:4] + 1 + tk
    new_other = torch.stack([o0, o1, o2, o3], dim=-1)
    if is_back:
        return new_p, new_other, ns
    return new_other, new_p, ns


def set_intv(fm: FM, c: torch.Tensor):
    """Initial single-base interval (bwt_set_intv, bwt.h:82).  c in [0,3]."""
    ci = c.to(torch.int64)
    l2c = fm.L2[ci]
    x0 = l2c + 1
    x2 = fm.L2[ci + 1] - l2c
    x1 = fm.L2[3 - ci] + 1
    return x0, x1, x2


def bwt_b0(fm: FM, x: torch.Tensor) -> torch.Tensor:
    """Character of the $-removed BWT at position x (bwt_B0, bwt.h:80)."""
    x = x.to(torch.int64)
    _, words = _row(fm, x >> OCC_INTV_SHIFT)
    word = _select4(words, (x >> 4) & 7)
    return ((word >> (((~x) & 15) << 1)) & 3).to(torch.int32)


def inv_psi(fm: FM, k: torch.Tensor) -> torch.Tensor:
    """Inverse-Psi step (bwt_invPsi, bwt.c:53-59): ONE combined-row gather
    serves both the BWT character and its occ count.  Only the count of the
    BWT character c at kk is needed: XOR the packed words with c replicated
    into every 2-bit lane, so positions equal to c become 00, and count the
    00 pairs."""
    it = fm.itype
    kk = k - (k >= fm.primary).to(k.dtype)
    kk = kk.clamp(0, fm.seq_len - 1).to(torch.int64)
    base, words = _row(fm, kk >> OCC_INTV_SHIFT)
    word = _select4(words, (kk >> 4) & 7)
    c = (word >> (((~kk) & 15) << 1)) & 3
    m = (kk & (OCC_INTERVAL - 1)) + 1
    w = words & _prefix_mask(m)
    t = ~(w ^ (c * 0x55555555)[..., None])  # 2-bit lanes equal to c -> 11
    m00 = (t >> 1) & t & 0x55555555
    occ_c = popcount32(m00).sum(-1).to(it)
    # masked-out (zeroed) positions read as symbol 0 and were counted
    occ_c = occ_c - torch.where(c == 0, (128 - m).to(it),
                                torch.zeros((), dtype=it, device=k.device))
    o = _select4(base, c) + occ_c
    res = fm.L2[:4][c] + o
    return torch.where(k == fm.primary, torch.zeros_like(res),
                       res).to(k.dtype)


def sa_lookup(fm: FM, k: torch.Tensor, chunk: int | None = None
              ) -> torch.Tensor:
    """Batched suffix-array lookup: masked inverse-Psi walk to the nearest
    sampled rank (bwt_sa, bwt.c:86-96).  The samples are taken by RANK, so
    a walk's length is not bounded by sa_intv: lanes advance in lockstep
    with per-lane done masks, `chunk` (default sa_intv - 1) masked trips at
    a time, and the host looks at the done mask once per chunk."""
    mask = fm.sa_intv - 1
    log2_intv = fm.sa_intv.bit_length() - 1
    step = max(chunk or mask, 1)
    kk = k
    t = torch.zeros_like(k)
    while True:
        for _ in range(step):
            act = (kk & mask) != 0
            kk = torch.where(act, inv_psi(fm, kk), kk)
            t = t + act.to(kk.dtype)
        if not bool(((kk & mask) != 0).any()):
            break
    samp = fm.sa[(kk >> log2_intv).to(torch.int64)]
    return (t + samp) % (fm.seq_len + 1)


# ---------- reference sequence access (bns_get_seq equivalents) ----------

def pac_base(fm: FM, pos: torch.Tensor) -> torch.Tensor:
    """Forward-strand base at pos from the packed 2-bit reference
    (_get_pac, bntseq.c:230; word-level for vectorized gathers).

    pac bytes were reinterpreted as little-endian uint32, so byte b of word w
    is at bits 8*(b&3); within a byte, base (pos&3) sits at bits
    (3-(pos&3))*2.
    """
    pos = pos.to(torch.int64)
    word = fm.pac[pos >> 4]
    byte = (word >> (((pos & 15) >> 2) << 3)) & 0xFF
    return ((byte >> ((3 - (pos & 3)) << 1)) & 3).to(torch.int32)


def ref_base(fm: FM, pos: torch.Tensor) -> torch.Tensor:
    """Base at a both-strands coordinate in [0, 2*l_pac): forward strand for
    pos < l_pac, reverse-complement otherwise (bns_get_seq, bntseq.c:403)."""
    is_rev = pos >= fm.l_pac
    fpos = torch.where(is_rev, 2 * fm.l_pac - 1 - pos, pos)
    b = pac_base(fm, fpos)
    return torch.where(is_rev, 3 - b, b)


def pos2rid(ctg_offsets: torch.Tensor, pos_f: torch.Tensor) -> torch.Tensor:
    """Forward-strand position -> contig id (bns_pos2rid, bntseq.c:354-368)."""
    return (torch.searchsorted(ctg_offsets, pos_f.to(ctg_offsets.dtype),
                               right=True) - 1).to(torch.int32)


def depos(l_pac: int, pos: torch.Tensor):
    """Both-strands coordinate -> (forward position, is_rev)
    (bns_depos, bntseq.h:87)."""
    is_rev = pos >= l_pac
    return torch.where(is_rev, 2 * l_pac - 1 - pos, pos), is_rev


def intv2rid(fm: FM, ctg_offsets: torch.Tensor, rb: torch.Tensor,
             re: torch.Tensor) -> torch.Tensor:
    """Interval -> contig id; -2 if it bridges the forward/reverse boundary,
    -1 if it spans two contigs (bns_intv2rid, bntseq.c:370-378)."""
    pb, _ = depos(fm.l_pac, rb)
    pe, _ = depos(fm.l_pac, re - 1)
    rid_b = pos2rid(ctg_offsets, pb)
    rid_e = torch.where(rb < re, pos2rid(ctg_offsets, pe), rid_b)
    rid = torch.where(rid_b == rid_e, rid_b, torch.full_like(rid_b, -1))
    return torch.where((rb < fm.l_pac) & (re > fm.l_pac),
                       torch.full_like(rid, -2), rid)
