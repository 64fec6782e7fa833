"""Paired-end read merging — `pemerge` subcommand.

Byte-equivalent reimplementation of the reference's main_pemerge
(pemerge.c:59-291): each pair is tested with an unbanded local SW of the
reverse-complemented read2 against read1 (ksw_align with
xtra = KSW_XSTART | KSW_XSUBO, pemerge.c:79-80), the overlap is validated
(score threshold, overhang geometry, second-best ratio, gap-free, tandem
test, error sum), and passing pairs are merged base-by-base with
quality-weighted consensus (pemerge.c:108-132).

Device reorganization: the per-pair ksw_align calls — the compute — run as
ONE batched dispatch per lane tile on the caller's device
(ops.local_sw.ksw_align_batch), and the reference's O(n^2) tandem-match scan
(pemerge.c:89-106, its own "TODO: SSE2 ... bottleneck") is one vectorized
diagonal-sum per pair instead of a scalar double loop.  The branchy
per-pair merge stays host-side.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from bwamem_tpu_torch.config import fill_scmat
from bwamem_tpu_torch.io.fastq import Read

MAX_SCORE_RATIO = 0.9
MAX_ERR = 8

ERR_MSG = [
    "successful merges",
    "low-scoring pairs",
    "pairs where the best SW alignment is not an overlap (long left end)",
    "pairs where the best SW alignment is not an overlap (long right end)",
    "pairs with large 2nd best SW score",
    "pairs with gapped overlap",
    "pairs where the end-to-end alignment is inconsistent with SW",
    "pairs potentially with tandem overlaps",
    "pairs with high sum of errors",
]


@dataclasses.dataclass
class PemOptions:
    """pem_opt_t (pemerge.c:34-57)."""
    a: int = 5
    b: int = 4
    q: int = 2          # gap open
    r: int = 17         # gap extension
    w: int = 20
    q_def: int = 20
    q_thres: int = 70
    T: int = 50         # a * min_ovlp
    chunk_size: int = 10000000
    n_threads: int = 1
    flag: int = 3       # bit 1: print merged; 2: print unmerged

    @property
    def mat(self) -> np.ndarray:
        return fill_scmat(self.a, self.b)


def _prep_pair(opt: PemOptions, x0: Read, x1: Read):
    """nt4 + qual arrays; read2 reverse-complemented (pemerge.c:65-77)."""
    s0 = np.asarray(x0.seq, np.uint8)
    q0 = (np.frombuffer(x0.qual.encode(), np.uint8).astype(np.int32) - 33
          if x0.qual else np.full(len(s0), opt.q_def, np.int32))
    s1f = np.asarray(x1.seq, np.uint8)[::-1]
    s1 = np.where(s1f < 4, 3 - s1f.astype(np.int32), 4).astype(np.uint8)
    q1 = (np.frombuffer(x1.qual.encode(), np.uint8)[::-1].astype(np.int32)
          - 33 if x1.qual else np.full(len(s1), opt.q_def, np.int32))
    return s0, q0, s1, q1


def _tandem_test(opt: PemOptions, s0: np.ndarray, s1: np.ndarray,
                 mat: np.ndarray, r_tb: int, r_qb: int) -> int:
    """The O(n^2) tandem-overlap scan (pemerge.c:89-106) as diagonal sums:
    m(l) = sum_{i<l} mat[s1[i], s0[L0-l+i]] is the trace of diagonal
    d = L0 - l of the pair score matrix."""
    L0, L1 = len(s0), len(s1)
    min_l = min(L0, L1)
    if min_l <= 1:
        return -6
    sc = mat[s1[:min_l - 1, None].astype(np.intp),
             s0[None, :].astype(np.intp)].astype(np.int64)
    # T[i, l] = sc[i, L0-l+i]; column l is overlap length l (i < l only,
    # automatic: i >= l would index column >= L0)
    ms = np.zeros(min_l, np.int64)
    for l in range(1, min_l):
        o = L0 - l
        ms[l] = np.trace(sc, offset=o)
    max_m = max_m2 = 0
    max_l = max_l2 = 0
    for l in range(1, min_l):
        m = int(ms[l])
        if m > max_m:
            max_m2, max_m = max_m, m
            max_l2, max_l = max_l, l
        elif m > max_m2:
            max_m2, max_l2 = m, l
    if max_m < opt.T or max_l != L0 - (r_tb - r_qb):
        return -6
    if max_l2 < max_l and max_m2 >= opt.T and \
            (max_m2 + (max_l - max_l2) * opt.a) / max_m >= MAX_SCORE_RATIO:
        return -7
    if max_l2 > max_l and max_m2 / max_m >= MAX_SCORE_RATIO:
        return -7
    return 0


def merge_pair(opt: PemOptions, x0: Read, x1: Read, r) -> int:
    """bwa_pemerge tail given the SW result (pemerge.c:81-144).
    r: (score, tb, te, qb, qe, score2) half-open te/qe.  On success mutates
    x0 into the merged read and empties x1; returns 0, else -err."""
    s0, q0, s1, q1 = _prep_pair(opt, x0, x1)
    score, tb, te, qb, qe, score2 = r
    if score < opt.T:
        return -1
    if tb < qb:
        return -2
    if len(s0) - te > len(s1) - qe:
        return -3
    if score2 > 0 and score2 / score >= MAX_SCORE_RATIO:
        return -4
    if qe - qb != te - tb:
        return -5
    ret = _tandem_test(opt, s0, s1, opt.mat, tb, qb)
    if ret < 0:
        return ret

    l = len(s0) - (tb - qb)             # length to merge
    l_seq = len(s0) + len(s1) - l
    seq = np.concatenate([s0, s1[l:]]).astype(np.int32)
    qual = np.concatenate([q0, q1[l:]]).astype(np.int32)
    o = len(s0) - l
    a0, b0 = s0[o:].astype(np.int32), q0[o:]
    a1, b1 = s1[:l].astype(np.int32), q1[:l]
    # consensus (pemerge.c:114-128), vectorized
    amb0 = a0 == 4
    amb1 = a1 == 4
    same = (a0 == a1) & ~amb0 & ~amb1
    diff = ~amb0 & ~amb1 & ~same
    mseq = np.where(amb0, a1, a0)
    # q0 > q1 keeps s0; ties go to s1 (pemerge.c:125)
    mseq = np.where(diff & ~(b0 > b1), a1, mseq)
    mqual = b0.copy()
    mqual = np.where(amb0, b1, mqual)
    mqual = np.where(same, np.maximum(b0, b1), mqual)
    mqual = np.where(diff, np.abs(b0 - b1), mqual)
    qq = np.minimum(b0, b1)[diff]
    sum_q = int(np.where(qq >= 3, qq << 1, 1).sum())
    if sum_q >> 1 > opt.q_thres:
        return -8
    seq[o:len(s0)] = mseq
    qual[o:len(s0)] = mqual

    x0.seq = seq.astype(np.uint8)
    x0.qual = bytes((qual + 33).astype(np.uint8)).decode("latin-1")
    assert len(x0.seq) == l_seq
    x1.seq = np.zeros(0, np.uint8)
    x1.qual = None
    return 0


def _batched_sw(opt: PemOptions, pairs: list[tuple[Read, Read]], device):
    """One ksw_align per pair, batched on `device` (pemerge.c:79-80:
    query = revcomp read2, target = read1, i16 kernel => stripe 8)."""
    import torch
    from bwamem_tpu_torch.ops import local_sw
    from bwamem_tpu_torch.pipeline import _shapes

    B = len(pairs)
    preps = [_prep_pair(opt, a, b) for a, b in pairs]
    lq = max(max(len(p[2]) for p in preps), 1)
    lt = max(max(len(p[0]) for p in preps), 1)
    p_stripe = 8
    LQ = -(-max(lq, 32) // p_stripe) * p_stripe
    LT = max(lt, 32)
    out = np.zeros((B, 6), np.int64)

    def put(a):
        return torch.from_numpy(a).to(device)

    for s0_, c in _shapes.chunks(B, tile=_shapes.lane_tile(device)):
        Bp = _shapes.lanes(c, device, fine_lo=8, coarse_lo=64)
        q = np.full((Bp, LQ), 4, np.uint8)
        t = np.full((Bp, LT), 4, np.uint8)
        qlen = np.zeros(Bp, np.int32)
        tlen = np.zeros(Bp, np.int32)
        for bi in range(c):
            s0, _, s1, _ = preps[s0_ + bi]
            q[bi, :len(s1)] = s1
            t[bi, :len(s0)] = s0
            qlen[bi], tlen[bi] = len(s1), len(s0)
        res = local_sw.ksw_align_batch(
            put(q), put(qlen), put(t), put(tlen), put(np.zeros(Bp, np.int32)),
            opt.mat, o_del=opt.q, e_del=opt.r, o_ins=opt.q, e_ins=opt.r,
            max_mat=opt.a, p=p_stripe)
        arr = torch.stack([res.score, res.tb, res.te, res.qb, res.qe,
                           res.score2], dim=1).cpu().numpy()
        out[s0_:s0_ + c] = arr[:c]
    # ++r.qe; ++r.te (half-open, pemerge.c:81)
    out[:, 2] += 1
    out[:, 4] += 1
    return out


def process_pairs(opt: PemOptions, pairs: list[tuple[Read, Read]],
                  cnt: list[int], device) -> None:
    """process_seqs (pemerge.c:176-215): merge in place, count outcomes.
    timers: pemerge.sw (the batched SW, fetched), pemerge.merge."""
    from bwamem_tpu_torch.utils import timers
    if not pairs:
        return
    with timers.section("pemerge.sw"):
        sw = _batched_sw(opt, pairs, device)
    with timers.section("pemerge.merge"):
        for p, (x0, x1) in enumerate(pairs):
            ret = merge_pair(opt, x0, x1, tuple(int(v) for v in sw[p]))
            cnt[-ret] += 1


FWD = "ACGTN"


def print_read(r: Read, rn: int, out) -> None:
    """print_bseq (pemerge.c:147-158)."""
    out.write("@" if r.qual else ">")
    out.write(r.name)
    if rn in (1, 2):
        out.write(f"/{rn}\n")
    else:
        out.write(" merged\n")
    out.write("".join(FWD[b] for b in r.seq))
    out.write("\n")
    if r.qual:
        out.write("+\n")
        out.write(r.qual)
        out.write("\n")


def run_pemerge(opt: PemOptions, pair_iter, out=None, err=None,
                device=None) -> list[int]:
    """Driver: chunked pair batches -> batched SW on `device` ("cuda" when
    None; raises without a GPU) -> merge -> print."""
    from bwamem_tpu_torch.pipeline.align import resolve_device
    device = resolve_device(device)
    out = out or sys.stdout
    err = err or sys.stderr
    cnt = [0] * (MAX_ERR + 1)
    buf: list[tuple[Read, Read]] = []
    buf_bp = 0

    def flush():
        nonlocal buf, buf_bp
        process_pairs(opt, buf, cnt, device)
        for x0, x1 in buf:
            if x1.l_seq != 0:
                if opt.flag & 2:
                    print_read(x0, 1, out)
                    print_read(x1, 2, out)
            elif opt.flag & 1:
                print_read(x0, 0, out)
        buf, buf_bp = [], 0

    for x0, x1 in pair_iter:
        buf.append((x0, x1))
        buf_bp += x0.l_seq + x1.l_seq
        if buf_bp >= opt.n_threads * opt.chunk_size:
            flush()
    flush()
    err.write(f"{cnt[0]:12d} {ERR_MSG[0]}\n")
    for i in range(1, MAX_ERR + 1):
        err.write(f"{cnt[i]:12d} {ERR_MSG[i]}\n")
    return cnt
