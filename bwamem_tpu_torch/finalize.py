"""Host-side single-end finalization of device alignment regions.

The device front half (pipeline.device_front) produces per-read region
lists; everything after that in the reference is
branchy per-read logic over a handful of records, which we keep on host:

  * mem_sort_dedup_patch   (reference bwamem.c:444-496) incl. mem_patch_reg
    colinear split-hit merging (:413-443),
  * mem_mark_primary_se    (:500-565) with hash_64 tie-breaking
    (utils.h:97-108) and the two-round ALT handling,
  * mem_approx_mapq_se     (:962-986),
  * mem_reg2aln            (:1099-1169) — band inference + band-doubling
    retries; the banded global DP runs batched in the native host kernel
    (native.ksw_global_batch, phase B), everything else here (phase A/C),
  * NM/MD computation      (bwa_gen_cigar2, bwa.c:311-341),
  * mem_gen_alt XA strings (bwamem_extra.c:117-170),
  * mem_reg2sam record selection (:1013-1059).

The split is deliberate: phase A walks reads and emits a flat list of
global-alignment jobs (primary/supplementary/XA), phase B executes them as
one or two native batches (band-doubling retry re-batches the rare failing
jobs), phase C renders SAM text.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from bwamem_tpu_torch.config import (MemOptions, MEM_F_ALL, MEM_F_NO_MULTI,
                               MEM_F_SOFTCLIP, MEM_F_KEEP_SUPP_MAPQ,
                               MEM_F_PRIMARY5)

INT_MAX = 2**31 - 1
PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90


def hash_64(key: int) -> int:
    """64-bit mix (reference utils.h:97-108)."""
    M = (1 << 64) - 1
    key = (key + (~(key << 32) & M)) & M
    key ^= key >> 22
    key = (key + (~(key << 13) & M)) & M
    key ^= key >> 8
    key = (key + (key << 3)) & M
    key ^= key >> 15
    key = (key + (~(key << 27) & M)) & M
    key ^= key >> 31
    return key


@dataclasses.dataclass(slots=True)
class AlnReg:
    """mem_alnreg_t (reference bwa.h:145-163).  slots: ~10k instances are
    built per batch in the replay hot path; slotted dataclasses construct
    ~2x faster and halve the per-instance memory."""
    rb: int = 0
    re: int = 0
    qb: int = 0
    qe: int = 0
    rid: int = -1
    score: int = 0
    truesc: int = 0
    sub: int = 0
    alt_sc: int = 0
    csub: int = 0
    sub_n: int = 0
    w: int = 0
    seedcov: int = 0
    secondary: int = -1
    secondary_all: int = -1
    seedlen0: int = 0
    n_comp: int = 1
    is_alt: int = 0
    frac_rep: float = 0.0
    hash: int = 0


# ---------------------------------------------------------------- ref fetch

def get_seq_np(pac: np.ndarray, l_pac: int, rb: int, re: int) -> np.ndarray:
    """Both-strands reference fetch (bns_get_seq, bntseq.c:403-424):
    forward 2-bit pac below l_pac, reverse-complement above."""
    if rb >= re or re > 2 * l_pac:
        return np.zeros(0, np.uint8)
    if rb >= l_pac:
        fb, fe = 2 * l_pac - re, 2 * l_pac - rb
        pos = np.arange(fe - 1, fb - 1, -1, dtype=np.int64)
        comp = True
    else:
        pos = np.arange(rb, min(re, l_pac), dtype=np.int64)
        comp = False
    b = (pac[pos >> 2] >> (((~pos) & 3) << 1).astype(np.uint8)) & 3
    return (3 - b).astype(np.uint8) if comp else b.astype(np.uint8)


def get_seq_many(pac: np.ndarray, l_pac: int, rb: np.ndarray,
                 re: np.ndarray) -> list[np.ndarray]:
    """Batched get_seq_np over many [rb, re) windows: ONE flat pac gather
    for all windows (per-window np.arange/gather overhead dominated
    CigarJob.prepare in the batch profile).  Positionally, base i of window
    w is the both-strands base at rb[w]+i — identical to get_seq_np for
    windows that do not straddle l_pac (asserted upstream: an AlnReg never
    straddles)."""
    rb = np.asarray(rb, np.int64)
    lens = np.asarray(re, np.int64) - rb
    lens = np.maximum(lens, 0)
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    total = int(off[-1])
    if total == 0:
        return [np.zeros(0, np.uint8) for _ in lens]
    pos = np.arange(total, dtype=np.int64) + np.repeat(rb - off[:-1], lens)
    is_rev = pos >= l_pac
    fpos = np.where(is_rev, 2 * l_pac - 1 - pos, pos)
    fpos = np.clip(fpos, 0, l_pac - 1)
    b = (pac[fpos >> 2] >> (((~fpos) & 3) << 1).astype(np.uint8)) & 3
    flat = np.where(is_rev, 3 - b, b).astype(np.uint8)
    return [flat[off[w]:off[w + 1]] for w in range(len(lens))]


# ------------------------------------------------- host banded global score

def ksw_global_score_np(q: np.ndarray, t: np.ndarray, w: int,
                        mat: np.ndarray, o_del: int, e_del: int,
                        o_ins: int, e_ins: int) -> int:
    """Score-only ksw_global2 (ksw.c:504-587) in NumPy rows; used by
    mem_patch_reg, which only needs the score."""
    NEGI = -0x40000000
    qlen, tlen = len(q), len(t)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    col = np.arange(qlen, dtype=np.int64)
    H = np.full(qlen + 1, NEGI, np.int64)
    E = np.full(qlen + 1, NEGI, np.int64)
    H[0] = 0
    jmax = min(qlen, w)
    H[1:jmax + 1] = -(o_ins + e_ins * np.arange(1, jmax + 1))
    mrow = mat.astype(np.int64)
    for i in range(tlen):
        beg, end = max(i - w, 0), min(i + w + 1, qlen)
        if beg >= end:
            continue
        qp = mrow[t[i], q]
        m = H[:qlen] + qp
        e = E[:qlen]
        A = np.where((col >= beg) & (col < end), m + e_ins * col, NEGI)
        G = np.maximum.accumulate(A)
        Gp = np.concatenate([[NEGI], G[:-1]])
        F = np.where(Gp <= NEGI // 2, NEGI, Gp - oe_ins - e_ins * col + e_ins)
        h = np.maximum(np.maximum(m, e), F)
        e_new = np.maximum(e - e_del, m - oe_del)
        h1 = -(o_del + e_del * (i + 1)) if beg == 0 else NEGI
        H[beg + 1:end + 1] = h[beg:end]
        H[beg] = h1
        E[beg:end] = e_new[beg:end]
        if end <= qlen:
            E[end] = NEGI
    return int(H[qlen])


def _gen_cigar_band(opt: MemOptions, l_query: int, rlen: int, w_: int) -> int:
    """The inner band of bwa_gen_cigar2 (bwa.c:292-300)."""
    max_ins = int((((l_query + 1) >> 1) * opt.a - opt.o_ins) / opt.e_ins + 1.)
    max_del = int((((l_query + 1) >> 1) * opt.a - opt.o_del) / opt.e_del + 1.)
    max_gap = max(max_ins, max_del, 1)
    w = (max_gap + abs(rlen - l_query) + 1) >> 1
    w = min(w, w_)
    min_w = abs(rlen - l_query) + 3
    return max(w, min_w)


def mem_patch_reg(opt: MemOptions, pac: np.ndarray, l_pac: int,
                  query: np.ndarray, a: AlnReg, b: AlnReg):
    """Colinear split-hit merge test (bwamem.c:413-443).  Returns
    (score, w) if the merged global alignment is good, else None.
    pac=None disables patching (mem_matesw's dedup call,
    bwamem_pair.c:203 passes bns=0)."""
    if pac is None:
        return None
    assert a.rid == b.rid and a.rb <= b.rb
    if a.rb < l_pac and b.rb >= l_pac:
        return None
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return None
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:
        if w > opt.w << 1 or r >= PATCH_MAX_R_BW:
            return None
    elif w > opt.w << 2 or r >= PATCH_MAX_R_BW * 2:
        return None
    w += a.w + b.w
    w = min(w, opt.w << 2)
    sub_q = query[a.qb:b.qe]
    l_query = b.qe - a.qb
    rseq = get_seq_np(pac, l_pac, a.rb, b.re)
    if b.re - a.rb != len(rseq):
        return None
    if a.rb >= l_pac:
        sub_q = sub_q[::-1]
        rseq = rseq[::-1]
    wi = _gen_cigar_band(opt, l_query, len(rseq), w)
    score = ksw_global_score_np(sub_q, rseq, wi, opt.mat, opt.o_del,
                                opt.e_del, opt.o_ins, opt.e_ins)
    q_s = int(l_query / ((b.qe - b.qb) + (a.qe - a.qb))
              * (b.score + a.score) + .499)
    r_s = int((b.re - a.rb) / ((b.re - b.rb) + (a.re - a.rb))
              * (b.score + a.score) + .499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return None
    return score, w


# ----------------------------------------------------------- dedup & patch

def sort_dedup_patch(opt: MemOptions, pac: np.ndarray, l_pac: int,
                     query: np.ndarray, regs: list[AlnReg]) -> list[AlnReg]:
    """mem_sort_dedup_patch (bwamem.c:444-496)."""
    n = len(regs)
    if n <= 1:
        return regs
    a = sorted(regs, key=lambda r: r.re)             # mem_ars2: by END
    for r in a:
        r.n_comp = 1
    for i in range(1, n):
        p = a[i]
        if p.rid != a[i - 1].rid or p.rb >= a[i - 1].re + opt.max_chain_gap:
            continue
        j = i - 1
        while j >= 0 and p.rid == a[j].rid and \
                p.rb < a[j].re + opt.max_chain_gap:
            q = a[j]
            j -= 1
            if q.qe == q.qb:
                continue
            or_ = q.re - p.rb
            oq = (q.qe - p.qb) if q.qb < p.qb else (p.qe - q.qb)
            mr = min(q.re - q.rb, p.re - p.rb)
            mq = min(q.qe - q.qb, p.qe - p.qb)
            if or_ > opt.mask_level_redun * mr and \
                    oq > opt.mask_level_redun * mq:
                if p.score < q.score:
                    p.qe = p.qb
                    break
                q.qe = q.qb
            elif q.rb < p.rb:
                pr = mem_patch_reg(opt, pac, l_pac, query, q, p)
                if pr is not None:
                    score, w = pr
                    p.n_comp += q.n_comp + 1
                    p.seedcov = max(p.seedcov, q.seedcov)
                    p.sub = max(p.sub, q.sub)
                    p.csub = max(p.csub, q.csub)
                    p.qb, p.rb = q.qb, q.rb
                    p.truesc = p.score = score
                    p.w = w
                    q.qb = q.qe
    a = [r for r in a if r.qe > r.qb]
    # mem_ars: score desc, rb asc, qb asc
    a.sort(key=lambda r: (-r.score, r.rb, r.qb))
    for i in range(1, len(a)):
        if a[i].score == a[i - 1].score and a[i].rb == a[i - 1].rb and \
                a[i].qb == a[i - 1].qb:
            a[i].qe = a[i].qb
    return [r for i, r in enumerate(a) if i == 0 or r.qe > r.qb]


# --------------------------------------------------------- primary marking

def mark_primary_many(opt: MemOptions, regs_lists: list[list[AlnReg]],
                      ids: list[int]) -> list[int]:
    """mark_primary_se over many reg lists at once: single-reg lists take
    the inline fast path, multi-reg lists run in ONE native pass
    (hostops.c:mark_primary_batch).  Returns n_pri per list; lists are reordered in place like
    mark_primary_se."""
    from bwamem_tpu_torch import native
    n_lists = len(regs_lists)
    n_pri = [0] * n_lists
    multi = []
    for i, regs in enumerate(regs_lists):
        n = len(regs)
        if n == 0:
            continue
        if n == 1:
            r = regs[0]
            r.sub = r.alt_sc = 0
            r.secondary = r.secondary_all = -1
            n_pri[i] = 0 if r.is_alt else 1
        else:
            multi.append(i)
    if not multi:
        return n_pri
    off = np.zeros(len(multi) + 1, np.int64)
    np.cumsum([len(regs_lists[i]) for i in multi], out=off[1:])
    total = int(off[-1])
    score = np.empty(total, np.int32)
    qb = np.empty(total, np.int32)
    qe = np.empty(total, np.int32)
    alt = np.empty(total, np.uint8)
    for k, i in enumerate(multi):
        b0 = int(off[k])
        for j, r in enumerate(regs_lists[i]):
            score[b0 + j] = r.score
            qb[b0 + j] = r.qb
            qe[b0 + j] = r.qe
            alt[b0 + j] = r.is_alt
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    perm, sec, sec_all, sub, sub_n, alt_sc, npri = \
        native.mark_primary_batch(off, [ids[i] for i in multi], score, qb,
                                  qe, alt, tmp, opt.mask_level)
    for k, i in enumerate(multi):
        regs = regs_lists[i]
        b0 = int(off[k])
        n = len(regs)
        new = [regs[perm[b0 + j]] for j in range(n)]
        for j, r in enumerate(new):
            r.secondary = int(sec[b0 + j])
            r.secondary_all = int(sec_all[b0 + j])
            r.sub = int(sub[b0 + j])
            r.sub_n = int(sub_n[b0 + j])
            r.alt_sc = int(alt_sc[b0 + j])
        regs[:] = new
        n_pri[i] = int(npri[k])
    return n_pri


def reorder_primary5(opt: MemOptions, regs: list[AlnReg]) -> None:
    """mem_reorder_primary5 (bwamem.c:988-1010): -5 mode brings the
    leftmost-on-query primary hit to the front."""
    n_pri = sum(1 for r in regs
                if r.secondary < 0 and not r.is_alt and r.score >= opt.T)
    if n_pri <= 1:
        return
    left_st, left_k = INT_MAX, -1
    for k, p in enumerate(regs):
        if p.secondary >= 0 or p.is_alt or p.score < opt.T:
            continue
        if p.qb < left_st:
            left_st, left_k = p.qb, k
    if left_k == 0:
        return
    regs[0], regs[left_k] = regs[left_k], regs[0]
    for k in range(1, len(regs)):
        p = regs[k]
        if p.secondary == 0:
            p.secondary = left_k
        elif p.secondary == left_k:
            p.secondary = 0
        if p.secondary_all == 0:
            p.secondary_all = left_k
        elif p.secondary_all == left_k:
            p.secondary_all = 0


# ------------------------------------------------------------------- mapq

def approx_mapq_se(opt: MemOptions, a: AlnReg) -> int:
    """mem_approx_mapq_se (bwamem.c:962-986)."""
    sub = a.sub if a.sub else opt.min_seed_len * opt.a
    sub = max(a.csub, sub)
    if sub >= a.score:
        return 0
    ln = max(a.qe - a.qb, a.re - a.rb)
    identity = 1. - (ln * opt.a - a.score) / (opt.a + opt.b) / ln
    if a.score == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1. if ln < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(ln)
        tmp *= identity * identity
        mapq = int(6.02 * (a.score - sub) / opt.a * tmp * tmp + .499)
    else:
        mapq = int(30.0 * (1. - sub / a.score) * math.log(a.seedcov) + .499)
        if identity < 0.95:
            mapq = int(mapq * identity * identity + .499)
    if a.sub_n > 0:
        mapq -= int(4.343 * math.log(a.sub_n + 1) + .499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    return int(mapq * (1. - a.frac_rep) + .499)


# ------------------------------------------------ reg → aln (CIGAR) phases

def infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
    """infer_bw (bwamem.c:799-806)."""
    if l1 == l2 and l1 * a - score < (q + r - a) << 1:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.)
    return max(w, abs(l1 - l2))


@dataclasses.dataclass(slots=True)
class Aln:
    """mem_aln_t (reference bwa.h:166-177) + rendered MD."""
    pos: int = -1
    rid: int = -1
    flag: int = 0
    is_rev: int = 0
    is_alt: int = 0
    mapq: int = 0
    NM: int = -1
    cigar: list = dataclasses.field(default_factory=list)  # [(op, len)]
    MD: str = ""
    score: int = -1
    sub: int = -1
    alt_sc: int = 0
    XA: Optional[str] = None


@dataclasses.dataclass(slots=True)
class CigarJob:
    """One mem_reg2aln global-alignment job (bwamem.c:1099-1169).
    slots: ~10k instances per batch in phase-A selection."""
    reg: AlnReg
    query: np.ndarray          # full read, nt4
    l_query: int
    # derived
    w2: int = 0
    last_sc: int = -(1 << 30)
    n_iter: int = 0
    done: bool = False
    score: int = 0
    cigar: list = dataclasses.field(default_factory=list)
    qseg: np.ndarray = None    # query[qb:qe], reversed if rev
    rseq: np.ndarray = None    # fetched ref, reversed if rev
    nm_md: tuple = None        # (NM, MD) batch-precomputed (native path)

    def prepare(self, opt: MemOptions, pac: np.ndarray, l_pac: int,
                rseq: Optional[np.ndarray] = None):
        """rseq: prefetched reference window (get_seq_many) — run_cigar_jobs
        batches the pac gather across all jobs; None fetches here."""
        ar = self.reg
        tmp = infer_bw(ar.qe - ar.qb, ar.re - ar.rb, ar.truesc, opt.a,
                       opt.o_del, opt.e_del)
        w2 = infer_bw(ar.qe - ar.qb, ar.re - ar.rb, ar.truesc, opt.a,
                      opt.o_ins, opt.e_ins)
        self.w2 = max(tmp, w2)
        if self.w2 > opt.w:
            self.w2 = min(self.w2, ar.w)
        qseg = self.query[ar.qb:ar.qe]
        if rseq is None:
            rseq = get_seq_np(pac, l_pac, ar.rb, ar.re)
        assert len(rseq) == ar.re - ar.rb
        if ar.rb >= l_pac:
            qseg = qseg[::-1]
            rseq = rseq[::-1]
        self.qseg = np.ascontiguousarray(qseg)
        self.rseq = np.ascontiguousarray(rseq)


def run_cigar_jobs(opt: MemOptions, pac: np.ndarray, l_pac: int,
                   jobs: list[CigarJob]) -> None:
    """Band-doubling loop of mem_reg2aln (bwamem.c:1117-1126), batched:
    every pending job runs one banded global alignment per round; jobs
    whose score converged (score == last_sc or band maxed) retire.

    The DP runs in the native host kernel (native.ksw_global_batch): these
    per-record jobs are tiny (~100x~30 banded cells) and traceback-heavy,
    which one host core handles well."""
    from bwamem_tpu_torch import native
    rseqs = get_seq_many(pac, l_pac,
                         np.fromiter((j.reg.rb for j in jobs), np.int64,
                                     len(jobs)),
                         np.fromiter((j.reg.re for j in jobs), np.int64,
                                     len(jobs)))
    for j, rs in zip(jobs, rseqs):
        j.prepare(opt, pac, l_pac, rseq=rs)
    for _ in range(4):
        live = [j for j in jobs if not j.done]
        if not live:
            break
        batch = []
        for j in live:
            j.w2 = min(j.w2, opt.w << 2)
            ar = j.reg
            if ar.qe - ar.qb == ar.re - ar.rb and j.w2 == 0:
                # gapless shortcut (bwa.c:281-289)
                mat = opt.mat
                j.score = int(mat[j.rseq, j.qseg].sum())
                j.cigar = [(0, ar.qe - ar.qb)]
                j.done = True
                continue
            batch.append(j)
        if not batch:
            continue
        ws = [_gen_cigar_band(opt, len(j.qseg), len(j.rseq), j.w2)
              for j in batch]
        scores, cigars = native.ksw_global_batch(
            [j.qseg for j in batch], [j.rseq for j in batch], ws,
            opt.mat, opt.o_del, opt.e_del, opt.o_ins, opt.e_ins)
        for b, j in enumerate(batch):
            j.score = int(scores[b])
            j.cigar = cigars[b]
        for j in batch:
            if j.score == j.last_sc or j.w2 == opt.w << 2:
                j.done = True
                continue
            j.last_sc = j.score
            j.w2 <<= 1
            j.n_iter += 1
            if j.n_iter >= 3 or j.score >= j.reg.truesc - opt.a:
                j.done = True
    if jobs:
        # batch all NM/MD work while the inputs are at hand; the cached
        # values short-circuit reg2aln_finish's per-record _nm_md
        nm, md = native.nm_md_batch(
            [j.cigar for j in jobs], [j.qseg for j in jobs],
            [j.rseq for j in jobs],
            np.fromiter((j.reg.rb >= l_pac for j in jobs), np.uint8,
                        len(jobs)))
        for b, j in enumerate(jobs):
            j.nm_md = (int(nm[b]), md[b])


def _nm_md(cigar: list, qseg: np.ndarray, rseq: np.ndarray,
           is_rev: bool) -> tuple[int, str]:
    """NM and MD from a raw (pre-clip) cigar over the aligned frames
    (bwa_gen_cigar2, bwa.c:311-341).  Leading/trailing deletions are
    excluded from both, exactly as the reference.  Match runs are compared
    vectorized (reads are clean: the per-base loop was the SAM-render
    hotspot at ~30 us/read)."""
    int2base = "TGCAN" if is_rev else "ACGTN"
    md = []
    x = y = u = 0
    n_mm = n_gap = 0
    n_cigar = len(cigar)
    for k, (op, ln) in enumerate(cigar):
        if op == 0:
            rs = rseq[y:y + ln]
            mm = np.flatnonzero(qseg[x:x + ln] != rs)
            n_mm += mm.size
            prev = -1
            for i in mm:
                i = int(i)
                md.append(str(u + i - prev - 1))
                md.append(int2base[rs[i]])
                u = 0
                prev = i
            u += ln - prev - 1
            x += ln
            y += ln
        elif op == 2:
            if 0 < k < n_cigar - 1:
                md.append(str(u))
                md.append("^")
                md.extend(int2base[b] for b in rseq[y:y + ln])
                u = 0
                n_gap += ln
            y += ln
        elif op == 1:
            x += ln
            n_gap += ln
    md.append(str(u))
    return n_mm + n_gap, "".join(md)


def _approx_mapq_se_vec(opt: MemOptions, score, sub0, csub, sub_n, qb, qe,
                        rb, re, seedcov, frac_rep) -> np.ndarray:
    """Vectorized mem_approx_mapq_se (bwamem.c:962-986) over job arrays.
    Bit-identical to approx_mapq_se: every int() there truncates a
    non-negative float, which matches numpy's float->int cast."""
    f8 = np.float64
    sub = np.where(sub0 != 0, sub0, opt.min_seed_len * opt.a)
    sub = np.maximum(csub, sub)
    ln = np.maximum(qe - qb, re - rb).astype(f8)
    ln = np.maximum(ln, 1)                       # guard: qe>qb always holds
    identity = 1.0 - (ln * opt.a - score) / (opt.a + opt.b) / ln
    if opt.mapQ_coef_len > 0:
        tmp = np.where(ln < opt.mapQ_coef_len, 1.0,
                       opt.mapQ_coef_fac / np.log(ln))
        tmp = tmp * identity * identity
        mapq = (6.02 * (score - sub) / opt.a * tmp * tmp + .499).astype(
            np.int64)
    else:
        mapq = (30.0 * (1. - sub / np.maximum(score, 1))
                * np.log(np.maximum(seedcov, 1)) + .499).astype(np.int64)
        shrink = (mapq * identity * identity + .499).astype(np.int64)
        mapq = np.where(identity < 0.95, shrink, mapq)
    mapq = mapq - np.where(sub_n > 0,
                           (4.343 * np.log(sub_n + 1.0)
                            + .499).astype(np.int64), 0)
    mapq = np.clip(mapq, 0, 60)
    mapq = ((mapq * (1.0 - frac_rep)) + .499).astype(np.int64)
    mapq = np.where((score == 0) | (sub >= score), 0, mapq)
    return mapq


def finish_jobs(opt: MemOptions, ctg_offsets: np.ndarray, l_pac: int,
                jobs: list[CigarJob]) -> list[Aln]:
    """Batched reg2aln_finish over EVERY job of a batch: one pass extracts
    the reg fields, the mapq/pos arithmetic runs vectorized, and only the
    short cigar clip/squeeze list work stays per record (mem_reg2aln tail,
    bwamem.c:1127-1168).  Each job index is consumed at most once by the
    phase-C assemblers, so the returned Aln objects are safe to mutate."""
    n = len(jobs)
    if n == 0:
        return []
    i8 = np.int64
    score = np.fromiter((j.reg.score for j in jobs), i8, n)
    sub0 = np.fromiter((j.reg.sub for j in jobs), i8, n)
    csub = np.fromiter((j.reg.csub for j in jobs), i8, n)
    sub_n = np.fromiter((j.reg.sub_n for j in jobs), i8, n)
    qb = np.fromiter((j.reg.qb for j in jobs), i8, n)
    qe = np.fromiter((j.reg.qe for j in jobs), i8, n)
    rb = np.fromiter((j.reg.rb for j in jobs), i8, n)
    re_ = np.fromiter((j.reg.re for j in jobs), i8, n)
    seedcov = np.fromiter((j.reg.seedcov for j in jobs), i8, n)
    frac_rep = np.fromiter((j.reg.frac_rep for j in jobs), np.float64, n)
    secondary = np.fromiter((j.reg.secondary for j in jobs), i8, n)
    rid = np.fromiter((j.reg.rid for j in jobs), i8, n)

    mapq = _approx_mapq_se_vec(opt, score, sub0, csub, sub_n, qb, qe, rb,
                               re_, seedcov, frac_rep)
    mapq = np.where(secondary >= 0, 0, mapq)
    is_rev = rb >= l_pac
    pos0 = np.where(is_rev, 2 * l_pac - 1 - (re_ - 1), rb)
    pos_rel = pos0 - ctg_offsets[np.clip(rid, 0, None)]
    submax = np.maximum(sub0, csub)

    out = []
    for b, j in enumerate(jobs):
        ar = j.reg
        a = Aln()
        a.mapq = int(mapq[b])
        if secondary[b] >= 0:
            a.flag |= 0x100
        rev = bool(is_rev[b])
        if j.nm_md is not None:
            a.NM, a.MD = j.nm_md
        else:
            a.NM, a.MD = _nm_md(j.cigar, j.qseg, j.rseq, rev)
        cigar = list(j.cigar)
        pos = int(pos_rel[b])
        a.is_rev = int(rev)
        if cigar:
            if cigar[0][0] == 2:               # leading deletion
                pos += cigar[0][1]
                cigar = cigar[1:]
            elif cigar[-1][0] == 2:            # trailing deletion
                cigar = cigar[:-1]
        if ar.qb != 0 or ar.qe != j.l_query:
            clip5 = j.l_query - ar.qe if rev else ar.qb
            clip3 = ar.qb if rev else j.l_query - ar.qe
            if clip5:
                cigar = [(3, clip5)] + cigar
            if clip3:
                cigar = cigar + [(3, clip3)]
        a.cigar = cigar
        a.rid = int(rid[b])
        a.pos = pos
        a.score = ar.score
        a.sub = int(submax[b])
        a.is_alt = ar.is_alt
        a.alt_sc = ar.alt_sc
        out.append(a)
    return out


def reg2aln_finish(opt: MemOptions, ctg_offsets: np.ndarray, l_pac: int,
                   job: CigarJob) -> Aln:
    """The post-DP part of mem_reg2aln (bwamem.c:1127-1168): NM/MD, strand
    & position, leading/trailing-D squeeze, soft clips, rid/pos."""
    ar = job.reg
    a = Aln()
    a.mapq = approx_mapq_se(opt, ar) if ar.secondary < 0 else 0
    if ar.secondary >= 0:
        a.flag |= 0x100
    is_rev = ar.rb >= l_pac
    if job.nm_md is not None:
        a.NM, a.MD = job.nm_md
    else:
        a.NM, a.MD = _nm_md(job.cigar, job.qseg, job.rseq, is_rev)
    cigar = list(job.cigar)
    pos = ar.rb if ar.rb < l_pac else 2 * l_pac - 1 - (ar.re - 1)
    a.is_rev = int(is_rev)
    if cigar:
        if cigar[0][0] == 2:               # leading deletion
            pos += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == 2:            # trailing deletion
            cigar = cigar[:-1]
    if ar.qb != 0 or ar.qe != job.l_query:
        clip5 = job.l_query - ar.qe if is_rev else ar.qb
        clip3 = ar.qb if is_rev else job.l_query - ar.qe
        if clip5:
            cigar = [(3, clip5)] + cigar
        if clip3:
            cigar = cigar + [(3, clip3)]
    a.cigar = cigar
    # rid is the interval's contig (intv2rid upstream); the leading-D
    # squeeze moves pos only within it, so no searchsorted per record
    rid = ar.rid
    a.rid = rid
    a.pos = int(pos - ctg_offsets[rid])
    a.score = ar.score
    a.sub = max(ar.sub, ar.csub)
    a.is_alt = ar.is_alt
    a.alt_sc = ar.alt_sc
    return a


def unmapped_aln() -> Aln:
    """mem_reg2aln(ar=0) (bwamem.c:1104-1107)."""
    return Aln(rid=-1, pos=-1, flag=0x4, score=-1, sub=-1)
