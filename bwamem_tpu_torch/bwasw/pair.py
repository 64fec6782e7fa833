"""BWA-SW read pairing (bwtsw2_pair.c): insert-size inference + local-SW
mate rescue/fixing through the batched ksw_align of ops/local_sw, with
exact lane counts and a query width rounded up only to the stripe of the
emulated SIMD kernel.  Counterpart of bwamem_tpu/bwasw/pair.py."""
from __future__ import annotations

import math

import numpy as np
import torch

from bwamem_tpu_torch.bwasw.aux import (BSW2_FLAG_MATESW, BSW2_FLAG_MOVED,
                                        BSW2_FLAG_RESCUED, BSW2_FLAG_TANDEM,
                                        _dev)
from bwamem_tpu_torch.bwasw.core import Hit
from bwamem_tpu_torch.ops import local_sw

OUTLIER_BOUND = 2.0
MAX_STDDEV = 4.0
EXT_STDDEV = 4.0


def fill_scmat_pair(a: int, b: int) -> np.ndarray:
    """The pairing-specific g_mat (bwtsw2_pair.c:172-176) — NOT
    bwa_fill_scmat: query-N (column 4) scores 0 rather than -1, and
    target-N (row 4) scores -b.  The mate sequence may carry Ns while the
    pac-derived target never does, so the column-4 zeros are what keep
    N-heavy rescues score-compatible with the reference."""
    mat = np.zeros((5, 5), np.int8)
    for i in range(5):
        for j in range(4):
            mat[i, j] = a if i == j else -b
        mat[i, 4] = 0
    return mat


class PeStat:
    __slots__ = ("low", "high", "failed", "avg", "std")

    def __init__(self):
        self.low = self.high = self.failed = 0
        self.avg = self.std = 0.0


def bsw2_stat(reads, buf, msg: list, max_ins: int) -> PeStat:
    """Insert-size distribution from unique high-quality pairs
    (bwtsw2_pair.c:26-95)."""
    r = PeStat()
    isize = []
    max_len = 0
    for i in range(0, len(reads), 2):
        if not buf[i] or len(buf[i]) != 1 or len(buf[i + 1]) != 1:
            continue
        t0, t1 = buf[i][0], buf[i + 1][0]
        if t0.G2 > 0.8 * t0.G or t1.G2 > 0.8 * t1.G:
            continue
        l = t0.k - t1.k + t1.len if t0.k > t1.k else t1.k - t0.k + t0.len
        if l >= max_ins:
            continue
        max_len = max(max_len, t0.end - t0.beg, t1.end - t1.beg)
        isize.append(l)
    isize.sort()
    k = len(isize)
    msg.append(f"[bsw2_stat] infer the insert size distribution from {k} "
               "high-quality pairs.\n")
    if k < 8:
        msg.append("[bsw2_stat] fail to infer the insert size distribution: "
                   "too few good pairs.\n")
        r.failed = 1
        return r
    # the percentiles only from 8 pairs on: bwa's bsw2_stat
    # (bwtsw2_pair.c:26-95) takes them first and reads past the list at
    # k = 1, where the JAX package raises
    p25 = isize[int(.25 * k + .499)]
    p50 = isize[int(.50 * k + .499)]
    p75 = isize[int(.75 * k + .499)]
    tmp = int(p25 - OUTLIER_BOUND * (p75 - p25) + .499)
    r.low = tmp if tmp > max_len else max_len
    if r.low < 1:
        r.low = 1
    r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + .499)
    if r.low > r.high:
        msg.append("[bsw2_stat] fail to infer the insert size distribution: "
                   "upper bound is smaller than max read length.\n")
        r.failed = 1
        return r
    msg.append(f"[bsw2_stat] (25, 50, 75) percentile: ({p25}, {p50}, "
               f"{p75})\n")
    msg.append("[bsw2_stat] low and high boundaries for computing mean and "
               f"std.dev: ({r.low}, {r.high})\n")
    sel = [x for x in isize if r.low <= x <= r.high]
    if not sel:
        msg.append("[bsw2_stat] fail to infer the insert size distribution: "
                   "no pairs within boundaries.\n")
        r.failed = 1
        return r
    r.avg = sum(sel) / len(sel)
    r.std = math.sqrt(sum((x - r.avg) ** 2 for x in sel) / len(sel))
    msg.append(f"[bsw2_stat] mean and std.dev: ({r.avg:.2f}, {r.std:.2f})\n")
    tmp = int(p25 - 3. * (p75 - p25) + .499)
    r.low = tmp if tmp > max_len else max_len
    if r.low < 1:
        r.low = 1
    r.high = int(p75 + 3. * (p75 - p25) + .499)
    if r.low > r.avg - MAX_STDDEV * r.std:
        r.low = int(r.avg - MAX_STDDEV * r.std + .499)
    r.low = tmp if tmp > max_len else max_len
    if r.high < r.avg + MAX_STDDEV * r.std:
        r.high = int(r.avg + MAX_STDDEV * r.std + .499)
    msg.append("[bsw2_stat] low and high boundaries for proper pairs: "
               f"({r.low}, {r.high})\n")
    return r


def _pair1_region(opt, hfm, st, h, l_mseq):
    """Candidate window + mate strand for bsw2_pair1
    (bwtsw2_pair.c:112-126); returns (beg, end, a_is_rev, a_flag16)."""
    if h.is_rev == 0:
        beg = int(h.k + st.avg - EXT_STDDEV * st.std - l_mseq + .499)
        if beg < h.k:
            beg = h.k
        end = int(h.k + st.avg + EXT_STDDEV * st.std + .499)
        is_rev, flag16 = 1, 16
    else:
        beg = int(h.k + h.end - h.beg - st.avg - EXT_STDDEV * st.std + .499)
        end = int(h.k + h.end - h.beg - st.avg + EXT_STDDEV * st.std
                  + l_mseq + .499)
        if end > h.k + (h.end - h.beg):
            end = h.k + (h.end - h.beg)
        is_rev, flag16 = 0, 0
    if beg < 1:
        beg = 1
    if end > hfm.l_pac:
        end = hfm.l_pac
    return beg, end, is_rev, flag16


def sw_batch(queries, refs, opt, mat, p, dev):
    """ksw_align2 of each (query, reference) on `dev` at SIMD stripe p:
    [(score, te, qe, score2, te2, tb, qb)].  The emulated kernel treats a
    query as padded to a multiple of p (ops/local_sw._pass), so the query
    width is the longest query rounded up to one."""
    B = len(queries)
    LQ = -(-max(len(x) for x in queries) // p) * p
    LT = max(len(x) for x in refs)
    query = np.full((B, LQ), 4, np.uint8)
    tgt = np.full((B, LT), 4, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b_, (sq, ref) in enumerate(zip(queries, refs)):
        query[b_, :len(sq)] = sq
        tgt[b_, :len(ref)] = ref
        qlen[b_], tlen[b_] = len(sq), len(ref)
    res = local_sw.ksw_align_batch(
        *(_dev(a, dev) for a in (query, qlen, tgt, tlen)),
        torch.full((B,), opt.t, dtype=torch.int32, device=dev), mat,
        o_del=opt.q, e_del=opt.r, o_ins=opt.q, e_ins=opt.r, max_mat=opt.a,
        p=p)
    cols = [x.cpu().numpy() for x in res]
    return [tuple(int(c[b_]) for c in cols) for b_ in range(B)]


def bsw2_pair(opt, hfm, reads, buf, err, dev):
    """bsw2_pair (bwtsw2_pair.c:164-274).  All candidate mate-SW jobs are
    collected first and run as two batches on `dev` (the u8 and i16
    kernels' stripes), then the per-pair decision tree replays
    sequentially."""

    msg: list[str] = []
    pes = bsw2_stat(reads, buf, msg, opt.max_ins)
    mat = fill_scmat_pair(opt.a, opt.b)
    n_rescued = n_moved = n_fixed = 0

    # ---- collect SW jobs: (pair index, j-side) -> (seq, ref) ----
    jobs = {}
    if not pes.failed and not opt.skip_sw:
        for i in range(0, len(reads), 2):
            # (1,1), (1,0) and (0,1) hit patterns pass (bwtsw2_pair.c:190-192
            # — the NULL test there never fires; entries are always alloc'd)
            if len(buf[i]) != 1 and len(buf[i + 1]) != 1:
                continue
            if len(buf[i]) > 1 or len(buf[i + 1]) > 1:
                continue
            for j, hsrc in ((1, i), (0, i + 1)):
                if len(buf[hsrc]) != 1:
                    continue
                h = buf[hsrc][0]
                mread = reads[i + j]
                l_mseq = mread.l_seq
                beg, end, is_rev, flag16 = _pair1_region(
                    opt, hfm, pes, h, l_mseq)
                if end - beg < l_mseq:
                    continue
                ref = hfm.get_seq(beg, end)
                mseq = np.asarray(mread.seq)
                if h.is_rev == 0:
                    sq = np.where(mseq > 3, 4, 3 - mseq)[::-1].copy()
                else:
                    sq = np.where(mseq > 3, 4, mseq).copy()
                jobs[(i, j)] = (sq, ref, beg, is_rev, flag16, l_mseq)

    # ---- run the two kernel batches ----
    results = {}
    for byte_kernel in (True, False):
        keys = [k for k, v in jobs.items()
                if (v[5] * opt.a < 250) == byte_kernel]
        if not keys:
            continue
        res = sw_batch([jobs[k][0] for k in keys],
                       [jobs[k][1] for k in keys], opt, mat,
                       16 if byte_kernel else 8, dev)
        results.update(zip(keys, res))

    # ---- per-pair decision tree (bwtsw2_pair.c:178-270) ----
    for i in range(0, len(reads), 2):
        a = [Hit(), Hit()]
        a[0].flag = 1 << 6
        a[1].flag = 1 << 7
        for j in range(2):
            if not buf[i + j]:
                continue
            for p in buf[i + j]:
                p.flag |= 1 << (6 + j)
        if pes.failed:
            continue
        if len(buf[i]) != 1 and len(buf[i + 1]) != 1:
            continue
        if len(buf[i]) > 1 or len(buf[i + 1]) > 1:
            continue
        for j in range(2):
            key = (i, j)
            if key not in jobs:
                continue
            sq, ref, beg, is_rev, flag16, l_mseq = jobs[key]
            if key not in results:
                continue
            score, te, qe, score2, te2, tb, qb = results[key]
            aj = a[j]
            aj.n_seeds = 1
            aj.flag |= BSW2_FLAG_MATESW | flag16
            aj.is_rev = is_rev
            aj.G = score
            aj.G2 = score2
            if aj.G < opt.t:
                aj.G = 0
            if aj.G2 < opt.t:
                aj.G2 = 0
            if aj.G2:
                aj.flag |= BSW2_FLAG_TANDEM
            aj.k = beg + tb
            aj.len = te - tb + 1
            aj.beg = qb
            aj.end = qe + 1
            if aj.is_rev:
                aj.beg, aj.end = l_mseq - aj.end, l_mseq - aj.beg
        if len(buf[i]) + len(buf[i + 1]) == 1:
            # one end mapped, the other not (:198-213)
            if len(buf[i]) == 1:
                p0, p1, which = buf[i], buf[i + 1], 1
            else:
                p0, p1, which = buf[i + 1], buf[i], 0
            if a[which].G == 0:
                continue
            a[which].flag |= BSW2_FLAG_RESCUED
            p1.append(a[which])
            p0[0].flag |= 2
            p1[0].flag |= 2
            n_rescued += 1
        else:
            is_fixed = False
            for j in range(2):
                p = buf[i + j][0]
                if p.G < a[j].G:
                    a[j].G2 = max(a[j].G2, p.G)
                    buf[i + j][0] = a[j]
                    n_fixed += 1
                    is_fixed = True
                elif p.k != a[j].k and p.G2 < a[j].G:
                    p.G2 = a[j].G
                elif p.k == a[j].k and p.G2 < a[j].G2:
                    p.G2 = a[j].G2
            h0, h1 = buf[i][0], buf[i + 1][0]
            if h0.k == a[0].k and h1.k == a[1].k:
                for j in range(2):
                    buf[i + j][0].flag |= 2 | (a[j].flag & BSW2_FLAG_TANDEM)
            elif h0.k == a[0].k or h1.k == a[1].k:
                for j in range(2):
                    buf[i + j][0].flag |= 2
                    if buf[i + j][0].k != a[j].k:
                        buf[i + j][0].flag |= BSW2_FLAG_TANDEM
            elif not is_fixed and (a[0].G or a[1].G):
                if a[0].G and a[1].G:
                    G = [h0.G + a[1].G, h1.G + a[0].G]
                    diff = abs(G[0] - G[1]) / (opt.a + opt.b) / (
                        (h0.len + a[1].len + h1.len + a[0].len) / 2.)
                    if diff > 0.05:
                        a[0 if G[0] > G[1] else 1].G = 0
                if a[0].G == 0 or a[1].G == 0:
                    if a[0].G:
                        p0h, p1h, which = h1, buf[i], 0
                    else:
                        p0h, p1h, which = h0, buf[i + 1], 1
                    isz = (p0h.k + p0h.len - a[which].k) if p0h.is_rev \
                        else (a[which].k + a[which].len - p0h.k)
                    dev = abs(isz - pes.avg) / pes.std if pes.std else \
                        float("inf")
                    diff = (p1h[0].G - a[which].G) / (opt.a + opt.b) / (
                        p1h[0].end - p1h[0].beg) * 100.0
                    if diff < dev * 2.:
                        a[which].G2 = a[which].G
                        p1h[0] = a[which]
                        p1h[0].flag |= BSW2_FLAG_MOVED | 2
                        p0h.flag |= 2
                        n_moved += 1
            elif is_fixed:
                buf[i][0].flag |= 2
                buf[i + 1][0].flag |= 2
    msg.append(f"[bsw2_pair] #fixed={n_fixed}, #rescued={n_rescued}, "
               f"#moved={n_moved}\n")
    err.write("".join(msg))
