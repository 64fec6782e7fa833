"""`sampe` — paired-end SAM from two .sai streams.

Behavior spec: bwa_sai2sam_pe_core (bwape.c:624-731) and its helpers:
insert-size inference (infer_isize, bwape.c:81-154), the positional
pairing scan with hash tie-breaks (pairing, :156-254), per-batch SE
conversion (bwa_cal_pac_pos_pe, :260-403), and the mate-rescue SW
(bwa_paired_sw / bwa_sw_core, :405-622).  Output SAM is byte-identical.

Organized as samse: every SA walk of a batch (main hits, all pairing
occurrences, multi hits) is one ops.fm.sa_lookup on the FM's device, the
mate-rescue local SWs batch through ops.local_sw.ksw_align_batch (the
same op mem's long-read re-scoring and pemerge use) plus one
ops.global_sw call for their CIGARs, on the same device, while the
sequential drand48-bearing selection logic runs on the host in exactly
the reference's order.  Counterpart of bwamem_tpu/legacy/sampe.py.

timers: sa_lookup, local_sw, global_sw (each with its transfers).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from bwamem_tpu_torch.config import fill_scmat
from bwamem_tpu_torch.finalize import hash_64
from bwamem_tpu_torch.legacy.aln import cal_maxdiff
from bwamem_tpu_torch.legacy.rng import Drand48
from bwamem_tpu_torch.legacy import samse as se
from bwamem_tpu_torch.legacy.samse import (
    BWA_TYPE_NO_MATCH, BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT, BWA_TYPE_MATESW,
    G_LOG_N, SeqSE, approx_mapQ, aln2seq_core, sa2pos)
from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.ops import local_sw
from bwamem_tpu_torch.utils import timers

SAM_FPD, SAM_FPP = 1, 2
SAM_FR1, SAM_FR2 = 64, 128

OUTLIER_BOUND = 2.0
SW_MIN_MATCH_LEN = 20
SW_MIN_MAPQ = 17

U64_MAX = (1 << 64) - 1


class PeOptions:
    """pe_opt_t (bwa_init_pe_opt, bwape.c:53-66)."""
    def __init__(self):
        self.max_isize = 500
        self.force_isize = 0
        self.max_occ = 100000
        self.n_multi = 3
        self.N_multi = 10
        self.is_sw = 1
        self.ap_prior = 1e-5


class IsizeInfo:
    def __init__(self):
        self.avg = -1.0
        self.std = -1.0
        self.low = 0
        self.high = 0
        self.high_bayesian = 0
        self.ap_prior = 0.0


def infer_isize(pairs: list[tuple[SeqSE, SeqSE]], ii: IsizeInfo,
                ap_prior: float, L: int, err) -> int:
    """infer_isize (bwape.c:81-154)."""
    ii.avg = ii.std = -1.0
    ii.low = ii.high = ii.high_bayesian = 0
    isizes = []
    max_len = 1
    for p0, p1 in pairs:
        if p0.mapQ >= 20 and p1.mapQ >= 20:
            # bwtint_t is unsigned: pos == -1 compares as 2^64-1
            u0 = p0.pos if p0.pos != -1 else U64_MAX
            u1 = p1.pos if p1.pos != -1 else U64_MAX
            x = (u1 + p1.len - u0 if u0 < u1 else u0 + p0.len - u1) \
                & U64_MAX
            if x < 100000:
                isizes.append(x)
        max_len = max(max_len, p0.len, p1.len)
    tot = len(isizes)
    if tot < 20:
        err.write("[infer_isize] fail to infer insert size: "
                  "too few good pairs\n")
        return -1
    isizes.sort()
    p25 = isizes[int(tot * 0.25 + 0.5)]
    p50 = isizes[int(tot * 0.50 + 0.5)]
    p75 = isizes[int(tot * 0.75 + 0.5)]
    tmp = int(p25 - OUTLIER_BOUND * (p75 - p25) + .499)
    ii.low = tmp if tmp > max_len else max_len
    ii.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + .499)
    if ii.low > ii.high:
        err.write("[infer_isize] fail to infer insert size: upper bound is "
                  "smaller than read length\n")
        return -1
    n = 0
    x = 0
    for v in isizes:
        if ii.low <= v <= ii.high:
            n += 1
            x += v
    ii.avg = x / n
    std = 0.0
    for v in isizes:
        if ii.low <= v <= ii.high:
            std += (v - ii.avg) * (v - ii.avg)
    ii.std = math.sqrt(std / n)
    y = 1.0
    while y < 10.0:
        if .5 * math.erfc(y / math.sqrt(2)) < \
                ap_prior / L * (y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + .499)
    n_ap = sum(1 for v in isizes if v > ii.high_bayesian)
    ii.ap_prior = .01 * (n_ap + .01) / tot
    if ii.ap_prior < ap_prior:
        ii.ap_prior = ap_prior
    err.write(f"[infer_isize] (25, 50, 75) percentile: ({p25}, {p50}, "
              f"{p75})\n")
    if math.isnan(ii.std) or p75 > 100000:
        ii.low = ii.high = ii.high_bayesian = 0
        ii.avg = ii.std = -1.0
        err.write("[infer_isize] fail to infer insert size: weird pairing\n")
        return -1
    y = 1.0
    while y < 10.0:
        if .5 * math.erfc(y / math.sqrt(2)) < \
                ap_prior / L * (y * ii.std + ii.avg):
            break
        y += 0.01
    ii.high_bayesian = int(y * ii.std + ii.avg + .499)
    err.write(f"[infer_isize] low and high boundaries: {ii.low} and "
              f"{ii.high} for estimating avg and std\n")
    err.write(f"[infer_isize] inferred external isize from {n} pairs: "
              f"{ii.avg:.3f} +/- {ii.std:.3f}\n")
    err.write(f"[infer_isize] inferred maximum insert size: "
              f"{ii.high_bayesian} ({y:.2f} sigma)\n")
    return 0


def pairing(p: tuple[SeqSE, SeqSE], arr: list[tuple[int, int]],
            alns: tuple[list, list], opt: PeOptions, s_mm: int,
            ii: IsizeInfo) -> int:
    """pairing (bwape.c:156-254).  arr entries (x, y) with
    y = k<<2 | strand<<1 | j; x unsigned (pos or U64_MAX)."""
    cnt_chg = 0
    max_len = max(p[0].full_len, p[1].full_len)
    o_score = subo_score = U64_MAX
    o_n = subo_n = 0
    o_pos = [None, None]
    arr = sorted(arr)
    last_pos = [[(U64_MAX, U64_MAX), (U64_MAX, U64_MAX)] for _ in range(2)]

    def aux(u, v):
        nonlocal o_score, subo_score, o_n, subo_n
        l = v[0] + p[v[1] & 1].len - u[0]
        if u[0] != U64_MAX and v[0] > u[0] and l >= max_len and \
                ((ii.high and l <= ii.high_bayesian) or
                 (ii.high == 0 and l <= opt.max_isize)):
            s = alns[v[1] & 1][v[1] >> 2][7] + alns[u[1] & 1][u[1] >> 2][7]
            s *= 10
            if ii.high:
                s += int(-4.343 * math.log(.5 * math.erfc(
                    (1 / math.sqrt(2)) * abs(l - ii.avg) / ii.std)) + .499)
            s = (s << 32 | (hash_64(((u[0] << 32) | v[0]) & U64_MAX)
                            & 0xFFFFFFFF)) & U64_MAX
            if s >> 32 == o_score >> 32:
                o_n += 1
            elif s >> 32 < o_score >> 32:
                subo_n += o_n
                o_n = 1
            else:
                subo_n += 1
            if s < o_score:
                subo_score = o_score
                o_score = s
                o_pos[u[1] & 1] = u
                o_pos[v[1] & 1] = v
            elif s < subo_score:
                subo_score = s

    for x in arr:
        strand = (x[1] >> 1) & 1
        if strand == 1:
            y = 1 - (x[1] & 1)
            aux(last_pos[y][1], x)
            aux(last_pos[y][0], x)
        else:
            last_pos[x[1] & 1][0] = last_pos[x[1] & 1][1]
            last_pos[x[1] & 1][1] = x

    if o_score != U64_MAX:
        mapQ_p = 0
        if o_n == 1:
            if subo_score == U64_MAX:
                mapQ_p = 29
            elif (subo_score >> 32) - (o_score >> 32) > s_mm * 10:
                mapQ_p = 23
            else:
                n = 255 if subo_n > 255 else subo_n
                mapQ_p = ((subo_score >> 32) - (o_score >> 32)) // 2 \
                    - G_LOG_N[n]
                if mapQ_p < 0:
                    mapQ_p = 0
        m0 = p[0].pos == o_pos[0][0] and \
            p[0].strand == ((o_pos[0][1] >> 1) & 1)
        m1 = p[1].pos == o_pos[1][0] and \
            p[1].strand == ((o_pos[1][1] >> 1) & 1)
        if m0 and m1:
            if p[0].mapQ > 0 and p[1].mapQ > 0:
                mq = min(p[0].mapQ + p[1].mapQ, 60)
                p[0].mapQ = p[1].mapQ = mq
            else:
                if p[0].mapQ == 0:
                    p[0].mapQ = min(mapQ_p + 7, p[1].mapQ)
                if p[1].mapQ == 0:
                    p[1].mapQ = min(mapQ_p + 7, p[0].mapQ)
        elif m0:
            p[1].seQ = 0
            p[1].mapQ = min(p[0].mapQ, mapQ_p)
        elif m1:
            p[0].seQ = 0
            p[0].mapQ = min(p[1].mapQ, mapQ_p)
        else:
            p[0].seQ = p[1].seQ = 0
            mapQ_p = max(mapQ_p - 20, 0)
            p[0].mapQ = p[1].mapQ = mapQ_p
        for q, w in ((p[0], o_pos[0]), (p[1], o_pos[1])):
            r = alns[w[1] & 1][w[1] >> 2]
            q.extra_flag |= SAM_FPP
            if q.pos != w[0] or q.strand != ((w[1] >> 1) & 1):
                q.n_mm, q.n_gapo, q.n_gape = r[0], r[1], r[2]
                q.strand = (w[1] >> 1) & 1
                q.score = r[7]
                q.pos = w[0]
                if q.mapQ > 0:
                    cnt_chg += 1
    return cnt_chg


# ------------------------------------------------------------- mate rescue

def _sw_filter_candidate(popt: PeOptions, p: tuple[SeqSE, SeqSE]) -> bool:
    return (p[0].mapQ >= SW_MIN_MAPQ or p[1].mapQ >= SW_MIN_MAPQ) and \
        not (p[0].extra_flag & SAM_FPP)


def _sw_coords(ii: IsizeInfo, l_pac: int, pref: SeqSE, pmate: SeqSE,
               right: bool) -> tuple[int, int]:
    """__set_rght_coor / __set_left_coor (bwape.c:525-537)."""
    if right:
        a = int(pref.pos + ii.avg - 3 * ii.std - pmate.len * 1.5)
        b = int(a + 6 * ii.std + 2 * pmate.len)
        if a < pref.pos + pref.len:
            a = pref.pos + pref.len
        if b > l_pac:
            b = l_pac
    else:
        a = int(pref.pos + pref.len - ii.avg - 3 * ii.std - pmate.len * 0.5)
        b = int(a + 6 * ii.std + 2 * pmate.len)
        if a < 0:
            a = 0
        if b > pref.pos:
            b = pref.pos
    return a, b


def paired_sw(pac: np.ndarray, l_pac: int, pairs: list[tuple[SeqSE, SeqSE]],
              popt: PeOptions, ii: IsizeInfo, err, device) -> None:
    """bwa_paired_sw (bwape.c:496-622), with the per-candidate ksw_align
    and ksw_global calls batched on `device`."""
    if not popt.is_sw or ii.avg < 0.0:
        return
    n_tot = [0, 0]
    n_mapped = [0, 0]
    mat = fill_scmat(1, 3)

    # ---- collect candidate jobs ----
    jobs = []        # (pair_idx, k, seq nt4, beg, reglen)
    cand = []
    for pi, p in enumerate(pairs):
        if not _sw_filter_candidate(popt, p):
            continue
        is_singleton = 1 if (p[0].type == BWA_TYPE_NO_MATCH or
                             p[1].type == BWA_TYPE_NO_MATCH) else 0
        n_tot[is_singleton] += 1
        cand.append((pi, is_singleton))
        for k in range(2):
            if p[1 - k].type == BWA_TYPE_NO_MATCH:
                continue
            if p[1 - k].strand == 0:
                beg, end = _sw_coords(ii, l_pac, p[1 - k], p[k], True)
                seq = se._aligned_query(p[k], 1)     # rseq
            else:
                beg, end = _sw_coords(ii, l_pac, p[1 - k], p[k], False)
                seq = se._aligned_query(p[k], 0)     # original order
            # bwa_sw_core N/geometry gates (bwape.c:420-424)
            reglen = end - beg
            ln = p[k].len
            if reglen < SW_MIN_MATCH_LEN or l_pac - beg < ln:
                continue
            nN = int((seq >= 4).sum())
            if nN / ln >= 0.25 or ln - nN < SW_MIN_MATCH_LEN:
                continue
            jobs.append([pi, k, seq, beg, reglen, None, None])

    # ---- batched ksw_align ----
    if jobs:
        for stripe, grp in ((16, [j for j in jobs if len(j[2]) < 250]),
                            (8, [j for j in jobs if len(j[2]) >= 250])):
            if not grp:
                continue
            B = len(grp)
            LQ = -(-max(len(j[2]) for j in grp) // stripe) * stripe
            LT = max(1, max(min(j[4], l_pac - j[3]) for j in grp))
            q = np.full((B, LQ), 4, np.uint8)
            t = np.full((B, LT), 4, np.uint8)
            qlen = np.zeros(B, np.int32)
            tlen = np.zeros(B, np.int32)
            refs = []
            for b, j in enumerate(grp):
                ref = se._pac_fetch(pac, j[3], min(j[3] + j[4], l_pac))
                refs.append(ref)
                q[b, :len(j[2])] = j[2]
                t[b, :len(ref)] = ref
                qlen[b], tlen[b] = len(j[2]), len(ref)
            with timers.section("local_sw"):
                res = local_sw.ksw_align_batch(
                    *(torch.from_numpy(a).to(device)
                      for a in (q, qlen, t, tlen, np.zeros(B, np.int32))),
                    mat, o_del=5, e_del=1, o_ins=5, e_ins=1, max_mat=1,
                    p=stripe)
                sc, tb, te, qb, qe, sc2 = (
                    x.cpu().numpy() for x in (res.score, res.tb, res.te,
                                              res.qb, res.qe, res.score2))
            for b, j in enumerate(grp):
                j[5] = (int(sc[b]), int(tb[b]), int(te[b]) + 1, int(qb[b]),
                        int(qe[b]) + 1, int(sc2[b]))
                j[6] = refs[b]

    # ---- batched ksw_global on the aligned segments ----
    live = [j for j in jobs if j[5] is not None]
    gcig = {}
    if live:
        B = len(live)
        LQ = max(1, max(j[5][4] - j[5][3] for j in live))
        LT = max(1, max(j[5][2] - j[5][1] for j in live))
        q = np.full((B, LQ), 4, np.uint8)
        t = np.full((B, LT), 4, np.uint8)
        qlen = np.zeros(B, np.int32)
        tlen = np.zeros(B, np.int32)
        for b, j in enumerate(live):
            sc, tb, te, qb, qe, sc2 = j[5]
            q[b, : qe - qb] = j[2][qb:qe]
            t[b, : te - tb] = j[6][tb:te]
            qlen[b], tlen[b] = qe - qb, te - tb
        ops, lens, ncig, gsc = se.global_cigars(
            q, np.maximum(qlen, 1), t, np.maximum(tlen, 1),
            np.full(B, 50, np.int32), mat, 50, device)
        for b, j in enumerate(live):
            gcig[id(j)] = (int(gsc[b]),
                           [(int(ops[b, x]), int(lens[b, x]))
                            for x in range(int(ncig[b]))])

    # ---- host finish per candidate pair, in order ----
    by_pair: dict[int, dict[int, tuple]] = {}
    for j in live:
        pi, k, seq, beg, reglen = j[0], j[1], j[2], j[3], j[4]
        gscore, cigar32 = gcig[id(j)]
        sc, tb, te, qb, qe, sc2 = j[5]
        ref = j[6]
        ln = len(seq)
        if sc < SW_MIN_MATCH_LEN or sc2 == sc or gscore != sc:
            continue
        x = y = 0
        for op, l_ in cigar32:
            if op == 0:
                x += l_
                y += l_
            elif op == 2:
                x += l_
            else:
                y += l_
        if x < SW_MIN_MATCH_LEN or y < SW_MIN_MATCH_LEN:
            continue
        beg2 = beg + tb
        cigar = list(cigar32)
        if qb:
            cigar = [(3, qb)] + cigar
        if qe < ln:
            cigar = cigar + [(3, ln - qe)]
        n_mm = n_gapo = n_gape = 0
        x, y = tb, qb
        for op, l_ in cigar:
            if op == 0:
                for z in range(l_):
                    if ref[x + z] < 4 and seq[y + z] < 4 and \
                            ref[x + z] != seq[y + z]:
                        n_mm += 1
                x += l_
                y += l_
            elif op == 2:
                x += l_
                n_gapo += 1
                n_gape += l_ - 1
            elif op == 1:
                y += l_
                n_gapo += 1
                n_gape += l_ - 1
        cnt = (n_mm << 16) | (n_gapo << 8) | n_gape
        by_pair.setdefault(pi, {})[k] = (cigar, beg2, cnt)

    for pi, is_singleton in cand:
        p = pairs[pi]
        got = by_pair.get(pi, {})
        cig = {0: None, 1: None}
        mq_adjust = [255, 255]
        for k in (0, 1):
            if k not in got:
                continue
            cigar, beg2, cnt = got[k]
            if p[k].type != BWA_TYPE_NO_MATCH:
                clip = 0
                if cigar[0][0] == 3:
                    clip += cigar[0][1]
                if cigar[-1][0] == 3:
                    clip += cigar[-1][1]
                s_old = int((p[k].n_mm * 9 + p[k].n_gapo * 13 +
                             p[k].n_gape * 2) / 3. * 8. + .499)
                s_new = int((((cnt >> 16) * 9 + ((cnt >> 8) & 0xFF) * 13 +
                              (cnt & 0xFF) * 2 + clip * 3) / 3. * 8.)
                            + .499)
                s_old = int(s_old + -4.343 * math.log(ii.ap_prior / l_pac))
                s_new = s_new + int(-4.343 * math.log(
                    .5 * math.erfc((1 / math.sqrt(2)) * 1.5) + .499))
                if s_old < s_new:      # reject SW alignment
                    mq_adjust[k] = s_new - s_old
                    continue
                mq_adjust[k] = s_old - s_new
            cig[k] = (cigar, beg2, cnt)
        k = -1
        mapQ = 0
        if cig[0] and cig[1]:
            k = 0 if p[0].mapQ < p[1].mapQ else 1
            mapQ = abs(p[1].mapQ - p[0].mapQ)
        elif cig[0]:
            k, mapQ = 0, p[1].mapQ
        elif cig[1]:
            k, mapQ = 1, p[0].mapQ
        if k >= 0 and p[k].pos != cig[k][1]:
            n_mapped[is_singleton] += 1
            tmp = p[1 - k].mapQ - p[k].mapQ // 2 - 8
            if tmp <= 0:
                tmp = 1
            if mapQ > tmp:
                mapQ = tmp
            p[k].mapQ = p[1 - k].mapQ = mapQ
            p[k].seQ = p[1 - k].seQ = min(p[1 - k].seQ, mapQ)
            if p[k].mapQ > mq_adjust[k]:
                p[k].mapQ = mq_adjust[k]
            if p[k].seQ > mq_adjust[k]:
                p[k].seQ = mq_adjust[k]
            cigar, beg2, cnt = cig[k]
            p[k].cigar = cigar
            # __set_fixed (bwape.c:539-547)
            p[k].type = BWA_TYPE_MATESW
            p[k].pos = beg2
            p[k].seQ = p[1 - k].seQ
            p[k].strand = 1 - p[1 - k].strand
            p[k].n_mm = cnt >> 16
            p[k].n_gapo = (cnt >> 8) & 0xFF
            p[k].n_gape = cnt & 0xFF
            p[k].extra_flag |= SAM_FPP
            p[1 - k].extra_flag |= SAM_FPP
    err.write(f"[bwa_paired_sw] {n_mapped[1]} out of {n_tot[1]} "
              f"Q{SW_MIN_MAPQ} singletons are mated.\n")
    err.write(f"[bwa_paired_sw] {n_mapped[0]} out of {n_tot[0]} "
              f"Q{SW_MIN_MAPQ} discordant pairs are fixed.\n")


# ---------------------------------------------------------------- entry points

def _batched_sa2pos(fm, l_pac: int, reqs: list[tuple[int, int]]):
    """One device SA walk for (rank, ref_len) requests → [(pos, strand)]."""
    if not reqs:
        return []
    pos_fr = se.sa_lookup_host(fm, [x[0] for x in reqs])
    return [sa2pos(l_pac, int(pos_fr[b]), reqs[b][1])
            for b in range(len(reqs))]


def sampe_core(idx, sai1: str, sai2: str, fq1: str, fq2: str,
               popt: PeOptions, rg_line: Optional[str],
               rg_id: Optional[str], out, err, device,
               pg_line: Optional[str] = None, seed: int = 11,
               batch: int = 0x40000) -> None:
    """bwa_sai2sam_pe_core (bwape.c:624-731); the SA walks and the SWs run
    on `device`."""
    fm = fmops.fm_from_index(idx, device)
    bns = se.make_bns(idx)
    l_pac = bns["l_pac"]
    rng = Drand48(seed)
    opt0, recs0 = se.read_sai(sai1)
    opt, recs1 = se.read_sai(sai2)
    out.write(se.sam_hdr(bns, rg_line, pg_line))
    it0 = se.load_seqs(fq1, opt0)
    it1 = se.load_seqs(fq2, opt)
    last_ii = IsizeInfo()
    while True:
        pairs: list[tuple[SeqSE, SeqSE]] = []
        pair_alns: list[tuple[list, list]] = []
        for a, b in zip(it0, it1):
            pairs.append((a, b))
            if len(pairs) >= batch:
                break
        if not pairs:
            break

        # ---- SE conversion (bwa_cal_pac_pos_pe head, bwape.c:278-303) ----
        sa_reqs = []
        sa_owner = []
        for i, p in enumerate(pairs):
            cur = []
            for j in range(2):
                s = p[j]
                s.n_multi = 0
                s.extra_flag |= SAM_FPD | (SAM_FR1 if j == 0 else SAM_FR2)
                alns = next(recs0 if j == 0 else recs1)
                cur.append(alns)
                aln2seq_core(alns, s, True, 0, rng)
                if s.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
                    # gopt is the SECOND sai's options (bwape.c:661,685)
                    max_diff = cal_maxdiff(s.len, thres=opt.fnr) \
                        if opt.fnr > 0.0 else opt.max_diff
                    s.seQ = s.mapQ = approx_mapQ(s, max_diff)
                    sa_reqs.append((s.sa, s.len + s.ref_shift))
                    sa_owner.append(s)
            pair_alns.append(tuple(cur))
        for s, (pos, strand) in zip(sa_owner,
                                    _batched_sa2pos(fm, l_pac, sa_reqs)):
            s.pos, s.strand = pos, strand
            if pos == -1:
                s.type = BWA_TYPE_NO_MATCH

        # ---- insert size ----
        ii = IsizeInfo()
        infer_isize(pairs, ii, popt.ap_prior, l_pac, err)
        if ii.avg < 0.0 < last_ii.avg:
            ii = last_ii
        if popt.force_isize:
            err.write("[bwa_cal_pac_pos_pe] discard insert size estimate "
                      "as user's request.\n")
            ii.low = ii.high = 0
            ii.avg = ii.std = -1.0

        # ---- pairing (bwape.c:313-368): batch every occurrence SA walk --
        occ_reqs = []
        occ_meta = []       # (pair_idx, j, k_idx)
        pair_ok = []
        for i, p in enumerate(pairs):
            ok = p[0].type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT) and \
                p[1].type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT)
            if ok:
                n_occ = [sum(r[6] - r[5] + 1 for r in pair_alns[i][j])
                         for j in range(2)]
                if n_occ[0] > popt.max_occ or n_occ[1] > popt.max_occ:
                    ok = False
            pair_ok.append(ok)
            if not ok:
                continue
            for j in range(2):
                for k, r in enumerate(pair_alns[i][j]):
                    for l in range(r[5], r[6] + 1):
                        occ_reqs.append((l, p[j].len + (r[4] - r[3])))
                        occ_meta.append((i, j, k))
        occ_pos = _batched_sa2pos(fm, l_pac, occ_reqs)
        arr_by_pair: dict[int, list] = {}
        for (i, j, k), (pos, strand) in zip(occ_meta, occ_pos):
            x = pos if pos != -1 else U64_MAX
            arr_by_pair.setdefault(i, []).append(
                (x, (k << 2) | (strand << 1) | j))
        cnt_chg = 0
        multi_reqs = []
        multi_owner = []
        for i, p in enumerate(pairs):
            if pair_ok[i]:
                cnt_chg += pairing(p, arr_by_pair.get(i, []),
                                   pair_alns[i], popt, opt.s_mm, ii)
            if popt.N_multi or popt.n_multi:
                for j in range(2):
                    s = p[j]
                    if s.type == BWA_TYPE_NO_MATCH:
                        continue
                    if not (s.extra_flag & SAM_FPP) and \
                            p[1 - j].type != BWA_TYPE_NO_MATCH:
                        nm = popt.n_multi \
                            if s.c1 + s.c2 - 1 > popt.N_multi \
                            else popt.N_multi
                    else:
                        nm = popt.n_multi
                    aln2seq_core(pair_alns[i][j], s, False, nm, rng)
                    for q in s.multi:
                        multi_reqs.append((q.pos, s.len + q.ref_shift))
                        multi_owner.append((s, q))
        for (s, q), (pos, strand) in zip(
                multi_owner, _batched_sa2pos(fm, l_pac, multi_reqs)):
            q.pos, q.strand = pos, strand
        for i, p in enumerate(pairs):
            for j in range(2):
                s = p[j]
                if s.type == BWA_TYPE_NO_MATCH:
                    continue
                s.multi = [q for q in s.multi
                           if q.pos != s.pos and q.pos != -1]
                s.n_multi = len(s.multi)
        err.write(f"[bwa_sai2sam_pe_core] changing coordinates of "
                  f"{cnt_chg} alignments.\n")

        # ---- mate rescue + refinement + render ----
        err.write("[bwa_sai2sam_pe_core] align unmapped mate...\n")
        paired_sw(idx.pac, l_pac, pairs, popt, ii, err, device)
        for j in range(2):
            seqs_j = [p[j] for p in pairs]
            se.refine_gapped_batch(idx.pac, l_pac, seqs_j, device)
            for s in seqs_j:
                if s.type != BWA_TYPE_NO_MATCH:
                    se.cal_md1(s, idx.pac, l_pac)
                se.correct_trimmed(s)
        for p in pairs:
            if p[0].name != p[1].name:  # err_fatal, bwape.c:709
                err.write(f'[bwa_sai2sam_pe_core] paired reads have '
                          f'different names: "{p[0].name}", '
                          f'"{p[1].name}"\n')
                raise SystemExit(1)
            se.print_sam1(bns, p[0], p[1], opt.mode, opt.max_top2,
                          rg_id or "", out)
            se.print_sam1(bns, p[1], p[0], opt.mode, opt.max_top2,
                          rg_id or "", out)
        last_ii = ii
        if len(pairs) < batch:
            break
