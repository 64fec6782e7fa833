"""Paired-end machinery: insert-size stats, mate rescue, pair scoring.

Host-side logic; the unbanded SW of mate rescue is batched by the caller
(pipeline.align.Aligner._matesw_rounds, native ksw_align_host).  Behavior
follows CPU bwamem_pair.c exactly:

  * mem_infer_dir / cal_sub             (bwamem_pair.c:49-72)
  * mem_pestat percentile stats          (:72-135) — the ONE batch-global
    reduction of the whole pipeline, on the host over the reg tables
  * mem_matesw                           (:137-206) — skip logic and reg
    insertion here, the unbanded SW batched across pairs, one lockstep
    round per (end, candidate) step so per-pair sequential semantics
    (insert→dedup→skip) are kept
  * mem_pair O(n²)-bounded pair scoring with erfc insert-size prior and
    hash_64 tie-breaking                 (:208-269); the plain counterpart
    of native.pair_batch, and the route of -5 and -P
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.finalize import AlnReg, hash_64, sort_dedup_patch

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0


@dataclasses.dataclass
class PeStat:
    """mem_pestat_t (reference bwa.h:120-125)."""
    low: int = 0
    high: int = 0
    failed: int = 1
    avg: float = 0.0
    std: float = 0.0


def infer_dir(l_pac: int, b1: int, b2: int) -> tuple[int, int]:
    """mem_infer_dir (bwamem_pair.c:49-57): orientation in {FF,FR,RF,RR}
    and distance on read 1's strand."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def cal_sub(opt: MemOptions, regs: list[AlnReg]) -> int:
    """cal_sub (bwamem_pair.c:59-71): first hit not significantly
    overlapping the best."""
    for j in range(1, len(regs)):
        b_max = max(regs[j].qb, regs[0].qb)
        e_min = min(regs[j].qe, regs[0].qe)
        if e_min > b_max:
            min_l = min(regs[j].qe - regs[j].qb, regs[0].qe - regs[0].qb)
            if e_min - b_max >= min_l * opt.mask_level:
                return regs[j].score
    return opt.min_seed_len * opt.a


def pestat(opt: MemOptions, l_pac: int,
           regs_pairs: list[tuple[list[AlnReg], list[AlnReg]]],
           log=None) -> list[PeStat]:
    """mem_pestat (bwamem_pair.c:72-135): robust percentile insert-size
    inference from unique top hits, per orientation quartet."""
    isize: list[list[int]] = [[], [], [], []]
    for r0, r1 in regs_pairs:
        if not r0 or not r1:
            continue
        if cal_sub(opt, r0) > MIN_RATIO * r0[0].score:
            continue
        if cal_sub(opt, r1) > MIN_RATIO * r1[0].score:
            continue
        if r0[0].rid != r1[0].rid:
            continue
        d, dist = infer_dir(l_pac, r0[0].rb, r1[0].rb)
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    pes = [PeStat() for _ in range(4)]
    for d in range(4):
        q = sorted(isize[d])
        r = pes[d]
        if len(q) < MIN_DIR_CNT:
            r.failed = 1
            continue
        r.failed = 0
        n = len(q)
        p25 = q[int(.25 * n + .499)]
        p50 = q[int(.50 * n + .499)]
        p75 = q[int(.75 * n + .499)]
        r.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + .499), 1)
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + .499)
        sel = [x for x in q if r.low <= x <= r.high]
        r.avg = sum(sel) / len(sel)
        r.std = math.sqrt(sum((x - r.avg) ** 2 for x in sel) / len(sel))
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + .499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + .499)
        if r.low > r.avg - MAX_STDDEV * r.std:
            r.low = int(r.avg - MAX_STDDEV * r.std + .499)
        if r.high < r.avg + MAX_STDDEV * r.std:
            r.high = int(r.avg + MAX_STDDEV * r.std + .499)
        r.low = max(r.low, 1)
        if log:
            log(f"[M::pestat] orientation {'FR'[d >> 1 & 1]}{'FR'[d & 1]}: "
                f"avg={r.avg:.2f} std={r.std:.2f} "
                f"low={r.low} high={r.high}")
    mx = max(len(x) for x in isize)
    for d in range(4):
        if pes[d].failed == 0 and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = 1
    return pes


def pes_from_spec(spec: dict) -> list[PeStat]:
    """-I mean[,std[,max[,min]]] override (fastmap.c:161-177): only FR."""
    pes = [PeStat() for _ in range(4)]
    pes[1] = PeStat(low=spec["low"], high=spec["high"], failed=0,
                    avg=spec["avg"], std=spec["std"])
    return pes


# ------------------------------------------------------------- mate rescue

@dataclasses.dataclass
class MateSwJob:
    """One orientation SW of one mem_matesw call (bwamem_pair.c:152-177)."""
    pair_i: int
    end: int               # which end's reg list receives the rescue (!i)
    r: int                 # orientation
    a: AlnReg              # the anchor reg
    seq: np.ndarray        # mate seq (possibly revcomp'd)
    rb: int = 0
    re: int = 0
    rid: int = -1
    is_rev: bool = False
    l_ms: int = 0
    valid: bool = False


def prepare_matesw_call(opt: MemOptions, pac, l_pac: int, ctg_offsets,
                        pes: list[PeStat], a: AlnReg, l_ms: int,
                        ms: np.ndarray, ma: list[AlnReg]):
    """The host half of mem_matesw: skip logic + window computation.
    Returns the orientation jobs to run (possibly none)."""
    skip = [1 if pes[r].failed else 0 for r in range(4)]
    for m in ma:
        r, dist = infer_dir(l_pac, a.rb, m.rb)
        if pes[r].low <= dist <= pes[r].high:
            skip[r] = 1
    if sum(skip) == 4:
        return []
    jobs = []
    for r in range(4):
        if skip[r]:
            continue
        is_rev = (r >> 1) != (r & 1)
        is_larger = not (r >> 1)
        if is_rev:
            seq = np.where(ms < 4, 3 - ms, 4)[::-1].astype(np.uint8)
        else:
            seq = ms
        if not is_rev:
            rb = a.rb + pes[r].low if is_larger else a.rb - pes[r].high
            re = (a.rb + pes[r].high if is_larger
                  else a.rb - pes[r].low) + l_ms
        else:
            rb = (a.rb + pes[r].low if is_larger
                  else a.rb - pes[r].high) - l_ms
            re = a.rb + pes[r].high if is_larger else a.rb - pes[r].low
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        j = MateSwJob(pair_i=-1, end=-1, r=r, a=a, seq=seq, l_ms=l_ms,
                      is_rev=is_rev)
        if rb < re:
            # bns_fetch_seq clamp to the contig of the window middle
            # (bntseq.c:426-451)
            rb, re, rid = fetch_clamp(ctg_offsets, l_pac, rb, (rb + re) >> 1,
                                      re)
            j.rb, j.re, j.rid = rb, re, rid
            j.valid = (a.rid == rid) and (re - rb >= opt.min_seed_len)
        jobs.append(j)
    return jobs


def fetch_clamp(ctg_offsets: np.ndarray, l_pac: int, rb: int, mid: int,
                re: int):
    """bns_fetch_seq coordinate clamping (bntseq.c:426-451): clip [rb,re)
    to the contig holding mid (strand-aware); returns (rb, re, rid)."""
    if mid >= l_pac:
        fm = (l_pac << 1) - 1 - mid
    else:
        fm = mid
    rid = int(np.searchsorted(ctg_offsets, fm, side="right") - 1)
    far_beg = int(ctg_offsets[rid])
    far_end = int(ctg_offsets[rid + 1]) if rid + 1 < len(ctg_offsets) \
        else l_pac
    if mid >= l_pac:
        beg, end = (l_pac << 1) - far_end, (l_pac << 1) - far_beg
    else:
        beg, end = far_beg, far_end
    return max(rb, beg), min(re, end), rid


def apply_matesw_result(opt: MemOptions, l_pac: int, job: MateSwJob,
                        score: int, tb: int, te: int, qb: int, qe: int,
                        score2: int, ma: list[AlnReg]) -> int:
    """The post-SW half of mem_matesw (bwamem_pair.c:178-205): convert the
    local hit to a reg, insert sorted by score, dedup.  Returns 1 if an SW
    was performed (n increment), mutates ma."""
    a, l_ms = job.a, job.l_ms
    rb = job.rb
    if score >= opt.min_seed_len and qb >= 0:
        b = AlnReg()
        b.rid = a.rid
        b.is_alt = a.is_alt
        b.qb = l_ms - (qe + 1) if job.is_rev else qb
        b.qe = l_ms - qb if job.is_rev else qe + 1
        b.rb = ((l_pac << 1) - (rb + te + 1)) if job.is_rev else rb + tb
        b.re = ((l_pac << 1) - (rb + tb)) if job.is_rev else rb + te + 1
        b.score = score
        b.csub = score2
        b.secondary = -1
        b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
        # insertion sort by score desc (bwamem_pair.c:192-197)
        pos = len(ma)
        for i in range(len(ma)):
            if ma[i].score < b.score:
                pos = i
                break
        ma.insert(pos, b)
    # dedup (patch disabled: reference passes bns=0, bwamem_pair.c:203)
    ma[:] = sort_dedup_patch(opt, None, 0, None, ma)
    return 1


# ------------------------------------------------------------ pair scoring

def mem_pair(opt: MemOptions, l_pac: int, ctg_offsets: np.ndarray,
             pes: list[PeStat], a: tuple[list[AlnReg], list[AlnReg]],
             id_: int, n_pri: list[int]):
    """mem_pair (bwamem_pair.c:208-269).  Returns
    (score, sub, n_sub, z[2]) with score 0 when no proper pair."""
    v = []   # (x, y)
    for r in range(2):
        for i in range(n_pri[r]):
            e = a[r][i]
            fpos = e.rb if e.rb < l_pac else (l_pac << 1) - 1 - e.rb
            x = (e.rid << 32) | int(fpos - ctg_offsets[e.rid])
            y = (e.score << 32) | (i << 2) | (int(e.rb >= l_pac) << 1) | r
            v.append((x, y))
    v.sort()
    y4 = [-1, -1, -1, -1]
    u = []
    M_SQRT1_2 = 1.0 / math.sqrt(2.0)
    for i in range(len(v)):
        for rr in range(2):
            dir_ = (rr << 1) | ((v[i][1] >> 1) & 1)
            if pes[dir_].failed:
                continue
            which = (rr << 1) | ((v[i][1] & 1) ^ 1)
            if y4[which] < 0:
                continue
            for k in range(y4[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[dir_].high:
                    break
                if dist < pes[dir_].low:
                    continue
                if pes[dir_].std > 0:
                    ns = (dist - pes[dir_].avg) / pes[dir_].std
                    q = int((v[i][1] >> 32) + (v[k][1] >> 32)
                            + .721 * math.log(2. * math.erfc(abs(ns)
                                                             * M_SQRT1_2))
                            * opt.a + .499)
                    q = max(q, 0)
                else:
                    # std == 0 (constant-insert data): the C reference
                    # divides by 0.0 → NaN/±inf propagates through
                    # erfc/log and the (int) conversion yields INT_MIN,
                    # which the q>0?q:0 clamp turns into 0
                    # (bwamem_pair.c:246-248)
                    q = 0
                yk = (k << 32) | i
                u.append(((q << 32) | (hash_64((yk ^ (id_ << 8))
                                               & ((1 << 64) - 1))
                                       & 0xFFFFFFFF), yk))
        y4[v[i][1] & 3] = i
    z = [-1, -1]
    if not u:
        return 0, 0, 0, z
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    u.sort()
    i = u[-1][1] >> 32
    k = u[-1][1] & 0xFFFFFFFF
    z[v[i][1] & 1] = (v[i][1] & 0xFFFFFFFF) >> 2
    z[v[k][1] & 1] = (v[k][1] & 0xFFFFFFFF) >> 2
    ret = u[-1][0] >> 32
    sub = (u[-2][0] >> 32) if len(u) > 1 else 0
    n_sub = 0
    for j in range(len(u) - 2, -1, -1):
        if sub - (u[j][0] >> 32) <= tmp:
            n_sub += 1
    return ret, sub, n_sub, z
