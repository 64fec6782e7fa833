"""Chain -> alignment-region driver (mem_chain2aln, bwamem.c:639-793): the
extension windows, the per-read work order and the lockstep-rounds
driver extend_all.

The reference walks each read's filtered chains in order, and within a
chain its seeds from longest to shortest; each seed is either skipped
(when nearly contained in an already-computed alignment region and no
overlapping longer seed suggests a different alignment) or extended
left+right with banded SW (band-doubling retry, MAX_BAND_TRY=2).

extend_all advances every read through its work list in lockstep rounds.
Each round
  1. scans forward over work items applying the skip test (vectorized
     over the read's existing regions and the seeds of the same chain),
  2. extends every read's first non-skipped item left, then right: each
     side's two passes (at w, again at 2w where the band was nearly
     reached) are one launch of the extension kernel (ops/ext_kernel),
  3. appends the new alignment region to the read's fixed-size region
     table.
Rounds repeat until every read exhausts its work list.  Reads needing
more regions than the cap are flagged.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bwamem_tpu_torch.ops import ext_kernel
from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.ops.chain import Chains, FilteredChains, Seeds
from bwamem_tpu_torch.ops.extend import ExtendResult


class Regs(NamedTuple):
    """mem_alnreg_t equivalents (reference bwa.h:145-163)."""
    rb: torch.Tensor        # [N, R] it
    re: torch.Tensor        # [N, R] it
    qb: torch.Tensor        # [N, R] int32
    qe: torch.Tensor        # [N, R] int32
    score: torch.Tensor     # [N, R] int32
    truesc: torch.Tensor    # [N, R] int32
    w: torch.Tensor         # [N, R] int32
    seedcov: torch.Tensor   # [N, R] int32
    seedlen0: torch.Tensor  # [N, R] int32
    rid: torch.Tensor       # [N, R] int32
    frac_rep: torch.Tensor  # [N] float32
    n: torch.Tensor         # [N] int32
    overflow: torch.Tensor  # [N] bool


def _cal_max_gap(qlen, a: int, o_del: int, e_del: int, o_ins: int,
                 e_ins: int, w: int):
    """cal_max_gap (bwamem.c:628-635); C double arithmetic + int truncation."""
    qf = qlen.to(torch.float64)
    l_del = ((qf * a - o_del) / e_del + 1.0).to(torch.int32)
    l_ins = ((qf * a - o_ins) / e_ins + 1.0).to(torch.int32)
    l = torch.maximum(l_del, l_ins).clamp(min=1)
    return l.clamp(max=w * 2)


def chain_rmax(seeds: Seeds, chains: Chains, l_seq, fm: fmops.FM,
               ctg_offsets, *, a: int, o_del: int, e_del: int, o_ins: int,
               e_ins: int, w: int):
    """Reference window [rmax0, rmax1) per chain (bwamem.c:648-666),
    including the strand clip and the bns_fetch_seq contig clamp."""
    N, S = seeds.rbeg.shape
    C = chains.pos.shape[1]
    it = seeds.rbeg.dtype
    dev = seeds.rbeg.device
    sc = chains.seed_chain
    in_ch = sc >= 0
    tgt = torch.where(in_ch, sc, C).to(torch.int64)

    gap_l = _cal_max_gap(seeds.qbeg, a, o_del, e_del, o_ins, e_ins, w)
    rem = l_seq[:, None] - seeds.qbeg - seeds.len
    gap_r = _cal_max_gap(rem, a, o_del, e_del, o_ins, e_ins, w)
    b = seeds.rbeg - (seeds.qbeg + gap_l).to(it)
    e = seeds.rbeg + seeds.len + (rem + gap_r).to(it)

    big = 2 * fm.l_pac
    # column C collects the seeds outside every chain and is cut off
    rmax0 = torch.full((N, C + 1), big, dtype=it, device=dev)
    rmax1 = torch.zeros((N, C + 1), dtype=it, device=dev)
    rmax0.scatter_reduce_(1, tgt, torch.where(in_ch, b, big), "amin")
    rmax1.scatter_reduce_(1, tgt, torch.where(in_ch, e, 0), "amax")
    rmax0 = rmax0[:, :C].clamp(min=0)
    rmax1 = rmax1[:, :C].clamp(max=big)
    crosses = (rmax0 < fm.l_pac) & (fm.l_pac < rmax1)
    first_fwd = chains.first_rbeg < fm.l_pac
    rmax1 = torch.where(crosses & first_fwd, fm.l_pac, rmax1)
    rmax0 = torch.where(crosses & ~first_fwd, fm.l_pac, rmax0)

    # bns_fetch_seq clamp to the contig holding the first seed (bntseq.c:426)
    pos_f, is_rev = fmops.depos(fm.l_pac, chains.first_rbeg)
    rid = chains.rid.clamp(min=0).to(torch.int64)
    n_ctg = ctg_offsets.shape[0]
    far_beg = ctg_offsets[rid.clamp(max=n_ctg - 1)].to(it)
    # contig end from the next offset (or l_pac for the last contig)
    nxt = torch.where(rid + 1 < n_ctg,
                      ctg_offsets[(rid + 1).clamp(max=n_ctg - 1)].to(it),
                      fm.l_pac)
    fb = torch.where(is_rev, 2 * fm.l_pac - nxt, far_beg)
    fe = torch.where(is_rev, 2 * fm.l_pac - far_beg, nxt)
    return torch.maximum(rmax0, fb), torch.minimum(rmax1, fe)


class WorkList(NamedTuple):
    seed_slot: torch.Tensor   # [N, S] slot of w-th work item
    chain: torch.Tensor       # [N, S] chain of w-th item (-1 invalid)
    n: torch.Tensor           # [N]


def build_worklist(seeds: Seeds, chains: Chains,
                   fl: FilteredChains) -> WorkList:
    """Processing order: chains by filter order (kept only), seeds within a
    chain by (len desc, slot desc) — the reverse of the reference's
    ks_introsort_64 ascending (score<<32|i) walk (bwamem.c:669-674).

    The sort key packs (filter position << 24) | ((512 - len) << 12) |
    (S - slot) in int64.  For a seed longer than 512 bp the middle field is
    negative and its sign bits run over the position field; the key is kept
    bit for bit as the JAX package computes it (its output is the
    reference here), and the host tie-order and re-scoring passes
    (pipeline/chainflt_host) rebuild the rows where it matters."""
    N, S = seeds.rbeg.shape
    C = chains.pos.shape[1]
    dev = seeds.rbeg.device
    i32, i64 = torch.int32, torch.int64
    order_c = fl.order.to(i64)
    # position of each chain in the filtered order, and its kept mark
    ord_pos = torch.zeros((N, C), dtype=i32, device=dev).scatter_(
        1, order_c, torch.arange(C, dtype=i32, device=dev)[None, :].expand(
            N, C))
    kept_of_chain = torch.zeros((N, C), dtype=i32, device=dev).scatter_(
        1, order_c, fl.kept.to(i32))
    sc = chains.seed_chain
    scc = sc.clamp(0, C - 1).to(i64)
    in_kept = ((sc >= 0) & (torch.gather(kept_of_chain, 1, scc) > 0)
               & seeds.valid)
    p = torch.gather(ord_pos, 1, scc)
    slots = torch.arange(S, dtype=i64, device=dev)[None, :]
    key = (p.to(i64) << 24 | (512 - seeds.len.to(i64)) << 12
           | (S - slots))
    key = torch.where(in_kept, key, 1 << 40)
    order = torch.sort(key, dim=1, stable=True).indices
    w_chain = torch.gather(torch.where(in_kept, sc, -1), 1, order)
    return WorkList(order.to(i32), w_chain, in_kept.sum(dim=1).to(i32))


SKIP_CHECK_EVERY = 4     # skip-scan steps between host reads of the mask


def _extend_side(queryT, qlen, targetT, tlen, h0, end_bonus, *, w: int,
                 lq_max: int, t_max: int, **kw):
    """ksw_extend2 of one side at band w, rerun at 2w for the lanes whose
    max_off reached (w>>1)+(w>>2) (bwamem.c:732-741).  Returns
    (ExtendResult, band [B] int32: 2w where the lane reran, else w).

    Kernel #1 (ext_kernel.extend_batch_pl2) takes both passes in one
    launch.  It reruns a lane only where its score also left h0 and its
    query is not empty; max and max_off move together in ksw_extend2, so
    for a positive threshold the two conditions agree.  At w <= 1 the
    threshold is 0 and every lane reruns here (max_off >= 0), where the
    kernel would keep the first pass of a lane whose score stayed h0: the
    second pass then runs for every lane, at 2w, as one launch of kernel
    #2 (extend_batch_pl).  Past ext_kernel.LQ_MAX both passes are
    launches of kernel #2."""
    B = qlen.shape[0]
    thr = (w >> 1) + (w >> 2)
    wv = torch.full((B,), w, dtype=torch.int32, device=qlen.device)
    kk = dict(lq_max=lq_max, t_max=t_max, **kw)
    if thr > 0 and lq_max <= ext_kernel.LQ_MAX:
        res, retried = ext_kernel.extend_batch_pl2(
            queryT, qlen, targetT, tlen, h0, end_bonus, w_opt=w, **kk)
        return res, torch.where(retried != 0, 2 * w, w).to(torch.int32)
    if thr == 0:
        return (ext_kernel.extend_batch_pl(queryT, qlen, targetT, tlen, h0,
                                           2 * wv, end_bonus, **kk),
                2 * wv)
    r0 = ext_kernel.extend_batch_pl(queryT, qlen, targetT, tlen, h0, wv,
                                    end_bonus, **kk)
    wr = torch.where(r0.max_off >= thr, 2 * w, w).to(torch.int32)
    r1 = ext_kernel.extend_batch_pl(queryT, qlen, targetT, tlen, h0, wr,
                                    end_bonus, **kk)
    retry = wr != w
    return ExtendResult(*(torch.where(retry, b, a)
                          for a, b in zip(r0, r1))), wr


def extend_all(fm: fmops.FM, ctg_offsets, ctg_is_alt, seq, l_seq,
               seeds: Seeds, chains: Chains, fl: FilteredChains, *,
               a: int, o_del: int, e_del: int, o_ins: int, e_ins: int,
               w: int, zdrop: int, pen_clip5: int, pen_clip3: int,
               mat, reg_cap: int = 16) -> Regs:
    """mem_chain2aln over a batch in lockstep rounds (one host read a
    round).  The skip scan of a round takes up to S steps; a step in which
    no read skips changes nothing, nor does any step after it, so the host
    stops the scan there, looking at the skip mask once every
    SKIP_CHECK_EVERY steps."""
    N, LQ = seq.shape
    S = seeds.rbeg.shape[1]
    C = chains.pos.shape[1]
    R = reg_cap
    it = seeds.rbeg.dtype
    dev = seq.device
    i32, i64, f64 = torch.int32, torch.int64, torch.float64
    rows1 = torch.arange(N, device=dev)
    kext = dict(mat_bytes=np.asarray(mat, np.int8).tobytes(), o_del=o_del,
                e_del=e_del, o_ins=o_ins, e_ins=e_ins, zdrop=zdrop, w=w,
                lq_max=LQ)

    wl = build_worklist(seeds, chains, fl)
    rmax0, rmax1 = chain_rmax(seeds, chains, l_seq, fm, ctg_offsets,
                              a=a, o_del=o_del, e_del=e_del, o_ins=o_ins,
                              e_ins=e_ins, w=w)
    T_MAX = LQ + 2 * w + 4
    l_seq = l_seq.to(i32)
    seq64 = seq.to(i64)

    # per-work-item seed fields, in work order
    wslot = wl.seed_slot.to(i64)
    w_rbeg = torch.gather(seeds.rbeg, 1, wslot)
    w_qbeg = torch.gather(seeds.qbeg, 1, wslot)
    w_len = torch.gather(seeds.len, 1, wslot)
    w_chainv = wl.chain
    slots_s = torch.arange(S, dtype=i32, device=dev)[None, :]
    regs_r = torch.arange(R, dtype=i32, device=dev)[None, :]
    cols = torch.arange(LQ, dtype=i32, device=dev)[None, :]
    trow = torch.arange(T_MAX, dtype=it, device=dev)[:, None]

    # region tables with a spill column R that the appends past the cap
    # write and the result cuts off
    def table(fill, dtype):
        return torch.full((N, R + 1), fill, dtype=dtype, device=dev)

    rb, re = table(0, it), table(0, it)
    qb, qe, r_score, r_truesc, r_w, r_cov, r_sl0 = (
        table(0, i32) for _ in range(7))
    r_rid = table(-1, i32)
    n_regs = torch.zeros((N,), dtype=i32, device=dev)
    overflow = torch.zeros((N,), dtype=torch.bool, device=dev)
    ptr = torch.zeros((N,), dtype=i32, device=dev)
    marks = torch.ones((N, S), dtype=i32, device=dev)

    def item(tab, iptr):
        return tab[rows1, iptr]

    def skip_test(ptr):
        """The containment skip of each read's work item at ptr
        (bwamem.c:678-713)."""
        iptr = ptr.clamp(0, S - 1).to(i64)
        s_rb = item(w_rbeg, iptr)[:, None]
        s_qb = item(w_qbeg, iptr)[:, None]
        s_len = item(w_len, iptr)[:, None]
        s_ch = item(w_chainv, iptr)[:, None]
        rb_, re_, qb_, qe_ = rb[:, :R], re[:, :R], qb[:, :R], qe[:, :R]
        exist = regs_r < n_regs[:, None]
        contained = (exist & (s_rb >= rb_) & (s_rb + s_len <= re_)
                     & (s_qb >= qb_) & (s_qb + s_len <= qe_))
        len_ok = ((s_len - r_sl0[:, :R]).to(f64)
                  <= 0.1 * l_seq.to(f64)[:, None])
        qd = s_qb - qb_
        rd = (s_rb - rb_).to(i32)
        ww = torch.minimum(_cal_max_gap(torch.minimum(qd, rd), a, o_del,
                                        e_del, o_ins, e_ins, w), r_w[:, :R])
        around1 = (qd - rd < ww) & (rd - qd < ww)
        qd2 = qe_ - (s_qb + s_len)
        rd2 = (re_ - (s_rb + s_len)).to(i32)
        ww2 = torch.minimum(_cal_max_gap(torch.minimum(qd2, rd2), a, o_del,
                                         e_del, o_ins, e_ins, w),
                            r_w[:, :R])
        around2 = (qd2 - rd2 < ww2) & (rd2 - qd2 < ww2)
        found = (contained & len_ok & (around1 | around2)).any(dim=1)

        # overlapping-seed exception (bwamem.c:699-706): longer unskipped
        # seeds of the same chain on a different diagonal
        same_chain = (chains.seed_chain == s_ch) & (s_ch >= 0)
        longer = ((seeds.len > s_len)
                  | ((seeds.len == s_len)
                     & (slots_s > item(wslot, iptr)[:, None])))
        t_ok = (same_chain & longer & (marks > 0)
                & (seeds.len.to(f64) >= s_len.to(f64) * 0.95))
        t_qb, t_rb = seeds.qbeg, seeds.rbeg
        c1 = ((s_qb <= t_qb) & (s_qb + s_len - t_qb >= (s_len >> 2))
              & ((t_qb - s_qb).to(it) != t_rb - s_rb))
        c2 = ((t_qb <= s_qb) & (t_qb + seeds.len - s_qb >= (s_len >> 2))
              & ((s_qb - t_qb).to(it) != s_rb - t_rb))
        diff_aln = (t_ok & (c1 | c2)).any(dim=1)
        return found & ~diff_aln

    while bool((ptr < wl.n).any()):
        # ---- 1. advance ptr past skippable items ----
        for t in range(S):
            skip = skip_test(ptr) & (ptr < wl.n)
            slot = item(wslot, ptr.clamp(0, S - 1).to(i64))
            marks[rows1, slot] = torch.where(skip, 0, marks[rows1, slot])
            ptr = torch.where(skip, ptr + 1, ptr)
            if (t % SKIP_CHECK_EVERY == SKIP_CHECK_EVERY - 1
                    and not bool(skip.any())):
                break

        # ---- 2. batched extension of the current item ----
        act = ptr < wl.n
        iptr = ptr.clamp(0, S - 1).to(i64)
        s_rb = item(w_rbeg, iptr)
        s_qb = item(w_qbeg, iptr)
        s_len = item(w_len, iptr)
        s_ch = item(w_chainv, iptr).clamp(0, C - 1).to(i64)
        c_rmax0 = item(rmax0, s_ch)
        c_rmax1 = item(rmax1, s_ch)
        c_rid = item(chains.rid, s_ch)
        hi = 2 * fm.l_pac - 1

        # left: reversed query[0:qbeg], reversed ref[rmax0:rbeg]
        lq_idx = s_qb[:, None] - 1 - cols
        lqT = torch.where(lq_idx >= 0, torch.gather(
            seq64, 1, lq_idx.clamp(0, LQ - 1).to(i64)), 4).T
        lqlen = torch.where(act, s_qb, 0)
        ltlen = torch.where(act, (s_rb - c_rmax0).to(i32), 0)
        lh0 = (s_len * a).clamp(min=1)
        ltT = fmops.ref_base(fm, (s_rb[None, :] - 1 - trow).clamp(0, hi))
        eb5 = torch.full((N,), pen_clip5, dtype=i32, device=dev)
        Lres, aw0 = _extend_side(lqT, lqlen, ltT, ltlen, lh0, eb5,
                                 t_max=T_MAX, **kext)

        has_left = act & (s_qb > 0)
        loc_l = (Lres.gscore <= 0) | (Lres.gscore <= Lres.score - pen_clip5)
        score_l = torch.where(has_left, Lres.score, s_len * a)
        n_qb = torch.where(has_left & loc_l, s_qb - Lres.qle, 0)
        n_rb = torch.where(has_left,
                           torch.where(loc_l, s_rb - Lres.tle,
                                       s_rb - Lres.gtle.to(it)), s_rb)
        truesc_l = torch.where(has_left,
                               torch.where(loc_l, Lres.score, Lres.gscore),
                               s_len * a)

        # right: query[qe:], ref[rbeg+len : rmax1]
        s_qe = s_qb + s_len
        rq_idx = s_qe[:, None] + cols
        rqT = torch.where(rq_idx < l_seq[:, None], torch.gather(
            seq64, 1, rq_idx.clamp(0, LQ - 1).to(i64)), 4).T
        rqlen = torch.where(act, l_seq - s_qe, 0)
        rtlen = torch.where(act, (c_rmax1 - (s_rb + s_len)).to(i32), 0)
        sc0 = score_l.clamp(min=1)
        rtT = fmops.ref_base(fm, (s_rb[None, :] + s_len[None, :]
                                  + trow).clamp(0, hi))
        eb3 = torch.full((N,), pen_clip3, dtype=i32, device=dev)
        Rres, aw1 = _extend_side(rqT, rqlen, rtT, rtlen, sc0, eb3,
                                 t_max=T_MAX, **kext)

        has_right = act & (s_qe < l_seq)
        loc_r = (Rres.gscore <= 0) | (Rres.gscore <= Rres.score - pen_clip3)
        score_f = torch.where(has_right, Rres.score, score_l)
        n_qe = torch.where(has_right & loc_r, s_qe + Rres.qle, l_seq)
        n_re = torch.where(has_right,
                           s_rb + s_len + torch.where(loc_r, Rres.tle,
                                                      Rres.gtle).to(it),
                           s_rb + s_len)
        truesc_f = truesc_l + torch.where(
            has_right, torch.where(loc_r, Rres.score, Rres.gscore) - sc0, 0)
        n_w = torch.maximum(torch.where(has_left, aw0, w),
                            torch.where(has_right, aw1, w))

        # seedcov (bwamem.c:781-786)
        in_chain = chains.seed_chain == item(w_chainv, iptr)[:, None]
        cov_ok = (in_chain & (seeds.qbeg >= n_qb[:, None])
                  & (seeds.qbeg + seeds.len <= n_qe[:, None])
                  & (seeds.rbeg >= n_rb[:, None])
                  & (seeds.rbeg + seeds.len <= n_re[:, None]))
        cov = torch.where(cov_ok, seeds.len, 0).sum(dim=1, dtype=i32)

        # ---- 3. append region ----
        can = act & (n_regs < R)
        slot = torch.where(can, n_regs, R).to(i64)
        for tab, v in ((rb, n_rb), (re, n_re), (qb, n_qb), (qe, n_qe),
                       (r_score, score_f), (r_truesc, truesc_f),
                       (r_w, n_w), (r_cov, cov), (r_sl0, s_len),
                       (r_rid, c_rid)):
            tab[rows1, slot] = v.to(tab.dtype)
        overflow = overflow | (act & (n_regs >= R))
        n_regs = n_regs + can.to(i32)
        ptr = torch.where(act, ptr + 1, ptr)

    return Regs(rb=rb[:, :R], re=re[:, :R], qb=qb[:, :R], qe=qe[:, :R],
                score=r_score[:, :R], truesc=r_truesc[:, :R], w=r_w[:, :R],
                seedcov=r_cov[:, :R], seedlen0=r_sl0[:, :R],
                rid=r_rid[:, :R],
                frac_rep=seeds.frac_rep / l_seq.clamp(min=1).to(
                    torch.float32),
                n=n_regs, overflow=overflow)
