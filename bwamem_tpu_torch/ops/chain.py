"""Seed expansion, seed chaining and chain weights.

Replaces the reference's per-read kbtree insertion chaining (mem_chain,
bwamem.c:258-322).  On a CUDA tensor chain_seeds launches the hand-written
kernel of csrc/chain_kernel.cu (a warp a read, over the read's own
seeds); on a CPU tensor it runs chain_seeds_plain, the reference
package's read-lockstep loop: every read processes one seed per step, and
the per-read "closest chain" lookup becomes a masked reduction over a
fixed-width chain table.  There is no fallback between the two (a failed
build or launch raises).  Containment, strand blocking, band/gap growth
rules and weight = min(query, ref) coverage follow the reference exactly.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.ops.launch import Library
from bwamem_tpu_torch.ops.smem import Intervals

_vp, _ci, _cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = Library("chain_kernel.cu", {
    "chain_launch": [_vp] * 5 + [_cl] * 5 + [_vp, _ci] + [_vp] * 12
                    + [_ci] * 4 + [_cl] * 3}, flags=["-Xptxas", "-v"])
SRC = LIB.src

launches = 0        # kernel launches by chain_seeds (CUDA tensors)


class Seeds(NamedTuple):
    rbeg: torch.Tensor      # [N, S] it — both-strands start
    qbeg: torch.Tensor      # [N, S] int32
    len: torch.Tensor       # [N, S] int32
    rid: torch.Tensor       # [N, S] int32 (<0 = discarded)
    valid: torch.Tensor     # [N, S] bool
    frac_rep: torch.Tensor  # [N] float32
    overflow: torch.Tensor  # [N] bool


def expand_seeds(fm: fmops.FM, ctg_offsets: torch.Tensor, iv: Intervals,
                 max_occ: int, seed_cap: int) -> Seeds:
    """Occurrence sampling + SA translation (mem_chain loop, bwamem.c:280-307).

    Seed slot order = sorted-interval order x occurrence order, which is the
    reference's chaining insertion order.  Step-sampling keeps exactly
    min(x2, max_occ) occurrences with stride floor(x2/max_occ).  Only the
    filled slots walk the suffix array (one host read of their count); an
    empty slot holds rank 0's position, as a walk from rank 0 gives.
    """
    N, I = iv.start.shape
    it = fm.itype
    dev = iv.start.device
    counts = torch.where(iv.valid, iv.x2.clamp(max=max_occ), 0).to(it)
    cum = torch.cumsum(counts, dim=1, dtype=it)               # [N, I]
    total = cum[:, -1]
    overflow = total > seed_cap

    slots = torch.arange(seed_cap, dtype=it, device=dev)[None, :].expand(
        N, seed_cap).contiguous()                           # [N, S]
    # interval that owns each slot
    own = torch.searchsorted(cum, slots, right=True)
    own_c = own.clamp(0, I - 1)
    prev_cum = torch.where(own_c > 0,
                           torch.gather(cum, 1, (own_c - 1).clamp(min=0)), 0)
    k_within = slots - prev_cum
    x0 = torch.gather(iv.x0, 1, own_c)
    x2 = torch.gather(iv.x2, 1, own_c)
    start = torch.gather(iv.start, 1, own_c)
    end = torch.gather(iv.end, 1, own_c)
    step = torch.where(x2 > max_occ, x2 // max_occ, 1)
    valid = slots < total[:, None]
    rank = torch.where(valid, x0 + k_within * step, 0).to(it)

    live = torch.nonzero(valid.reshape(-1))[:, 0]
    rbeg = fmops.sa_lookup(fm, rank.new_zeros(1)).repeat(N * seed_cap)
    rbeg[live] = fmops.sa_lookup(fm, rank.reshape(-1)[live])
    rbeg = rbeg.reshape(N, seed_cap)
    slen = (end - start).to(torch.int32)
    rid = fmops.intv2rid(fm, ctg_offsets, rbeg, rbeg + slen)
    valid = valid & (rid >= 0)

    # frac_rep: union length of intervals with x2 > max_occ (bwamem.c:272-279)
    rep = iv.valid & (iv.x2 > max_occ)
    sb = torch.where(rep, iv.start, 0)
    se = torch.where(rep, iv.end, 0)
    # running max of previous ends among rep intervals (sorted by start)
    run_end = torch.cummax(torch.where(rep, se, -1), dim=1).values
    prev_end = torch.cat([torch.full((N, 1), -1, dtype=run_end.dtype,
                                     device=dev), run_end[:, :-1]], dim=1)
    contrib = torch.where(
        rep, (se - torch.maximum(sb, prev_end)).clamp(min=0), 0)
    l_rep = contrib.sum(dim=1)
    return Seeds(rbeg=rbeg, qbeg=start, len=slen, rid=rid, valid=valid,
                 frac_rep=l_rep.to(torch.float32), overflow=overflow)


class Chains(NamedTuple):
    pos: torch.Tensor        # [N, C] it — first seed rbeg (B-tree key)
    rid: torch.Tensor        # [N, C] int32
    is_alt: torch.Tensor     # [N, C] bool
    first_qbeg: torch.Tensor  # [N, C] int32
    first_rbeg: torch.Tensor  # [N, C] it
    last_qbeg: torch.Tensor   # [N, C] int32
    last_rbeg: torch.Tensor   # [N, C] it
    last_len: torch.Tensor    # [N, C] int32
    n_seeds: torch.Tensor     # [N, C] int32
    n: torch.Tensor           # [N] chains created
    seed_chain: torch.Tensor  # [N, S] int32 — chain of each seed (-1 = none)
    overflow: torch.Tensor    # [N] bool


def _imax(dtype) -> int:
    return torch.iinfo(dtype).max


def chain_seeds(seeds: Seeds, ctg_is_alt: torch.Tensor, l_pac: int,
                w: int, max_chain_gap: int, chain_cap: int) -> Chains:
    """Sequential-equivalent chaining (mem_chain + test_and_merge,
    bwamem.c:197-307) of every read's valid seeds in slot order: for each
    seed, find the chain with the largest pos <= rbeg (kb_intervalp's
    lower; the later-created chain on ties), try to merge per
    test_and_merge, else open a new chain keyed at rbeg while the read has
    fewer than chain_cap (else its overflow flag).

    The CUDA kernel on a CUDA tensor, chain_seeds_plain on a CPU one; the
    two give the same Chains bit for bit."""
    if not seeds.rbeg.is_cuda:
        return chain_seeds_plain(seeds, ctg_is_alt, l_pac, w, max_chain_gap,
                                 chain_cap)
    return launch_chain(seeds, ctg_is_alt, l_pac, w, max_chain_gap,
                        chain_cap)


def _rows(x: torch.Tensor, dtype) -> torch.Tensor:
    """x as `dtype` with unit column stride (a row-strided view passes
    as it is: the kernel takes each grid's row stride)."""
    x = x.to(dtype)
    return x if x.stride(1) == 1 else x.contiguous()


def launch_chain(seeds: Seeds, ctg_is_alt: torch.Tensor, l_pac: int, w: int,
                 max_chain_gap: int, chain_cap: int) -> Chains:
    """chain_kernel on CUDA tensors (chain_seeds' launch): outputs
    allocated here and written once by the kernel, no [N, C, 8] state."""
    global launches
    N, S = seeds.rbeg.shape
    C = chain_cap
    it = seeds.rbeg.dtype
    if it not in (torch.int32, torch.int64):
        raise ValueError(f"chain_seeds: rbeg of type {it}")
    dev = seeds.rbeg.device
    i32 = torch.int32
    grids = [_rows(seeds.rbeg, it), _rows(seeds.qbeg, i32),
             _rows(seeds.len, i32), _rows(seeds.rid, i32),
             _rows(seeds.valid, torch.bool)]
    alt_of = ctg_is_alt.to(dev, i32).contiguous()
    index = seeds.rbeg.get_device()
    for x in grids:
        if x.shape != (N, S):
            raise ValueError(f"chain_seeds: seed grid of shape "
                             f"{tuple(x.shape)} for [{N}, {S}]")
    if any(x.get_device() != index for x in (*grids, alt_of)):
        raise ValueError("chain_seeds: tensors on different devices")

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)
    ch = Chains(pos=empty((N, C), it), rid=empty((N, C), i32),
                is_alt=empty((N, C), torch.bool),
                first_qbeg=empty((N, C), i32), first_rbeg=empty((N, C), it),
                last_qbeg=empty((N, C), i32), last_rbeg=empty((N, C), it),
                last_len=empty((N, C), i32), n_seeds=empty((N, C), i32),
                n=empty((N,), i32), seed_chain=empty((N, S), i32),
                overflow=empty((N,), torch.bool))
    LIB.launch("chain_launch", index, (
        *(x.data_ptr() for x in grids), *(x.stride(0) for x in grids),
        alt_of.data_ptr(), int(alt_of.numel()),
        *(x.data_ptr() for x in ch), int(N), int(S), int(C),
        int(it == torch.int64), int(l_pac), int(w), int(max_chain_gap)),
        "chain_kernel")
    launches += 1
    return ch


def chain_seeds_plain(seeds: Seeds, ctg_is_alt: torch.Tensor, l_pac: int,
                      w: int, max_chain_gap: int, chain_cap: int) -> Chains:
    """The plain version of chain_seeds, lockstep over reads: S trips, one
    seed per read per trip, the chain table one [N, C, 8] state that each
    trip reduces with a one-hot mask and rewrites (the reference package's
    chain_seeds, a lax.fori_loop of jnp)."""
    N, S = seeds.rbeg.shape
    C = chain_cap
    it = seeds.rbeg.dtype
    dev = seeds.rbeg.device
    i32 = torch.int32
    BIG = _imax(it)

    # per-chain state in one [N, C, 8] array (pos, rid<<1|alt, fq, fr, lq,
    # lr, ll, ns); the loop body reads and writes it with one-hot masks
    P_POS, P_RA, P_FQ, P_FR, P_LQ, P_LR, P_LL, P_NS = range(8)
    lanesC = torch.arange(C, dtype=i32, device=dev)[None, :]
    g = torch.zeros((N, C, 8), dtype=it, device=dev)
    g[:, :, P_POS] = BIG
    g[:, :, P_RA] = -2                    # rid -1, alt 0
    n = torch.zeros((N,), dtype=i32, device=dev)
    seed_chain = torch.full((N, S), -1, dtype=i32, device=dev)
    overflow = torch.zeros((N,), dtype=torch.bool, device=dev)
    alt_of = ctg_is_alt.to(dev)

    for s in range(S):
        rb = seeds.rbeg[:, s]
        qb = seeds.qbeg[:, s].to(it)
        sl = seeds.len[:, s].to(it)
        srid = seeds.rid[:, s]
        svalid = seeds.valid[:, s]

        pos = g[:, :, P_POS]
        exists = lanesC < n[:, None]
        cand = exists & (pos <= rb[:, None])
        has_lower = cand.any(dim=1)
        # argmax of (pos, j): later-created chain wins ties
        key = torch.where(cand, pos, torch.full_like(pos, -BIG))
        maxpos = key.max(dim=1).values
        tie = cand & (pos == maxpos[:, None])
        lower = torch.where(tie, lanesC, -1).max(dim=1).values

        oh_low = lanesC == lower[:, None]              # [N, C]
        c = torch.where(oh_low[:, :, None], g, 0).sum(dim=1, dtype=it)
        c_rid = (c[:, P_RA] >> 1).to(i32)
        c_fq, c_fr = c[:, P_FQ], c[:, P_FR]
        c_lq, c_lr, c_ll = c[:, P_LQ], c[:, P_LR], c[:, P_LL]
        qend = c_lq + c_ll
        rend = c_lr + c_ll

        same_rid = srid == c_rid
        contained = ((qb >= c_fq) & (qb + sl <= qend)
                     & (rb >= c_fr) & (rb + sl <= rend))
        strand_block = ((c_lr < l_pac) | (c_fr < l_pac)) & (rb >= l_pac)
        x = qb - c_lq
        y = rb - c_lr
        grow = ((y >= 0) & (x - y <= w) & (y - x <= w)
                & (x - c_ll < max_chain_gap) & (y - c_ll < max_chain_gap))
        merged = svalid & has_lower & same_rid & (contained
                                                  | (~strand_block & grow))
        appended = merged & ~contained
        new = svalid & ~merged & (n < C)

        # ONE masked write serves both cases (disjoint per lane): the
        # appended row keeps (pos, ra, fq, fr) and refreshes the tail; a
        # new chain writes the full row at slot n
        new_ra = ((srid.to(it) << 1)
                  | (alt_of[srid.clamp(min=0).to(torch.int64)] > 0).to(it))
        app_row = torch.stack([c[:, P_POS], c[:, P_RA], c_fq, c_fr,
                               qb, rb, sl, c[:, P_NS] + 1], dim=-1)
        new_row = torch.stack([rb, new_ra, qb, rb, qb, rb, sl,
                               torch.ones_like(rb)], dim=-1)
        wmask = torch.where(appended[:, None], oh_low,
                            new[:, None] & (lanesC == n[:, None]))
        wrow = torch.where(appended[:, None], app_row, new_row)
        g = torch.where(wmask[:, :, None], wrow[:, None, :], g)

        seed_chain[:, s] = torch.where(
            appended, lower.clamp(0, C - 1),
            torch.where(new, n, torch.full_like(n, -1)))
        overflow = overflow | (svalid & ~merged & (n >= C))
        n = n + new.to(i32)

    return Chains(g[:, :, P_POS], (g[:, :, P_RA] >> 1).to(i32),
                  (g[:, :, P_RA] & 1).to(torch.bool),
                  g[:, :, P_FQ].to(i32), g[:, :, P_FR],
                  g[:, :, P_LQ].to(i32), g[:, :, P_LR],
                  g[:, :, P_LL].to(i32), g[:, :, P_NS].to(i32), n,
                  seed_chain, overflow)


def seeds_by_chain(seeds: Seeds, chains: Chains):
    """Reorder seeds per read by (chain, insertion slot) and return
    (order, chain_of_sorted_seed, valid).  Within a chain the order equals
    insertion order, which test_and_merge guarantees is non-decreasing in
    both qbeg and rbeg — required by mem_chain_weight's sweep."""
    N, S = seeds.rbeg.shape
    in_chain = chains.seed_chain >= 0
    key = torch.where(in_chain, chains.seed_chain, 2 ** 30).to(torch.int64)
    slots = torch.arange(S, dtype=torch.int64, device=key.device)[None, :]
    order = torch.argsort(key * (S + 1) + slots, dim=1)
    sc = torch.gather(chains.seed_chain, 1, order)
    return order, sc, sc >= 0


def seg_cummax(vals: torch.Tensor, seg_start: torch.Tensor,
               span: int) -> torch.Tensor:
    """Running max along the last axis that restarts at every seg_start
    (a segmented max scan).  vals must lie in [-1, span - 2]: each segment
    is lifted by `span` times its ordinal so earlier segments never win."""
    seg = torch.cumsum(seg_start.to(torch.int64), dim=-1)
    lifted = vals.to(torch.int64) + seg * span
    return torch.cummax(lifted, dim=-1).values - seg * span


def chain_weights(seeds: Seeds, chains: Chains) -> torch.Tensor:
    """mem_chain_weight (bwamem.c:220-239): min of query- and ref-coverage
    of the chain's seeds, via segmented running-max sweeps."""
    N, S = seeds.rbeg.shape
    C = chains.pos.shape[1]
    dev = seeds.rbeg.device
    order, sc, svalid = seeds_by_chain(seeds, chains)
    i64 = torch.int64
    qb = torch.gather(seeds.qbeg, 1, order).to(i64)
    rb = torch.gather(seeds.rbeg, 1, order).to(i64)
    sl = torch.gather(seeds.len, 1, order).to(i64)
    seg_start = torch.cat([torch.ones((N, 1), dtype=torch.bool, device=dev),
                           sc[:, 1:] != sc[:, :-1]], dim=1)
    rows = torch.arange(N, device=dev)[:, None].expand(N, S)
    cols = sc.clamp(0, C - 1).to(i64)

    def coverage(beg):
        endv = beg + sl
        # ends are both-strands coordinates (< 2^40 for any genome)
        run = seg_cummax(endv, seg_start, 1 << 40)
        prev = torch.cat([torch.zeros((N, 1), dtype=i64, device=dev),
                          run[:, :-1]], dim=1)
        prev = torch.where(seg_start, 0, prev)
        cov = torch.where(svalid,
                          (endv - torch.maximum(beg, prev)).clamp(min=0), 0)
        out = torch.zeros((N, C), dtype=i64, device=dev)
        return out.index_put_((rows, cols), cov, accumulate=True)

    wq = coverage(qb)
    wr = coverage(rb)
    w = torch.minimum(wq, wr)
    return w.clamp(max=(1 << 30) - 1).to(torch.int32)


class FilteredChains(NamedTuple):
    order: torch.Tensor   # [N, C] chain indices in weight-desc processing order
    kept: torch.Tensor    # [N, C] 0/1/2/3 per ORDERED position
    w: torch.Tensor       # [N, C] weight per ordered position
    n: torch.Tensor       # [N] chains entering the filter


def filter_chains(chains: Chains, weights: torch.Tensor, seeds: Seeds,
                  *, mask_level: float, drop_ratio: float, min_seed_len: int,
                  max_chain_gap: int, min_chain_weight: int,
                  max_chain_extend: int) -> FilteredChains:
    """mem_chain_flt (bwamem.c:334-392), lockstep over reads.

    Chains are processed in weight-descending order (stable on the B-tree
    traversal order = pos ascending) against the kept list; shadowed chains
    with a sufficiently lower weight are dropped, and each kept chain's first
    shadowed victim is resurrected with kept=1 for mapq accuracy.  One trip
    per ordered position, up to the largest count of heavy chains in the
    group (one host read of that count)."""
    N, C = weights.shape
    dev = weights.device
    i32, f32 = torch.int32, torch.float32
    # chain span on the query: first seed qbeg .. last seed qbeg+len
    beg = chains.first_qbeg
    end = chains.last_qbeg + chains.last_len
    idxs = torch.arange(C, dtype=i32, device=dev)[None, :]
    exists = idxs < chains.n[:, None]
    heavy = exists & (weights >= min_chain_weight)
    # order: traversal order is pos ascending (creation order on ties), then
    # a stable sort by weight descending
    trav_key = torch.sort(
        torch.where(exists, chains.pos, _imax(chains.pos.dtype)), dim=1,
        stable=True).indices
    w_trav = torch.gather(weights, 1, trav_key)
    h_trav = torch.gather(heavy, 1, trav_key)
    sort2 = torch.sort(torch.where(h_trav, -w_trav, 2 ** 30).to(i32), dim=1,
                       stable=True).indices
    order = torch.gather(trav_key, 1, sort2)               # [N, C]
    w_ord = torch.gather(weights, 1, order)
    beg_o = torch.gather(beg, 1, order)
    end_o = torch.gather(end, 1, order)
    alt_o = torch.gather(chains.is_alt, 1, order)
    n_f = torch.gather(heavy, 1, order).sum(dim=1)

    kept = torch.zeros((N, C), dtype=i32, device=dev)
    kept[:, 0] = torch.where(n_f > 0, 3, 0)
    first = torch.full((N, C), -1, dtype=i32, device=dev)
    li_all = end_o - beg_o
    w_f = w_ord.to(f32)
    # positions at or past a row's n_f are inactive: they change nothing
    for i in range(1, min(C, int(n_f.max())) if N else 0):
        active = i < n_f                                   # [N]
        in_kept = kept >= 2                                # kept list members
        b_max = torch.maximum(beg_o, beg_o[:, i, None])
        e_min = torch.minimum(end_o, end_o[:, i, None])
        ovl = (e_min > b_max) & (~alt_o | alt_o[:, i, None])
        min_l = torch.minimum(li_all, li_all[:, i, None])
        sig = (ovl & ((e_min - b_max).to(f32) >= min_l.to(f32) * mask_level)
               & (min_l < max_chain_gap) & in_kept)
        dropj = sig & ((w_f[:, i, None] < w_f * drop_ratio)
                       & (w_ord - w_ord[:, i, None] >= (min_seed_len << 1)))
        brk = torch.where(dropj, idxs, C).min(dim=1).values  # first breaking j
        dropped = active & (brk < C)
        upto = sig & (idxs <= brk[:, None])
        mark = upto & (first < 0) & active[:, None]
        first = torch.where(mark, i, first).to(i32)
        large = upto.any(dim=1)
        kept_i = torch.where(dropped, 0, torch.where(large, 2, 3)).to(i32)
        kept[:, i] = torch.where(active, kept_i, kept[:, i])
    # resurrection: for kept chains with first >= 0, set kept[first] = 1
    # (column C collects the chains with nothing to resurrect and is cut)
    is_kept = kept >= 2
    res = torch.zeros((N, C + 1), dtype=torch.bool, device=dev)
    res.scatter_(1, torch.where(is_kept & (first >= 0), first, C
                                ).to(torch.int64),
                 torch.ones((N, C), dtype=torch.bool, device=dev))
    kept = torch.where(res[:, :C] & (kept == 0), 1, kept)
    # max_chain_extend: cap the number of kept in {1, 2} chains; once the
    # cap is hit, all later kept<3 chains are dropped
    ext = (kept == 1) | (kept == 2)
    cum_ext = torch.cumsum(ext.to(i32), dim=1)
    over = ext & (cum_ext > max_chain_extend)
    hit = torch.cumsum(over.to(i32), dim=1) > 0
    kept = torch.where(hit & (kept < 3), 0, kept).to(i32)
    return FilteredChains(order=order, kept=kept, w=w_ord, n=n_f)
