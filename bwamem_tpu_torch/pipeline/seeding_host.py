"""Host-compacted front half: seeding -> compact SA lookups -> grouped
chaining/worklists — the path of every row and batch the device front
(pipeline/device_front) hands back: reads that enter
mem_flt_chained_seeds (about 800 bp and longer), rows over its seed cap,
rows its final two-round walk demotes, and batches it does not support.

The device front runs every stage at one padded [N, S] shape.  This module

  1. runs the (exact 3-pass) SMEM seeding on the device (_p1/_p2/_p3_body
     below, the same three programs the device front runs),
  2. expands interval occurrences to seeds ON THE HOST (the occurrence-
     sampling arithmetic of mem_chain, bwamem.c:280-307 — pure indexing)
     into a COMPACT flat rank array,
  3. batch-translates only the real ranks through the device SA walk,
  4. groups reads by seed count and runs chaining/filter/worklist at each
     group's snug shape class (caps 16/64/256/1024 seeds),

so a read with a thousand seeds does not size the tensors of its batch.
Also home of what the device front shares with it: the flat-lane
compaction, the three seeding programs and the sizing, growth and
high-water history of their arenas.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.ops import align_ext
from bwamem_tpu_torch.ops import chain as chainops
from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.ops import smem as smemops
from bwamem_tpu_torch.parallel import mesh as pmesh
from bwamem_tpu_torch.pipeline import _shapes
from bwamem_tpu_torch.pipeline._shapes import pow2_bucket
from bwamem_tpu_torch.pipeline import chainflt_host
from bwamem_tpu_torch.utils import fetchguard, timers

i32 = torch.int32
i64 = torch.int64


def _compact_flat(mask, fields, arena):
    """Compact flat lanes: mask [T] bool; fields [(flat tensor, dtype)].
    Returns (outs [arena], n, overflow, pos) — pos is the target slot per
    source lane (for scattering results back to the source grid).  Lanes
    past the arena are DROPPED (written to a spill slot that is cut off),
    so output is only valid when overflow is False — callers must retry
    with a bigger arena.  n and overflow stay 0-d device tensors.

    Even on overflow every slot holds one whole lane: the reference clamps
    the lanes past the arena into its last slot, where a CUDA scatter with
    repeated indices may keep each field from another lane, and the
    gathers of the same dispatch (sa_lookup's rank from x0 and x2) then
    index past their tables, a device-side assert where JAX clamps."""
    pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    n_all = pos[-1] + 1
    over = n_all > arena
    tgt = torch.where(mask & (pos < arena), pos,
                      torch.full_like(pos, arena)).to(torch.int64)
    outs = []
    for a, dt in fields:
        o = torch.zeros(arena + 1, dtype=dt, device=mask.device)
        o[tgt] = a.reshape(-1).to(dt)
        outs.append(o[:arena])
    return outs, torch.clamp(n_all, max=arena), over, pos


def _ar(n, dtype, dev):
    return torch.arange(n, dtype=dtype, device=dev)


def _zero(dtype, dev):
    return torch.zeros((), dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# P1: pass-1 SMEM scan (bwt_smem1a forward+backward over every pivot chain)
# ---------------------------------------------------------------------------

def _stage_ladder(base: int, width: int):
    """Static halving arena ladder for back_extend_flat compaction; empty
    for small batches (compaction overhead beats the win only at scale).
    Candidate lifetimes are front-loaded (median 6 left steps), so deep
    halving keeps the arena tracking the survivor count."""
    if width < 8192:
        return ()
    out = []
    for j in range(8):
        # cap at the input arena width: a stage wider than its input can
        # never overflow but still runs its k steps
        w = min(max(base >> j, 512), width)
        if out and w == out[-1] == 512:
            break           # ladder hit the floor
        out.append(w)
    return tuple(out)


def _p1_body(fm, seq, l_seq, *, cap, kmax, emax, min_seed_len, use_kmer,
             b1s, t1s):
    N, L = seq.shape
    it = fm.itype
    dev = seq.device
    pre = smemops.kmer_pre0(fm, seq, l_seq) if use_kmer else None
    c1 = smemops.forward_scan(fm, seq, l_seq, torch.zeros((N,), dtype=i32,
                                                          device=dev),
                              torch.ones((N,), dtype=it, device=dev), cap,
                              multi_pivot=True, pre=pre, max_steps=t1s)
    rows = _ar(N, i32, dev)[:, None].expand(N, cap)
    slots = _ar(cap, i32, dev)[None, :].expand(N, cap)
    mask1 = (slots < c1.n[:, None]).reshape(-1)
    (lane_read, pivot, fx0, fx1, fx2), nk, k_over, pos1 = _compact_flat(
        mask1, [(rows, i32), (c1.pivot, i32), (c1.x0, it), (c1.x1, it),
                (c1.x2, it)], kmax)
    fvalid = _ar(kmax, i32, dev) < nk
    st1 = _stage_ladder(b1s, kmax)
    ones = torch.ones((kmax,), dtype=it, device=dev)
    if st1:
        s_f, x0_f, x2_f, b1_over, b1_need = smemops.back_extend_flat(
            fm, seq, lane_read, pivot, fx0, fx1, fx2, ones, fvalid,
            stage_w=st1)
    else:
        s_f, x0_f, x2_f = smemops.back_extend_flat(
            fm, seq, lane_read, pivot, fx0, fx1, fx2, ones, fvalid)
        b1_over = _zero(torch.bool, dev)
        b1_need = _zero(i32, dev)
    maskg = mask1.reshape(N, cap)
    back = torch.where(maskg, pos1.reshape(N, cap).clamp(max=kmax - 1),
                       0).to(i64)
    s_grid = torch.where(maskg, s_f[back], 0)
    x0_grid = torch.where(maskg, x0_f[back], 0)
    x2_grid = torch.where(maskg, x2_f[back], 0)
    emit1 = smemops.emit_mask(c1, s_grid.reshape(-1))
    smem1 = emit1 & ((c1.end - s_grid) >= min_seed_len)
    (e_read, e_s, e_e, e_x0, e_x2), n1, e_over, _ = _compact_flat(
        smem1.reshape(-1), [(rows, it), (s_grid, it), (c1.end, it),
                            (x0_grid, it), (x2_grid, it)], emax)
    sec1 = torch.stack([e_read, e_s, e_e, e_x0, e_x2])
    flags = (c1.overflow.any().to(i32)
             | (k_over.to(i32) << 1) | (e_over.to(i32) << 2)
             | (b1_over.to(i32) << 9)
             | (c1.unfinished.to(i32) << 11))
    meta = torch.stack([n1.to(i32), flags, c1.n.max().to(i32),
                        nk.to(i32), n1.to(i32), b1_need.to(i32),
                        c1.steps.to(i32), _zero(i32, dev)])
    return sec1, meta


# ---------------------------------------------------------------------------
# P2: re-seeding of long low-occurrence SMEMs (bwamem.c:155-165)
# ---------------------------------------------------------------------------

def _p2_body(fm, seq, l_seq, sec1, n1, *, pmax, cand2, k2max, e2max,
             min_seed_len, split_len, split_width, b2s, t2s):
    it = fm.itype
    dev = seq.device
    emax = sec1.shape[1]
    e_read, e_s, e_e, e_x0, e_x2 = (sec1[k] for k in range(5))
    lane1 = _ar(emax, i32, dev)
    qual = ((lane1 < n1) & ((e_e - e_s) >= split_len)
            & (e_x2 <= split_width))
    (p_read, p_start, p_min), n_par, p_over, _ = _compact_flat(
        qual, [(e_read.to(i32), i32),
               ((e_s + e_e).to(i32) >> 1, i32), (e_x2 + 1, it)], pmax)
    p_alive = _ar(pmax, i32, dev) < n_par
    p_lseq = torch.where(p_alive, l_seq[p_read.to(i64)], 0).to(l_seq.dtype)
    c2 = smemops.forward_scan(
        fm, seq, p_lseq, torch.where(p_alive, p_start, 0),
        torch.where(p_alive, p_min, 1), cand2, multi_pivot=False,
        lane_read=p_read, max_steps=t2s)
    rows2 = p_read[:, None].expand(pmax, cand2)
    slots2 = _ar(cand2, i32, dev)[None, :].expand(pmax, cand2)
    mask2 = (slots2 < c2.n[:, None]).reshape(-1)
    min2g = p_min[:, None].expand(pmax, cand2)
    (lr2, pv2, bx0, bx1, bx2, mi2), nk2, k2_over, pos2 = _compact_flat(
        mask2, [(rows2, i32), (c2.pivot, i32), (c2.x0, it), (c2.x1, it),
                (c2.x2, it), (min2g, it)], k2max)
    v2 = _ar(k2max, i32, dev) < nk2
    st2 = _stage_ladder(b2s, k2max)
    if st2:
        s2f, x0f2, x2f2, b2_over, b2_need = smemops.back_extend_flat(
            fm, seq, lr2, pv2, bx0, bx1, bx2, mi2, v2, stage_w=st2)
    else:
        s2f, x0f2, x2f2 = smemops.back_extend_flat(
            fm, seq, lr2, pv2, bx0, bx1, bx2, mi2, v2)
        b2_over = _zero(torch.bool, dev)
        b2_need = _zero(i32, dev)
    mask2g = mask2.reshape(pmax, cand2)
    back2 = torch.where(mask2g, pos2.reshape(pmax, cand2).clamp(
        max=k2max - 1), 0).to(i64)
    s2_grid = torch.where(mask2g, s2f[back2], 0)
    x0_2g = torch.where(mask2g, x0f2[back2], 0)
    x2_2g = torch.where(mask2g, x2f2[back2], 0)
    emit2 = smemops.emit_mask(c2, s2_grid.reshape(-1))
    smem2 = emit2 & ((c2.end - s2_grid) >= min_seed_len)
    (e2_read, e2_s, e2_e, e2_x0, e2_x2), n2, e2_over, _ = _compact_flat(
        smem2.reshape(-1), [(rows2, it), (s2_grid, it), (c2.end, it),
                            (x0_2g, it), (x2_2g, it)], e2max)
    sec2 = torch.stack([e2_read, e2_s, e2_e, e2_x0, e2_x2])
    flags = ((p_over.to(i32) << 3) | (c2.overflow.any().to(i32) << 4)
             | (k2_over.to(i32) << 5) | (e2_over.to(i32) << 6)
             | (b2_over.to(i32) << 10)
             | (c2.unfinished.to(i32) << 12))
    meta = torch.stack([n2.to(i32), flags, n_par.to(i32),
                        c2.n.max().to(i32), nk2.to(i32),
                        n2.to(i32), b2_need.to(i32), c2.steps.to(i32)])
    return sec2, meta


# ---------------------------------------------------------------------------
# P3: LAST-like forward-only pass (bwt_seed_strategy1, bwt.c:358-379)
# ---------------------------------------------------------------------------

def _p3_body(fm, seq, l_seq, *, p3cap, e3max, min_seed_len, max_mem_intv,
             use_kmer, t3s):
    N, L = seq.shape
    it = fm.itype
    dev = seq.device
    pre = smemops.kmer_pre(fm, seq, l_seq) if use_kmer else None
    p3x0, p3x2, p3s, p3e, p3n, p3over, p3steps, p3unf = smemops.pass3_scan(
        fm, seq, l_seq, min_seed_len, max_mem_intv, p3cap, pre=pre,
        max_steps=t3s)
    rows3 = _ar(N, i32, dev)[:, None].expand(N, p3cap)
    m3 = _ar(p3cap, i32, dev)[None, :].expand(N, p3cap) < p3n[:, None]
    (e3_read, e3_s, e3_e, e3_x0, e3_x2), n3, e3_over, _ = _compact_flat(
        m3.reshape(-1), [(rows3, it), (p3s, it), (p3e, it),
                         (p3x0, it), (p3x2, it)], e3max)
    sec3 = torch.stack([e3_read, e3_s, e3_e, e3_x0, e3_x2])
    flags = ((p3over.any().to(i32) << 7) | (e3_over.to(i32) << 8)
             | (p3unf.to(i32) << 13))
    z = _zero(i32, dev)
    meta = torch.stack([n3.to(i32), flags, p3n.max().to(i32),
                        n3.to(i32), p3steps.to(i32), z, z, z])
    return sec3, meta


_GROW1 = ("cap", "kmax", "emax")
_GROW2 = ("pmax", "cand2", "k2max", "e2max")  # bits 3..6 of p2 flags
_GROW3 = ("p3cap", "e3max")                   # bits 7..8 of p3 flags
_GROWB = ("b1s", "b2s")                       # bits 9..10: back-ext ladders
_GROWT = ("t1s", "t2s", "t3s")                # bits 11..13: scan trip counts


def _sizes_for(hist: dict, N: int, Lr: int) -> dict:
    """Arena sizes from an in-memory high-water history (25% headroom),
    falling back to shape-scaled defaults on the first batch of a shape."""
    # flat arenas, in entries per 128 read bases (one short read).  Long
    # reads (from 512 bases: the ones the host-compacted front takes) get
    # their own densities, measured on 1000-base reads at 2% and 8%
    # substitutions: noisy reads fill up to 0.7 pass-1 lanes a base.  A
    # first long-read batch then does not rerun its scans (thousands of
    # trips each) to grow an arena.
    per128 = {"kmax": 16, "emax": 8, "pmax": 2, "k2max": 8, "e2max": 4,
              "e3max": 2, "a_seed": 8, "a_ch": 4, "a_it": 8, "a_sel": 2,
              "b1s": 8, "b2s": 4}
    if Lr >= 512:
        # b1s/b2s: a long read's candidates extend left for tens of bases,
        # so the halving ladder of back_extend_flat would overflow; a base
        # width of 2^7 arenas keeps all 8 stages at the arena width
        per128.update(kmax=128, pmax=4, k2max=32, e3max=8, a_seed=16,
                      a_ch=8, a_it=16, a_sel=4, b1s=128 << 7, b2s=32 << 7)
    R = N * max(1, Lr // 128)
    defaults = {k: pow2_bucket(R * v, lo=256 if k == "pmax" else 1024)
                for k, v in per128.items()}
    defaults.update(cap=2 * Lr, cand2=48, s_cap=64,
                    p3cap=max(32, pow2_bucket(Lr // 16, lo=8)))
    # scan trip counts: multiples of 32 (a trip count scales time, not
    # memory, so fine granularity avoids a 2x overshoot).  The pass-2 scan
    # follows ONE pivot from the middle of its parent SMEM and ends within
    # a few hundred bases; its step journal is [t2s, pmax, 6], so long
    # reads start it at 512 trips and grow it if a lane is unfinished.
    defaults["t1s"] = -(-(Lr + (Lr >> 1) + 24) // 32) * 32
    defaults["t2s"] = min(-(-(Lr + 8) // 32) * 32, 512)
    defaults["t3s"] = defaults["t1s"]
    floors = {"cap": 64, "kmax": 1024, "emax": 1024, "pmax": 256,
              "cand2": 16, "k2max": 1024, "e2max": 1024, "p3cap": 16,
              "e3max": 1024, "a_seed": 1024, "s_cap": 16, "a_ch": 1024,
              "a_it": 1024, "a_sel": 1024, "b1s": 1024, "b2s": 1024,
              "t1s": 32, "t2s": 32, "t3s": 32}
    sizes = {}
    for k, d in defaults.items():
        h = hist.get(("hwm", k, (N, Lr)))
        if h is None:
            sizes[k] = d
        elif k in _GROWT:
            sizes[k] = max(-(-(int(h) + (int(h) >> 3) + 1) // 32) * 32,
                           floors[k])
        else:
            sizes[k] = pow2_bucket(int(h + (h >> 2) + 1), lo=floors[k])
    return sizes


def use_kmer_table(al) -> bool:
    """k-mer fast start: only when the index carries the table and the skip
    is provably exact (min_seed_len >= K, see ops.smem.kmer_pre)."""
    return (al.fm.kmer is not None
            and getattr(al.opt, "use_kmer_table", True)
            and al.opt.min_seed_len >= smemops.KMER_K)


def _seeding_kw(opt: MemOptions, sizes: dict, use_kmer: bool):
    """Keyword sets of the three seeding programs (_p1/_p2/_p3_body)."""
    s1 = dict(cap=sizes["cap"], kmax=sizes["kmax"], emax=sizes["emax"],
              min_seed_len=opt.min_seed_len, use_kmer=use_kmer,
              b1s=sizes["b1s"], t1s=sizes["t1s"])
    s2 = dict(pmax=sizes["pmax"], cand2=sizes["cand2"],
              k2max=sizes["k2max"], e2max=sizes["e2max"],
              min_seed_len=opt.min_seed_len, split_len=opt.split_len,
              split_width=opt.split_width,
              b2s=sizes["b2s"], t2s=sizes["t2s"])
    s3 = dict(p3cap=sizes["p3cap"], e3max=sizes["e3max"],
              min_seed_len=opt.min_seed_len,
              max_mem_intv=opt.max_mem_intv, use_kmer=use_kmer,
              t3s=sizes["t3s"])
    return s1, s2, s3


def _seeding_overflows(m1, m2, m3) -> list:
    """Names of the seeding arenas whose overflow bit is set in the fetched
    metas of _p1/_p2/_p3_body."""
    flags = int(m1[1]) | int(m2[1]) | int(m3[1])
    return [name for bit, name in enumerate(_GROW1 + _GROW2 + _GROW3
                                            + _GROWB + _GROWT)
            if (flags >> bit) & 1]


def _grow_sizes(sizes: dict, grow, m1, m2) -> None:
    """Double every arena in `grow` (None entries are skipped).  The
    back-extend ladders report the exact base width that would have fit
    (b*_need) — jump straight there."""
    for g in grow:
        if g is not None:
            sizes[g] *= 2
    if "b1s" in grow:
        sizes["b1s"] = max(sizes["b1s"],
                           pow2_bucket(int(m1[5]) + 1, lo=1024))
    if "b2s" in grow:
        sizes["b2s"] = max(sizes["b2s"],
                           pow2_bucket(int(m2[6]) + 1, lo=1024))


def _note_seeding_hwm(hist, key, m1, m2, m3) -> bool:
    return _note_hwm(hist, key, cap=m1[2], kmax=m1[3], emax=m1[4],
                     pmax=m2[2], cand2=m2[3], k2max=m2[4], e2max=m2[5],
                     p3cap=m3[2], e3max=m3[3], b1s=m1[5], b2s=m2[6],
                     t1s=m1[6], t2s=m2[7], t3s=m3[4])


def _note_hwm(hist, N, **vals) -> bool:
    """Raise the high-water marks of `vals` under key N; True when one
    rose."""
    changed = False
    for k, v in vals.items():
        key = ("hwm", k, N)
        if int(v) > hist.get(key, 0):
            hist[key] = int(v)
            changed = True
    return changed


def _chain_worklist(fm, ctg_offsets, ctg_is_alt, seeds, l_seq, *,
                    arena, w, max_chain_gap, mask_level, drop_ratio,
                    min_chain_weight, max_chain_extend, min_seed_len,
                    a, o_del, e_del, o_ins, e_ins):
    """Chain + filter + worklist for one read group; outputs are COMPACTED
    to the work that exists and bit-packed, so one group costs one small
    fetch instead of a dozen padded [G, C] grids:

      flat  [7, arena] i32 (or [4,.] i32 + [3,.] it when the index is
            int64): per-WORK-ITEM (slot<<16|chain) in read-major work
            order, then per-CHAIN (w<<16|fq), (lq<<16|ll), (rid<<1|alt),
            rmax0, rmax1, pos in read-major storage order
      sc16  [G, C] int16: seed -> chain assignment (replay needs all seeds)
      cnts  [G] i32: wl_n<<16 | chain_n<<1 | overflow

    `arena` >= the group's true seed count guarantees no compaction
    overflow (work items and chains are each <= seeds)."""
    ch = chainops.chain_seeds(seeds, ctg_is_alt, fm.l_pac, w=w,
                              max_chain_gap=max_chain_gap,
                              chain_cap=seeds.rbeg.shape[1])
    wt = chainops.chain_weights(seeds, ch)
    fl = chainops.filter_chains(
        ch, wt, seeds, mask_level=mask_level, drop_ratio=drop_ratio,
        min_seed_len=min_seed_len, max_chain_gap=max_chain_gap,
        min_chain_weight=min_chain_weight,
        max_chain_extend=max_chain_extend)
    wl = align_ext.build_worklist(seeds, ch, fl)
    rmax0, rmax1 = align_ext.chain_rmax(
        seeds, ch, l_seq, fm, ctg_offsets,
        a=a, o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins, w=w)
    it = ch.pos.dtype
    G, C = ch.pos.shape
    slots = torch.arange(C, dtype=i32, device=ch.pos.device)[None, :].expand(
        G, C)
    wmask = (slots < wl.n[:, None]).reshape(-1)
    pkw = (wl.seed_slot.to(i32) << 16) | (wl.chain.to(i32) & 0xFFFF)
    (fw,), _, w_over, _ = _compact_flat(wmask, [(pkw, i32)], arena)
    cmask = (slots < ch.n[:, None]).reshape(-1)
    pk1 = (wt.to(i32) << 16) | (ch.first_qbeg.to(i32) & 0xFFFF)
    pk2 = (ch.last_qbeg.to(i32) << 16) | (ch.last_len.to(i32) & 0xFFFF)
    pk3 = (ch.rid.to(i32) << 1) | ch.is_alt.to(i32)
    (f1, f2, f3), _, c_over, _ = _compact_flat(
        cmask, [(pk1, i32), (pk2, i32), (pk3, i32)], arena)
    (fr0, fr1, fps), _, _, _ = _compact_flat(
        cmask, [(rmax0, it), (rmax1, it), (ch.pos, it)], arena)
    over = ch.overflow | w_over | c_over
    cnts = (wl.n.to(i32) << 16) | (ch.n.to(i32) << 1) | over.to(i32)
    sc16 = ch.seed_chain.to(torch.int16)
    if it == i32:
        return torch.stack([fw, f1, f2, f3, fr0, fr1, fps]), sc16, cnts
    return (torch.stack([fw, f1, f2, f3]), torch.stack([fr0, fr1, fps]),
            sc16, cnts)


class SeedsNp(NamedTuple):
    """Numpy view compatible with what extend_host consumes."""
    qbeg: np.ndarray
    rbeg: np.ndarray
    len: np.ndarray
    valid: np.ndarray
    frac_rep: np.ndarray


class WorklistNp(NamedTuple):
    seeds: SeedsNp
    seed_chain: np.ndarray
    wl_slot: np.ndarray
    wl_chain: np.ndarray
    wl_n: np.ndarray
    rmax0: np.ndarray
    rmax1: np.ndarray
    chain_rid: np.ndarray
    overflow: np.ndarray
    # per-chain summaries for the host tie-order fixup (chainflt_host)
    chain_w: np.ndarray     # [G, C] mem_chain_weight
    chain_pos: np.ndarray   # [G, C] B-tree key (creation rbeg)
    chain_fq: np.ndarray    # [G, C] chn_beg (first seed qbeg)
    chain_lq: np.ndarray    # [G, C] last seed qbeg
    chain_ll: np.ndarray    # [G, C] last seed len
    chain_alt: np.ndarray   # [G, C] bool
    chain_n: np.ndarray     # [G]


def _intv2rid_np(ctg_offsets, l_pac, rb, slen):
    """bns_intv2rid (bntseq.c:370-378), vectorized on host."""
    re = rb + slen
    pb = np.where(rb >= l_pac, 2 * l_pac - 1 - rb, rb)
    pe_in = re - 1
    pe = np.where(pe_in >= l_pac, 2 * l_pac - 1 - pe_in, pe_in)
    rid_b = np.searchsorted(ctg_offsets, pb, side="right") - 1
    rid_e = np.searchsorted(ctg_offsets, pe, side="right") - 1
    rid = np.where(rid_b == rid_e, rid_b, -1)
    return np.where((rb < l_pac) & (re > l_pac), -2, rid).astype(np.int32)


def _np_itype(fm) -> np.dtype:
    return np.dtype(np.int64 if fm.itype == torch.int64 else np.int32)


def _fetch(x: torch.Tensor, what: str = "fetch") -> np.ndarray:
    """One tensor to the host under the fetch watchdog (utils/fetchguard:
    FetchTimeout past its timeout)."""
    return fetchguard.fetch([x], what=what)[0]


def front_half(al, reads, seq: np.ndarray, l_seq: np.ndarray,
               group_caps=(16, 64, 256, 1024)):
    """al: Aligner; returns a list of (read_indices, WorklistNp) groups."""
    opt: MemOptions = al.opt
    dev = al.device
    n = len(reads)
    with timers.section("seed.collect"):
        read_iv, iv_s, iv_e, iv_x0, iv_x2, _overflow = \
            collect_intervals_host(al, seq, l_seq, n)

    # ---- occurrence sampling (mem_chain loop, bwamem.c:280-307) ----
    counts = np.minimum(iv_x2, opt.max_occ).astype(np.int64)
    step = np.where(iv_x2 > opt.max_occ, iv_x2 // opt.max_occ, 1)
    M = int(counts.sum())
    owner = np.repeat(np.arange(counts.size, dtype=np.int64), counts)
    cum = np.concatenate([[0], np.cumsum(counts)])
    k_within = np.arange(M, dtype=np.int64) - cum[owner]
    ranks = iv_x0[owner] + k_within * step[owner]
    read_of = read_iv[owner].astype(np.int32)
    qbeg = iv_s[owner].astype(np.int32)
    slen = (iv_e - iv_s)[owner].astype(np.int32)

    # ---- compact device SA walk ----
    it = _np_itype(al.fm)
    if M:
        with timers.section("seed.sa_walk"):
            Mp = _shapes.lanes(M, dev, fine_lo=256, coarse_lo=1024,
                               shards=pmesh.shards(al.mesh))
            rk = np.zeros(Mp, dtype=it)
            rk[:M] = ranks
            rbeg = _fetch(pmesh.over(al.mesh, fmops.sa_lookup, {},
                                     (True, False))(
                al.fm, torch.from_numpy(rk).to(dev)), "sa_walk")[:M]
            rbeg = rbeg.astype(np.int64)
    else:
        rbeg = np.zeros(0, np.int64)
    rid = _intv2rid_np(al.ctg_offsets_np, al.l_pac, rbeg, slen)
    # mem_chain skips a seed whose bns_intv2rid < 0 before it reaches the
    # chains: drop them here; slot order preserved
    keep = rid >= 0
    read_of, qbeg, slen, rbeg, rid = (a[keep] for a in
                                      (read_of, qbeg, slen, rbeg, rid))
    seed_cnt = np.bincount(read_of, minlength=n)

    # ---- frac_rep (l_rep union, bwamem.c:272-279) ----
    with timers.section("seed.l_rep"):
        l_rep = np.zeros(n, np.float32)
        rep = iv_x2 > opt.max_occ
        for i in np.unique(read_iv[rep]):
            b = e = lr = 0
            sel = rep & (read_iv == i)  # flat order is (start, end) asc
            for sb, se in zip(iv_s[sel], iv_e[sel]):
                if sb > e:
                    lr += e - b
                    b, e = int(sb), int(se)
                else:
                    e = max(e, int(se))
            l_rep[i] = lr + (e - b)

    # ---- group reads by seed count; chain at snug shapes ----
    order = np.argsort(read_of, kind="stable")
    starts = np.concatenate([[0], np.cumsum(seed_cnt)])
    statics = dict(
        w=opt.w, max_chain_gap=opt.max_chain_gap,
        mask_level=opt.mask_level, drop_ratio=opt.drop_ratio,
        min_chain_weight=opt.min_chain_weight,
        max_chain_extend=opt.max_chain_extend,
        min_seed_len=opt.min_seed_len, a=opt.a, o_del=opt.o_del,
        e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins)

    def submit_group(ridx, cap):
        """Build the group's packed seed arrays and ENQUEUE the chaining
        dispatch; the fetch is deferred to drain_group so the device works
        through every group while the host packs the next."""
        G = ridx.size
        Gp = _shapes.lanes(G, dev, fine_lo=8, coarse_lo=64,
                           shards=pmesh.shards(al.mesh))
        g_qbeg = np.zeros((Gp, cap), np.int32)
        g_rbeg = np.zeros((Gp, cap), it)
        g_len = np.zeros((Gp, cap), np.int32)
        g_rid = np.full((Gp, cap), -1, np.int32)
        g_valid = np.zeros((Gp, cap), bool)
        for gi, i in enumerate(ridx):
            sl = order[starts[i]:starts[i + 1]][:cap]
            c = sl.size
            g_qbeg[gi, :c] = qbeg[sl]
            g_rbeg[gi, :c] = rbeg[sl]
            g_len[gi, :c] = slen[sl]
            g_rid[gi, :c] = rid[sl]
            g_valid[gi, :c] = True
        g_l = np.ones(Gp, np.int32)
        g_l[:G] = l_seq[ridx]
        g_frac = np.pad(l_rep[ridx], (0, Gp - G))
        # arena >= true seed count => the device compactions cannot overflow
        # (work items and chains are each at most one per seed)
        arena = pow2_bucket(max(int(g_valid.sum()), 1), lo=256)

        def put(a):
            return torch.from_numpy(a).to(dev)

        seeds = chainops.Seeds(
            rbeg=put(g_rbeg), qbeg=put(g_qbeg), len=put(g_len),
            rid=put(g_rid), valid=put(g_valid), frac_rep=put(g_frac),
            overflow=torch.zeros(Gp, dtype=torch.bool, device=dev))
        # under a mesh the compactions are shard-local: each shard's
        # [., arena] block follows the one before on axis 1
        res = pmesh.over(
            al.mesh, _chain_worklist, dict(statics, arena=arena),
            (True, True, True, False, False),
            out_mask=("ax1", False, False) if it == np.int32
            else ("ax1", "ax1", False, False))(
            al.fm, al.ctg_offsets, al.ctg_is_alt, seeds, put(g_l))
        return ridx, (g_qbeg, g_rbeg, g_len, g_valid, g_frac), res, arena

    def drain_group(plan):
        ridx, (g_qbeg, g_rbeg, g_len, g_valid, g_frac), res, arena = plan
        if len(res) == 3:
            flat, sc16, cnts = fetchguard.fetch(res, what="chain_grid")
            fitp = flat[4:7].astype(it)
        else:
            flat, fitp, sc16, cnts = fetchguard.fetch(res,
                                                      what="chain_grid")
        Gp, C = sc16.shape
        wl_n = (cnts >> 16).astype(np.int32)
        chain_n = ((cnts >> 1) & 0x7FFF).astype(np.int32)
        if (cnts[:ridx.size] & 1).any():
            # cannot happen: arena >= group seed count bounds both
            # compactions and chain_cap == seed cap bounds the B-tree
            raise RuntimeError("chain worklist compaction overflow")
        wl_slot = np.zeros((Gp, C), np.int16)
        wl_chain = np.full((Gp, C), -1, np.int16)
        rmax0 = np.zeros((Gp, C), it)
        rmax1 = np.zeros((Gp, C), it)
        c_pos = np.zeros((Gp, C), it)
        c_w = np.zeros((Gp, C), np.int32)
        c_fq = np.zeros((Gp, C), np.int32)
        c_lq = np.zeros((Gp, C), np.int32)
        c_ll = np.zeros((Gp, C), np.int32)
        c_rid = np.full((Gp, C), -1, np.int32)
        c_alt = np.zeros((Gp, C), bool)

        def scatter(dst_list, src_list, counts_row, base, r0):
            """Unpack a shard's read-major flat arrays (from column `base`,
            its rows from r0) into [rows, C] grids."""
            k = counts_row.sum()
            if not k:
                return
            rows_r = np.repeat(np.arange(counts_row.size), counts_row)
            cum = np.concatenate([[0], np.cumsum(counts_row)])
            cols = np.arange(k) - cum[rows_r]
            for dst, src in zip(dst_list, src_list):
                dst[rows_r + r0, cols] = src[base:base + k]

        # one arena a shard (one shard off a mesh), a shard's block of rows
        # after another's
        nsh = flat.shape[1] // arena
        Gs = Gp // nsh
        wv = flat[0]
        for sh in range(nsh):
            r0 = sh * Gs
            scatter([wl_slot, wl_chain],
                    [(wv >> 16).astype(np.int16),
                     (wv & 0xFFFF).astype(np.int16)],
                    wl_n[r0:r0 + Gs], sh * arena, r0)
            scatter([c_w, c_fq, c_lq, c_ll, c_rid, c_alt, rmax0, rmax1,
                     c_pos],
                    [flat[1] >> 16, flat[1] & 0xFFFF, flat[2] >> 16,
                     flat[2] & 0xFFFF, flat[3] >> 1,
                     (flat[3] & 1).astype(bool), fitp[0], fitp[1], fitp[2]],
                    chain_n[r0:r0 + Gs], sh * arena, r0)
        wr = WorklistNp(
            seeds=SeedsNp(qbeg=g_qbeg, rbeg=g_rbeg, len=g_len,
                          valid=g_valid, frac_rep=g_frac),
            seed_chain=sc16.astype(np.int32), wl_slot=wl_slot,
            wl_chain=wl_chain, wl_n=wl_n, rmax0=rmax0,
            rmax1=rmax1, chain_rid=c_rid,
            overflow=(cnts & 1).astype(bool),
            chain_w=c_w, chain_pos=c_pos, chain_fq=c_fq, chain_lq=c_lq,
            chain_ll=c_ll, chain_alt=c_alt,
            chain_n=chain_n)
        chainflt_host.fix_tied_rows(wr, opt)
        return wr

    def g_tile(cap):
        # bounds the [G, cap, 8] chain table the chaining loop rewrites on
        # every one of its `cap` trips
        return max(128, 131072 // cap)

    plans = []
    with timers.section("seed.group_submit"):
        assigned = np.zeros(n, bool)
        for cap in group_caps:
            sel = (~assigned) & (seed_cnt <= cap) & (seed_cnt > 0)
            assigned |= sel
            ridx = np.nonzero(sel)[0]
            for s0, c in _shapes.chunks(ridx.size, tile=g_tile(cap)):
                plans.append(submit_group(ridx[s0:s0 + c], cap))
        # reads beyond the largest cap: truncated to the first `cap` seeds
        # (slot order == insertion order)
        rest = np.nonzero((~assigned) & (seed_cnt > 0))[0]
        for s0, c in _shapes.chunks(rest.size, tile=g_tile(group_caps[-1])):
            plans.append(submit_group(rest[s0:s0 + c], group_caps[-1]))
    with timers.section("seed.group_drain"):
        return [(p[0], drain_group(p)) for p in plans]


# --------------------------------------------------------------------------
# 3-pass interval collection: pass 1 (SMEM forward scan + backward extension
# + emission), pass 2 (re-seeding of long low-occurrence SMEMs on
# device-compacted parent lanes) and pass 3 (LAST-like short-seed scan) run
# as the device front's three seeding programs, each compacting its
# emissions into a flat arena; the host fetches the three metas in one
# tensor, then only the filled part of each arena.  Semantics are those of
# mem_collect_intv (bwamem.c:137-185).
# --------------------------------------------------------------------------

_MAX_RETRIES = 16


def _collect_programs(fm, seq, l_seq, *, s1, s2, s3, pass3):
    """The three seeding programs on one device (or one shard's rows):
    (meta [24, 1], sec1, sec2, sec3), the metas as a column so shards
    stack on axis 1."""
    sec1, m1 = _p1_body(fm, seq, l_seq, **s1)
    sec2, m2 = _p2_body(fm, seq, l_seq, sec1, m1[0], **s2)
    if pass3:
        sec3, m3 = _p3_body(fm, seq, l_seq, **s3)
    else:
        sec3, m3 = sec2[:, :0], torch.zeros((8,), dtype=i32,
                                            device=seq.device)
    return torch.cat([m1, m2, m3])[:, None], sec1, sec2, sec3


def collect_intervals_host(al, seq_np: np.ndarray, l_seq: np.ndarray,
                           n: int, kmax0: int = 0, emax0: int = 0):
    """Returns flat per-interval arrays (read, start, end, x0, x2) sorted by
    (read, start, end) — mem_collect_intv output (bwamem.c:137-185) plus an
    overflow flag per read (always all-False: every arena overflow is
    retried with a grown arena until the output fits; RuntimeError after
    16 retries).

    The arena sizes start from the aligner's high-water history of this
    batch shape (al._seed_arena_hist) or shape-scaled defaults; under a
    mesh every shard has arenas of its own, sized and keyed by per-shard
    rows.  kmax0 / emax0 override the initial pass-1 arena sizes (tests
    use tiny values to force the grow-and-retry path)."""
    opt: MemOptions = al.opt
    dev = al.device
    nsh = pmesh.shards(al.mesh)
    if seq_np.shape[0] % nsh:
        # a batch under the shard count: empty rows give every shard one
        seq_np = np.pad(seq_np, ((0, -seq_np.shape[0] % nsh), (0, 0)))
        l_seq = np.pad(l_seq, (0, -l_seq.shape[0] % nsh))
    seq_d = torch.from_numpy(np.ascontiguousarray(seq_np)).to(dev)
    l_d = torch.from_numpy(np.ascontiguousarray(l_seq)).to(dev)
    N, Lr = seq_np.shape
    key = (N // nsh, Lr)
    hist = al._seed_arena_hist
    sizes = _sizes_for(hist, *key)
    if kmax0:
        sizes["kmax"] = kmax0
    if emax0:
        sizes["emax"] = emax0
    use_kmer = use_kmer_table(al)
    retries = 0
    while True:
        s1, s2, s3 = _seeding_kw(opt, sizes, use_kmer)
        kw = dict(s1=s1, s2=s2, s3=s3, pass3=opt.max_mem_intv > 0)
        with timers.section("seed.collect_rt"):
            meta_d, sec1, sec2, sec3 = pmesh.over(
                al.mesh, _collect_programs, kw, (True, False, False),
                out_mask="ax1")(al.fm, seq_d, l_d)
            meta_st = _fetch(meta_d, "seed_collect.meta")     # [24, nsh]
        # flags of any shard (OR), counts and high-water marks of the
        # fullest (max)
        meta = meta_st.max(axis=1)
        for sl in (1, 9, 17):
            meta[sl] = np.bitwise_or.reduce(meta_st[sl])
        m1, m2, m3 = meta[:8], meta[8:16], meta[16:]
        # grow whichever arena overflowed and rerun: dropped-lane output is
        # incomplete, silently truncating seeds is not an option
        grow = _seeding_overflows(m1, m2, m3)
        if not grow:
            break
        retries += 1
        if retries > _MAX_RETRIES:
            raise RuntimeError(f"seeding arena growth did not converge: "
                               f"{grow} sizes={sizes}")
        _grow_sizes(sizes, grow, m1, m2)
        timers.count("seed.retries")
        for g in grow:
            timers.count("seed.grow." + g)
    # running max of the measured high-water marks sizes the next batch
    _note_seeding_hwm(hist, key, m1, m2, m3)
    # the filled head of each shard's three arenas; shard-local read rows
    # become batch rows
    parts = []
    for sh in range(nsh):
        for k, sec in enumerate((sec1, sec2, sec3)):
            w = sec.shape[1] // nsh
            parts.append(sec[:, sh * w: sh * w + int(meta_st[8 * k, sh])])
    allv = _fetch(torch.cat(parts, dim=1), "seed_collect")
    read_iv = allv[0].astype(np.int32)
    if nsh > 1:
        lens = [p.shape[1] for p in parts]
        read_iv += np.repeat(np.repeat(np.arange(nsh, dtype=np.int32)
                                       * key[0], 3), lens)
    start = allv[1].astype(np.int64)
    end = allv[2].astype(np.int64)
    x0 = allv[3].astype(np.int64)
    x2 = allv[4].astype(np.int64)
    # sort by (read, start, end) — ks_introsort(mem_intv) on info; stable,
    # so ties keep pass-1 < pass-2 < pass-3 emission order
    order = np.lexsort((end, start, read_iv))
    overflow = np.zeros(n, bool)
    return (read_iv[order], start[order], end[order], x0[order], x2[order],
            overflow)


# --------------------------------------------------------------------------
# Stand-alone single-pass scan wrappers.  The mem pipeline uses the three
# seeding programs above; these are the building blocks of the SMEM-
# enumeration CLI tools (fastmap, maxk — fastmap.c:324, maxk.c:12), which
# need raw per-pivot SMEMs rather than the 3-pass seeding output.
# --------------------------------------------------------------------------

def scan_trips(L: int) -> int:
    """First trip count of _fwd_scan for reads padded to L bases: the
    pass-1 default of _sizes_for (t1s)."""
    return -(-(L + (L >> 1) + 24) // 32) * 32


def _fwd_scan(fm, seq, l_seq, start, min_intv, *, cap, multi_pivot):
    """forward_scan run to completion, as the JAX package's while_loop
    form (max_steps=None) does: rerun with twice the trips while a lane is
    unfinished.  Candidates past `cap` are dropped (overflow), as there.
    A lane needs at most one trip per base and one per pivot, so the trip
    count converges.  timers: seed.scan.trips (every trip run, reruns
    included) and seed.scan.reruns."""
    trips = scan_trips(seq.shape[1])
    while True:
        c = smemops.forward_scan(fm, seq, l_seq, start, min_intv, cap,
                                 multi_pivot=multi_pivot, max_steps=trips)
        timers.count("seed.scan.trips", trips)
        if not bool(c.unfinished):
            return c
        if trips > 4 * (seq.shape[1] + 1):
            raise RuntimeError(f"forward_scan unfinished after {trips} "
                               f"trips on reads of {seq.shape[1]} bases")
        timers.count("seed.scan.reruns")
        trips *= 2


class SmemBatch(NamedTuple):
    """Per-pivot SMEM candidates of one batch (host arrays, rows [n])."""
    pivot: np.ndarray    # [n, cap] candidate's pivot
    end: np.ndarray      # [n, cap] match end (exclusive)
    s: np.ndarray        # [n, cap] leftmost start after back-extension
    x0: np.ndarray       # [n, cap] interval of [s, end)
    x2: np.ndarray       # [n, cap] its size
    cnt: np.ndarray      # [n] candidates written
    emit: np.ndarray     # [n, cap] bool: the candidate is an SMEM
    l_seq: np.ndarray    # [n] read lengths


def smem_batch(fm, reads, min_intv: int) -> SmemBatch:
    """The SMEMs of every read of `reads` (bwt_smem1a over each pivot of
    the read, min interval size min_intv): the forward scan, every
    candidate back-extended in one flat lane set, then the emission rule —
    the body of fastmap and maxk (bwamem_tpu/cli.py:360-398).  timers:
    seed.scan, seed.back_ext (each up to its fetch)."""
    from bwamem_tpu_torch.io.fastq import pack_batch
    dev = fm.device
    it = _np_itype(fm)
    n = len(reads)
    N = pow2_bucket(n, lo=8)
    L = pow2_bucket(max(r.l_seq for r in reads), lo=32)
    seq, l_seq = pack_batch(reads, N, L)
    cap = 2 * L
    seq_d = torch.from_numpy(seq).to(dev)

    def put(a):
        return torch.from_numpy(a).to(dev)

    with timers.section("seed.scan"):
        c1 = _fwd_scan(fm, seq_d, put(l_seq),
                       torch.zeros(N, dtype=i32, device=dev),
                       torch.full((N,), min_intv, dtype=fm.itype,
                                  device=dev), cap=cap, multi_pivot=True)
        pivot, end, cx0, cx1, cx2, cnt = (_fetch(x)[:n] for x in (
            c1.pivot, c1.end, c1.x0, c1.x1, c1.x2, c1.n))
    rows, slots = np.nonzero(np.arange(cap)[None, :] < cnt[:, None])
    M = rows.size
    s = np.zeros((n, cap), np.int32)
    x0a = np.zeros((n, cap), it)
    x2a = np.zeros((n, cap), it)
    if M:
        Mp = pow2_bucket(M, lo=256)
        lr = np.zeros(Mp, np.int32)
        pv = np.zeros(Mp, np.int32)
        bx = [np.zeros(Mp, it) for _ in range(3)]
        va = np.zeros(Mp, bool)
        lr[:M] = rows
        pv[:M] = pivot[rows, slots]
        bx[0][:M] = cx0[rows, slots]
        bx[1][:M] = cx1[rows, slots]
        bx[2][:M] = cx2[rows, slots]
        va[:M] = True
        # no compaction ladder: the closing loop runs L + 1 trips and a
        # lane retires at the latest when its position passes 0 (pivot <
        # L), so every lane runs to its end, as the JAX while_loop does
        with timers.section("seed.back_ext"):
            sf, x0f, x2f = (_fetch(x)[:M] for x in smemops.back_extend_flat(
                fm, seq_d, put(lr), put(pv), put(bx[0]), put(bx[1]),
                put(bx[2]), put(np.full(Mp, min_intv, it)), put(va)))
        s[rows, slots] = sf
        x0a[rows, slots] = x0f
        x2a[rows, slots] = x2f
    # the emission rule on the host copies (smem.emit_mask)
    emit = smemops.emit_mask(c1._replace(pivot=torch.from_numpy(pivot),
                                         n=torch.from_numpy(cnt)),
                             torch.from_numpy(s).reshape(-1)).numpy()
    return SmemBatch(pivot, end, s, x0a, x2a, cnt, emit, l_seq[:n])
