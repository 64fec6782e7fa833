"""Device-resident front half: reads -> extended alignment candidates in six
chained device programs with ONE fetch of their results.

  P1/P2/P3  3-pass SMEM seeding (ops/smem) emitting flat interval arenas
            (mem_collect_intv, reference bwamem.c:137-185); the programs
            and their arena sizing live in pipeline/seeding_host, which
            runs them too
  EXPAND    occurrence sampling + SA walk + rid filter + l_rep union +
            scatter into per-read seed grids (mem_chain head,
            bwamem.c:272-307)
  CHAIN     chaining (mem_chain, bwamem.c:197-307: the CUDA kernel of
            ops/chain on the card, a warp a read over its own seeds; the
            lockstep loop on the CPU) + chain weights + reference windows
            (mem_chain_weight, bwamem.c:220-332) + a compact per-chain
            arena for the host's exact filter
  EXT       every seed of every heavy chain extended speculatively by the
            extension kernel (left + band-doubling retry + right,
            ksw_extend2 semantics; the CUDA kernel on the card, its plain
            version on the CPU) + per-item seedcov

The host then runs the EXACT mem_chain_flt over the fetched per-chain arena
and replays mem_chain2aln's sequential skip/accept walk (bwamem.c:674-793)
with the extension results in hand (native hostops.c replay_batch).
Extending dropped-chain seeds wastes only device lanes; acceptance is
bit-identical to the reference.

Every arena has a static size; a program that overflows one reports it in
its meta vector, and the driver grows the arena and reruns the batch.
Reads that overflow the per-read seed cap, long reads that enter
mem_flt_chained_seeds (bwamem.c:607-625) and reads the final two-round
walk demotes need the host-compacted front (pipeline/seeding_host +
pipeline/extend_host): front_finish returns them as fallback rows and
the caller re-runs them there.  A batch in which half the rows or more are
such long reads is not dispatched at all: every row is handed back.  So
is a batch the front gives up on (FrontBailout: arena growth that does
not converge, or a chain table overflow), as the reference package's
front_finish does.

Under a data-parallel mesh (parallel/mesh) the six programs run shard by
shard on each shard's rows, every arena shard-local and sized by per-shard
rows, single-round extension only; front_finish combines the shards'
metas and merges their arenas into the one read-major layout the host
replay reads.
"""
from __future__ import annotations

import json
import math
import os
import sys
import tempfile

import numpy as np
import torch

from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.finalize import AlnReg
from bwamem_tpu_torch.ops import align_ext
from bwamem_tpu_torch.ops import chain as chainops
from bwamem_tpu_torch.ops import ext_kernel
from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.parallel import mesh as pmesh
from bwamem_tpu_torch.pipeline.chainflt_host import (
    MEM_HSP_COEF, MEM_MINSC_COEF, MEM_SEEDSW_COEF)
from bwamem_tpu_torch.pipeline._shapes import pow2_bucket
from bwamem_tpu_torch.pipeline.seeding_host import (
    _ar, _compact_flat, _fetch, _grow_sizes, _note_hwm, _note_seeding_hwm,
    _p1_body, _p2_body, _p3_body, _seeding_kw, _seeding_overflows,
    _sizes_for, _zero, use_kmer_table)
from bwamem_tpu_torch.utils import fetchguard, timers

i32 = torch.int32
i64 = torch.int64


def _put(shape, fill, dtype, dev, idx, vals):
    """zeros(shape).at[idx].set(vals, mode="drop") where an index equal to
    the size of its axis drops the write (spill row/column cut off)."""
    out = torch.full(tuple(s + 1 for s in shape), fill, dtype=dtype,
                     device=dev)
    out[idx] = vals.to(dtype)
    return out[tuple(slice(0, s) for s in shape)]


# ---------------------------------------------------------------------------
# EXPAND: flat intervals -> per-read seed grids
# ---------------------------------------------------------------------------

def _expand_body(fm, ctg_offsets, sec1, n1, sec2, n2, sec3, n3, *, max_occ,
                 a_seed, s_cap, n_reads):
    it = fm.itype
    dev = sec1.device
    N = n_reads
    S = s_cap
    e1, e2w = sec1.shape[1], sec2.shape[1]
    cat = torch.cat([sec1, sec2, sec3], dim=1)
    read, s, e, x0, x2 = (cat[k] for k in range(5))
    A = read.shape[0]
    lane = _ar(A, i32, dev)
    valid = torch.where(lane < e1, lane < n1,
                        torch.where(lane < e1 + e2w, lane - e1 < n2,
                                    lane - e1 - e2w < n3))
    # sort by (read, start, end) — ks_introsort(mem_intv) on info; stable,
    # ties keep pass-1 < pass-2 < pass-3 emission order.  One composite
    # int64 key: reads < 2^23, positions < 2^20.
    readk = torch.where(valid, read, N).to(i64)
    key = (readk << 40) | (s.to(i64) << 20) | e.to(i64)
    order = torch.sort(key, stable=True).indices
    valid = valid[order]
    read = torch.where(valid, readk[order], 0).to(i32)
    s, e, x0, x2 = s[order], e[order], x0[order], x2[order]

    # ---- occurrence sampling (mem_chain loop, bwamem.c:280-307) ----
    counts = torch.where(valid, x2.clamp(max=max_occ), 0).to(it)
    cum = torch.cumsum(counts, 0, dtype=it)
    total = cum[-1]
    seed_arena_over = total > a_seed
    slots = _ar(a_seed, it, dev)
    own = torch.searchsorted(cum, slots, right=True).to(i32)
    ownc = own.clamp(0, A - 1).to(i64)
    prev = torch.where(ownc > 0, cum[(ownc - 1).clamp(min=0)],
                       _zero(it, dev))
    k_within = slots - prev
    x0o = x0[ownc]
    x2o = x2[ownc]
    step = torch.where(x2o > max_occ, x2o // max_occ, 1)
    svalid = slots < total
    rank = torch.where(svalid, x0o + k_within * step, 0).to(it)
    rbeg = fmops.sa_lookup(fm, rank)
    sread = torch.where(svalid, read[ownc], N).to(i32)
    qbeg = torch.where(svalid, s[ownc], 0).to(i32)
    slen = torch.where(svalid, (e - s)[ownc], 0).to(i32)
    rid = fmops.intv2rid(fm, ctg_offsets, rbeg, rbeg + slen)
    svalid = svalid & (rid >= 0)

    # per-read slot among valid seeds (invalid-rid seeds dropped BEFORE slot
    # assignment, matching the host-compacted front)
    csum = torch.cumsum(svalid.to(i32), 0, dtype=i32)
    sread64 = sread.to(i64)
    seed_cnt = torch.zeros((N + 1,), dtype=i32, device=dev).index_add_(
        0, sread64, svalid.to(i32))[:N]
    read_base = torch.cat([torch.zeros((1,), dtype=i32, device=dev),
                           torch.cumsum(seed_cnt, 0, dtype=i32)[:-1]])
    slot = csum - 1 - read_base[sread64.clamp(0, N - 1)]
    ok = svalid & (slot < S)
    tgt = (torch.where(ok, sread, N).to(i64),
           torch.where(ok, slot, 0).to(i64))
    g_qbeg = _put((N, S), 0, i32, dev, tgt, qbeg)
    g_len = _put((N, S), 0, i32, dev, tgt, slen)
    g_rbeg = _put((N, S), 0, it, dev, tgt, rbeg)
    g_rid = _put((N, S), -1, i32, dev, tgt, rid)
    g_valid = _put((N, S), False, torch.bool, dev, tgt, ok)

    # ---- l_rep: union of repetitive intervals (bwamem.c:272-279) ----
    rep = valid & (x2 > max_occ)
    seg_start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                           read[1:] != read[:-1]])
    ends = torch.where(rep, e, -1)
    run = chainops.seg_cummax(ends, seg_start, 1 << 24)
    prev_end = torch.cat([torch.full((1,), -1, dtype=run.dtype, device=dev),
                          run[:-1]])
    prev_end = torch.where(seg_start, -1, prev_end)
    contrib = torch.where(rep, (e - torch.maximum(s.to(i64), prev_end)
                                ).clamp(min=0), 0)
    l_rep = torch.zeros((N,), dtype=it, device=dev).index_add_(
        0, read.to(i64), contrib.to(it))

    seeds = chainops.Seeds(
        rbeg=g_rbeg, qbeg=g_qbeg, len=g_len, rid=g_rid, valid=g_valid,
        frac_rep=l_rep.to(torch.float32), overflow=seed_cnt > S)
    z = _zero(i32, dev)
    meta = torch.stack([seed_arena_over.to(i32),
                        total.clamp(max=2 ** 31 - 1).to(i32),
                        seed_cnt.max(), z, z, z, z, z])
    return seeds, seed_cnt, l_rep, meta


# ---------------------------------------------------------------------------
# CHAIN: chaining + weights + windows + compact arenas
# ---------------------------------------------------------------------------

def _chain_body(fm, ctg_offsets, ctg_is_alt, seeds, l_seq, *, w,
                max_chain_gap, chain_cap, a_ch, a_it, min_chain_weight,
                a, o_del, e_del, o_ins, e_ins):
    it = seeds.rbeg.dtype
    dev = seeds.rbeg.device
    N, S = seeds.qbeg.shape
    C = chain_cap
    k0 = chainops.launches
    ch = chainops.chain_seeds(seeds, ctg_is_alt, fm.l_pac, w=w,
                              max_chain_gap=max_chain_gap, chain_cap=C)
    timers.count("front.chain.launches", chainops.launches - k0)
    wt = chainops.chain_weights(seeds, ch)
    rmax0, rmax1 = align_ext.chain_rmax(
        seeds, ch, l_seq, fm, ctg_offsets,
        a=a, o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins, w=w)
    # compact per-chain arena in (read-major, creation order) — the host
    # replays mem_chain_flt's exact B-tree traversal + introsort from it
    rows_c = _ar(N, i32, dev)[:, None].expand(N, C)
    slots_c = _ar(C, i32, dev)[None, :].expand(N, C)
    cmask = (slots_c < ch.n[:, None]).reshape(-1)
    beg = ch.first_qbeg
    end = ch.last_qbeg + ch.last_len
    pk_rid_alt = (ch.rid << 1) | ch.is_alt.to(i32)
    (c_read, c_w, c_beg, c_end, c_ra), n_ch, ch_arena_over, _ = \
        _compact_flat(cmask, [(rows_c, i32), (wt, i32), (beg, i32),
                              (end, i32), (pk_rid_alt, i32)], a_ch)
    (c_pos,), _, _, _ = _compact_flat(cmask, [(ch.pos, it)], a_ch)
    chain32 = torch.stack([c_read, c_w, c_beg, c_end, c_ra])

    # ---- work items: every valid seed of every heavy chain ----
    sc = ch.seed_chain
    scc = sc.clamp(0, C - 1).to(i64)
    heavy = torch.gather(wt, 1, scc) >= min_chain_weight
    imask = (sc >= 0) & heavy & seeds.valid
    rows_s = _ar(N, i32, dev)[:, None].expand(N, S)
    slots_s = _ar(S, i32, dev)[None, :].expand(N, S)
    i_rmax0 = torch.gather(rmax0, 1, scc)
    i_rmax1 = torch.gather(rmax1, 1, scc)
    (i_read, i_slot, i_chain, i_qbeg, i_len), n_it, it_over, _ = \
        _compact_flat(imask.reshape(-1),
                      [(rows_s, i32), (slots_s, i32), (sc, i32),
                       (seeds.qbeg, i32), (seeds.len, i32)], a_it)
    (i_rbeg, i_r0, i_r1), _, _, _ = _compact_flat(
        imask.reshape(-1), [(seeds.rbeg, it), (i_rmax0, it), (i_rmax1, it)],
        a_it)
    # largest extension window over the items: sizes the NEXT batch's
    # t_max (host checks the CURRENT batch didn't exceed it)
    tl = torch.where(imask & (seeds.qbeg > 0), seeds.rbeg - i_rmax0, 0)
    qe = seeds.qbeg + seeds.len
    tr = torch.where(imask & (qe < l_seq[:, None]),
                     i_rmax1 - (seeds.rbeg + seeds.len), 0)
    t_span = torch.maximum(tl.max(), tr.max()).to(i32)
    z = _zero(i32, dev)
    meta = torch.stack([ch.overflow.any().to(i32),
                        ch_arena_over.to(i32), it_over.to(i32),
                        n_ch.to(i32), n_it.to(i32),
                        ch.n.max().to(i32), t_span, z])
    items32 = torch.stack([i_read, i_slot, i_chain, i_qbeg, i_len])
    items_it = torch.stack([i_rbeg, i_r0, i_r1])
    return ch.seed_chain, items32, items_it, chain32, c_pos, meta


# ---------------------------------------------------------------------------
# EXT: speculative fused extension of all work items + seedcov
# ---------------------------------------------------------------------------

def _qt_blocks(pac, l_pac, seqbatch, lane_read, q_start, q_sign, qlen,
               t_start, t_sign, tlen, *, lq_max, t_max):
    """[LQ, B] query and [LT, B] target nt4 blocks from the device-resident
    read batch + packed reference.  Computed lane-major ([B, L*]) so each
    lane's positions are consecutive, then transposed."""
    it = t_start.dtype
    dev = seqbatch.device
    L = seqbatch.shape[1]
    j = _ar(lq_max, i32, dev)[None, :]
    qidx = q_start.to(i32)[:, None] + q_sign[:, None] * j
    q = torch.gather(seqbatch[lane_read.to(i64)].to(i32), 1,
                     qidx.clamp(0, L - 1).to(i64))
    q = torch.where(j < qlen[:, None], q, 4)
    ti = _ar(t_max, it, dev)[None, :]
    pos = (t_start[:, None] + t_sign[:, None].to(it) * ti).clamp(
        0, 2 * l_pac - 1).to(i64)
    is_rev = pos >= l_pac
    fpos = torch.where(is_rev, 2 * l_pac - 1 - pos, pos)
    word = pac[fpos >> 4]
    byte = (word >> (((fpos & 15) >> 2) << 3)) & 0xFF
    b = ((byte >> ((3 - (fpos & 3)) << 1)) & 3).to(i32)
    b = torch.where(is_rev, 3 - b, b)
    t = torch.where(ti < tlen[:, None], b, 4)
    return q.T.contiguous(), t.T.contiguous()


def _ext_kernel(qT, qlen, tT, tlen, h0, eb, *, w_opt, lq_max, t_max, **kw):
    """Both passes of one extension side: the CUDA kernel on a card, its
    plain version on the CPU (ops/ext_kernel.extend_batch_pl2)."""
    return ext_kernel.extend_batch_pl2(
        qT, qlen, tT, tlen, h0, eb, lq_max=lq_max, t_max=t_max,
        w_opt=w_opt, **kw)


def _ext_core(fm, seq, l_seq, seed_chain, seeds_valid, seeds_qbeg, seeds_len,
              seeds_rbeg, iv, *, lq_max, t_max, mat_bytes,
              o_del, e_del, o_ins, e_ins, zdrop, w_opt, a, pen_clip5,
              pen_clip3):
    """Fused left+right extension for a vector of work items + per-item
    seedcov (mem_chain2aln extension body, bwamem.c:717-786).  Returns the
    14 per-item result vectors in the INPUT item order."""
    i_read, i_slot, i_chain, i_qbeg, i_len, i_rbeg, i_r0, i_r1 = iv
    it = seeds_rbeg.dtype
    dev = seq.device
    B = i_read.shape[0]
    lseq_of = l_seq[i_read.clamp(0, l_seq.shape[0] - 1).to(i64)].to(i32)

    # Sort the items by their extension-window size so similar target
    # lengths share kernel blocks; outputs are unsorted at the end.
    klen_l = torch.where(i_qbeg > 0, i_rbeg - i_r0, 0).to(i32)
    klen_r = torch.where(i_qbeg + i_len < lseq_of,
                         (i_r1 - (i_rbeg + i_len)).to(i32), 0)
    pos_s = torch.sort(torch.maximum(klen_l, klen_r), stable=True).indices
    i_read, i_slot, i_chain, i_qbeg, i_len, i_rbeg, i_r0, i_r1, l_seq_i = (
        x[pos_s] for x in (i_read, i_slot, i_chain, i_qbeg, i_len, i_rbeg,
                           i_r0, i_r1, lseq_of))
    kker = dict(w_opt=w_opt, lq_max=lq_max, t_max=t_max, mat_bytes=mat_bytes,
                o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                zdrop=zdrop)
    neg1 = torch.full((B,), -1, dtype=i32, device=dev)
    pos1 = torch.ones((B,), dtype=i32, device=dev)

    # ---- left: reversed prefix vs [rmax0, rbeg) reversed ----
    qlen_l = i_qbeg.to(i32)
    tlen_l = torch.where(i_qbeg > 0, i_rbeg - i_r0, 0).to(i32)
    h0_l = (i_len * a).clamp(min=1).to(i32)
    qT, tT = _qt_blocks(fm.pac, fm.l_pac, seq, i_read, i_qbeg - 1, neg1,
                        qlen_l, i_rbeg - 1, neg1, tlen_l,
                        lq_max=lq_max, t_max=t_max)
    eb5 = torch.full((B,), pen_clip5, dtype=i32, device=dev)
    L, retL = _ext_kernel(qT, qlen_l, tT, tlen_l, h0_l, eb5, **kker)
    score_l = torch.where(qlen_l > 0, L.score, (i_len * a).to(i32))
    sc0 = score_l.clamp(min=1)

    # ---- right: suffix vs [rbeg + len, rmax1) ----
    s_qe = i_qbeg + i_len
    qlen_r = (l_seq_i - s_qe).to(i32)
    tlen_r = torch.where(s_qe < l_seq_i,
                         (i_r1 - (i_rbeg + i_len)).to(i32), 0)
    qT, tT = _qt_blocks(fm.pac, fm.l_pac, seq, i_read, s_qe, pos1,
                        qlen_r, i_rbeg + i_len, pos1, tlen_r,
                        lq_max=lq_max, t_max=t_max)
    eb3 = torch.full((B,), pen_clip3, dtype=i32, device=dev)
    R, retR = _ext_kernel(qT, qlen_r, tT, tlen_r, sc0, eb3, **kker)

    # ---- endpoint selection (bwamem.c:744-779) ----
    has_left = qlen_l > 0
    loc_l = (L.gscore <= 0) | (L.gscore <= L.score - pen_clip5)
    n_qb = torch.where(has_left & loc_l, i_qbeg - L.qle, 0)
    n_rb = torch.where(has_left,
                       torch.where(loc_l, i_rbeg - L.tle, i_rbeg - L.gtle),
                       i_rbeg)
    truesc_l = torch.where(has_left, torch.where(loc_l, L.score, L.gscore),
                           (i_len * a).to(i32))
    has_right = s_qe < l_seq_i
    loc_r = (R.gscore <= 0) | (R.gscore <= R.score - pen_clip3)
    score_f = torch.where(has_right, R.score, score_l)
    n_qe = torch.where(has_right & loc_r, s_qe + R.qle, l_seq_i)
    n_re = torch.where(has_right,
                       torch.where(loc_r, i_rbeg + i_len + R.tle,
                                   i_rbeg + i_len + R.gtle),
                       i_rbeg + i_len)
    truesc_f = truesc_l + torch.where(
        has_right, torch.where(loc_r, R.score - sc0, R.gscore - sc0), 0)
    aw0 = torch.where(has_left & (retL != 0), w_opt * 2, w_opt)
    aw1 = torch.where(has_right & (retR != 0), w_opt * 2, w_opt)
    n_w = torch.maximum(aw0, aw1).to(i32)

    # ---- seedcov (bwamem.c:781-786) ----
    rr = i_read.clamp(0, seeds_qbeg.shape[0] - 1).to(i64)
    sd_qb = seeds_qbeg[rr]                        # [B, S]
    sd_len = seeds_len[rr]
    sd_rb = seeds_rbeg[rr]
    in_ch = seeds_valid[rr] & (seed_chain[rr] == i_chain[:, None])
    cov = (in_ch & (sd_qb >= n_qb[:, None])
           & (sd_qb + sd_len <= n_qe[:, None])
           & (sd_rb >= n_rb[:, None].to(it))
           & (sd_rb + sd_len <= n_re[:, None].to(it)))
    seedcov = torch.where(cov, sd_len, 0).sum(dim=1, dtype=i32)

    # restore the input item order
    inv = torch.empty_like(pos_s)
    inv[pos_s] = _ar(B, i64, dev)
    out = (i_read, i_slot, i_chain, i_qbeg, i_len, n_qb.to(i32),
           n_qe.to(i32), score_f.to(i32), truesc_f.to(i32), n_w, seedcov,
           i_rbeg, n_rb.to(it), n_re.to(it))
    return tuple(x[inv] for x in out)


def _ext_body(fm, seq, l_seq, seed_chain, seeds_valid, seeds_qbeg, seeds_len,
              seeds_rbeg, items32, items_it, n_item, *, lq_max, t_max,
              mat_bytes, o_del, e_del, o_ins, e_ins, zdrop, w_opt, a,
              pen_clip5, pen_clip3, sel_cap=0, c_cap=0):
    """EXT program: speculative fused extension over the flat item arena.

    sel_cap == 0: every lane extends (single-round mode; also the round-2
    program over a host-built item subset).  Output row 11 (has-result) is
    all ones.

    sel_cap > 0: TWO-ROUND mode, round 1 — only the srt-first work item of
    each (read, chain) group extends (the item the sequential accept/skip
    walk, bwamem.c:669-676 DESC srt order, processes first; its region is
    what the walk's containment skip test consults for the rest of the
    chain, so extending it first lets the host prepass kill most of the
    remaining items before they reach the kernel).  The selection compacts
    to a `sel_cap`-lane arena; results scatter back to the full arena with
    row 11 marking which items have results.  Chains beyond sel_cap get no
    round-1 result — the host prepass then routes ALL their items to round
    2, which is correct (just less selective), so truncation needs no
    retry.

    Returns (out32 [12, A] i32, out_it [3, A] index-typed, m6 [8] i32
    meta; m6[0] = selected-group count for a_sel hwm tracking)."""
    i_read, i_slot, i_chain, i_qbeg, i_len = (items32[k] for k in range(5))
    i_rbeg, i_r0, i_r1 = (items_it[k] for k in range(3))
    dev = seq.device
    A = i_read.shape[0]
    kcore = dict(lq_max=lq_max, t_max=t_max, mat_bytes=mat_bytes,
                 o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                 zdrop=zdrop, w_opt=w_opt, a=a, pen_clip5=pen_clip5,
                 pen_clip3=pen_clip3)
    seeds4 = (seed_chain, seeds_valid, seeds_qbeg, seeds_len, seeds_rbeg)
    if sel_cap == 0:
        r = _ext_core(fm, seq, l_seq, *seeds4,
                      (i_read, i_slot, i_chain, i_qbeg, i_len, i_rbeg,
                       i_r0, i_r1), **kcore)
        out32 = torch.stack(list(r[:11])
                            + [torch.ones((A,), dtype=i32, device=dev)])
        return out32, torch.stack(list(r[11:])), torch.zeros(
            (8,), dtype=i32, device=dev)

    # ---- round-1 selection: srt-first item per (read, chain) ----
    posA = _ar(A, i32, dev)
    valid = posA < n_item
    NG = l_seq.shape[0] * c_cap
    gid = torch.where(valid, i_read * c_cap + i_chain.clamp(0, c_cap - 1),
                      NG).to(i64)
    # srt walks (len desc, insertion idx desc); within a read the arena is
    # in insertion (m asc) order, so (len, global pos) max = the first item
    pk = (i_len.to(i64) << 32) | posA.to(i64)
    gmax = torch.full((NG + 1,), -1, dtype=i64, device=dev)
    gmax.scatter_reduce_(0, gid, pk, "amax")
    is_first = valid & (gmax[gid] == pk)
    n_sel = is_first.sum(dtype=i32)
    sel = torch.sort(torch.where(is_first, 0, 1).to(i32), stable=True
                     ).indices[:sel_cap]
    has_lane = is_first[sel]
    s_read, s_slot, s_chain, s_qbeg, s_len, s_rbeg, s_r0, s_r1 = (
        x[sel] for x in (i_read, i_slot, i_chain, i_qbeg, i_len, i_rbeg,
                         i_r0, i_r1))
    # pad/unselected lanes: zero both extension windows so their kernel
    # work is nil (they sort to the cheap end anyway)
    s_qbeg = torch.where(has_lane, s_qbeg, 0)
    s_len = torch.where(has_lane, s_len, 0)
    s_r0 = torch.where(has_lane, s_r0, s_rbeg)
    s_r1 = torch.where(has_lane, s_r1, s_rbeg)
    r = _ext_core(fm, seq, l_seq, *seeds4,
                  (s_read, s_slot, s_chain, s_qbeg, s_len, s_rbeg, s_r0,
                   s_r1), **kcore)
    tgt = torch.where(has_lane, sel, A)

    def back(x):
        return _put((A,), 0, x.dtype, dev, (tgt,), x)

    has_row = _put((A,), 0, i32, dev, (tgt,), torch.ones_like(tgt))
    # identity rows keep the FULL arena values — the host walk reads the
    # seed fields of every item, extended or not.  Result-less lanes keep
    # their INPUT windows (rmax0/rmax1) in rows 1-2: exactly what the
    # round-2 dispatch needs back.
    hasb = has_row.to(torch.bool)
    out32 = torch.stack([i_read, i_slot, i_chain, i_qbeg, i_len,
                         back(r[5]), back(r[6]), back(r[7]), back(r[8]),
                         back(r[9]), back(r[10]), has_row])
    out_it = torch.stack([i_rbeg,
                          torch.where(hasb, back(r[12]), i_r0),
                          torch.where(hasb, back(r[13]), i_r1)])
    m6 = torch.zeros((8,), dtype=i32, device=dev)
    m6[0] = n_sel
    return out32, out_it, m6


# ---------------------------------------------------------------------------
# Host driver
# ---------------------------------------------------------------------------

def gate_rows(opt: MemOptions, reads) -> set:
    """Rows entering mem_flt_chained_seeds (bwamem.c:607-611) — long reads
    whose seed re-scoring mutates the work order; they need the host
    path."""
    rows = set()
    for i, r in enumerate(reads):
        L = r.l_seq
        if L <= 0:
            continue
        min_l = (MEM_HSP_COEF * opt.min_chain_weight
                 if opt.min_chain_weight
                 else MEM_MINSC_COEF * math.log(L))
        if min_l <= MEM_SEEDSW_COEF * L:
            rows.add(i)
    return rows


def supported(al, reads) -> bool:
    """Whether this batch can take the device front: its EXT program
    extends at the padded read length, and the extension kernel takes
    queries up to 4095 bases and (by the (h<<12)|col packing of its plain
    version's row max) reachable scores below 2^18.  Under a mesh a batch
    whose row bucket is smaller than the shard count takes the host
    front, as in the reference."""
    nsh = pmesh.shards(al.mesh)
    if nsh > 1 and pow2_bucket(len(reads), lo=8) < nsh:
        return False
    mat_max = int(np.max(np.asarray(al.opt.mat)))
    Lr = max((r.l_seq for r in reads), default=0)
    # the batch is padded to the next multiple of 32 (align._lbucket)
    return (-(-Lr // 32) * 32 <= ext_kernel.LQ_MAX
            and 2 * Lr * max(al.opt.a, mat_max) < (1 << 18))


def front_start(al, reads, seq: np.ndarray, l_seq: np.ndarray):
    """Dispatch the device front for a batch WITHOUT fetching: uploads the
    batch, enqueues the 6-program chain, and returns a token for
    front_finish.  The split lets align_stream enqueue batch k+1's front
    while the host finalizes batch k."""
    opt: MemOptions = al.opt
    n = len(reads)
    N, Lr = seq.shape
    nsh = pmesh.shards(al.mesh)
    Nkey = (N // nsh, Lr)     # (per-shard rows, read-len bucket) hwm key
    hist = al._front_hist
    sizes = _sizes_for(hist, *Nkey)
    use_kmer = use_kmer_table(al)
    # two-round extension (round-1 select + host prepass + round-2 subset)
    # needs a single device; sel_cap == 0 keeps the single-round program
    if os.environ.get("BWAMEM_TPU_EXT2", "1") != "1" or nsh > 1:
        sizes["a_sel"] = 0
    # long reads that enter mem_flt_chained_seeds keep the host path
    fallback = gate_rows(opt, reads)
    if len(fallback) * 2 >= max(n, 1):
        # mostly long-read batch: dispatching the device front first would
        # only spend device time on rows that all fall back anyway
        return dict(abort=True, n=n)

    dev = al.device
    seq_dev = torch.from_numpy(seq).to(dev)
    l_dev = torch.from_numpy(l_seq).to(dev)

    # extension-window rows: hwm-sized (the device reports each batch's true
    # max span, m5[6]); the first batch uses the conservative chain-span
    # bound L + w + 2*cal_max_gap_bound
    h_ts = hist.get(("hwm", "t_span", Nkey))
    gmax = min(max((Lr * opt.a - min(opt.o_del, opt.o_ins))
                   // min(opt.e_del, opt.e_ins) + 1, 1), 2 * opt.w)
    bound = Lr + opt.w + 2 * gmax + 8
    sizes["t_span"] = pow2_bucket(min(int(h_ts + (h_ts >> 3) + 1), bound),
                              lo=128) if h_ts is not None \
        else pow2_bucket(bound, lo=128)

    with timers.section("front.dispatch"):
        *arrs, ext2ctx = _dispatch(al, seq_dev, l_dev, sizes, use_kmer, N, Lr)
    return dict(abort=False, reads=reads, n=n, N=N, Lr=Lr, hist=hist,
                sizes=sizes,
                use_kmer=use_kmer, fallback=fallback, seq_dev=seq_dev,
                l_dev=l_dev, arrs=tuple(arrs), nsh=nsh, Nkey=Nkey,
                ext2ctx=ext2ctx)


# directory of the saved arena high-water history (unset: nothing is saved)
HWM_DIR_ENV = "BWAMEM_TPU_HWM_DIR"


def hist_path(al) -> str | None:
    """File of the device front's arena high-water history for this index
    and device type, in the directory BWAMEM_TPU_HWM_DIR names; None when
    the variable is unset.  A process that starts from the saved sizes
    does not regrow cold arenas (every regrowth reruns the batch's six
    programs).  Keys are per-shard rows, so a mesh and one device share
    the sizes of a shard's shape."""
    d = os.environ.get(HWM_DIR_ENV)
    if not d:
        return None
    fp = (f"{int(al.idx.seq_len)}-{int(al.idx.primary)}-"
          f"{len(al.ctg_names)}-{al.device.type}")
    return os.path.join(d, f"front_hwm_{fp}.json")


def hist_load(al) -> dict:
    """The saved history of hist_path (empty when there is none, or when
    the file cannot be read)."""
    hist = {}
    path = hist_path(al)
    if path and os.path.exists(path):
        try:
            with open(path) as f:
                for k, v in json.load(f).items():
                    name, n, lr = k.split(":")
                    hist[("hwm", name, (int(n), int(lr)))] = int(v)
        except (OSError, ValueError):
            return {}
    return hist


def hist_save(al) -> None:
    """Write al._front_hist to hist_path (atomically; nothing when the
    variable is unset).  A file that cannot be written costs only the
    saved sizes: one line on stderr, and alignment goes on."""
    path = hist_path(al)
    if not path:
        return
    data = {f"{k[1]}:{k[2][0]}:{k[2][1]}": int(v)
            for k, v in al._front_hist.items()}
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        with os.fdopen(fd, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError as e:
        print(f"[bwamem_tpu_torch] arena history not saved to {path}: {e}",
              file=sys.stderr, flush=True)


MAX_RETRIES = 16        # arena regrowths of one batch before it bails


class FrontBailout(RuntimeError):
    """The device front gives up on a batch: its arenas did not converge
    within MAX_RETRIES regrowths, or its chain table overflowed.  Only
    front_finish catches it."""


def front_finish(al, tok):
    """Fetch + grow-and-retry + exact-filter replay for a front_start
    token.

    Returns (regs_out, fallback_rows): per-read AlnReg lists in
    mem_chain2aln emission order (pre-dedup) for every read NOT in
    fallback_rows; fallback rows (cap overflows, long reads entering
    mem_flt_chained_seeds, reads the final two-round walk demotes) need
    the host-compacted front.  When the front bails on the batch
    (FrontBailout), every row is a fallback row: one line on stderr names
    the cause, and `front.bailouts` counts it.  When a fetch outlasts its
    watchdog (utils/fetchguard.FetchTimeout), every row is a fallback row
    too and the device front stays off for the rest of the process
    (al._front_disabled): one line on stderr, `front.fetch_timeouts`
    counts it.  The reference package catches every RuntimeError there;
    this catches only these two, so a CUDA error or a failed kernel build
    or launch still propagates and the device is never bypassed
    silently.  timers counts the rows handed back by cause:
    front.fallback.gated (long reads), .s_cap (seed count over the cap),
    .demoted (the final walk), .abort (a mostly long-read batch),
    .bailout and .timeout; with the batches the caller never dispatches
    (.undispatched) they sum to front.fallback_rows."""
    n = tok["n"]
    if tok["abort"]:
        timers.count("front.fallback.abort", n)
        return [[] for _ in range(n)], list(range(n))
    try:
        return _finish(al, tok)
    except fetchguard.FetchTimeout:
        al._front_disabled = True
        print("[bwamem_tpu_torch] device front DISABLED after a fetch "
              "timeout; re-running the batch on the host-compacted front",
              file=sys.stderr, flush=True)
        timers.count("front.fetch_timeouts")
        timers.count("front.fallback.timeout", n)
        return [[] for _ in range(n)], list(range(n))
    except FrontBailout as e:
        print(f"[bwamem_tpu_torch] device front bailed for this batch: {e}; "
              "re-running on the host-compacted front", file=sys.stderr,
              flush=True)
        timers.count("front.bailouts")
        timers.count("front.fallback.bailout", n)
        return [[] for _ in range(n)], list(range(n))


# meta slots holding bit flags: combined across shards with OR; every other
# slot is a count or a high-water mark and combines with max
_FLAG_SLOTS = (1, 9, 17, 24, 32, 33, 34)


def _finish(al, tok):
    """front_finish for a dispatched batch; raises FrontBailout."""
    reads, n, N, Lr = tok["reads"], tok["n"], tok["N"], tok["Lr"]
    hist, sizes, use_kmer = tok["hist"], tok["sizes"], tok["use_kmer"]
    fallback = tok["fallback"]
    seq_dev, l_dev, Nkey = tok["seq_dev"], tok["l_dev"], tok["Nkey"]
    nsh = tok["nsh"]
    n_gated = len(fallback)
    meta_all, out32, out_it, chain32, c_pos, scl = tok["arrs"]
    retries = 0
    changed = False         # a high-water mark rose: save the history
    with timers.section("front.fetch"):
        meta_st = _fetch(meta_all)              # [48, nsh]
    while True:
        meta = meta_st.max(axis=1)
        for sl in _FLAG_SLOTS:
            meta[sl] = np.bitwise_or.reduce(meta_st[sl])
        m1, m2, m3, m4, m5, m6 = (meta[8 * k: 8 * k + 8] for k in range(6))
        grow = _seeding_overflows(m1, m2, m3)
        if m4[0]:
            grow.append("a_seed")
        if m5[1]:
            grow.append("a_ch")
        if m5[2]:
            grow.append("a_it")
        if int(m5[6]) > sizes["t_span"]:
            # an extension window exceeded the hwm-sized t_max: results
            # would be silently truncated — grow and rerun
            sizes["t_span"] = pow2_bucket(int(m5[6]), lo=128)
            changed |= _note_hwm(hist, Nkey, t_span=m5[6])
            grow.append(None)
        if not grow:
            break
        retries += 1
        if retries > MAX_RETRIES:
            raise FrontBailout(f"front arena growth did not converge: "
                               f"{grow} sizes={sizes}")
        _grow_sizes(sizes, grow, m1, m2)
        timers.count("front.retries")
        # the rerun, from its dispatch to the meta fetch that waits for it
        with timers.section("front.regrow"):
            with timers.section("front.dispatch"):
                *tok["arrs"], tok["ext2ctx"] = _dispatch(
                    al, seq_dev, l_dev, sizes, use_kmer, N, Lr)
            meta_all, out32, out_it, chain32, c_pos, scl = tok["arrs"]
            with timers.section("front.fetch"):
                meta_st = _fetch(meta_all)

    _note_sizes(sizes, m1, m2, m3)
    with timers.section("front.fetch"):
        out32, out_it, chain32, c_pos, scl = fetchguard.fetch(
            [out32, out_it, chain32, c_pos, scl], what="front.arenas")
    changed |= _note_seeding_hwm(hist, Nkey, m1, m2, m3)
    changed |= _note_hwm(hist, Nkey, a_seed=m4[1], s_cap=m4[2], a_ch=m5[3],
                         a_it=m5[4], t_span=m5[6], a_sel=m6[0])
    if changed:
        hist_save(al)
    if m5[0]:
        raise FrontBailout("chain table overflow with chain_cap == seed cap")

    seed_cnt = scl[0].astype(np.int64)
    l_rep = scl[1]
    _note_chain(seed_cnt, N, sizes["s_cap"])
    I32, IIT, CH32, CHPOS = _merge_shards(out32, out_it, chain32, c_pos,
                                          meta_st, N // nsh)
    for i in np.nonzero(seed_cnt[:n] > sizes["s_cap"])[0]:
        fallback.add(int(i))
    n_scap = len(fallback) - n_gated

    # ---- two-round extension: prepass -> round-2 subset -> final walk ----
    has = None
    if sizes.get("a_sel", 0):
        has = np.ascontiguousarray(I32[11], np.uint8)
        needed = _replay(al, reads, I32, IIT, CH32, CHPOS, l_rep, n,
                         fallback, has_res=has, prepass=True)
        timers.count("ext.items", int(m6[0]) + len(needed))
        if len(needed):
            _ext2_run(al, tok["ext2ctx"], I32, IIT, needed, hist, Nkey)
            if _note_hwm(hist, Nkey, a_e2=len(needed)):
                hist_save(al)
            has[needed] = 1
    regs_out = _replay(al, reads, I32, IIT, CH32, CHPOS, l_rep, n, fallback,
                       has_res=has)
    timers.count("front.fallback.gated", n_gated)
    timers.count("front.fallback.s_cap", n_scap)
    timers.count("front.fallback.demoted", len(fallback) - n_gated - n_scap)
    return regs_out, sorted(fallback)


def _note_sizes(sizes: dict, m1, m2, m3) -> None:
    """The kept dispatch's arena sizes as gauges (front.size.<key>), and
    its scan trips: front.trips.run those dispatched (t1s + t2s + t3s),
    front.trips.used those its metas report the scans needed."""
    if not timers.enabled():
        return
    for k, v in sizes.items():
        timers.gauge("front.size." + k, int(v))
    timers.count("front.trips.run", sizes["t1s"] + sizes["t2s"]
                 + sizes["t3s"])
    timers.count("front.trips.used", int(m1[6]) + int(m2[7]) + int(m3[4]))


def _note_chain(seed_cnt, N: int, s_cap: int) -> None:
    """The kept dispatch's CHAIN work: front.chain.seeds the valid seeds
    its grids held (each row's count up to the seed cap), front.chain.slots
    the N x s_cap slots of those grids, which the lockstep loop walks
    whatever they hold."""
    if not timers.enabled():
        return
    timers.count("front.chain.seeds",
                 int(np.minimum(seed_cnt, s_cap).sum()))
    timers.count("front.chain.slots", N * s_cap)


def _merge_shards(out32, out_it, chain32, c_pos, meta_st, Ns):
    """The per-shard item and chain arenas (stacked on axis 1, a shard's
    arena after another's) merged into the global read-major layout the
    host replay reads: shard s holds reads [s*Ns, (s+1)*Ns) under
    shard-local read ids, so its ids are offset by s*Ns.  One device is
    the case of one shard."""
    nsh = meta_st.shape[1]
    a_it = out32.shape[1] // nsh
    a_ch = chain32.shape[1] // nsh
    nit = meta_st[36].astype(np.int64)     # m5[4] per shard
    nch = meta_st[35].astype(np.int64)     # m5[3] per shard
    i32p, itp, chp, pp = [], [], [], []
    for s in range(nsh):
        it0, ch0 = s * a_it, s * a_ch
        blk = np.array(out32[:, it0:it0 + nit[s]])
        blk[0] += s * Ns
        i32p.append(blk)
        itp.append(out_it[:, it0:it0 + nit[s]])
        cb = np.array(chain32[:, ch0:ch0 + nch[s]])
        cb[0] += s * Ns
        chp.append(cb)
        pp.append(c_pos[0, ch0:ch0 + nch[s]])
    return (np.concatenate(i32p, axis=1), np.concatenate(itp, axis=1),
            np.concatenate(chp, axis=1), np.concatenate(pp))


def _ext2_run(al, ctx, I32, IIT, needed, hist, Nkey):
    """Round-2 extension: one small dispatch over exactly the items the
    prepass still needs (same program as round 1 with sel_cap=0, arena
    hwm-bucketed on the needed count)."""
    k = len(needed)
    h = hist.get(("hwm", "a_e2", Nkey), 0)
    a2 = pow2_bucket(max(int(h + (h >> 2) + 1), k), lo=1024)
    sub32 = np.zeros((5, a2), np.int32)
    sub32[:, :k] = I32[:5, needed]
    subit = np.zeros((3, a2), IIT.dtype)
    subit[:, :k] = IIT[:, needed]
    dev = al.device
    with timers.device_section("front.ext2", dev):
        timers.count("dispatch.front", 1)
        o32d, oitd, _ = _ext_body(
            al.fm, ctx["seq_dev"], ctx["l_dev"], ctx["seed_chain"],
            ctx["sv"], ctx["sq"], ctx["sl"], ctx["sr"],
            torch.from_numpy(sub32).to(dev), torch.from_numpy(subit).to(dev),
            k, sel_cap=0, c_cap=0, **ctx["s6"])
    with timers.section("front.fetch"):
        o32, oit = fetchguard.fetch([o32d, oitd], what="front.ext2")
    I32[5:11, needed] = o32[5:11, :k]
    IIT[1:, needed] = oit[1:, :k]


def _program_kw(opt: MemOptions, sizes: dict, use_kmer: bool, n_reads: int,
                Lr: int) -> dict:
    """Keyword sets of the six programs (s1..s6) for a batch (or a shard)
    of n_reads rows padded to Lr bases."""
    s1, s2, s3 = _seeding_kw(opt, sizes, use_kmer)
    s4 = dict(max_occ=opt.max_occ, a_seed=sizes["a_seed"],
              s_cap=sizes["s_cap"], n_reads=n_reads)
    s5 = dict(w=opt.w, max_chain_gap=opt.max_chain_gap,
              chain_cap=sizes["s_cap"], a_ch=sizes["a_ch"],
              a_it=sizes["a_it"], min_chain_weight=opt.min_chain_weight,
              a=opt.a, o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins)
    s6 = dict(lq_max=Lr, t_max=sizes["t_span"],
              mat_bytes=np.asarray(opt.mat, np.int8).tobytes(),
              o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins, zdrop=opt.zdrop, w_opt=opt.w, a=opt.a,
              pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3)
    return dict(s1=s1, s2=s2, s3=s3, s4=s4, s5=s5, s6=s6)


def _programs(fm, ctg_offsets, ctg_is_alt, seq_dev, l_dev, *, s1, s2, s3,
              s4, s5, s6, sel_cap=0, c_cap=0):
    """Enqueue the six programs on one device (or one shard's rows);
    returns device tensors (no fetch) and the round-2 context."""
    dev = seq_dev.device
    with timers.device_section("front.p1", dev):
        sec1, m1 = _p1_body(fm, seq_dev, l_dev, **s1)
    with timers.device_section("front.p2", dev):
        sec2, m2 = _p2_body(fm, seq_dev, l_dev, sec1, m1[0], **s2)
    with timers.device_section("front.p3", dev):
        sec3, m3 = _p3_body(fm, seq_dev, l_dev, **s3)
    with timers.device_section("front.expand", dev):
        seeds, seed_cnt, l_rep, m4 = _expand_body(
            fm, ctg_offsets, sec1, m1[0], sec2, m2[0], sec3, m3[0], **s4)
    with timers.device_section("front.chain", dev):
        seed_chain, items32, items_it, chain32, c_pos, m5 = _chain_body(
            fm, ctg_offsets, ctg_is_alt, seeds, l_dev, **s5)
    with timers.device_section("front.ext", dev):
        out32, out_it, m6 = _ext_body(
            fm, seq_dev, l_dev, seed_chain, seeds.valid, seeds.qbeg,
            seeds.len, seeds.rbeg, items32, items_it, m5[4],
            sel_cap=sel_cap, c_cap=c_cap, **s6)
    meta_all = torch.cat([m1, m2, m3, m4, m5, m6])
    scl = torch.stack([seed_cnt.to(fm.itype), l_rep])
    # ext2 context: device tensors the round-2 dispatch needs (the items
    # come back from the host as an explicit subset)
    ctx = dict(seq_dev=seq_dev, l_dev=l_dev, seed_chain=seed_chain,
               sv=seeds.valid, sq=seeds.qbeg, sl=seeds.len, sr=seeds.rbeg,
               s6=s6)
    return meta_all, out32, out_it, chain32, c_pos, scl, ctx


def _shard_programs(fm, ctg_offsets, ctg_is_alt, seq, l_seq, **kw):
    """One shard's six programs, single-round extension (sel_cap 0: the
    two-round driver's host prepass would serialize a round trip per
    shard); the meta [48] and c_pos come back as a column and a row so the
    shards stack on axis 1 ([48, nsh], [1, nsh * a_ch])."""
    meta_all, out32, out_it, chain32, c_pos, scl, _ = _programs(
        fm, ctg_offsets, ctg_is_alt, seq, l_seq, **kw)
    return meta_all[:, None], out32, out_it, chain32, c_pos[None, :], scl


def _dispatch(al, seq_dev, l_dev, sizes, use_kmer, N, Lr):
    """Enqueue the device program chain; returns device tensors (no
    fetch) in the stacked per-shard layout _finish merges (one device is
    one shard: meta [48, 1], c_pos [1, a_ch]) and the round-2 context
    (None under a mesh).  Under a mesh the six programs run shard by shard
    (parallel/mesh.rowmap): reads on their leading axis, the FM index
    replicated, every arena shard-local."""
    nsh = pmesh.shards(al.mesh)
    kw = _program_kw(al.opt, sizes, use_kmer, N // nsh, Lr)
    timers.count("dispatch.front", 6)
    if nsh > 1:
        run = pmesh.rowmap(al.mesh, _shard_programs, tuple(kw.items()),
                           (True, True, True, False, False),
                           out_mask=("ax1",) * 6)
        out = (*run(al.fm, al.ctg_offsets, al.ctg_is_alt, seq_dev, l_dev),
               None)
    else:
        meta_all, out32, out_it, chain32, c_pos, scl, ctx = _programs(
            al.fm, al.ctg_offsets, al.ctg_is_alt, seq_dev, l_dev,
            sel_cap=sizes.get("a_sel", 0), c_cap=sizes["s_cap"], **kw)
        out = (meta_all[:, None], out32, out_it, chain32, c_pos[None, :],
               scl, ctx)
    _note_device_bytes(al)
    return out


def _note_device_bytes(al) -> None:
    """Gauge front.device_bytes: the bytes allocated on the front's CUDA
    devices once a dispatch is enqueued (the caching allocator's count,
    not its peak, which the caller's own statistics keep)."""
    if not timers.enabled():
        return
    devs = {d for d in (al.mesh.devices if al.mesh is not None
                        else (al.device,)) if d.type == "cuda"}
    if devs:
        timers.gauge("front.device_bytes",
                     sum(torch.cuda.memory_allocated(d) for d in devs))


def _replay(al, reads, I32, IIT, CH32, CHPOS, l_rep, n, fallback,
            has_res=None, prepass=False):
    """Exact mem_chain_flt + mem_chain2aln skip/accept replay
    (bwamem.c:334-392, 674-793) over the fetched arenas, in the native
    hostops.replay_batch.

    Two-round extension contract (has_res = per-item result mask):
    prepass=True returns just the needed-item index array (round-2 work
    list).  prepass=False with has_res set is the FINAL walk — any read
    whose walk still needs a result-less item (a rare prepass/exact
    divergence) is demoted to the fallback rows, keeping the output
    bit-identical unconditionally."""
    from bwamem_tpu_torch import native
    opt: MemOptions = al.opt
    with timers.section("front.prepass" if prepass else "front.replay"):
        (i_read, _i_slot, i_chain, i_qbeg, i_len, n_qb, n_qe, score,
         truesc, n_w, seedcov) = (I32[k] for k in range(11))
        i_rbeg, n_rb, n_re = IIT[0], IIT[1], IIT[2]
        c_read, c_w, c_beg, c_end, c_ra = (CH32[k] for k in range(5))
        ch_base = np.searchsorted(c_read, np.arange(n + 1))
        it_base = np.searchsorted(i_read, np.arange(n + 1))
        skip = np.zeros(n, np.uint8)
        for i in fallback:
            if i < n:
                skip[i] = 1
        l_seq = np.fromiter((r.l_seq for r in reads[:n]), np.int32, n)
        out_base, out_m, out_rid, needed = native.replay_batch(
            ch_base, c_w, c_beg, c_end, (c_ra & 1).astype(np.uint8),
            CHPOS, c_ra >> 1, it_base, i_chain, i_qbeg, i_len, i_rbeg,
            n_qb, n_qe, n_rb, n_re, n_w, skip, l_seq, opt,
            has_res=has_res)
        if prepass:
            return needed
        bad_reads = set()
        if has_res is not None and needed.size:
            # final walk hit unresolved items: demote those reads
            for r in (np.searchsorted(it_base, needed, side="right") - 1):
                bad_reads.add(int(r))
                fallback.add(int(r))
        if has_res is None:
            timers.count("ext.items", int(it_base[n]))
        timers.count("ext.accepted", len(out_m))
        qb_l = n_qb[out_m].tolist()
        qe_l = n_qe[out_m].tolist()
        rb_l = n_rb[out_m].tolist()
        re_l = n_re[out_m].tolist()
        sc_l = score[out_m].tolist()
        ts_l = truesc[out_m].tolist()
        w_l = n_w[out_m].tolist()
        sl_l = i_len[out_m].tolist()
        cov_l = seedcov[out_m].tolist()
        rid_l = out_rid.tolist()
        regs_out: list[list[AlnReg]] = [[] for _ in range(n)]
        ob = out_base.tolist()
        for i in range(n):
            b, e = ob[i], ob[i + 1]
            if b == e or i in bad_reads:
                continue
            frac_rep = float(l_rep[i]) / max(l_seq[i], 1)
            regs_out[i] = [
                AlnReg(rb=rb_l[j], re=re_l[j], qb=qb_l[j], qe=qe_l[j],
                       rid=rid_l[j], score=sc_l[j], truesc=ts_l[j],
                       w=w_l[j], seedcov=cov_l[j], seedlen0=sl_l[j],
                       frac_rep=frac_rep)
                for j in range(b, e)]
    return regs_out
