"""Flat speculative extension — the host-compacted path of mem_chain2aln.

The reference walks each read's work list sequentially because the
containment-skip test (bwamem.c:678-713) consults previously ACCEPTED
alignment regions.  An item's extension result does not depend on any other
item — only its acceptance does.  So this module:

  1. takes the work list (exact mem_chain2aln order) as numpy,
  2. extends every item on the device, lanes bucketed by shape class:
       * a batch whose longest read fits the extension kernels (4095 bp)
         on a card: ONE fused dispatch per lane tile — left extension with
         the in-kernel band-doubling retry, the left->right score handoff,
         right extension with retry (two launches of ext_pl2_kernel);
       * otherwise the side path: a pass at w, then a pass at 2w over the
         lanes that need it (bwamem.c:732-741), left side first, then the
         right side seeded with the left score.  On a card every lane goes
         to ext_pl_kernel, whatever its query length and score; on the CPU
         every lane goes to the plain ops/extend.extend_batch, whose
         row-max packing widens with the query;
  3. replays the sequential skip/accept logic on the host with the
     extension results in hand — bit-identical to the reference, since a
     skipped item's (discarded) extension costs only device work.

Queries and targets are built ON THE DEVICE from the resident read batch
and the packed reference: each lane carries only (read row, starts, signs,
lengths), a few [B] vectors per dispatch.
"""
from __future__ import annotations

import numpy as np
import torch

from bwamem_tpu_torch.config import MemOptions
from bwamem_tpu_torch.finalize import AlnReg
from bwamem_tpu_torch.ops import ext_kernel
from bwamem_tpu_torch.parallel import mesh as pmesh
from bwamem_tpu_torch.pipeline import _shapes
from bwamem_tpu_torch.pipeline._shapes import pow2_bucket
from bwamem_tpu_torch.pipeline.device_front import _fetch, _qt_blocks
from bwamem_tpu_torch.utils import timers

i32 = torch.int32
FIELDS = ("score", "qle", "tle", "gtle", "gscore", "max_off")
# (rows + columns) x lanes of one kernel dispatch: bounds the int64
# gather temporaries of _qt_blocks and the kernels' scratch planes to a few
# hundred MB however long the reads are
_TILE_CELLS = 1 << 25


def _kernel_tile(lq: int, lt: int) -> int:
    """Lane tile of a kernel dispatch at query rows lq and target rows lt."""
    fit = max(_TILE_CELLS // (lq + lt), 128)
    return min(_shapes.PL_LANE_TILE, 1 << (fit.bit_length() - 1))


def _score_kw(opt: MemOptions, mat) -> dict:
    return dict(mat_bytes=np.asarray(mat, np.int8).tobytes(),
                o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                e_ins=opt.e_ins, zdrop=opt.zdrop)


def _extend_flat(pac, l_pac, seqbatch, packed, *, lq_max, t_max, **kw):
    """One extension pass at a per-lane band over a [10, B] int64 lane
    block (read row, q_start, q_sign, qlen, t_start, t_sign, tlen, h0, w,
    end_bonus) through ops/ext_kernel.extend_batch_pl: the CUDA kernel for
    tensors on a card, its plain version for tensors on the CPU; both take
    any query length.  Returns the six result rows stacked [6, B]."""
    (lane_read, q_start, q_sign, qlen, t_start, t_sign, tlen, h0, w,
     end_bonus) = (packed[i] for i in range(10))
    qlen, tlen, h0, w, end_bonus = (x.to(i32) for x in (qlen, tlen, h0, w,
                                                        end_bonus))
    qT, tT = _qt_blocks(pac, l_pac, seqbatch, lane_read, q_start, q_sign,
                        qlen, t_start, t_sign, tlen, lq_max=lq_max,
                        t_max=t_max)
    return torch.stack(list(ext_kernel.extend_batch_pl(
        qT, qlen, tT, tlen, h0, w, end_bonus, lq_max=lq_max, t_max=t_max,
        **kw)))


def _extend_fused(pac, l_pac, seqbatch, packed, *, lq_max, t_max, a,
                  pen_clip5, pen_clip3, **kw):
    """The whole mem_chain2aln extension of a lane tile: left extension
    (+in-kernel band-doubling retry, bwamem.c:732-741), the left->right
    score handoff (h0 of the right pass = the selected left score,
    bwamem.c:744-753), and the right extension (+retry).  packed: [7, B]
    int64 (read row, seed qbeg, len, rbeg, rmax0, rmax1, l_seq).  Returns
    [14, B]: the six result rows and the retried flag of each side."""
    lane_read, s_qb, s_len, s_rb, rmax0, rmax1, l_seq = (
        packed[i] for i in range(7))
    B = packed.shape[1]
    dev = packed.device
    neg1 = torch.full((B,), -1, dtype=torch.int64, device=dev)
    pos1 = torch.ones((B,), dtype=torch.int64, device=dev)
    kw = dict(kw, lq_max=lq_max, t_max=t_max)

    # ---- left: reversed prefix vs [rmax0, s_rb) reversed ----
    qlen_l = s_qb.to(i32)
    tlen_l = torch.where(s_qb > 0, s_rb - rmax0, 0).to(i32)
    h0_l = (s_len * a).clamp(min=1).to(i32)
    qT, tT = _qt_blocks(pac, l_pac, seqbatch, lane_read, s_qb - 1, neg1,
                        qlen_l, s_rb - 1, neg1, tlen_l, lq_max=lq_max,
                        t_max=t_max)
    eb5 = torch.full((B,), pen_clip5, dtype=i32, device=dev)
    L, retL = ext_kernel.extend_batch_pl2(qT, qlen_l, tT, tlen_l, h0_l, eb5,
                                          **kw)

    # h0 of the right pass: the accepted left score (bwamem.c:744)
    score_l = torch.where(qlen_l > 0, L.score, (s_len * a).to(i32))
    sc0 = score_l.clamp(min=1)

    # ---- right: suffix vs [s_rb + s_len, rmax1) ----
    s_qe = s_qb + s_len
    qlen_r = (l_seq - s_qe).to(i32)
    tlen_r = torch.where(s_qe < l_seq, rmax1 - (s_rb + s_len), 0).to(i32)
    qT, tT = _qt_blocks(pac, l_pac, seqbatch, lane_read, s_qe, pos1, qlen_r,
                        s_rb + s_len, pos1, tlen_r, lq_max=lq_max,
                        t_max=t_max)
    eb3 = torch.full((B,), pen_clip3, dtype=i32, device=dev)
    R, retR = ext_kernel.extend_batch_pl2(qT, qlen_r, tT, tlen_r, sc0, eb3,
                                          **kw)
    return torch.stack([*L, retL, *R, retR])


def ref_base_np(pac: np.ndarray, l_pac: int, pos: np.ndarray) -> np.ndarray:
    """Vectorized both-strands base gather (bns_get_seq semantics)."""
    is_rev = pos >= l_pac
    fpos = np.where(is_rev, 2 * l_pac - 1 - pos, pos)
    fpos = np.clip(fpos, 0, l_pac - 1)
    b = (pac[fpos >> 2] >> (((~fpos) & 3) << 1).astype(np.uint8)) & 3
    return np.where(is_rev, 3 - b, b).astype(np.uint8)


def cal_max_gap(opt: MemOptions, qlen: int) -> int:
    """cal_max_gap (bwamem.c:628-637), C truncation semantics."""
    l_del = int((qlen * opt.a - opt.o_del) / opt.e_del + 1.)
    l_ins = int((qlen * opt.a - opt.o_ins) / opt.e_ins + 1.)
    l = max(l_del, l_ins, 1)
    return min(l, opt.w << 1)


class _ExtBatcher:
    """Runs a set of extension lanes through the one-pass extension,
    bucketed by (LQ, LT) shape class so one slow lane cannot stall
    thousands.

    Targets are NOT materialized up front: each lane carries (t_start,
    t_sign) into the reference and the per-class target block gathers only
    the rows of its class.  Under a mesh each dispatch's lanes are split
    over the shards (the packed [10, B] block on axis 1; the reference and
    the read batch replicated)."""

    def __init__(self, opt: MemOptions, mat, end_bonus: int, fm, seq_dev,
                 mesh=None):
        self.opt = opt
        self.mat = mat
        self.end_bonus = end_bonus
        self.fm = fm
        self.seq_dev = seq_dev
        self.mesh = mesh

    def _dispatch(self, idx, B, arrays, *, lq_max, t_max):
        """Pack the lanes `idx` of the nine per-lane arrays into one
        [10, B] block (pad lanes: qlen = tlen = 0, h0 = 1) and enqueue."""
        packed = np.zeros((10, B), np.int64)
        packed[2, idx.size:] = 1      # q_sign pad
        packed[5, idx.size:] = 1      # t_sign pad
        packed[7, idx.size:] = 1      # h0 pad
        packed[8, idx.size:] = self.opt.w
        packed[9] = self.end_bonus
        for r_, a in enumerate(arrays):
            packed[r_, : idx.size] = a[idx]
        dev = self.seq_dev.device
        return pmesh.over(
            self.mesh, _extend_flat,
            dict(lq_max=lq_max, t_max=t_max,
                 **_score_kw(self.opt, self.mat)),
            (True, True, True, "ax1"), out_mask="ax1")(
            self.fm.pac, self.fm.l_pac, self.seq_dev,
            torch.from_numpy(packed).to(dev))

    def submit(self, lane_read, q_start, q_sign, qlen, t_start, t_sign,
               tlen, h0, w):
        """Enqueue all device dispatches for these lanes WITHOUT fetching.
        Returns an opaque plan for drain()."""
        M = len(qlen)
        plan = {"M": M, "parts": []}
        if M == 0:
            return plan
        dev = self.seq_dev.device
        on_card = dev.type != "cpu"
        arrays = (lane_read, q_start, q_sign, qlen, t_start, t_sign, tlen,
                  h0, w)
        assigned = np.zeros(M, bool)
        if not on_card:
            # the plain extension packs a row's maximum as (h << sh) | col:
            # sh = 12 holds queries to 4095 bases and scores below 2^18;
            # wider lanes go in a dispatch of their own, whose shift widens
            # with LQ (ops/extend.py SH).  The CUDA kernel's scalar lane
            # loop packs nothing, so on a card every lane takes the
            # classes below.
            max_mat = int(np.max(np.asarray(self.mat)))
            need = h0.astype(np.int64) + qlen.astype(np.int64) * max_mat
            long_sel = (qlen > ext_kernel.LQ_MAX) | (need >= (1 << 18))
            if long_sel.any():
                lqb = pow2_bucket(int(qlen[long_sel].max()), lo=16)
                sh = max(12, int(lqb).bit_length())
                if int(need[long_sel].max()) >= (1 << (31 - sh)):
                    raise ValueError(
                        "extension score bound exceeded even for the "
                        "widened packing: %d >= 2^%d; lower -A" %
                        (int(need.max()), 31 - sh))
                idx = np.nonzero(long_sel)[0]
                B = _shapes.lanes(idx.size, dev, fine_lo=8, coarse_lo=8,
                                  shards=pmesh.shards(self.mesh))
                LT = pow2_bucket(max(int(tlen[idx].max()), 1), lo=16)
                timers.count("dispatch.extend_long")
                plan["parts"].append((idx, self._dispatch(
                    idx, B, arrays, lq_max=lqb, t_max=LT)))
                assigned = long_sel
        # size classes by target length (the row count of the DP)
        classes = [64, 256, max(1024, pow2_bucket(int(tlen.max()), lo=16))]
        for tcap in classes:
            sel = (~assigned) & (tlen <= tcap)
            assigned |= sel
            cls_idx = np.nonzero(sel)[0]
            if cls_idx.size == 0:
                continue
            if on_card:
                # one query width for the call and the exact class height:
                # a lane costs one thread whatever the block's rows, and few
                # distinct shapes keep the allocator's blocks reusable
                LQ = pow2_bucket(max(int(qlen.max()), 1), lo=16)
                LT = tcap
                tile = _kernel_tile(LQ, LT)
            else:
                # snug classes: padded rows/cols are real work for the
                # plain extension
                LQ = pow2_bucket(max(int(qlen[cls_idx].max()), 1), lo=16)
                LT = pow2_bucket(
                    max(min(tcap, int(tlen[cls_idx].max())), 1), lo=16)
                tile = _shapes.LANE_TILE
            for s0, c in _shapes.chunks(cls_idx.size, tile):
                idx = cls_idx[s0:s0 + c]
                B = _shapes.lanes(idx.size, dev, fine_lo=8, coarse_lo=512,
                                  shards=pmesh.shards(self.mesh))
                timers.count("dispatch.extend")
                plan["parts"].append((idx, self._dispatch(
                    idx, B, arrays, lq_max=LQ, t_max=LT)))
        return plan

    @staticmethod
    def drain(plan):
        """Fetch all results of a submit() plan -> dict of [M] arrays."""
        M = plan["M"]
        out = {k: np.zeros(M, np.int32) for k in FIELDS}
        for idx, res in plan["parts"]:
            arr = _fetch(res, "extend")
            for fi, k in enumerate(FIELDS):
                out[k][idx] = arr[fi, : idx.size]
        return out

    def run(self, lane_read, q_start, q_sign, qlen, t_start, t_sign, tlen,
            h0, w):
        """All arrays [M]; returns dict of result arrays [M]."""
        return self.drain(self.submit(lane_read, q_start, q_sign, qlen,
                                      t_start, t_sign, tlen, h0, w))


def _extend_side(batcher, opt, lane_read, q_start, q_sign, qlen, t_start,
                 t_sign, tlen, h0):
    """MAX_BAND_TRY band-doubling (bwamem.c:732-741): pass 1 at w, retry at
    2w for lanes with max_off >= (w>>1)+(w>>2); returns results + aw."""
    M = len(qlen)
    w1 = np.full(M, opt.w, np.int32)
    r1 = batcher.run(lane_read, q_start, q_sign, qlen, t_start, t_sign,
                     tlen, h0, w1)
    retry = r1["max_off"] >= ((opt.w >> 1) + (opt.w >> 2))
    # reference break: `if (a->score == prev) break` (bwamem.c:735,741) —
    # prev is the score entering the pass (h0: seed score on the left,
    # left-extension score on the right)
    retry &= r1["score"] != h0
    retry &= qlen > 0
    aw = np.where(retry, opt.w * 2, opt.w).astype(np.int32)
    idx = np.nonzero(retry)[0]
    if idx.size:
        r2 = batcher.run(lane_read[idx], q_start[idx], q_sign[idx],
                         qlen[idx], t_start[idx], t_sign[idx], tlen[idx],
                         h0[idx], np.full(idx.size, opt.w * 2, np.int32))
        for k in r1:
            r1[k][idx] = r2[k]
    return r1, aw


def _extend_both_fused(al, opt, mat, seq_dev, ii, s_qb, s_len, s_rb, rmax0,
                       rmax1, l_seq):
    """Host side of _extend_fused: classes lanes by the larger of the two
    target spans, ships ONE [7, B] array per tile, fetches ONE [14, B]
    result.  Returns (L results, aw0, R results, aw1) shaped like two
    _extend_side calls.  Under a mesh each tile's lanes are split over the
    shards, as in _ExtBatcher."""
    M = len(ii)
    mat_np = np.asarray(mat, np.int8)
    dev = seq_dev.device
    kw = dict(_score_kw(opt, mat), a=opt.a, pen_clip5=opt.pen_clip5,
              pen_clip3=opt.pen_clip3, w_opt=opt.w)

    qlen_l = s_qb.astype(np.int64)
    qlen_r = (l_seq - (s_qb + s_len)).astype(np.int64)
    # the (h << 12) | col packing bound (see _ExtBatcher.submit): the right
    # pass starts from the left result, so both windows count
    max_mat = int(mat_np.max())
    hi = int((np.maximum(s_len * opt.a, 1)
              + (qlen_l + qlen_r) * max_mat).max()) if M else 0
    if hi >= (1 << 18):
        raise ValueError(
            "extension score bound exceeded: %d >= 2^18; lower -A or "
            "split the read" % hi)
    tlen_l = np.where(s_qb > 0, s_rb - rmax0, 0)
    tlen_r = np.where(s_qb + s_len < l_seq, rmax1 - (s_rb + s_len), 0)
    tspan = np.maximum(tlen_l, tlen_r)
    lq_fixed = min(pow2_bucket(max(int(max(qlen_l.max(), qlen_r.max())), 1),
                               lo=16), ext_kernel.LQ_MAX)

    classes = [64, 256,
               max(1024, pow2_bucket(int(tspan.max()) if M else 1, lo=16))]
    assigned = np.zeros(M, bool)
    parts = []
    for tcap in classes:
        sel = (~assigned) & (tspan <= tcap)
        assigned |= sel
        cls_idx = np.nonzero(sel)[0]
        if cls_idx.size == 0:
            continue
        for s0, c in _shapes.chunks(cls_idx.size,
                                    _kernel_tile(lq_fixed, tcap)):
            idx = cls_idx[s0:s0 + c]
            B = _shapes.lanes(idx.size, dev, fine_lo=8, coarse_lo=512,
                              shards=pmesh.shards(al.mesh))
            packed = np.zeros((7, B), np.int64)
            for r_, a_ in enumerate((ii, s_qb, s_len, s_rb, rmax0, rmax1,
                                     l_seq)):
                packed[r_, : idx.size] = a_[idx]
            timers.count("dispatch.extend_fused")
            parts.append((idx, pmesh.over(
                al.mesh, _extend_fused,
                dict(kw, lq_max=lq_fixed, t_max=tcap),
                (True, True, True, "ax1"), out_mask="ax1")(
                al.fm.pac, al.l_pac, seq_dev,
                torch.from_numpy(packed).to(dev))))

    L = {k: np.zeros(M, np.int32) for k in FIELDS}
    R = {k: np.zeros(M, np.int32) for k in FIELDS}
    aw0 = np.full(M, opt.w, np.int32)
    aw1 = np.full(M, opt.w, np.int32)
    for idx, res in parts:
        arr = _fetch(res, "extend_fused")
        k = idx.size
        for fi, name in enumerate(FIELDS):
            L[name][idx] = arr[fi, :k]
            R[name][idx] = arr[7 + fi, :k]
        aw0[idx] = np.where(arr[6, :k] != 0, opt.w * 2, opt.w)
        aw1[idx] = np.where(arr[13, :k] != 0, opt.w * 2, opt.w)
    return L, aw0, R, aw1


def extend_regions(al, reads, seq: np.ndarray, wr) -> list[list[AlnReg]]:
    """al: Aligner; reads: list[Read]; seq: packed [N, L] nt4 for THESE
    reads; wr: WorklistNp.  Returns per-read AlnReg lists in mem_chain2aln
    emission order."""
    opt: MemOptions = al.opt
    n = len(reads)
    mat = opt.mat
    seq_dev = torch.from_numpy(np.ascontiguousarray(seq)).to(al.device)

    # ---- flatten work items ----
    n_items = wr.wl_n
    ii, kk = [], []
    for i in range(n):
        c = int(n_items[i])
        if c:
            ii.extend([i] * c)
            kk.extend(range(c))
    M = len(ii)
    regs_out: list[list[AlnReg]] = [[] for _ in range(n)]
    if M == 0:
        return regs_out
    ii = np.asarray(ii, np.int32)
    kk = np.asarray(kk, np.int32)
    slot = wr.wl_slot[ii, kk]
    chn = wr.wl_chain[ii, kk]
    s_qb = wr.seeds.qbeg[ii, slot].astype(np.int64)
    s_len = wr.seeds.len[ii, slot].astype(np.int64)
    s_rb = wr.seeds.rbeg[ii, slot].astype(np.int64)
    rmax0 = wr.rmax0[ii, chn].astype(np.int64)
    rmax1 = wr.rmax1[ii, chn].astype(np.int64)
    rid = wr.chain_rid[ii, chn]
    l_seq = np.asarray([reads[i].l_seq for i in range(n)], np.int64)[ii]

    # ---- left extension lanes (reversed prefixes) ----
    lql = s_qb.astype(np.int32)
    ltl = np.where(s_qb > 0, s_rb - rmax0, 0).astype(np.int32)
    h0 = np.maximum(s_len * opt.a, 1).astype(np.int32)
    neg1 = np.full(M, -1, np.int64)
    # the fused path takes queries to 4095, as the reference routes
    # them — longer reads take the side path, whose one-pass kernel takes
    # any length
    fused = al.device.type != "cpu" and \
        int(l_seq.max()) <= ext_kernel.LQ_MAX
    if fused:
        # ONE dispatch per lane tile covers left + retry + right + retry
        with timers.section("ext.fused"):
            L, aw0, R, aw1 = _extend_both_fused(
                al, opt, mat, seq_dev, ii, s_qb, s_len, s_rb, rmax0,
                rmax1, l_seq)
    else:
        batcherL = _ExtBatcher(opt, mat, opt.pen_clip5, al.fm, seq_dev,
                               mesh=al.mesh)
        with timers.section("ext.left"):
            L, aw0 = _extend_side(batcherL, opt, ii, s_qb - 1, neg1, lql,
                                  s_rb - 1, neg1, ltl, h0)

    has_left = s_qb > 0
    loc_l = (L["gscore"] <= 0) | (L["gscore"] <= L["score"] - opt.pen_clip5)
    score_l = np.where(has_left, L["score"], (s_len * opt.a)).astype(np.int64)
    n_qb = np.where(has_left, np.where(loc_l, s_qb - L["qle"], 0), 0)
    n_rb = np.where(has_left,
                    np.where(loc_l, s_rb - L["tle"], s_rb - L["gtle"]),
                    s_rb)
    truesc_l = np.where(has_left,
                        np.where(loc_l, L["score"], L["gscore"]),
                        s_len * opt.a).astype(np.int64)
    aw0 = np.where(has_left, aw0, opt.w)

    # ---- right extension lanes ----
    s_qe = s_qb + s_len
    rql = (l_seq - s_qe).astype(np.int32)
    rtl = np.where(s_qe < l_seq, rmax1 - (s_rb + s_len), 0).astype(np.int32)
    sc0 = np.maximum(score_l, 1).astype(np.int32)
    pos1 = np.ones(M, np.int64)
    if not fused:
        batcherR = _ExtBatcher(opt, mat, opt.pen_clip3, al.fm, seq_dev,
                               mesh=al.mesh)
        with timers.section("ext.right"):
            R, aw1 = _extend_side(batcherR, opt, ii, s_qe, pos1, rql,
                                  s_rb + s_len, pos1, rtl, sc0)

    has_right = s_qe < l_seq
    loc_r = (R["gscore"] <= 0) | (R["gscore"] <= R["score"] - opt.pen_clip3)
    score_f = np.where(has_right, R["score"], score_l).astype(np.int64)
    n_qe = np.where(has_right,
                    np.where(loc_r, s_qe + R["qle"], l_seq), l_seq)
    n_re = np.where(has_right,
                    np.where(loc_r, s_rb + s_len + R["tle"],
                             s_rb + s_len + R["gtle"]),
                    s_rb + s_len)
    truesc_f = truesc_l + np.where(
        has_right, np.where(loc_r, R["score"] - sc0, R["gscore"] - sc0), 0)
    aw1 = np.where(has_right, aw1, opt.w)
    n_w = np.maximum(aw0, aw1)

    with timers.section("ext.replay"):
        _replay(opt, reads, wr, regs_out, n_items, ii, chn, rid, s_qb, s_len,
                s_rb, n_qb, n_qe, n_rb, n_re, score_f, truesc_f, n_w)
    return regs_out


def _replay(opt, reads, wr, regs_out, n_items, ii, chn, rid, s_qb, s_len,
            s_rb, n_qb, n_qe, n_rb, n_re, score_f, truesc_f, n_w):
    """Sequential skip/accept replay (bwamem.c:674-713) over the extended
    items, appending the accepted regions to regs_out per read."""
    n = len(reads)
    # items are emitted grouped by read in k order, so item m of read i is
    # base[i] + k; per-item state is pulled into Python lists ONCE (scalar
    # numpy indexing per item would dominate this loop)
    base = np.zeros(n + 1, np.int64)
    np.cumsum(np.asarray(n_items[:n], np.int64), out=base[1:])

    # seedcov (bwamem.c:781-786) for every item, vectorized: [M, S] seed
    # table gathered per item vs its own extended region bounds; it depends
    # only on the extension result, not on accept/skip decisions
    sd_qb_a = wr.seeds.qbeg[ii].astype(np.int64)          # [M, S]
    sd_len_a = wr.seeds.len[ii].astype(np.int64)
    sd_rb_a = wr.seeds.rbeg[ii].astype(np.int64)
    in_ch_a = wr.seeds.valid[ii] & (wr.seed_chain[ii] == chn[:, None])
    cov_a = ((sd_qb_a >= n_qb[:, None])
             & (sd_qb_a + sd_len_a <= n_qe[:, None])
             & (sd_rb_a >= n_rb[:, None])
             & (sd_rb_a + sd_len_a <= n_re[:, None]) & in_ch_a)
    seedcov_a = np.where(cov_a, sd_len_a, 0).sum(axis=1).tolist()

    s_rb_l, s_qb_l, s_len_l = s_rb.tolist(), s_qb.tolist(), s_len.tolist()
    n_qb_l, n_rb_l = n_qb.tolist(), n_rb.tolist()
    n_qe_l, n_re_l = n_qe.tolist(), n_re.tolist()
    score_l_, truesc_l_, n_w_l = score_f.tolist(), truesc_f.tolist(), \
        np.asarray(n_w).tolist()
    rid_l, chn_l = rid.tolist(), chn.tolist()
    frac_rep_raw = wr.seeds.frac_rep[:n].tolist()

    for i in range(n):
        c = int(n_items[i])
        if c == 0:
            continue
        b0 = int(base[i])
        lq = reads[i].l_seq
        # per-chain srt bookkeeping: worklist items of one chain appear in
        # srt-descending order; exception scan looks at EARLIER (longer)
        # items of the same chain whose mark is still set
        marks = [True] * c
        chain_items = {}     # chain -> [work indices in order]
        for k in range(c):
            chain_items.setdefault(chn_l[b0 + k], []).append(k)
        regs = regs_out[i]
        frac_rep = float(frac_rep_raw[i]) / max(lq, 1)
        for k in range(c):
            m = b0 + k
            srb, sqb, slen = s_rb_l[m], s_qb_l[m], s_len_l[m]
            hit = -1
            for p in regs:
                if srb < p.rb or srb + slen > p.re or sqb < p.qb or \
                        sqb + slen > p.qe:
                    continue
                if slen - p.seedlen0 > .1 * lq:
                    continue
                qd, rd = sqb - p.qb, srb - p.rb
                w = min(cal_max_gap(opt, min(qd, rd)), p.w)
                if qd - rd < w and rd - qd < w:
                    hit = 1
                    break
                qd, rd = p.qe - (sqb + slen), p.re - (srb + slen)
                w = min(cal_max_gap(opt, min(qd, rd)), p.w)
                if qd - rd < w and rd - qd < w:
                    hit = 1
                    break
            if hit >= 0:
                # overlapping-seed exception (bwamem.c:699-711)
                mates = chain_items[chn_l[m]]
                pos = mates.index(k)
                differs = False
                for k2 in mates[:pos][::-1]:   # earlier = longer, srt asc
                    if not marks[k2]:
                        continue
                    m2 = b0 + k2
                    tq, tr, tl_ = s_qb_l[m2], s_rb_l[m2], s_len_l[m2]
                    if tl_ < slen * .95:
                        continue
                    if sqb <= tq and sqb + slen - tq >= slen >> 2 and \
                            tq - sqb != tr - srb:
                        differs = True
                        break
                    if tq <= sqb and tq + tl_ - sqb >= slen >> 2 and \
                            sqb - tq != srb - tr:
                        differs = True
                        break
                if not differs:
                    marks[k] = False
                    continue
            regs.append(AlnReg(
                rb=n_rb_l[m], re=n_re_l[m], qb=n_qb_l[m], qe=n_qe_l[m],
                rid=rid_l[m], score=score_l_[m], truesc=truesc_l_[m],
                w=n_w_l[m], seedcov=seedcov_a[m], seedlen0=slen,
                frac_rep=frac_rep))
