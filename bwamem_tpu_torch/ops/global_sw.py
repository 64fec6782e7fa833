"""Banded global (Needleman-Wunsch) alignment with traceback — batched.

Exact semantics of ksw_global2 (reference ksw.c:504-606): banded affine-gap
DP over [max(i-w,0), min(i+w+1, qlen)) per target row with a 6-bit direction
byte per cell (h dir in bits 0-1, E-extend in bit 2, F-extend in bits 4-5),
followed by the which-state traceback and run-length cigar merging of
push_cigar (ksw.c:491-501).

One Python step = one target row for EVERY lane; the serial F recurrence
F(i,j+1) = max(M(i,j)-oe_ins, F(i,j)-e_ins) is solved per row with a prefix
max over A(j) = M(j) + e_ins*j (torch.cummax), giving
F(j) = maxprefix(A)(j-1) - oe_ins - e_ins*(j-1).  The direction matrix is
uint8 [B, LT, n_col]; the traceback walks every lane in lockstep, records
its per-step `which` stream, and run-length encodes it afterwards into
fixed-capacity (op, len) tables that the host turns into CIGAR strings.

Plain tensor code on any device, as the reference package computes it
outside any Pallas kernel.  Counterpart of bwamem_tpu/ops/global_sw.py;
every output equals it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = -0x40000000
i32 = torch.int32
# traceback steps between the host's looks at the lanes' done mask
CHECK_EVERY = 16


class GlobalResult(NamedTuple):
    score: torch.Tensor      # [B] int32 — H(tlen-1, qlen-1)
    ops: torch.Tensor        # [B, MC] int32 cigar op per run (0 M, 1 I, 2 D)
    lens: torch.Tensor       # [B, MC] int32 run lengths
    n_cigar: torch.Tensor    # [B] int32 runs used
    overflow: torch.Tensor   # [B] bool — more runs than MC (caller retries)


def _col(B: int, value: int, dev, dtype=i32) -> torch.Tensor:
    return torch.full((B, 1), value, dtype=dtype, device=dev)


def global_align_batch(query: torch.Tensor, qlen: torch.Tensor,
                       target: torch.Tensor, tlen: torch.Tensor,
                       w: torch.Tensor, mat, *, o_del: int, e_del: int,
                       o_ins: int, e_ins: int, w_max: int,
                       max_cigar: int = 32,
                       with_cigar: bool = True) -> GlobalResult:
    """Banded global alignment of B (query, target) pairs in lockstep.

    query/target: [B, LQ]/[B, LT] nt4 codes 0-4 (callers pre-reverse both
    for reverse-strand hits so indels left-align, as bwa_gen_cigar2
    bwa.c:275).  w: [B] per-lane band (clamped to w_max).  mat: [5, 5]
    host array.  The host looks at the traceback's done mask once every
    CHECK_EVERY steps to stop early; finished lanes are masked, so that
    changes no result."""
    B, LQ = query.shape
    LT = target.shape[1]
    dev = query.device
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    NCOL = min(LQ, 2 * w_max + 1)
    MC = max_cigar
    u8 = torch.uint8

    w = w.to(i32).clamp(max=w_max)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    rows1 = torch.arange(B, device=dev)

    jj = torch.arange(LQ + 1, dtype=i32, device=dev)[None, :]
    col = jj[:, :LQ]
    qpad = torch.where(col < qlen[:, None], query.to(torch.int64), 4)
    matf = torch.from_numpy(np.asarray(mat).astype(np.int32).reshape(-1)
                            ).to(dev)
    prof = torch.stack([matf[c * 5 + qpad] for c in range(5)], dim=1)
    target = target.to(i32)

    # first row (ksw.c:520-524): eh[j].h = -(o_ins+e_ins*j) for 1<=j<=w
    Hp = torch.where(jj == 0, 0, torch.where(
        (jj <= w[:, None]) & (jj <= qlen[:, None]), -(o_ins + e_ins * jj),
        NEG)).to(i32)
    Ep = torch.full((B, LQ + 1), NEG, dtype=i32, device=dev)
    z = torch.zeros((B, LT, NCOL) if with_cigar else (B, 1, 1), dtype=u8,
                    device=dev)
    ramp = e_ins * col
    cc = torch.arange(NCOL, dtype=i32, device=dev)[None, :]
    negcol, zcol = _col(B, NEG, dev), _col(B, 0, dev)
    negB = torch.full((B,), NEG, dtype=i32, device=dev)

    for i in range(LT):
        act = i < tlen
        beg = (i - w).clamp(min=0)
        end = torch.minimum(i + w + 1, qlen)
        tbi = target[:, i, None]
        q = prof[:, 4]
        for c in range(4):
            q = torch.where(tbi == c, prof[:, c], q)
        win = (col >= beg[:, None]) & (col < end[:, None])

        m = Hp[:, :LQ] + q
        e = Ep[:, :LQ]
        # F prefix-max: F(j) = max_{j'<j}(M(j')+e*j') - oe - e*(j-1)
        A = torch.where(win, m + ramp, NEG)
        G = torch.cummax(A, dim=1).values
        Gprev = torch.cat([negcol, G[:, :-1]], dim=1)
        F = torch.where(Gprev <= NEG // 2, NEG,
                        Gprev - oe_ins - ramp + e_ins)

        d = (m < e).to(u8)
        h = torch.maximum(m, e)
        d = torch.where(h >= F, d, 2)
        h = torch.maximum(h, F)

        t_del = m - oe_del
        ebit = (e - e_del) > t_del
        e_new = torch.maximum(e - e_del, t_del)
        fbit = (F - e_ins) > (m - oe_ins)
        d = d | (ebit.to(u8) << 2) | (fbit.to(u8) << 5)

        if with_cigar:
            src = (beg[:, None] + cc).clamp(0, LQ - 1).to(torch.int64)
            zrow = d.gather(1, src)
            z[:, i] = torch.where(cc < (end - beg)[:, None], zrow, 0)

        h1_init = torch.where(beg == 0, -(o_del + e_del * (i + 1)), negB)
        h_sh = torch.cat([zcol, h], dim=1)
        wh = (jj >= beg[:, None]) & (jj <= end[:, None])
        Hp2 = torch.where(wh, torch.where(jj == beg[:, None],
                                          h1_init[:, None], h_sh), Hp)
        we = (jj >= beg[:, None]) & (jj < end[:, None])
        e_pad = torch.cat([e_new, negcol], dim=1)
        Ep2 = torch.where(we, e_pad,
                          torch.where(jj == end[:, None], NEG, Ep))
        Hp = torch.where(act[:, None], Hp2, Hp)
        Ep = torch.where(act[:, None], Ep2, Ep)

    score = Hp.gather(1, qlen[:, None].to(torch.int64))[:, 0]
    if not with_cigar:
        zi = torch.zeros((B,), dtype=i32, device=dev)
        zmc = torch.zeros((B, MC), dtype=i32, device=dev)
        return GlobalResult(score, zmc, zmc.clone(), zi, zi.to(torch.bool))

    # ---- traceback (ksw.c:589-603): record the per-step `which` stream,
    # then merge runs as push_cigar does ----
    S = LT + LQ + 2                      # path length bound
    i = tlen - 1
    k = torch.minimum(tlen - 1 + w + 1, qlen) - 1
    which = torch.zeros((B,), dtype=i32, device=dev)
    wbuf = torch.full((S, B), 3, dtype=u8, device=dev)   # 3 = inactive
    for s in range(S):
        active = (i >= 0) & (k >= 0)
        if s % CHECK_EVERY == 0 and not bool(active.any()):
            break
        beg = (i - w).clamp(min=0)
        ic = i.clamp(0, LT - 1).to(torch.int64)
        kc = (k - beg).clamp(0, NCOL - 1).to(torch.int64)
        zi = z[rows1, ic, kc].to(i32)
        which = torch.where(active, (zi >> (which << 1)) & 3, which)
        wbuf[s] = torch.where(active, which, 3).to(u8)
        i = i - (active & (which != 2)).to(i32)
        k = k - (active & (which != 1)).to(i32)

    # run-length encode the recorded streams (push_cigar semantics):
    # which 0 -> M, 1 -> D, 2 -> I; 3 marks steps past a lane's exit.  A
    # lane's valid steps are contiguous from 0, so run j's length is
    # start[j+1] - start[j].
    wb = wbuf.to(i32).T                                      # [B, S]
    opst = torch.where(wb == 0, 0, torch.where(
        wb == 1, 2, torch.where(wb == 2, 1, -1))).to(i32)
    valid = opst >= 0
    prev = torch.cat([_col(B, -2, dev), opst[:, :-1]], dim=1)
    startr = valid & (opst != prev)
    srange = torch.arange(S, dtype=i32, device=dev)[None, :]
    nrun = startr.sum(1, dtype=i32)                            # [B]
    last_s = torch.where(valid, srange, -1).max(dim=1).values  # [B]
    last_op = (torch.where(srange == last_s[:, None], opst, 0)
               * valid.to(i32)).sum(1, dtype=i32)            # [B]
    keys = torch.where(startr, srange, S + 1)
    sk, order = torch.sort(keys, dim=1, stable=True)
    so = opst.gather(1, order)
    if MC <= S:
        starts, ops_s = sk[:, :MC], so[:, :MC]
    else:     # retried with a giant cigar cap: runs can never exceed S
        starts = torch.cat([sk, torch.full((B, MC - S), S + 1, dtype=i32,
                                           device=dev)], dim=1)
        ops_s = torch.cat([so, torch.zeros((B, MC - S), dtype=i32,
                                           device=dev)], dim=1)
    nxt = torch.cat([starts[:, 1:], _col(B, S + 1, dev)], dim=1)
    lens_s = torch.minimum(nxt, last_s[:, None] + 1) - starts
    jr = torch.arange(MC, dtype=i32, device=dev)[None, :]
    run_ok = jr < torch.minimum(nrun, torch.tensor(MC, dtype=i32,
                                                   device=dev))[:, None]
    # one spare column takes the writes the reference drops (slot MC)
    ops = torch.cat([torch.where(run_ok, ops_s, 0), zcol], dim=1)
    lens = torch.cat([torch.where(run_ok, lens_s, 0), zcol], dim=1)

    # trailing run (ksw.c:598-599): leading deletions when i survived,
    # else leading insertions — the loop exit makes them mutually
    # exclusive (a lane exits as soon as i < 0 or k < 0)
    t_active = (i >= 0) | (k >= 0)
    t_op = torch.where(i >= 0, 2, 1).to(i32)
    t_len = torch.where(i >= 0, i + 1, k + 1)
    t_merge = t_active & (nrun > 0) & (last_op == t_op)
    mslot = torch.where(t_merge, (nrun - 1).clamp(max=MC - 1), MC)
    lens.index_put_((rows1, mslot.to(torch.int64)), t_len, accumulate=True)
    t_new = t_active & ~t_merge
    aslot = torch.where(t_new & (nrun < MC), nrun, MC).to(torch.int64)
    ops[rows1, aslot] = t_op
    lens[rows1, aslot] = t_len
    ops, lens = ops[:, :MC], lens[:, :MC]
    n = nrun + t_new.to(i32)
    overflow = n > MC
    n = n.clamp(max=MC)

    # traceback emitted runs back-to-front; reverse per lane
    idx = (n[:, None] - 1 - jr).clamp(0, MC - 1).to(torch.int64)
    keep = jr < n[:, None]
    ops_r = torch.where(keep, ops.gather(1, idx), 0)
    lens_r = torch.where(keep, lens.gather(1, idx), 0)
    return GlobalResult(score, ops_r, lens_r, n, overflow)
