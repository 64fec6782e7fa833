"""Banded affine-gap Smith-Waterman extension — batched, row-parallel.

Exact semantics of ksw_extend2 (reference ksw.c:380-479) — including the
adaptive [beg,end) window, z-drop row termination, the M==0 short-circuit
that forbids "100M3I3D20M"-style cigars, to-end (gscore) bookkeeping and
max_off tracking — organized as tensor ops over every lane at once:

  * one loop trip = one TARGET row for every lane in the batch;
  * the row's horizontal F-dependency (F(i,j+1) = max(H(i,j)-oe, F(i,j))-e)
    is resolved with a prefix max: because an F-dominant H never opens a
    better F (oe > e), F(j) = max_{j'<j} (max(0, M(j')-oe) - (j-1-j')*e),
    which after adding e*j to both sides is a plain running maximum;
  * per-lane scalars (beg, end, max, max_i/j, gscore, zdrop-done) are
    [B] tensors; finished lanes are masked, not retired;
  * at row i every lane's window lies in columns [i - w, i + w + 1), so a
    trip works on that column slice of the state (in place), not on the
    whole query width: a 5 kbp query costs 2w + 2 columns a row.

This is the plain version of the hand-written extension kernel
(ops/ext_kernel.py): the CPU runs it, and the card checks the kernel
against it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG = -0x40000000


class ExtendResult(NamedTuple):
    score: torch.Tensor     # [B] best local score (>= h0 semantics of ksw)
    qle: torch.Tensor       # [B] query end (local)
    tle: torch.Tensor       # [B] target end (local)
    gtle: torch.Tensor      # [B] target end of best to-query-end extension
    gscore: torch.Tensor    # [B] best to-query-end score (-1 if none)
    max_off: torch.Tensor   # [B] max diagonal offset of the best cell


def _adjust_w(w, qlen, max_mat, end_bonus, o_ins, e_ins, o_del, e_del):
    """Band clamp (ksw.c:399-407): w = min(w, max_ins, max_del), in C
    double arithmetic with int truncation."""
    qf = qlen.to(torch.float64)
    max_ins = (qf * max_mat + end_bonus - o_ins) / e_ins + 1.0
    max_ins = max_ins.to(torch.int32).clamp(min=1)
    max_del = (qf * max_mat + end_bonus - o_del) / e_del + 1.0
    max_del = max_del.to(torch.int32).clamp(min=1)
    return torch.minimum(torch.minimum(w, max_ins), max_del)


def extend_batch(query: torch.Tensor, qlen: torch.Tensor, target_at,
                 tlen: torch.Tensor, h0: torch.Tensor, w: torch.Tensor,
                 end_bonus: torch.Tensor, mat, *, o_del: int, e_del: int,
                 o_ins: int, e_ins: int, zdrop: int, t_max: int,
                 check_every: int = 8) -> ExtendResult:
    """Run ksw_extend2 for B lanes in lockstep.

    query:  [B, LQ] nt4 codes (already reversed for left extensions)
    qlen:   [B]
    target_at: callable (i: int) -> [B] nt4 code of target row i per lane
    tlen:   [B]; t_max: bound on rows (rows past it are not run)
    h0:     [B] > 0 starting score; w: [B] band; end_bonus: [B]
    mat:    [5,5] int8 scoring matrix (host array)
    The host looks at the lanes' done mask once every `check_every` rows
    to stop early; finished lanes are masked, so that changes no result.
    """
    B, LQ = query.shape
    dev = query.device
    L1 = LQ + 1
    i32 = torch.int32
    # (h << SH) | col packing in the row reduction: SH = 12 for short
    # reads; longer queries widen the column field
    SH = max(12, int(LQ).bit_length())
    CMASK = (1 << SH) - 1
    assert LQ <= CMASK, (LQ, SH)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    mat = np.asarray(mat)
    max_mat = int(np.max(mat))
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    h0 = h0.to(i32)

    w = _adjust_w(w.to(i32), qlen, max_mat, end_bonus.to(i32),
                  o_ins, e_ins, o_del, e_del)

    jj = torch.arange(L1, dtype=i32, device=dev)[None, :]     # [1, L1]
    # first row of eh (ksw.c:395-397)
    v = h0[:, None] - oe_ins - (jj - 1) * e_ins
    eh_h = torch.where(jj == 0, h0[:, None], v.clamp(min=0))
    eh_h = torch.where(jj <= qlen[:, None], eh_h, 0).to(i32)
    eh_e = torch.zeros((B, L1), dtype=i32, device=dev)

    col = jj[:, :LQ]
    qpad = torch.where(col < qlen[:, None], query.to(torch.int64), 4)
    matf = torch.from_numpy(mat.astype(np.int32).reshape(-1)).to(dev)
    # score-profile rows, precomputed per target symbol so the row loop
    # does a 5-way select instead of a per-row gather
    prof = torch.stack([matf[c * 5 + qpad] for c in range(5)], dim=1)

    ramp = col * e_ins                                # e*j per column

    beg = torch.zeros((B,), dtype=i32, device=dev)
    end = qlen.clone()
    mx = h0.clone()
    max_i = torch.full((B,), -1, dtype=i32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros((B,), dtype=i32, device=dev)
    done = tlen <= 0
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    # the widest band of the batch (one host read) bounds every row's
    # column slice
    w_hi = int(w.max()) if B else 0

    for i in range(t_max):
        if i % check_every == 0 and bool(done.all()):
            break
        act = (~done) & (i < tlen)
        begi = torch.clamp(beg, min=i - w)
        endi = torch.minimum(torch.minimum(end, i + w + 1), qlen)
        # columns [lo, hi) hold every lane's window [begi, endi) of this
        # row; the eh planes are touched in [lo, hi] (they run to endi)
        lo = max(0, min(i - w_hi, LQ - 1))
        hi = min(LQ, i + w_hi + 1)
        colw = col[:, lo:hi]
        jjw = jj[:, lo:hi + 1]
        rampw = ramp[:, lo:hi]
        eh_hw = eh_h[:, lo:hi + 1]
        eh_ew = eh_e[:, lo:hi + 1]

        tb = target_at(i)                 # garbage for finished lanes is
        q = prof[:, 4, lo:hi]             # fine: they are masked below
        for c in range(4):
            q = torch.where(tb[:, None] == c, prof[:, c, lo:hi], q)

        win = (colw >= begi[:, None]) & (colw < endi[:, None])

        M = eh_hw[:, :-1]
        E = eh_ew[:, :-1]
        Mq = torch.where(M != 0, M + q, 0)            # ksw.c:433 M?M+q:0
        # F via prefix-max with linear decay (first f at beg is 0); the
        # columns left of the slice lie outside every window
        t_ins = (Mq - oe_ins).clamp(min=0)
        A = torch.where(win, t_ins + rampw + e_ins, NEG)
        G = torch.cummax(A, dim=1).values
        Gprev = torch.cat([negcol, G[:, :-1]], dim=1)
        F = (Gprev - rampw).clamp(min=0)
        F = torch.where(colw == begi[:, None], 0, F)

        h = torch.maximum(torch.maximum(Mq, E), F)
        h = torch.where(win, h, 0)

        # h1 entering column beg (ksw.c:420-423)
        h1_init = torch.where(begi == 0,
                              (h0 - (o_del + e_del * (i + 1))).clamp(min=0),
                              0)

        # row max + its LAST attaining column, and h at column end-1
        mj_enc = ((h << SH) | colw).max(dim=1).values
        h1_enc = torch.where(colw == (endi - 1)[:, None], h, NEG
                             ).max(dim=1).values
        m = mj_enc >> SH
        mj = torch.where(m > 0, mj_enc & CMASK,
                         torch.where(endi > begi, endi - 1, -1))

        # E update (ksw.c:439-443)
        e_new = torch.maximum(E - e_del, (Mq - oe_del).clamp(min=0))

        # write back eh rows: eh_h[j] = H(i, j-1) for j in [beg, end];
        # eh_e[j] for j in [beg, end); eh_e[end] = 0
        h_sh = torch.cat([zcol, h], dim=1)
        wh = (jjw >= begi[:, None]) & (jjw <= endi[:, None])
        new_h = torch.where(jjw == begi[:, None], h1_init[:, None], h_sh)
        eh_h2 = torch.where(wh & act[:, None], new_h, eh_hw)
        e_pad = torch.cat([e_new, zcol], dim=1)
        we = (jjw >= begi[:, None]) & (jjw < endi[:, None])
        eh_e2 = torch.where(we & act[:, None], e_pad, eh_ew)
        eh_e2 = torch.where((jjw == endi[:, None]) & act[:, None], 0, eh_e2)

        # gscore at the last query column (ksw.c:450-453)
        h1_last = torch.where(endi > begi, h1_enc, h1_init)
        reach = act & (endi == qlen)
        upd_g = reach & (gscore <= h1_last)
        max_ie2 = torch.where(reach & (gscore > h1_last), max_ie,
                              torch.where(reach, i, max_ie))
        gscore2 = torch.where(upd_g, torch.maximum(gscore, h1_last), gscore)

        # break / max update (ksw.c:454-464)
        brk0 = act & (m == 0)
        better = act & (m > mx)
        mx2 = torch.where(better, m, mx)
        max_i2 = torch.where(better, i, max_i)
        max_j2 = torch.where(better, mj, max_j)
        off = (mj - i).abs()
        max_off2 = torch.where(better, torch.maximum(max_off, off), max_off)
        di = i - max_i
        dj = mj - max_j
        zd = torch.where(di > dj, mx - m - (di - dj) * e_del > zdrop,
                         mx - m - (dj - di) * e_ins > zdrop)
        brk1 = act & ~brk0 & ~better & (zdrop > 0) & zd

        # window shrink (ksw.c:466-469) on the NEW eh values; both scans in
        # one reduction each (no nz column exists in [beg, first_nz), so
        # the last-nz mask can start at beg)
        nz = (eh_h2 != 0) | (eh_e2 != 0)
        BIGJ = 1 << 20
        fst = torch.where(we & nz, BIGJ - jjw, -1).max(dim=1).values
        lst = torch.where(wh & nz, jjw, -1).max(dim=1).values
        first_nz = torch.where(fst < 0, L1, BIGJ - fst)
        beg2 = torch.minimum(first_nz, endi)
        end2 = torch.minimum(lst + 2, qlen)

        done = done | brk0 | brk1 | (i + 1 >= tlen)
        keep = act & ~brk0 & ~brk1
        live = act & ~brk0
        eh_h[:, lo:hi + 1] = eh_h2
        eh_e[:, lo:hi + 1] = eh_e2
        beg = torch.where(keep, beg2, beg).to(i32)
        end = torch.where(keep, end2, end).to(i32)
        mx = torch.where(live, mx2, mx)
        max_i = torch.where(live, max_i2, max_i).to(i32)
        max_j = torch.where(live, max_j2, max_j).to(i32)
        max_ie = torch.where(act, max_ie2, max_ie).to(i32)
        gscore = torch.where(act, gscore2, gscore)
        max_off = torch.where(live, max_off2, max_off)
    return ExtendResult(score=mx, qle=max_j + 1, tle=max_i + 1,
                        gtle=max_ie + 1, gscore=gscore, max_off=max_off)
