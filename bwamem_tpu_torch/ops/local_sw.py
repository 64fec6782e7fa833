"""Batched unbanded local Smith-Waterman — ksw_align2 semantics.

Exact behavior of the reference's SSE2 striped SW (ksw_u8/ksw_i16,
ksw.c:112-334) and the ksw_align2 two-pass start-finding wrapper
(ksw.c:343-369) with xtra = KSW_XSUBO | KSW_XSTART | minsc:

  * score/te:   best score; te = FIRST target row attaining it strictly;
  * qe:         minimum query index attaining the best row's maximum
                (the striped iteration order reduces to exactly this);
  * score2/te2: best row-max outside te ± ceil(score/max_mat), where
                consecutive qualifying rows (rowmax >= minsc) merge into
                one run keeping (run max, first row attaining it);
  * tb/qb:      from a second pass over the reversed prefixes with
                XSTOP = score (early stop at the first row reaching it);
                -1 when the second pass disagrees (ksw.c:365-366).

Organized like ops/extend.py: one loop trip = one target row for every
lane, the row's serial F recurrence solved with a prefix max (valid because
o_ins + e_ins > e_ins, so an F-derived H never opens a better F), per-lane
done masks instead of breaks.  Saturating-u8 quirks of ksw_u8 are
unreachable for scores < 251, which the callers guarantee by choosing the
16-wide stripe only when l_ms * a < 250.  Plain tensor code on any device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

i32 = torch.int32
NEG = -0x40000000


class KswResult(NamedTuple):
    score: torch.Tensor    # [B]
    te: torch.Tensor       # [B]
    qe: torch.Tensor       # [B]
    score2: torch.Tensor   # [B]
    te2: torch.Tensor      # [B]
    tb: torch.Tensor       # [B]
    qb: torch.Tensor       # [B]


def _pass(query, qlen, qpadlen, target, tlen, endsc, matf, o_del, e_del,
          o_ins, e_ins, check_every: int = 8):
    """One striped-SW forward pass; returns (gmax, te, Hmax, rowmax).

    qpadlen = qlen rounded up to the SIMD stripe (16 for ksw_u8, 8 for
    ksw_i16): the reference's striped layout implicitly extends the query
    with phantom positions scoring 0 against every base (ksw_qinit,
    ksw.c:94-97 `k >= qlen? 0 : ...`), and those phantom columns carry
    "ghost" values into later row maxima — which changes score2/te2.
    Bit parity requires modeling them.  The host looks at the done mask
    once every `check_every` rows to stop early; finished lanes are masked,
    so that changes no result."""
    B, LQ = query.shape
    LT = target.shape[1]
    dev = query.device
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    col = torch.arange(LQ, dtype=i32, device=dev)[None, :]
    inq = col < qlen[:, None]
    inp = col < qpadlen[:, None]
    qpad = torch.where(inq, query.to(torch.int64), 4)
    ramp = e_ins * col
    prof = torch.stack([torch.where(inq, matf[c * 5 + qpad], 0)
                        for c in range(5)], dim=1)
    target = target.to(i32)

    Hp = torch.zeros((B, LQ), dtype=i32, device=dev)
    E = torch.zeros((B, LQ), dtype=i32, device=dev)
    gmax = torch.zeros((B,), dtype=i32, device=dev)
    te = torch.full((B,), -1, dtype=i32, device=dev)
    Hmax = torch.zeros((B, LQ), dtype=i32, device=dev)
    rowmax = torch.zeros((B, LT), dtype=i32, device=dev)
    done = tlen <= 0
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)

    for i in range(LT):
        if i % check_every == 0 and bool(done.all()):
            break
        act = (~done) & (i < tlen)
        tbi = target[:, i, None]
        S = prof[:, 4]
        for c in range(4):
            S = torch.where(tbi == c, prof[:, c], S)
        Hp_sh = torch.cat([zcol, Hp[:, :-1]], dim=1)
        M = (Hp_sh + S).clamp(min=0)
        ME = torch.where(inp, torch.maximum(M, E), 0)
        # F(j) = max(0, max_{j'<j}(ME(j') + e*j') - oe - e*(j-1))
        A = torch.where(inp, ME + ramp, NEG)
        G = torch.cummax(A, dim=1).values
        Gp = torch.cat([negcol, G[:, :-1]], dim=1)
        F = (Gp - oe_ins - ramp + e_ins).clamp(min=0)
        H = torch.where(inp, torch.maximum(ME, F), 0)
        E2 = torch.where(
            inp, torch.maximum(E - e_del, H - oe_del).clamp(min=0), 0)

        imax = H.max(dim=1).values
        rowmax[:, i] = torch.where(act, imax, 0)
        better = act & (imax > gmax)
        gmax = torch.where(better, imax, gmax)
        te = torch.where(better, i, te).to(i32)
        Hmax = torch.where(better[:, None], H, Hmax)
        done = done | (better & (gmax >= endsc)) | (i + 1 >= tlen)
        Hp = torch.where(act[:, None], H, Hp)
        E = torch.where(act[:, None], E2, E)
    return gmax, te, Hmax, rowmax


def _qe_from_hmax(Hmax):
    """Minimum query index attaining the snapshot row's max
    (ksw.c:218-221 reduced)."""
    LQ = Hmax.shape[1]
    m = Hmax.max(dim=1).values
    col = torch.arange(LQ, dtype=i32, device=Hmax.device)[None, :]
    return torch.where(Hmax == m[:, None], col, LQ).min(dim=1).values


def _score2(rowmax, tlen, te, score, minsc, max_mat):
    """b-array entry merging + exclusion window (ksw.c:204-213, 224-231).

    An entry (max, row) absorbs row i only when i == row + 1, advancing its
    row ONLY on strict improvement (ksw.c:206-212); any other qualifying
    row finalizes the entry and opens a new one.  At the end the best entry
    with row outside te ± ceil(score/max_mat) is score2 (first such entry
    wins ties, strictly-greater comparison)."""
    B, LT = rowmax.shape
    dev = rowmax.device
    d = (score + max_mat - 1) // max_mat
    lo, hi = te - d, te + d

    def finalize(entry_max, entry_row, have, best2, best2_row, cond):
        outside = (entry_row < lo) | (entry_row > hi)
        take = cond & have & outside & (entry_max > best2)
        return (torch.where(take, entry_max, best2),
                torch.where(take, entry_row, best2_row))

    entry_max = torch.zeros((B,), dtype=i32, device=dev)
    entry_row = torch.full((B,), -2, dtype=i32, device=dev)
    have = torch.zeros((B,), dtype=torch.bool, device=dev)
    best2 = torch.full((B,), -1, dtype=i32, device=dev)
    best2_row = torch.full((B,), -1, dtype=i32, device=dev)
    # rows past the longest target qualify in no lane
    for i in range(min(LT, int(tlen.max())) if B else 0):
        v = rowmax[:, i]
        ok = (i < tlen) & (v >= minsc)
        adjacent = have & (entry_row + 1 == i)
        improve = ok & adjacent & (v > entry_max)
        newent = ok & ~adjacent
        best2, best2_row = finalize(entry_max, entry_row, have, best2,
                                    best2_row, newent)
        entry_max = torch.where(improve | newent, v, entry_max)
        entry_row = torch.where(improve | newent, i, entry_row).to(i32)
        have = have | ok
    return finalize(entry_max, entry_row, have, best2, best2_row,
                    torch.ones((B,), dtype=torch.bool, device=dev))


def ksw_align_batch(query: torch.Tensor, qlen: torch.Tensor,
                    target: torch.Tensor, tlen: torch.Tensor,
                    minsc: torch.Tensor, mat, *, o_del: int, e_del: int,
                    o_ins: int, e_ins: int, max_mat: int,
                    p: int = 16) -> KswResult:
    """ksw_align2 with xtra = KSW_XSUBO | KSW_XSTART | minsc, batched.

    p is the SIMD stripe width of the emulated kernel: 16 for ksw_u8
    (chosen by the caller when l_ms * a < 250), 8 for ksw_i16.  The query
    behaves as if padded to a multiple of p with phantom 0-scoring bases
    (see _pass); LQ must be >= max padded length.  mat: [5,5] host array."""
    B, LQ = query.shape
    LT = target.shape[1]
    dev = query.device
    matf = torch.from_numpy(np.asarray(mat).astype(np.int32).reshape(-1)
                            ).to(dev)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    minsc = minsc.to(i32).expand(B)
    bigs = torch.full((B,), 0x10000, dtype=i32, device=dev)
    kw = (matf, o_del, e_del, o_ins, e_ins)

    def padlen(n):
        return ((n + p - 1) // p * p).clamp(max=LQ)

    gmax, te, Hmax, rowmax = _pass(query, qlen, padlen(qlen), target, tlen,
                                   bigs, *kw)
    qe = _qe_from_hmax(Hmax)
    score2, te2 = _score2(rowmax, tlen, te, gmax, minsc, max_mat)

    # ---- second pass on reversed prefixes (KSW_XSTART, ksw.c:360-367) ----
    do2 = gmax >= minsc
    col_q = torch.arange(LQ, dtype=i32, device=dev)[None, :]
    col_t = torch.arange(LT, dtype=i32, device=dev)[None, :]
    q2len = torch.where(do2, qe + 1, 0).to(i32)
    t2len = torch.where(do2, te + 1, 0).to(i32)
    qidx = (qe[:, None] - col_q).clamp(0, LQ - 1).to(torch.int64)
    tidx = (te[:, None] - col_t).clamp(0, LT - 1).to(torch.int64)
    q2 = torch.gather(query, 1, qidx)
    t2 = torch.gather(target, 1, tidx)
    g2, te_r, Hmax2, _ = _pass(q2, q2len, padlen(q2len), t2, t2len, gmax,
                               *kw)
    qe_r = _qe_from_hmax(Hmax2)
    agree = do2 & (g2 == gmax)
    tb = torch.where(agree, te - te_r, -1)
    qb = torch.where(agree, qe - qe_r, -1)
    return KswResult(score=gmax, te=te, qe=qe, score2=score2, te2=te2,
                     tb=tb, qb=qb)
