"""Affine-gap alignment of reads against genome windows, in NumPy.

For each (query, window) lane, `best_scores` gives the best raw score of
four kinds of alignment: the start free in the query (local) or at its
first base (end to end), and the end likewise; the window is free at both
ends.  `choice` picks among them as BWA-MEM's clipping rule does: an end
is reached only where reaching it scores more than clipping it less the
clipping penalty (ties clip), so the pick maximises the raw score plus the
penalty of each end reached, and a tie goes to the higher raw score.

Scores: `a` a match, -`b` a mismatch, -1 against N (code 4), a gap of k
bases -(o + k e) (deletions o_del/e_del, insertions o_ins/e_ins).  Code 5
pads a window and no alignment enters it.  `bits` 8 runs every cell in
saturating int8 (the control's lower precision); None in int32.
"""
from __future__ import annotations

import numpy as np

NEG = -(1 << 20)
PAD = 5
# the four kinds, in best_scores' column order: (start reached, end reached)
KINDS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _mat6(a: int, b: int) -> np.ndarray:
    m = np.full((6, 6), -1, np.int32)
    m[:4, :4] = -b
    m[np.arange(4), np.arange(4)] = a
    m[PAD, :] = m[:, PAD] = -1000
    return m


def best_scores(q: np.ndarray, t: np.ndarray, sc: dict,
                bits: int | None = None) -> np.ndarray:
    """q: uint8 [n, L] queries (all of length L); t: uint8 [n, W] windows
    padded with PAD.  Returns int64 [n, 4], KINDS order."""
    n, L = q.shape
    W = t.shape[1]
    mat = _mat6(int(sc["a"]), int(sc["b"]))
    tab = mat[:, t]                                  # [6, n, W]
    lanes = np.arange(n)
    od, ed = int(sc["o_del"]), int(sc["e_del"])
    oi, ei = int(sc["o_ins"]), int(sc["e_ins"])
    ramp = (ed * np.arange(W, dtype=np.int32))[None, :]
    lo, hi = (-(1 << 7), (1 << 7) - 1) if bits == 8 else (NEG, -NEG)

    def sat(x):
        return np.clip(x, lo, hi, out=x) if bits == 8 else x

    out = np.zeros((n, 4), np.int64)
    for k, start_e2e in enumerate((False, True)):
        hprev = np.zeros((n, W + 1), np.int32)       # row -1: free start
        hprev[:, 0] = NEG
        f = np.full((n, W), NEG, np.int32)
        best = np.full(n, NEG, np.int64)
        for i in range(L):
            diag = hprev[:, :-1]
            if not start_e2e:
                diag = np.maximum(diag, 0)
            m = sat(diag + tab[q[:, i], lanes])
            f = sat(np.maximum(hprev[:, 1:] - (oi + ei), f - ei))
            hd = np.maximum(m, f)
            e = np.full((n, W), NEG, np.int32)
            pre = np.maximum.accumulate(hd + ramp, axis=1)
            e[:, 1:] = pre[:, :-1] - od - ramp[:, 1:]
            h = sat(np.maximum(hd, e))
            best = np.maximum(best, h.max(1))
            hprev = np.concatenate([np.full((n, 1), NEG, np.int32), h], 1)
        out[:, 2 * k] = best
        out[:, 2 * k + 1] = hprev[:, 1:].max(1)
    return out


def choice(raw: np.ndarray, clip5: int, clip3: int) -> np.ndarray:
    """The raw score of the kind BWA-MEM's clipping rule keeps, from
    best_scores' output."""
    bonus = np.array([s * clip5 + e * clip3 for s, e in KINDS], np.int64)
    key = (raw + bonus[None, :]) * 4096 + raw      # ties: higher raw
    return raw[np.arange(len(raw)), key.argmax(1)]


def local_only(raw: np.ndarray) -> np.ndarray:
    """The best local score (both ends free): the pick of a rule with no
    clipping penalty."""
    return raw[:, 0]
