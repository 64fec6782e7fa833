"""Peaks of the card and the least time of kernel #1's calls.

A frozen copy of chip_smoke.py's bound() arithmetic (numpy here), with the
band clamp of ksw.c:399-407 that the kernel applies in each lane.

Peaks (NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit;
a card set lower runs slower, so every reading names its power limit):
- HBM3 bandwidth 3.35 TB/s.
- int32: the data sheet gives 67 TFLOP/s of FP32 outside the tensor
  cores; an SM has 64 INT32 lanes beside its 128 FP32 lanes, so the int32
  rate is half of it, 33.5 T op/s.  (chip_smoke.py phase 1 measured
  32.32-33.08 T op/s of int32 mixes on a 700 W card.)
"""
from __future__ import annotations

import numpy as np

PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 33.5e12
OPS_PER_CELL = 16       # int32 operations of ksw's recurrence per DP cell
LANE_WORDS = 4 + 7      # ext_pl2_kernel: per-lane inputs read, outputs written


def clamp_band(w, qlen, end_bonus, max_mat: int, o_ins: int, e_ins: int,
               o_del: int, e_del: int) -> np.ndarray:
    """ksw_extend2's band clamp (ksw.c:399-407), per lane."""
    q = qlen.astype(np.float64)
    eb = end_bonus.astype(np.float64)
    max_ins = np.maximum(((q * max_mat + eb - o_ins) / e_ins + 1.0)
                         .astype(np.int64), 1)
    max_del = np.maximum(((q * max_mat + eb - o_del) / e_del + 1.0)
                         .astype(np.int64), 1)
    return np.minimum(np.minimum(np.asarray(w, np.int64), max_ins), max_del)


def band_cells(qlen, rows, w, t_max: int) -> int:
    """Cells of ksw's band: at each target row i < min(rows, t_max),
    max(0, min(qlen, i + w + 1) - max(0, i - w)) columns, summed in
    closed form per lane.  A row holds cells while i < qlen + w."""
    q = np.asarray(qlen, np.int64)
    w = np.broadcast_to(np.asarray(w, np.int64), q.shape)
    R = np.where(q > 0, np.minimum(np.minimum(np.asarray(rows, np.int64),
                                              t_max), q + w), 0)
    R = np.maximum(R, 0)
    a = np.clip(q - w, 0, R)           # rows whose band ends at i + w + 1
    first = a * (a - 1) // 2 + a * (w + 1) + (R - a) * q
    b = np.maximum(R - w - 1, 0)       # rows whose band starts at i - w
    return int((first - b * (b + 1) // 2).sum())


def bound_s(qlen, tlen, w1, w2, retried, t_max: int) -> tuple[float, str]:
    """Least seconds the card could take for one call's lanes, and what
    bounds it ("operations" or "bytes").  Bytes: the query and target rows
    of each nonempty lane read once and LANE_WORDS int32 a lane.  Cells: the
    band at w1 for every lane, again at w2 for the lanes that retry.  The
    window shrink and z-drop of ksw can leave fewer cells; they are not
    subtracted."""
    q = qlen.astype(np.int64)
    rows = np.clip(tlen.astype(np.int64), 0, t_max)
    live = (q > 0) & (rows > 0)
    nbytes = 4 * (int(np.where(live, q + rows, 0).sum())
                  + LANE_WORDS * len(q))
    rt = retried.astype(bool)
    cells = band_cells(q, rows, w1, t_max) + (
        band_cells(q[rt], rows[rt], np.asarray(w2)[rt], t_max)
        if rt.any() else 0)
    t_b = nbytes / PEAK_BYTES
    t_o = cells * OPS_PER_CELL / PEAK_INT32_OPS
    return max(t_b, t_o), ("operations" if t_o >= t_b else "bytes")
