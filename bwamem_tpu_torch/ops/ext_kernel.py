"""Banded extension: the hand-written CUDA kernels (csrc/ext_kernel.cu)
and their plain PyTorch versions.

extend_batch_pl2 replaces the Pallas TPU kernel of the reference package,
bwamem_tpu/ops/pallas_ext.py extend_batch_pl2 (pallas_ext.py:316, kernel
body _kernel_retry at :229): ksw_extend2 at w_opt and an in-lane rerun at
2*w_opt (bwamem.c:732-741).  extend_batch_pl replaces extend_batch_pl
(pallas_ext.py:262, kernel body _kernel at :213): one pass at a per-lane
band, no retry (the long-read side path, pipeline/extend_host._ExtBatcher,
and bwasw rerun the lanes that need a wider band).  On a CUDA tensor each
launches its kernel, on a CPU tensor it runs its plain version; there is
no fallback between the two (a failed build or launch raises), and each
wrapper counts its own launches.

The kernels run a lane on a group of G threads (8, 16 or 32), a row's
cells in chunks of G columns with F as a shuffle scan, and keep the
lane's H and E in a ring of R columns (R a power of two of at least
2 w + 8, or lq_max + 1 slots when that is fewer) beside its query bytes:
in shared memory, 128 / G lanes a block, or, when a block's lanes do not
fit, lane-major in a global scratch the wrapper allocates.  `plan` sizes
all of it from lq_max and the widest band (2*w_opt for extend_batch_pl2,
max(w) for extend_batch_pl: one host read) at G = GROUP.  The band
clamp of ksw.c:399-407 runs in the lane, so the wrapper issues no torch
op for it.

What bounds the kernels on an H100: the DP cells of the data-dependent band
(about 16 int32 operations each, at the card's int32 rate), not bytes: a
batch reads the query and target rows of its nonempty lanes and each
per-lane value once (megabytes: microseconds at 3.35 TB/s).  What holds
them is each row's dependent chain (a chunk's load, scan and rotation, the
row's reductions) with too few warps a scheduler to hide it when a call
has only 1024-2048 lanes (csrc/ext_kernel.cu, PERF.md).

The kernels are built and launched through ops/launch (nvcc for sm_90a
at first use, the caller's current stream).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from bwamem_tpu_torch.ops import extend as extops
from bwamem_tpu_torch.ops.extend import ExtendResult
from bwamem_tpu_torch.ops.launch import Library

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = Library("ext_kernel.cu", {
    "ext_pl2_launch": [_vp] * 6 + [_ci] * 2 + [_vp] * 2 + [_ci] * 3 + [_vp]
                      + [_ci] * 9,
    "ext_pl_launch": [_vp] * 9 + [_ci] * 3 + [_vp] + [_ci] * 9},
    flags=["-Xptxas", "-v"])
SRC = LIB.src
# longest query of the fused two-pass route (extend_batch_pl2), and of one
# plain-extension dispatch at the narrow (h << 12) | col packing
LQ_MAX = 4095
THREADS = 128                  # a block (EXT_THREADS): 128 / G lanes
GROUPS = (8, 16, 32)           # threads a lane
# G of every call: 32.  Timed on each main path's widest call by
# chip_smoke.py (NVIDIA H100 80GB HBM3, 700 W), G = 8 / 16 / 32: 101 bp
# 0.4085 / 0.2933 / 0.2291 ms, 150 bp pairs 0.7579 / 0.5267 / 0.4380,
# 1000 bp 13.649 / 8.285 / 5.769, 5000 bp 36.90 / 19.73 / 11.48.  A
# smaller G packs more lanes in a warp but runs more chunks a row, and the
# rows' chain, not the number of lanes, holds the kernel.
GROUP = 32
# dynamic shared memory a block may take: the H100's 227 KB a block, less
# room for the block's matrix
SMEM_MAX = 232448 - 1024
STORAGE = ("shared", "global")

launches = 0        # kernel launches by extend_batch_pl2 (CUDA tensors)
launches_pl = 0     # kernel launches by extend_batch_pl (CUDA tensors)


class Plan(NamedTuple):
    """How a call runs: G threads a lane, a ring of R columns, `area`
    bytes a lane, `storage` "shared" or "global", `smem` bytes of dynamic
    shared memory a block (0 in the global mode)."""
    group: int
    R: int
    area: int
    storage: str
    smem: int


def _pow2(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def plan(lq_max: int, w_max: int, group: int | None = None,
         storage: str | None = None) -> Plan:
    """The ring, the lane area and the storage of a call whose lanes run
    at bands up to w_max.  R is the smaller of the power of two at least
    2 w_max + 8 (the span of columns read again is at most 2 w + 2) and
    the one at least lq_max + 1, where no column wraps and lq_max + 1
    slots are kept; the area holds those slots (8 bytes each) and lq_max
    query bytes, rounded to 16.  Shared memory when a block's lanes fit,
    else the global scratch; `group` and `storage` default to GROUP and
    that choice."""
    G = group or GROUP
    if G not in GROUPS:
        raise ValueError(f"group {G} is not one of {GROUPS}")
    R = min(_pow2(max(2 * w_max + 8, 8)), _pow2(lq_max + 1))
    area = -(-(8 * min(R, lq_max + 1) + lq_max) // 16) * 16
    smem = THREADS // G * area
    if storage is None:
        storage = "shared" if smem <= SMEM_MAX else "global"
    if storage not in STORAGE:
        raise ValueError(f"storage {storage!r} is not one of {STORAGE}")
    return Plan(G, R, area, storage, smem if storage == "shared" else 0)


def _mat25(mat_bytes: bytes) -> np.ndarray:
    return np.ascontiguousarray(
        np.frombuffer(mat_bytes, np.int8).astype(np.int32).reshape(25))


def _checked_lanes(name, queryT, qlen, targetT, tlen, h0, lq_max, t_max,
                   *lane_vectors):
    """Shape/device checks shared by the two wrappers; returns the int32
    contiguous (qT, tT, qlen, tlen, h0, *lane_vectors) the kernels read."""
    B = queryT.shape[1]
    if queryT.shape != (lq_max, B) or targetT.shape != (t_max, B):
        raise ValueError(f"{name}: queryT {tuple(queryT.shape)} "
                         f"targetT {tuple(targetT.shape)} for lq_max="
                         f"{lq_max} t_max={t_max} B={B}")
    i32 = torch.int32
    out = [x.to(i32).contiguous() for x in (queryT, targetT, qlen, tlen, h0,
                                            *lane_vectors)]
    index = queryT.get_device()
    for x in out:
        if x.get_device() != index:
            raise ValueError(f"{name}: tensors on different devices")
    for x in out[2:]:
        if x.shape != (B,):
            raise ValueError(f"{name}: per-lane vector of shape "
                             f"{tuple(x.shape)} for B={B}")
    return out


def _scratch(p: Plan, B: int, dev) -> tuple[torch.Tensor | None, int]:
    """The global scratch of the global mode (B lane areas) and its
    address; nothing in the shared mode."""
    if p.storage == "shared":
        return None, 0
    s = torch.empty((B, p.area), dtype=torch.uint8, device=dev)
    return s, s.data_ptr()


def extend_batch_pl2(queryT, qlen, targetT, tlen, h0, end_bonus, *,
                     lq_max, t_max, mat_bytes, o_del, e_del, o_ins, e_ins,
                     zdrop, w_opt):
    """ksw_extend2 over B lanes with the band-doubling retry: pass 1 at
    w_opt, rerun at 2*w_opt for lanes whose pass-1 max_off crossed
    (w>>1)+(w>>2) with a changed score (bwamem.c:732-741).

    queryT: [lq_max, B] int32 nt4 (already reversed for left extensions,
    every qlen <= lq_max); targetT: [t_max, B] int32; per-lane vectors [B].
    Returns (ExtendResult, retried [B] int32)."""
    kw = dict(lq_max=lq_max, t_max=t_max, mat_bytes=mat_bytes, o_del=o_del,
              e_del=e_del, o_ins=o_ins, e_ins=e_ins, zdrop=zdrop)
    if not queryT.is_cuda:
        return extend_batch_pl2_plain(queryT, qlen, targetT, tlen, h0,
                                      end_bonus, w_opt=w_opt, **kw)
    if lq_max > LQ_MAX:
        # the bound of the fused two-pass route, as the reference routes
        # its lanes
        raise ValueError(f"extend_batch_pl2: lq_max {lq_max} > {LQ_MAX}")
    return launch_pl2(queryT, qlen, targetT, tlen, h0, end_bonus,
                      plan(lq_max, 2 * w_opt), w_opt=w_opt, **kw)


def launch_pl2(queryT, qlen, targetT, tlen, h0, end_bonus, p: Plan, *,
               lq_max, t_max, mat_bytes, o_del, e_del, o_ins, e_ins, zdrop,
               w_opt):
    """ext_pl2_kernel on CUDA tensors as `p` plans it (extend_batch_pl2's
    launch; chip_smoke.py times each G through it)."""
    global launches
    B = queryT.shape[1]
    dev = queryT.device
    qT, tT, ql, tl, hh, eb = _checked_lanes(
        "extend_batch_pl2", queryT, qlen, targetT, tlen, h0, lq_max, t_max,
        end_bonus)
    scratch, sp = _scratch(p, B, dev)   # held until the launch is issued
    out = torch.empty((7, B), dtype=torch.int32, device=dev)
    mat = _mat25(mat_bytes)
    LIB.launch("ext_pl2_launch", qT.get_device(), (
        qT.data_ptr(), tT.data_ptr(), ql.data_ptr(), tl.data_ptr(),
        hh.data_ptr(), eb.data_ptr(), int(w_opt),
        (w_opt >> 1) + (w_opt >> 2), sp, out.data_ptr(), int(B),
        int(lq_max), int(t_max), mat.ctypes.data, int(o_del), int(e_del),
        int(o_ins), int(e_ins), int(zdrop), p.group, p.R, p.area,
        STORAGE.index(p.storage)), "ext_pl2_kernel")
    launches += 1
    return (ExtendResult(score=out[0], qle=out[1], tle=out[2], gtle=out[3],
                         gscore=out[4], max_off=out[5]), out[6])


def extend_batch_pl2_plain(queryT, qlen, targetT, tlen, h0, end_bonus, *,
                           lq_max, t_max, mat_bytes, o_del, e_del, o_ins,
                           e_ins, zdrop, w_opt):
    """The plain version of extend_batch_pl2: ops/extend.extend_batch at
    w_opt, then at 2*w_opt over the lanes that retry, with the
    band-doubling retry select (the XLA branch of the reference package's
    device_front._ext_kernel)."""
    i32 = torch.int32
    B = qlen.shape[0]
    mat = np.frombuffer(mat_bytes, np.int8).reshape(5, 5)
    query = queryT.T.to(torch.uint8)
    qlen = qlen.to(i32)

    def target_at(i):
        return targetT[min(i, t_max - 1)]

    kw = dict(mat=mat, o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              zdrop=zdrop, t_max=t_max)
    w1 = torch.full((B,), w_opt, dtype=i32, device=qlen.device)
    r1 = extops.extend_batch(query, qlen, target_at, tlen, h0, w1,
                             end_bonus, **kw)
    retry = ((r1.max_off >= ((w_opt >> 1) + (w_opt >> 2)))
             & (r1.score != h0) & (qlen > 0))
    # lanes are independent: the second pass runs over the retrying lanes
    # only (one host read of the mask)
    idx = torch.nonzero(retry)[:, 0]
    if idx.numel() == 0:
        return r1, retry.to(i32)
    sub_t = targetT[:, idx]
    r2 = extops.extend_batch(
        query[idx], qlen[idx], lambda i: sub_t[min(i, t_max - 1)],
        tlen[idx], h0[idx], torch.full_like(idx, 2 * w_opt, dtype=i32),
        end_bonus[idx], **kw)
    res = ExtendResult(*(a.index_copy(0, idx, b.to(a.dtype))
                         for a, b in zip(r1, r2)))
    return res, retry.to(i32)


def extend_batch_pl(queryT, qlen, targetT, tlen, h0, w, end_bonus, *,
                    lq_max, t_max, mat_bytes, o_del, e_del, o_ins, e_ins,
                    zdrop):
    """One ksw_extend2 pass over B lanes at the per-lane band `w` (clamped
    per lane as ksw.c:399-407 does), no retry.

    queryT: [lq_max, B] int32 nt4 (already reversed for left extensions,
    every qlen <= lq_max; any lq_max: the lane packs nothing and scores are
    plain int32); targetT: [t_max, B] int32; per-lane vectors [B].  The
    ring is sized from max(w) (one host read), which bounds the clamped
    band of every lane.  Returns ExtendResult."""
    kw = dict(lq_max=lq_max, t_max=t_max, mat_bytes=mat_bytes, o_del=o_del,
              e_del=e_del, o_ins=o_ins, e_ins=e_ins, zdrop=zdrop)
    if not queryT.is_cuda:
        return extend_batch_pl_plain(queryT, qlen, targetT, tlen, h0, w,
                                     end_bonus, **kw)
    w_max = int(w.max()) if w.numel() else 0
    return launch_pl(queryT, qlen, targetT, tlen, h0, w, end_bonus,
                     plan(lq_max, w_max), **kw)


def launch_pl(queryT, qlen, targetT, tlen, h0, w, end_bonus, p: Plan, *,
              lq_max, t_max, mat_bytes, o_del, e_del, o_ins, e_ins, zdrop):
    """ext_pl_kernel on CUDA tensors as `p` plans it (extend_batch_pl's
    launch; chip_smoke.py times each G through it)."""
    global launches_pl
    B = queryT.shape[1]
    dev = queryT.device
    qT, tT, ql, tl, hh, wv, eb = _checked_lanes(
        "extend_batch_pl", queryT, qlen, targetT, tlen, h0, lq_max, t_max,
        w, end_bonus)
    scratch, sp = _scratch(p, B, dev)   # held until the launch is issued
    out = torch.empty((6, B), dtype=torch.int32, device=dev)
    mat = _mat25(mat_bytes)
    LIB.launch("ext_pl_launch", qT.get_device(), (
        qT.data_ptr(), tT.data_ptr(), ql.data_ptr(), tl.data_ptr(),
        hh.data_ptr(), wv.data_ptr(), eb.data_ptr(), sp, out.data_ptr(),
        int(B), int(lq_max), int(t_max), mat.ctypes.data, int(o_del),
        int(e_del), int(o_ins), int(e_ins), int(zdrop), p.group, p.R,
        p.area, STORAGE.index(p.storage)), "ext_pl_kernel")
    launches_pl += 1
    return ExtendResult(score=out[0], qle=out[1], tle=out[2], gtle=out[3],
                        gscore=out[4], max_off=out[5])


def extend_batch_pl_plain(queryT, qlen, targetT, tlen, h0, w, end_bonus, *,
                          lq_max, t_max, mat_bytes, o_del, e_del, o_ins,
                          e_ins, zdrop):
    """The plain version of extend_batch_pl: one call of
    ops/extend.extend_batch at the per-lane band."""

    def target_at(i):
        return targetT[min(i, t_max - 1)]

    return extops.extend_batch(
        queryT.T.to(torch.uint8), qlen.to(torch.int32), target_at, tlen, h0,
        w, end_bonus, np.frombuffer(mat_bytes, np.int8).reshape(5, 5),
        o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins, zdrop=zdrop,
        t_max=t_max)
