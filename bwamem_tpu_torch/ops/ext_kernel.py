"""Banded extension: the hand-written CUDA kernels (csrc/ext_kernel.cu)
and their plain PyTorch versions.

extend_batch_pl2 replaces the Pallas TPU kernel of the reference package,
bwamem_tpu/ops/pallas_ext.py extend_batch_pl2 (pallas_ext.py:316, kernel
body _kernel_retry at :229).  On a CUDA tensor it launches the kernel (one
thread per lane running the scalar ksw_extend2 row loop, pass 1 at w_opt
and an in-lane rerun at 2*w_opt, bwamem.c:732-741); on a CPU tensor it runs
extend_batch_pl2_plain.

extend_batch_pl replaces extend_batch_pl (pallas_ext.py:262, kernel body
_kernel at :213): one pass at a per-lane band, no retry — the long-read
side path (pipeline/extend_host._ExtBatcher) reruns the lanes that
need the doubled band.  Same lane loop, same split: the kernel on a CUDA
tensor, extend_batch_pl_plain on a CPU tensor.

There is no fallback between a kernel and its plain version: a failed
build or launch raises.  Each wrapper counts its own launches.

What bounds the kernels on an H100: the DP cells of the data-dependent band
(about 16 int32 operations each, at the card's int32 rate), not bytes — a
batch reads the query and target rows of its nonempty lanes and each
per-lane value once (megabytes: microseconds at 3.35 TB/s).  In
practice the thread-serial band and the imbalance between the lanes of a
warp (different target lengths and z-drop exits) set the time.

The kernels are built and launched through ops/launch (nvcc for sm_90a
at first use, the caller's current stream).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from bwamem_tpu_torch.ops import extend as extops
from bwamem_tpu_torch.ops.extend import ExtendResult, _adjust_w
from bwamem_tpu_torch.ops.launch import Library

_vp, _ci = ctypes.c_void_p, ctypes.c_int
LIB = Library("ext_kernel.cu", {
    "ext_pl2_launch": [_vp] * 7 + [_ci] + [_vp] * 2 + [_ci] * 3 + [_vp]
                      + [_ci] * 5,
    "ext_pl_launch": [_vp] * 8 + [_ci] * 3 + [_vp] + [_ci] * 5})
SRC = LIB.src
# longest query of the fused two-pass route (extend_batch_pl2), and of one
# plain-extension dispatch at the narrow (h << 12) | col packing
LQ_MAX = 4095

launches = 0        # kernel launches by extend_batch_pl2 (CUDA tensors)
launches_pl = 0     # kernel launches by extend_batch_pl (CUDA tensors)


def _mat25(mat_bytes: bytes) -> np.ndarray:
    return np.frombuffer(mat_bytes, np.int8).astype(np.int32).reshape(25)


def _bands(qlen, end_bonus, *, mat_bytes, o_del, e_del, o_ins, e_ins,
           w_opt):
    """Per-lane clamped bands for both passes and the retry threshold."""
    max_mat = int(_mat25(mat_bytes).max())
    w1 = torch.full_like(qlen, w_opt)
    w2 = torch.full_like(qlen, 2 * w_opt)
    kw = (max_mat, end_bonus, o_ins, e_ins, o_del, e_del)
    return (_adjust_w(w1, qlen, *kw).to(torch.int32),
            _adjust_w(w2, qlen, *kw).to(torch.int32),
            (w_opt >> 1) + (w_opt >> 2))


def _checked_lanes(name, queryT, qlen, targetT, tlen, h0, lq_max, t_max):
    """Shape/device checks shared by the two wrappers; returns the int32
    contiguous (qT, tT, qlen, tlen, h0) the kernels read."""
    B = queryT.shape[1]
    if queryT.shape != (lq_max, B) or targetT.shape != (t_max, B):
        raise ValueError(f"{name}: queryT {tuple(queryT.shape)} "
                         f"targetT {tuple(targetT.shape)} for lq_max="
                         f"{lq_max} t_max={t_max} B={B}")
    i32 = torch.int32
    out = [x.to(i32).contiguous() for x in (queryT, targetT, qlen, tlen, h0)]
    index = queryT.get_device()
    for x in out:
        if x.get_device() != index:
            raise ValueError(f"{name}: tensors on different devices")
    for x in out[2:]:
        if x.shape != (B,):
            raise ValueError(f"{name}: per-lane vector of shape "
                             f"{tuple(x.shape)} for B={B}")
    return out


def extend_batch_pl2(queryT, qlen, targetT, tlen, h0, end_bonus, *,
                     lq_max, t_max, mat_bytes, o_del, e_del, o_ins, e_ins,
                     zdrop, w_opt):
    """ksw_extend2 over B lanes with the band-doubling retry: pass 1 at
    w_opt, rerun at 2*w_opt for lanes whose pass-1 max_off crossed
    (w>>1)+(w>>2) with a changed score (bwamem.c:732-741).

    queryT: [lq_max, B] int32 nt4 (already reversed for left extensions,
    every qlen <= lq_max); targetT: [t_max, B] int32; per-lane vectors [B].
    Returns (ExtendResult, retried [B] int32)."""
    if not queryT.is_cuda:
        return extend_batch_pl2_plain(
            queryT, qlen, targetT, tlen, h0, end_bonus, lq_max=lq_max,
            t_max=t_max, mat_bytes=mat_bytes, o_del=o_del, e_del=e_del,
            o_ins=o_ins, e_ins=e_ins, zdrop=zdrop, w_opt=w_opt)
    global launches
    if lq_max > LQ_MAX:
        # the bound of the fused two-pass route, as the reference routes
        # its lanes
        raise ValueError(f"extend_batch_pl2: lq_max {lq_max} > {LQ_MAX}")
    B = queryT.shape[1]
    dev = queryT.device
    i32 = torch.int32
    qT, tT, ql, tl, hh = _checked_lanes("extend_batch_pl2", queryT, qlen,
                                        targetT, tlen, h0, lq_max, t_max)
    w1, w2, thr = _bands(ql, end_bonus.to(i32), mat_bytes=mat_bytes,
                         o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                         w_opt=w_opt)
    eh = torch.empty((2, lq_max + 1, B), dtype=i32, device=dev)
    out = torch.empty((7, B), dtype=i32, device=dev)
    mat = np.ascontiguousarray(_mat25(mat_bytes))
    LIB.launch("ext_pl2_launch", qT.get_device(), (
        qT.data_ptr(), tT.data_ptr(), ql.data_ptr(), tl.data_ptr(),
        hh.data_ptr(), w1.data_ptr(), w2.data_ptr(), int(thr),
        eh.data_ptr(), out.data_ptr(), int(B), int(lq_max), int(t_max),
        mat.ctypes.data, int(o_del), int(e_del), int(o_ins),
        int(e_ins), int(zdrop)), "ext_pl2_kernel")
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
    every qlen <= lq_max; any lq_max: the scalar lane loop packs nothing,
    scores are plain int32, and the eh scratch is sized from lq_max);
    targetT: [t_max, B] int32; per-lane vectors [B].  Returns
    ExtendResult."""
    kw = dict(lq_max=lq_max, t_max=t_max, mat_bytes=mat_bytes, o_del=o_del,
              e_del=e_del, o_ins=o_ins, e_ins=e_ins, zdrop=zdrop)
    if not queryT.is_cuda:
        return extend_batch_pl_plain(queryT, qlen, targetT, tlen, h0, w,
                                     end_bonus, **kw)
    global launches_pl
    B = queryT.shape[1]
    dev = queryT.device
    i32 = torch.int32
    qT, tT, ql, tl, hh = _checked_lanes("extend_batch_pl", queryT, qlen,
                                        targetT, tlen, h0, lq_max, t_max)
    mat = np.ascontiguousarray(_mat25(mat_bytes))
    wadj = _adjust_w(w.to(i32), ql, int(mat.max()), end_bonus.to(i32), o_ins,
                     e_ins, o_del, e_del).to(i32).contiguous()
    if wadj.shape != (B,) or wadj.get_device() != qT.get_device():
        raise ValueError("extend_batch_pl: band vector does not match the "
                         "lanes")
    eh = torch.empty((2, lq_max + 1, B), dtype=i32, device=dev)
    out = torch.empty((6, B), dtype=i32, device=dev)
    LIB.launch("ext_pl_launch", qT.get_device(), (
        qT.data_ptr(), tT.data_ptr(), ql.data_ptr(), tl.data_ptr(),
        hh.data_ptr(), wadj.data_ptr(), eh.data_ptr(), out.data_ptr(),
        int(B), int(lq_max), int(t_max), mat.ctypes.data, int(o_del),
        int(e_del), int(o_ins), int(e_ins), int(zdrop)), "ext_pl_kernel")
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
