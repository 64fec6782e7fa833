"""The dispatch probe's kernel: the hand-written CUDA kernel
(csrc/dispatch_probe_kernel.cu) and its plain PyTorch version.

It is the function of the TPU probe kernel of the reference package's
tools/dispatch_probe.py (make_kernel(L1p, ROWS, B).kernel, :32), which
that script uses to price a call, a queue of calls and the copies:

  dp_eh   out[r, b] = eh after ROWS steps of
          eh = max(eh + (qT[r, b] == tT[i, b] ? 1 : -4), 0), from
          eh = r * 3 % 17; qT int32 [L1p, B], tT int32 [ROWS, B], out
          int32 [L1p, B]

The adds cannot overflow (eh stays in [0, 16 + ROWS]).  On a CUDA tensor
the wrapper launches the kernel and counts the launch (`launches`); on a
CPU tensor it runs the plain version and counts nothing.  There is no
fallback between the two: a failed build or launch raises.  The kernel is
built and launched through ops/launch (nvcc for sm_90a at first use, the
caller's current stream).  A call is split in two so that the probe can
price the port's own issue path: _prep (the checks and the output's
allocation) and _launch (ops/launch's stream lookup, device check and
ctypes call, counted).
"""
from __future__ import annotations

import ctypes

import torch

from bwamem_tpu_torch.ops.launch import Library

OPS_PER_CELL = 4    # compare, select, add, max
# (qT, tT, out, L1p, rows, B)
LIB = Library("dispatch_probe_kernel.cu",
              {"dp_eh": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3})
SRC = LIB.src

launches = 0        # kernel launches by dp_eh (CUDA tensors)


def work(L1p: int, rows: int, B: int) -> tuple[int, int]:
    """(bytes, int32 operations) of one call's function: qT, tT and out
    moved once, OPS_PER_CELL a cell of L1p x B x rows."""
    return 4 * (2 * L1p * B + rows * B), OPS_PER_CELL * L1p * B * rows


def dp_eh_plain(qT: torch.Tensor, tT: torch.Tensor) -> torch.Tensor:
    check_tables("dp_eh", qT, tT)
    L1p, B = qT.shape
    one = torch.ones((), dtype=torch.int32, device=qT.device)
    eh = (torch.arange(L1p, dtype=torch.int32, device=qT.device) * 3
          % 17)[:, None].expand(L1p, B)
    for i in range(tT.shape[0]):
        eh = (eh + torch.where(qT == tT[i], one, -4 * one)).clamp_min(0)
    return eh.contiguous()


def check_tables(name: str, qT: torch.Tensor, tT: torch.Tensor) -> None:
    """ValueError unless qT and tT are contiguous int32 2-d tensors on one
    device with the same lanes (columns), one row and one lane at least;
    also used by ops/pl_probe."""
    index = qT.get_device()
    for what, t in (("qT", qT), ("tT", tT)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous() \
                or t.get_device() != index:
            raise ValueError(f"{name}: {what} must be contiguous int32 2-d "
                             f"on {qT.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if tT.shape[1] != qT.shape[1] or min(*qT.shape, tT.shape[0]) < 1:
        raise ValueError(f"{name}: qT {tuple(qT.shape)} and tT "
                         f"{tuple(tT.shape)} need the same lanes, at least "
                         f"one row each and one lane")


def _prep(qT, tT):
    """Checks a call's tensors (ValueError on anything the kernel does not
    take) and returns the output tensor and the C entry's arguments."""
    check_tables("dp_eh", qT, tT)
    out = torch.empty_like(qT)
    return out, (qT.data_ptr(), tT.data_ptr(), out.data_ptr(), qT.shape[0],
                 tT.shape[0], qT.shape[1])


def _launch(out: torch.Tensor, args: tuple) -> torch.Tensor:
    global launches
    LIB.launch("dp_eh", out.get_device(), args)
    launches += 1
    return out


def dp_eh(qT: torch.Tensor, tT: torch.Tensor) -> torch.Tensor:
    """qT int32 [L1p, B], tT int32 [ROWS, B] -> int32 [L1p, B] (see
    dp_eh_plain)."""
    if not qT.is_cuda:
        return dp_eh_plain(qT, tT)
    return _launch(*_prep(qT, tT))
