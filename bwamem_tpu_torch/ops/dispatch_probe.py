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
price the port's own issue path: _prep (the checks, the plan and the
output's allocation) and _launch (ops/launch's stream lookup, device check
and ctypes call, counted).

What bounds it on an H100: int32 operations (OPS_PER_CELL a cell, at the
rate chip_smoke.py phase 1 measures, PEAK_INT32_OPS) from ROWS 128 up,
bytes and the launch below.  The kernel (csrc/rows.cuh) gives a thread
RPT rows of LPT adjacent lanes, its cells in registers and one tT word a
step for all of them, a block a tile of lanes by row groups staging tT in
shared memory; bits 16 packs two rows a word and adds two cells a DPX
instruction.  plan() picks the shipped plan (PLAN, or PLAN_SHORT for a
short run); a caller may pass another (tools/torch_row_variants.py and
the tests run every one).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bwamem_tpu_torch.ops.launch import Library

OPS_PER_CELL = 4    # compare, select, add, max
# (qT, tT, out, L1p, rows, B, rpt, lpt, bits, threads a block, lane groups
# a block)
LIB = Library("dispatch_probe_kernel.cu",
              {"dp_eh": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8},
              flags=["-Xptxas", "-v"])
SRC = LIB.src
RPTS, LPTS, BITS = (1, 2, 4, 8, 16), (1, 4), (32, 16)
ROWS_MAX_16 = 32767 - 16    # eh <= 16 + ROWS must fit in int16


class Plan(NamedTuple):
    rpt: int        # rows a thread
    lpt: int        # adjacent lanes a thread (4: 16-byte loads)
    bits: int       # 32, or 16: two rows a word
    threads: int    # threads a block
    lgb: int        # lane groups a block (threads / lgb row groups)


# The shipped plans, chosen by tools/torch_row_variants.py on the card
# (PERF.md §6): a tile of 16 lanes by 8 row groups of 4 rows staging
# tT, and for a run of at most SHORT_ROWS target rows, where the launch is
# most of the time and a tile's staging only adds to it, a thread a row of
# 4 lanes.
PLAN = Plan(rpt=4, lpt=1, bits=32, threads=128, lgb=16)
PLAN_SHORT = Plan(rpt=1, lpt=4, bits=32, threads=128, lgb=128)
SHORT_ROWS = 32

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


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def plan(L1p: int, rows: int, B: int, aligned: bool = True) -> Plan:
    """The shipped plan at this shape: PLAN, or PLAN_SHORT up to SHORT_ROWS
    target rows, with one lane a thread where B % 4 != 0 or a table is not
    16-byte aligned, and 32 bits past ROWS_MAX_16 rows."""
    p = PLAN_SHORT if rows <= SHORT_ROWS else PLAN
    if p.lpt == 4 and (B % 4 or not aligned):
        p = p._replace(lpt=1)
    if p.bits == 16 and rows > ROWS_MAX_16:
        p = p._replace(bits=32)
    return p


def check_plan(p: Plan, rows: int, B: int, aligned: bool = True,
               name: str = "dp_eh") -> None:
    """ValueError unless the kernel takes plan p at this shape (csrc/
    rows.cuh, rows_launch; also plp_row's eh_only, as `name`)."""
    if p.rpt not in RPTS or p.lpt not in LPTS or p.bits not in BITS \
            or not 32 <= p.threads <= 512 or (p.bits == 16 and p.rpt < 2) \
            or p.lgb < 1 or p.threads % p.lgb \
            or (p.lgb < p.threads and 32 * p.lgb * p.lpt > 8 * p.threads):
        raise ValueError(f"{name}: plan {p} is not one of rpt {RPTS} (even "
                         f"for 16 bits), lpt {LPTS}, bits {BITS}, 32 to "
                         f"512 threads, lane groups a block dividing them "
                         f"(a tile's 32 steps at most 8 words a thread)")
    if p.lpt == 4 and (B % 4 or not aligned):
        raise ValueError(f"{name}: plan {p} needs B % 4 == 0 and 16-byte "
                         f"aligned tables (B {B})")
    if p.bits == 16 and rows > ROWS_MAX_16:
        raise ValueError(f"{name}: plan {p}: eh reaches 16 + {rows}, past "
                         f"int16")


def _prep(qT, tT, p: Plan | None = None):
    """Checks a call's tensors and plan (ValueError on anything the kernel
    does not take) and returns the output tensor and the C entry's
    arguments; p None takes plan()."""
    check_tables("dp_eh", qT, tT)
    out = torch.empty_like(qT)
    (L1p, B), rows = qT.shape, tT.shape[0]
    aligned = _aligned(qT, tT, out)
    if p is None:
        p = plan(L1p, rows, B, aligned)
    check_plan(p, rows, B, aligned)
    return out, (qT.data_ptr(), tT.data_ptr(), out.data_ptr(), L1p, rows,
                 B, *p)


def _launch(out: torch.Tensor, args: tuple) -> torch.Tensor:
    global launches
    LIB.launch("dp_eh", out.get_device(), args)
    launches += 1
    return out


def dp_eh(qT: torch.Tensor, tT: torch.Tensor,
          p: Plan | None = None) -> torch.Tensor:
    """qT int32 [L1p, B], tT int32 [ROWS, B] -> int32 [L1p, B] (see
    dp_eh_plain), by the kernel at plan p (None: plan()) on a CUDA
    tensor."""
    if not qT.is_cuda:
        return dp_eh_plain(qT, tT)
    return _launch(*_prep(qT, tT, p))
