"""The card's int32 rate: the measuring kernel (csrc/int_rate_kernel.cu)
and its plain PyTorch version.

No TPU kernel is replaced here.  The rate measured with it is the peak
that every bound by int32 operations divides by (chip_smoke.PEAK_INT32_OPS,
which tools/torch_dispatch_probe.bound reads).  Each thread runs CHAINS
independent register chains through `iters` iterations of UNROLL steps of
one mix (see the source) and stores the XOR of its chains:

  alu       u = u + v + C, v = max(v, u) on pairs of chains (IADD3, IMNMX)
  cell      dp_eh's cell written plainly: x = max(x + (x == q ? 1 : -4), 0)
  cell_dpx  the same cell with __viaddmax_s32
  s16x2     x = __viaddmax_s16x2_relu(x, y, z): two 16-bit cells a step
  dpx32     x = __viaddmax_s32(x, y, z): the 32-bit DPX instruction alone

OPS_PER_STEP counts each mix's operations a chain a step as its function
does them (a DPX instruction counts its add and its max).  On a CUDA
tensor run() launches the kernel and counts the launch in `launches`; on
the CPU there is only the plain version (the CPU tests also build the
lane loop as host C++).  The kernel is built and launched through
ops/launch (nvcc for sm_90a at first use, the caller's current stream).
"""
from __future__ import annotations

import ctypes

import torch

from bwamem_tpu_torch.ops.launch import Library

MIXES = ("alu", "cell", "cell_dpx", "s16x2", "dpx32")
CHAINS, UNROLL = 8, 16          # IR_CHAINS, IR_UNROLL of the source
OPS_PER_STEP = {"alu": 1.5, "cell": 4, "cell_dpx": 4, "s16x2": 4,
                "dpx32": 2}
THREADS = 256                   # threads a block
# (out, blocks, threads, iters, seed, mix)
LIB = Library("int_rate_kernel.cu",
              {"int_rate": [ctypes.c_void_p] + [ctypes.c_int] * 5},
              flags=["-Xptxas", "-v"])
SRC = LIB.src

launches = 0        # kernel launches by run (CUDA tensors)


def ops_per_thread(mix: str, iters: int) -> float:
    """Operations one thread does in `iters` iterations of a mix."""
    return OPS_PER_STEP[mix] * CHAINS * UNROLL * iters


def run(mix: str, blocks: int, iters: int, seed: int = 0,
        device="cuda") -> torch.Tensor:
    """int32 [blocks * THREADS]: each thread's word after `iters`
    iterations of the mix, by the kernel on a CUDA device and by the
    plain version on the CPU."""
    if mix not in MIXES or blocks < 1 or iters < 0:
        raise ValueError(f"int_rate: mix {mix!r}, blocks {blocks}, iters "
                         f"{iters}: need one of {MIXES}, blocks >= 1, "
                         f"iters >= 0")
    device = torch.device(device)
    if device.type != "cuda":
        return plain(mix, blocks * THREADS, iters, seed)
    global launches
    out = torch.empty(blocks * THREADS, dtype=torch.int32, device=device)
    LIB.launch("int_rate", out.get_device(),
               (out.data_ptr(), blocks, THREADS, iters, seed,
                MIXES.index(mix)), f"int_rate ({mix})")
    launches += 1
    return out


def _w32(x: torch.Tensor) -> torch.Tensor:
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _w16(x: torch.Tensor) -> torch.Tensor:
    return (x + (1 << 15)) % (1 << 16) - (1 << 15)


def _addmax16x2_relu(a, b, c):
    """__viaddmax_s16x2_relu on int64 tensors holding 32-bit words."""
    out = torch.zeros_like(a)
    for sh in (0, 16):
        half = [_w16((v >> sh) & 0xffff) for v in (a, b, c)]
        s = torch.maximum(torch.maximum(_w16(half[0] + half[1]), half[2]),
                          torch.zeros_like(a))
        out |= (s & 0xffff) << sh
    return _w32(out)


def plain(mix: str, n: int, iters: int, seed: int = 0,
          device="cpu") -> torch.Tensor:
    """The chains of threads 0 .. n - 1, written as the source writes them,
    in int64 with each sum wrapped to 32 (or, for s16x2, 16) bits."""
    tid = torch.arange(n, dtype=torch.int64, device=device)
    s0 = (seed % (1 << 32)) * 2654435761 + tid * 40503

    def draw(k, salt):
        return (s0 + k * 977 + salt) % (1 << 32) & 0x3fff
    x = [draw(k, 0) for k in range(CHAINS)]
    q = [draw(k, 1) & 31 for k in range(CHAINS)]
    y = [draw(k, 2) - 0x2000 for k in range(CHAINS)]
    z = [draw(k, 3) - 0x2000 for k in range(CHAINS)]
    if mix == "s16x2":
        x = [_w32(x[k] | (q[k] << 16)) for k in range(CHAINS)]
        y, z = ([_w32((a & 0xffff) | ((b % (1 << 32)) << 16) % (1 << 32))
                 for a, b in zip(y, z)],
                [_w32((b & 0xffff) | ((a % (1 << 32)) << 16) % (1 << 32))
                 for a, b in zip(y, z)])
    zero = torch.zeros_like(tid)
    for _ in range(iters * UNROLL):
        if mix == "alu":
            for k in range(0, CHAINS, 2):
                x[k] = _w32(x[k] + x[k + 1] + y[k])
                x[k + 1] = torch.maximum(x[k + 1], x[k])
        elif mix == "s16x2":
            x = [_addmax16x2_relu(x[k], y[k], z[k]) for k in range(CHAINS)]
        elif mix == "dpx32":
            x = [torch.maximum(_w32(x[k] + y[k]), z[k]) for k in range(CHAINS)]
        else:
            x = [torch.maximum(_w32(x[k] + torch.where(x[k] == q[k], 1, -4)),
                               zero) for k in range(CHAINS)]
    acc = zero
    for v in x:
        acc = acc ^ v
    return _w32(acc).to(torch.int32)
