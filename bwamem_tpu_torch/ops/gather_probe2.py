"""Round 2 of the gather probe: the hand-written CUDA kernels
(csrc/gather_probe2_kernel.cu) and their plain PyTorch versions.

The legacy `aln` search sends one batched occ lookup per round, most rounds
carrying few lanes.  This probe prices four more ways of making such a
lookup, each the function of one TPU probe kernel of the reference
package's tools/pl_gather_probe2.py:

  gp2_take_ax0    (probe_b, :75)   kk = (kk + tab[kk, j]) mod R, `steps`
                                   times; tab and kk int32 [R, 128]
  gp2_take_ax1    (probe_c, :98)   kk = (kk + tab[i, kk]) mod 128, `steps`
                                   times; tab and kk int32 [S, 128]
  gp2_col0        (probe_d, :122)  out[q] = tab[k[q], 0]; tab int32 [R, W],
                                   k int32 [N]: ops/col0's call of
                                   col0_kernel (csrc/col0.cuh)
  gp2_onehot_f32  (probe_e, :150)  out[q] = int(f32(onehot(k >> 7, A)) @
                                   f32(tab))[q, k & 127]); tab int32
                                   [A, 128], k and out int32 [N/128, 128];
                                   0 where k >> 7 is outside [0, A).  Each
                                   sum of that product is exact, so it is
                                   the gather int(f32(tab.flat[k])), and
                                   the kernel computes it so: one load a
                                   query, no product

gp2_take_ax0 and gp2_take_ax1 launch the kernels of csrc/line_pow.cuh,
which gp3_dg launches too: a step of line x (a column at axis 0, a row at
axis 1) is a fixed map of the state, T_x(k) = (k + tab[k, x]) mod R at
axis 0, (k + tab[x, k]) mod 128 at axis 1, with the wrap and the
remainder's sign inside it, so the kernel takes T_x once a launch and
computes the same function by the map's powers, taken by squaring (32
steps: five squarings and one lookup): at the probe's R = 512 a block a
column, the powers 16-bit in shared memory; at axis 1 (and R = 128) a
warp a row, the map in registers; at R up to 32 a segment of a warp a
column.

Preconditions the kernels do not check (a plain version raises on the
first two): kk in [0, R) for gp2_take_ax0 and in [0, 128) for
gp2_take_ax1, k in [0, R) for gp2_col0, and |tab| <= 2^31 - 129 for
gp2_onehot_f32, so that f32(tab) < 2^31 converts back to int32 (from 2^24
on float32 rounds, to nearest even, as the TPU kernel's astype does).
The adds of the chains wrap in int32 and the remainder is never negative
(jnp's %).

On a CUDA tensor each wrapper launches its kernel and counts the launch
(launches_*); on a CPU tensor it runs the plain version and counts nothing.
There is no fallback between the two: a failed build or launch raises.
The kernels are built and launched through ops/launch (nvcc for sm_90a at
first use, the caller's current stream).
"""
from __future__ import annotations

import ctypes

import torch

from bwamem_tpu_torch.ops import col0
from bwamem_tpu_torch.ops.gather_probe import _check, _wrap32
from bwamem_tpu_torch.ops.launch import Library

COLS = 128                  # columns of the chained and one-hot tables
SMEM_MAX = 232448           # bytes of shared memory a block may opt into

# (in, in, out, two ints): (R|S, steps) for the chains, (N, W|A) for the
# lookups
LIB = Library("gather_probe2_kernel.cu", {
    name: [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    for name in ("gp2_take_ax0", "gp2_take_ax1", "gp2_col0",
                 "gp2_onehot_f32")})
SRC = LIB.src

launches_take0 = 0      # kernel launches by gp2_take_ax0 (CUDA tensors)
launches_take1 = 0      # ... by gp2_take_ax1
launches_col0 = 0       # ... by gp2_col0
launches_onehot = 0     # ... by gp2_onehot_f32


# ---- plain versions ----

def _chain(tab: torch.Tensor, kk: torch.Tensor, steps: int,
           dim: int) -> torch.Tensor:
    """kk = (kk + tab.gather(dim, kk)) mod tab.shape[dim], `steps` times,
    in int64 with the int32 wrap spelled out, so it does not lean on what
    a backend does on overflow."""
    m = tab.shape[dim]
    k = kk.to(torch.int64)
    for _ in range(steps):
        k = torch.remainder(_wrap32(k + tab.gather(dim, k).to(torch.int64)),
                            m)
    return k.to(torch.int32)


def take_ax0_plain(tab: torch.Tensor, kk: torch.Tensor,
                   steps: int) -> torch.Tensor:
    return _chain(tab, kk, steps, 0)


def take_ax1_plain(tab: torch.Tensor, kk: torch.Tensor,
                   steps: int) -> torch.Tensor:
    return _chain(tab, kk, steps, 1)


def onehot_f32_plain(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The one-hot product's pick, written as the gather it equals: row
    k >> 7 of the float32 table (0 outside [0, A)), column k & 127,
    truncated to int32."""
    A = tab.shape[0]
    hi = k >> 7
    ok = (hi >= 0) & (hi < A)
    v = tab.to(torch.float32)[hi.clamp(0, A - 1).to(torch.int64),
                              (k & 127).to(torch.int64)]
    return torch.where(ok, v, 0).to(torch.int32)


# ---- kernels ----
# Each _prep_* checks a call's tensors (dtype, shape, contiguity, device)
# and returns the output tensor and the C entry's arguments; it raises
# ValueError on anything the kernel does not take.

def _prep_chain(name, tab, kk, steps):
    _check(name, tab, "tab", cols=COLS)
    _check(name, kk, "kk", cols=COLS, dev=tab.get_device())
    if kk.shape != tab.shape or tab.shape[0] < 1 or steps < 0:
        raise ValueError(f"{name}: kk {tuple(kk.shape)} for a table "
                         f"{tuple(tab.shape)}, steps {steps}")
    out = torch.empty_like(kk)
    return out, (tab.data_ptr(), kk.data_ptr(), out.data_ptr(),
                 tab.shape[0], int(steps))


def _prep_take0(tab, kk, steps):
    if tab.shape[0] * 4 > SMEM_MAX:
        raise ValueError(f"gp2_take_ax0: a column of {tab.shape[0]} rows "
                         f"does not fit in {SMEM_MAX} bytes of shared "
                         "memory")
    return _prep_chain("gp2_take_ax0", tab, kk, steps)


def _prep_take1(tab, kk, steps):
    return _prep_chain("gp2_take_ax1", tab, kk, steps)


def _prep_onehot(tab, k):
    _check("gp2_onehot_f32", tab, "tab", cols=COLS)
    _check("gp2_onehot_f32", k, "k", cols=COLS, dev=tab.get_device())
    if tab.shape[0] < 1:
        raise ValueError("gp2_onehot_f32: empty table")
    out = torch.empty_like(k)
    return out, (tab.data_ptr(), k.data_ptr(), out.data_ptr(), k.numel(),
                 tab.shape[0])


def _launch(name: str, out: torch.Tensor, args: tuple) -> torch.Tensor:
    LIB.launch(name, out.get_device(), args)
    return out


def gp2_take_ax0(tab: torch.Tensor, kk: torch.Tensor,
                 steps: int) -> torch.Tensor:
    """tab, kk int32 [R, 128], kk in [0, R) -> kk after `steps` chained
    steps kk = (kk + tab[kk, j]) mod R."""
    if not tab.is_cuda:
        return take_ax0_plain(tab, kk, steps)
    global launches_take0
    out = _launch("gp2_take_ax0", *_prep_take0(tab, kk, steps))
    launches_take0 += 1
    return out


def gp2_take_ax1(tab: torch.Tensor, kk: torch.Tensor,
                 steps: int) -> torch.Tensor:
    """tab, kk int32 [S, 128], kk in [0, 128) -> kk after `steps` chained
    steps kk = (kk + tab[i, kk]) mod 128."""
    if not tab.is_cuda:
        return take_ax1_plain(tab, kk, steps)
    global launches_take1
    out = _launch("gp2_take_ax1", *_prep_take1(tab, kk, steps))
    launches_take1 += 1
    return out


def gp2_col0(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """tab int32 [R, W], k int32 [N] in [0, R) -> tab[k, 0]."""
    if not tab.is_cuda:
        return col0.plain(tab, k)
    global launches_col0
    out = col0.launch(LIB, "gp2_col0", tab, k)
    launches_col0 += 1
    return out


def gp2_onehot_f32(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """tab int32 [A, 128], k int32 [N/128, 128] -> the float32 one-hot
    product's pick (see onehot_f32_plain), computed as the gather it is."""
    if not tab.is_cuda:
        return onehot_f32_plain(tab, k)
    global launches_onehot
    out = _launch("gp2_onehot_f32", *_prep_onehot(tab, k))
    launches_onehot += 1
    return out
