"""The gather-strategy probe: the hand-written CUDA kernels
(csrc/gather_probe_kernel.cu) and their plain PyTorch versions.

An in-kernel FM scan needs one table lookup per lane and step.  This probe
prices four ways of making it, each the function of one TPU probe kernel of
the reference package's tools/pl_gather_probe.py:

  gp_scalar    (kernel_scalar, :65)  out[i, j] = tab[k[i, j], j]
  gp_scalar2   (kernel_scalarw, :93) out = tab[k, 0] + tab[k, 1], wrapping
                                     int32
  gp_onehot    (kernel_mm, :120)     out = int(bf16(tab3[k >> 7, k & 127])),
                                     0 where k >> 7 is outside [0, A), by a
                                     one-hot product on the tensor cores
  gp_take_ax0  (kernel_dg, :151)     kk = (kk + tab[kk, j]) mod R, `steps`
                                     times, over a table-shaped kk [R, 128]

k is int32 [N/128, 128] (N lanes, lane q at row q // 128, column q % 128);
every table is int32.  gp_scalar and gp_scalar2 repeat their pass `steps`
times, as the TPU kernels do (the output does not depend on it; steps >= 1).
Preconditions the kernels do not check (a plain version raises on the
first): k in [0, R) for gp_scalar and gp_scalar2, kk in [0, R) for
gp_take_ax0, and |tab3| < 2^24 for gp_onehot — there int32 -> float ->
bf16 rounds as XLA does, and the bf16 value converts back to int32.

On a CUDA tensor each wrapper launches its kernel and counts the launch
(launches_*); on a CPU tensor it runs the plain version and counts nothing.
There is no fallback between the two: a failed build or launch raises.
The kernels are compiled with nvcc for sm_90a into the repository's build/
directory at first use and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import os
import threading

import torch

from bwamem_tpu_torch.ops.ext_kernel import NVCC_FLAGS, nvcc

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "gather_probe_kernel.cu")
COLS = 128                  # columns of k, tab and tab3; lanes per k row

launches_scalar = 0     # kernel launches by gp_scalar (CUDA tensors)
launches_scalar2 = 0    # ... by gp_scalar2
launches_onehot = 0     # ... by gp_onehot
launches_take = 0       # ... by gp_take_ax0
_lock = threading.Lock()
_lib = None


def load():
    """Build (at first use) and load the kernel library; raises on
    failure."""
    global _lib
    with _lock:
        if _lib is None:
            from bwamem_tpu_torch._build import shared_lib
            lib = ctypes.CDLL(shared_lib(SRC, "libgather_probe_kernel.so",
                                         [nvcc(), *NVCC_FLAGS]))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            for fn, n_int in ((lib.gp_scalar, 2), (lib.gp_scalar2, 3),
                              (lib.gp_onehot, 2), (lib.gp_take_ax0, 2)):
                fn.restype = ci
                fn.argtypes = [vp] * 3 + [ci] * n_int + [vp]
            _lib = lib
    return _lib


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to the int32 range (two's complement)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


# ---- plain versions ----

def scalar_plain(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return tab.gather(0, k.to(torch.int64))


def scalar2_plain(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    r = k.to(torch.int64)
    return _wrap32(tab[r, 0].to(torch.int64)
                   + tab[r, 1].to(torch.int64)).to(torch.int32)


def onehot_plain(tab3: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    A = tab3.shape[0]
    hi = k >> 7
    ok = (hi >= 0) & (hi < A)
    v = tab3.to(torch.bfloat16).to(torch.float32)[
        hi.clamp(0, A - 1).to(torch.int64), (k & 127).to(torch.int64)]
    return torch.where(ok, v, 0).to(torch.int32)


def take_ax0_plain(tab: torch.Tensor, kk: torch.Tensor,
                   steps: int) -> torch.Tensor:
    """The chain in int64 with the int32 wrap spelled out, so it does not
    lean on what a backend does on overflow."""
    R = tab.shape[0]
    k = kk.to(torch.int64)
    for _ in range(steps):
        k = torch.remainder(_wrap32(k + tab.gather(0, k).to(torch.int64)), R)
    return k.to(torch.int32)


# ---- kernels ----
# Each _prep_* checks a call's tensors (dtype, shape, contiguity, device,
# alignment) and returns the output tensor and the C entry's arguments; it
# raises ValueError on anything the kernel does not take.

def _check(name: str, t: torch.Tensor, what: str, *, cols=None, dev=None):
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous() \
            or (cols is not None and t.shape[1] != cols) \
            or (dev is not None and t.device != dev):
        raise ValueError(f"{name}: {what} must be contiguous int32 "
                         f"[rows, {cols or 'W'}]"
                         + (f" on {dev}" if dev is not None else "")
                         + f", got {t.dtype} {tuple(t.shape)} on {t.device}")


def _prep_lanes(name, tab, k, steps, tab_cols=COLS):
    _check(name, tab, "tab", cols=tab_cols)
    _check(name, k, "k", cols=COLS, dev=tab.device)
    if steps < 1:
        raise ValueError(f"{name}: steps {steps} < 1")
    if tab.shape[0] < 1:
        raise ValueError(f"{name}: empty table")
    out = torch.empty_like(k)
    return out, (tab.data_ptr(), k.data_ptr(), out.data_ptr(), k.numel())


def _prep_scalar(tab, k, steps):
    out, args = _prep_lanes("gp_scalar", tab, k, steps)
    return out, args + (int(steps),)


def _prep_scalar2(tab, k, steps):
    out, args = _prep_lanes("gp_scalar2", tab, k, steps, tab_cols=None)
    W = tab.shape[1]
    if W < 2 or W % 2 or tab.data_ptr() % 8:
        raise ValueError(f"gp_scalar2: rows of {W} words at "
                         f"{tab.data_ptr():#x} are not 8-byte aligned pairs")
    return out, args + (W, int(steps))


def _prep_onehot(tab3, k):
    out, args = _prep_lanes("gp_onehot", tab3, k, 1)
    return out, args + (tab3.shape[0],)


def _prep_take(tab, kk, steps):
    _check("gp_take_ax0", tab, "tab", cols=COLS)
    _check("gp_take_ax0", kk, "kk", cols=COLS, dev=tab.device)
    R = tab.shape[0]
    if kk.shape[0] != R or not 0 < R < (1 << 31) // COLS or steps < 0:
        raise ValueError(f"gp_take_ax0: kk {tuple(kk.shape)} for a table of "
                         f"{R} rows, steps {steps}")
    out = torch.empty_like(kk)
    return out, (tab.data_ptr(), kk.data_ptr(), out.data_ptr(), R,
                 int(steps))


def _launch(name: str, out: torch.Tensor, args: tuple) -> torch.Tensor:
    lib = load()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
    rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    return out


def gp_scalar(tab: torch.Tensor, k: torch.Tensor, steps: int) -> torch.Tensor:
    """tab int32 [R, 128], k int32 [N/128, 128] -> tab[k, column]."""
    if tab.device.type != "cuda":
        return scalar_plain(tab, k)
    global launches_scalar
    out = _launch("gp_scalar", *_prep_scalar(tab, k, steps))
    launches_scalar += 1
    return out


def gp_scalar2(tab: torch.Tensor, k: torch.Tensor,
               steps: int) -> torch.Tensor:
    """tab int32 [R, W] (W even), k int32 [N/128, 128] -> tab[k, 0] +
    tab[k, 1]; the two words are one 8-byte load."""
    if tab.device.type != "cuda":
        return scalar2_plain(tab, k)
    global launches_scalar2
    out = _launch("gp_scalar2", *_prep_scalar2(tab, k, steps))
    launches_scalar2 += 1
    return out


def gp_onehot(tab3: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """tab3 int32 [A, 128], k int32 [N/128, 128] -> the one-hot product's
    pick (see onehot_plain)."""
    if tab3.device.type != "cuda":
        return onehot_plain(tab3, k)
    global launches_onehot
    out = _launch("gp_onehot", *_prep_onehot(tab3, k))
    launches_onehot += 1
    return out


def gp_take_ax0(tab: torch.Tensor, kk: torch.Tensor,
                steps: int) -> torch.Tensor:
    """tab int32 [R, 128], kk int32 [R, 128] in [0, R) -> kk after `steps`
    chained steps kk = (kk + tab[kk, j]) mod R."""
    if tab.device.type != "cuda":
        return take_ax0_plain(tab, kk, steps)
    global launches_take
    out = _launch("gp_take_ax0", *_prep_take(tab, kk, steps))
    launches_take += 1
    return out
