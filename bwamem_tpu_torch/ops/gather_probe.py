"""The gather-strategy probe: the hand-written CUDA kernels
(csrc/gather_probe_kernel.cu) and their plain PyTorch versions.

An in-kernel FM scan needs one table lookup per lane and step.  This probe
prices four ways of making it, each the function of one TPU probe kernel of
the reference package's tools/pl_gather_probe.py:

  gp_scalar    (kernel_scalar, :65)  out[i, j] = tab[k[i, j], j]
  gp_scalar2   (kernel_scalarw, :93) out = tab[k, 0] + tab[k, 1], wrapping
                                     int32
  gp_onehot    (kernel_mm, :120)     out = int(bf16(tab3[k >> 7, k & 127])),
                                     0 where k >> 7 is outside [0, A): the
                                     TPU kernel's one-hot product computes
                                     this gather, and so does the kernel,
                                     one load a lane
  gp_take_ax0  (kernel_dg, :151)     kk = (kk + tab[kk, j]) mod R, `steps`
                                     times, over a table-shaped kk [R, 128];
                                     the kernel takes each column's step as
                                     a map once a launch, in shared memory
                                     where the map fits (a block a column,
                                     three launches through a scratch the
                                     wrapper allocates at the size the
                                     library gives), past that a thread an
                                     element

k is int32 [N/128, 128] (N lanes, lane q at row q // 128, column q % 128);
every table is int32.  gp_scalar and gp_scalar2 compute one pass: their
TPU kernels repeat the pass STEPS times only to price one, and the output
does not depend on it.  gp_scalar2 reads a row's two words in one 8-byte
load where the row start is 8-byte aligned (W even, the table 8-byte
aligned), in two 4-byte loads otherwise.
Preconditions the kernels do not check (a plain version raises on the
first): k in [0, R) for gp_scalar and gp_scalar2, kk in [0, R) for
gp_take_ax0, and |tab3| < 2^24 for gp_onehot — there int32 -> float ->
bf16 rounds as XLA does, and the bf16 value converts back to int32.

On a CUDA tensor each wrapper launches its kernel and counts the launch
(launches_*); on a CPU tensor it runs the plain version and counts nothing.
There is no fallback between the two: a failed build or launch raises.
The kernels are built and launched through ops/launch (nvcc for sm_90a at
first use, the caller's current stream).
"""
from __future__ import annotations

import ctypes

import torch

from bwamem_tpu_torch.ops.launch import Library

COLS = 128                  # columns of k, tab and tab3; lanes per k row
# kernels one gp_take_ax0 call launches where it takes the column design
# (take_in_kernel, take_col_kernel, take_out_kernel: a scratch is needed);
# one elsewhere.  launches_take counts calls.
TAKE_COL_KERNELS = 3
# (pointers, ints): (tab, k, out; N) for gp_scalar, (...; N, W) for
# gp_scalar2, (...; N, A) for gp_onehot, (tab, kk, out, scratch; R, steps)
# for gp_take_ax0
LIB = Library("gather_probe_kernel.cu", {
    name: [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
    for name, n_ptr, n_int in (("gp_scalar", 3, 1), ("gp_scalar2", 3, 2),
                               ("gp_onehot", 3, 2), ("gp_take_ax0", 4, 2))})
SRC = LIB.src

launches_scalar = 0     # kernel launches by gp_scalar (CUDA tensors)
launches_scalar2 = 0    # ... by gp_scalar2
launches_onehot = 0     # ... by gp_onehot
launches_take = 0       # ... by gp_take_ax0 (calls: see TAKE_COL_KERNELS)


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


ONEHOT_CASES = ("probe", "bf16_rounding", "k_outside", "k_extremes")


def onehot_inputs(case: str, A: int = 8, n: int = 256, seed: int = 3):
    """numpy (tab3 int32 [A, 128], k int32 [n/128, 128], n >= 256) for
    gp_onehot, drawn from `seed`: "probe", tab3 in [0, 255) as the TPU
    probe draws it, where bf16 is exact; "bf16_rounding", tab3 in
    (-2^23, 2^23), where most values round, with the ties 257, 259, 383,
    385, 513, -257 and the largest odd values 2^23 - 1, 2^23 - 3 in row 0
    and zeros beside them; "k_outside", as bf16_rounding with half of k's
    second row in [A * 128, 2^30) and half in [-2^30, 0); "k_extremes", as
    k_outside with k = 0, A * 128 - 1, A * 128, -1, -2^31 and 2^31 - 1 in
    row 0."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hi = 255 if case == "probe" else 1 << 23
    tab3 = rng.integers(0 if case == "probe" else -hi, hi, (A, 128),
                        dtype=np.int32)
    if case != "probe":                    # ties to even, and exact zeros
        tab3[0, :8] = ((1 << 23) - 1, (1 << 23) - 3, 257, 259, 513, -257,
                       383, 385)
        tab3[0, 8:16] = 0
    k = rng.integers(0, A * 128, (n // 128, 128), dtype=np.int32)
    k[0, :16] = np.arange(16)
    if case in ("k_outside", "k_extremes"):
        k[1, :64] = rng.integers(A * 128, 1 << 30, 64)
        k[1, 64:] = rng.integers(-(1 << 30), 0, 64)
    if case == "k_extremes":
        k[0, 16:22] = (0, A * 128 - 1, A * 128, -1, -(1 << 31),
                       (1 << 31) - 1)
    return tab3, k


TAKE_KINDS = ("probe", "spread", "wrap")


def take_inputs(kind: str, R: int = 78208, n_lanes: int = 8192,
                seed: int = 0, device="cpu"):
    """(tab, kk) int32 [R, 128] for gp_take_ax0, drawn from `seed`:
    "probe", tab in [0, 2^20) and kk zero past its first n_lanes / 128
    rows, which hold lanes in [0, R), as the TPU script seeds its
    table-shaped indices (so the chains of rows past them share one state
    a column); "spread", the same table and every row of kk drawn from
    [0, R) (chains that share no state); "wrap", tab within 4096 of
    +-2^31 (even rows negative) and kk as "spread", so that adds wrap in
    int32 and remainders go negative before the sign fix."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = (((1 << 31) - 4096, 1 << 31) if kind == "wrap"
              else (0, 1 << 20))
    tab = rng.integers(lo, hi, (R, 128), dtype=np.int64).astype(np.int32)
    if kind == "wrap":
        tab[::2] = -tab[::2]
    if kind == "probe":
        kk = np.zeros((R, 128), np.int32)
        kk[:n_lanes // 128] = rng.integers(0, R, (n_lanes // 128, 128),
                                           dtype=np.int32)
    else:
        kk = rng.integers(0, R, (R, 128), dtype=np.int32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(kk).to(device))


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
    """dev: the device index (Tensor.get_device(), -1 on the CPU) that t
    must be on, or None."""
    if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous() \
            or (cols is not None and t.shape[1] != cols) \
            or (dev is not None and t.get_device() != dev):
        raise ValueError(f"{name}: {what} must be contiguous int32 "
                         f"[rows, {cols or 'W'}]"
                         + (f" on device index {dev}" if dev is not None
                            else "")
                         + f", got {t.dtype} {tuple(t.shape)} on {t.device}")


def _prep_lanes(name, tab, k, tab_cols=COLS):
    _check(name, tab, "tab", cols=tab_cols)
    _check(name, k, "k", cols=COLS, dev=tab.get_device())
    if tab.shape[0] < 1:
        raise ValueError(f"{name}: empty table")
    out = torch.empty_like(k)
    return out, (tab.data_ptr(), k.data_ptr(), out.data_ptr(), k.numel())


def _prep_scalar(tab, k):
    return _prep_lanes("gp_scalar", tab, k)


def _prep_scalar2(tab, k):
    out, args = _prep_lanes("gp_scalar2", tab, k, tab_cols=None)
    W = tab.shape[1]
    if W < 2:
        raise ValueError(f"gp_scalar2: rows of {W} words hold no two words")
    return out, args + (W,)


def _prep_onehot(tab3, k):
    out, args = _prep_lanes("gp_onehot", tab3, k)
    return out, args + (tab3.shape[0],)


def _prep_take(tab, kk, steps):
    _check("gp_take_ax0", tab, "tab", cols=COLS)
    _check("gp_take_ax0", kk, "kk", cols=COLS, dev=tab.get_device())
    R = tab.shape[0]
    if kk.shape[0] != R or not 0 < R < (1 << 31) // COLS or steps < 0:
        raise ValueError(f"gp_take_ax0: kk {tuple(kk.shape)} for a table of "
                         f"{R} rows, steps {steps}")
    out = torch.empty_like(kk)
    return out, (tab.data_ptr(), kk.data_ptr(), out.data_ptr(), R,
                 int(steps))


def take_scratch_words(R: int) -> int:
    """int32 words of the scratch gp_take_ax0 needs at R rows, as the CUDA
    library gives them (gp_take_ax0_scratch_words: the column design's
    where its map fits a block's shared memory, else 0, and the C entry
    then takes a design that needs none)."""
    return LIB.value("gp_take_ax0_scratch_words", R)


def _launch(name: str, out: torch.Tensor, args: tuple) -> torch.Tensor:
    LIB.launch(name, out.get_device(), args)
    return out


def gp_scalar(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """tab int32 [R, 128], k int32 [N/128, 128] -> tab[k, column], one
    pass."""
    if not tab.is_cuda:
        return scalar_plain(tab, k)
    global launches_scalar
    out = _launch("gp_scalar", *_prep_scalar(tab, k))
    launches_scalar += 1
    return out


def gp_scalar2(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """tab int32 [R, W] (W >= 2), k int32 [N/128, 128] -> tab[k, 0] +
    tab[k, 1], wrapping int32, one pass."""
    if not tab.is_cuda:
        return scalar2_plain(tab, k)
    global launches_scalar2
    out = _launch("gp_scalar2", *_prep_scalar2(tab, k))
    launches_scalar2 += 1
    return out


def gp_onehot(tab3: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """tab3 int32 [A, 128], k int32 [N/128, 128] -> int(bf16(tab3.flat[k]))
    where 0 <= k < A * 128, else 0 (see onehot_plain): the one-hot
    product's pick, computed as the gather it is."""
    if not tab3.is_cuda:
        return onehot_plain(tab3, k)
    global launches_onehot
    out = _launch("gp_onehot", *_prep_onehot(tab3, k))
    launches_onehot += 1
    return out


def gp_take_ax0(tab: torch.Tensor, kk: torch.Tensor,
                steps: int) -> torch.Tensor:
    """tab int32 [R, 128], kk int32 [R, 128] in [0, R) -> kk after `steps`
    chained steps kk = (kk + tab[kk, j]) mod R."""
    if not tab.is_cuda:
        return take_ax0_plain(tab, kk, steps)
    global launches_take
    out, (t, k, o, R, n) = _prep_take(tab, kk, steps)
    words = take_scratch_words(R)
    scratch = kk.new_empty(words) if words else None
    _launch("gp_take_ax0", out, (t, k, o, scratch.data_ptr() if words else 0,
                                 R, n))
    launches_take += 1
    return out
