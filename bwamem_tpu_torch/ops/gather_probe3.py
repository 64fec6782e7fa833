"""Round 3 of the gather probe: the hand-written CUDA kernels
(csrc/gather_probe3_kernel.cu) and their plain PyTorch versions.

Each is the function of one TPU probe kernel of the reference package's
tools/pl_gather_probe3.py, which maps what a gather costs in a kernel:

  gp3_dg    (dg_probe, :56)   kk = clip(kk + take_along_axis(tab, kk, axis),
                              0, hi - 1), `steps` times; tab and kk int32
                              [S, L], hi = tab.shape[axis]; the kernel
                              takes a line's step as a map and composes it
                              (the powers by squaring: 512 steps in ten
                              rounds), a line a segment of a warp at hi up
                              to 32, a block past that
  gp3_ct    (probe_ct, :79)   per step g = take_along_axis(tab, kk, 1),
                              g2 = take_along_axis(g.T, kk, 1), kk =
                              clip(kk + g2, 0, N - 1); tab and kk int32
                              [N, N], 1 <= N <= 139; at N = CT_N a
                              cluster of CT_CLUSTER blocks, at any other N
                              one block
  gp3_col0  (probe_d2, :103)  out[q] = tab[k[q], 0]; tab int32 [R, W], k
                              int32 [n]: ops/col0's call of col0_kernel
                              (csrc/col0.cuh)
  gp3_mm    (probe_e2, :125)  acc = 0, then `reps` times acc = acc +
                              (a @ b)[:rows] in float32; a [M, K], b [K, N]

Preconditions the kernels do not check (a plain version raises on the
first two): kk in [0, hi) for gp3_dg and in [0, N) for gp3_ct, k in [0, R)
for gp3_col0.  The adds of the chains wrap in int32, as jnp's do.  gp3_mm
splits K into 16 chunks over a cluster of 16 blocks, sums each chunk by
float32 FMA in k order (TF32 off) and adds the chunks' sums in a fixed
order (no atomics: two calls give the same bits); the plain version takes
torch.matmul's order, so the two are equal where every partial sum is
exact (integer-valued inputs small enough, mm_exact) and within
mm_tolerance elsewhere.

On the probe's own inputs (tables drawn from [0, 2^20), as the TPU
script's) nearly every chain of gp3_dg and gp3_ct saturates at hi - 1
after its first step and stays there; spread_inputs() draws the tables
from [-hi, hi], so chains keep moving and meet both ends of the clip.

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

SMEM_MAX = 232448           # bytes of shared memory a block may opt into
MM_REPS, MM_ROWS = 64, 8    # probe_e2's iterations and output rows

# gp3_ct runs at N = CT_N as a cluster of CT_CLUSTER blocks, each holding
# N / CT_CLUSTER rows of the state (the kernel's CT_N and CT_CS)
CT_N, CT_CLUSTER = 128, 16

# (in, in, out, ints)
LIB = Library("gather_probe3_kernel.cu", {
    name: [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_int
    for name, n_int in (("gp3_dg", 4), ("gp3_ct", 2), ("gp3_col0", 2),
                        ("gp3_mm", 4))})
SRC = LIB.src

launches_dg = 0         # kernel launches by gp3_dg (CUDA tensors)
launches_ct = 0         # ... by gp3_ct
launches_col0 = 0       # ... by gp3_col0
launches_mm = 0         # ... by gp3_mm



# ---- plain versions ----

def _clip_step(k: torch.Tensor, g: torch.Tensor, hi: int) -> torch.Tensor:
    """clip(k + g, 0, hi - 1) in int64, the int32 wrap of the add spelled
    out."""
    return _wrap32(k + g.to(torch.int64)).clamp(0, hi - 1)


def _in_range(name: str, kk: torch.Tensor, hi: int) -> None:
    if kk.numel() and (int(kk.min()) < 0 or int(kk.max()) >= hi):
        raise ValueError(f"{name}: an index outside [0, {hi})")


def dg_plain(tab: torch.Tensor, kk: torch.Tensor, steps: int,
             axis: int) -> torch.Tensor:
    hi = tab.shape[axis]
    _in_range("dg_plain", kk, hi)
    k = kk.to(torch.int64)
    for _ in range(steps):
        k = _clip_step(k, tab.gather(axis, k), hi)
    return k.to(torch.int32)


def ct_plain(tab: torch.Tensor, kk: torch.Tensor, steps: int) -> torch.Tensor:
    """The TPU kernel's step as written: a take on axis 1, the transpose,
    a second take on axis 1 at the same kk."""
    N = tab.shape[0]
    _in_range("ct_plain", kk, N)
    k = kk.to(torch.int64)
    for _ in range(steps):
        g = tab.gather(1, k)
        g2 = g.t().gather(1, k)
        k = _clip_step(k, g2, N)
    return k.to(torch.int32)


def mm_plain(a: torch.Tensor, b: torch.Tensor, reps: int = MM_REPS,
             rows: int = MM_ROWS) -> torch.Tensor:
    """`reps` float32 additions of (a @ b)[:rows], in order: the product's
    rows :rows are the same each time, so it is taken once."""
    m = torch.matmul(a[:rows], b)
    acc = torch.zeros_like(m)
    for _ in range(reps):
        acc = acc + m
    return acc


def mm_exact(a: torch.Tensor, b: torch.Tensor, reps: int = MM_REPS,
             rows: int = MM_ROWS) -> bool:
    """True when every partial sum of gp3_mm is an integer below 2^24 in
    magnitude, so any order of the sums gives the same float32."""
    a, b = a[:rows].double(), b.double()
    if not (torch.equal(a, a.round()) and torch.equal(b, b.round())):
        return False
    bound = (a.abs() @ b.abs()).max().item() if a.numel() and b.numel() \
        else 0.0
    return bound * reps < 2 ** 24


def mm_tolerance(a: torch.Tensor, b: torch.Tensor, reps: int = MM_REPS,
                 rows: int = MM_ROWS) -> float:
    """Bound on |gp3_mm - mm_plain| from rounding alone: each K-term dot
    product is within K u S of the exact one in any order (u = 2^-24, S =
    the largest sum of |a_rk b_kc|), and each of the `reps` additions
    rounds the sum, at most u reps S, on each side."""
    K = a.shape[1]
    u = 2.0 ** -24
    S = (a[:rows].double().abs() @ b.double().abs()).max().item() \
        if a.numel() and b.numel() else 0.0
    return 2 * reps * (K * u * S + reps * u * S)


CT_KINDS = ("probe", "spread", "wrap")       # of dg_inputs and ct_inputs


def dg_inputs(kind: str, S: int, L: int, axis: int, seed: int,
              device="cpu"):
    """(tab, kk) int32 [S, L] for gp3_dg along `axis` (hi = (S, L)[axis]):
    "probe", tab in [0, 2^20) as the TPU script draws it (every chain at
    hi - 1 after a step); "spread", spread_inputs; "wrap", tab within 64
    of +-2^31 (even rows negative), so that every add wraps in int32.  kk
    in [0, hi)."""
    import numpy as np
    if kind == "spread":
        return spread_inputs(seed, S, L, axis, device)
    rng = np.random.default_rng(seed)
    lo, hi = {"probe": (0, 1 << 20), "wrap": ((1 << 31) - 64, 1 << 31)}[kind]
    tab = rng.integers(lo, hi, (S, L), dtype=np.int64).astype(np.int32)
    if kind == "wrap":
        tab[::2] = -tab[::2]
    kk = rng.integers(0, (S, L)[axis], (S, L), dtype=np.int32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(kk).to(device))


def ct_inputs(kind: str, N: int, seed: int, device="cpu"):
    """(tab, kk) int32 [N, N] for gp3_ct: dg_inputs at [N, N] along axis
    1 (the probe's table, spread_inputs, or adds that wrap)."""
    return dg_inputs(kind, N, N, 1, seed, device)


def spread_inputs(seed: int, S: int, L: int, axis: int, device="cpu"):
    """A table drawn from [-hi, hi] and a start kk in [0, hi) for gp3_dg
    (or gp3_ct with S = L, axis 1): chains move every step and meet both
    ends of the clip."""
    import numpy as np
    hi = (S, L)[axis]
    rng = np.random.default_rng(seed)
    tab = rng.integers(-hi, hi + 1, (S, L), dtype=np.int32)
    kk = rng.integers(0, hi, (S, L), dtype=np.int32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(kk).to(device))


# ---- kernels ----
# Each _prep_* checks a call's tensors (dtype, shape, contiguity, device)
# and returns the output tensor and the C entry's arguments; it raises
# ValueError on anything the kernel does not take.

def _prep_dg(tab, kk, steps, axis):
    _check("gp3_dg", tab, "tab")
    _check("gp3_dg", kk, "kk", dev=tab.get_device())
    if kk.shape != tab.shape or min(tab.shape) < 1 or steps < 0 \
            or axis not in (0, 1):
        raise ValueError(f"gp3_dg: kk {tuple(kk.shape)} for a table "
                         f"{tuple(tab.shape)}, steps {steps}, axis {axis}")
    if tab.shape[axis] * 4 > SMEM_MAX:
        raise ValueError(f"gp3_dg: a line of {tab.shape[axis]} words does "
                         f"not fit in {SMEM_MAX} bytes of shared memory")
    out = torch.empty_like(kk)
    return out, (tab.data_ptr(), kk.data_ptr(), out.data_ptr(),
                 tab.shape[0], tab.shape[1], int(steps), int(axis))


def check_ct(tab, kk, steps) -> int:
    """N of a gp3_ct call's square tab and kk; ValueError on anything the
    kernel does not take."""
    _check("gp3_ct", tab, "tab")
    _check("gp3_ct", kk, "kk", dev=tab.get_device())
    N = tab.shape[0]
    if tab.shape != (N, N) or kk.shape != tab.shape or N < 1 or steps < 0:
        raise ValueError(f"gp3_ct: square tab and kk expected, got "
                         f"{tuple(tab.shape)} and {tuple(kk.shape)}, steps "
                         f"{steps}")
    if (3 * N * N + 2) * 4 > SMEM_MAX:
        raise ValueError(f"gp3_ct: the table and two states of [{N},{N}] "
                         f"do not fit in {SMEM_MAX} bytes of shared memory")
    return N


def _prep_ct(tab, kk, steps):
    N = check_ct(tab, kk, steps)
    out = torch.empty_like(kk)
    return out, (tab.data_ptr(), kk.data_ptr(), out.data_ptr(), N,
                 int(steps))


def _prep_mm(a, b, reps, rows):
    for what, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32 or t.dim() != 2 \
                or not t.is_contiguous() \
                or t.get_device() != a.get_device():
            raise ValueError(f"gp3_mm: {what} must be contiguous float32 "
                             f"2-d on {a.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if a.shape[1] != b.shape[0] or not 0 < rows <= a.shape[0] or reps < 0:
        raise ValueError(f"gp3_mm: a {tuple(a.shape)} @ b {tuple(b.shape)}"
                         f", rows {rows}, reps {reps}")
    out = a.new_empty((rows, b.shape[1]))
    return out, (a.data_ptr(), b.data_ptr(), out.data_ptr(), rows,
                 a.shape[1], b.shape[1], int(reps))


def _launch(name: str, out: torch.Tensor, args: tuple) -> torch.Tensor:
    LIB.launch(name, out.get_device(), args)
    return out


def gp3_dg(tab: torch.Tensor, kk: torch.Tensor, steps: int,
           axis: int) -> torch.Tensor:
    """tab, kk int32 [S, L], kk in [0, hi) -> kk after `steps` clipped
    chain steps along `axis` (see dg_plain)."""
    if not tab.is_cuda:
        return dg_plain(tab, kk, steps, axis)
    global launches_dg
    out = _launch("gp3_dg", *_prep_dg(tab, kk, steps, axis))
    launches_dg += 1
    return out


def gp3_ct(tab: torch.Tensor, kk: torch.Tensor, steps: int) -> torch.Tensor:
    """tab, kk int32 [N, N], kk in [0, N) -> kk after `steps` transpose
    steps (see ct_plain)."""
    if not tab.is_cuda:
        return ct_plain(tab, kk, steps)
    global launches_ct
    out = _launch("gp3_ct", *_prep_ct(tab, kk, steps))
    launches_ct += 1
    return out


def gp3_col0(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """tab int32 [R, W], k int32 [n] in [0, R) -> tab[k, 0]."""
    if not tab.is_cuda:
        return col0.plain(tab, k)
    global launches_col0
    out = col0.launch(LIB, "gp3_col0", tab, k)
    launches_col0 += 1
    return out


def gp3_mm(a: torch.Tensor, b: torch.Tensor, reps: int = MM_REPS,
           rows: int = MM_ROWS) -> torch.Tensor:
    """a float32 [M, K], b [K, N] -> float32 [rows, N], `reps` ordered
    additions of (a @ b)[:rows] (see mm_plain, mm_exact, mm_tolerance)."""
    if not a.is_cuda:
        return mm_plain(a, b, reps, rows)
    global launches_mm
    out = _launch("gp3_mm", *_prep_mm(a, b, reps, rows))
    launches_mm += 1
    return out
