"""Round 2 of the gather probe of bwamem_tpu_torch (ops/gather_probe2) on
the CPU.  The four Pallas kernel bodies of the reference's
tools/pl_gather_probe2.py (:75-161), copied here with their sizes and
STEPS as parameters, run under pl.pallas_call(..., interpret=True) at a
small size, and each plain version must equal its kernel exactly; so must
the lane loops of csrc/gather_probe2_kernel.cu, built for the host
(gp2_take_ax0 and gp2_take_ax1 as the card runs them: csrc/line_pow.cuh's
map taken once, its powers by squaring and a lookup a set bit of `steps`;
gp2_col0, and gp2_onehot_f32's gather, held against the float32 one-hot
product in interpret mode).  The edge cases: table values near +-2^31 for
the chains (the int32 wrap, and the sign of the remainder), step counts
with no bit, one, low bits and both ends set, R at the warp design's sizes
and past them, values up to 2^23 for the float32 one-hot product, values
in (2^24, 2^30) and at float32 ties there, where the int32 -> float32
conversion rounds, and k at 0, at A * 128 - 1 and outside [0, A * 128)."""
import ctypes

import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401  (x64 on, as the reference runs)
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from bwamem_tpu_torch._build import shared_lib
from bwamem_tpu_torch.ops import col0, gather_probe2 as gp2

from torch_port_util import (T, assert_same, col0_bad_inputs,
                             col0_edge_inputs)

VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
SMEM = pl.BlockSpec(memory_space=pltpu.SMEM)
STEPS = 5


def pl_b(tab, idx, steps):
    """probe_b's kernel (tools/pl_gather_probe2.py:75-79); its 512 is the
    table's row count."""
    R = tab.shape[0]

    def kernel(tab_ref, k_ref, o_ref):
        def body(i, kk):
            g = jnp.take_along_axis(tab_ref[:], kk, axis=0)
            return (kk + g) % R
        o_ref[:] = jax.lax.fori_loop(0, steps, body, k_ref[:])
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(tab.shape, jnp.int32),
        in_specs=[VMEM] * 2, out_specs=VMEM, interpret=True)(tab, idx)


def pl_c(tab, idx, steps):
    """probe_c's kernel (:98-102)."""
    def kernel(tab_ref, k_ref, o_ref):
        def body(i, kk):
            g = jnp.take_along_axis(tab_ref[:], kk, axis=1)
            return (kk + g) % 128
        o_ref[:] = jax.lax.fori_loop(0, steps, body, k_ref[:])
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(tab.shape, jnp.int32),
        in_specs=[VMEM] * 2, out_specs=VMEM, interpret=True)(tab, idx)


def pl_d(tab, idx):
    """probe_d's kernel (:122-128)."""
    N = idx.shape[0]

    def kernel(tab_ref, k_ref, o_ref):
        def lane(q, _):
            r = k_ref[q]
            o_ref[q] = tab_ref[r, 0]
            return 0
        jax.lax.fori_loop(0, N, lane, 0)
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((N,), jnp.int32),
        in_specs=[VMEM, SMEM], out_specs=SMEM, interpret=True)(tab, idx)


def pl_e(tab, idx):
    """probe_e's kernel (:150-161); idx is [Q/128, 128]."""
    Q = idx.size
    A = tab.shape[0]

    def kernel(tab_ref, k_ref, o_ref):
        kk = k_ref[:]
        hi = (kk >> 7).reshape(Q, 1)
        oh = (hi == jax.lax.broadcasted_iota(jnp.int32, (Q, A), 1))
        m1 = jax.lax.dot_general(
            oh.astype(jnp.float32), tab_ref[:].astype(jnp.float32),
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)
        lo = (kk & 127).reshape(Q, 1)
        pick = jnp.take_along_axis(
            m1, jnp.broadcast_to(lo, (Q, 128)).astype(jnp.int32), axis=1)
        o_ref[:] = pick[:, :1].reshape(Q // 128, 128).astype(jnp.int32)
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.int32),
        in_specs=[VMEM] * 2, out_specs=VMEM, interpret=True)(tab, idx)


def _table(rng, shape, lo, hi):
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)


def _host(entry, *arrays_and_ints):
    """csrc/gather_probe2_kernel.cu's lane loops built as host C++ (the
    card runs the same code per thread); returns the filled output."""
    lib = ctypes.CDLL(shared_lib(
        gp2.SRC, "libgather_probe2_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    args, keep = [], []
    for a in arrays_and_ints:
        if isinstance(a, np.ndarray):
            a = np.ascontiguousarray(a, np.int32)
            keep.append(a)
            args.append(ctypes.c_void_p(a.ctypes.data))
        else:
            args.append(ctypes.c_int(a))
    assert fn(*args) == 0
    return keep[2]


RANGES = [(0, 1 << 20), ((1 << 31) - 4096, 1 << 31), (-(1 << 31), 1 << 31)]


# step counts of the composed map: no bit set; one; low bits; five set
# bits; one high bit (the TPU probe's 32); both ends
POW_STEPS = (0, 1, 5, 31, 32, 33)


@pytest.mark.parametrize("steps", POW_STEPS)
@pytest.mark.parametrize("R", [1, 5, 32, 33, 64, 128, 129])
@pytest.mark.parametrize("lo,hi", RANGES)
def test_take_ax0_plain_and_lanes_match_pallas(lo, hi, R, steps):
    """gp2_take_ax0_host runs the card's algorithm (the map of each
    column built at its row, T_j(r) = (r + tab[r, j]) mod R; its powers by
    squaring, the state taking one a set bit of `steps`): R up to 32 the
    warp-segment design's sizes, 128 the warp-a-line design's, 33, 64 and
    129 the block design's."""
    rng = np.random.default_rng(1 + R * 64 + steps)
    tab = _table(rng, (R, 128), lo, hi)
    kk = rng.integers(0, R, (R, 128), dtype=np.int32)
    want = np.asarray(pl_b(jnp.asarray(tab), jnp.asarray(kk), steps))
    got = gp2.take_ax0_plain(T(tab), T(kk), steps)
    assert_same(want, got, "take_ax0")
    assert (want >= 0).all() and (want < R).all()
    assert_same(want, _host("gp2_take_ax0_host", tab, kk, np.zeros_like(kk),
                            R, steps), "take_ax0 lanes")


@pytest.mark.parametrize("steps", POW_STEPS)
@pytest.mark.parametrize("S", [1, 8, 16])
@pytest.mark.parametrize("lo,hi", RANGES)
def test_take_ax1_plain_and_lanes_match_pallas(lo, hi, S, steps):
    """gp2_take_ax1_host runs the card's algorithm on each row's map
    T_i(k) = (k + tab[i, k]) mod 128."""
    rng = np.random.default_rng(2 + S * 64 + steps)
    tab = _table(rng, (S, 128), lo, hi)
    kk = rng.integers(0, 128, (S, 128), dtype=np.int32)
    want = np.asarray(pl_c(jnp.asarray(tab), jnp.asarray(kk), steps))
    got = gp2.take_ax1_plain(T(tab), T(kk), steps)
    assert_same(want, got, "take_ax1")
    assert (want >= 0).all() and (want < 128).all()
    assert_same(want, _host("gp2_take_ax1_host", tab, kk, np.zeros_like(kk),
                            S, steps), "take_ax1 lanes")


def test_chains_with_no_steps_return_their_input():
    rng = np.random.default_rng(3)
    kk = rng.integers(0, 8, (8, 128), dtype=np.int32)
    tab = _table(rng, (8, 128), 0, 1 << 20)
    for fn, entry in ((gp2.take_ax0_plain, "gp2_take_ax0_host"),
                      (gp2.take_ax1_plain, "gp2_take_ax1_host")):
        assert_same(kk, fn(T(tab), T(kk), 0), entry)
        assert_same(kk, _host(entry, tab, kk, np.zeros_like(kk), 8, 0),
                    entry)


@pytest.mark.parametrize("W", [8, 3])
def test_col0_plain_and_lanes_match_pallas(W):
    rng = np.random.default_rng(4)
    R, N = 1000, 256
    tab = _table(rng, (R, W), -(1 << 31), 1 << 31)
    k = rng.integers(0, R, N, dtype=np.int32)
    k[:2] = (0, R - 1)
    want = np.asarray(pl_d(jnp.asarray(tab), jnp.asarray(k)))
    assert_same(want, col0.plain(T(tab), T(k)), "col0")
    assert_same(want, _host("gp2_col0_host", tab, k, np.zeros_like(k), N, W),
                "col0 lanes")


@pytest.mark.parametrize("W", [1, 3, 8])
@pytest.mark.parametrize("N", [1, 8, 33, 1024])
def test_col0_shared_lane_loop_matches_pallas(N, W):
    """The one lane loop of csrc/col0.cuh, which gp2_col0 and gp3_col0
    both launch, built for the host through this library's entry, at one
    lane, 8, past a warp and 1024 lanes; k at R - 1 and 0."""
    tab, k = col0_edge_inputs(N, W)
    want = np.asarray(pl_d(jnp.asarray(tab), jnp.asarray(k)))
    assert_same(want, col0.plain(T(tab), T(k)), "col0")
    assert_same(want, _host("gp2_col0_host", tab, k, np.zeros_like(k), N, W),
                "col0 lanes")


F32_TIES = ((1 << 24) + 1, (1 << 24) + 3, (1 << 25) + 2, -((1 << 24) + 1),
            (1 << 31) - 129)
F32_TIES_ROUNDED = [1 << 24, (1 << 24) + 4, 1 << 25, -(1 << 24),
                    (1 << 31) - 128]


@pytest.mark.parametrize("case", ["probe", "to_2^23", "k_outside",
                                  "f32_rounding"])
def test_onehot_f32_plain_matches_pallas(case):
    rng = np.random.default_rng(5)
    A, Q = 20, 512
    if case == "f32_rounding":   # |tab| in (2^24, 2^30): float32 rounds
        tab = _table(rng, (A, 128), (1 << 24) + 1, 1 << 30)
        tab = np.where(rng.integers(0, 2, tab.shape) == 1, tab, -tab)
        tab[0, :5] = F32_TIES    # ties to even, and the precondition's end
    else:
        hi = {"probe": 1 << 20, "to_2^23": 1 << 23,
              "k_outside": 1 << 23}[case]
        tab = _table(rng, (A, 128), 0 if case == "probe" else -hi, hi)
    if case in ("to_2^23", "k_outside"):  # a TF32 or bf16 product rounds
        tab[0, :6] = ((1 << 23) - 1, -(1 << 23) + 1, 2049, 4097, -2049, 0)
    k = rng.integers(0, A * 128, (Q // 128, 128), dtype=np.int32)
    k[0, :8] = (0, 1, 2, 3, 4, 5, A * 128 - 1, A * 128 - 128)
    if case == "k_outside":
        k[1, :64] = rng.integers(A * 128, 1 << 30, 64)
        k[1, 64:] = rng.integers(-(1 << 30), 0, 64)
    want = np.asarray(pl_e(jnp.asarray(tab), jnp.asarray(k)))
    got = gp2.onehot_f32_plain(T(tab), T(k))
    assert_same(want, got, f"onehot_f32 {case}")
    # the kernel's lane (one load, the int32 -> float32 -> int32 round
    # trip), built for the host, against the same product
    assert_same(want, _host("gp2_onehot_f32_host", tab, k, np.zeros_like(k),
                            Q, A), f"gp2_onehot_f32 lanes {case}")
    inside = (k >> 7 >= 0) & (k >> 7 < A)
    raw = tab[(k >> 7)[inside], (k & 127)[inside]]
    if case == "f32_rounding":   # a lane that skips the round trip fails
        assert (want[inside] != raw).mean() > 0.5
        assert want[0, :5].tolist() == F32_TIES_ROUNDED
    else:
        assert (want[inside] == raw).all()
    if case == "k_outside":
        assert (want[1] == 0).all()


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    rng = np.random.default_rng(6)
    tab = T(_table(rng, (64, 128), 0, 1 << 20))
    kk0 = T(rng.integers(0, 64, (64, 128), dtype=np.int32))
    kk1 = T(rng.integers(0, 128, (64, 128), dtype=np.int32))
    k = T(rng.integers(0, 64, 256, dtype=np.int32))
    ke = T(rng.integers(0, 64 * 128, (2, 128), dtype=np.int32))
    names = ("launches_take0", "launches_take1", "launches_col0",
             "launches_onehot")
    before = [getattr(gp2, n) for n in names]
    assert torch.equal(gp2.gp2_take_ax0(tab, kk0, STEPS),
                       gp2.take_ax0_plain(tab, kk0, STEPS))
    assert torch.equal(gp2.gp2_take_ax1(tab, kk1, STEPS),
                       gp2.take_ax1_plain(tab, kk1, STEPS))
    assert torch.equal(gp2.gp2_col0(tab, k), col0.plain(tab, k))
    assert torch.equal(gp2.gp2_onehot_f32(tab, ke),
                       gp2.onehot_f32_plain(tab, ke))
    assert [getattr(gp2, n) for n in names] == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(7)
    tab = T(_table(rng, (64, 128), 0, 1 << 20))
    kk = T(rng.integers(0, 64, (64, 128), dtype=np.int32))
    k = T(rng.integers(0, 64, 256, dtype=np.int32))
    good = {"take0": (gp2._prep_take0, dict(tab=tab, kk=kk, steps=2)),
            "take1": (gp2._prep_take1, dict(tab=tab, kk=kk, steps=2)),
            "col0": (lambda tab, k: col0.prep("gp2_col0", tab, k),
                     dict(tab=tab[:, :8].contiguous(), k=k)),
            "onehot": (gp2._prep_onehot, dict(tab=tab, k=kk[:2]))}
    for fn, kw in good.values():
        out, _ = fn(**kw)
        assert out.shape == kw.get("kk", kw.get("k")).shape
    big = torch.zeros((gp2.SMEM_MAX // 4 + 1, 128), dtype=torch.int32)
    bad = [("take0", dict(tab=tab.to(torch.int64))),
           ("take0", dict(kk=kk[:32])),
           ("take0", dict(kk=kk[:, :64].contiguous())),
           ("take0", dict(tab=big, kk=big)),
           ("take0", dict(steps=-1)),
           ("take1", dict(kk=kk.t())),
           ("take1", dict(tab=tab[:, :64].contiguous())),
           ("col0", dict(k=k.reshape(2, 128))),
           ("col0", dict(k=k.to(torch.int64))),
           ("col0", dict(tab=tab[:0])),
           *(("col0", c) for c in col0_bad_inputs(tab[:, :8].contiguous(),
                                                 k)),
           ("onehot", dict(k=k)),
           ("onehot", dict(tab=tab[:0])),
           ("onehot", dict(k=kk[:2].to(torch.float32)))]
    for name, change in bad:
        fn, kw = good[name]
        with pytest.raises(ValueError):
            fn(**(kw | change))
