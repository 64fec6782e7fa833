"""Round 3 of the gather probe of bwamem_tpu_torch (ops/gather_probe3) on
the CPU.  The four Pallas kernel bodies of the reference's
tools/pl_gather_probe3.py (:56-136), copied here with their sizes, STEPS
and the product's iterations as parameters, run under
pl.pallas_call(..., interpret=True) at a small size, and each plain
version must equal its kernel (gp3_mm: exactly on integer-valued inputs,
within mm_tolerance on normal ones); so must the lane loops of
csrc/gather_probe3_kernel.cu built for the host (gp3_dg step by step, and
as the card computes it: the line's map, its powers by squaring and the
state taking one power for each set bit of the steps, after 0, 1, 37 and
512 steps).  Besides the probe's own
tables (values in [0, 2^20), where every chain saturates at hi - 1 after
one step), the chains run on spread tables (values in [-hi, hi]: chains
keep moving and meet both ends of the clip) and near +-2^31 (the int32
wrap of the add).  gp3_ct's spread input is one on which a single-buffer
step, lanes reading a mix of old and new kk, gives another result."""
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
from bwamem_tpu_torch.ops import col0, gather_probe3 as gp3

from torch_port_util import (T, assert_same, col0_bad_inputs,
                             col0_edge_inputs)

VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)
SMEM = pl.BlockSpec(memory_space=pltpu.SMEM)
STEPS = 6


def pl_dg(tab, idx, axis, steps):
    """dg_probe's kernel (tools/pl_gather_probe3.py:56-61)."""
    S, L = tab.shape
    hi = S if axis == 0 else L

    def kernel(tab_ref, k_ref, o_ref):
        def body(i, kk):
            g = jnp.take_along_axis(tab_ref[:], kk, axis=axis)
            return jnp.clip(kk + g, 0, hi - 1)
        o_ref[:] = jax.lax.fori_loop(0, steps, body, k_ref[:])
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((S, L), jnp.int32),
        in_specs=[VMEM] * 2, out_specs=VMEM, interpret=True)(tab, idx)


def pl_ct(tab, idx, steps):
    """probe_ct's kernel (:79-85); its 127 is N - 1."""
    N = tab.shape[0]

    def kernel(tab_ref, k_ref, o_ref):
        def body(i, kk):
            g = jnp.take_along_axis(tab_ref[:], kk, axis=1)
            gt = g.T
            g2 = jnp.take_along_axis(gt, kk, axis=1)
            return jnp.clip(kk + g2, 0, N - 1)
        o_ref[:] = jax.lax.fori_loop(0, steps, body, k_ref[:])
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((N, N), jnp.int32),
        in_specs=[VMEM] * 2, out_specs=VMEM, interpret=True)(tab, idx)


def pl_d2(tab, idx):
    """probe_d2's kernel (:103-106); its 8 is the lane count."""
    n = idx.shape[0]

    def kernel(tab_ref, k_ref, o_ref):
        for q in range(n):
            r = k_ref[q]
            o_ref[q] = tab_ref[r, 0]
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((n,), jnp.int32),
        in_specs=[VMEM, SMEM], out_specs=SMEM, interpret=True)(tab, idx)


def pl_e2(a, b, reps, rows):
    """probe_e2's kernel (:125-132); its 64 and 8 are reps and rows."""
    N = b.shape[1]

    def kernel(a_ref, b_ref, o_ref):
        def body(i, acc):
            m = jax.lax.dot_general(a_ref[:], b_ref[:],
                                    (((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.float32)
            return acc + m[:rows]
        o_ref[:] = jax.lax.fori_loop(0, reps, body,
                                     jnp.zeros((rows, N), jnp.float32))
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((rows, N), jnp.float32),
        in_specs=[VMEM] * 2, out_specs=VMEM, interpret=True)(a, b)


def _host(entry, *arrays_and_ints):
    """csrc/gather_probe3_kernel.cu's lane loops built as host C++ (the
    card runs the same code per thread); returns the filled output (the
    third array)."""
    lib = ctypes.CDLL(shared_lib(
        gp3.SRC, "libgather_probe3_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    args, keep = [], []
    for a in arrays_and_ints:
        if isinstance(a, np.ndarray):
            a = np.ascontiguousarray(a)
            keep.append(a)
            args.append(ctypes.c_void_p(a.ctypes.data))
        else:
            args.append(ctypes.c_int(a))
    assert fn(*args) == 0
    return keep[2]


def _dg_inputs(kind, S, L, axis, seed):
    """gather_probe3.dg_inputs as numpy: the probe's table, a spread one,
    or adds that wrap both ways in int32."""
    return tuple(a.numpy() for a in gp3.dg_inputs(kind, S, L, axis, seed))


SHAPES = [(8, 16, 0), (32, 16, 0), (8, 64, 1)]     # B8, B32, C512, cut


@pytest.mark.parametrize("kind", ["probe", "spread", "wrap"])
@pytest.mark.parametrize("S,L,axis", SHAPES)
def test_dg_plain_and_lanes_match_pallas(S, L, axis, kind):
    tab, kk = _dg_inputs(kind, S, L, axis, seed=S + L + axis)
    want = np.asarray(pl_dg(jnp.asarray(tab), jnp.asarray(kk), axis, STEPS))
    assert_same(want, gp3.dg_plain(T(tab), T(kk), STEPS, axis), "dg")
    assert_same(want, _host("gp3_dg_host", tab, kk, np.zeros_like(kk), S, L,
                            STEPS, axis), "dg lanes")


@pytest.mark.parametrize("steps", [0, 1, 37, 512])
@pytest.mark.parametrize("kind", gp3.CT_KINDS)
@pytest.mark.parametrize("S,L,axis", SHAPES)
def test_dg_doubling_lanes_match_pallas(S, L, axis, kind, steps):
    """gp3_dg as the card computes it (gp3_dg_double_host: the line's map
    T, T^(2^b) by squaring, the state taking it for each set bit of steps,
    as the warp design at hi 8 and 32 and the block design at hi 64 do)
    against dg_probe's kernel in interpret mode and the plain version."""
    tab, kk = _dg_inputs(kind, S, L, axis, seed=S * L + steps)
    want = np.asarray(pl_dg(jnp.asarray(tab), jnp.asarray(kk), axis, steps))
    assert_same(want, gp3.dg_plain(T(tab), T(kk), steps, axis), "dg")
    assert_same(want, _host("gp3_dg_double_host", tab, kk, np.zeros_like(kk),
                            S, L, steps, axis), "dg doubling lanes")


@pytest.mark.parametrize("S,L,axis", SHAPES)
def test_dg_spread_chains_move_and_meet_both_clip_ends(S, L, axis):
    """The spread table keeps chains moving (the probe's saturates them),
    and over the steps chains sit at 0 and at hi - 1."""
    hi = (S, L)[axis]
    seen_lo = seen_hi = False
    for kind in ("probe", "spread"):
        tab, kk = (T(x) for x in _dg_inputs(kind, S, L, axis, seed=9))
        k = kk
        for _ in range(STEPS):
            k2 = gp3.dg_plain(tab, k, 1, axis)
            moved = float((k2 != k).float().mean())
            if kind == "spread":
                seen_lo |= bool((k2 == 0).any())
                seen_hi |= bool((k2 == hi - 1).any())
            k = k2
        if kind == "probe":
            assert bool((k == hi - 1).float().mean() > 0.9)
        else:
            assert moved > 0.2, moved
    assert seen_lo and seen_hi


def _ct_one_buffer(tab, kk, steps):
    """gp3_ct's step done in place in one buffer, row-major: the mix of old
    and new kk a block without the second buffer could read."""
    N = tab.shape[0]
    k = kk.astype(np.int64).copy()
    for _ in range(steps):
        for i in range(N):
            for j in range(N):
                m = k[i, j]
                k[i, j] = min(max(m + tab[m, k[m, i]], 0), N - 1)
    return k.astype(np.int32)


@pytest.mark.parametrize("kind", ["probe", "spread", "wrap"])
def test_ct_plain_and_lanes_match_pallas(kind):
    N = 16
    tab, kk = _dg_inputs(kind, N, N, 1, seed=13)
    want = np.asarray(pl_ct(jnp.asarray(tab), jnp.asarray(kk), STEPS))
    assert_same(want, gp3.ct_plain(T(tab), T(kk), STEPS), "ct")
    assert_same(want, _host("gp3_ct_host", tab, kk, np.zeros_like(kk), N,
                            STEPS, 1), "ct lanes")
    if kind == "spread":
        mixed = _ct_one_buffer(tab, kk, STEPS)
        assert (mixed != want).any(), "the input shows no cross-row read"


def test_chains_with_no_steps_return_their_input():
    tab, kk = _dg_inputs("spread", 16, 16, 1, seed=3)
    for axis in (0, 1):
        assert_same(kk, gp3.dg_plain(T(tab), T(kk), 0, axis), "dg 0")
        assert_same(kk, _host("gp3_dg_host", tab, kk, np.zeros_like(kk), 16,
                              16, 0, axis), "dg lanes 0")
    assert_same(kk, gp3.ct_plain(T(tab), T(kk), 0), "ct 0")
    assert_same(kk, _host("gp3_ct_host", tab, kk, np.zeros_like(kk), 16, 0,
                          1), "ct lanes 0")


@pytest.mark.parametrize("W,n", [(8, 8), (3, 13)])
def test_col0_plain_and_lanes_match_pallas(W, n):
    rng = np.random.default_rng(W)
    R = 1000
    tab = rng.integers(-(1 << 31), 1 << 31, (R, W),
                       dtype=np.int64).astype(np.int32)
    k = rng.integers(0, R, n, dtype=np.int32)
    k[:2] = (0, R - 1)
    want = np.asarray(pl_d2(jnp.asarray(tab), jnp.asarray(k)))
    assert_same(want, col0.plain(T(tab), T(k)), "col0")
    assert_same(want, _host("gp3_col0_host", tab, k, np.zeros_like(k), n, W),
                "col0 lanes")


@pytest.mark.parametrize("W", [1, 3, 8])
@pytest.mark.parametrize("N", [1, 8, 33, 1024])
def test_col0_shared_lane_loop_matches_pallas(N, W):
    """The one lane loop of csrc/col0.cuh, which gp3_col0 and gp2_col0
    both launch, built for the host through this library's entry, at one
    lane, the probe's 8, past a warp and 1024 lanes; k at R - 1 and 0."""
    tab, k = col0_edge_inputs(N, W)
    want = np.asarray(pl_d2(jnp.asarray(tab), jnp.asarray(k)))
    assert_same(want, col0.plain(T(tab), T(k)), "col0")
    assert_same(want, _host("gp3_col0_host", tab, k, np.zeros_like(k), N, W),
                "col0 lanes")


def _mm_inputs(kind, seed, M=24, K=40, N=16):
    rng = np.random.default_rng(seed)
    if kind == "integer":
        a = rng.integers(-8, 9, (M, K)).astype(np.float32)
        b = rng.integers(-8, 9, (K, N)).astype(np.float32)
    else:
        a = rng.standard_normal((M, K)).astype(np.float32)
        b = rng.standard_normal((K, N)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("kind", ["integer", "normal"])
def test_mm_plain_and_lanes_match_pallas(kind):
    reps, rows = 9, 8
    a, b = _mm_inputs(kind, seed=17)
    want = np.asarray(pl_e2(jnp.asarray(a), jnp.asarray(b), reps, rows))
    plain = gp3.mm_plain(T(a), T(b), reps, rows)
    lanes = _host("gp3_mm_host", a, b, np.zeros((rows, b.shape[1]),
                                                np.float32),
                  rows, a.shape[1], b.shape[1], reps)
    exact = gp3.mm_exact(T(a), T(b), reps, rows)
    assert exact == (kind == "integer")
    if exact:
        assert_same(want, plain, "mm")
        assert_same(want, lanes, "mm lanes")
    else:
        tol = gp3.mm_tolerance(T(a), T(b), reps, rows)
        assert 0 < tol < 1e-2
        for got in (plain.numpy(), lanes):
            assert np.abs(got.astype(np.float64) - want).max() <= tol


@pytest.mark.parametrize("M,K,N,rows", [(8, 5, 7, 8), (24, 40, 16, 8),
                                        (13, 640, 300, 13),
                                        (8, 2000, 128, 8)])
@pytest.mark.parametrize("kind", ["integer", "normal"])
def test_mm_lanes_split_k_against_plain(kind, M, K, N, rows):
    """gp3_mm_host runs the card's order: K in MM_CS x MM_G chunks (empty
    ones where K is smaller), each summed by FMA in k order, the chunks
    added in order, then the 64 adds.  Exact on integer-valued inputs,
    within mm_tolerance on normal ones, the same bits on a second call."""
    a, b = _mm_inputs(kind, seed=K + N, M=M, K=K, N=N)
    plain = gp3.mm_plain(T(a), T(b), 64, rows).numpy().astype(np.float64)

    def lanes():
        return _host("gp3_mm_host", a, b, np.zeros((rows, N), np.float32),
                     rows, K, N, 64)
    got = lanes()
    assert np.array_equal(got.view(np.int32), lanes().view(np.int32))
    assert gp3.mm_exact(T(a), T(b), 64, rows) == (kind == "integer")
    if kind == "integer":
        assert_same(plain.astype(np.float32), got, "mm lanes")
    else:
        err = np.abs(got.astype(np.float64) - plain).max()
        assert err <= gp3.mm_tolerance(T(a), T(b), 64, rows)


def test_mm_adds_in_order_not_by_a_multiple():
    """64 rounded additions of m are not 64 * m: a value whose sums round
    tells them apart, and plain, lanes and Pallas all add."""
    a = np.zeros((8, 1), np.float32)
    b = np.zeros((1, 1), np.float32)
    a[0, 0], b[0, 0] = 1.0, np.float32(1 / 3)
    want = np.asarray(pl_e2(jnp.asarray(a), jnp.asarray(b), 64, 8))
    assert want[0, 0] != np.float32(64) * np.float32(1 / 3)
    assert_same(want, gp3.mm_plain(T(a), T(b)), "mm adds")
    assert_same(want, _host("gp3_mm_host", a, b, np.zeros((8, 1), np.float32),
                            8, 1, 1, 64), "mm lanes adds")


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    tab, kk = (T(x) for x in _dg_inputs("spread", 16, 16, 1, seed=5))
    k = T(np.arange(8, dtype=np.int32))
    a, b = (T(x) for x in _mm_inputs("integer", seed=6))
    names = ("launches_dg", "launches_ct", "launches_col0", "launches_mm")
    before = [getattr(gp3, n) for n in names]
    for axis in (0, 1):
        assert torch.equal(gp3.gp3_dg(tab, kk, STEPS, axis),
                           gp3.dg_plain(tab, kk, STEPS, axis))
    assert torch.equal(gp3.gp3_ct(tab, kk, STEPS),
                       gp3.ct_plain(tab, kk, STEPS))
    assert torch.equal(gp3.gp3_col0(tab, k), col0.plain(tab, k))
    assert torch.equal(gp3.gp3_mm(a, b), gp3.mm_plain(a, b))
    assert [getattr(gp3, n) for n in names] == before
    with pytest.raises(ValueError):
        gp3.dg_plain(tab, kk + 16, 1, 0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    tab, kk = (T(x) for x in _dg_inputs("spread", 16, 16, 1, seed=7))
    k = T(np.arange(8, dtype=np.int32))
    a, b = (T(x) for x in _mm_inputs("normal", seed=8))
    good = {"dg": (gp3._prep_dg, dict(tab=tab, kk=kk, steps=2, axis=1)),
            "ct": (gp3._prep_ct, dict(tab=tab, kk=kk, steps=2)),
            "col0": (lambda tab, k: col0.prep("gp3_col0", tab, k),
                     dict(tab=tab, k=k)),
            "mm": (gp3._prep_mm, dict(a=a, b=b, reps=64, rows=8))}
    for fn, kw in good.values():
        out, _ = fn(**kw)
        assert out.dtype == (torch.float32 if "a" in kw else torch.int32)
    wide = torch.zeros((1, gp3.SMEM_MAX // 4 + 1), dtype=torch.int32)
    big = torch.zeros((140, 140), dtype=torch.int32)
    bad = [("dg", dict(tab=tab.to(torch.int64))),
           ("dg", dict(kk=kk[:8])),
           ("dg", dict(kk=kk.t())),
           ("dg", dict(axis=2)),
           ("dg", dict(steps=-1)),
           ("dg", dict(tab=wide, kk=wide.clone())),
           ("ct", dict(tab=tab[:8].contiguous(), kk=kk[:8].contiguous())),
           ("ct", dict(tab=big, kk=big.clone())),
           ("ct", dict(steps=-1)),
           ("col0", dict(k=k.reshape(2, 4))),
           ("col0", dict(k=k.to(torch.int64))),
           *(("col0", c) for c in col0_bad_inputs(
               T(np.arange(64, dtype=np.int32).reshape(16, 4)), k)),
           ("mm", dict(a=a.double())),
           ("mm", dict(b=b[:-1].contiguous())),
           ("mm", dict(rows=a.shape[0] + 1)),
           ("mm", dict(b=b.t()))]
    for name, change in bad:
        fn, kw = good[name]
        with pytest.raises(ValueError):
            fn(**(kw | change))
