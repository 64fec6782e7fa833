"""The gather-strategy probe of bwamem_tpu_torch (ops/gather_probe) on the
CPU.  The four Pallas kernel bodies of the reference's
tools/pl_gather_probe.py (:65-157), copied here with N, STEPS and R as
parameters, run under pl.pallas_call(..., interpret=True) at a small size,
and each plain version must equal its kernel exactly; so must the lane
loops of csrc/gather_probe_kernel.cu, built for the host (gp_scalar's and
gp_scalar2's one pass, held against kernel_scalar's and kernel_scalarw's
STEPS passes in interpret mode, gp_scalar2 at even and odd row widths with
its 8-byte and its two 4-byte loads, gp_take_ax0's two designs (a thread
an element, step by step, and the column's map taken once as 16 + 1 bits
a row) on every kind of ops/gather_probe.take_inputs, and gp_onehot's
gather
with its bf16 rounding in integer arithmetic, held against the one-hot
product in interpret mode).
The edge cases: table values near 2^31 (the int32 wrap, and the sign of
the remainder of the take), values up to 2^23 for the bf16 rounding of the
one-hot product, and k outside [0, A * 128) there (ops/gather_probe
.onehot_inputs, the inputs chip_smoke.py holds the kernel on too)."""
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
from bwamem_tpu_torch.ops import gather_probe as gp

from torch_port_util import T, assert_same

R, N, STEPS = 1024, 256, 3
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _call(kernel, out_shape, *args):
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.int32),
        in_specs=[VMEM, VMEM], out_specs=VMEM, interpret=True)(*args)


def pl_scalar(tab, k, n, steps):
    """kernel_scalar (tools/pl_gather_probe.py:65-75)."""
    def kernel_scalar(tab_ref, k_ref, o_ref):
        def step(t, _):
            def lane(q, _):
                i, j = q // 128, q % 128
                r = k_ref[i, j]
                v = tab_ref[r, j]          # scalar load, dynamic row
                o_ref[i, j] = v
                return 0
            jax.lax.fori_loop(0, n, lane, 0)
            return 0
        jax.lax.fori_loop(0, steps, step, 0)
    return _call(kernel_scalar, (n // 128, 128), tab, k)


def pl_scalarw(tabw, k, n, steps):
    """kernel_scalarw (:93-102)."""
    def kernel_scalarw(tab_ref, k_ref, o_ref):
        def step(t, _):
            def lane(q, _):
                i, j = q // 128, q % 128
                r = k_ref[i, j]
                o_ref[i, j] = tab_ref[r, 0] + tab_ref[r, 1]
                return 0
            jax.lax.fori_loop(0, n, lane, 0)
            return 0
        jax.lax.fori_loop(0, steps, step, 0)
    return _call(kernel_scalarw, (n // 128, 128), tabw, k)


def pl_mm(tab3, k, n):
    """kernel_mm (:120-134)."""
    S, A = n // 128, tab3.shape[0]

    def kernel_mm(tab_ref, k_ref, o_ref):
        kk = k_ref[:]                       # [S, 128]
        hi = (kk >> 7).reshape(n, 1)        # [N, 1]
        lo = kk & 127                       # [S, 128]
        oh = (hi == jax.lax.broadcasted_iota(jnp.int32, (n, A), 1))
        m1 = jax.lax.dot_general(
            oh.astype(jnp.bfloat16), tab_ref[:].astype(jnp.bfloat16),
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32)   # [N, 128]
        m1 = m1.reshape(S, 128, 128)
        sel = (lo[:, :, None] ==
               jax.lax.broadcasted_iota(jnp.int32, (S, 128, 128), 2))
        o_ref[:] = jnp.where(sel, m1, 0).sum(2).astype(jnp.int32)
    return _call(kernel_mm, (S, 128), tab3, k)


def pl_dg(tab, kfull, r, steps):
    """kernel_dg (:151-157); the `if False` branch of :153-154 leaves kk."""
    def kernel_dg(tab_ref, k_ref, o_ref):
        def step(t, kk):
            g = jnp.take_along_axis(tab_ref[:], kk, axis=0)
            return (kk + g) % r
        kk = k_ref[:]
        o_ref[:] = jax.lax.fori_loop(0, steps, step, kk)
    return _call(kernel_dg, (r, 128), tab, kfull)


def _inputs(seed, lo=0, hi=1 << 20, r=R, n=N, w=8):
    rng = np.random.default_rng(seed)
    tab = rng.integers(lo, hi, (r, 128), dtype=np.int64).astype(np.int32)
    tabw = rng.integers(lo, hi, (r, w), dtype=np.int64).astype(np.int32)
    k = rng.integers(0, r, (n // 128, 128), dtype=np.int32)
    kfull = np.zeros((r, 128), np.int32)
    kfull[:n // 128] = k
    return tab, tabw, k, kfull


def _host(entry, *arrays_and_ints, rc=0):
    """csrc/gather_probe_kernel.cu's lane loops built as host C++ (the card
    runs the same code per thread); returns the filled output array after
    checking that the entry returned `rc`."""
    lib = ctypes.CDLL(shared_lib(
        gp.SRC, "libgather_probe_kernel_host.so",
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
    assert fn(*args) == rc
    return keep[2]


# ---- plain versions against the Pallas bodies ----

@pytest.mark.parametrize("lo,hi", [(0, 1 << 20), (-(1 << 31), 1 << 31)])
def test_scalar_plain_matches_pallas(lo, hi):
    tab, _, k, _ = _inputs(1, lo, hi)
    want = pl_scalar(jnp.asarray(tab), jnp.asarray(k), N, STEPS)
    assert_same(want, gp.scalar_plain(T(tab), T(k)), "scalar")
    # the kernel's one pass, built for the host, against STEPS > 1 passes
    assert STEPS > 1
    assert_same(want, _host("gp_scalar_host", tab, k, np.zeros_like(k), N),
                "gp_scalar lanes")


@pytest.mark.parametrize("lo,hi", [(0, 1 << 20), ((1 << 31) - 64, 1 << 31),
                                   (-(1 << 31), 1 << 31)])
def test_scalar2_plain_matches_pallas(lo, hi):
    _, tabw, k, _ = _inputs(2, lo, hi)
    want = pl_scalarw(jnp.asarray(tabw), jnp.asarray(k), N, STEPS)
    if lo > 0:                          # every sum wraps
        assert (np.asarray(want) < 0).all()
    assert_same(want, gp.scalar2_plain(T(tabw), T(k)), "scalar2")


@pytest.mark.parametrize("w", [2, 3, 7, 8])
def test_scalar2_one_pass_lanes_match_pallas(w):
    """gp_scalar2's one pass, built for the host, against kernel_scalarw's
    STEPS passes at an odd and an even row width (odd: two 4-byte loads;
    even: the 8-byte load too), with sums that wrap."""
    _, tabw, k, _ = _inputs(9, (1 << 31) - 64, 1 << 31, w=w)
    want = pl_scalarw(jnp.asarray(tabw), jnp.asarray(k), N, STEPS)
    assert (np.asarray(want) < 0).all()             # every sum wraps
    for pair in ((0, 1) if w % 2 == 0 else (0,)):
        assert_same(want, _host("gp_scalar2_host", tabw, k, np.zeros_like(k),
                                N, w, pair), f"gp_scalar2 lanes W={w}")


@pytest.mark.parametrize("case", ["probe", "bf16_rounding", "k_outside"])
def test_onehot_plain_matches_pallas(case):
    A = R // 128
    tab3, k = gp.onehot_inputs(case, A, N)
    want = pl_mm(jnp.asarray(tab3), jnp.asarray(k), N)
    got = gp.onehot_plain(T(tab3), T(k))
    assert_same(want, got, f"onehot {case}")
    # the kernel's lane (one load, bf16 rounding by integer arithmetic),
    # built for the host, against the same product
    assert_same(want, _host("gp_onehot_host", tab3, k, np.zeros_like(k), N,
                            A), f"gp_onehot lanes {case}")
    if case == "bf16_rounding":           # bf16 keeps 8 bits: most round
        assert (np.asarray(want) != tab3[k >> 7, k & 127]).mean() > 0.5
    if case == "k_outside":
        assert (np.asarray(got)[1] == 0).all()
        # and k at both ends of the table and of int32, no product needed
        tab3, k = gp.onehot_inputs("k_extremes", A, N)
        assert_same(gp.onehot_plain(T(tab3), T(k)),
                    _host("gp_onehot_host", tab3, k, np.zeros_like(k), N, A),
                    "gp_onehot lanes k_extremes")


@pytest.mark.parametrize("lo,hi,steps", [(0, 1 << 20, STEPS),
                                         ((1 << 31) - 4096, 1 << 31, 4),
                                         (-(1 << 31), 1 << 31, 4)])
def test_take_ax0_plain_matches_pallas(lo, hi, steps):
    tab, _, _, kfull = _inputs(4, lo, hi)
    want = pl_dg(jnp.asarray(tab), jnp.asarray(kfull), R, steps)
    got = gp.take_ax0_plain(T(tab), T(kfull), steps)
    assert_same(want, got, "take_ax0")
    assert (got >= 0).all() and (got < R).all()


# ---- the kernel source's lane loops, built for the host ----

@pytest.mark.parametrize("lo,hi", [(0, 1 << 20), (-(1 << 31), 1 << 31)])
def test_kernel_source_scalar_lanes_match_plain(lo, hi):
    tab, tabw, k, _ = _inputs(5, lo, hi)
    assert_same(gp.scalar_plain(T(tab), T(k)),
                _host("gp_scalar_host", tab, k, np.zeros_like(k), N),
                "gp_scalar lanes")
    assert_same(gp.scalar2_plain(T(tabw), T(k)),
                _host("gp_scalar2_host", tabw, k, np.zeros_like(k), N, 8, 1),
                "gp_scalar2 lanes")


@pytest.mark.parametrize("lo,hi,steps", [(0, 1 << 20, 5),
                                         ((1 << 31) - 4096, 1 << 31, 4),
                                         (-(1 << 31), 1 << 31, 4),
                                         (0, 1 << 20, 0)])
def test_kernel_source_take_lanes_match_plain(lo, hi, steps):
    tab, _, _, kfull = _inputs(6, lo, hi)
    want = gp.take_ax0_plain(T(tab), T(kfull), steps)
    assert_same(want, _host("gp_take_ax0_host", tab, kfull,
                            np.zeros_like(kfull), R, steps), "take lanes")


# ---- gp_take_ax0 as the card runs it ----

# the last R whose column map fits a block's shared memory (the kernel's
# take_col_smem: 16 bits a row and a bitmap of bit 16, R rounded up to 32)
TAKE_COL_R_MAX = 109376


@pytest.mark.parametrize("steps", [0, 1, 5, 16])
@pytest.mark.parametrize("kind", gp.TAKE_KINDS)
def test_take_ax0_lanes_match_pallas(kind, steps):
    """The two designs the C entry takes, built for the host: the column
    design (gp_take_ax0_lanes_host: the column's map in shared memory, 16
    low bits and a bitmap of bit 16, through a scratch laid out as the
    card's) and, past its R, a thread an element (gp_take_ax0_host),
    against kernel_dg in interpret mode and the plain version, on every
    input kind after 0, 1, 5 and the probe's 16 steps."""
    tab, kk = (a.numpy() for a in gp.take_inputs(kind, R, N, seed=10))
    want = np.asarray(pl_dg(jnp.asarray(tab), jnp.asarray(kk), R, steps))
    assert_same(want, gp.take_ax0_plain(T(tab), T(kk), steps),
                f"take_ax0 {kind}")
    assert_same(want, _host("gp_take_ax0_lanes_host", tab, kk,
                            np.zeros_like(kk), R, steps),
                f"take lanes, the column design, {kind}")
    assert_same(want, _host("gp_take_ax0_host", tab, kk, np.zeros_like(kk),
                            R, steps),
                f"take lanes, a thread an element, {kind}")


def test_take_ax0_column_map_keeps_bit_16():
    """Past R = 2^16 the column design's map needs its bitmap of bit 16:
    R = 65600 on the spread input, against kernel_dg in interpret mode and
    the plain version."""
    r2, steps = 65600, 2
    tab, kk = (a.numpy() for a in gp.take_inputs("spread", r2, N, seed=12))
    want = np.asarray(pl_dg(jnp.asarray(tab), jnp.asarray(kk), r2, steps))
    assert (want >= 1 << 16).sum() > 1000        # states past 16 bits
    assert_same(want, gp.take_ax0_plain(T(tab), T(kk), steps), "take_ax0")
    assert_same(want, _host("gp_take_ax0_lanes_host", tab, kk,
                            np.zeros_like(kk), r2, steps),
                "take lanes, the column design")


def test_take_ax0_column_design_ends_where_its_map_stops_fitting():
    """The library alone sizes the scratch and so picks the design:
    gp_take_ax0_scratch_words gives the column design's 324 words a row (R
    rounded up to 32) up to TAKE_COL_R_MAX and 0 past it (and at R 0),
    where the C entry takes a thread an element and the host build
    refuses the column design."""
    lib = ctypes.CDLL(shared_lib(
        gp.SRC, "libgather_probe_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    words = lib.gp_take_ax0_scratch_words
    words.restype = ctypes.c_longlong
    for r in (1, 31, 32, 33, 1000, 78208, TAKE_COL_R_MAX):
        assert words(r) == 324 * ((r + 31) // 32 * 32)
    assert words(TAKE_COL_R_MAX + 1) == 0 and words(0) == 0
    one = np.zeros((1, 128), np.int32)
    _host("gp_take_ax0_lanes_host", one, one, one.copy(),
          TAKE_COL_R_MAX + 1, 0, rc=1)
    r = TAKE_COL_R_MAX
    big = np.zeros((r, 128), np.int32)
    big[:, 0] = np.arange(r)
    assert_same(big, _host("gp_take_ax0_lanes_host", one.repeat(r, 0), big,
                           np.zeros_like(big), r, 0),
                "the column design at its last R, 0 steps")


# ---- the wrappers ----

def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    tab, tabw, k, kfull = (T(a) for a in _inputs(7))
    tab3 = tab[:R // 128]
    names = ("launches_scalar", "launches_scalar2", "launches_onehot",
             "launches_take")
    before = [getattr(gp, n) for n in names]
    assert torch.equal(gp.gp_scalar(tab, k), gp.scalar_plain(tab, k))
    assert torch.equal(gp.gp_scalar2(tabw, k), gp.scalar2_plain(tabw, k))
    assert torch.equal(gp.gp_onehot(tab3, k), gp.onehot_plain(tab3, k))
    assert torch.equal(gp.gp_take_ax0(tab, kfull, STEPS),
                       gp.take_ax0_plain(tab, kfull, STEPS))
    assert [getattr(gp, n) for n in names] == before


def test_wrappers_reject_what_the_kernels_do_not_take():
    tab, tabw, k, kfull = (T(a) for a in _inputs(8))
    good = {"scalar": (gp._prep_scalar, dict(tab=tab, k=k)),
            "scalar2": (gp._prep_scalar2, dict(tab=tabw, k=k)),
            "onehot": (gp._prep_onehot, dict(tab3=tab[:8], k=k)),
            "take": (gp._prep_take, dict(tab=tab, kk=kfull, steps=2))}
    for fn, kw in good.values():
        out, args = fn(**kw)
        assert out.shape == next(v for n, v in kw.items()
                                 if n in ("k", "kk")).shape
    # gp_scalar2 takes odd widths and a table off an 8-byte boundary (its
    # kernel then loads the two words apart)
    for tw in (tabw[:, :3].contiguous(),
               tabw.reshape(-1)[1:9 * 8 + 1].reshape(9, 8)):
        assert gp._prep_scalar2(tw, k)[1][-1] == tw.shape[1]
    bad = [("scalar", dict(tab=tab.to(torch.int64))),
           ("scalar", dict(tab=tab[:, :64])),
           ("scalar", dict(k=k[:, :64].contiguous())),
           ("scalar", dict(k=k.t())),
           ("scalar", dict(k=k.reshape(-1))),
           ("scalar2", dict(tab=tabw[:, :1].contiguous())),
           ("scalar2", dict(tab=tabw[:, :1])),
           ("scalar2", dict(k=k.to(torch.int64))),
           ("onehot", dict(tab3=tab[:0])),
           ("onehot", dict(k=k.to(torch.float32))),
           ("take", dict(kk=kfull[:-1])),
           ("take", dict(kk=kfull[:, :64].contiguous())),
           ("take", dict(steps=-1))]
    for name, change in bad:
        fn, kw = good[name]
        with pytest.raises(ValueError):
            fn(**(kw | change))
