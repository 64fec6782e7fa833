"""The int32-rate kernel of bwamem_tpu_torch (ops/int_rate) on the CPU:
csrc/int_rate_kernel.cu built as host C++ must give, for each mix, the
words of its plain PyTorch version, and the plain C definitions of the DPX
intrinsics (csrc/dpx.cuh, which every kernel of the extension row's
recurrence uses) must match the intrinsics' semantics on edge values: the
32-bit add wraps, and each 16-bit half of the 16x2 forms adds and wraps on
its own, with no carry into the other half."""
import ctypes

import numpy as np
import pytest
import torch

from bwamem_tpu_torch._build import shared_lib
from bwamem_tpu_torch.ops import int_rate


def _lib():
    return ctypes.CDLL(shared_lib(
        int_rate.SRC, "libint_rate_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))


@pytest.mark.parametrize("mix", int_rate.MIXES)
@pytest.mark.parametrize("seed", [0, -3, 123456789])
def test_host_build_matches_plain(mix, seed):
    n, iters = 300, 3
    out = np.zeros(n, np.int32)
    assert _lib().int_rate_host(ctypes.c_void_p(out.ctypes.data), n, iters,
                                seed, int_rate.MIXES.index(mix)) == 0
    want = int_rate.plain(mix, n, iters, seed)
    np.testing.assert_array_equal(out, want.numpy())
    assert len(np.unique(out)) > n // 4      # the chains did not collapse


def _s16(x):
    return (x & 0xFFFF) - ((x & 0x8000) << 1)


def _dpx(op, a, b, c):
    """The intrinsics' functions in Python on 32-bit words."""
    w32 = lambda v: (v + (1 << 31)) % (1 << 32) - (1 << 31)   # noqa: E731
    if op < 2:
        m = max(w32(a + b), c)
        return max(m, 0) if op == 1 else m
    out = 0
    for sh in (0, 16):
        ha, hb, hc = (_s16((v % (1 << 32)) >> sh) for v in (a, b, c))
        m = max(_s16(ha + hb), hc)
        if op == 3:
            m = max(m, 0)
        out |= (m & 0xFFFF) << sh
    return w32(out)


EDGES = [(0x7FFFFFFF, 1, 0), (-0x80000000, -1, 5), (-9, 3, -20),
         (0x00007FFF, 0x00000001, 0x00000000), (0x0000FFFF, 1, 0x7FFF0000),
         (0x7FFF8000, 0x00018000, -0x10000), (0x12345678, 0x6DCBA988, 0),
         (0x0005FFFC, 0x0001FFFD, 0), (-1, -1, -1)]


@pytest.mark.parametrize("op", range(4))
def test_dpx_definitions_on_edge_values(op):
    lib = _lib()
    for a, b, c in EDGES:
        assert lib.dpx_host(op, a, b, c) == _dpx(op, a, b, c), (op, a, b, c)
    # the low half's 0x7FFF + 1 wraps to -0x8000 (c is -0x8000 in both
    # halves) and does not carry into the high half, which stays 0
    assert lib.dpx_host(2, 0x00007FFF, 1, -0x7FFF8000) == 0x8000


def test_run_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    before = int_rate.launches
    got = int_rate.run("cell_dpx", 1, 2, seed=4, device="cpu")
    assert torch.equal(got, int_rate.plain("cell_dpx", int_rate.THREADS, 2,
                                           seed=4))
    assert int_rate.launches == before
    assert int_rate.ops_per_thread("alu", 10) == 1.5 * 8 * 16 * 10
    with pytest.raises(ValueError):
        int_rate.run("fma", 1, 2, device="cpu")
