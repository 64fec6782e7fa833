"""The dispatch probe's kernel of bwamem_tpu_torch (ops/dispatch_probe) on
the CPU.  The reference's own probe, tools/dispatch_probe.py, is loaded
and make_kernel(L1p, ROWS, B) runs under pl.pallas_call(...,
interpret=True); the plain version and the lane loop of
csrc/dispatch_probe_kernel.cu built for the host must equal it exactly.
The TPU script tiles 128 lanes, so a B that is not a multiple of 128 runs
there with extra lanes (lanes are independent) that are then cut.
Besides the probe's inputs (bases in [0, 4)), a lane loop is held on
inputs that match everywhere, where eh grows by one a row."""
import ctypes
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401  (x64 on, as the reference runs)
from jax.experimental import pallas as pl

from bwamem_tpu_torch._build import shared_lib
from bwamem_tpu_torch.ops import dispatch_probe as dp

from torch_port_util import T, assert_same

REPO = Path(__file__).resolve().parent.parent
TB = 128


def _tpu_kernel(monkeypatch, L1p, ROWS, B):
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: real(*a, **(k | {"interpret": True})))
    spec = importlib.util.spec_from_file_location(
        "dispatch_probe_reference", REPO / "tools" / "dispatch_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make_kernel(L1p, ROWS, B)


def _host(qT, tT):
    """csrc/dispatch_probe_kernel.cu's lane loop built as host C++."""
    lib = ctypes.CDLL(shared_lib(
        dp.SRC, "libdispatch_probe_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    out = np.zeros_like(qT)
    ptr = [ctypes.c_void_p(a.ctypes.data) for a in (qT, tT, out)]
    assert lib.dp_eh_host(*ptr, qT.shape[0], tT.shape[0], qT.shape[1]) == 0
    return out


@pytest.mark.parametrize("B", [256, 96])
@pytest.mark.parametrize("ROWS", [1, 8, 33])
def test_plain_and_lanes_match_pallas(monkeypatch, ROWS, B):
    L1p = 24
    Bp = -(-B // TB) * TB
    rng = np.random.default_rng(ROWS + B)
    qT = rng.integers(0, 4, (L1p, Bp)).astype(np.int32)
    tT = rng.integers(0, 4, (ROWS, Bp)).astype(np.int32)
    want = np.asarray(_tpu_kernel(monkeypatch, L1p, ROWS, Bp)(qT, tT))[:, :B]
    qT, tT = (np.ascontiguousarray(x[:, :B]) for x in (qT, tT))
    assert_same(want, dp.dp_eh_plain(T(qT), T(tT)), "dp plain")
    assert_same(want, _host(qT, tT), "dp lanes")


def test_matching_rows_grow_by_one_a_row():
    L1p, ROWS, B = 20, 40, 7
    qT = np.zeros((L1p, B), np.int32)
    tT = np.zeros((ROWS, B), np.int32)
    want = (np.arange(L1p) * 3 % 17)[:, None] + ROWS + np.zeros((1, B), int)
    assert_same(want, dp.dp_eh_plain(T(qT), T(tT)), "dp plain")
    assert_same(want, _host(qT, tT), "dp lanes")
    assert_same(np.arange(L1p)[:, None] * 3 % 17 + np.zeros((1, B), int),
                _host(qT, tT[:0]), "no rows")


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    rng = np.random.default_rng(2)
    qT = T(rng.integers(0, 4, (16, 40)).astype(np.int32))
    tT = T(rng.integers(0, 4, (5, 40)).astype(np.int32))
    before = dp.launches
    assert torch.equal(dp.dp_eh(qT, tT), dp.dp_eh_plain(qT, tT))
    assert dp.launches == before
    assert dp.work(136, 2048, 2048) == (4 * (2 * 136 * 2048 + 2048 * 2048),
                                        4 * 136 * 2048 * 2048)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    qT = torch.zeros((16, 40), dtype=torch.int32)
    tT = torch.zeros((5, 40), dtype=torch.int32)
    out, args = dp._prep(qT, tT)
    assert out.shape == qT.shape and args[3:] == (16, 5, 40)
    for q, t in ((qT.to(torch.int64), tT), (qT, tT[:, :8].contiguous()),
                 (qT[:0], tT), (qT.t(), tT), (qT, tT.reshape(-1))):
        with pytest.raises(ValueError):
            dp._prep(q, t)
