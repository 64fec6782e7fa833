"""The dispatch probe's kernel of bwamem_tpu_torch (ops/dispatch_probe) on
the CPU.  The reference's own probe, tools/dispatch_probe.py, is loaded
and make_kernel(L1p, ROWS, B) runs under pl.pallas_call(...,
interpret=True); the plain version and every plan of the kernel's design
(csrc/rows.cuh: rows a thread, lanes a thread, 32-bit cells or two 16-bit
cells a word), built for the host from csrc/dispatch_probe_kernel.cu with
the DPX add-maxes by their plain C definitions, must equal it exactly.
The TPU script tiles 128 lanes, so a B that is not a multiple of 128 runs
there with extra lanes (lanes are independent) that are then cut.
The plans are held on the probe's inputs (bases in [0, 4)) and on the
match input of tools/torch_dispatch_probe.draw (each lane's bases mostly
one base, so eh climbs), and on inputs that match everywhere, where eh
grows by one a row, up to the 16-bit cells' limit."""
import ctypes
import importlib.util
import sys
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
sys.path.insert(0, str(REPO / "tools"))
from torch_dispatch_probe import draw  # noqa: E402

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


def _host(qT, tT, p=None):
    """csrc/dispatch_probe_kernel.cu's threads built as host C++, at plan p
    (None: the shipped plan)."""
    lib = ctypes.CDLL(shared_lib(
        dp.SRC, "libdispatch_probe_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    (L1p, B), rows = qT.shape, tT.shape[0]
    p = dp.plan(L1p, rows, B) if p is None else p
    out = np.zeros_like(qT)
    ptr = [ctypes.c_void_p(a.ctypes.data) for a in (qT, tT, out)]
    assert lib.dp_eh_host(*ptr, L1p, rows, B, *p[:3]) == 0
    return out


# every plan the kernel takes (threads a block do not change the result)
PLANS = [dp.Plan(rpt, lpt, bits, 256, 8) for bits in dp.BITS
         for rpt in dp.RPTS for lpt in dp.LPTS if bits == 32 or rpt > 1]
_REFERENCE = {}


@pytest.mark.parametrize("p", PLANS, ids=lambda p: f"{p.rpt}x{p.lpt}-"
                         f"{p.bits}")
@pytest.mark.parametrize("kind", ["probe", "match"])
@pytest.mark.parametrize("B", [256, 96])
@pytest.mark.parametrize("ROWS", [1, 8, 33])
def test_plain_and_lanes_match_pallas(monkeypatch, ROWS, B, kind, p):
    """L1p 21 is no multiple of 2, 4, 8 or 16 rows a thread; ROWS 1 and 33
    no multiple of the 4 target rows loaded ahead.  On the probe's input
    (tools/torch_dispatch_probe.draw) eh falls to 0 within a few steps;
    on its match input eh climbs, so out depends on every target row."""
    L1p = 21
    Bp = -(-B // TB) * TB
    if (ROWS, B, kind) not in _REFERENCE:
        qT, tT = draw(ROWS + B, L1p, Bp, ROWS, kind)
        want = np.asarray(_tpu_kernel(monkeypatch, L1p, ROWS, Bp)(qT, tT))
        _REFERENCE[ROWS, B, kind] = [np.ascontiguousarray(x[:, :B])
                                     for x in (qT, tT, want)]
    qT, tT, want = _REFERENCE[ROWS, B, kind]
    if kind == "match" and ROWS == 33:
        assert want.mean() > 8 + ROWS / 4
    assert_same(want, dp.dp_eh_plain(T(qT), T(tT)), "dp plain")
    assert_same(want, _host(qT, tT, p), f"dp {p}")


@pytest.mark.parametrize("p", [None, *PLANS[::3]],
                         ids=lambda p: "shipped" if p is None else
                         f"{p.rpt}x{p.lpt}-{p.bits}")
@pytest.mark.parametrize("B", [7, 8])
def test_matching_rows_grow_by_one_a_row(p, B):
    """B 7 is no multiple of 4 lanes a thread: there a plan takes one lane
    a thread, as plan() does."""
    L1p, ROWS = 20, 40
    if p is not None and B % p.lpt:
        p = p._replace(lpt=1)
    qT = np.zeros((L1p, B), np.int32)
    tT = np.zeros((ROWS, B), np.int32)
    want = (np.arange(L1p) * 3 % 17)[:, None] + ROWS + np.zeros((1, B), int)
    assert_same(want, dp.dp_eh_plain(T(qT), T(tT)), "dp plain")
    assert_same(want, _host(qT, tT, p), f"dp {p}")
    assert_same(np.arange(L1p)[:, None] * 3 % 17 + np.zeros((1, B), int),
                _host(qT, tT[:0], p), "no rows")


@pytest.mark.parametrize("rpt", [2, 4, 16])
def test_sixteen_bit_cells_stay_exact_to_their_limit(rpt):
    """At ROWS_MAX_16 target rows that all match, row 16's eh reaches 16 +
    ROWS = 32767, the top of int16, in the low half of its word and row
    17's 32752 in the high half: neither half carries into the other.
    One row more and a 16-bit plan is refused, and the shipped plan keeps
    32 bits."""
    L1p, ROWS, B = 18, dp.ROWS_MAX_16, 4
    qT = np.zeros((L1p, B), np.int32)
    tT = np.zeros((ROWS, B), np.int32)
    want = (np.arange(L1p) * 3 % 17)[:, None] + ROWS + np.zeros((1, B), int)
    assert want.max() == 32767
    for p in (dp.Plan(rpt, 4, 16, 256, 8), dp.Plan(rpt, 1, 16, 256, 256)):
        dp.check_plan(p, ROWS, B)
        assert_same(want, _host(qT, tT, p), f"dp {p}")
    with pytest.raises(ValueError):
        dp.check_plan(dp.Plan(rpt, 4, 16, 256, 8), ROWS + 1, B)
    assert dp.plan(L1p, ROWS + 1, B).bits == 32


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
    assert out.shape == qT.shape and args[3:] == (16, 5, 40,
                                                  *dp.PLAN_SHORT)
    for q, t in ((qT.to(torch.int64), tT), (qT, tT[:, :8].contiguous()),
                 (qT[:0], tT), (qT.t(), tT), (qT, tT.reshape(-1))):
        with pytest.raises(ValueError):
            dp._prep(q, t)
    for p in (dp.Plan(3, 1, 32, 256, 8), dp.Plan(4, 2, 32, 256, 8),
              dp.Plan(1, 1, 16, 256, 8), dp.Plan(4, 1, 8, 256, 8),
              dp.Plan(4, 1, 32, 1024, 8), dp.Plan(4, 1, 32, 16, 8),
              dp.Plan(4, 1, 32, 256, 0), dp.Plan(4, 1, 32, 256, 24),
              dp.Plan(4, 4, 32, 256, 32)):
        with pytest.raises(ValueError):
            dp._prep(qT, tT, p)
    q2, t2 = (torch.zeros((n, 42), dtype=torch.int32) for n in (16, 5))
    with pytest.raises(ValueError):           # 42 lanes: not 4 a thread
        dp._prep(q2, t2, dp.Plan(4, 4, 32, 256, 8))


def test_plan_keeps_the_shipped_design_where_the_shape_allows(monkeypatch):
    """PLAN past SHORT_ROWS target rows, PLAN_SHORT up to them; one lane a
    thread where B % 4 != 0 or a table is not 16-byte aligned; 32-bit
    cells past ROWS_MAX_16 (checked with PLAN set to 16-bit cells)."""
    assert dp.plan(136, 128, 2048) == dp.PLAN
    assert dp.plan(136, dp.SHORT_ROWS, 2048) == dp.PLAN_SHORT
    assert dp.plan(136, dp.SHORT_ROWS + 1, 2048) == dp.PLAN
    assert dp.PLAN_SHORT.lpt == 4
    assert dp.plan(136, 8, 2046).lpt == 1
    assert dp.plan(136, 8, 2048, aligned=False).lpt == 1
    monkeypatch.setattr(dp, "PLAN", dp.PLAN._replace(bits=16))
    assert dp.plan(136, 128, 2048).bits == 16
    assert dp.plan(136, dp.ROWS_MAX_16 + 1, 2048).bits == 32
    tT = torch.zeros((5, 40), dtype=torch.int32)
    q4 = torch.zeros(4 * 40 + 1, dtype=torch.int32)[1:].view(4, 40)
    assert q4.is_contiguous() and q4.data_ptr() % 16
    out, args = dp._prep(q4, tT)
    assert args[7] == 1                        # lanes a thread
