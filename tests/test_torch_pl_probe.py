"""The row-body ablation probe of bwamem_tpu_torch (ops/pl_probe) on the
CPU.  The reference's own probe, tools/pl_probe.py, is loaded with its
shape in sys.argv (it reads B, LQ and ROWS at import) and its kernel runs
under pl.pallas_call(..., interpret=True); for each of its five variants
the plain version and the lane loops of csrc/pl_probe_kernel.cu built for
the host (a thread a lane, and for roll the warp's chunks with the
shuffles spelled out) must equal it exactly.  The TPU script tiles 128
lanes, so a B that is not a multiple of 128 runs there with extra lanes
(lanes are independent) that are then cut.  The reductions the TPU kernel
multiplies by zero reach `aux`, which is held against a numpy computation
of the row body.  Besides the probe's inputs (tools/torch_pl_probe.draw:
bases in [0, 4), on which most states decay to 0 within a few rows), the
cases run on its "match" input (target rows copied from the query along a
diagonal, so that states grow and the reductions see large h)."""
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
from bwamem_tpu_torch.ops import pl_probe as plp

from torch_port_util import T, assert_same

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from torch_pl_probe import draw  # noqa: E402

TB = 128


def _tpu_probe(monkeypatch, B, LQ, ROWS):
    """tools/pl_probe.py loaded at B lanes (a multiple of 128), LQ, ROWS,
    its pallas_call run in interpret mode."""
    monkeypatch.setattr(sys, "argv", ["pl_probe.py", str(B), str(LQ),
                                      str(ROWS)])
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: real(*a, **(k | {"interpret": True})))
    spec = importlib.util.spec_from_file_location(
        "pl_probe_reference", REPO / "tools" / "pl_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert (mod.B, mod.LQ, mod.ROWS, mod.L1p) == (B, LQ, ROWS,
                                                  plp.l1p_of(LQ))
    return mod


def _reference(monkeypatch, variant, kind, B, LQ, ROWS, seed=0):
    """(qT, tT, the TPU kernel's output) at B lanes."""
    Bp = -(-B // TB) * TB
    mod = _tpu_probe(monkeypatch, Bp, LQ, ROWS)
    qT, tT = draw(seed, mod.L1p, Bp, ROWS, kind)
    want = np.asarray(mod.make(variant)(qT, tT))
    return (np.ascontiguousarray(qT[:, :B]), np.ascontiguousarray(tT[:, :B]),
            want[:, :B])


def _host(qT, tT, LQ, variant):
    """csrc/pl_probe_kernel.cu's lane loops built as host C++; returns
    (out, aux)."""
    lib = ctypes.CDLL(shared_lib(
        plp.SRC, "libpl_probe_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    L1p, B = qT.shape
    out = np.zeros_like(qT)
    aux = np.zeros((3, B), np.int32)
    ptr = [ctypes.c_void_p(a.ctypes.data) for a in (qT, tT, out, aux)]
    assert lib.plp_row_host(*ptr, L1p, tT.shape[0], B, LQ,
                            plp.VARIANTS.index(variant)) == 0
    return out, aux


def _numpy_body(qT, tT, variant, LQ):
    """The row body written once more in numpy, row by row: (out, aux)."""
    L1p, B = qT.shape
    h = (np.arange(L1p)[:, None] * 3 % 17 + np.zeros((1, B), int)).astype(
        np.int64)
    e = np.zeros((L1p, B), np.int64)
    aux = np.zeros((3, B), np.int64)
    for i in range(tT.shape[0]):
        Mq = np.where(h != 0, h + np.where(qT == tT[i], 1, -4), 0)
        if variant == "eh_only":
            h = Mq
            continue
        hv = np.zeros_like(h)
        G = np.full(B, plp.NEG, np.int64)
        mj = np.full(B, np.iinfo(np.int32).min, np.int64)
        lst = np.full(B, -1, np.int64)
        for r in range(L1p):
            A = np.maximum(Mq[r] - 7, 0) + r
            F = A if variant == "noscan" else np.maximum(G - r, 0)
            G = np.maximum(G, A)
            hv[r] = np.maximum(Mq[r], F)
            e[r] = np.maximum(e[r] - 1, np.maximum(Mq[r] - 8, 0))
            code = ((hv[r] << 12) | r) & 0xFFFFFFFF
            mj = np.maximum(mj, np.where(code >= 1 << 31, code - (1 << 32),
                                         code))
            lst = np.where((hv[r] != 0) | (e[r] != 0), r, lst)
        if variant in ("full", "roll"):
            aux = np.stack([mj, hv[LQ - 1], lst])
        h = np.concatenate([hv[:1], hv[:-1]])
    return h, aux


CASES = [(B, LQ, ROWS) for B in (256, 96) for LQ in (16, 13)
         for ROWS in (1, 8)]


@pytest.mark.parametrize("variant", plp.VARIANTS)
@pytest.mark.parametrize("B,LQ,ROWS", CASES)
def test_plain_and_lanes_match_pallas(monkeypatch, variant, B, LQ, ROWS):
    qT, tT, want = _reference(monkeypatch, variant, "probe", B, LQ, ROWS,
                              seed=B + LQ + ROWS)
    out, aux = plp.plp_plain(T(qT), T(tT), variant, LQ)
    assert_same(want, out, f"{variant} plain")
    h_out, h_aux = _host(qT, tT, LQ, variant)
    assert_same(want, h_out, f"{variant} lanes")
    assert_same(aux, h_aux, f"{variant} lanes aux")
    n_out, n_aux = _numpy_body(qT, tT, variant, LQ)
    assert_same(want, n_out, f"{variant} numpy")
    assert_same(n_aux, aux, f"{variant} aux")
    if variant == "eh_only" and ROWS == 8:
        assert want.min() < 0          # Mq is not clamped


@pytest.mark.parametrize("variant", ["noreduce", "full", "roll"])
@pytest.mark.parametrize("B,LQ,ROWS", [(256, 70, 12), (96, 130, 5)])
def test_warp_chunks_on_the_match_input(monkeypatch, variant, B, LQ, ROWS):
    """Query rows over 32 give the warp-a-lane body chunks of 3 and 5 rows
    (24 and 28 of its 32 threads with rows); on the match input states grow,
    so the scan, the shift across chunks and the reductions all matter."""
    qT, tT, want = _reference(monkeypatch, variant, "match", B, LQ, ROWS,
                              seed=LQ)
    assert want.max() > 20
    out, aux = plp.plp_plain(T(qT), T(tT), variant, LQ)
    assert_same(want, out, f"{variant} plain")
    h_out, h_aux = _host(qT, tT, LQ, variant)
    assert_same(want, h_out, f"{variant} lanes")
    n_out, n_aux = _numpy_body(qT, tT, variant, LQ)
    assert_same(n_aux, aux, f"{variant} aux")
    assert_same(n_aux, h_aux, f"{variant} lanes aux")
    if variant != "noreduce":
        assert (n_aux[1] > 0).any() and (n_aux[2] == plp.l1p_of(LQ) - 1).any()


@pytest.mark.parametrize("variant", plp.VARIANTS)
@pytest.mark.parametrize("L1p,LQ", [(13, 13), (21, 17), (30, 30)])
def test_lanes_on_query_rows_past_the_last_whole_tile(variant, L1p, LQ):
    """The thread-a-lane loop runs whole tiles of PLP_TILE (8) rows and
    then the rest one at a time: query rows that are not a multiple of 8
    (the TPU script's L1p always is) take both paths, on the match input
    so that the states grow."""
    qT, tT = draw(L1p, L1p, 40, 9, "match")
    out, aux = plp.plp_plain(T(qT), T(tT), variant, LQ)
    if variant != "eh_only":
        assert out.max() > 3
    h_out, h_aux = _host(qT, tT, LQ, variant)
    assert_same(out, h_out, f"{variant} lanes")
    assert_same(aux, h_aux, f"{variant} lanes aux")
    n_out, n_aux = _numpy_body(qT, tT, variant, LQ)
    assert_same(n_out, out, f"{variant} numpy")
    assert_same(n_aux, aux, f"{variant} numpy aux")


def test_noreduce_full_and_roll_give_one_output():
    qT, tT = draw(4, plp.l1p_of(21), 40, 9, "match")
    outs = {v: plp.plp_plain(T(qT), T(tT), v, 21) for v in plp.VARIANTS}
    for v in ("full", "roll"):
        assert_same(outs["noreduce"][0], outs[v][0], v)
        assert_same(outs["full"][1], outs[v][1], v + " aux")
    for v in ("eh_only", "noscan", "noreduce"):
        assert not outs[v][1].any()
    assert not torch.equal(outs["noscan"][0], outs["noreduce"][0])


def test_wrapper_takes_the_plain_version_on_the_cpu_and_counts_nothing():
    qT, tT = (T(x) for x in draw(5, 16, 24, 3))
    before = dict(plp.launches)
    for v in plp.VARIANTS:
        got = plp.plp_row(qT, tT, v, 13)
        want = plp.plp_plain(qT, tT, v, 13)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert plp.launches == before


def test_blocks_are_sized_from_the_query_rows():
    assert plp.lanes_per_block("full", 136) == (32, 32 * 2 * 136 * 4)
    assert plp.lanes_per_block("roll", 136) == (4, 4 * 3 * 136 * 4)
    n, smem = plp.lanes_per_block("noscan", 4000)
    assert n == plp.SMEM_MAX // (2 * 4000 * 4) and smem <= plp.SMEM_MAX
    assert plp.lanes_per_block("eh_only", 29056)[0] == 1
    with pytest.raises(ValueError):
        plp.lanes_per_block("full", 29057)
    with pytest.raises(ValueError):
        plp.lanes_per_block("roll", 19371)
    assert plp.work("full", 136, 128, 2048) == (
        4 * (2 * 136 * 2048 + 128 * 2048 + 3 * 2048), 23 * 136 * 2048 * 128)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    qT, tT = (T(x) for x in draw(6, 16, 24, 3))
    good = dict(qT=qT, tT=tT, variant="full", LQ=13)
    (out, aux), args = plp._prep(**good)
    assert out.shape == qT.shape and aux.shape == (3, 24)
    assert args[-3:] == (plp.VARIANTS.index("full"), 32, 32 * 2 * 16 * 4)
    bad = [dict(qT=qT.to(torch.int64)), dict(tT=tT[:, :8]),
           dict(tT=tT[:0]), dict(qT=qT.t().contiguous().t()),
           dict(variant="scan"), dict(LQ=0), dict(LQ=17),
           dict(qT=torch.zeros((29057, 24), dtype=torch.int32))]
    for change in bad:
        with pytest.raises(ValueError):
            plp._prep(**(good | change))
