"""The row-body ablation probe of bwamem_tpu_torch (ops/pl_probe) on the
CPU.  The reference's own probe, tools/pl_probe.py, is loaded with its
shape in sys.argv (it reads B, LQ and ROWS at import) and its kernel runs
under pl.pallas_call(..., interpret=True); for each of its five variants
the plain version and every design of csrc/pl_probe_kernel.cu built for
the host must equal it exactly: the group design at G = 8, 16 and 32 with
its chunk in registers and in shared memory (the group's threads one after
another, the shuffles' scan and shift and the reductions spelled out, the
DPX add-maxes by their plain C definitions), roll's warp a lane with its
rows in registers and its block with them in shared memory (the log-step
scans spelled out),
and eh_only's rows of lanes a thread.  The TPU script tiles 128 lanes, so
a B that is not a multiple of 128 runs there with extra lanes (lanes are
independent) that are then cut.  The reductions the TPU kernel multiplies
by zero reach `aux`, which is held against a numpy computation of the row
body.  Besides the probe's inputs (tools/torch_pl_probe.draw: bases in
[0, 4), on which most states decay to 0 within a few rows), the cases run
on its "match" input (target rows copied from the query along a diagonal,
so that states grow and the reductions see large h)."""
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


_REFERENCE = {}     # the TPU kernel's output, by its arguments


def _reference(monkeypatch, variant, kind, B, LQ, ROWS, seed=0):
    """(qT, tT, the TPU kernel's output) at B lanes."""
    key = (variant, kind, B, LQ, ROWS, seed)
    if key not in _REFERENCE:
        Bp = -(-B // TB) * TB
        mod = _tpu_probe(monkeypatch, Bp, LQ, ROWS)
        qT, tT = draw(seed, mod.L1p, Bp, ROWS, kind)
        want = np.asarray(mod.make(variant)(qT, tT))
        _REFERENCE[key] = (np.ascontiguousarray(qT[:, :B]),
                           np.ascontiguousarray(tT[:, :B]), want[:, :B])
    return _REFERENCE[key]


# The designs of each variant the host build runs (labels of design_plan)
GROUP_DESIGNS = [f"G{G}-{st}" for G in plp.GROUPS for st in plp.STORAGE]
DESIGNS = {"eh_only": ["rpt1-lpt1", "rpt2-lpt4", "rpt4-lpt4", "rpt16-lpt1"],
           "noscan": GROUP_DESIGNS, "noreduce": GROUP_DESIGNS,
           "full": GROUP_DESIGNS, "roll": list(plp.STORAGE)}
VARIANT_DESIGNS = [(v, d) for v in plp.VARIANTS for d in DESIGNS[v]]


def design_plan(variant, design, L1p, B):
    """The plan (ops/pl_probe.Plan) of a DESIGNS label at L1p rows, B
    lanes; eh_only's lanes a thread fall back to 1 where B % 4 != 0."""
    if variant == "eh_only":
        rpt, lpt = (int(x[3:]) for x in design.split("-"))
        return plp.Plan(rpt, lpt if B % lpt == 0 else 1, 256, 8)
    if variant == "roll":
        return plp.plan(variant, L1p, B, storage=design)
    G, st = design.split("-")
    return plp.plan(variant, L1p, B, G=int(G[1:]), storage=st)


def _host(qT, tT, LQ, variant, p=None):
    """csrc/pl_probe_kernel.cu's designs built as host C++, at plan p (None:
    the shipped plan); returns (out, aux)."""
    lib = ctypes.CDLL(shared_lib(
        plp.SRC, "libpl_probe_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    L1p, B = qT.shape
    p = plp.plan(variant, L1p, B) if p is None else p
    out = np.zeros_like(qT)
    aux = np.zeros((3, B), np.int32)
    ptr = [ctypes.c_void_p(a.ctypes.data) for a in (qT, tT, out, aux)]
    assert lib.plp_row_host(*ptr, L1p, tT.shape[0], B, LQ,
                            plp.VARIANTS.index(variant), *p) == 0
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


@pytest.mark.parametrize("variant,design", VARIANT_DESIGNS)
@pytest.mark.parametrize("B,LQ,ROWS", CASES)
def test_plain_and_lanes_match_pallas(monkeypatch, variant, design, B, LQ,
                                      ROWS):
    """L1p 16 and 24 lie below G = 32 (and 24 is no multiple of 16); ROWS
    1 and 8 are no multiple of G."""
    qT, tT, want = _reference(monkeypatch, variant, "probe", B, LQ, ROWS,
                              seed=B + LQ + ROWS)
    out, aux = plp.plp_plain(T(qT), T(tT), variant, LQ)
    assert_same(want, out, f"{variant} plain")
    h_out, h_aux = _host(qT, tT, LQ, variant,
                         design_plan(variant, design, *qT.shape))
    assert_same(want, h_out, f"{variant} {design}")
    assert_same(aux, h_aux, f"{variant} {design} aux")
    n_out, n_aux = _numpy_body(qT, tT, variant, LQ)
    assert_same(want, n_out, f"{variant} numpy")
    assert_same(n_aux, aux, f"{variant} aux")
    if variant == "eh_only" and ROWS == 8:
        assert want.min() < 0          # Mq is not clamped


MATCH_DESIGNS = [(v, d) for v, d in VARIANT_DESIGNS
                 if v in ("noreduce", "full", "roll")]


@pytest.mark.parametrize("variant,design", MATCH_DESIGNS)
@pytest.mark.parametrize("B,LQ,ROWS", [(256, 70, 12), (96, 130, 5),
                                       (128, 128, 5)])
def test_warp_chunks_on_the_match_input(monkeypatch, variant, design, B, LQ,
                                        ROWS):
    """Query rows of 72, 136 and 136 (the probe's) give the group chunks of
    3 to 17 rows (threads idle past the last row at G 32), roll 3 to 5
    rows a thread (or 3 to 5 warps of its block); on the match input
    states grow, so the scan, the shift across chunks and warps and the
    reductions all matter."""
    qT, tT, want = _reference(monkeypatch, variant, "match", B, LQ, ROWS,
                              seed=LQ)
    assert want.max() > 20
    out, aux = plp.plp_plain(T(qT), T(tT), variant, LQ)
    assert_same(want, out, f"{variant} plain")
    h_out, h_aux = _host(qT, tT, LQ, variant,
                         design_plan(variant, design, *qT.shape))
    assert_same(want, h_out, f"{variant} {design}")
    n_out, n_aux = _numpy_body(qT, tT, variant, LQ)
    assert_same(n_aux, aux, f"{variant} aux")
    assert_same(n_aux, h_aux, f"{variant} {design} aux")
    if variant != "noreduce":
        assert (n_aux[1] > 0).any() and (n_aux[2] == plp.l1p_of(LQ) - 1).any()


_NUMPY = {}         # _numpy_body's output, by variant and shape


@pytest.mark.parametrize("variant,design", VARIANT_DESIGNS)
@pytest.mark.parametrize("L1p,LQ,B", [(13, 13, 40), (21, 17, 90),
                                      (30, 30, 40), (136, 128, 6),
                                      (1030, 1000, 3)])
def test_lanes_on_query_rows_past_the_last_whole_tile(variant, design, L1p,
                                                      LQ, B):
    """Query rows that the TPU script never makes (it rounds L1p to 8):
    13, 21 and 30 rows (no multiple of G; the last chunk short, threads
    idle),
    136 and 1030 (past roll's 512 rows in registers and its block of 1024
    threads: roll in segments; the group's chunk in shared memory at G 8
    and 16, where it passes the registers' 32 rows);
    B 90 is no multiple of eh_only's 4 lanes a thread.  On the match input
    the states grow."""
    qT, tT = draw(L1p, L1p, B, 9, "match")
    out, aux = plp.plp_plain(T(qT), T(tT), variant, LQ)
    if variant != "eh_only":
        assert out.max() > 3
    try:
        p = design_plan(variant, design, L1p, B)
    except ValueError:       # registers cannot hold 1030 rows at this G
        p = None
        assert L1p == 1030 and design.endswith("registers")
    h_out, h_aux = _host(qT, tT, LQ, variant, p)
    assert_same(out, h_out, f"{variant} {design}")
    assert_same(aux, h_aux, f"{variant} {design} aux")
    key = (variant, L1p, LQ, B)
    if key not in _NUMPY:
        _NUMPY[key] = _numpy_body(qT, tT, variant, LQ)
    n_out, n_aux = _NUMPY[key]
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


def test_plan_picks_registers_then_shared_memory():
    """The shipped plans at the probe's shape, and where each design's state
    stops fitting: the group's chunk in registers up to 32 rows a thread,
    then in shared memory (two words a row a lane) up to SMEM_MAX a block;
    roll a warp a lane with up to 16 rows a thread in registers, then a
    block with its rows in shared memory; eh_only at EH_PLAN's lanes a
    thread where B allows it."""
    G = plp.GROUP
    assert plp.plan("full", 136, 2048) == (G, -(-136 // G), 128 // G, 0)
    assert plp.plan("full", 136, 2048, G=32) == (32, 5, 4, 0)
    assert plp.plan("noscan", 136, 2048, G=8) == (8, 17, 16, 0)
    assert plp.plan("noreduce", 104, 1000, G=16) == (16, 8, 8, 0)
    assert plp.plan("full", 21, 1000, G=8) == (8, 3, 16, 0)
    assert plp.plan("full", 136, 2048, G=16, storage="shared") == (
        16, 0, 8, 8 * 2 * 136 * 4)
    assert plp.plan("full", 1024, 8, G=32) == (32, 32, 4, 0)
    assert plp.plan("full", 1025, 8, G=32) == (32, 0, 4, 4 * 2 * 1025 * 4)
    n, smem = plp.plan("noscan", 4000, 8, G=16)[2:]
    assert n == plp.SMEM_MAX // (2 * 4000 * 4) and smem <= plp.SMEM_MAX
    assert plp.plan("noreduce", 29056, 8, G=8)[2:] == (1, plp.SMEM_MAX)
    assert plp.plan("roll", 136, 2048) == (32, 5, 4, 0)
    assert plp.plan("roll", 200, 8) == (32, 8, 4, 0)
    assert plp.plan("roll", 512, 8) == (32, 16, 4, 0)
    assert plp.plan("roll", 513, 8) == (544, 0, 0, 4 * (7 * 17 + 1026))
    assert plp.plan("roll", 1025, 8) == (1024, 0, 0, 4 * (7 * 32 + 2050))
    assert plp.plan("roll", 136, 8, storage="shared") == (
        160, 0, 0, 4 * (7 * 5 + 272))
    rpt, lpt, threads, lgb = plp.EH_PLAN
    assert plp.plan("eh_only", 136, 2048) == plp.EH_PLAN
    assert plp.plan("eh_only", 136, 90) == (rpt, 1 if 90 % lpt else lpt,
                                            threads, lgb)
    assert plp.plan("eh_only", 136, 2048, aligned=False) == (rpt, 1,
                                                             threads, lgb)
    for bad in (dict(variant="full", L1p=29057, B=8),
                dict(variant="full", L1p=1025, B=8, G=32,
                     storage="registers"),
                dict(variant="roll", L1p=513, B=8, storage="registers"),
                dict(variant="roll", L1p=28945, B=8),
                dict(variant="full", L1p=136, B=8, G=64),
                dict(variant="full", L1p=136, B=8, storage="ring")):
        with pytest.raises(ValueError):
            plp.plan(**bad)
    assert plp.work("full", 136, 128, 2048) == (
        4 * (2 * 136 * 2048 + 128 * 2048 + 3 * 2048), 23 * 136 * 2048 * 128)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    qT, tT = (T(x) for x in draw(6, 16, 24, 3))
    good = dict(qT=qT, tT=tT, variant="full", LQ=13)
    (out, aux), args = plp._prep(**good)
    assert out.shape == qT.shape and aux.shape == (3, 24)
    assert args[-5:] == (plp.VARIANTS.index("full"),
                         *plp.plan("full", 16, 24))
    bad = [dict(qT=qT.to(torch.int64)), dict(tT=tT[:, :8]),
           dict(tT=tT[:0]), dict(qT=qT.t().contiguous().t()),
           dict(variant="scan"), dict(LQ=0), dict(LQ=17),
           dict(qT=torch.zeros((29057, 24), dtype=torch.int32))]
    # plans the C entry would launch past its shared memory, its register
    # chunks or a 16-byte load: the wrapper checks every plan it is given
    P, S = plp.Plan, plp.SMEM_MAX
    bad += [dict(variant=v, p=p) for v in ("noscan", "noreduce", "full")
            for p in (P(64, 1, 1, 0), P(8, 1, 4, 0), P(32, 7, 4, 0),
                      P(32, 1, 8, 0), P(32, 1, 0, 0),
                      P(32, 0, 4, 4 * 2 * 16 * 4 - 4), P(32, 0, 4, S + 4))]
    roll_smem = 4 * (7 + 2 * 16)
    bad += [dict(variant="roll", p=p) for p in (
        P(32, 7, 4, 0), P(64, 1, 4, 0), P(32, 0, 0, roll_smem - 4),
        P(48, 0, 0, S), P(2048, 0, 0, S), P(32, 0, 0, S + 4))]
    bad += [dict(variant="eh_only", p=p) for p in (
        P(3, 1, 128, 128), P(2, 2, 128, 128), P(2, 4, 128, 16),
        P(2, 1, 1024, 128), P(2, 1, 128, 0))]
    for change in bad:
        with pytest.raises(ValueError):
            plp._prep(**(good | change))
    for v in plp.VARIANTS:                  # the plans the tests run
        for d in DESIGNS[v]:
            plp._prep(qT, tT, v, 13, design_plan(v, d, 16, 24))
    # 4 lanes a thread only where B % 4 == 0 and the tables are aligned
    q42, t42 = (T(x) for x in draw(6, 16, 42, 3))
    q4 = torch.zeros(16 * 24 + 1, dtype=torch.int32)[1:].view(16, 24)
    assert q4.is_contiguous() and q4.data_ptr() % 16
    for q, t in ((q42, t42), (q4, tT)):
        with pytest.raises(ValueError):
            plp._prep(q, t, "eh_only", 13, P(2, 4, 128, 128))
        assert plp._prep(q, t, "eh_only", 13)[1][-3] == 1
