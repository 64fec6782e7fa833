"""The one-pass extension kernel's plain version against the reference's
Pallas kernel (extend_batch_pl in interpret mode) on the test_extend
gen_cases corpora with per-lane bands w and 2w, and the CUDA source's
group step, compiled for the host with its G threads run one after the
other, against the plain version at G = 8, 16 and 32 and in both storage
modes: on the same lanes, on long lanes (queries of 1000-4095 bases), on
lanes past the Pallas kernel's packing limit (queries of 4096-5000
bases), on lanes whose score starts at 2^18 and more, and on the lanes of
tests/torch_ext_cases.py that the corpora never reach (a ring that wraps
dozens of times, a window end that grows by 2 onto a column never
stored, breaks on m == 0 and on the z-drop, ties of the row max in
different chunks).  Exact equality of all six outputs."""
import ctypes
import functools

import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401
import jax.numpy as jnp

from bwamem_tpu.config import fill_scmat
from bwamem_tpu.ops import pallas_ext
from bwamem_tpu_torch._build import shared_lib
from bwamem_tpu_torch.ops import ext_kernel

import torch_ext_cases as xc
from test_extend import gen_cases
from test_torch_ext import GS, GS_IDS, KW, _lanes
from torch_port_util import T, assert_same

OUT_NAMES = ("score", "qle", "tle", "gtle", "gscore", "max_off")
MAT = np.asarray(fill_scmat(1, 4), np.int8)
# (gen_cases seed, count, w): the corpora of tests/test_pallas_ext.py, plus
# narrow bands where w and 2w give different answers
CORPORA = [(0, 200, 100), (7, 100, 100), (0, 200, 10), (13, 100, 5),
           (21, 150, 30)]


def _bands(B, w):
    return np.where(np.arange(B) % 2 == 0, w, 2 * w).astype(np.int32)


def _pl_plain(lanes, w, mat=MAT, kw=KW):
    qT, tT, qlen, tlen, h0, eb, LQ, Tm = lanes
    res = ext_kernel.extend_batch_pl(
        T(qT), T(qlen), T(tT), T(tlen), T(h0), T(w), T(eb), lq_max=LQ,
        t_max=Tm, mat_bytes=mat.tobytes(), **kw)
    return [x.numpy() for x in res]


@pytest.mark.parametrize("seed,n,w", CORPORA)
def test_plain_matches_pallas_interpret(seed, n, w):
    lanes = _lanes(gen_cases(seed, n))
    qT, tT, qlen, tlen, h0, eb, LQ, Tm = lanes
    wv = _bands(qlen.shape[0], w)
    want = pallas_ext.extend_batch_pl(
        jnp.asarray(qT), jnp.asarray(qlen), jnp.asarray(tT),
        jnp.asarray(tlen), jnp.asarray(h0), jnp.asarray(wv), jnp.asarray(eb),
        lq_max=LQ, t_max=Tm, mat_bytes=MAT.tobytes(), interpret=True, **KW)
    got = _pl_plain(lanes, wv)
    for nm, a, b in zip(OUT_NAMES, want, got):
        assert_same(a, b, nm)
    if w < 100:
        one = _pl_plain(lanes, np.full_like(wv, w))
        assert any((a != b).any() for a, b in zip(one, got)), \
            "the doubled band should change some lane"


def _host_pl(lanes, wv, group, storage, mat=MAT, kw=KW):
    """csrc/ext_kernel.cu's ext_pl group step built as host C++ (the card
    runs the same step, a thread for each of the G), planned as
    extend_batch_pl plans it; returns out [6, B]."""
    qT, tT, qlen, tlen, h0, eb, LQ, Tm = lanes
    lib = ctypes.CDLL(shared_lib(
        ext_kernel.SRC, "libext_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ext_pl_host.restype = ci
    lib.ext_pl_host.argtypes = [vp] * 9 + [ci] * 3 + [vp] + [ci] * 9
    B = qlen.shape[0]
    p = ext_kernel.plan(LQ, int(wv.max()), group, storage)
    assert p.storage == storage
    scratch = np.zeros(B * p.area if storage == "global" else 1, np.uint8)
    out = np.zeros((6, B), np.int32)
    m25 = mat.astype(np.int32).reshape(25).copy()
    arrs = [np.ascontiguousarray(a, np.int32)
            for a in (qT, tT, qlen, tlen, h0, wv, eb)]
    rc = lib.ext_pl_host(
        *(a.ctypes.data for a in arrs),
        scratch.ctypes.data if storage == "global" else None,
        out.ctypes.data, B, LQ, Tm, m25.ctypes.data, kw["o_del"],
        kw["e_del"], kw["o_ins"], kw["e_ins"], kw["zdrop"], p.group,
        p.R, p.area, ext_kernel.STORAGE.index(storage))
    assert rc == 0
    return out


def _check(want, out):
    for k, nm in enumerate(OUT_NAMES):
        assert_same(want[k], out[k], nm)


@functools.lru_cache(maxsize=None)
def _corpus(seed, n, w):
    lanes = _lanes(gen_cases(seed, n), lane_mult=1)
    wv = _bands(lanes[2].shape[0], w)
    return lanes, wv, _pl_plain(lanes, wv)


@pytest.mark.parametrize("group,storage", GS, ids=GS_IDS)
@pytest.mark.parametrize("seed,n,w", CORPORA)
def test_kernel_source_lane_loop_matches_plain(seed, n, w, group, storage):
    lanes, wv, want = _corpus(seed, n, w)
    _check(want, _host_pl(lanes, wv, group, storage))


def _long_lanes(seed=5, B=12, LQ=4095, Tm=4352, qlo=1000, h0_lo=19,
                h0_hi=400):
    """Queries of qlo-LQ bases (1000-4095 by default) against a mutated copy with an indel and
    a tail; an unrelated target; a lane with an empty query; padding lanes
    (qlen = tlen = 0, h0 = 1) as the long-read path builds them."""
    rng = np.random.default_rng(seed)
    qT = np.full((LQ, B), 4, np.int32)
    tT = np.full((Tm, B), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    h0 = np.ones(B, np.int32)
    for b in range(B - 2):
        ql = LQ if b == 0 else int(rng.integers(qlo, LQ + 1))
        if b == 1:
            ql = 0
        q = rng.integers(0, 4, ql)
        if b in (1, 2):
            t = rng.integers(0, 4, 700)
        else:
            m = q.copy()
            sub = rng.random(ql) < 0.03
            m[sub] = rng.integers(0, 4, int(sub.sum()))
            cut = int(rng.integers(100, ql - 100))
            gap = int(rng.integers(1, 120))
            t = np.concatenate([m[:cut], rng.integers(0, 4, gap),
                                m[cut + gap // 2:],
                                rng.integers(0, 4, 150)])[:Tm]
        qT[:ql, b] = q
        tT[:len(t), b] = t
        qlen[b], tlen[b], h0[b] = ql, len(t), int(rng.integers(h0_lo, h0_hi))
    eb = np.full(B, 5, np.int32)
    return qT, tT, qlen, tlen, h0, eb, LQ, Tm


@functools.lru_cache(maxsize=None)
def _long(kind):
    lanes = {"long": lambda: _long_lanes(),
             "over": lambda: _long_lanes(seed=17, B=8, LQ=5000, Tm=5376,
                                         qlo=4096),
             "score": lambda: _long_lanes(seed=23, B=8, LQ=2000, Tm=2304,
                                          qlo=1000, h0_lo=1 << 18,
                                          h0_hi=(1 << 19) - 2001)}[kind]()
    wv = _bands(lanes[2].shape[0], 100)
    return lanes, wv, _pl_plain(lanes, wv)


@pytest.mark.parametrize("group,storage", GS, ids=GS_IDS)
def test_kernel_source_lane_loop_matches_plain_long(group, storage):
    lanes, wv, want = _long("long")
    out = _host_pl(lanes, wv, group, storage)
    _check(want, out)
    assert want[1].max() > 1000          # extensions ran far into the query
    # padding lanes cost nothing and return score = h0
    assert (out[0][-2:] == 1).all() and (out[1:, -2:] <= 0).all()


@pytest.mark.parametrize("group,storage", GS, ids=GS_IDS)
def test_kernel_source_lane_loop_matches_plain_over_4095(group, storage):
    """Lanes the Pallas kernel's (h << 12) | col packing cannot hold: the
    group step takes them as any other."""
    lanes, wv, want = _long("over")
    assert (lanes[2][[0, 3, 4, 5]] > 4095).all()
    out = _host_pl(lanes, wv, group, storage)
    _check(want, out)
    assert want[1].max() > 4095          # ran past the old column limit
    assert (out[0][-2:] == 1).all() and (out[1:, -2:] <= 0).all()


@pytest.mark.parametrize("group,storage", GS, ids=GS_IDS)
def test_kernel_source_lane_loop_matches_plain_score_over_2p18(group,
                                                               storage):
    """Scores from 2^18 up (under 2^19, what the plain version's packing
    holds at this width): int32 holds them in the group step."""
    lanes, wv, want = _long("score")
    _check(want, _host_pl(lanes, wv, group, storage))
    assert want[0][:-2].min() >= 1 << 18 and want[1].max() > 1000


@functools.lru_cache(maxsize=None)
def _cases(kind):
    """A case set of tests/torch_ext_cases.py: its lanes, bands, scoring,
    the plain version's outputs and the scalar trace of each lane."""
    cases = {"ring": xc.ring_wrap_cases, "grow": xc.grow_cases,
             "break": xc.break_cases, "tie": xc.tie_cases}[kind]()
    mat, kw = MAT, KW
    if kind == "tie":
        kw = dict(xc.TIE_SCORE)
        mat = np.asarray(fill_scmat(kw.pop("a"), kw.pop("b")), np.int8)
    lanes, wv = xc.block(cases)
    evs = [xc.trace(q, t, h, w, e, mat, **kw) for q, t, h, w, e in cases]
    return lanes, wv, mat, kw, _pl_plain(lanes, wv, mat, kw), evs


@pytest.mark.parametrize("group,storage", GS, ids=GS_IDS)
def test_kernel_source_ring_wraps(group, storage):
    """Queries of 1500-3000 bases at bands 5-20: R is 32-64, and the
    columns stored pass slot 0 of the ring dozens of times."""
    lanes, wv, mat, kw, want, evs = _cases("ring")
    _check(want, _host_pl(lanes, wv, group, storage, mat, kw))
    R = ext_kernel.plan(lanes[6], int(wv.max())).R
    assert 32 <= R <= 64
    assert min(ev["hi"] for ev in evs) > 30 * R
    # the trace is ksw_extend2 as well: it agrees with the plain version
    assert [ev["score"] for ev in evs] == list(want[0][:-1])


@pytest.mark.parametrize("group,storage", GS, ids=GS_IDS)
def test_kernel_source_end_grows_onto_unstored_columns(group, storage):
    """Windows whose end grows by 2 in a row and reads a column no row has
    stored, which must still hold its first-row value."""
    lanes, wv, mat, kw, want, evs = _cases("grow")
    _check(want, _host_pl(lanes, wv, group, storage, mat, kw))
    assert all(ev["grow2_fresh"] > 0 for ev in evs)
    assert [ev["qle"] for ev in evs] == list(want[1][:-1])


@pytest.mark.parametrize("group,storage", GS, ids=GS_IDS)
def test_kernel_source_breaks(group, storage):
    """Lanes that stop on m == 0 and on the z-drop, each in a group whose
    chunk count changes from row to row."""
    lanes, wv, mat, kw, want, evs = _cases("break")
    _check(want, _host_pl(lanes, wv, group, storage, mat, kw))
    stops = {ev["stop"] for ev in evs}
    assert stops == {"m0", "zdrop"}, stops
    assert all(len(ev["chunks"][group]) > 1 for ev in evs)


@pytest.mark.parametrize("group,storage", GS, ids=GS_IDS)
def test_kernel_source_row_max_ties(group, storage):
    """Lanes whose final max row reaches the max at two columns that one
    thread holds in different chunks: qle is the later column + 1."""
    lanes, wv, mat, kw, want, evs = _cases("tie")
    _check(want, _host_pl(lanes, wv, group, storage, mat, kw))
    assert all(ev["tie_at_max"][group] for ev in evs)
    assert [ev["qle"] for ev in evs] == list(want[1][:-1])


def test_plan_sizes_the_ring_and_picks_the_storage():
    """The ring is the smaller of the power of two at 2 w + 8 and the one
    at lq_max + 1 (then lq_max + 1 slots); a lane area holds its slots and
    query bytes; a block whose lanes exceed shared memory goes global."""
    p = ext_kernel.plan(128, 200)                # 101 bp, w2 = 200
    assert (p.R, p.area, p.storage) == (256, 1168, "shared")
    assert p.smem == ext_kernel.THREADS // p.group * p.area
    p = ext_kernel.plan(8192, 200, 32)           # 5000 bp side path
    assert (p.R, p.area, p.storage, p.smem) == (512, 12288, "shared",
                                                4 * 12288)
    p = ext_kernel.plan(3000, 5, 8)              # R 32: wraps
    assert (p.R, p.area, p.smem) == (32, 3264, 16 * 3264)
    p = ext_kernel.plan(20000, 5000, 32)         # past shared memory
    assert p.storage == "global" and p.smem == 0 and p.R == 16384
    assert ext_kernel.plan(20000, 5000, 32, "shared").smem > \
        ext_kernel.SMEM_MAX
    for g in (4, 12, 64):
        with pytest.raises(ValueError):
            ext_kernel.plan(128, 100, g)
    with pytest.raises(ValueError):
        ext_kernel.plan(128, 100, storage="texture")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    lanes = _lanes(gen_cases(0, 10))
    qT, tT, qlen, tlen, h0, eb, LQ, Tm = lanes
    args = (T(qT), T(qlen), T(tT), T(tlen), T(h0), T(_bands(len(qlen), 100)),
            T(eb))
    kw = dict(mat_bytes=MAT.tobytes(), **KW)
    for bad in (dict(lq_max=LQ + 1, t_max=Tm), dict(lq_max=LQ, t_max=Tm + 1),
                dict(lq_max=4096, t_max=Tm)):
        with pytest.raises(ValueError):
            ext_kernel._checked_lanes("extend_batch_pl", args[0], args[1],
                                      args[2], args[3], args[4], **bad)
    # a CPU tensor takes the plain version, whatever the shape checks say
    res = ext_kernel.extend_batch_pl(*args, lq_max=LQ, t_max=Tm, **kw)
    assert res.score.device.type == "cpu"
    assert torch.equal(res.score, ext_kernel.extend_batch_pl_plain(
        *args, lq_max=LQ, t_max=Tm, **kw).score)
