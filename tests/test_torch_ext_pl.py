"""The one-pass extension kernel's plain version against the reference's
Pallas kernel (extend_batch_pl in interpret mode) on the test_extend
gen_cases corpora with per-lane bands w and 2w, and the CUDA source's
one-pass lane loop, compiled for the host, against the plain version on
the same lanes, on long lanes (queries of 1000-4095 bases), on lanes past
the Pallas kernel's packing limit (queries of 4096-5000 bases) and on lanes
whose score starts at 2^18 and more.  Exact equality of all six outputs."""
import ctypes

import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401
import jax.numpy as jnp

from bwamem_tpu.config import fill_scmat
from bwamem_tpu.ops import pallas_ext
from bwamem_tpu_torch._build import shared_lib
from bwamem_tpu_torch.ops import ext_kernel
from bwamem_tpu_torch.ops.extend import _adjust_w

from test_extend import gen_cases
from test_torch_ext import KW, _lanes
from torch_port_util import T, assert_same

OUT_NAMES = ("score", "qle", "tle", "gtle", "gscore", "max_off")
MAT = np.asarray(fill_scmat(1, 4), np.int8)
# (gen_cases seed, count, w): the corpora of tests/test_pallas_ext.py, plus
# narrow bands where w and 2w give different answers
CORPORA = [(0, 200, 100), (7, 100, 100), (0, 200, 10), (13, 100, 5),
           (21, 150, 30)]


def _bands(B, w):
    return np.where(np.arange(B) % 2 == 0, w, 2 * w).astype(np.int32)


def _pl_plain(lanes, w):
    qT, tT, qlen, tlen, h0, eb, LQ, Tm = lanes
    res = ext_kernel.extend_batch_pl(
        T(qT), T(qlen), T(tT), T(tlen), T(h0), T(w), T(eb), lq_max=LQ,
        t_max=Tm, mat_bytes=MAT.tobytes(), **KW)
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


def _host_pl(lanes, wv):
    """csrc/ext_kernel.cu's one-pass lane loop built as host C++ (the card
    runs the same code per thread)."""
    qT, tT, qlen, tlen, h0, eb, LQ, Tm = lanes
    lib = ctypes.CDLL(shared_lib(
        ext_kernel.SRC, "libext_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ext_pl_host.restype = ci
    lib.ext_pl_host.argtypes = [vp] * 8 + [ci] * 3 + [vp] + [ci] * 5
    B = qlen.shape[0]
    wadj = np.ascontiguousarray(_adjust_w(
        T(wv), T(qlen), int(MAT.max()), T(eb), 6, 1, 6, 1).numpy(),
        np.int32)
    eh = np.zeros((2, LQ + 1, B), np.int32)
    out = np.zeros((6, B), np.int32)
    mat = MAT.astype(np.int32).reshape(25).copy()
    arrs = [np.ascontiguousarray(a, np.int32)
            for a in (qT, tT, qlen, tlen, h0)]
    rc = lib.ext_pl_host(*(a.ctypes.data for a in arrs), wadj.ctypes.data,
                         eh.ctypes.data, out.ctypes.data, B, LQ, Tm,
                         mat.ctypes.data, 6, 1, 6, 1, 100)
    assert rc == 0
    return out


@pytest.mark.parametrize("seed,n,w", CORPORA)
def test_kernel_source_lane_loop_matches_plain(seed, n, w):
    lanes = _lanes(gen_cases(seed, n), lane_mult=1)
    wv = _bands(lanes[2].shape[0], w)
    want = _pl_plain(lanes, wv)
    out = _host_pl(lanes, wv)
    for k, nm in enumerate(OUT_NAMES):
        assert_same(want[k], out[k], nm)


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


def test_kernel_source_lane_loop_matches_plain_long():
    lanes = _long_lanes()
    wv = _bands(lanes[2].shape[0], 100)
    want = _pl_plain(lanes, wv)
    out = _host_pl(lanes, wv)
    for k, nm in enumerate(OUT_NAMES):
        assert_same(want[k], out[k], nm)
    assert want[1].max() > 1000          # extensions ran far into the query
    # padding lanes cost nothing and return score = h0
    assert (out[0][-2:] == 1).all() and (out[1:, -2:] <= 0).all()


def test_kernel_source_lane_loop_matches_plain_over_4095():
    """Lanes the Pallas kernel's (h << 12) | col packing cannot hold: the
    scalar lane loop takes them as any other."""
    lanes = _long_lanes(seed=17, B=8, LQ=5000, Tm=5376, qlo=4096)
    assert (lanes[2][[0, 3, 4, 5]] > 4095).all()
    wv = _bands(lanes[2].shape[0], 100)
    want = _pl_plain(lanes, wv)
    out = _host_pl(lanes, wv)
    for k, nm in enumerate(OUT_NAMES):
        assert_same(want[k], out[k], nm)
    assert want[1].max() > 4095          # ran past the old column limit
    assert (out[0][-2:] == 1).all() and (out[1:, -2:] <= 0).all()


def test_kernel_source_lane_loop_matches_plain_score_over_2p18():
    """Scores from 2^18 up (under 2^19, what the plain version's packing
    holds at this width): int32 holds them in the lane loop."""
    lanes = _long_lanes(seed=23, B=8, LQ=2000, Tm=2304, qlo=1000,
                        h0_lo=1 << 18, h0_hi=(1 << 19) - 2001)
    wv = _bands(lanes[2].shape[0], 100)
    want = _pl_plain(lanes, wv)
    out = _host_pl(lanes, wv)
    for k, nm in enumerate(OUT_NAMES):
        assert_same(want[k], out[k], nm)
    assert want[0][:-2].min() >= 1 << 18 and want[1].max() > 1000


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
