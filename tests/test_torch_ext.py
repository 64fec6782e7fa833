"""The extension kernel's plain version against the reference's Pallas
kernel (extend_batch_pl2 in interpret mode) on the test_extend.gen_cases
corpora, with bands that make lanes retry; the CUDA source's group step,
compiled for the host with its G threads run one after the other, against
the plain version on the same lanes at G = 8, 16 and 32 and in both
storage modes, and on long lanes whose ring of columns wraps many times;
and the EXT program (_ext_body, one- and two-round modes) against the
reference's.  Exact equality."""
import ctypes
import functools

import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401
import jax.numpy as jnp

from bwamem_tpu.config import fill_scmat
from bwamem_tpu.ops import pallas_ext
from bwamem_tpu.pipeline import device_front as jdf
from bwamem_tpu_torch._build import shared_lib
from bwamem_tpu_torch.ops import ext_kernel
from bwamem_tpu_torch.pipeline import device_front as tdf

from test_extend import NT4, gen_cases
from torch_ext_cases import block, ring_wrap_cases, trace
from torch_port_util import T, assert_same, front_setup

KW = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100)
OUT_NAMES = ("score", "qle", "tle", "gtle", "gscore", "max_off", "retried")


def _lanes(cases, lane_mult=128):
    """Corpus -> [LQ, B] / [T, B] blocks padded to a multiple of 128 lanes
    (pad lanes: qlen = tlen = 0), plus lanes with an empty query and a
    non-empty target."""
    B0 = len(cases) + 2
    B = -(-B0 // lane_mult) * lane_mult
    LQ = max(len(q) for _, _, _, q, _ in cases)
    Tm = max(len(t) for *_, t in cases)
    qT = np.full((LQ, B), 4, np.int32)
    tT = np.full((Tm, B), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    h0 = np.ones(B, np.int32)
    eb = np.zeros(B, np.int32)
    for b, (h, _w, e, q, t) in enumerate(cases):
        qT[: len(q), b] = [NT4[c] for c in q]
        tT[: len(t), b] = [NT4[c] for c in t]
        qlen[b], tlen[b], h0[b], eb[b] = len(q), len(t), h, e
    for b in (len(cases), len(cases) + 1):      # qlen == 0, tlen > 0
        tlen[b], h0[b], eb[b] = 7, 30, 5
        tT[:7, b] = 2
    return qT, tT, qlen, tlen, h0, eb, LQ, Tm


def _pl2_jax(lanes, w_opt):
    qT, tT, qlen, tlen, h0, eb, LQ, Tm = lanes
    res, retried = pallas_ext.extend_batch_pl2(
        jnp.asarray(qT), jnp.asarray(qlen), jnp.asarray(tT),
        jnp.asarray(tlen), jnp.asarray(h0), jnp.asarray(eb), lq_max=LQ,
        t_max=Tm, mat_bytes=np.asarray(fill_scmat(1, 4), np.int8).tobytes(),
        w_opt=w_opt, interpret=True, **KW)
    return [np.asarray(x) for x in res] + [np.asarray(retried)]


def _pl2_plain(lanes, w_opt):
    qT, tT, qlen, tlen, h0, eb, LQ, Tm = lanes
    res, retried = ext_kernel.extend_batch_pl2(
        T(qT), T(qlen), T(tT), T(tlen), T(h0), T(eb), lq_max=LQ, t_max=Tm,
        mat_bytes=np.asarray(fill_scmat(1, 4), np.int8).tobytes(),
        w_opt=w_opt, **KW)
    return [x.numpy() for x in res] + [retried.numpy()]


# the group sizes and storage modes of the kernels' group step
GS = [(g, s) for g in ext_kernel.GROUPS for s in ext_kernel.STORAGE]
GS_IDS = [f"G{g}-{s}" for g, s in GS]


# (gen_cases seed, count, w_opt): narrow bands make some lanes retry; 100
# is the default band
CORPORA = [(0, 200, 10), (7, 100, 5), (13, 100, 5), (21, 150, 30),
           (0, 200, 100)]


@pytest.mark.parametrize("seed,n,w_opt", CORPORA)
def test_plain_matches_pallas_interpret(seed, n, w_opt):
    lanes = _lanes(gen_cases(seed, n))
    want = _pl2_jax(lanes, w_opt)
    got = _pl2_plain(lanes, w_opt)
    for nm, a, b in zip(OUT_NAMES, want, got):
        assert_same(a, b, nm)
    if w_opt < 100:
        assert want[6].sum() > 0, "corpus should make some lanes retry"


def _host_kernel():
    lib = ctypes.CDLL(shared_lib(
        ext_kernel.SRC, "libext_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.ext_pl2_host.restype = ci
    lib.ext_pl2_host.argtypes = ([vp] * 6 + [ci] * 2 + [vp] * 2 + [ci] * 3
                                 + [vp] + [ci] * 9)
    return lib


def _host_pl2(lanes, w_opt, group, storage):
    """csrc/ext_kernel.cu's ext_pl2 group step built as host C++ (the
    card runs the same step, a thread for each of the G), planned as
    extend_batch_pl2 plans it; returns out [7, B]."""
    qT, tT, qlen, tlen, h0, eb, LQ, Tm = lanes
    B = qlen.shape[0]
    p = ext_kernel.plan(LQ, 2 * w_opt, group, storage)
    assert p.storage == storage
    scratch = np.zeros(B * p.area if storage == "global" else 1, np.uint8)
    out = np.zeros((7, B), np.int32)
    mat = np.asarray(fill_scmat(1, 4), np.int32).reshape(25).copy()
    arrs = [np.ascontiguousarray(a, np.int32)
            for a in (qT, tT, qlen, tlen, h0, eb)]
    rc = _host_kernel().ext_pl2_host(
        *(a.ctypes.data for a in arrs), w_opt, (w_opt >> 1) + (w_opt >> 2),
        scratch.ctypes.data if storage == "global" else None,
        out.ctypes.data, B, LQ, Tm, mat.ctypes.data, 6, 1, 6, 1, 100,
        p.group, p.R, p.area, ext_kernel.STORAGE.index(storage))
    assert rc == 0
    return out


@functools.lru_cache(maxsize=None)
def _corpus(seed, n, w_opt):
    """The lanes of a corpus and the plain version's outputs (shared by
    the G and storage cases)."""
    lanes = _lanes(gen_cases(seed, n), lane_mult=1)
    return lanes, _pl2_plain(lanes, w_opt)


@pytest.mark.parametrize("group,storage", GS, ids=GS_IDS)
@pytest.mark.parametrize("seed,n,w_opt", CORPORA)
def test_kernel_source_lane_loop_matches_plain(seed, n, w_opt, group,
                                               storage):
    """csrc/ext_kernel.cu's group step (built as host C++) against the
    plain version, every output field."""
    lanes, want = _corpus(seed, n, w_opt)
    out = _host_pl2(lanes, w_opt, group, storage)
    for k, nm in enumerate(OUT_NAMES):
        assert_same(want[k], out[k], nm)


@functools.lru_cache(maxsize=None)
def _ring_wrap():
    cases = ring_wrap_cases(seed=53)
    lanes, _ = block(cases)
    return cases, lanes, _pl2_plain(lanes, 5)


@pytest.mark.parametrize("group,storage", GS, ids=GS_IDS)
def test_kernel_source_ring_wraps_with_retry(group, storage):
    """Queries of 1500-3000 bases at w_opt 5: both passes run on a ring of
    R = 32 columns (2 x 10 + 8 rounded up) that the stored columns pass
    dozens of times; the retry reruns on the ring pass 1 left behind."""
    cases, lanes, want = _ring_wrap()
    out = _host_pl2(lanes, 5, group, storage)
    for k, nm in enumerate(OUT_NAMES):
        assert_same(want[k], out[k], nm)
    assert ext_kernel.plan(lanes[6], 10).R == 32
    assert want[6][:len(cases)].sum() >= 2, "some lane should retry"
    mat = np.asarray(fill_scmat(1, 4), np.int8)
    hi = [trace(q, t, h, 10, e, mat, **KW)["hi"] for q, t, h, _, e in cases]
    assert min(hi) > 30 * 32, hi                   # slot 0 reused 30 times


@pytest.fixture(scope="module")
def chained(tmp_path_factory):
    fx = front_setup(tmp_path_factory.mktemp("ext"))
    ja = fx["ja"]
    opt = fx["ta"].opt
    z = fx["sizes"]
    seq, l_seq = jnp.asarray(fx["seq"]), jnp.asarray(fx["l_seq"])
    s1 = dict(cap=z["cap"], kmax=z["kmax"], emax=z["emax"],
              min_seed_len=opt.min_seed_len, use_kmer=True, b1s=z["b1s"],
              t1s=z["t1s"])
    s2 = dict(pmax=z["pmax"], cand2=z["cand2"], k2max=z["k2max"],
              e2max=z["e2max"], min_seed_len=opt.min_seed_len,
              split_len=opt.split_len, split_width=opt.split_width,
              b2s=z["b2s"], t2s=z["t2s"])
    s3 = dict(p3cap=z["p3cap"], e3max=z["e3max"],
              min_seed_len=opt.min_seed_len, max_mem_intv=opt.max_mem_intv,
              use_kmer=True, t3s=z["t3s"])
    sec1, m1 = jdf._p1_jit(ja.fm, seq, l_seq, **s1)
    sec2, m2 = jdf._p2_jit(ja.fm, seq, l_seq, sec1, m1[0], **s2)
    sec3, m3 = jdf._p3_jit(ja.fm, seq, l_seq, **s3)
    seeds, _, _, _ = jdf._expand_jit(
        ja.fm, ja.ctg_offsets, sec1, m1[0], sec2, m2[0], sec3, m3[0],
        max_occ=opt.max_occ, a_seed=z["a_seed"], s_cap=z["s_cap"],
        n_reads=fx["N"])
    ch = jdf._chain_jit(
        ja.fm, ja.ctg_offsets, ja.ctg_is_alt, seeds, l_seq, w=opt.w,
        max_chain_gap=opt.max_chain_gap, chain_cap=z["s_cap"],
        a_ch=z["a_ch"], a_it=z["a_it"],
        min_chain_weight=opt.min_chain_weight, a=opt.a, o_del=opt.o_del,
        e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins)
    s6 = dict(lq_max=fx["L"], t_max=256,
              mat_bytes=np.asarray(opt.mat, np.int8).tobytes(),
              o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins, zdrop=opt.zdrop, w_opt=opt.w, a=opt.a,
              pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3)
    return fx, seeds, ch, s6


@pytest.mark.parametrize("sel_cap", [0, 256])
def test_ext_body(chained, sel_cap):
    fx, seeds, ch, s6 = chained
    seed_chain, items32, items_it, _, _, m5 = ch
    ja, ta = fx["ja"], fx["ta"]
    c_cap = fx["sizes"]["s_cap"]
    jout = jdf._ext_jit(
        ja.fm, jnp.asarray(fx["seq"]), jnp.asarray(fx["l_seq"]), seed_chain,
        seeds.valid, seeds.qbeg, seeds.len, seeds.rbeg, items32, items_it,
        m5[4], sel_cap=sel_cap, c_cap=c_cap, use_pl=False, **s6)
    tout = tdf._ext_body(
        ta.fm, T(fx["seq"]), T(fx["l_seq"]), T(seed_chain), T(seeds.valid),
        T(seeds.qbeg), T(seeds.len), T(seeds.rbeg), T(items32), T(items_it),
        T(m5[4]), sel_cap=sel_cap, c_cap=c_cap, **s6)
    for nm, a, b in zip(("out32", "out_it", "m6"), jout, tout):
        assert_same(a, b, nm)
    n_it = int(np.asarray(m5)[4])
    assert n_it > 0
    if sel_cap:
        assert 0 < int(np.asarray(jout[2])[0]) < n_it   # round 1 selects
