"""The port's device-front programs against bwamem_tpu's at the same sizes:
the P1/P2/P3 interval arenas and metas (k-mer fast start on and off, with
and without the back-extension compaction ladder), EXPAND's seed grids,
seed counts and l_rep, and CHAIN's six outputs.  Each program gets the
reference's upstream outputs as its inputs.  Exact equality."""
import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401
import jax.numpy as jnp

from bwamem_tpu.ops import chain as jchain
from bwamem_tpu.ops import smem as jsmem
from bwamem_tpu.pipeline import device_front as jdf
from bwamem_tpu.pipeline.seeding_host import _compact_flat as j_compact
from bwamem_tpu_torch.ops import chain as tchain
from bwamem_tpu_torch.ops import smem as tsmem
from bwamem_tpu_torch.pipeline import device_front as tdf
from bwamem_tpu_torch.pipeline.seeding_host import _compact_flat as t_compact

from torch_port_util import T, assert_same, front_setup


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return front_setup(tmp_path_factory.mktemp("front"))


def _seeding_kw(fx, use_kmer, ladder):
    z = dict(fx["sizes"])
    if ladder:
        # arenas wide enough to take the staged back-extension path
        z["kmax"] = z["k2max"] = 8192
    opt = fx["ta"].opt
    s1 = dict(cap=z["cap"], kmax=z["kmax"], emax=z["emax"],
              min_seed_len=opt.min_seed_len, use_kmer=use_kmer,
              b1s=z["b1s"], t1s=z["t1s"])
    s2 = dict(pmax=z["pmax"], cand2=z["cand2"], k2max=z["k2max"],
              e2max=z["e2max"], min_seed_len=opt.min_seed_len,
              split_len=opt.split_len, split_width=opt.split_width,
              b2s=z["b2s"], t2s=z["t2s"])
    s3 = dict(p3cap=z["p3cap"], e3max=z["e3max"],
              min_seed_len=opt.min_seed_len, max_mem_intv=opt.max_mem_intv,
              use_kmer=use_kmer, t3s=z["t3s"])
    return s1, s2, s3


def _jax_front(fx, use_kmer=True, ladder=False):
    s1, s2, s3 = _seeding_kw(fx, use_kmer, ladder)
    ja = fx["ja"]
    seq, l_seq = jnp.asarray(fx["seq"]), jnp.asarray(fx["l_seq"])
    sec1, m1 = jdf._p1_jit(ja.fm, seq, l_seq, **s1)
    sec2, m2 = jdf._p2_jit(ja.fm, seq, l_seq, sec1, m1[0], **s2)
    sec3, m3 = jdf._p3_jit(ja.fm, seq, l_seq, **s3)
    return (sec1, m1), (sec2, m2), (sec3, m3)


@pytest.mark.parametrize("use_kmer,ladder", [(True, False), (False, False),
                                             (True, True)])
def test_seeding_passes(fx, use_kmer, ladder):
    s1, s2, s3 = _seeding_kw(fx, use_kmer, ladder)
    ta = fx["ta"]
    tseq, tl = T(fx["seq"]), T(fx["l_seq"])
    (j1, jm1), (j2, jm2), (j3, jm3) = _jax_front(fx, use_kmer, ladder)
    t1, tm1 = tdf._p1_body(ta.fm, tseq, tl, **s1)
    assert_same(j1, t1, "sec1")
    assert_same(jm1, tm1, "meta1")
    assert int(jm1[0]) > 0
    t2, tm2 = tdf._p2_body(ta.fm, tseq, tl, T(j1), T(jm1[0]), **s2)
    assert_same(j2, t2, "sec2")
    assert_same(jm2, tm2, "meta2")
    t3, tm3 = tdf._p3_body(ta.fm, tseq, tl, **s3)
    assert_same(j3, t3, "sec3")
    assert_same(jm3, tm3, "meta3")


def test_kmer_pre(fx):
    ja, ta = fx["ja"], fx["ta"]
    seq, l_seq = fx["seq"], fx["l_seq"]
    assert_same(jsmem.kmer_pre(ja.fm, jnp.asarray(seq), jnp.asarray(l_seq)),
                tsmem.kmer_pre(ta.fm, T(seq), T(l_seq)), "kmer_pre")
    assert_same(jsmem.kmer_pre0(ja.fm, jnp.asarray(seq), jnp.asarray(l_seq)),
                tsmem.kmer_pre0(ta.fm, T(seq), T(l_seq)), "kmer_pre0")


def test_compact_flat_overflow_flags():
    rng = np.random.default_rng(5)
    mask = rng.random(300) < 0.4
    vals = rng.integers(-50, 50, 300).astype(np.int32)
    for arena in (64, 256):
        jo, jn, jov, jpos = j_compact(jnp.asarray(mask),
                                      [(jnp.asarray(vals), jnp.int32)], arena)
        to, tn, tov, tpos = t_compact(T(mask), [(T(vals), torch.int32)],
                                      arena)
        assert_same(jn, tn, "n")
        assert bool(jov) == bool(tov)
        assert_same(jpos, tpos, "pos")
        if not bool(jov):
            assert_same(jo[0], to[0], "out")


def test_compact_flat_overflow_keeps_whole_lanes():
    """On overflow the lanes past the arena are dropped: every slot holds
    the lane of its position, in every field (the reference's last slot
    takes an overflowing lane, which a CUDA scatter may take field by
    field from different lanes)."""
    rng = np.random.default_rng(6)
    mask = rng.random(300) < 0.4
    vals = [rng.integers(-50, 50, 300).astype(np.int32) for _ in range(3)]
    kept = [v[mask] for v in vals]
    for arena in (16, 64):
        outs, n, over, _ = t_compact(
            T(mask), [(T(v), torch.int32) for v in vals], arena)
        assert bool(over) and int(n) == arena
        for o, k in zip(outs, kept):
            assert_same(k[:arena], o, "out")


@pytest.fixture(scope="module")
def expanded(fx):
    (j1, jm1), (j2, jm2), (j3, jm3) = _jax_front(fx)
    z = fx["sizes"]
    s4 = dict(max_occ=fx["ta"].opt.max_occ, a_seed=z["a_seed"],
              s_cap=z["s_cap"], n_reads=fx["N"])
    ja = fx["ja"]
    jout = jdf._expand_jit(ja.fm, ja.ctg_offsets, j1, jm1[0], j2, jm2[0],
                           j3, jm3[0], **s4)
    return (j1, jm1, j2, jm2, j3, jm3), s4, jout


def test_expand(fx, expanded):
    (j1, jm1, j2, jm2, j3, jm3), s4, (jseeds, jcnt, jlrep, jm4) = expanded
    ta = fx["ta"]
    tseeds, tcnt, tlrep, tm4 = tdf._expand_body(
        ta.fm, ta.ctg_offsets, T(j1), T(jm1[0]), T(j2), T(jm2[0]), T(j3),
        T(jm3[0]), **s4)
    for f in jchain.Seeds._fields:
        assert_same(getattr(jseeds, f), getattr(tseeds, f), f"seeds.{f}")
    assert_same(jcnt, tcnt, "seed_cnt")
    assert_same(jlrep, tlrep, "l_rep")
    assert_same(jm4, tm4, "meta4")
    assert int(np.asarray(jseeds.valid).sum()) > 0


def test_chain(fx, expanded):
    _, _, (jseeds, _, _, _) = expanded
    ja, ta = fx["ja"], fx["ta"]
    opt = ta.opt
    z = fx["sizes"]
    s5 = dict(w=opt.w, max_chain_gap=opt.max_chain_gap,
              chain_cap=z["s_cap"], a_ch=z["a_ch"], a_it=z["a_it"],
              min_chain_weight=opt.min_chain_weight, a=opt.a,
              o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins)
    jout = jdf._chain_jit(ja.fm, ja.ctg_offsets, ja.ctg_is_alt, jseeds,
                          jnp.asarray(fx["l_seq"]), **s5)
    tseeds = tchain.Seeds(*(T(x) for x in jseeds))
    tout = tdf._chain_body(ta.fm, ta.ctg_offsets, ta.ctg_is_alt, tseeds,
                           T(fx["l_seq"]), **s5)
    names = ("seed_chain", "items32", "items_it", "chain32", "c_pos",
             "meta5")
    for nm, a, b in zip(names, jout, tout):
        assert_same(a, b, nm)
    assert int(np.asarray(jout[5])[4]) > 0       # some work items
