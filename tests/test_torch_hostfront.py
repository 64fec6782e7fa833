"""The port's host-compacted front against bwamem_tpu's, stage by stage, on
1000 bp reads (clean and noisy) of a simulated genome: interval collection
with its grow-and-retry path, front_half group by group, chain filter +
worklist + the packed chaining program (int32 and int64 index layouts),
ksw_align_batch, the host tie-order and seed re-scoring passes, and
extend_regions by both paths.  Each stage gets the reference's upstream
state as its input.  Exact equality."""
import dataclasses

import numpy as np
import pytest

import bwamem_tpu  # noqa: F401
import jax.numpy as jnp

from bwamem_tpu.io.fastq import pack_batch, read_fastx as j_read
from bwamem_tpu.ops import align_ext as jalign
from bwamem_tpu.ops import chain as jchain
from bwamem_tpu.ops import local_sw as jksw
from bwamem_tpu.pipeline import chainflt_host as jflt
from bwamem_tpu.pipeline import extend_host as jext
from bwamem_tpu.pipeline import seeding_host as jsh
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.ops import align_ext as talign
from bwamem_tpu_torch.ops import chain as tchain
from bwamem_tpu_torch.ops import local_sw as tksw
from bwamem_tpu_torch.pipeline import chainflt_host as tflt
from bwamem_tpu_torch.pipeline import extend_host as text
from bwamem_tpu_torch.pipeline import seeding_host as tsh
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.utils import timers

from torch_port_util import (T, assert_same, assert_worklist_same,
                             copy_worklist, dataset_contigs, long_reads_fq,
                             make_dataset, tensors_from, torch_opt,
                             worklist_from)

N_CLEAN, N_NOISY, N_EXACT = 6, 6, 2
CHIMERA = N_CLEAN + N_NOISY + N_EXACT      # row of the chimeric read
L_PAD = 1184


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """Both aligners, one packed batch of clean, noisy and error-free
    1000 bp reads plus one chimeric read (640 bases of one contig with 2%
    substitutions, then 520 error-free bases of the other: its lighter
    chain holds a seed over 512 bases), and the reference's front_half
    groups of it."""
    d = tmp_path_factory.mktemp("hostfront")
    data = make_dataset(d, n_reads=8, seed=7)
    contigs = dataset_contigs(seed=7)
    fq = str(d / "long.fq")
    with open(fq, "w") as out:
        for part, (n, seed, sub, ind) in enumerate(
                [(N_CLEAN, 55, 0.02, 0.003), (N_NOISY, 67, 0.12, 0.02),
                 (N_EXACT, 77, 0.0, 0.0)]):
            out.write(open(long_reads_fq(d / f"p{part}.fq", contigs, n, 1000,
                                         seed, sub, ind)).read())
        rng = np.random.default_rng(9)
        c0, c1 = (contigs[k] for k in sorted(contigs))
        a = list(c0[2000:2640])
        for k in np.nonzero(rng.random(640) < 0.02)[0]:
            a[k] = "ACGT"[("ACGT".index(a[k]) + 1) % 4] if a[k] in "ACGT" \
                else a[k]
        chim = "".join(a) + c1[7000:7520]
        out.write(f"@chimera\n{chim}\n+\n{'I' * len(chim)}\n")
    jreads, treads = list(j_read(fq)), list(t_read(fq))
    ja = JAligner(data["jidx"])
    ta = TAligner(data["tidx"], torch_opt(), device="cpu")
    seq, l_seq = pack_batch(jreads, 16, L_PAD)
    groups = jsh.front_half(ja, jreads, seq, l_seq)
    return dict(ja=ja, ta=ta, jreads=jreads, treads=treads, seq=seq,
                l_seq=l_seq, groups=groups)


def test_collect_intervals_grow_and_retry(hf):
    n = len(hf["jreads"])
    want = jsh.collect_intervals_host(hf["ja"], hf["seq"], hf["l_seq"], n,
                                      kmax0=1024, emax0=64)
    ta = hf["ta"]
    ta._seed_arena_hist.clear()
    timers.reset()
    timers.enable(True)
    try:
        got = tsh.collect_intervals_host(ta, hf["seq"], hf["l_seq"], n,
                                         kmax0=1024, emax0=64)
        retries = timers.snapshot().get("seed.retries.count", 0)
    finally:
        timers.enable(False)
        timers.reset()
    for nm, a, b in zip(("read", "start", "end", "x0", "x2", "overflow"),
                        want, got):
        assert_same(a, b, nm)
    assert want[0].size > 100
    assert retries >= 2               # kmax 1024 and emax 64 are too small
    # the next batch of this shape starts from the measured high-water
    # marks: no rerun
    timers.enable(True)
    try:
        again = tsh.collect_intervals_host(ta, hf["seq"], hf["l_seq"], n)
        assert "seed.retries.count" not in timers.snapshot()
    finally:
        timers.enable(False)
        timers.reset()
    assert_same(want[1], again[1], "start, second batch")


def test_front_half_groups(hf):
    got = tsh.front_half(hf["ta"], hf["treads"], hf["seq"], hf["l_seq"])
    want = hf["groups"]
    assert len(want) == len(got) >= 1
    for g, ((jr, jwr), (tr, twr)) in enumerate(zip(want, got)):
        assert_same(jr, tr, f"group {g} reads")
        assert_worklist_same(jwr, twr, f"group {g} ")
    assert sum(int(w.wl_n.sum()) for _, w in want) > 50


def _group_seeds(hf, it, read=None):
    """The seed grids of the group that holds row `read` (the largest
    group by default) as both packages' Seeds, with the index type `it`
    (numpy dtype), and its l_seq."""
    if read is None:
        ridx, wr = max(hf["groups"], key=lambda g: g[1].seeds.qbeg.size)
    else:
        ridx, wr = next(g for g in hf["groups"] if read in g[0])
    ja = hf["ja"]
    s = wr.seeds
    rid = jsh._intv2rid_np(ja.ctg_offsets_np, ja.l_pac,
                           s.rbeg.astype(np.int64), s.len)
    rid = np.where(s.valid, rid, -1).astype(np.int32)
    Gp = s.qbeg.shape[0]
    l_seq = np.ones(Gp, np.int32)
    l_seq[:ridx.size] = hf["l_seq"][ridx]
    arrs = dict(rbeg=s.rbeg.astype(it), qbeg=s.qbeg, len=s.len, rid=rid,
                valid=s.valid, frac_rep=s.frac_rep,
                overflow=np.zeros(Gp, bool))
    jseeds = jchain.Seeds(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tseeds = tchain.Seeds(**{k: T(v) for k, v in arrs.items()})
    return jseeds, tseeds, l_seq, int(s.valid.sum())


def _flt_kw(opt):
    return dict(mask_level=opt.mask_level, drop_ratio=opt.drop_ratio,
                min_seed_len=opt.min_seed_len,
                max_chain_gap=opt.max_chain_gap,
                min_chain_weight=opt.min_chain_weight,
                max_chain_extend=opt.max_chain_extend)


@pytest.mark.parametrize("which", ["largest", "chimera"])
def test_filter_chains_and_worklist(hf, which):
    ja, ta = hf["ja"], hf["ta"]
    opt = ta.opt
    jseeds, tseeds, _, _ = _group_seeds(
        hf, np.int32, read=None if which == "largest" else CHIMERA)
    C = jseeds.rbeg.shape[1]
    jch = jchain.chain_seeds(jseeds, ja.ctg_is_alt, ja.fm.l_pac, w=opt.w,
                             max_chain_gap=opt.max_chain_gap, chain_cap=C)
    jwt = jchain.chain_weights(jseeds, jch)
    jfl = jchain.filter_chains(jch, jwt, jseeds, **_flt_kw(opt))
    tch = tensors_from(jch, tchain.Chains)
    tfl = tchain.filter_chains(tch, T(jwt), tseeds, **_flt_kw(opt))
    for f in jchain.FilteredChains._fields:
        assert_same(getattr(jfl, f), getattr(tfl, f), f"filtered.{f}")
    if which == "largest":
        assert int(np.asarray(jfl.n).max()) > 1
        assert set(np.unique(np.asarray(jfl.kept))) > {0, 3}   # 1s or 2s
    jwl = jalign.build_worklist(jseeds, jch, jfl)
    twl = talign.build_worklist(tseeds, tch,
                                tensors_from(jfl, tchain.FilteredChains))
    for f in jalign.WorkList._fields:
        assert_same(getattr(jwl, f), getattr(twl, f), f"worklist.{f}")
    if which == "chimera":
        # the key's length field goes negative past 512 bases and runs over
        # the chain-position field: the chimeric read's 520-base seed
        # belongs to its SECOND chain in filter order, yet leads the work
        # list.  The port follows the reference bit for bit.
        ridx = next(g[0] for g in hf["groups"] if CHIMERA in g[0])
        row = int(np.nonzero(ridx == CHIMERA)[0][0])
        first_slot = int(np.asarray(jwl.seed_slot)[row, 0])
        assert int(np.asarray(jseeds.len)[row, first_slot]) > 512
        assert int(np.asarray(jwl.chain)[row, 0]) == \
            int(np.asarray(jfl.order)[row, 1])


@pytest.mark.parametrize("it", [np.int32, np.int64])
def test_chain_worklist_program(hf, it):
    ja, ta = hf["ja"], hf["ta"]
    opt = ta.opt
    jseeds, tseeds, l_seq, n_seeds = _group_seeds(hf, it)
    arena = 256
    while arena < n_seeds:
        arena <<= 1
    kw = dict(arena=arena, w=opt.w, a=opt.a, o_del=opt.o_del,
              e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
              **_flt_kw(opt))
    want = jsh._chain_worklist_jit(ja.fm, ja.ctg_offsets, ja.ctg_is_alt,
                                   jseeds, jnp.asarray(l_seq), **kw)
    got = tsh._chain_worklist(ta.fm, ta.ctg_offsets, ta.ctg_is_alt, tseeds,
                              T(l_seq), **kw)
    assert len(want) == len(got) == (3 if it == np.int32 else 4)
    for k, (a, b) in enumerate(zip(want, got)):
        assert_same(a, b, f"output {k}")
    assert int((np.asarray(want[-1]) >> 16).sum()) > 0      # work items


@pytest.mark.parametrize("p", [8, 16])
def test_ksw_align_batch(p):
    rng = np.random.default_rng(17 + p)
    B, LQ, LT = 48, 64, 96
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, LT), 4, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        ql = 0 if b == 0 else int(rng.integers(8, LQ - 15))
        qs = rng.integers(0, 4, ql)
        m = qs.copy()
        sub = rng.random(ql) < 0.08
        m[sub] = rng.integers(0, 5, int(sub.sum()))
        if b % 5 == 1 and ql > 20:          # a repeat: a second hit (score2)
            ts = np.concatenate([m[: ql // 2], rng.integers(0, 4, 9), m])
        elif b % 5 == 2 and ql > 20:        # an indel
            ts = np.concatenate([m[: ql // 2], m[ql // 2 + 2:]])
        elif b % 5 == 3:                    # unrelated
            ts = rng.integers(0, 4, int(rng.integers(1, LT)))
        else:
            ts = np.concatenate([rng.integers(0, 4, int(rng.integers(0, 20))),
                                 m, rng.integers(0, 4, 6)])
        ts = ts[:LT]
        q[b, :ql], t[b, :len(ts)] = qs, ts
        qlen[b], tlen[b] = ql, len(ts)
    minsc = rng.integers(1, 30, B).astype(np.int32)
    opt = torch_opt()
    kw = dict(o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
              e_ins=opt.e_ins, max_mat=opt.a, p=p)
    want = jksw.ksw_align_batch(jnp.asarray(q), jnp.asarray(qlen),
                                jnp.asarray(t), jnp.asarray(tlen),
                                jnp.asarray(minsc), jnp.asarray(opt.mat),
                                **kw)
    got = tksw.ksw_align_batch(T(q), T(qlen), T(t), T(tlen), T(minsc),
                               opt.mat, **kw)
    for f in jksw.KswResult._fields:
        assert_same(getattr(want, f), getattr(got, f), f)
    assert (np.asarray(want.score2) > 0).any()
    assert (np.asarray(want.tb) >= 0).any()


def test_fix_tied_rows(hf):
    """Rows whose heavy chains tie in weight are rebuilt in ks_introsort's
    order: tie two heavy chains of every row that has two, then run both
    packages' pass on copies."""
    _, wr = max(hf["groups"], key=lambda g: g[1].seeds.qbeg.size)
    opt = hf["ta"].opt
    jwr = copy_worklist(wr)
    tied = 0
    for gi in range(jwr.chain_w.shape[0]):
        heavy = np.nonzero((np.arange(jwr.chain_w.shape[1])
                            < jwr.chain_n[gi])
                           & (jwr.chain_w[gi] >= opt.min_chain_weight))[0]
        if heavy.size >= 2:
            jwr.chain_w[gi, heavy[1:]] = jwr.chain_w[gi, heavy[0]]
            tied += 1
    assert tied > 0
    twr = worklist_from(jwr)
    n_j = jflt.fix_tied_rows(jwr, hf["ja"].opt)
    n_t = tflt.fix_tied_rows(twr, opt)
    assert n_j == n_t == tied
    assert_worklist_same(jwr, twr, "tied ")
    assert not np.array_equal(jwr.wl_chain, wr.wl_chain)    # rows changed


def test_flt_chained_seeds(hf):
    """mem_flt_chained_seeds on the 1000 bp reads: the re-scored work order
    and the dropped seeds (wl_* and seed_chain are mutated in place)."""
    dropped = 0
    changed = False
    for ridx, wr in hf["groups"]:
        jwr, twr = copy_worklist(wr), worklist_from(wr)
        n_j = jflt.flt_chained_seeds(
            hf["ja"], [hf["jreads"][i] for i in ridx], jwr)
        n_t = tflt.flt_chained_seeds(
            hf["ta"], [hf["treads"][i] for i in ridx], twr)
        assert n_j == n_t
        assert_worklist_same(jwr, twr, "flt ")
        dropped += n_j
        changed |= not np.array_equal(jwr.wl_slot, wr.wl_slot)
    assert dropped > 0 and changed


FIELDS = [f.name for f in dataclasses.fields(text.AlnReg)]


def _regs_same(want, got):
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert len(a) == len(b), (i, len(a), len(b))
        for k, (x, y) in enumerate(zip(a, b)):
            for f in FIELDS:
                assert getattr(x, f) == getattr(y, f), (i, k, f)


@pytest.fixture(scope="module")
def rescored(hf):
    """The groups after the reference's seed re-scoring, as both packages'
    worklists."""
    out = []
    for ridx, wr in hf["groups"]:
        jwr = copy_worklist(wr)
        jflt.flt_chained_seeds(hf["ja"], [hf["jreads"][i] for i in ridx],
                               jwr)
        out.append((ridx, jwr, worklist_from(jwr)))
    return out


def test_extend_regions_side_path(hf, rescored):
    n_regs = 0
    for ridx, jwr, twr in rescored:
        want = jext.extend_regions(
            hf["ja"], [hf["jreads"][i] for i in ridx], hf["seq"][ridx], jwr)
        got = text.extend_regions(
            hf["ta"], [hf["treads"][i] for i in ridx], hf["seq"][ridx], twr)
        _regs_same(want, got)
        n_regs += sum(len(r) for r in want)
    assert n_regs >= len(hf["jreads"])


def test_extend_both_fused_equals_side_path(hf, rescored):
    """_extend_both_fused called directly (on the CPU its two kernel calls
    take their plain version) against two _extend_side runs on the same
    items: the twelve result vectors and both band marks."""
    ta = hf["ta"]
    opt = ta.opt
    ridx, _, wr = max(rescored, key=lambda g: int(g[2].wl_n.sum()))
    n = ridx.size
    ii = np.repeat(np.arange(n, dtype=np.int32), wr.wl_n[:n])
    kk = np.concatenate([np.arange(c) for c in wr.wl_n[:n]]).astype(np.int32)
    slot, chn = wr.wl_slot[ii, kk], wr.wl_chain[ii, kk]
    s_qb = wr.seeds.qbeg[ii, slot].astype(np.int64)
    s_len = wr.seeds.len[ii, slot].astype(np.int64)
    s_rb = wr.seeds.rbeg[ii, slot].astype(np.int64)
    rmax0 = wr.rmax0[ii, chn].astype(np.int64)
    rmax1 = wr.rmax1[ii, chn].astype(np.int64)
    l_seq = hf["l_seq"][ridx].astype(np.int64)[ii]
    M = ii.size
    assert M > 20
    seq_dev = T(hf["seq"][ridx])
    L, aw0, R, aw1 = text._extend_both_fused(
        ta, opt, opt.mat, seq_dev, ii, s_qb, s_len, s_rb, rmax0, rmax1,
        l_seq)
    neg1, pos1 = np.full(M, -1, np.int64), np.ones(M, np.int64)
    h0 = np.maximum(s_len * opt.a, 1).astype(np.int32)
    Ls, aw0s = text._extend_side(
        text._ExtBatcher(opt, opt.mat, opt.pen_clip5, ta.fm, seq_dev), opt,
        ii, s_qb - 1, neg1, s_qb.astype(np.int32), s_rb - 1, neg1,
        np.where(s_qb > 0, s_rb - rmax0, 0).astype(np.int32), h0)
    sc0 = np.maximum(np.where(s_qb > 0, Ls["score"], s_len * opt.a),
                     1).astype(np.int32)
    s_qe = s_qb + s_len
    Rs, aw1s = text._extend_side(
        text._ExtBatcher(opt, opt.mat, opt.pen_clip3, ta.fm, seq_dev), opt,
        ii, s_qe, pos1, (l_seq - s_qe).astype(np.int32), s_rb + s_len, pos1,
        np.where(s_qe < l_seq, rmax1 - (s_rb + s_len), 0).astype(np.int32),
        sc0)
    for f in text.FIELDS:
        assert_same(L[f], Ls[f], f"left {f}")
        assert_same(R[f], Rs[f], f"right {f}")
    assert_same(aw0, aw0s, "aw0")
    assert_same(aw1, aw1s, "aw1")
