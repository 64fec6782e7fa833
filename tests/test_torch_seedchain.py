"""The port's single-program front half (pipeline/seedchain.py with
ops/smem.collect_intervals, ops/chain.expand_seeds and
ops/align_ext.extend_all) against bwamem_tpu's, on 64 reads of 101 bp of
a 60 kbp simulated genome: intervals, seeds, chains, filtered chains,
alignment regions and the extension work list, at the default caps, at
caps small enough to set every overflow flag and at band 1 (where the
retry condition of kernel #1 and the reference's differ), then the
port's align_regs regions against its own host-compacted front's.
Exact equality; frac_rep bit for bit as float32."""
import dataclasses

import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401
import jax.numpy as jnp

from bwamem_tpu.config import MemOptions as JOpt
from bwamem_tpu.index import build_index
from bwamem_tpu.io.fastq import pack_batch, read_fastx as j_read
from bwamem_tpu.ops.smem import SeedingCaps as JCaps
from bwamem_tpu.pipeline import seedchain as jsc
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch.config import MemOptions as TOpt
from bwamem_tpu_torch.index import load_index
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.ops import align_ext as talign
from bwamem_tpu_torch.ops import chain as tchain
from bwamem_tpu_torch.ops import ext_kernel
from bwamem_tpu_torch.ops import smem as tsmem
from bwamem_tpu_torch.pipeline import seedchain as tsc
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner

from torch_port_util import T, assert_same, torch_opt

N_READS = 64
L_PAD = 128
# name -> (SeedingCaps fields, seed_cap, chain_cap, reg_cap): "small" sets
# the interval (pass-1, pass-2 and pass-3 caps), seed and chain overflow
# flags on this data; the band-1 case sets the region one (reg_cap 1: 9
# reads hold 2 regions), which needs a second chain
CAPS = {"default": ({}, 256, 64, 16),
        "small": (dict(cand1=8, parents=1, cand2=4, pass3=2), 4, 1, 2),
        "band1": ({}, 256, 64, 1)}
REG_FIELDS = ("rb", "re", "qb", "qe", "rid", "score", "truesc", "w",
              "seedcov", "seedlen0")


@pytest.fixture(scope="module")
def sc(tmp_path_factory):
    """Both aligners on one index, the packed batch, and a cache of the
    reference's results by case."""
    import simdata
    d = tmp_path_factory.mktemp("seedchain")
    contigs = simdata.make_genome(60_000, seed=3, n_contigs=2)
    simdata.write_fasta(contigs, str(d / "g.fa"))
    simdata.write_fastq(simdata.sim_reads(contigs, N_READS, read_len=101,
                                          seed=5), str(d / "r.fq"))
    jidx = build_index(str(d / "g.fa"))
    jidx.save(str(d / "g"))
    tidx = load_index(str(d / "g"))
    jreads = list(j_read(str(d / "r.fq")))
    seq, l_seq = pack_batch(jreads, N_READS, L_PAD)
    return dict(jidx=jidx, tidx=tidx, ja=JAligner(jidx),
                ta=TAligner(tidx, torch_opt(), device="cpu"),
                treads=list(t_read(str(d / "r.fq"))), seq=seq, l_seq=l_seq,
                cache={})


def _caps(case, pkg):
    """(keyword caps, reg_cap) of a case; the default SeedingCaps is left
    to the callee, as Aligner._device_worklist leaves it."""
    fields, seed_cap, chain_cap, reg_cap = CAPS[case]
    kw = dict(seed_cap=seed_cap, chain_cap=chain_cap)
    if fields:
        kw["caps"] = (JCaps if pkg == "j" else tsmem.SeedingCaps)(**fields)
    return kw, reg_cap


def _ref(sc, key, fn):
    if key not in sc["cache"]:
        sc["cache"][key] = fn()
    return sc["cache"][key]


def _jargs(sc):
    ja = sc["ja"]
    return (ja.fm, ja.ctg_offsets, ja.ctg_is_alt, jnp.asarray(sc["seq"]),
            jnp.asarray(sc["l_seq"]))


def _targs(sc, al=None):
    ta = al or sc["ta"]
    return (ta.fm, ta.ctg_offsets, ta.ctg_is_alt, torch.from_numpy(sc["seq"]),
            torch.from_numpy(sc["l_seq"]))


def _jaln(sc, case, w=None):
    """The reference's align_regs: (SeedChainResult, Regs), at band w when
    given."""
    kw, reg_cap = _caps(case, "j")
    jopt = JOpt() if w is None else JOpt(w=w)
    return _ref(sc, ("aln", case, w), lambda: jsc.align_regs(
        *_jargs(sc), jopt, reg_cap=reg_cap, **kw))


def _same_tuple(want, got, what):
    assert type(want)._fields == type(got)._fields, what
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f"{what}.{f}")


def _same_result(want, got, what):
    _same_tuple(want.intervals, got.intervals, f"{what}.intervals")
    _same_tuple(want.seeds, got.seeds, f"{what}.seeds")
    _same_tuple(want.chains, got.chains, f"{what}.chains")
    assert_same(want.weights, got.weights, f"{what}.weights")
    _same_tuple(want.filtered, got.filtered, f"{what}.filtered")
    # frac_rep bit for bit
    assert np.array_equal(np.asarray(want.seeds.frac_rep).view(np.int32),
                          got.seeds.frac_rep.numpy().view(np.int32))


@pytest.mark.parametrize("case", ["default", "small"])
def test_collect_intervals(sc, case):
    want = _jaln(sc, case)[0].intervals
    opt = sc["ta"].opt
    got = tsmem.collect_intervals(
        sc["ta"].fm, *_targs(sc)[3:], min_seed_len=opt.min_seed_len,
        split_len=opt.split_len, split_width=opt.split_width,
        max_mem_intv=opt.max_mem_intv,
        **{k: v for k, v in _caps(case, "t")[0].items() if k == "caps"})
    _same_tuple(want, got, "intervals")
    if case == "small":
        assert got.overflow.all()


@pytest.mark.parametrize("case", ["default", "small"])
def test_expand_seeds(sc, case):
    """On the reference's intervals, carried across."""
    res = _jaln(sc, case)[0]
    seed_cap = CAPS[case][1]
    ta = sc["ta"]
    got = tchain.expand_seeds(ta.fm, ta.ctg_offsets,
                              tsmem.Intervals(*(T(x) for x in res.intervals)),
                              max_occ=ta.opt.max_occ, seed_cap=seed_cap)
    _same_tuple(res.seeds, got, "seeds")
    assert np.array_equal(np.asarray(res.seeds.frac_rep).view(np.int32),
                          got.frac_rep.numpy().view(np.int32))
    if case == "small":
        assert got.overflow.any()


@pytest.mark.parametrize("case", ["default", "small"])
def test_seed_and_chain_opts(sc, case):
    want = _jaln(sc, case)[0]
    kw, _ = _caps(case, "t")
    got = tsc.seed_and_chain_opts(*_targs(sc), sc["ta"].opt, **kw)
    _same_result(want, got, "seed_and_chain")
    if case == "small":
        assert got.chains.overflow.any()


@pytest.mark.parametrize("case", ["default", "small"])
def test_align_regs(sc, case):
    want_res, want = _jaln(sc, case)
    kw, reg_cap = _caps(case, "t")
    got_res, got = tsc.align_regs(*_targs(sc), sc["ta"].opt,
                                  reg_cap=reg_cap, **kw)
    _same_result(want_res, got_res, "align_regs")
    _same_tuple(want, got, "regs")
    assert np.array_equal(np.asarray(want.frac_rep).view(np.int32),
                          got.frac_rep.numpy().view(np.int32))
    assert int(got.n.sum()) > N_READS // 2


def test_align_regs_band_1(sc, monkeypatch):
    """MemOptions(w=1): the retry threshold is 0, so the reference reruns
    every lane at band 2, where kernel #1's rule would keep the first pass
    of a lane whose score stayed h0: with that rule some regions' w reads
    1.  At reg_cap 1, which sets the region overflow flag."""
    want_res, want = _jaln(sc, "band1", w=1)
    ta = TAligner(sc["tidx"], torch_opt(JOpt(w=1)), device="cpu")
    kw, reg_cap = _caps("band1", "t")
    got_res, got = tsc.align_regs(*_targs(sc, ta), ta.opt, reg_cap=reg_cap,
                                  **kw)
    _same_result(want_res, got_res, "align_regs")
    _same_tuple(want, got, "regs")
    assert got.overflow.any() and int(got.n.sum()) > N_READS // 2

    def kernel_rule(*args, w, **k):
        res, retried = ext_kernel.extend_batch_pl2(*args, w_opt=w, **k)
        return res, torch.where(retried != 0, 2 * w, w).to(torch.int32)
    monkeypatch.setattr(talign, "_extend_side", kernel_rule)
    other = tsc.align_regs(*_targs(sc, ta), ta.opt, reg_cap=reg_cap, **kw)[1]
    assert (other.w != got.w).any()


def test_align_regs_past_lq_max(sc, monkeypatch):
    """The route for queries over ext_kernel.LQ_MAX (two launches of kernel
    #2 a side), taken here at 101 bp by lowering the bound."""
    want = _jaln(sc, "default")[1]
    calls = []
    pl = ext_kernel.extend_batch_pl
    monkeypatch.setattr(ext_kernel, "LQ_MAX", 64)
    monkeypatch.setattr(ext_kernel, "extend_batch_pl",
                        lambda *a, **k: calls.append(1) or pl(*a, **k))
    monkeypatch.setattr(ext_kernel, "extend_batch_pl2", None)
    got = tsc.align_regs(*_targs(sc), sc["ta"].opt)[1]
    _same_tuple(want, got, "regs")
    assert calls and len(calls) % 4 == 0


@pytest.mark.parametrize("case", ["default", "small"])
def test_seed_chain_worklist(sc, case):
    kw, _ = _caps(case, "j")
    want = _ref(sc, ("wl", case), lambda: jsc.seed_chain_worklist(
        *_jargs(sc), JOpt(), **kw))
    got = tsc.seed_chain_worklist(*_targs(sc), sc["ta"].opt,
                                  **_caps(case, "t")[0])
    _same_tuple(want.seeds, got.seeds, "worklist.seeds")
    for f in want._fields[1:]:
        assert_same(getattr(want, f), getattr(got, f), f"worklist.{f}")
    if case == "small":
        assert got.overflow.any()


def test_device_worklist(sc):
    want = sc["ja"]._device_worklist(sc["seq"], sc["l_seq"])
    got = sc["ta"]._device_worklist(sc["seq"], sc["l_seq"])
    _same_tuple(want.seeds, got.seeds, "worklist.seeds")
    for f in want._fields[1:]:
        got_f = getattr(got, f)
        assert isinstance(got_f, np.ndarray)
        assert_same(getattr(want, f), got_f, f"worklist.{f}")


def _regs_lists(regs):
    n = regs.n.numpy()
    cols = {f: getattr(regs, f).numpy() for f in REG_FIELDS}
    return [[tuple(int(cols[f][r, j]) for f in REG_FIELDS)
             for j in range(n[r])] for r in range(len(n))]


def test_align_regs_equal_host_front(sc):
    """The cross-check the single-program driver exists for: its regions
    equal the host-compacted front's before dedup, read by read, in
    emission order."""
    res, regs = tsc.align_regs(*_targs(sc), sc["ta"].opt)
    flagged = (res.intervals.overflow | res.seeds.overflow
               | res.chains.overflow | regs.overflow).numpy()
    host = sc["ta"]._regs_host_front(sc["treads"])
    got = _regs_lists(regs)
    assert not flagged.any()
    for i, rd in enumerate(sc["treads"]):
        want = [tuple(int(getattr(r, f)) for f in REG_FIELDS)
                for r in host[i]]
        assert got[i] == want, (i, rd.name)


@pytest.mark.parametrize("touched", [None, set(), {"b", "zdrop"},
                                     {"o_del", "e_del", "pen_unpaired"}])
def test_rescale(touched):
    want = JOpt().rescale(2, touched)
    got = TOpt().rescale(2, touched)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mat.tolist() == want.mat.tolist()
