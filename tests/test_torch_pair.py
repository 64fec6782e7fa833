"""bwamem_tpu_torch.pair on the CPU against bwamem_tpu.pair on the same
regions: the region lists of 160 simulated pairs (the port's front half,
copied field by field into the reference's AlnReg) go through pestat,
mem_pair (also against the native pair_batch that align_batch_pe calls),
prepare_matesw_call and apply_matesw_result in both packages.  Exact
equality everywhere."""
import copy
import dataclasses

import numpy as np
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu import finalize as jfin
from bwamem_tpu import pair as jpair
from bwamem_tpu.config import MemOptions as JOpt
from bwamem_tpu_torch import finalize as tfin
from bwamem_tpu_torch import native as tnative
from bwamem_tpu_torch import pair as tpair
from bwamem_tpu_torch.io.fastq import interleave, read_fastx
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner

from torch_port_util import make_dataset, torch_opt

N_PAIRS = 160


def jregs_of(regs):
    """The port's AlnRegs as the reference's, field by field."""
    return [jfin.AlnReg(**dataclasses.asdict(r)) for r in regs]


def as_dicts(regs):
    return [dataclasses.asdict(r) for r in regs]


@pytest.fixture(scope="module")
def state(tmp_path_factory):
    data = make_dataset(tmp_path_factory.mktemp("pair"), genome_len=80_000,
                        n_reads=4, seed=31, n_pairs=N_PAIRS,
                        pe_read_len=101)
    reads = list(interleave(read_fastx(data["fq1"]),
                            read_fastx(data["fq2"])))
    al = TAligner(data["tidx"], torch_opt(), device="cpu")
    regs = al._regs_from_device(reads)
    return dict(al=al, reads=reads, regs=regs, jopt=JOpt(),
                topt=al.opt)


def _pairs(regs, n=None):
    n = len(regs) // 2 if n is None else n
    return [(regs[2 * p], regs[2 * p + 1]) for p in range(n)]


@pytest.mark.parametrize("key", [0, 1, 12345, (1 << 63) + 77, (1 << 64) - 1])
def test_hash_64(key):
    assert tfin.hash_64(key) == jfin.hash_64(key)


def test_infer_dir_cal_sub_fetch_clamp(state):
    al, regs = state["al"], state["regs"]
    l_pac = al.l_pac
    rng = np.random.default_rng(0)
    for b1, b2 in rng.integers(0, 2 * l_pac, (200, 2)).tolist():
        assert tpair.infer_dir(l_pac, b1, b2) == jpair.infer_dir(l_pac, b1,
                                                                 b2)
        rb, re = min(b1, b2), max(b1, b2) + 1
        assert tpair.fetch_clamp(al.ctg_offsets_np, l_pac, rb,
                                 (rb + re) >> 1, re) == \
            jpair.fetch_clamp(al.ctg_offsets_np, l_pac, rb, (rb + re) >> 1,
                              re)
    subs = [tpair.cal_sub(state["topt"], r) for r in regs if r]
    assert subs == [jpair.cal_sub(state["jopt"], jregs_of(r))
                    for r in regs if r]
    assert len(set(subs)) > 1


@pytest.mark.parametrize("n_pairs", [N_PAIRS, 40, 8])
def test_pestat(state, n_pairs):
    al, regs = state["al"], state["regs"]
    logs = ([], [])
    want = jpair.pestat(state["jopt"], al.l_pac,
                        [(jregs_of(a), jregs_of(b))
                         for a, b in _pairs(regs, n_pairs)],
                        log=logs[0].append)
    got = tpair.pestat(state["topt"], al.l_pac, _pairs(regs, n_pairs),
                       log=logs[1].append)
    assert as_dicts(want) == as_dicts(got)
    assert logs[0] == logs[1]
    if n_pairs == 8:
        # under 10 pairs an orientation fails (MIN_DIR_CNT)
        assert all(p.failed for p in got)
    else:
        assert not got[1].failed and 380 < got[1].avg < 420


def test_pes_from_spec():
    spec = dict(avg=400.0, std=40.0, high=560, low=240)
    assert as_dicts(tpair.pes_from_spec(spec)) == \
        as_dicts(jpair.pes_from_spec(spec))


def _marked(state):
    """Deep copies of the region lists after mark_primary_many, ids as the
    align_batch_pe builds them, plus n_pri per read."""
    regs = copy.deepcopy(state["regs"])
    ids = [((e >> 1) << 1) | (e & 1) for e in range(len(regs))]
    n_pri = tfin.mark_primary_many(state["topt"], regs, ids)
    return regs, n_pri


@pytest.mark.parametrize("id0", [0, 4096])
def test_mem_pair_and_native_pair_batch(state, id0):
    al, topt, jopt = state["al"], state["topt"], state["jopt"]
    regs, n_pri = _marked(state)
    pes = tpair.pestat(topt, al.l_pac, _pairs(state["regs"]))
    jpes = jpair.pestat(jopt, al.l_pac, [(jregs_of(a), jregs_of(b))
                                         for a, b in _pairs(state["regs"])])
    elig = [p for p in range(N_PAIRS) if n_pri[2 * p] and n_pri[2 * p + 1]]
    assert len(elig) > N_PAIRS // 2
    plain = []
    for p in elig:
        npr = [n_pri[2 * p], n_pri[2 * p + 1]]
        got = tpair.mem_pair(topt, al.l_pac, al.ctg_offsets_np, pes,
                             (regs[2 * p], regs[2 * p + 1]), id0 + p, npr)
        want = jpair.mem_pair(jopt, al.l_pac, al.ctg_offsets_np, jpes,
                              (jregs_of(regs[2 * p]),
                               jregs_of(regs[2 * p + 1])), id0 + p, npr)
        assert got == want, p
        plain.append(got)
    assert sum(1 for o, *_ in plain if o > 0) > len(elig) // 2
    assert any(n_sub > 0 for _, _, n_sub, _ in plain)

    # the native batch align_batch_pe calls
    def flat(end, field, dt):
        return np.asarray([getattr(r, field) for p in elig
                           for r in regs[2 * p + end][:n_pri[2 * p + end]]],
                          dt)
    off = [np.concatenate([[0], np.cumsum([n_pri[2 * p + e] for p in elig])]
                          ).astype(np.int64) for e in range(2)]
    tmp = max(topt.a + topt.b, topt.o_del + topt.e_del,
              topt.o_ins + topt.e_ins)
    o, sub, n_sub, z0, z1 = tnative.pair_batch(
        off[0], off[1], flat(0, "rb", np.int64), flat(0, "rid", np.int32),
        flat(0, "score", np.int32), flat(1, "rb", np.int64),
        flat(1, "rid", np.int32), flat(1, "score", np.int32),
        [id0 + p for p in elig], al.ctg_offsets_np, al.l_pac, pes, topt.a,
        tmp)
    for k, want in enumerate(plain):
        got = (int(o[k]), int(sub[k]), int(n_sub[k]),
               [int(z0[k]), int(z1[k])])
        assert got == want, (k, got, want)


def _job_fields(j):
    return (j.r, j.rb, j.re, j.rid, j.is_rev, j.l_ms, j.valid,
            j.seq.tolist())


def test_matesw_prepare_and_apply(state):
    """Every (pair, end, candidate) rescue call: same jobs from both
    packages, and — with the native SW result — the same mate list after
    apply_matesw_result (insertion + dedup)."""
    al, topt, jopt = state["al"], state["topt"], state["jopt"]
    reads = state["reads"]
    regs = copy.deepcopy(state["regs"])
    # a narrow distribution leaves mates out of range, so rescue has work
    spec = dict(avg=400.0, std=10.0, high=420, low=380)
    pes, jpes = tpair.pes_from_spec(spec), jpair.pes_from_spec(spec)
    n_jobs = n_valid = n_inserted = 0
    for p in range(N_PAIRS):
        for i in range(2):
            if not regs[2 * p + i]:
                continue
            anchor = copy.copy(regs[2 * p + i][0])
            mate = reads[2 * p + 1 - i]
            # every third pair: the mate as if it had not mapped, so the
            # rescued hit is inserted rather than deduplicated away
            ma = [] if p % 3 == 0 else regs[2 * p + 1 - i]
            jma = jregs_of(ma)
            tj = tpair.prepare_matesw_call(
                topt, al.pac, al.l_pac, al.ctg_offsets_np, pes, anchor,
                mate.l_seq, mate.seq, ma)
            jj = jpair.prepare_matesw_call(
                jopt, al.pac, al.l_pac, al.ctg_offsets_np, jpes,
                jregs_of([anchor])[0], mate.l_seq, mate.seq, jma)
            assert [_job_fields(j) for j in tj] == \
                [_job_fields(j) for j in jj], (p, i)
            n_jobs += len(tj)
            for a, b in zip(tj, jj):
                if not a.valid:
                    continue
                n_valid += 1
                ref = tfin.get_seq_np(al.pac, al.l_pac, a.rb, a.re)
                r = tnative.ksw_align_host(
                    [a.seq], [ref], [topt.min_seed_len * topt.a], topt.mat,
                    topt.o_del, topt.e_del, topt.o_ins, topt.e_ins,
                    int(topt.a), 16 if a.l_ms * topt.a < 250 else 8)
                res = [int(r[k][0]) for k in ("score", "tb", "te", "qb",
                                              "qe", "score2")]
                before = len(ma)
                assert tpair.apply_matesw_result(topt, al.l_pac, a, *res,
                                                 ma) == 1
                assert jpair.apply_matesw_result(jopt, al.l_pac, b, *res,
                                                 jma) == 1
                assert as_dicts(ma) == as_dicts(jma), (p, i)
                n_inserted += len(ma) > before
    assert n_jobs > N_PAIRS and n_valid > 20 and n_inserted > 0
