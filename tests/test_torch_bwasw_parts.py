"""The parts of bwamem_tpu_torch's `bwasw` against bwamem_tpu's, on the
CPU: the read's BwtLite (occ4 at every k), the genome's HostFM (occ4 and
occ4_pair at -1, 0, primary and seq_len, reference bases, ambiguity
counts), klib's introsort replay on lists with ties, the chain filter, the
hit resolution with its drand48 draw, and the three device adapters on
generated jobs: extensions with the band under and over its clamp, a large
h0, N bases and empty jobs; global alignments; and the mate SW at both
stripe widths with mate lengths that are no multiple of 16."""
import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401  (x64 on, as the reference runs)
from bwamem_tpu.bwasw import aux as jaux
from bwamem_tpu.bwasw import chain as jchain
from bwamem_tpu.bwasw import core as jcore
from bwamem_tpu.bwasw import pair as jpair
from bwamem_tpu.bwasw.bwtl import BwtLite as JBwtLite
from bwamem_tpu.bwasw.hostfm import HostFM as JHostFM
from bwamem_tpu.bwasw.ksort import ks_introsort as j_introsort
from bwamem_tpu.legacy.rng import Drand48 as JDrand48
from bwamem_tpu_torch.bwasw import aux as taux
from bwamem_tpu_torch.bwasw import chain as tchain
from bwamem_tpu_torch.bwasw import core as tcore
from bwamem_tpu_torch.bwasw import pair as tpair
from bwamem_tpu_torch.bwasw.bwtl import BwtLite as TBwtLite
from bwamem_tpu_torch.bwasw.hostfm import HostFM as THostFM
from bwamem_tpu_torch.bwasw.ksort import ks_introsort as t_introsort
from bwamem_tpu_torch.legacy.rng import Drand48 as TDrand48

from torch_port_util import assert_same, make_dataset

CPU = torch.device("cpu")
HIT_FIELDS = jcore.Hit.__slots__


@pytest.mark.parametrize("n", [1, 15, 16, 17, 100, 257])
def test_bwtlite_matches_at_every_k(n):
    seq = np.random.default_rng(n).integers(0, 4, n).astype(np.uint8)
    seq[: n // 3] = seq[0]                       # a run: ties in the SA
    j, t = JBwtLite(seq), TBwtLite(seq)
    for f in ("sa", "codes", "ckpt", "L2"):
        assert_same(getattr(j, f), getattr(t, f), f)
    assert (j.primary, j.seq_len) == (t.primary, t.seq_len)
    for k in range(-1, n + 1):
        assert_same(j.occ4(k), t.occ4(k), f"occ4({k})")
        for a, b in zip(j.occ4_pair(k - 1, k), t.occ4_pair(k - 1, k)):
            assert_same(a, b, f"occ4_pair({k})")


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    data = make_dataset(tmp_path_factory.mktemp("bwasw_parts"),
                        genome_len=30_000, n_reads=2, kmer=False,
                        n_contigs=3)
    return JHostFM(data["jidx"]), THostFM(data["tidx"])


def test_hostfm_occ_bases_and_annotations(genome):
    j, t = genome
    rng = np.random.default_rng(5)
    k = np.concatenate([[-1, 0, 1, j.primary - 1, j.primary, j.primary + 1,
                         j.seq_len - 1, j.seq_len],
                        rng.integers(0, j.seq_len + 1, 300)])
    assert_same(j.occ4(k), t.occ4(k), "occ4")
    for a, b in zip(j.occ4_pair(k[:-1], k[1:]), t.occ4_pair(k[:-1], k[1:])):
        assert_same(a, b, "occ4_pair")
    for beg, end in ((0, 1), (0, 64), (j.l_pac - 37, j.l_pac), (777, 1301)):
        assert_same(j.get_seq(beg, end), t.get_seq(beg, end), "get_seq")
    for pos in [0, 1, j.l_pac - 1, j.l_pac, 2 * j.l_pac - 1,
                *rng.integers(0, 2 * j.l_pac, 50)]:
        assert j.depos(int(pos)) == t.depos(int(pos))
    for pos in [0, j.l_pac - 10, *rng.integers(0, j.l_pac - 500, 50)]:
        assert j.cnt_ambi(int(pos), 500) == t.cnt_ambi(int(pos), 500)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 16, 17, 40, 300])
def test_introsort_replays_ties_in_the_same_order(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, max(2, n // 8), n).tolist()
    a = [(k, i) for i, k in enumerate(keys)]
    b = list(a)
    j_introsort(a, lambda x, y: x[0] < y[0])
    t_introsort(b, lambda x, y: x[0] < y[0])
    assert a == b
    assert [x[0] for x in b] == sorted(keys)


def _hits(rng, n, lq=500):
    """n random hits (both packages' Hit classes, same fields)."""
    out = ([], [])
    for _ in range(n):
        beg = int(rng.integers(0, lq - 40))
        vals = dict(k=int(rng.integers(0, 5000)), l=0, flag=0,
                    n_seeds=int(rng.integers(0, 4)),
                    is_rev=int(rng.integers(0, 2)),
                    len=int(rng.integers(20, 120)),
                    G=int(rng.integers(0, 6)) * 10,
                    G2=int(rng.integers(0, 3)) * 10, beg=beg,
                    end=beg + int(rng.integers(20, 40)))
        for lst, cls in zip(out, (jcore.Hit, tcore.Hit)):
            h = cls()
            for f, v in vals.items():
                setattr(h, f, v)
            lst.append(h)
    return out


def _fields(hits):
    return [tuple(getattr(h, f) for f in HIT_FIELDS) for h in hits]


class _Opt:
    bw, max_chain_gap, t_seeds = 50, 10000, 5


@pytest.mark.parametrize("seed", range(4))
def test_chain_filter_and_hit_resolution(seed):
    rng = np.random.default_rng(seed)
    (j0, t0), (j1, t1) = _hits(rng, 30), _hits(rng, 30)
    jf = jchain.chain_filter(_Opt, 500, j0, j1)
    tf = tchain.chain_filter(_Opt, 500, t0, t1)
    assert [_fields(x) for x in jf] == [_fields(x) for x in tf]
    jh, th = _hits(rng, 40)
    jd = jcore.resolve_duphits(None, None, jh, 0)
    td = tcore.resolve_duphits(None, None, th, 0)
    assert _fields(jd) == _fields(td)
    jr, tr = JDrand48(11 + seed), TDrand48(11 + seed)
    jq = jcore.resolve_query_overlaps(jd, 0.5, jr)
    tq = tcore.resolve_query_overlaps(td, 0.5, tr)
    assert _fields(jq) == _fields(tq) and jr.x == tr.x


def _nt4(rng, n, n_frac=0.0):
    s = rng.integers(0, 4, n).astype(np.uint8)
    s[rng.random(n) < n_frac] = 4
    return s


def test_extension_adapter_matches_the_reference():
    """Left- and right-style jobs: h0 of 1 and of 400, bands over and
    under the ksw clamp (short queries clamp w = 50), Ns, empty jobs."""
    rng = np.random.default_rng(21)
    jobs = []
    for qn, tn, h0, nf in ((60, 90, 1, 0.0), (500, 760, 1, 0.0),
                           (8, 30, 1, 0.0), (300, 420, 400, 0.02),
                           (0, 50, 1, 0.0), (40, 0, 9, 0.0),
                           (120, 200, 35, 0.1), (1, 3, 1, 0.0)):
        ref = _nt4(rng, max(tn, qn) + 5)
        q = ref[:qn].copy()
        mut = rng.random(qn) < 0.03
        q[mut] = rng.integers(0, 4, int(mut.sum()))
        q[rng.random(qn) < nf] = 4
        jobs.append((q, ref[:tn].copy(), h0))
    mat = jaux.fill_scmat(1, 3)
    for bw in (50, 3):
        want = jaux.ksw_extend_jobs(jobs, mat, 5, 2, bw)
        got = taux.ksw_extend_jobs(jobs, mat, 5, 2, bw, CPU, "ext_rght")
        assert got == want, bw
        assert want[4] == want[5] == (0, 0, 0) and want[1][0] > 100


def test_global_adapter_matches_the_reference():
    rng = np.random.default_rng(22)
    jobs = []
    for qn, tn, w in ((100, 104, 7), (500, 497, 50), (37, 40, 6),
                      (250, 250, 3), (1, 1, 3), (160, 150, 13)):
        ref = _nt4(rng, tn)
        q = np.concatenate([ref[:qn // 2], _nt4(rng, 2), ref[qn // 2:]])[:qn]
        jobs.append((q, ref, w))
    mat = jaux.fill_scmat(1, 3)
    assert taux.ksw_global_jobs(jobs, mat, 5, 2, CPU) == \
        jaux.ksw_global_jobs(jobs, mat, 5, 2)


def _ref_mate_sw(queries, refs, t, p):
    """The reference's mate-SW batch (bwamem_tpu/bwasw/pair.py:174-196):
    lanes and lengths padded to powers of two from 16."""
    import jax.numpy as jnp
    from bwamem_tpu.ops import local_sw
    B = jaux._bucket(len(queries))
    LQ = jaux._bucket(max(len(x) for x in queries), lo=16)
    LT = jaux._bucket(max(len(x) for x in refs), lo=16)
    query = np.full((B, LQ), 4, np.uint8)
    tgt = np.full((B, LT), 4, np.uint8)
    qlen = np.ones(B, np.int32)
    tlen = np.ones(B, np.int32)
    for b, (sq, ref) in enumerate(zip(queries, refs)):
        query[b, :len(sq)] = sq
        tgt[b, :len(ref)] = ref
        qlen[b], tlen[b] = len(sq), len(ref)
    res = local_sw.ksw_align_batch(
        jnp.asarray(query), jnp.asarray(qlen), jnp.asarray(tgt),
        jnp.asarray(tlen), jnp.asarray(np.int32(t)),
        jnp.asarray(jpair.fill_scmat_pair(1, 3)), o_del=5, e_del=2,
        o_ins=5, e_ins=2, max_mat=1, p=p)
    return [tuple(int(np.asarray(x)[b]) for x in res)
            for b in range(len(queries))]


@pytest.mark.parametrize("p,lens", [(16, (300, 249, 99, 17)),
                                    (8, (300, 251, 263, 1003))])
def test_mate_sw_adapter_matches_the_reference(p, lens):
    rng = np.random.default_rng(p)
    queries, refs = [], []
    for n in lens:
        ref = _nt4(rng, n + 400)
        s = int(rng.integers(0, 400))
        q = ref[s:s + n].copy()
        q[rng.random(n) < 0.02] = 4
        queries.append(q)
        refs.append(ref)
    opt = taux.Bsw2Options()
    got = tpair.sw_batch(queries, refs, opt,
                         tpair.fill_scmat_pair(opt.a, opt.b), p, CPU)
    assert got == _ref_mate_sw(queries, refs, opt.t, p)
    assert all(g[0] >= 0.8 * n for g, n in zip(got, lens))


def _pair_buf(cls, ks):
    """Two reads a pair, one unique hit each, mates ks[p] apart."""
    buf = []
    for p, d in enumerate(ks):
        for e in range(2):
            h = cls()
            h.k, h.len, h.G, h.G2 = 1000 * p + e * d, 300, 280, 0
            h.beg, h.end = 0, 300
            buf.append([h])
    return buf


@pytest.mark.parametrize("n_good", [0, 1, 2, 7, 9])
def test_insert_size_inference(n_good):
    """bsw2_stat on n_good unique pairs: the reference's message and
    result from 2 pairs on; at 1 the reference (bwtsw2_pair.c:26-95)
    reads past its list — the JAX package raises there, the port reports
    too few pairs, as it does for every k < 8."""
    ks = [600 + 13 * i for i in range(n_good)]
    reads = [None] * (2 * n_good)
    msg_t = []
    got = tpair.bsw2_stat(reads, _pair_buf(tcore.Hit, ks), msg_t, 20000)
    assert got.failed == (n_good < 8)
    if n_good == 1:
        with pytest.raises(IndexError):
            jpair.bsw2_stat(reads, _pair_buf(jcore.Hit, ks), [], 20000)
        assert "too few good pairs" in msg_t[-1]
        return
    msg_j = []
    want = jpair.bsw2_stat(reads, _pair_buf(jcore.Hit, ks), msg_j, 20000)
    assert msg_t == msg_j
    assert [getattr(got, f) for f in got.__slots__] == \
        [getattr(want, f) for f in want.__slots__]
