"""The benchmark's yardstick on the CPU: data from seeds, the reference's
alignment arithmetic, the trace and roofline arithmetic."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from conftest import ROOT, tiny_config
from portbench import roofline, trace
from portbench.gen import genome as gg
from portbench.gen import reads as gr
from portbench.ref import check, sw

SC = dict(a=1, b=4, o_del=6, e_del=1, o_ins=6, e_ins=1)
BIG_SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def tiny_genome():
    return gr.Genome.of(gg.make_genome(tiny_config()))


def test_genome_repeats_for_its_seed(tiny_genome):
    again = gr.Genome.of(gg.make_genome(tiny_config()))
    assert np.array_equal(tiny_genome.codes, again.codes)
    other = tiny_config()
    other["genome_seed"] += 1
    assert not np.array_equal(gr.Genome.of(gg.make_genome(other)).codes,
                              tiny_genome.codes)
    assert tiny_genome.names == ["c1", "c2"]
    assert (tiny_genome.codes[1000:1500] == 4).all()
    assert tiny_genome.n_starts[0] == 1000


def test_repeat_families_are_written():
    cfg = tiny_config()
    cfg["repeats"] = [{"kind": "interspersed", "share": 0.3,
                       "length": [300, 300], "consensus": 300,
                       "families": 1, "divergence": [0.0, 0.0]}]
    cfg["contigs"] = [{"name": "c", "length": 100000}]
    codes = gg.make_genome(cfg)[0][1]
    # exact copies of one 300 bp family: a 40-mer of the genome recurs
    kmers = {}
    for i in range(0, len(codes) - 40, 7):
        kmers.setdefault(codes[i:i + 40].tobytes(), []).append(i)
    assert max(len(v) for v in kmers.values()) >= 10


@pytest.mark.parametrize("traffic", ["se101", "pe150"])
def test_reads_repeat_for_a_seed(tiny_genome, traffic):
    with open(os.path.join(ROOT, f"portbench/workloads/{traffic}.json")) as f:
        t = json.load(f)
    a = gr.make_batch(tiny_genome, t, BIG_SEED, 3, 64, 128)
    b = gr.make_batch(tiny_genome, t, BIG_SEED, 3, 64, 128)
    c = gr.make_batch(tiny_genome, t, BIG_SEED + 1, 3, 64, 128)
    for x in ("seqs", "ctg", "pos", "strand"):
        assert np.array_equal(getattr(a, x), getattr(b, x))
    assert not np.array_equal(a.seqs, c.seqs)
    assert a.first == 128 and a.seqs.shape == (64, t["read_len"])


@pytest.mark.parametrize("traffic", ["se101", "pe150"])
def test_reads_come_from_their_origin(tiny_genome, traffic):
    with open(os.path.join(ROOT, f"portbench/workloads/{traffic}.json")) as f:
        t = dict(json.load(f), sub_rate=0.0, indel_rate=0.0)
    b = gr.make_batch(tiny_genome, t, 5, 1, 400, 0)
    L = t["read_len"]
    for k in range(len(b.seqs)):
        off = tiny_genome.offsets[b.ctg[k]] + b.pos[k]
        seg = tiny_genome.codes[off:off + L]
        want = 3 - seg[::-1] if b.strand[k] else seg
        assert np.array_equal(b.seqs[k], want)
        assert (seg < 4).all()
    if t["paired"]:
        s = b.strand.reshape(-1, 2)
        p = b.pos.reshape(-1, 2)
        assert (s[:, 0] != s[:, 1]).all()       # FR: opposite strands
        fwd = np.where(s[:, 0] == 0, p[:, 0], p[:, 1])
        rev = np.where(s[:, 0] == 0, p[:, 1], p[:, 0])
        ins = rev + L - fwd
        assert (ins >= L + 10).all() and abs(ins.mean() - 400) < 20


def test_batch_reads_cut_by_bases():
    assert gr.batch_reads(dict(read_len=101, paired=False,
                               batch_bases=10_000_000)) == 99010
    assert gr.batch_reads(dict(read_len=150, paired=True,
                               batch_bases=10_000_000)) == 66668


def scalar_dp(q, t, start_e2e: bool, end_e2e: bool) -> int:
    """Gotoh's recurrence cell by cell, the window free at both ends."""
    mat = sw._mat6(1, 4)
    NEG = -10 ** 9
    L, W = len(q), len(t)
    H = [[NEG] * (W + 1) for _ in range(L + 1)]
    E = [[NEG] * (W + 1) for _ in range(L + 1)]
    F = [[NEG] * (W + 1) for _ in range(L + 1)]
    for j in range(W + 1):
        H[0][j] = 0
    best = NEG
    for i in range(1, L + 1):
        for j in range(1, W + 1):
            d = H[i - 1][j - 1]
            if not start_e2e:
                d = max(d, 0)
            m = d + int(mat[q[i - 1], t[j - 1]])
            F[i][j] = max(H[i - 1][j] - 7, F[i - 1][j] - 1)
            E[i][j] = max(H[i][j - 1] - 7, E[i][j - 1] - 1)
            H[i][j] = max(m, F[i][j], E[i][j])
            if not end_e2e or i == L:
                best = max(best, H[i][j])
    return best


def test_sw_matches_scalar_dp():
    rng = np.random.default_rng(3)
    qs, ts = [], []
    for k in range(12):
        t = rng.integers(0, 4, 40).astype(np.uint8)
        q = t[8:30].copy()
        if k % 3 == 1:
            q = np.concatenate([q[:9], q[12:], rng.integers(0, 4, 3)])
        if k % 3 == 2:
            q = np.concatenate([q[:9], rng.integers(0, 4, 4), q[9:18]])
        q = q[:22].astype(np.uint8)
        flip = rng.random(22) < 0.1
        q[flip] = (q[flip] + 1) % 4
        if k == 5:
            t[20] = 4
        qs.append(q)
        ts.append(t)
    got = sw.best_scores(np.stack(qs), np.stack(ts), SC)
    for k in range(12):
        for c, (s, e) in enumerate(sw.KINDS):
            assert got[k, c] == scalar_dp(qs[k], ts[k], s, e), (k, c)


def test_choice_follows_the_clipping_rule():
    raw = np.array([[19, 15, 19, 15],      # mismatch at the last base
                    [20, 10, 20, 10],      # clipping gains 10 > 5
                    [20, 15, 20, 15]])     # gains 5: a tie clips
    assert sw.choice(raw, 5, 5).tolist() == [15, 20, 20]
    assert sw.local_only(raw).tolist() == [19, 20, 20]


def test_int8_cells_saturate():
    q = np.zeros((1, 150), np.uint8)
    t = np.zeros((1, 170), np.uint8)
    assert sw.best_scores(q, t, SC)[0, 3] == 150
    assert sw.best_scores(q, t, SC, bits=8)[0, 3] == 127


def test_walk_nm_md_score():
    g = np.array([0, 1, 2, 3, 0, 1, 2, 3, 0, 1], np.uint8)
    q = np.array([0, 1, 0, 3, 0, 2, 3, 0, 1], np.uint8)
    assert check.walk(check.cigar_ops("4M1D5M"), q, g, SC) == \
        (3, "2G1^A0C4", -8)
    q2 = np.array([3, 3, 2, 3, 0, 1, 1, 2, 3], np.uint8)
    assert check.walk(check.cigar_ops("2S3M1I3M"), q2, g[2:], SC) == \
        (1, "6", -1)


def test_mapq_bound_is_bwas_approx_mapq_se():
    sc = dict(SC, min_seed_len=19)
    ops = check.cigar_ops
    assert check.mapq_bound(101, 0, ops("101M"), sc) == 60
    assert check.mapq_bound(30, 25, ops("101M"), sc) == 7
    assert check.mapq_bound(40, 10, ops("20S81M"), sc) == 38
    assert check.mapq_bound(40, 10, ops("30S40M"), sc) == 60   # l < 50
    assert check.mapq_bound(60, 60, ops("101M"), sc) == 0      # XS >= AS
    assert check.mapq_bound(19, 0, ops("19M"), sc) == 0        # sub's floor


def test_mapq_held_to_its_bound():
    sc = dict(SC, min_seed_len=19)

    def r(flag, mapq, xs):
        return dict(flag=flag, mapq=mapq, cigar="101M",
                    tags=dict(AS=30, XS=xs))
    assert check.mapq_ok(r(0, 7, 25), sc, False)
    assert not check.mapq_ok(r(0, 8, 25), sc, False)
    assert not check.mapq_ok(r(0, 61, 0), sc, False)
    assert not check.mapq_ok(r(4, 3, 0), sc, False)      # unmapped: 0
    # a proper pair may lift MAPQ over the single-end bound
    assert check.mapq_ok(r(0x43, 47, 25), sc, True)
    assert not check.mapq_ok(r(0x41, 47, 25), sc, True)


def rec(flag, rname, pos, cigar, rnext, pnext, tlen):
    return dict(flag=flag, rname=rname, pos=pos, cigar=cigar, rnext=rnext,
                pnext=pnext, tlen=tlen)


def test_mate_fields():
    a = rec(0x63, "chr1", 100, "150M", "=", 351, 401)
    b = rec(0x93, "chr1", 351, "150M", "=", 100, -401)
    assert check.mate_ok(a, b) and check.mate_ok(b, a)
    assert not check.mate_ok(dict(a, pnext=352), b)
    assert not check.mate_ok(dict(a, tlen=400), b)
    assert not check.mate_ok(a, dict(b, flag=0x83))     # 0x20 vs 0x10
    # an unmapped mate sits at its mate's place
    u = rec(0x89 | 0x20, "chr1", 100, "*", "=", 100, 0)
    m = rec(0x49 & ~0x8 | 0x10 | 0x8, "chr1", 100, "150M", "=", 100, 0)
    m["flag"] = 0x1 | 0x8 | 0x40 | 0x10
    u["flag"] = 0x1 | 0x4 | 0x80 | 0x20
    assert check.mate_ok(u, m) and check.mate_ok(m, u)


def test_union_gaps_and_labels():
    ivs = np.array([[10, 20], [15, 30], [40, 50], [45, 47], [90, 120]])
    u = trace.union(ivs, 0, 100)
    assert u.tolist() == [[10, 30], [40, 50], [90, 100]]
    assert trace.gaps(u, 0, 100).tolist() == [[0, 10], [30, 40], [50, 90]]
    spans = [("outer", 0, 100), ("inner", 25, 60)]
    assert trace.innermost(spans, np.array([5, 35, 70, 200]), "x") == \
        ["outer", "inner", "outer", "x"]
    ev = (["k1", "k2", "Memcpy HtoD", "k1", "k3"],
          np.array([10, 15, 40, 90, 130]), np.array([20, 30, 50, 120, 140]))
    r = trace.reduce(ev, 0, 100, spans)
    assert r["busy_s"] == 40e-9 and r["window_s"] == 100e-9
    assert r["launches"] == 3 and r["inside"] == 4
    assert r["device_ops"][0] == ["k1", 20e-9]
    assert dict(r["idle_gaps"]) == {"outer": 50e-9, "inner": 10e-9}


def test_roofline_bound_counts_band_cells():
    q = np.array([101, 50, 0, 101])
    t = np.array([150, 80, 40, 20])
    w1 = np.array([100, 3, 100, 5])
    cells = 0
    for k in range(4):
        for i in range(t[k]):
            cells += max(0, min(q[k], i + w1[k] + 1) - max(0, i - w1[k]))
    assert roofline.band_cells(q, t, w1, 512) == cells
    s, by = roofline.bound_s(q, t, w1, 2 * w1, np.array([0, 1, 0, 0]), 512)
    extra = sum(max(0, min(50, i + 7) - max(0, i - 6)) for i in range(80))
    assert by == "operations"
    assert s == pytest.approx((cells + extra) * 16 / 33.5e12)


def test_band_cells_closed_form_on_random_lanes():
    rng = np.random.default_rng(9)
    q = rng.integers(0, 300, 200)
    t = rng.integers(0, 400, 200)
    w = rng.integers(1, 250, 200)
    for t_max in (64, 333, 512):
        want = sum(max(0, min(q[k], i + w[k] + 1) - max(0, i - w[k]))
                   for k in range(200) for i in range(min(t[k], t_max)))
        assert roofline.band_cells(q, t, w, t_max) == want


def test_band_clamp_is_ksw_s():
    q = np.array([0, 1, 10, 101])
    eb = np.array([5, 5, 0, 5])
    w = roofline.clamp_band(100, q, eb, 1, 6, 1, 6, 1)
    want = [max(1, min(100, int((x + e - 6) / 1 + 1.0)))
            for x, e in zip(q, eb)]
    assert w.tolist() == want
