"""The device front's own timers in bwamem_tpu_torch, on the CPU: its scan
trips, arena sizes and CHAIN counters against the token it dispatched and
the seed grids CHAIN was given, the rerun span of a
forced regrowth, the fallback causes against front.fallback_rows, the
spans portbench's Recorder sees, and `mem`'s report on stderr.  Only the
port runs: 96 reads of 101 bp on a 50 kbp simdata genome."""
import pytest

from bwamem_tpu_torch import cli
from bwamem_tpu_torch.io.fastq import Read, read_fastx
from bwamem_tpu_torch.ops import chain as chainops
from bwamem_tpu_torch.pipeline import device_front
from bwamem_tpu_torch.pipeline.align import Aligner
from bwamem_tpu_torch.utils import timers

from torch_port_util import run_cli, torch_opt

PROGRAMS = ("front.p1", "front.p2", "front.p3", "front.expand",
            "front.chain", "front.ext")
CAUSES = ("gated", "s_cap", "demoted", "abort", "bailout", "timeout",
          "undispatched")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    import simdata
    from bwamem_tpu_torch.index import build_index, load_index
    d = tmp_path_factory.mktemp("front_timers")
    contigs = simdata.make_genome(50_000, seed=5, n_contigs=2)
    simdata.write_fasta(contigs, str(d / "g.fa"))
    simdata.write_fastq(simdata.sim_reads(contigs, 96, read_len=101,
                                          seed=6), str(d / "r.fq"))
    build_index(str(d / "g.fa"), with_kmer_table=True).save(str(d / "g"))
    return dict(prefix=str(d / "g"), fq=str(d / "r.fq"),
                idx=load_index(str(d / "g")),
                reads=list(read_fastx(str(d / "r.fq"))))


@pytest.fixture
def on():
    timers.reset()
    timers.enable(True)
    try:
        yield
    finally:
        timers.enable(False)
        timers.reset()


def _aligner(data, **opts):
    opt = torch_opt()
    for k, v in opts.items():
        setattr(opt, k, v)
    return Aligner(data["idx"], opt, device="cpu")


@pytest.mark.parametrize("how", ["default", "small"])
def test_trips_and_sizes_of_the_kept_dispatch(data, on, monkeypatch, how):
    from torch_front_force import forced_front
    grids = []
    chain_seeds = chainops.chain_seeds

    def seen(seeds, *a, **k):
        grids.append((int(seeds.valid.sum()), seeds.valid.numel()))
        return chain_seeds(seeds, *a, **k)
    monkeypatch.setattr(chainops, "chain_seeds", seen)
    al = _aligner(data)
    if how == "small":
        with forced_front("small"):
            front = al.begin_batch(data["reads"])
    else:
        front = al.begin_batch(data["reads"])
    tok = front["tok"]
    device_front.front_finish(al, tok)
    snap = timers.snapshot()
    sizes = tok["sizes"]
    meta = tok["arrs"][0].cpu().numpy().max(axis=1)     # the kept dispatch
    m1, m2, m3 = meta[0:8], meta[8:16], meta[16:24]
    assert snap["front.trips.run.count"] == (sizes["t1s"] + sizes["t2s"]
                                             + sizes["t3s"])
    assert snap["front.trips.used.count"] == int(m1[6] + m2[7] + m3[4])
    assert 0 < snap["front.trips.used.count"] <= snap["front.trips.run.count"]
    for k, v in sizes.items():
        assert snap["front.size." + k + ".gauge"] == (v, v)
    # CHAIN's work in the kept dispatch: its grids' valid seeds against
    # their slots; no kernel on the CPU
    assert len(grids) >= 1
    assert (snap["front.chain.seeds.count"],
            snap["front.chain.slots.count"]) == grids[-1]
    assert 0 < grids[-1][0] < grids[-1][1]
    assert snap["front.chain.launches.count"] == 0
    retries = snap.get("front.retries.count", 0)
    if how == "small":
        assert retries >= 1
    # one rerun span a retry, holding its dispatch and its meta fetch
    assert ("front.regrow" in snap) == (retries > 0)
    sp = timers.spans()
    regrow = [i for i, s in enumerate(sp) if s[0] == "front.regrow"]
    assert len(regrow) == retries
    for i in regrow:
        assert sp[i][2] > sp[i][1]
        kids = [s[0] for s in sp if s[3] == i]
        assert kids == ["front.dispatch", "front.fetch"]
    # every program a device section, a host span (no .gpu on the CPU)
    for p in PROGRAMS:
        assert snap[p][0] == retries + 1
        assert p + ".gpu" not in snap


def _fallback(data, kind, monkeypatch):
    """The timers' snapshot of a 16-read batch whose rows the host front
    takes for the cause `kind`."""
    reads = data["reads"][:16]
    opts = {}
    if kind in ("gated", "abort"):
        # -W 4 gates every read of 88 bases or more (mem_flt_chained_seeds)
        opts["min_chain_weight"] = 4
        if kind == "gated":
            reads = ([Read(r.name, r.seq[:60], r.qual[:60])
                      for r in reads[:12]] + reads[12:])
    if kind == "undispatched":
        monkeypatch.setenv("BWAMEM_TPU_FRONT", "host")
    al = _aligner(data, **opts)
    al.align_batch_se(reads)
    return timers.snapshot()


@pytest.mark.parametrize("kind,rows", [("gated", 4), ("abort", 16),
                                       ("undispatched", 16)])
def test_fallback_causes_sum_to_the_fallback_rows(data, on, monkeypatch,
                                                  kind, rows):
    snap = _fallback(data, kind, monkeypatch)
    causes = {c: snap.get(f"front.fallback.{c}.count", 0) for c in CAUSES}
    assert snap["front.fallback_rows.count"] == rows
    assert sum(causes.values()) == rows
    assert causes[kind] == rows
    # the host front ran once, over the rows handed back
    assert snap["front.host"][0] == 1


def test_recorder_sees_the_new_sections(data, monkeypatch):
    """portbench.spans.Recorder (the benchmark's wrapper of timers.section
    and start/stop) gets the device sections, front.host and front.regrow
    under the names and counts timers.spans() has."""
    from portbench import spans
    from torch_front_force import forced_front
    reads = ([Read(r.name, r.seq[:60], r.qual[:60])
              for r in data["reads"][:60]] + data["reads"][60:])
    al = _aligner(data, min_chain_weight=4)
    rec = spans.Recorder()
    rec.install()
    try:
        with forced_front("small"):
            al.align_batch_se(reads)
        got = timers.spans()
    finally:
        rec.uninstall()
        timers.enable(False)
        timers.reset()
    new = set(PROGRAMS) | {"front.host", "front.regrow"}
    mine = [s[0] for s in got if s[0] in new]
    theirs = [s[0] for s in rec.spans if s[0] in new]
    assert set(mine) == new
    assert sorted(mine) == sorted(theirs)


def test_mem_prints_the_report(data, on):
    rc, out, err = run_cli(cli, ["mem", data["prefix"], data["fq"]],
                           device="cpu")
    assert rc == 0 and out.count("\n") > 96
    rows = {ln.split()[0] for ln in err.splitlines() if ln.strip()}
    for name in PROGRAMS + ("front.trips.run", "front.trips.used",
                            "front.size.t1s", "front.fallback_rows",
                            "front.chain.seeds", "front.chain.slots",
                            "front.chain.launches"):
        assert name in rows, name
    # the byte counters of the old transport are gone
    assert not any(r.startswith(("d2h.", "h2d.")) for r in rows)
