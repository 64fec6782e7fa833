"""`fastmap`, `maxk` and `pemerge` of bwamem_tpu_torch's CLI on the CPU
against bwamem_tpu's, byte for byte: fastmap's stdout with the defaults and
with -w, -l, -p and -i, on reads that include one with Ns and one longer
than the rest; a fastmap run whose first scan trip count leaves lanes
unfinished, so the rerun is exercised; maxk with and without -s (and with
the .bwt file as its first argument); pemerge's stdout and stderr with the
defaults and with -m -T 20.  The index is bwamem_tpu's build_index of a
tools/simdata.py genome."""
import numpy as np
import pytest

import bwamem_tpu.cli as jcli
import bwamem_tpu_torch.cli as tcli
from bwamem_tpu_torch.pipeline import seeding_host as tsh
from bwamem_tpu_torch.utils import timers

import torch_port_util as U
import simdata  # noqa: E402  (tools/, put on the path by torch_port_util)
from torch_port_util import run_cli as run


def both(argv):
    """The same command through both packages (the port on the CPU)."""
    want = run(jcli, argv)
    got = run(tcli, argv, device="cpu")
    assert want[0] == 0
    assert got == want
    return got


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_seeding")
    ds = U.make_dataset(d / "idx", genome_len=30_000, n_reads=40,
                        n_contigs=2)
    contigs = U.dataset_contigs(genome_len=30_000, n_contigs=2)
    seq = next(iter(contigs.values()))
    # a read with Ns (ambiguous pivots), and one longer than the rest
    extra = [("withN", seq[1000:1040] + "NN" + seq[1042:1101], None),
             ("long", seq[5000:5180], None)]
    fq = d / "r.fq"
    with open(ds["fq"]) as f:
        text = f.read()
    with open(fq, "w") as f:
        f.write(text)
        for name, s, _ in extra:
            f.write(f"@{name}\n{s}\n+\n{'I' * len(s)}\n")
    fa = d / "slice.fa"
    fa.write_text(f">slice\n{seq[:2400]}\n")
    return dict(prefix=ds["prefix"], fq=str(fq), fa=str(fa),
                contigs=contigs, d=d)


@pytest.mark.parametrize("flags", [[], ["-w", "40", "-l", "10", "-p"],
                                   ["-i", "2", "-l", "12"],
                                   ["-I", "5", "-L", "3"]])
def test_fastmap_identical(data, flags):
    rc, out, err = both(["fastmap", *flags, data["prefix"], data["fq"]])
    assert out.count("SQ\t") == 42 and "\tlong\t180" in out
    if "-I" in flags:
        assert err == ("[W::fastmap] -I not supported yet\n"
                       "[W::fastmap] -L not supported yet\n")


def test_fastmap_rerun_of_unfinished_scan(data, monkeypatch):
    """A first trip count of 16 leaves every lane unfinished: the scan
    reruns with twice the trips until none is, and the output is the
    same."""
    want = run(jcli, ["fastmap", data["prefix"], data["fq"]])
    monkeypatch.setattr(tsh, "scan_trips", lambda L: 16)
    timers.reset()
    timers.enable(True)
    try:
        got = run(tcli, ["fastmap", data["prefix"], data["fq"]],
                  device="cpu")
    finally:
        timers.enable(False)
    snap = timers.snapshot()
    timers.reset()
    assert got == want
    # 16, 32, 64, 128, 256 trips: reads padded to 256 bases need 4 reruns
    assert snap["seed.scan.reruns.count"] >= 3
    assert snap["seed.scan.trips.count"] >= 16 + 32 + 64 + 128


def test_scan_wrappers_run_every_lane_to_its_end(data):
    """smem_batch's candidates on a read that is an exact copy of the
    genome: its longest SMEM back-extends to the read's first base, and
    every candidate's start is a real position."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import Read
    from bwamem_tpu_torch.ops import fm as fmops
    seq = next(iter(data["contigs"].values()))[7000:7120]
    codes = np.frombuffer(seq.encode(), np.uint8)
    nt4 = np.full(256, 4, np.uint8)
    nt4[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    read = Read(name="exact", seq=nt4[codes].copy())
    fm = fmops.fm_from_index(load_index(data["prefix"]), "cpu")
    sm = tsh.smem_batch(fm, [read], 1)
    slots = np.nonzero(sm.emit[0])[0]
    assert slots.size >= 1
    assert int(sm.s[0, slots].min()) == 0
    assert int(sm.end[0, slots].max()) == 120
    assert (sm.x2[0, slots] >= 1).all()


@pytest.mark.parametrize("which", ["reads", "self", "bwt_path"])
def test_maxk_identical(data, which):
    argv = {"reads": ["maxk", data["prefix"], data["fq"]],
            "self": ["maxk", "-s", data["prefix"], data["fa"]],
            "bwt_path": ["maxk", data["prefix"] + ".bwt", data["fq"]]}[which]
    if which == "bwt_path":
        from bwamem_tpu.index import load_index
        load_index(data["prefix"]).save_reference_format(data["prefix"])
    rc, out, err = both(argv)
    hist = [int(line.split("\t")[1]) for line in out.splitlines()]
    assert len(hist) == 256 and sum(hist) > 0


@pytest.fixture(scope="module")
def pem_data(data):
    """Pairs in the shape of tests/test_pemerge.py: overlapping short
    inserts, unmergeable long ones, varied qualities."""
    d = data["d"]
    contigs = data["contigs"]
    reads = simdata.sim_reads(contigs, 120, read_len=100, seed=8,
                              sub_rate=0.01, indel_rate=0.0, paired=True,
                              insert_mean=150, insert_std=15)
    reads += simdata.sim_reads(contigs, 40, read_len=100, seed=9,
                               sub_rate=0.01, indel_rate=0.0, paired=True,
                               insert_mean=420, insert_std=30)
    rng = np.random.default_rng(11)
    reads = [(n, s, "".join(chr(33 + q) for q in rng.integers(2, 41, len(s))))
             for n, s, q in reads]
    r1, r2 = d / "p1.fq", d / "p2.fq"
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i in range(0, len(reads), 2):
            n, s, q = reads[i]
            f1.write(f"@{n}/1\n{s}\n+\n{q}\n")
            n, s, q = reads[i + 1]
            f2.write(f"@{n}/2\n{s}\n+\n{q}\n")
    return str(r1), str(r2)


@pytest.mark.parametrize("flags", [[], ["-m", "-T", "20"], ["-u", "-Q", "40"]])
def test_pemerge_identical(pem_data, flags):
    rc, out, err = both(["pemerge", *flags, *pem_data])
    n_merged = int(err.splitlines()[0].split()[0])
    assert 30 < n_merged < 80
    assert len(err.splitlines()) == 9
