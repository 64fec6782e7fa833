"""Single-end SAM from bwamem_tpu_torch on the CPU, byte for byte against
bwamem_tpu's, for batches the device front hands whole to the
host-compacted front: 1000 bp reads, clean and noisy, through
align_batch_se, and `mem` through the CLI on the 1000 bp FASTQ.  (Mixed
batches, 250 bp reads and seed-cap overflows: test_torch_align_fallback.py;
reads over 4095 bases: test_torch_align_5k.py.)"""
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu import cli as jcli
from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch import cli as tcli
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.utils import timers

from torch_port_util import (dataset_contigs, long_reads_fq, make_dataset,
                             torch_opt)

# name -> (reads, read length, simdata seed, substitution rate, indel rate,
# expected rows through the host-compacted front); the noisy profile is the
# one of tests/test_e2e_longread.py
BATCHES = {
    "1000bp": (8, 1000, 55, 0.02, 0.003, 8),
    "1000bp_noisy": (8, 1000, 66, 0.08, 0.01, 8),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("long")
    data = make_dataset(d, n_reads=4, seed=7)
    contigs = dataset_contigs(seed=7)
    data["fqs"] = {
        name: long_reads_fq(d / f"{name}.fq", contigs, n, rl, seed, sub, ind)
        for name, (n, rl, seed, sub, ind, _) in BATCHES.items()}
    return data


@pytest.fixture
def counted():
    timers.reset()
    timers.enable(True)
    yield timers
    timers.enable(False)
    timers.reset()


def _first_diff(a, b):
    bad = [i for i in range(min(len(a), len(b))) if a[i] != b[i]]
    return (len(a), len(b), bad[:3], [(a[i], b[i]) for i in bad[:1]])


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_align_batch_se(data, counted, name):
    fq = data["fqs"][name]
    want = JAligner(data["jidx"]).align_batch_se(list(j_read(fq)))
    got = TAligner(data["tidx"], torch_opt(), device="cpu").align_batch_se(
        list(t_read(fq)))
    assert want == got, _first_diff(want, got)
    assert sum(not (int(s.split("\t")[1]) & 4) for s in got) >= len(got) - 1
    snap = counted.snapshot()
    assert snap.get("front.fallback_rows.count", 0) == BATCHES[name][5]
    assert "dispatch.front.count" not in snap     # every row is gated


def test_cli_mem_long_reads(data, tmp_path, monkeypatch):
    monkeypatch.setenv("BWAMEM_TPU_DEVICES", "1")     # reference: one chip
    # the @PG line echoes the command line: same relative output path
    args = ["mem", "-o", "out.sam", data["prefix"], data["fqs"]["1000bp"]]
    for sub, run in (("j", lambda: jcli.main(args)),
                     ("t", lambda: tcli.main(args, device="cpu"))):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert run() == 0
    want = (tmp_path / "j" / "out.sam").read_text()
    got = (tmp_path / "t" / "out.sam").read_text()
    assert got.startswith("@SQ\t")
    assert want == got
