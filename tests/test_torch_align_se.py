"""Single-end SAM from bwamem_tpu_torch on the CPU, byte for byte against
bwamem_tpu's on a simulated genome: align_batch_se with the two-round
extension on and off, align_stream over two batches, and `mem` through the
CLI, header included.  No read falls back to the host-compacted front."""
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu import cli as jcli
from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu.pipeline.align import align_stream as j_stream
from bwamem_tpu_torch import cli as tcli
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.pipeline.align import align_stream as t_stream
from bwamem_tpu_torch.utils import timers

from torch_port_util import make_dataset, torch_opt


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("se"), n_reads=160,
                        kmer=True, seed=11)


@pytest.fixture
def counted():
    timers.reset()
    timers.enable(True)
    yield
    snap = timers.snapshot()
    timers.enable(False)
    timers.reset()
    assert snap.get("front.fallback_rows.count", 0) == 0


def _first_diff(a, b):
    bad = [i for i in range(min(len(a), len(b))) if a[i] != b[i]]
    return (len(a), len(b), bad[:3],
            [(a[i], b[i]) for i in bad[:1]])


@pytest.mark.parametrize("ext2", ["1", "0"])
def test_align_batch_se(data, monkeypatch, counted, ext2):
    monkeypatch.setenv("BWAMEM_TPU_EXT2", ext2)
    want = JAligner(data["jidx"]).align_batch_se(list(j_read(data["fq"])))
    got = TAligner(data["tidx"], torch_opt(), device="cpu").align_batch_se(
        list(t_read(data["fq"])))
    assert want == got, _first_diff(want, got)
    assert sum(s.count("\n") for s in got) >= len(got)


def test_align_stream_two_batches(data, counted):
    def batches(reads):
        return [reads[:96], reads[96:]]
    want = [s for _, ss in j_stream(JAligner(data["jidx"]),
                                    batches(list(j_read(data["fq"]))))
            for s in ss]
    n_seen = []
    got = []
    for n, ss in t_stream(TAligner(data["tidx"], torch_opt(), device="cpu"),
                          batches(list(t_read(data["fq"])))):
        n_seen.append(n)
        got.extend(ss)
    assert n_seen == [96, 64]
    assert want == got, _first_diff(want, got)


def test_cli_mem(data, tmp_path, monkeypatch, counted):
    monkeypatch.setenv("BWAMEM_TPU_DEVICES", "1")     # reference: one chip
    # the @PG line echoes the command line: same relative output path
    args = ["mem", "-o", "out.sam", "-K", "10000", data["prefix"],
            data["fq"]]
    for sub, run in (("j", lambda: jcli.main(args)),
                     ("t", lambda: tcli.main(args, device="cpu"))):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert run() == 0
    want = (tmp_path / "j" / "out.sam").read_text()
    got = (tmp_path / "t" / "out.sam").read_text()
    assert got.startswith("@SQ\t")
    assert want == got
