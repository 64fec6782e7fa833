"""The device front of bwamem_tpu_torch bails to the host-compacted front
as bwamem_tpu's does, on the CPU.

With the item arena pinned in both packages (torch_port_util.
force_front_sizes "pinned"), arena growth never converges: after its
retries each front gives up on the batch and re-runs every row on the
host-compacted front.  The port's SAM must equal the reference's byte for
byte, through align_batch_se and through `mem` on the command line, with
one `front.bailouts` and every row a fallback row.  Any other
RuntimeError inside front_finish (a CUDA error, a failed launch) must
still propagate.  (Pairs: test_torch_front_bail_pe.py.)"""
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu import cli as jcli
from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch import cli as tcli
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.pipeline import device_front as tdf
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.utils import timers

from torch_port_util import (first_diff, force_front_sizes, make_dataset,
                             torch_opt)

N_READS = 96


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("bail"), n_reads=N_READS,
                        seed=5)


@pytest.fixture
def counted():
    timers.reset()
    timers.enable(True)
    yield timers
    timers.enable(False)
    timers.reset()


def _bailed_once(snap, n_rows):
    assert snap.get("front.bailouts.count", 0) == 1
    assert snap.get("front.retries.count", 0) == tdf.MAX_RETRIES
    assert snap.get("front.fallback_rows.count", 0) == n_rows


def test_align_batch_se_bails_to_the_host_front(data, monkeypatch, counted,
                                                capfd):
    force_front_sizes(monkeypatch, "pinned")
    want = JAligner(data["jidx"]).align_batch_se(list(j_read(data["fq"])))
    capfd.readouterr()
    got = TAligner(data["tidx"], torch_opt(), device="cpu").align_batch_se(
        list(t_read(data["fq"])))
    assert want == got, first_diff(want, got)
    _bailed_once(counted.snapshot(), N_READS)
    bails = [line for line in capfd.readouterr().err.splitlines()
             if "device front bailed" in line]
    assert len(bails) == 1
    assert bails[0].startswith("[bwamem_tpu_torch] ")
    assert "arena growth did not converge: ['a_it']" in bails[0]


def test_cli_mem_bails_to_the_host_front(data, tmp_path, monkeypatch,
                                         counted):
    force_front_sizes(monkeypatch, "pinned")
    monkeypatch.setenv("BWAMEM_TPU_DEVICES", "1")     # reference: one chip
    # the @PG line echoes the command line: same relative output path
    args = ["mem", "-o", "out.sam", data["prefix"], data["fq"]]
    for sub, run in (("j", lambda: jcli.main(args)),
                     ("t", lambda: tcli.main(args, device="cpu"))):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert run() == 0
    want = (tmp_path / "j" / "out.sam").read_text()
    got = (tmp_path / "t" / "out.sam").read_text()
    assert got.startswith("@SQ\t")
    assert want == got
    _bailed_once(counted.snapshot(), N_READS)


@pytest.mark.parametrize("where", ["fetch", "retry_dispatch"])
def test_an_error_that_is_not_a_bailout_propagates(data, monkeypatch,
                                                   counted, where):
    """A RuntimeError raised inside front_finish that is not FrontBailout
    (here as a CUDA error would be, from the meta fetch or from the
    dispatch of a retry) leaves align_batch_se: nothing re-runs the batch
    elsewhere."""
    msg = "CUDA error: an illegal memory access was encountered"
    if where == "fetch":
        def fetch(x):
            raise RuntimeError(msg)
        monkeypatch.setattr(tdf, "_fetch", fetch)
    else:
        force_front_sizes(monkeypatch, "small")
        calls = []
        dispatch = tdf._dispatch

        def failing_retry(*args, **kw):
            calls.append(1)
            if len(calls) > 1:
                raise RuntimeError(msg)
            return dispatch(*args, **kw)
        monkeypatch.setattr(tdf, "_dispatch", failing_retry)
    al = TAligner(data["tidx"], torch_opt(), device="cpu")
    with pytest.raises(RuntimeError, match="illegal memory access") as e:
        al.align_batch_se(list(t_read(data["fq"])))
    assert not isinstance(e.value, tdf.FrontBailout)
    snap = counted.snapshot()
    assert snap.get("front.bailouts.count", 0) == 0
    assert snap.get("front.fallback_rows.count", 0) == 0
    if where == "retry_dispatch":
        assert len(calls) == 2
