"""The device front's arena high-water history saved to disk
(pipeline/device_front.hist_path / hist_load / hist_save), on the CPU.

With BWAMEM_TPU_HWM_DIR set, an aligner whose first batch grew its arenas
(forced small here, as tools/torch_front_force.py does) writes the sizes
it measured, and a second aligner starts from them: no regrowth, and the
SAM of both equals bwamem_tpu's.  With the variable unset nothing is
written and every aligner starts from the shape-scaled defaults."""
import json

import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.pipeline import device_front as tdf
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.utils import timers

from torch_port_util import first_diff, make_dataset, torch_opt
from torch_front_force import sized   # tools/: torch_port_util's path

KEY = (128, 128)          # (rows, padded read length) of the 96-read batch


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = make_dataset(tmp_path_factory.mktemp("saved"), seed=41)
    d["want"] = JAligner(d["jidx"]).align_batch_se(list(j_read(d["fq"])))
    return d


def _run(data):
    timers.reset()
    timers.enable(True)
    try:
        al = TAligner(data["tidx"], torch_opt(), device="cpu")
        got = al.align_batch_se(list(t_read(data["fq"])))
        return al, got, timers.snapshot()
    finally:
        timers.enable(False)
        timers.reset()


def test_saved_sizes_start_the_next_aligner(data, tmp_path, monkeypatch):
    d = tmp_path / "hwm"
    monkeypatch.setenv("BWAMEM_TPU_HWM_DIR", str(d))
    with monkeypatch.context() as m:
        orig = tdf._sizes_for
        m.setattr(tdf, "_sizes_for",
                  lambda hist, N, Lr: sized(orig(hist, N, Lr), "small"))
        first, got, snap = _run(data)
    assert got == data["want"], first_diff(data["want"], got)
    assert snap.get("front.retries.count", 0) >= 1
    path = tdf.hist_path(first)
    assert path.startswith(str(d)) and path.endswith(".json")
    saved = json.load(open(path))
    assert saved and all(k.endswith(":%d:%d" % KEY) for k in saved)

    second, got, snap = _run(data)
    assert second._front_hist == first._front_hist
    assert got == data["want"], first_diff(data["want"], got)
    assert snap.get("front.retries.count", 0) == 0
    assert snap.get("dispatch.front.count", 0) == 6
    # it started from the saved sizes, not from the defaults
    start = tdf._sizes_for(second._front_hist, *KEY)
    assert start == tdf._sizes_for(first._front_hist, *KEY)
    assert start != tdf._sizes_for({}, *KEY)


def test_nothing_saved_unless_asked(data, tmp_path, monkeypatch):
    monkeypatch.delenv("BWAMEM_TPU_HWM_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    al, got, _ = _run(data)
    assert tdf.hist_path(al) is None
    assert got == data["want"]
    assert al._front_hist and not list(tmp_path.iterdir())
    # an unreadable file is no history
    monkeypatch.setenv("BWAMEM_TPU_HWM_DIR", str(tmp_path))
    path = tdf.hist_path(al)
    open(path, "w").write("{not json")
    assert tdf.hist_load(al) == {}
