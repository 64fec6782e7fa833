"""Single-end SAM from bwamem_tpu_torch on the CPU, byte for byte against
bwamem_tpu's, on 250 bp reads: the plain batch, where no row falls back,
and the same batch with a forced seed-cap overflow, where the device
front hands some rows to the host-compacted front and their regions are
merged back by row.  (A mixed 101/1000 bp batch:
test_torch_align_mixed.py.)"""
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.utils import timers

from torch_port_util import (dataset_contigs, long_reads_fq, make_dataset,
                             torch_opt)

N_250 = 16


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("fallback")
    data = make_dataset(d, n_reads=4, seed=7)
    data["fq250"] = long_reads_fq(d / "r250.fq", dataset_contigs(seed=7),
                                  N_250, 250, 44)
    return data


@pytest.fixture
def counted():
    timers.reset()
    timers.enable(True)
    yield timers
    timers.enable(False)
    timers.reset()


def _both(data, fq, s_cap_key=None):
    ja = JAligner(data["jidx"])
    ta = TAligner(data["tidx"], torch_opt(), device="cpu")
    if s_cap_key is not None:
        # a device-front seed cap of 16, forced through the arena history
        ja._front_hist = {s_cap_key: 1}
        ta._front_hist[s_cap_key] = 1
    want = ja.align_batch_se(list(j_read(fq)))
    got = ta.align_batch_se(list(t_read(fq)))
    bad = [i for i in range(min(len(want), len(got))) if want[i] != got[i]]
    assert want == got, (len(want), len(got), bad[:3])


def test_250bp_batch(data, counted):
    _both(data, data["fq250"])
    assert counted.snapshot().get("front.fallback_rows.count", 0) == 0


def test_seed_cap_overflow_rows(data, counted):
    """Some 250 bp reads hold more than 16 seeds: with the cap forced to 16
    in both aligners those rows are re-run through the host-compacted
    front and merged by row."""
    _both(data, data["fq250"], s_cap_key=("hwm", "s_cap", (16, 256)))
    n_fb = counted.snapshot().get("front.fallback_rows.count", 0)
    assert 0 < n_fb < N_250
