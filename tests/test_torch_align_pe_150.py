"""Paired-end SAM from bwamem_tpu_torch on the CPU, byte for byte against
bwamem_tpu's on 128 pairs of 150 bp from a simulated genome:
align_batch_pe on the whole set, and align_stream(pe=True) over two
batches, where batch 1 keeps counting read ids where batch 0 stopped and
infers its own insert-size distribution."""
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu.pipeline.align import align_stream as j_stream
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.pipeline.align import align_stream as t_stream
from bwamem_tpu_torch.utils import timers

from torch_port_util import (first_diff, make_dataset, pe_both, pe_reads,
                             sam_flags, torch_opt)

N_PAIRS = 128


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("pe150"), genome_len=100_000,
                        n_reads=4, seed=191, n_pairs=N_PAIRS,
                        pe_read_len=150)


@pytest.fixture
def counted():
    timers.reset()
    timers.enable(True)
    yield
    snap = timers.snapshot()
    timers.enable(False)
    timers.reset()
    assert snap.get("front.fallback_rows.count", 0) == 0


def test_align_batch_pe_150(data, counted):
    got = pe_both(data)
    assert len(got) == 2 * N_PAIRS
    assert sum(1 for f in sam_flags(got) if f & 2) > 1.6 * N_PAIRS
    assert all(len(s.split("\t")[9]) == 150 for s in got)


def test_align_stream_pe_two_batches(data, counted):
    def batches(reads):
        return [reads[:160], reads[160:]]
    want = [s for _, ss in j_stream(JAligner(data["jidx"]),
                                    batches(pe_reads(data, "j")), pe=True)
            for s in ss]
    n_seen, got = [], []
    for n, ss in t_stream(TAligner(data["tidx"], torch_opt(), device="cpu"),
                          batches(pe_reads(data, "t")), pe=True):
        n_seen.append(n)
        got.extend(ss)
    assert n_seen == [160, 96]
    assert want == got, first_diff(want, got)
    assert timers.snapshot()["pestat.batch"][0] == 2
