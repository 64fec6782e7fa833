"""Paired-end SAM from bwamem_tpu_torch on the CPU, byte for byte against
bwamem_tpu's on 128 pairs of 101 bp from a simulated genome:
align_batch_pe, a batch too small for pestat (8 pairs), a given -I
distribution, the per-pair mem_pair route (-5 and -P) and no rescue (-S).
No read falls back to the host-compacted front.  (150 bp pairs and the
stream: test_torch_align_pe_150.py; the CLI: test_torch_align_pe_cli.py.)"""
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu.config import (MEM_F_NO_RESCUE, MEM_F_NOPAIRING,
                               MEM_F_PRIMARY5, MEM_F_KEEP_SUPP_MAPQ)
from bwamem_tpu_torch.utils import timers

from torch_port_util import make_dataset, pe_both, sam_flags

N_PAIRS = 128
SPEC = dict(avg=400.0, std=40.0, high=560, low=240)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("pe101"), genome_len=100_000,
                        n_reads=4, seed=142, n_pairs=N_PAIRS,
                        pe_read_len=101)


@pytest.fixture
def counted():
    timers.reset()
    timers.enable(True)
    yield
    snap = timers.snapshot()
    timers.enable(False)
    timers.reset()
    assert snap.get("front.fallback_rows.count", 0) == 0


def test_align_batch_pe(data, counted):
    got = pe_both(data)
    fl = sam_flags(got)
    assert len(got) == 2 * N_PAIRS
    assert sum(1 for f in fl if f & 2) > 1.6 * N_PAIRS    # proper pairs
    assert all(f & 1 for f in fl)
    assert all(f & (0x40 if i % 2 == 0 else 0x80) for i, f in enumerate(fl))
    snap = timers.snapshot()
    assert snap["pair.native"][0] == 1 and snap["pestat.batch"][0] == 1


def test_batch_where_pestat_fails(data, counted):
    """8 pairs: every orientation has under 10 samples, so no pair is
    proper and no mate is rescued."""
    got = pe_both(data, n_pairs=8)
    assert not any(f & 2 for f in sam_flags(got))
    assert timers.snapshot().get("matesw.jobs.count", 0) == 0


def test_given_insert_size_distribution(data, counted):
    """pes0 (the -I spec) replaces pestat, also where pestat would fail,
    and read ids start mid-stream."""
    got = pe_both(data, n_pairs=8, pes0=SPEC, n_processed=4096)
    assert sum(1 for f in sam_flags(got) if f & 2) >= 12
    assert "pestat.batch" not in timers.snapshot()


def test_narrow_distribution_rescues_mates(data, counted):
    pe_both(data, pes0=dict(SPEC, std=5.0, high=420, low=380))
    assert timers.snapshot()["matesw.jobs.count"] > 0


@pytest.mark.parametrize("flag", [MEM_F_PRIMARY5 | MEM_F_KEEP_SUPP_MAPQ,
                                  MEM_F_NOPAIRING, MEM_F_NO_RESCUE],
                         ids=["-5", "-P", "-S"])
def test_per_pair_route_and_no_rescue(data, counted, flag):
    """-5 and -P skip native pair_batch (pair.mem_pair, or no pairing);
    -S skips mate rescue."""
    pe_both(data, flag=flag)
    snap = timers.snapshot()
    if flag == MEM_F_NO_RESCUE:
        assert "matesw.batch" not in snap and "pair.native" in snap
    else:
        assert "pair.native" not in snap and "matesw.batch" in snap
