"""The device front of bwamem_tpu_torch bails to the host-compacted front
as bwamem_tpu's does, on paired-end reads, on the CPU: 48 pairs of 150 bp
through align_batch_pe with the item arena pinned in both packages
(torch_port_util.force_front_sizes "pinned").  The port's SAM must equal
the reference's byte for byte, with one `front.bailouts` and every read a
fallback row.  (Single-end and the command line:
test_torch_front_bail.py.)"""
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu_torch.pipeline import device_front as tdf
from bwamem_tpu_torch.utils import timers

from torch_port_util import force_front_sizes, make_dataset, pe_both

N_PAIRS = 48


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("bail_pe"), n_reads=4,
                        seed=5, n_pairs=N_PAIRS, pe_read_len=150)


def test_align_batch_pe_bails_to_the_host_front(data, monkeypatch):
    force_front_sizes(monkeypatch, "pinned")
    timers.reset()
    timers.enable(True)
    try:
        pe_both(data)
        snap = timers.snapshot()
    finally:
        timers.enable(False)
        timers.reset()
    assert snap.get("front.bailouts.count", 0) == 1
    assert snap.get("front.retries.count", 0) == tdf.MAX_RETRIES
    assert snap.get("front.fallback_rows.count", 0) == 2 * N_PAIRS
