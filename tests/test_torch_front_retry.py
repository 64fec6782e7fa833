"""The grow-and-retry loop of bwamem_tpu_torch's device front, on the CPU,
on 96 single-end reads of 101 bp.

Every first-dispatch arena of tools/torch_front_force.SMALL_ARENAS is forced
small in both packages (torch_port_util.force_front_sizes "small"), so the
front overflows, grows its arenas and reruns the batch.  The port must
retry at least once and write the reference's SAM byte for byte, which is
also its own SAM from the default sizes, with no row handed to the host
front (torch_port_util.retry_matches).  (Pairs:
test_torch_front_retry_pe.py.)"""
import pytest

import bwamem_tpu  # noqa: F401

from torch_port_util import make_dataset, retry_matches


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("retry"), n_reads=96,
                        seed=5)


def test_small_arenas_grow_and_retry_to_the_same_sam(data, monkeypatch):
    retry_matches(data, monkeypatch, pe=False)
