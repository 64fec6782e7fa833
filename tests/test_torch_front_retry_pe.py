"""The grow-and-retry loop of bwamem_tpu_torch's device front, on the CPU,
on 48 pairs of 150 bp through align_batch_pe, with every first-dispatch
arena of torch_front_force.SMALL_ARENAS forced small in both packages: at
least one retry, and the reference's SAM byte for byte, which is also the
port's own from the default sizes (torch_port_util.retry_matches).
(Single-end: test_torch_front_retry.py.)"""
import pytest

import bwamem_tpu  # noqa: F401

from torch_port_util import make_dataset, retry_matches


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("retry_pe"), n_reads=4,
                        seed=5, n_pairs=48, pe_read_len=150)


def test_small_arenas_grow_and_retry_to_the_same_sam(data, monkeypatch):
    retry_matches(data, monkeypatch, pe=True)
