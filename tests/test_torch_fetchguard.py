"""The fetch watchdog of bwamem_tpu_torch (utils/fetchguard.py) and the
switches that send batches to the host-compacted front, on the CPU.

A device fetch that outlasts its timeout raises FetchTimeout; the device
front then re-runs the batch on the host-compacted front and stays off for
the process (the reference's device_front.py:1015-1025).  Forced here by a
copy that blocks past a 1 s limit: the batch's SAM must still equal
bwamem_tpu's, and the next batch must take the host front.
BWAMEM_TPU_FRONT=host sends every batch there from the start."""
import threading
import time

import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401

from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.utils import fetchguard, timers

from torch_port_util import first_diff, make_dataset, torch_opt

N_READS = 64


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = make_dataset(tmp_path_factory.mktemp("fetchguard"),
                     n_reads=N_READS, seed=31)
    d["want"] = JAligner(d["jidx"]).align_batch_se(list(j_read(d["fq"])))
    return d


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.setattr(fetchguard, "_suspect", False)
    timers.reset()
    timers.enable(True)
    yield timers
    timers.enable(False)
    timers.reset()


def _blocking_copy(monkeypatch, seconds, calls=1):
    """The first `calls` copies wait `seconds` before copying."""
    orig = fetchguard._copy
    n = [0]

    def copy(tensors):
        n[0] += 1
        if n[0] <= calls:
            time.sleep(seconds)
        return orig(tensors)
    monkeypatch.setattr(fetchguard, "_copy", copy)
    return n


def test_fetch_copies_in_order():
    a, b = torch.arange(6).reshape(2, 3), torch.ones(4, dtype=torch.int8)
    got = fetchguard.fetch([a, b], timeout=5)
    assert [x.dtype for x in got] == [np.int64, np.int8]
    assert np.array_equal(got[0], a.numpy()) and np.array_equal(got[1],
                                                                b.numpy())


def test_fetch_times_out(monkeypatch, counted):
    _blocking_copy(monkeypatch, 3)
    t0 = time.perf_counter()
    with pytest.raises(fetchguard.FetchTimeout, match="meta"):
        fetchguard.fetch([torch.zeros(3)], timeout=0.5, what="meta")
    assert time.perf_counter() - t0 < 2.5
    assert fetchguard.device_suspect()


def test_fetch_error_propagates_and_timeout_off(monkeypatch, counted):
    def bad(tensors):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(fetchguard, "_copy", bad)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        fetchguard.fetch([torch.zeros(3)], timeout=5)
    seen = []
    monkeypatch.setattr(fetchguard, "_copy", lambda ts: seen.append(
        threading.current_thread()) or [t.numpy() for t in ts])
    fetchguard.fetch([torch.zeros(3)], timeout=0)
    assert seen == [threading.main_thread()]
    assert not fetchguard.device_suspect()


def test_front_fetch_timeout_reruns_on_host_front(data, monkeypatch,
                                                  counted):
    monkeypatch.setattr(fetchguard, "DEFAULT_TIMEOUT", 1.0)
    calls = _blocking_copy(monkeypatch, 3)
    reads = list(t_read(data["fq"]))
    half = N_READS // 2
    al = TAligner(data["tidx"], torch_opt(), device="cpu")
    got = al.align_batch_se(reads[:half])
    assert calls[0] > 1
    assert got == data["want"][:half], first_diff(data["want"][:half], got)
    assert al._front_disabled and fetchguard.device_suspect()
    snap = counted.snapshot()
    assert snap.get("front.fetch_timeouts.count", 0) == 1
    assert snap.get("front.fallback_rows.count", 0) == half
    assert snap.get("front.bailouts.count", 0) == 0
    counted.reset()
    got = al.align_batch_se(reads[half:], half)
    assert got == data["want"][half:], first_diff(data["want"][half:], got)
    snap = counted.snapshot()
    assert snap.get("dispatch.front.count", 0) == 0
    assert snap.get("front.fallback_rows.count", 0) == N_READS - half
    assert snap.get("front.fetch_timeouts.count", 0) == 0


def test_front_host_switch(data, monkeypatch, counted):
    monkeypatch.setenv("BWAMEM_TPU_FRONT", "host")
    al = TAligner(data["tidx"], torch_opt(), device="cpu")
    got = al.align_batch_se(list(t_read(data["fq"])))
    assert got == data["want"], first_diff(data["want"], got)
    snap = counted.snapshot()
    assert snap.get("dispatch.front.count", 0) == 0
    assert snap.get("front.fallback_rows.count", 0) == N_READS
    assert not al._front_disabled
