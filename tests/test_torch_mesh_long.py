"""The data-parallel mesh of bwamem_tpu_torch on batches the device front
hands whole to the host-compacted front, on the CPU: 8 reads of 1000 bp
over a 2-shard mesh (SAM against bwamem_tpu's over a 2-device mesh of the
conftest's virtual CPU devices, and the port's on one device; every row
through the host front), and 4 short reads over a 16-shard mesh, a batch
whose row bucket (8) is under the shard count (every row through the host
front, whose rows are padded so every shard gets one; SAM against the
port's on one device)."""
import jax
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.parallel import make_mesh as j_make_mesh
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.parallel import make_mesh
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.utils import timers

from torch_port_util import (dataset_contigs, first_diff, long_reads_fq,
                             make_dataset, torch_opt)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("meshlong")
    data = make_dataset(d, n_reads=4, seed=7)
    data["long"] = long_reads_fq(d / "long.fq", dataset_contigs(seed=7), 8,
                                 1000, 55, 0.02, 0.003)
    return data


@pytest.fixture
def counted():
    timers.reset()
    timers.enable(True)
    yield timers
    timers.enable(False)
    timers.reset()


def test_long_reads_two_shards(data, counted):
    want = JAligner(data["jidx"], mesh=j_make_mesh(
        jax.devices()[:2])).align_batch_se(list(j_read(data["long"])))
    reads = list(t_read(data["long"]))
    one = TAligner(data["tidx"], torch_opt(),
                   device="cpu").align_batch_se(reads)
    counted.reset()
    got = TAligner(data["tidx"], torch_opt(), mesh=make_mesh(
        ["cpu"] * 2)).align_batch_se(reads)
    assert got == want, first_diff(want, got)
    assert got == one, first_diff(one, got)
    snap = counted.snapshot()
    assert snap.get("front.fallback_rows.count", 0) == len(reads) == 8
    assert snap.get("dispatch.front.count", 0) == 0


def test_a_batch_under_the_shard_count_takes_the_host_front(data,
                                                            counted):
    reads = list(t_read(data["fq"]))
    one = TAligner(data["tidx"], torch_opt(),
                   device="cpu").align_batch_se(reads)
    counted.reset()
    al = TAligner(data["tidx"], torch_opt(), mesh=make_mesh(["cpu"] * 16))
    got = al.align_batch_se(reads)
    assert got == one, first_diff(one, got)
    snap = counted.snapshot()
    assert snap.get("front.fallback_rows.count", 0) == len(reads) == 4
    assert snap.get("dispatch.front.count", 0) == 0
    # the host front's arenas are keyed by per-shard rows (8 rows padded
    # to 16, one a shard)
    assert {k[2] for k in al._seed_arena_hist} == {(1, 128)}
