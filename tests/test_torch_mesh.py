"""The data-parallel mesh of bwamem_tpu_torch (parallel/mesh.py and its
branches in the fronts and the Aligner) on the CPU, against bwamem_tpu.

A mesh may repeat a device, so ["cpu"] * 2 and ["cpu"] * 4 run the sharded
path here: every device program runs once per shard on shard-local rows or
lanes, the index replicated, every arena shard-local, and the host merges
the shards.  The SAM must equal the reference's over a 2-device mesh of
the conftest's virtual CPU devices and the port's on one device, for 64
single-end reads and 32 pairs of 101 bp; at 4 shards also for 50 reads,
whose last shard is mostly padding.  The device front's merged arenas
(the host replay's input) and its fallback rows must equal the
reference's under the same mesh.  (Long reads, and a batch under the
shard count on 16 shards: test_torch_mesh_long.py.)"""
import types

import jax
import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401

from bwamem_tpu.config import MemOptions as JOpt
from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.parallel import make_mesh as j_make_mesh
from bwamem_tpu.pipeline import device_front as jdf
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.parallel import mesh as pmesh
from bwamem_tpu_torch.pipeline import device_front as tdf
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.utils import timers

from torch_port_util import (assert_same, first_diff, make_dataset,
                             pe_reads, torch_opt)

N_READS, N_PAIRS = 64, 32


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("mesh"), n_reads=N_READS,
                        seed=21, n_pairs=N_PAIRS)


def _record_replay(monkeypatch, mod, store):
    """Record the final walk's inputs of `mod`'s device front: the merged
    item and chain arenas, l_rep and the fallback rows."""
    orig = mod._replay

    def rec(al, reads, I32, IIT, CH32, CHPOS, l_rep, n, fallback,
            has_res=None, prepass=False):
        out = orig(al, reads, I32, IIT, CH32, CHPOS, l_rep, n, fallback,
                   has_res=has_res, prepass=prepass)
        if not prepass:
            store.append(dict(I32=np.array(I32), IIT=np.array(IIT),
                              CH32=np.array(CH32), CHPOS=np.array(CHPOS),
                              l_rep=np.array(l_rep)[:n],
                              fallback=sorted(fallback)))
        return out
    monkeypatch.setattr(mod, "_replay", rec)


@pytest.fixture(scope="module")
def reference(data):
    """The reference over a 2-device mesh: SE and PE SAM and the SE
    batch's front arrays."""
    mp = pytest.MonkeyPatch()
    store = []
    _record_replay(mp, jdf, store)
    try:
        ja = JAligner(data["jidx"], mesh=j_make_mesh(jax.devices()[:2]))
        se = ja.align_batch_se(list(j_read(data["fq"])))
        front = store[-1]
        pe = ja.align_batch_pe(pe_reads(data, "j"))
    finally:
        mp.undo()
    return dict(se=se, pe=pe, front=front)


@pytest.fixture(scope="module")
def single(data):
    """The port on one device."""
    ta = TAligner(data["tidx"], torch_opt(), device="cpu")
    return dict(se=ta.align_batch_se(list(t_read(data["fq"]))),
                pe=ta.align_batch_pe(pe_reads(data, "t")))


@pytest.fixture
def counted():
    timers.reset()
    timers.enable(True)
    yield timers
    timers.enable(False)
    timers.reset()


def _mesh_aligner(data, nsh):
    return TAligner(data["tidx"], torch_opt(),
                    mesh=pmesh.make_mesh(["cpu"] * nsh))


def test_make_mesh(monkeypatch):
    m = pmesh.make_mesh(["cpu", "cpu"])
    assert m.size == 2 and m.devices == (torch.device("cpu"),) * 2
    for bad in (["cpu"] * 3, []):
        with pytest.raises(ValueError, match="power of two"):
            pmesh.make_mesh(bad)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pmesh.make_mesh(["cuda:0", "cuda:0"])


def test_rowmap_specs():
    """Replicated, axis-0 and axis-1 arguments; outputs joined on axis 0,
    on axis 1, or one entry per output; shard-local shapes inside."""
    m = pmesh.make_mesh(["cpu"] * 4)
    rows = torch.arange(8 * 3).reshape(8, 3)
    cols = torch.arange(2 * 8).reshape(2, 8)
    seen = []

    def fn(tab, r, c, *, k):
        # shard s holds rows [2s, 2s + 2): its first value names it
        seen.append((int(r[0, 0]) // 6, tuple(r.shape), tuple(c.shape)))
        return r.sum(1) + tab[0] * k, c * k
    run = pmesh.rowmap(m, fn, (("k", 2),), (True, False, "ax1"),
                       out_mask=(False, "ax1"))
    tab = torch.tensor([5])
    a, b = run(tab, rows, cols)
    assert seen == [(s, (2, 3), (2, 2)) for s in range(4)]
    assert torch.equal(a, rows.sum(1) + 10)
    assert torch.equal(b, cols * 2)
    both = pmesh.rowmap(m, lambda r: (r, r + 1), (), (False,))(rows)
    assert torch.equal(torch.stack(both), torch.stack([rows, rows + 1]))
    with pytest.raises(ValueError, match="does not split"):
        run(tab, rows[:6], cols)


def test_replicated_is_one_copy_per_device():
    m = pmesh.make_mesh(["cpu"] * 4)
    fm = types.SimpleNamespace()
    t = torch.arange(5)
    copies = pmesh.replicated(m, t)
    assert len(copies) == 4 and all(c is copies[0] for c in copies)
    assert pmesh.replicated(m, t) is copies
    seen = []
    pmesh.rowmap(m, lambda x, r: seen.append(x) or r, (),
                 (True, False))(t, torch.zeros(4))
    assert all(x is copies[0] for x in seen)
    assert pmesh.replicated(m, fm)[0] is fm     # nothing to move


@pytest.mark.parametrize("nsh", [2, 4])
def test_se(data, reference, single, monkeypatch, counted, nsh):
    store = []
    _record_replay(monkeypatch, tdf, store)
    al = _mesh_aligner(data, nsh)
    got = al.align_batch_se(list(t_read(data["fq"])))
    assert got == reference["se"], first_diff(reference["se"], got)
    assert got == single["se"], first_diff(single["se"], got)
    snap = counted.snapshot()
    assert snap.get("dispatch.front.count", 0) == 6
    if nsh == 2:
        # the merged arenas the host replays, as the reference merges them
        want = reference["front"]
        for k in ("I32", "IIT", "CH32", "CHPOS", "l_rep"):
            assert_same(want[k], store[-1][k], k)
        assert store[-1]["fallback"] == want["fallback"]
    else:
        # 50 reads: rows 48-49 of the last shard's 16 are real
        n = 50
        got = al.align_batch_se(list(t_read(data["fq"]))[:n])
        assert got == single["se"][:n], first_diff(single["se"][:n], got)
    # the arena history is keyed by per-shard rows
    assert {k[2] for k in al._front_hist} == {(N_READS // nsh, 128)}


@pytest.mark.parametrize("nsh", [2, 4])
def test_pe(data, reference, single, nsh):
    got = _mesh_aligner(data, nsh).align_batch_pe(pe_reads(data, "t"))
    assert got == reference["pe"], first_diff(reference["pe"], got)
    assert got == single["pe"], first_diff(single["pe"], got)


def test_a_batch_under_the_shard_count_is_not_supported(data):
    """Both packages send a batch whose row bucket (8) is under the shard
    count (16) to the host front; at the shard count it may take the
    device front."""
    reads = list(t_read(data["fq"]))[:4]
    stub = types.SimpleNamespace(opt=JOpt(), mesh=types.SimpleNamespace(
        devices=np.zeros(16)))
    assert not jdf.supported(stub, list(j_read(data["fq"]))[:4])
    al16 = _mesh_aligner(data, 16)
    assert not tdf.supported(al16, reads)
    assert al16.begin_batch(reads)["tok"] is None
    stub.mesh.devices = np.zeros(8)
    assert jdf.supported(stub, list(j_read(data["fq"]))[:4])
    assert tdf.supported(_mesh_aligner(data, 8), reads)
