"""Multi-process `mem` of bwamem_tpu_torch (parallel/multihost.py) on the
CPU, byte for byte against bwamem_tpu.

-K chunks are dealt round-robin to the ranks, each replaying the
single-process n_processed offsets; paired-end statistics are per chunk,
so rank 0's merge of the shards must equal one process's SAM.

  * in one process: the port's shard files and merged SAM against the
    reference's align_shard / merge_shards on the same chunks, SE and PE,
    at 2 and 3 ranks; either package merges the other's shards;
  * two port processes over gloo through cli.main (device="cpu"), against
    the reference's single-process cli.main computed in this process (the
    reference's own two-process spawn takes minutes); -I does not reach the
    chunks of a multi-process run, as in the reference; a rank that fails
    makes both exit non-zero instead of waiting in the barrier;
  * importing the parallel package and the CLI loads neither JAX nor
    bwamem_tpu."""
import io
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu import cli as jcli
from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.parallel import multihost as jmh
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch import cli as tcli
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.parallel import multihost as tmh
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner

from torch_port_util import make_dataset, pe_reads, torch_opt

REPO = Path(__file__).resolve().parent.parent
N_READS, N_PAIRS = 48, 24
CHUNK = 16          # reads a chunk (pairs: 8): 3 chunks


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("mh"), n_reads=N_READS,
                        seed=13, n_pairs=N_PAIRS)


class _EachChunkOnce:
    """An Aligner of either package, each chunk aligned once: the shard
    tests at 2 and 3 ranks (and the paired-end process test) hand it the
    same chunks at the same offsets, so the 3-rank tests check the shard
    files and the merge on the chunks the 2-rank tests aligned."""

    def __init__(self, al):
        self.al, self.done = al, {}

    def _once(self, how, batch, n_proc, rg_id=None):
        key = (how, n_proc, len(batch))
        if key not in self.done:
            self.done[key] = getattr(self.al, how)(batch, n_proc,
                                                   rg_id=rg_id)
        return self.done[key]

    def align_batch_se(self, batch, n_proc, rg_id=None):
        return self._once("align_batch_se", batch, n_proc, rg_id)

    def align_batch_pe(self, batch, n_proc, rg_id=None):
        return self._once("align_batch_pe", batch, n_proc, rg_id)


@pytest.fixture(scope="module")
def aligners(data):
    return (_EachChunkOnce(JAligner(data["jidx"])),
            _EachChunkOnce(TAligner(data["tidx"], torch_opt(),
                                    device="cpu")))


def _batches(reads, chunk):
    for i in range(0, len(reads), chunk):
        yield reads[i: i + chunk]


def _reads(data, which, pe):
    if pe:
        return pe_reads(data, which)
    return list((j_read if which == "j" else t_read)(data["fq"]))


def test_shard_roundrobin_offsets():
    batches = [[0] * 5, [1] * 3, [2] * 4, [3] * 2]
    got = [[(c, n, len(b)) for c, n, b in
            tmh.shard_chunks(iter(batches), r, 2)] for r in range(2)]
    assert got == [[(0, 0, 5), (2, 8, 4)], [(1, 5, 3), (3, 12, 2)]]
    assert got == [[(c, n, len(b)) for c, n, b in
                    jmh.shard_chunks(iter(batches), r, 2)]
                   for r in range(2)]
    assert [c for c, _, _ in tmh.shard_chunks(iter(batches), 2, 3)] == [2]


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe"])
@pytest.mark.parametrize("nproc", [2, 3])
def test_shards_and_merge_match_reference(data, aligners, tmp_path, pe,
                                          nproc):
    ja, ta = aligners
    chunk = CHUNK
    jreads, treads = _reads(data, "j", pe), _reads(data, "t", pe)
    jp, tp = [], []
    for rank in range(nproc):
        jp.append(str(tmp_path / f"j.shard{rank}"))
        tp.append(str(tmp_path / f"t.shard{rank}"))
        nj = jmh.align_shard(ja, _batches(jreads, chunk), process_id=rank,
                             num_processes=nproc, shard_path=jp[-1], pe=pe)
        nt = tmh.align_shard(ta, _batches(treads, chunk), process_id=rank,
                             num_processes=nproc, shard_path=tp[-1], pe=pe)
        assert nj == nt > 0
        assert Path(tp[-1]).read_bytes() == Path(jp[-1]).read_bytes(), rank
    n_chunks = -(-len(treads) // chunk)
    merged = {}
    for name, merge, paths in (("t", tmh.merge_shards, tp),
                               ("j", jmh.merge_shards, jp),
                               ("t_of_j", tmh.merge_shards, jp),
                               ("j_of_t", jmh.merge_shards, tp)):
        buf = io.BytesIO()
        assert merge(paths, buf) == n_chunks
        merged[name] = buf.getvalue()
    assert len(set(merged.values())) == 1


def test_merge_refuses_a_missing_chunk_or_a_foreign_file(tmp_path):
    p0, p1 = str(tmp_path / "s0"), str(tmp_path / "s1")
    for path, chunks in ((p0, (0, 2)), (p1, (3,))):
        w = tmh.ShardWriter(path)
        for c in chunks:
            w.add_chunk(c, f"chunk{c}\n")
        w.close()
    buf = io.BytesIO()
    with pytest.raises(ValueError, match="chunk 1 missing"):
        tmh.merge_shards([p0, p1], buf)
    assert buf.getvalue() == b"chunk0\n"
    bad = tmp_path / "bad"
    bad.write_bytes(b"not a shard\n")
    with pytest.raises(ValueError, match="not a bwamem shard file"):
        tmh.merge_shards([str(bad)], io.BytesIO())


def test_init_from_env_unconfigured(monkeypatch):
    import torch.distributed as dist
    for k in ("BWAMEM_COORDINATOR", "BWAMEM_NUM_PROCESSES",
              "BWAMEM_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert tmh.init_from_env() == (0, 1)
    assert tmh.init_from_env("localhost:1", 1, 0) == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="not a rank"):
        tmh.init_from_env("localhost:1", 2, 2)


_RANK = ("import sys, torch; torch.set_num_threads(1); "
         "from bwamem_tpu_torch import cli; "
         "sys.exit(cli.main(sys.argv[1:], device='cpu'))")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _clean_env():
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX", "XLA", "BWAMEM_"))} | {
        "PYTHONPATH": str(REPO)}


def _two_ranks(argvs, cwd, timeout=300):
    """Two port processes of `mem` over gloo; argvs[r] is rank r's command
    line.  Returns [(exit code, stderr)] by rank."""
    port = _free_port()
    procs = []
    for r, argv in enumerate(argvs):
        env = _clean_env() | {"BWAMEM_COORDINATOR": f"localhost:{port}",
                              "BWAMEM_NUM_PROCESSES": "2",
                              "BWAMEM_PROCESS_ID": str(r)}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, *argv], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _reference_cli(argv, cwd, monkeypatch, capsys):
    monkeypatch.setenv("BWAMEM_TPU_DEVICES", "1")     # reference: one chip
    monkeypatch.chdir(cwd)
    assert jcli.main(argv) == 0
    capsys.readouterr()
    return (Path(cwd) / "out.sam").read_text()


@pytest.mark.parametrize("pe", [False, True], ids=["se", "pe_-I"])
def test_two_processes_match_one(data, aligners, tmp_path, monkeypatch,
                                 capsys, pe):
    """SE: rank 0's merged output equals the reference's one-process bytes.
    PE with -I: the ranks infer each chunk's insert size as the reference's
    multi-process run does, so the records equal the reference's chunks
    aligned without -I (and differ from one process's run with -I, which
    test_torch_align_pe_cli.py holds to the reference's)."""
    reads = [data["fq1"], data["fq2"]] if pe else [data["fq"]]
    # -K of 16 reads: 3 chunks, 2 for rank 0 (pairs: 8 a chunk)
    opts = ["-K", str(CHUNK * 101)] + (["-I", "250,20"] if pe else [])
    argv = ["mem", "-o", "out.sam", *opts, data["prefix"], *reads]
    (tmp_path / "mh").mkdir()
    res = _two_ranks([argv, argv], tmp_path / "mh")
    for r, (rc, err) in enumerate(res):
        assert rc == 0, err[-3000:]
        assert f"rank {r} aligned {(2 - r) * CHUNK} reads" in err
    got = (tmp_path / "mh" / "out.sam").read_text()
    assert sorted(p.name for p in (tmp_path / "mh").iterdir()) == [
        "out.sam", "out.sam.shard0", "out.sam.shard1"]
    if not pe:
        (tmp_path / "j").mkdir()
        assert got == _reference_cli(argv, tmp_path / "j", monkeypatch,
                                     capsys)
        return

    def body(sam):
        return [l for l in sam.splitlines() if not l.startswith("@")]
    ja, _ = aligners
    jreads = _reads(data, "j", True)
    chunks = [ja.align_batch_pe(jreads[i:i + CHUNK], i)
              for i in range(0, len(jreads), CHUNK)]
    assert body(got) == body("".join(s for c in chunks for s in c))
    (tmp_path / "t").mkdir()
    monkeypatch.chdir(tmp_path / "t")
    assert tcli.main(argv, device="cpu") == 0
    capsys.readouterr()
    assert body(got) != body((tmp_path / "t" / "out.sam").read_text())


def test_a_failed_rank_fails_both(data, tmp_path):
    """Rank 1 cannot load its index: it exits non-zero, and rank 0 leaves
    the barrier with an error instead of waiting out the timeout."""
    argv = ["mem", "-K", str(CHUNK * 101), "-o", "out.sam"]
    res = _two_ranks([argv + [data["prefix"], data["fq"]],
                      argv + [data["prefix"] + "_missing", data["fq"]]],
                     tmp_path, timeout=110)
    assert [rc != 0 for rc, _ in res] == [True, True]
    assert "no index" in res[1][1]


def test_parallel_and_cli_import_no_jax():
    code = ("import sys\n"
            "import bwamem_tpu_torch.parallel\n"
            "import bwamem_tpu_torch.parallel.multihost\n"
            "import bwamem_tpu_torch.cli\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bwamem_tpu'))\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "CLEAN" in r.stdout
