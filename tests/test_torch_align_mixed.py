"""Single-end SAM from bwamem_tpu_torch on the CPU, byte for byte against
bwamem_tpu's, on a mixed batch of 101 bp and 1000 bp reads: the device
front runs, the long rows are gated and re-run through the host-compacted
front, and their regions are merged back by row.  A file of its own: the
device front of a 1024-base batch takes the reference minutes."""
import bwamem_tpu  # noqa: F401

from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.utils import timers

from torch_port_util import (dataset_contigs, long_reads_fq, make_dataset,
                             torch_opt)


def test_mixed_batch_merges_fallback_rows(tmp_path):
    data = make_dataset(tmp_path, n_reads=12, seed=7)
    # 12 reads of 101 bp, then 3 of 1000 bp: under half the rows are gated,
    # so the device front is dispatched and hands the long rows back
    long_fq = long_reads_fq(tmp_path / "r1000.fq", dataset_contigs(seed=7),
                            3, 1000, 55)
    fq = tmp_path / "mixed.fq"
    fq.write_text(open(data["fq"]).read() + open(long_fq).read())
    want = JAligner(data["jidx"]).align_batch_se(list(j_read(str(fq))))
    timers.reset()
    timers.enable(True)
    try:
        got = TAligner(data["tidx"], torch_opt(),
                       device="cpu").align_batch_se(list(t_read(str(fq))))
        snap = timers.snapshot()
    finally:
        timers.enable(False)
        timers.reset()
    bad = [i for i in range(min(len(want), len(got))) if want[i] != got[i]]
    assert want == got, (len(want), len(got), bad[:3])
    assert snap.get("front.fallback_rows.count", 0) == 3
    assert snap.get("dispatch.front.count", 0) >= 6      # front dispatched
    assert all(not (int(x.split("\t")[1]) & 4) for x in got[-3:])
