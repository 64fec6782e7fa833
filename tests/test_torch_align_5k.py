"""Single-end SAM from bwamem_tpu_torch on the CPU, byte for byte against
bwamem_tpu's, on reads past the extension kernels' 4095-base query bound:
the side path routes their over-long lanes to the plain extension with
the widened row-max packing.  A file of its own: the reference alone takes
minutes on such reads."""
import bwamem_tpu  # noqa: F401

from bwamem_tpu.io.fastq import read_fastx as j_read
from bwamem_tpu.pipeline.align import Aligner as JAligner
from bwamem_tpu_torch.io.fastq import read_fastx as t_read
from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
from bwamem_tpu_torch.utils import timers

from torch_port_util import (dataset_contigs, long_reads_fq, make_dataset,
                             torch_opt)


def test_reads_over_4095_bases(tmp_path):
    data = make_dataset(tmp_path, n_reads=4, seed=7)
    fq = long_reads_fq(tmp_path / "l5k.fq", dataset_contigs(seed=7), 2, 4400,
                       seed=77, sub_rate=0.02, indel_rate=0.002)
    want = JAligner(data["jidx"]).align_batch_se(list(j_read(fq)))
    timers.reset()
    timers.enable(True)
    try:
        got = TAligner(data["tidx"], torch_opt(),
                       device="cpu").align_batch_se(list(t_read(fq)))
        snap = timers.snapshot()
    finally:
        timers.enable(False)
        timers.reset()
    assert want == got
    assert all(not (int(s.split("\t")[1]) & 4) for s in got)
    assert snap.get("front.fallback_rows.count", 0) == 2
    # lanes with a query over 4095 bases took the widened plain extension
    assert snap.get("dispatch.extend_long.count", 0) >= 1
