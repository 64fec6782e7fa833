"""The single-end data sets of chip_smoke.py and tools/torch_se_profile.py:
a 5 Mbp one-contig genome and 2 x 8192 reads of 101 bp from simdata.py
(fixed seeds), indexed with bwamem_tpu_torch's build_index, and long-read
batches from the same genome (512 reads of 1000 bp, 128 reads of 5000 bp).
Everything is cached under build/chip_smoke/."""
from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, "build", "chip_smoke")
SEED = 20251016
GENOME_LEN = 5_000_000
BATCH = 8192
N_BATCHES = 2
READ_LEN = 101
# long-read batches: read length -> (reads, substitution rate, indel rate);
# the 5000 bp reads pass the extension kernels' 4095-base query bound
LONG_SETS = {1000: (512, 0.02, 0.003), 5000: (128, 0.02, 0.002)}


def _simdata():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import simdata
    return simdata


def _genome():
    return _simdata().make_genome(GENOME_LEN, seed=SEED, n_contigs=1)


def long_reads(read_len: int, log=print) -> str:
    """FASTQ path of the long-read batch of `read_len` (a key of
    LONG_SETS), sampled from smoke_data's genome on first use."""
    simdata = _simdata()
    n, sub, indel = LONG_SETS[read_len]
    os.makedirs(WORK, exist_ok=True)
    fq = os.path.join(WORK, f"r{read_len}.fq")
    if not os.path.exists(fq):
        t0 = time.perf_counter()
        simdata.write_fastq(simdata.sim_reads(
            _genome(), n, read_len=read_len, seed=SEED + read_len,
            sub_rate=sub, indel_rate=indel), fq)
        log(f"data, {n} reads of {read_len} bp: "
            f"{time.perf_counter() - t0:.1f} s")
    return fq


def smoke_data(log=print) -> tuple[str, str]:
    """(index prefix, FASTQ path), generated and indexed on first use."""
    simdata = _simdata()
    from bwamem_tpu_torch.index import build_index
    os.makedirs(WORK, exist_ok=True)
    fa = os.path.join(WORK, "g5m.fa")
    fq = os.path.join(WORK, "r101.fq")
    prefix = os.path.join(WORK, "g5m")
    if not (os.path.exists(fq) and os.path.exists(prefix + ".bt.npz")):
        t0 = time.perf_counter()
        contigs = _genome()
        simdata.write_fasta(contigs, fa)
        simdata.write_fastq(simdata.sim_reads(
            contigs, BATCH * N_BATCHES, read_len=READ_LEN, seed=SEED + 1),
            fq)
        log(f"data: {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        build_index(fa, with_kmer_table=True).save(prefix)
        log(f"index build: {time.perf_counter() - t1:.1f} s")
    return prefix, fq
