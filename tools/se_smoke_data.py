"""The data sets of chip_smoke.py, tools/torch_se_profile.py and
tools/torch_fm_step_probe.py: a 5 Mbp one-contig genome and 2 x 8192
single-end reads of 101 bp from simdata.py (fixed seeds), indexed with
bwamem_tpu_torch's build_index; long-read batches from the same genome (512
reads of 1000 bp, 128 reads of 5000 bp); 8192 pairs of 150 bp (insert
400 +- 40) with the place each pair was sampled from; 4096 pairs of 100
bp for pemerge; 2048 pairs of 101 bp (insert 300 +- 30) for the legacy
aligner, a share of them with a second mate that only the mate rescue of
`sampe` can place; and for `bwasw` 256 reads of 500 bp and 64 pairs of
300 bp (insert 700 +- 60).  Everything is cached under build/chip_smoke/."""
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
# paired-end: pairs, pairs per batch, read length, insert mean and sd
PE_PAIRS = 8192
PE_BATCH_PAIRS = 4096
PE_READ_LEN = 150
PE_INSERT = (400, 40)
# pemerge: pairs, read length, and the two insert-size classes (mean, sd)
PEM_PAIRS = 4096
PEM_READ_LEN = 100
PEM_INSERTS = ((150, 15), (420, 30))
# the legacy aligner: pairs, read length, insert mean and sd, and every
# LEG_BAIT_EVERY-th pair's second mate carries LEG_BAIT_SUBS substitutions
# (more than aln's max_diff of 5 at 101 bp: tests/test_legacy.py's bait)
LEG_PAIRS = 2048
LEG_READ_LEN = 101
LEG_INSERT = (300, 30)
LEG_BAIT_EVERY, LEG_BAIT_SUBS = 16, 10
# bwasw: reads, read length, substitution and indel rates; pairs, read
# length, insert mean and sd, substitution and indel rates (the shapes of
# tests/test_bwasw.py:22-30, scaled up)
BWASW_SE = (256, 500, 0.02, 0.002)
BWASW_PE = (64, 300, (700, 60), 0.02, 0.001)


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


class _Tracked(str):
    """A contig that notes every slice taken from it: simdata's paired
    sampler slices the contig once per pair (the fragment) and its read
    names carry no position, so this is where the pairs' origins come
    from."""

    def __new__(cls, seq, name, taken):
        self = super().__new__(cls, seq)
        self.name, self.taken = name, taken
        return self

    def __getitem__(self, key):
        if isinstance(key, slice):
            self.taken.append((self.name, key.start, key.stop))
        return str.__getitem__(self, key)


def _sample_pairs(tag: str, n_pairs: int, read_len: int, insert: tuple,
                  seed: int, log, bait=None, sub_rate=0.01,
                  indel_rate=0.0005) -> tuple[str, str, list]:
    """(FASTQ of mates 1, FASTQ of mates 2, origins) of n_pairs pairs
    sampled from smoke_data's genome on first use, cached under
    WORK/<tag>_*.  origins[p] = (contig, fragment start, fragment end),
    0-based: one mate of pair p starts at the fragment's start on the
    forward strand, the other ends at its end on the reverse strand.
    bait = (every, subs): the second mate of every `every`-th pair gets
    `subs` random substitutions.  sub_rate and indel_rate are simdata's
    mutation rates (its defaults unless given)."""
    import numpy as np
    simdata = _simdata()
    os.makedirs(WORK, exist_ok=True)
    fq1, fq2, org = (os.path.join(WORK, f"{tag}_{x}")
                     for x in ("1.fq", "2.fq", "origin.tsv"))
    if not all(os.path.exists(f) for f in (fq1, fq2, org)):
        t0 = time.perf_counter()
        taken = []
        contigs = {n: _Tracked(seq, n, taken)
                   for n, seq in _genome().items()}
        pairs = simdata.sim_reads(
            contigs, 2 * n_pairs, read_len=read_len, seed=seed, paired=True,
            insert_mean=insert[0], insert_std=insert[1], sub_rate=sub_rate,
            indel_rate=indel_rate)
        if len(taken) != n_pairs:
            raise RuntimeError(f"{len(taken)} fragments for {n_pairs} "
                               "pairs: simdata's paired sampler changed")
        mates2 = pairs[1::2]
        if bait:
            every, subs = bait
            rng = np.random.default_rng(seed)
            for p in range(0, n_pairs, every):
                name, seq, qual = mates2[p]
                arr = bytearray(seq.encode())
                for x in rng.choice(len(arr), subs, replace=False):
                    arr[x] = ord("ACGT"[rng.integers(0, 4)])
                mates2[p] = (name, arr.decode(), qual)
        simdata.write_fastq(pairs[0::2], fq1)
        simdata.write_fastq(mates2, fq2)
        with open(org, "w") as f:
            for name, a, b in taken:
                f.write(f"{name}\t{a}\t{b}\n")
        log(f"data, {n_pairs} pairs of {read_len} bp ({tag}): "
            f"{time.perf_counter() - t0:.1f} s")
    with open(org) as f:
        origins = [(n, int(a), int(b)) for n, a, b in
                   (line.split("\t") for line in f)]
    return fq1, fq2, origins


def pe_reads(log=print) -> tuple[str, str, list]:
    """(FASTQ of mates 1, FASTQ of mates 2, origins): PE_PAIRS pairs of
    PE_READ_LEN bases (see _sample_pairs)."""
    return _sample_pairs(f"pe{PE_READ_LEN}", PE_PAIRS, PE_READ_LEN,
                         PE_INSERT, SEED + PE_READ_LEN, log)


def legacy_pairs(log=print) -> tuple[str, str, list]:
    """(FASTQ of mates 1, FASTQ of mates 2, origins): LEG_PAIRS pairs of
    LEG_READ_LEN bases for aln/sampe, every LEG_BAIT_EVERY-th second mate
    with LEG_BAIT_SUBS substitutions (see _sample_pairs)."""
    return _sample_pairs(f"leg{LEG_READ_LEN}", LEG_PAIRS, LEG_READ_LEN,
                         LEG_INSERT, SEED + 300, log,
                         bait=(LEG_BAIT_EVERY, LEG_BAIT_SUBS))


def bwasw_reads(log=print) -> tuple[str, str, str, list]:
    """(FASTQ of the single-end reads, FASTQ of mates 1, FASTQ of mates 2,
    pair origins) for `bwasw`: BWASW_SE's reads, named
    rd<i>_<contig>_<start> as simdata names them, and BWASW_PE's pairs
    (see _sample_pairs), sampled from smoke_data's genome on first use."""
    simdata = _simdata()
    n, read_len, sub, indel = BWASW_SE
    os.makedirs(WORK, exist_ok=True)
    fq = os.path.join(WORK, f"sw{read_len}.fq")
    if not os.path.exists(fq):
        t0 = time.perf_counter()
        simdata.write_fastq(simdata.sim_reads(
            _genome(), n, read_len=read_len, seed=SEED + 500,
            sub_rate=sub, indel_rate=indel), fq)
        log(f"data, {n} reads of {read_len} bp for bwasw: "
            f"{time.perf_counter() - t0:.1f} s")
    n_pairs, pe_len, insert, sub, indel = BWASW_PE
    fq1, fq2, origins = _sample_pairs(f"sw{pe_len}", n_pairs, pe_len, insert,
                                      SEED + 501, log, sub_rate=sub,
                                      indel_rate=indel)
    return fq, fq1, fq2, origins


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


def pemerge_pairs(log=print) -> tuple[str, str]:
    """(FASTQ of mates 1, FASTQ of mates 2): PEM_PAIRS pairs of PEM_READ_LEN
    bases from smoke_data's genome, in the shape of tests/test_pemerge.py
    (1 % substitutions, no indels): three quarters at inserts of 150 +- 15,
    so the mates overlap and merge, a quarter at 420 +- 30, which cannot;
    qualities drawn at random from 2-40.  Made on first use."""
    import numpy as np
    simdata = _simdata()
    os.makedirs(WORK, exist_ok=True)
    fq1, fq2 = (os.path.join(WORK, f"pem{PEM_READ_LEN}_{e}.fq")
                for e in (1, 2))
    if not (os.path.exists(fq1) and os.path.exists(fq2)):
        t0 = time.perf_counter()
        genome = _genome()
        short = PEM_PAIRS * 3 // 4
        reads = []
        for n, (mean, sd), seed in ((short, PEM_INSERTS[0], 1),
                                    (PEM_PAIRS - short, PEM_INSERTS[1], 2)):
            reads += simdata.sim_reads(
                genome, 2 * n, read_len=PEM_READ_LEN, seed=SEED + 100 + seed,
                sub_rate=0.01, indel_rate=0.0, paired=True, insert_mean=mean,
                insert_std=sd)
        rng = np.random.default_rng(SEED + 100)
        with open(fq1, "w") as f1, open(fq2, "w") as f2:
            for i, (name, seq, _) in enumerate(reads):
                qual = "".join(chr(33 + q) for q in
                               rng.integers(2, 41, len(seq)))
                (f1 if i % 2 == 0 else f2).write(
                    f"@{name}/{1 + i % 2}\n{seq}\n+\n{qual}\n")
        log(f"data, {PEM_PAIRS} pairs of {PEM_READ_LEN} bp for pemerge: "
            f"{time.perf_counter() - t0:.1f} s")
    return fq1, fq2
