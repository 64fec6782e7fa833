"""Shared inputs for the tests that hold bwamem_tpu_torch against bwamem_tpu.

Every input is made with numpy from a seed (tools/simdata.py genomes and
reads, indexed with bwamem_tpu.index.build_index), and the same arrays go
to both packages.  No oracle is needed."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
# The tensors here are small: intra-op threads only add contention with
# XLA's thread pool and the other test workers.
torch.set_num_threads(1)


def make_dataset(dirpath, *, genome_len=50_000, n_reads=96, seed=3,
                 kmer=True, n_contigs=2, n_pairs=0, pe_read_len=101):
    """Genome + 101 bp reads + both packages' index of it under dirpath;
    with n_pairs, also a paired read set of pe_read_len bases (insert 400
    +- 40) as two FASTQs.  Returns dict(prefix, fa, fq, jidx, tidx) plus
    fq1, fq2 when pairs were asked for."""
    import simdata
    from bwamem_tpu.index import build_index
    from bwamem_tpu_torch.index import load_index
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    fa, fq, prefix = str(d / "g.fa"), str(d / "r.fq"), str(d / "g")
    contigs = simdata.make_genome(genome_len, seed=seed, n_contigs=n_contigs)
    simdata.write_fasta(contigs, fa)
    simdata.write_fastq(simdata.sim_reads(contigs, n_reads, read_len=101,
                                          seed=seed + 1), fq)
    pe = {}
    if n_pairs:
        pe = dict(fq1=str(d / "r1.fq"), fq2=str(d / "r2.fq"))
        pairs = simdata.sim_reads(contigs, 2 * n_pairs, seed=seed + 2,
                                  read_len=pe_read_len, paired=True)
        simdata.write_fastq(pairs[0::2], pe["fq1"])
        simdata.write_fastq(pairs[1::2], pe["fq2"])
    jidx = build_index(fa, with_kmer_table=kmer)
    jidx.save(prefix)
    return dict(prefix=prefix, fa=fa, fq=fq, jidx=jidx,
                tidx=load_index(prefix), **pe)


def torch_opt(jopt=None):
    """The port's MemOptions carried across from the reference's."""
    from bwamem_tpu.config import MemOptions as JOpt
    from bwamem_tpu_torch.config import options_from
    return options_from(dataclasses.asdict(jopt or JOpt()))


def jfm_arrays(jfm) -> dict:
    """The reference FM's leaves (and static fields) as numpy."""
    return {f.name: (None if getattr(jfm, f.name) is None
                     else np.asarray(getattr(jfm, f.name)))
            for f in dataclasses.fields(jfm)}


def T(x, dtype=None):
    """A reference-package array (or tree leaf) as a CPU tensor."""
    t = torch.from_numpy(np.array(x))
    return t if dtype is None else t.to(dtype)


def N(x):
    """A tensor or array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_same(a, b, what=""):
    """Exact equality of values (dtypes may differ)."""
    a, b = N(a), N(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    kind = np.float64 if (a.dtype.kind == "f" or b.dtype.kind == "f") \
        else np.int64
    bad = np.flatnonzero(a.reshape(-1).astype(kind)
                         != b.reshape(-1).astype(kind))
    assert bad.size == 0, (f"{what}: {bad.size} of {a.size} differ; first "
                           f"at {bad[:5]}: {a.reshape(-1)[bad[:5]]} vs "
                           f"{b.reshape(-1)[bad[:5]]}")


def front_setup(dirpath, *, n_reads=96, kmer=True):
    """Both packages' aligners on one dataset plus one packed batch and the
    port's default arena sizes for it."""
    from bwamem_tpu.io.fastq import pack_batch, read_fastx
    from bwamem_tpu.pipeline.align import Aligner as JAligner
    from bwamem_tpu_torch.pipeline import device_front as tdf
    from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
    data = make_dataset(dirpath, n_reads=n_reads, kmer=kmer)
    reads = list(read_fastx(data["fq"]))
    ja = JAligner(data["jidx"])
    ta = TAligner(data["tidx"], torch_opt(), device="cpu")
    n = len(reads)
    Nb = 8
    while Nb < n:
        Nb <<= 1
    seq, l_seq = pack_batch(reads, Nb, 128)
    sizes = tdf._sizes_for(ta._front_hist, Nb, 128)
    return dict(data=data, reads=reads, ja=ja, ta=ta, seq=seq, l_seq=l_seq,
                N=Nb, L=128, sizes=sizes)


# ---- the reference's host-front state carried across as numpy ----

def worklist_from(jwr):
    """The reference's WorklistNp (with its SeedsNp) as the port's, field
    by field, every array copied (the host passes mutate them in place)."""
    from bwamem_tpu_torch.pipeline import seeding_host as tsh
    seeds = tsh.SeedsNp(*(np.array(getattr(jwr.seeds, f))
                          for f in tsh.SeedsNp._fields))
    rest = {f: np.array(getattr(jwr, f)) for f in tsh.WorklistNp._fields
            if f != "seeds"}
    return tsh.WorklistNp(seeds=seeds, **rest)


def copy_worklist(wr):
    """A deep copy of a WorklistNp of either package."""
    seeds = type(wr.seeds)(*(np.array(x) for x in wr.seeds))
    return type(wr)(seeds, *(np.array(x) for x in wr[1:]))


def assert_worklist_same(jwr, twr, what=""):
    for f in jwr.seeds._fields:
        assert_same(getattr(jwr.seeds, f), getattr(twr.seeds, f),
                    f"{what}seeds.{f}")
    for f in jwr._fields[1:]:
        assert_same(getattr(jwr, f), getattr(twr, f), f"{what}{f}")


def tensors_from(jtuple, cls):
    """A reference NamedTuple of arrays (Seeds, Chains, FilteredChains) as
    the port's class of CPU tensors."""
    return cls(*(T(x) for x in jtuple))


def long_reads_fq(path, contigs, n, read_len, seed, sub_rate=0.02,
                  indel_rate=0.003):
    import simdata
    simdata.write_fastq(simdata.sim_reads(
        contigs, n, read_len=read_len, seed=seed, sub_rate=sub_rate,
        indel_rate=indel_rate), str(path))
    return str(path)


def dataset_contigs(genome_len=50_000, seed=3, n_contigs=2):
    """The genome make_dataset indexes (same arguments, same seed)."""
    import simdata
    return simdata.make_genome(genome_len, seed=seed, n_contigs=n_contigs)


# ---- paired-end: both packages on the same interleaved reads ----

def pe_reads(d, which, n_pairs=None):
    """The paired FASTQs of a make_dataset(n_pairs=...) dict interleaved by
    package `which` ("j": bwamem_tpu, "t": bwamem_tpu_torch)."""
    if which == "j":
        from bwamem_tpu.io.fastq import interleave, read_fastx
    else:
        from bwamem_tpu_torch.io.fastq import interleave, read_fastx
    reads = list(interleave(read_fastx(d["fq1"]), read_fastx(d["fq2"])))
    return reads if n_pairs is None else reads[:2 * n_pairs]


def first_diff(a, b):
    bad = [i for i in range(min(len(a), len(b))) if a[i] != b[i]]
    return (len(a), len(b), bad[:3], [(a[i], b[i]) for i in bad[:1]])


def pe_both(d, *, flag=0, n_pairs=None, pes0=None, n_processed=0):
    """align_batch_pe of both packages on the CPU; asserts equal SAM and
    returns it (one string per read)."""
    from bwamem_tpu.config import MemOptions as JOpt
    from bwamem_tpu.pipeline.align import Aligner as JAligner
    from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
    jopt = JOpt()
    jopt.flag |= flag
    want = JAligner(d["jidx"], jopt).align_batch_pe(
        pe_reads(d, "j", n_pairs), n_processed, pes0=pes0)
    got = TAligner(d["tidx"], torch_opt(jopt), device="cpu").align_batch_pe(
        pe_reads(d, "t", n_pairs), n_processed, pes0=pes0)
    assert want == got, first_diff(want, got)
    return got


def sam_flags(sams):
    return [int(s.split("\t")[1]) for s in sams]


# ---- the legacy aligner (aln / samse / sampe) ----

def torch_gap_opt(jopt=None):
    """The port's GapOptions carried across from the reference's, through
    the packed gap_opt_t the .sai header holds."""
    from bwamem_tpu.legacy.aln import GapOptions as JGap
    from bwamem_tpu_torch.legacy.aln import GapOptions
    return GapOptions.unpack((jopt or JGap()).pack())


def torch_pe_opt(jpopt=None):
    """The port's PeOptions built from the reference's fields."""
    from bwamem_tpu.legacy.sampe import PeOptions as JPe
    from bwamem_tpu_torch.legacy.sampe import PeOptions
    popt = PeOptions()
    for name, value in vars(jpopt or JPe()).items():
        setattr(popt, name, value)
    return popt


def _fq(path, reads):
    with open(path, "w") as f:
        for name, seq, qual in reads:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")
    return str(path)


def legacy_dataset(dirpath, *, genome_len=100_000, n_se=48, n_pairs=60,
                   n_bait=12, seed=7):
    """A genome, bwamem_tpu's index of it (the port loads the same files)
    and the legacy aligner's reads under dirpath:
      se.fq  n_se reads of 101 bp (1 % substitutions, 0.2 % indels); a
             quarter with a low-quality 3' tail (for -q), some with a few
             Ns and one with too many, and reads cut to 36-90 bp or taken
             at 150 bp (mixed lengths);
      r1.fq, r2.fq  n_pairs pairs of 101 bp at insert 300 +- 30 (names
             /1 and /2), then n_bait pairs whose second mate carries 10
             substitutions: aln cannot place it and sampe's mate rescue
             must (tests/test_legacy.py's bait).
    Returns dict(prefix, se, r1, r2)."""
    import simdata
    from bwamem_tpu.index import build_index
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    contigs = simdata.make_genome(genome_len, seed=seed, n_contigs=2)
    fa, prefix = str(d / "g.fa"), str(d / "g")
    simdata.write_fasta(contigs, fa)
    build_index(fa).save(prefix)

    se = simdata.sim_reads(contigs, n_se, read_len=101, seed=seed + 1,
                           sub_rate=0.01, indel_rate=0.002)
    se += simdata.sim_reads(contigs, 4, read_len=150, seed=seed + 2)
    out = []
    for i, (name, seq, qual) in enumerate(se):
        s = bytearray(seq.encode())
        if i % 4 == 1:                       # low-quality 3' tail
            cut = int(rng.integers(8, 30))
            qual = qual[:-cut] + "#" * cut
        if i % 6 == 2:                       # a few Ns
            for p in rng.choice(len(s), int(rng.integers(1, 3)),
                                replace=False):
                s[p] = ord("N")
        if i == 5:                           # more Ns than max_diff
            s[10:20] = b"N" * 10
        if i % 7 == 3:                       # mixed lengths
            ln = int(rng.integers(36, 91))
            s, qual = s[:ln], qual[:ln]
        out.append((name, s.decode(), qual))
    se_fq = str(d / "se.fq")
    _fq(se_fq, out)

    pairs = simdata.sim_reads(contigs, 2 * n_pairs, read_len=101,
                              seed=seed + 3, sub_rate=0.01,
                              indel_rate=0.002, paired=True,
                              insert_mean=300, insert_std=30)
    bait = simdata.sim_reads(contigs, 2 * n_bait, read_len=101,
                             seed=seed + 4, sub_rate=0.0, indel_rate=0.0,
                             paired=True, insert_mean=300, insert_std=30)
    for i in range(1, len(bait), 2):
        n, s, q = bait[i]
        arr = bytearray(s.encode())
        for p in rng.choice(len(arr), 10, replace=False):
            arr[p] = ord("ACGT"[rng.integers(0, 4)])
        bait[i] = (n, arr.decode(), q)
    bait = [(f"bait{n[2:]}", s, q) for n, s, q in bait]
    r1, r2 = str(d / "r1.fq"), str(d / "r2.fq")
    both = pairs + bait
    _fq(r1, [(f"{n}/1", s, q) for n, s, q in both[0::2]])
    _fq(r2, [(f"{n}/2", s, q) for n, s, q in both[1::2]])
    return dict(prefix=prefix, se=se_fq, r1=r1, r2=r2)


def run_cli(cli, argv, **kw):
    """cli.main(argv, **kw) with stdout and stderr captured:
    (exit code, stdout, stderr); a SystemExit (a bad flag) gives its code
    or message as the exit code."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main(argv, **kw)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def bwasw_dataset(dirpath, *, n_se=0, n_pairs=0):
    """The data of tests/test_bwasw.py:19-36 without the oracle: a 200 kbp
    simdata genome (seed 7, two contigs) indexed with bwamem_tpu's
    build_index; n_se reads of 500 bp (seed 31, 2 % substitutions, 0.2 %
    indels) and n_pairs pairs of 300 bp (seed 32, 2 %, 0.1 %, insert 700
    +- 60).  Returns dict(prefix, fq, fq1, fq2) (the read files that were
    asked for)."""
    import simdata
    from bwamem_tpu.index import build_index
    d = Path(dirpath)
    d.mkdir(parents=True, exist_ok=True)
    contigs = simdata.make_genome(200_000, seed=7, n_contigs=2)
    simdata.write_fasta(contigs, str(d / "g.fa"))
    out = dict(prefix=str(d / "g"))
    if n_se:
        out["fq"] = _fq(d / "lr.fq", simdata.sim_reads(
            contigs, n_se, read_len=500, seed=31, sub_rate=0.02,
            indel_rate=0.002))
    if n_pairs:
        pairs = simdata.sim_reads(contigs, 2 * n_pairs, read_len=300,
                                  seed=32, sub_rate=0.02, indel_rate=0.001,
                                  paired=True, insert_mean=700,
                                  insert_std=60)
        out["fq1"] = _fq(d / "lr1.fq", pairs[0::2])
        out["fq2"] = _fq(d / "lr2.fq", pairs[1::2])
    build_index(str(d / "g.fa")).save(out["prefix"])
    return out


# ---- the device front's arena sizes, forced in both packages ----

def force_front_sizes(monkeypatch, how):
    """Patch the device front's first-dispatch sizes (`_sizes_for`) in both
    packages as tools/torch_front_force.sized says: how="small" starts
    every arena of its SMALL_ARENAS there, how="pinned" keeps the item
    arena from growing, so the front bails to the host front after its
    retries."""
    from bwamem_tpu.pipeline import device_front as jdf
    from bwamem_tpu_torch.pipeline import device_front as tdf
    from torch_front_force import sized
    jorig, torig = jdf._sizes_for, tdf._sizes_for

    def jsizes(al, N, Lr):
        hist, sizes = jorig(al, N, Lr)
        return hist, sized(sizes, how)
    monkeypatch.setattr(jdf, "_sizes_for", jsizes)
    monkeypatch.setattr(tdf, "_sizes_for",
                        lambda hist, N, Lr: sized(torig(hist, N, Lr), how))


def retry_matches(data, monkeypatch, pe):
    """SAM of a make_dataset batch (its 101 bp reads, or with pe its pairs)
    with the first-dispatch arenas forced small in both packages: the
    port's must equal the reference's and its own from the default sizes,
    after at least one retry of its device front and no bail-out."""
    from bwamem_tpu.io.fastq import read_fastx as j_read
    from bwamem_tpu.pipeline.align import Aligner as JAligner
    from bwamem_tpu_torch.io.fastq import read_fastx as t_read
    from bwamem_tpu_torch.pipeline.align import Aligner as TAligner
    from bwamem_tpu_torch.utils import timers

    def port():
        al = TAligner(data["tidx"], torch_opt(), device="cpu")
        if pe:
            return al.align_batch_pe(pe_reads(data, "t"))
        return al.align_batch_se(list(t_read(data["fq"])))
    unforced = port()
    force_front_sizes(monkeypatch, "small")
    ja = JAligner(data["jidx"])
    want = (ja.align_batch_pe(pe_reads(data, "j")) if pe
            else ja.align_batch_se(list(j_read(data["fq"]))))
    timers.reset()
    timers.enable(True)
    try:
        got = port()
        snap = timers.snapshot()
    finally:
        timers.enable(False)
        timers.reset()
    assert want == got, first_diff(want, got)
    assert got == unforced, first_diff(unforced, got)
    assert snap.get("front.retries.count", 0) >= 1
    assert snap.get("front.bailouts.count", 0) == 0
    assert snap.get("front.fallback_rows.count", 0) == 0


class _OtherDevice(torch.Tensor):
    """A CPU tensor that reports CUDA device index 0."""

    def get_device(self):
        return 0


def on_other_device(t):
    """t, reporting another device than its CPU neighbours (get_device()
    0): what a wrapper's device check must reject."""
    return t.as_subclass(_OtherDevice)


def col0_edge_inputs(N, W, R=1000):
    """A [R, W] int32 table over the whole int32 range and N indices in
    [0, R), the first at R - 1 and the second (N > 1) at 0."""
    rng = np.random.default_rng(N * 16 + W)
    tab = rng.integers(-(1 << 31), 1 << 31, (R, W),
                       dtype=np.int64).astype(np.int32)
    k = rng.integers(0, R, N, dtype=np.int32)
    k[:2] = (R - 1, 0)[:N]
    return tab, k


def col0_bad_inputs(tab, k):
    """Changes to a good gp2_col0 / gp3_col0 call (tab int32 [R, W], W >= 4,
    k int32 [N], N even) that the kernel does not take: dtype, rank,
    contiguity and device of either, and an empty table (no rows, no
    columns)."""
    return [dict(tab=tab.to(torch.int64)), dict(k=k.to(torch.int64)),
            dict(tab=tab[:, 0].contiguous()), dict(k=k.reshape(2, -1)),
            dict(tab=tab[:, :2]), dict(k=k[::2]),
            dict(k=on_other_device(k)), dict(tab=tab[:0]),
            dict(tab=tab[:, :0].contiguous())]
