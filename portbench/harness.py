"""One command, one cell, one run: set-up, the timed window, the check.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name from BENCHMARK.json at the checkout's root:
the cell's configuration file (`configs[].file`), its traffic mix
(`portbench/workloads/<traffic>.json`), its run settings and the limits of
its check (`portbench/cells/<cell>.json`), and each per-layer metric's
reader (`portbench/metrics/<metric>.py`, a `read(ctx)` that returns a
number or None).  A new configuration, traffic mix, cell or metric is new
files and new entries, never an edit.

Set-up (`setup_s`, from the process's start): torch and CUDA; the
configuration's genome (from its own seed) and the program's index
(bwamem_tpu_torch.index.build_index, as `bwa index`), both cached under
portbench/.cache/<config>/<hash of the configuration file>/ and built by
the first run in a checkout; the Aligner; the reads from --seed; one warm
batch of the cell's shape through align_stream.  No arena sizes are saved
or read (BWAMEM_TPU_HWM_DIR is unset): they only ever rise, so sizes one
run grew would set the work of every later run in the checkout; each run
starts from the program's defaults and grows them in its own warm batch
and window, so its work follows from its seed alone.  The first run's
genome and index build, once per deployment as `bwa index` is, is left
out of `setup_s` and reported apart as `index_build_s`.

The window: bwamem_tpu_torch.pipeline.align.align_stream over the
pre-made batches, cut by bases as cli._batches_by_bases cuts a stream;
after the first, no batch is issued once --seconds have passed, and the
window ends when the last issued batch's records have been yielded.  The
pool holds enough batches for the cell's `pool_rate` reads/s over
--seconds; a run that empties it before --seconds have passed fails.
With --trace 1 the window runs under torch.profiler (CUDA activity only)
with the spans of portbench/spans.py, and the run reports the per-layer
metrics.

Then: the peak device memory, the check that neither JAX nor the JAX
package was loaded, the program's state freed, and the plain reference
(portbench/ref) over the window's SAM.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import os
import resource
import shutil
import sys
import time

import numpy as np

from portbench.gen import genome as gen_genome
from portbench.gen import reads as gen_reads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "bwamem_tpu")
WARM_STREAM = 0
CHECK_STREAM = 1 << 20


class NoDevice(RuntimeError):
    """The card the cell asks for is not there."""


def log(msg: str) -> None:
    sys.stderr.write(f"[portbench] {msg}\n")
    sys.stderr.flush()


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def named(items: list[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_spec(root: str, name: str) -> dict:
    """The cell's entry, configuration, traffic and cell file, by name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = named(bench["workloads"], name, "workload")
    centry = named(bench["configs"], cell["config"], "configuration")
    cfg_path = os.path.join(root, centry["file"])
    d = os.path.join(root, "portbench")
    return dict(
        bench=bench, cell=cell, config=load_json(cfg_path),
        config_path=cfg_path, dir=d,
        traffic=load_json(os.path.join(d, "workloads",
                                       cell["traffic"] + ".json")),
        run=load_json(os.path.join(d, "cells", name + ".json")))


def metric_reader(bench_dir: str, name: str):
    """read(ctx) of portbench/metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> list[str]:
    """Top-level names of sys.modules that are JAX or the JAX package,
    compared whole (bwamem_tpu_torch is not bwamem_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ------------------------------------------------------------ set-up

def cache_dir(spec: dict) -> str:
    with open(spec["config_path"], "rb") as f:
        h = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(spec["dir"], ".cache", spec["config"]["name"], h)


def genome_and_index(spec: dict, cdir: str):
    """(Genome, index prefix, (seconds building, of them the genome's) or
    None): the configuration's genome and the program's index, from the
    cache or made and saved there."""
    from bwamem_tpu_torch.index import build_index
    prefix = os.path.join(cdir, "index")
    ready = os.path.join(cdir, "ready")
    built = None
    if not os.path.exists(ready):
        t0 = time.perf_counter()
        shutil.rmtree(cdir, ignore_errors=True)
        os.makedirs(cdir)
        contigs = gen_genome.make_genome(spec["config"])
        t_gen = time.perf_counter() - t0
        fa = os.path.join(cdir, "genome.fa")
        gen_genome.write_fasta(contigs, fa)
        idx = build_index(fa, with_kmer_table=True)
        idx.save(prefix)
        del idx
        os.unlink(fa)
        g = gen_reads.Genome.of(contigs)
        np.save(os.path.join(cdir, "genome.npy"), g.codes)
        with open(os.path.join(cdir, "genome.json"), "w") as f:
            json.dump(dict(names=g.names, lens=g.lens.tolist()), f)
        with open(ready, "w") as f:
            f.write("ok\n")
        built = (time.perf_counter() - t0, t_gen)
    meta = load_json(os.path.join(cdir, "genome.json"))
    codes = np.load(os.path.join(cdir, "genome.npy"))
    offs = np.concatenate([[0], np.cumsum(meta["lens"])[:-1]]).astype(int)
    g = gen_reads.Genome.of([(n, codes[o:o + ln]) for n, o, ln in
                             zip(meta["names"], offs, meta["lens"])])
    return g, prefix, built


def options(cfg: dict, paired: bool):
    from bwamem_tpu_torch.config import MEM_F_PE, MemOptions
    opt = MemOptions()
    for k, v in cfg["aligner"].items():
        if not hasattr(opt, k):
            raise KeyError(f"aligner option {k!r} is not a MemOptions field")
        setattr(opt, k, v)
    if paired:
        opt.flag |= MEM_F_PE
    return opt


def read_names(b, paired: bool) -> list[str]:
    """A batch's read names: the read's number (pairs: the pair's)."""
    idx = b.first + np.arange(len(b.seqs))
    return [str(i) for i in (idx // 2 if paired else idx)]


def to_reads(b, paired: bool):
    """Read objects of a batch."""
    from bwamem_tpu_torch.io.fastq import Read
    qual = "I" * b.seqs.shape[1]
    return [Read(name=nm, seq=s, qual=qual)
            for nm, s in zip(read_names(b, paired), b.seqs)]


# ------------------------------------------------------------ the run

class PoolEmptied(RuntimeError):
    """The window issued every batch of the pool before its time."""


def window(al, pool, seconds: float, paired: bool, rec=None):
    """(issued batches, SAM texts by batch, seconds): align_stream over
    the pool's batches, none after the first issued once `seconds` have
    passed (None: all of them)."""
    from bwamem_tpu_torch.pipeline.align import align_stream
    issued = []
    t0 = time.perf_counter()

    def feed():
        for b, reads in pool:
            if (issued and seconds is not None
                    and time.perf_counter() - t0 >= seconds):
                return
            issued.append(b)
            yield reads
        if seconds is not None:
            raise PoolEmptied(
                f"all {len(pool)} batches issued before {seconds} s had "
                f"passed: the program is past the cell's pool_rate, which "
                f"a benchmark change has to raise")

    sams = []
    stream = align_stream(al, feed(), pe=paired)
    while True:
        if rec is None:
            item = next(stream, None)
        else:
            with rec.span("stream"):
                item = next(stream, None)
        if item is None:
            break
        sams.append(item[1])
    if al.device.type == "cuda":
        import torch
        torch.cuda.synchronize(al.device)
    return issued, sams, time.perf_counter() - t0


def sample_reads(seed: int, n_reads: int, k: int, paired: bool):
    rng = gen_reads.rng_for(seed, CHECK_STREAM)
    if paired:
        p = np.sort(rng.choice(n_reads // 2, min(k // 2, n_reads // 2),
                               replace=False))
        return np.stack([2 * p, 2 * p + 1], 1).reshape(-1)
    return np.sort(rng.choice(n_reads, min(k, n_reads), replace=False))


def per_layer(spec: dict, ctx: dict) -> dict:
    out = {}
    name = spec["cell"]["name"]
    for m in spec["bench"]["per_layer"]:
        if name not in m.get("workloads", [name]):
            continue
        v = metric_reader(spec["dir"], m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def ext_bound_s(calls: list[dict]) -> float | None:
    """Least seconds of kernel #1's calls in the window (roofline.py)."""
    from portbench import roofline
    if not calls:
        return None
    total = 0.0
    for c in calls:
        kw = c["kw"]
        q = c["qlen"].cpu().numpy()
        t = c["tlen"].cpu().numpy()
        eb = c["eb"].cpu().numpy()
        mx = int(np.frombuffer(kw["mat_bytes"], np.int8).max())
        band = dict(max_mat=mx, o_ins=kw["o_ins"], e_ins=kw["e_ins"],
                    o_del=kw["o_del"], e_del=kw["e_del"])
        w1 = roofline.clamp_band(kw["w_opt"], q, eb, **band)
        w2 = roofline.clamp_band(2 * kw["w_opt"], q, eb, **band)
        total += roofline.bound_s(q, t, w1, w2, c["retried"].cpu().numpy(),
                                  int(kw["t_max"]))[0]
    return total


def run(argv=None, *, t_start: float | None = None, device=None,
        root: str = ROOT) -> int:
    """A run of one cell; prints the result line.  `device`: None takes
    the card (and fails without one); tests pass "cpu"."""
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cell_spec(root, args.workload)
    cfg, traffic, runcfg = spec["config"], spec["traffic"], spec["run"]
    paired = bool(traffic["paired"])

    import torch
    if device is None:
        chips = int(spec["cell"]["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"the cell asks for {chips} CUDA device(s); "
                           f"{torch.cuda.device_count()} visible")
        device = "cuda:0"
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
    marks = [("start", t_start),
             ("torch and the device", time.perf_counter())]
    cdir = cache_dir(spec)
    os.makedirs(cdir, exist_ok=True)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(spec["dir"], ".cache", sub)
    os.environ.pop("BWAMEM_TPU_HWM_DIR", None)
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.pipeline.align import Aligner
    from bwamem_tpu_torch.utils import timers
    timers.enable(False)

    g, prefix, built = genome_and_index(spec, cdir)
    if built:
        log(f"first run in this checkout: genome and index built in "
            f"{built[0]:.3f} s, of which the genome {built[1]:.3f}")
    marks.append(("genome" + (" and index build" if built else ""),
                  time.perf_counter()))
    idx = load_index(prefix)
    marks.append(("index load", time.perf_counter()))
    al = Aligner(idx, options(cfg, paired), device=device)
    marks.append(("Aligner", time.perf_counter()))
    n_b = gen_reads.batch_reads(traffic)
    warm = gen_reads.make_batch(g, traffic, args.seed, WARM_STREAM, n_b, 0)
    n_pool = math.ceil(float(runcfg["pool_rate"]) * args.seconds / n_b) + 2
    batches = [gen_reads.make_batch(g, traffic, args.seed, 1 + k, n_b,
                                    k * n_b)
               for k in range(n_pool)]
    pool = [(b, to_reads(b, paired)) for b in batches]
    marks.append(("reads", time.perf_counter()))
    window(al, [(warm, to_reads(warm, paired))], None, paired)
    marks.append(("warm batch", time.perf_counter()))
    build_s = built[0] if built else 0.0
    setup_s = time.perf_counter() - t_start - build_s
    log(f"set-up {setup_s:.3f} s" + (f" after the build's {build_s:.3f}"
                                     if built else "") + ": " + ", ".join(
        f"{k} {t - marks[i][1]:.3f}" for i, (k, t) in enumerate(marks[1:]))
        + f"; {len(pool)} batches of {n_b} reads ready")

    rec = prof = None
    if args.trace:
        from portbench import spans
        rec = spans.Recorder()
        rec.install()
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA
                                   if dev.type == "cuda" else
                                   ProfilerActivity.CPU])
        prof.__enter__()
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    w0 = time.time_ns()
    try:
        issued, sams, window_s = window(al, pool, args.seconds, paired, rec)
    except PoolEmptied as e:
        log(str(e))
        return 5
    w1 = time.time_ns()
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    n_reads = sum(len(b.seqs) for b in issued)
    snap = {}
    if args.trace:
        prof.__exit__(None, None, None)
        rec.uninstall()
        snap = timers.snapshot()
        timers.enable(False)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    bad = forbidden_loaded()
    if bad:
        log(f"modules loaded that the port must not load: {bad}")
        return 4
    log(f"window {window_s:.3f} s: {len(issued)} batches, {n_reads} reads, "
        f"{n_reads / window_s:.1f} reads/s")

    trace_red = None
    ext_s = None
    if args.trace:
        from portbench import trace as tr
        t0 = time.perf_counter()
        evs = tr.device_events(prof, dev.type)
        t1 = time.perf_counter()
        trace_red = tr.reduce(evs, w0, w1, rec.spans)
        t2 = time.perf_counter()
        ext_s = ext_bound_s(rec.ext_calls)
        log(f"trace read in {time.perf_counter() - t0:.3f} s (events "
            f"{t1 - t0:.3f}, reduction {t2 - t1:.3f}, #1's bound "
            f"{time.perf_counter() - t2:.3f}): "
            f"{trace_red['events']} device events, {trace_red['inside']} in "
            f"the window, the first {trace_red['lead_s']:.6f} s after its "
            f"start, the last {trace_red['tail_s']:.6f} s before its end; "
            f"{len(rec.spans)} host spans, {len(rec.ext_calls)} calls of "
            f"kernel #1")
        del prof
    del al, idx, pool
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the plain reference, over the window's SAM
    t0 = time.perf_counter()
    from portbench.ref import check
    names = [read_names(b, paired) for b in issued]
    sample = sample_reads(args.seed, n_reads, int(runcfg["check_reads"]),
                          paired)
    numbers = check.judge(sams, issued, names, g, cfg["aligner"], paired,
                          sample)
    log(f"reference: {time.perf_counter() - t0:.3f} s; sampled "
        f"{len(sample)}, judged {numbers.pop('checked')}, at their origin "
        f"{numbers.pop('at_origin'):.4f}")
    limits = runcfg["limits"]
    verdict = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(numbers[k] <= limits[k] for k in limits)

    if args.trace:
        ctx = dict(reads=n_reads, window_s=window_s, paired=paired,
                   cpu_s=(ru1.ru_utime - ru0.ru_utime
                          + ru1.ru_stime - ru0.ru_stime),
                   spans=rec.totals(), timers=snap, trace=trace_red,
                   ext_bound_s=ext_s)
        metrics = per_layer(spec, ctx)
    else:
        metrics = {"reads_per_s": {"value": n_reads / window_s,
                                   "unit": "reads/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else dev.type),
               "count": 1, "memory_peak_bytes": int(peak)}
    res = {"correct": bool(correct), "attempted": n_reads,
           "failed": int(numbers["missing"]), "metrics": metrics,
           "device": devinfo}
    if trace_red is not None:
        devinfo.update(busy_s=trace_red["busy_s"],
                       window_s=trace_red["window_s"])
        res["breakdown"] = {"device_ops": trace_red["device_ops"],
                            "idle_gaps": trace_red["idle_gaps"]}
    if built:
        res["index_build_s"] = build_s
    res["check"] = verdict
    for k, v in verdict.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    sys.stdout.write(json.dumps(res) + "\n")
    sys.stdout.flush()
    return 0


def main(argv=None, t_start: float | None = None) -> int:
    try:
        return run(argv, t_start=t_start)
    except NoDevice as e:
        log(str(e))
        return 3
