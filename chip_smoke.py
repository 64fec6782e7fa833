#!/usr/bin/env python3
"""Smoke run of bwamem_tpu_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Three phases; any failure exits non-zero without printing a result.

1. Environment: the card's name and power limit, then the build of every
   native source the main path needs (the CUDA extension kernel with nvcc
   for sm_90a, the host kernels and the suffix-array builder with cc), all
   compilers started together.
2. Kernel against plain: ~16k extension lanes shaped like the front's EXT
   lanes (query rows 128, target rows 256, default scoring; lanes that
   retry at the doubled band, empty queries and z-drop cuts included),
   made with numpy from a fixed seed.  The CUDA kernel must equal its plain
   PyTorch version on all 7 outputs; both are timed with CUDA events.
3. Main path at full size: a 5 Mbp genome and 2 x 8192 single-end 101 bp
   reads (tools/se_smoke_data.py: simdata.py with fixed seeds, indexed
   with the port's build_index and cached under build/), aligned by
   align_stream on the card.
   Prints reads/s, the stage timers, the kernel's launches in that run, the
   fallback-row count (must be 0) and the peak device memory, then reruns
   the first 256 reads on the CPU and requires byte-identical SAM.  The
   widest extension call of that run is kept, and the kernel is held
   against its plain version on those lanes too; the kernels line reports
   these main-path lanes.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA device and no network.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CPU_CHECK_READS = 256
# lanes of the kernel comparison: the main path's EXT shape
LANES, LQ, T_MAX = 16384, 128, 256
# H100 SXM peaks: HBM bytes/s (data sheet), and the int32 rate outside the
# tensor cores, half the 67 TFLOP/s float32 rate (an SM issues 64 int32
# against 128 float32 operations per clock)
PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 33.5e12
OPS_PER_CELL = 16      # int32 operations of ksw's recurrence per DP cell


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 5) -> float:
    import torch
    fn()                                   # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


# ------------------------------------------------------------------ phase 1

def phase_env():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")

    from bwamem_tpu_torch import native
    from bwamem_tpu_torch.index import native as sais
    from bwamem_tpu_torch.ops import ext_kernel
    errors = []

    def build(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            log(f"build {name}: {time.perf_counter() - t0:.1f} s")
        except BaseException as e:        # reported after the join
            errors.append(f"{name}: {e}")

    def load_sais():
        if not sais.available():
            raise RuntimeError("the suffix-array builder did not build")

    jobs = [threading.Thread(target=build, args=a) for a in (
        ("ext_kernel.cu (nvcc sm_90a)", ext_kernel.load),
        ("hostops.c (cc)", native.load),
        ("sais.c (cc)", load_sais))]
    t0 = time.perf_counter()
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    if errors:
        raise RuntimeError("build failed: " + "; ".join(errors))
    log(f"build total: {time.perf_counter() - t0:.1f} s")
    return smi.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ phase 2

def ext_lanes():
    """EXT-shaped lanes: queries of up to 101 bases in [LQ, B] rows,
    targets of up to T_MAX rows; categories cover plain extensions, empty
    queries, z-drop cuts, lanes whose best cell sits 80 off the diagonal
    (they retry at the doubled band) and unrelated targets."""
    import numpy as np
    import se_smoke_data as sd
    rng = np.random.default_rng(sd.SEED)
    qT = np.full((LQ, LANES), 4, np.int32)
    tT = np.full((T_MAX, LANES), 4, np.int32)
    qlen = np.zeros(LANES, np.int32)
    tlen = np.zeros(LANES, np.int32)
    h0 = rng.integers(1, 102, LANES).astype(np.int32)
    kind = rng.integers(0, 10, LANES)
    for b in range(LANES):
        k = kind[b]
        ql = 0 if k == 0 else int(rng.integers(1, sd.READ_LEN + 1))
        q = rng.integers(0, 4, ql)
        m = q.copy()
        sub = rng.random(ql) < 0.02
        m[sub] = rng.integers(0, 4, int(sub.sum()))
        if k == 0:                         # empty query
            t = rng.integers(0, 4, int(rng.integers(1, 120)))
        elif k == 1:                       # z-drop: match, then garbage
            cut = ql // 3
            t = np.concatenate([m[:cut], rng.integers(0, 4, 150)])
        elif k == 2:                       # 80-base gap: retry lanes
            h0[b] = 100
            t = np.concatenate([rng.integers(0, 4, 80), m,
                                rng.integers(0, 4, 20)])
        elif k == 3:                       # unrelated
            t = rng.integers(0, 4, int(rng.integers(1, T_MAX)))
        else:                              # ordinary extension + tail
            t = np.concatenate([m, rng.integers(0, 4,
                                                int(rng.integers(0, 100)))])
        t = t[:T_MAX]
        qT[:ql, b] = q
        tT[:len(t), b] = t
        qlen[b], tlen[b] = ql, len(t)
    eb = np.full(LANES, 5, np.int32)
    return qT, tT, qlen, tlen, h0, eb


def bound(qlen, tlen, w1, w2, retried, t_max):
    """Least time the card could take for these lanes, from the inputs:
    (bound_ms, bound_by, bytes, cells).  Bytes: the query and target rows
    of each nonempty lane (rows < qlen, rows < min(tlen, t_max)) read once,
    the 4 per-lane inputs read once and the 7 outputs written once.  Cells:
    ksw's band, min(qlen, i + w + 1) - max(0, i - w) columns at each row
    i < min(tlen, t_max), at w1 for every lane and again at w2 for the
    lanes that retry (the plain version's `retried`).  The window shrink
    and z-drop of ksw can leave fewer cells; they are not subtracted."""
    import torch
    B = qlen.shape[0]
    q = qlen.to(torch.int64)
    rows = tlen.to(torch.int64).clamp(0, t_max)
    live = (q > 0) & (rows > 0)
    nbytes = 4 * (int(torch.where(live, q + rows, 0).sum()) + (4 + 7) * B)
    i = torch.arange(t_max, device=q.device, dtype=torch.int64)[:, None]

    def band_cells(w):
        w = w.to(torch.int64)[None, :]
        c = (torch.minimum(q[None, :], i + w + 1) - (i - w).clamp(min=0))
        return torch.where(i < rows[None, :], c.clamp(min=0), 0).sum(0)

    cells = int(band_cells(w1).sum()) + int(
        torch.where(retried.bool(), band_cells(w2), 0).sum())
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = cells * OPS_PER_CELL / PEAK_INT32_OPS * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else
            "bytes", nbytes, cells)


def hold_kernel(label, qT, qlen, tT, tlen, h0, eb, **kw):
    """The CUDA kernel against its plain version on one set of lanes (all
    7 outputs must be equal), both timed with CUDA events; returns the
    kernel's entry of the kernels line (launches filled in later)."""
    import torch
    from bwamem_tpu_torch.ops import ext_kernel
    B = qlen.shape[0]
    lq, tm = kw["lq_max"], kw["t_max"]
    res, retried = ext_kernel.extend_batch_pl2(qT, qlen, tT, tlen, h0, eb,
                                               **kw)
    torch.cuda.synchronize()
    pres, pretried = ext_kernel.extend_batch_pl2_plain(qT, qlen, tT, tlen,
                                                       h0, eb, **kw)
    got = torch.stack(list(res) + [retried]).to(torch.int64)
    want = torch.stack(list(pres) + [pretried]).to(torch.int64)
    err = int((got - want).abs().max().item())
    n_bad = int((got != want).any(0).sum().item())
    n_retried = int(pretried.sum())
    log(f"kernel vs plain, {label}: {B} lanes x {lq} query rows x {tm} "
        f"target rows, {n_bad} differ, max_abs_err {err}, retried "
        f"{n_retried}, empty queries {int((qlen == 0).sum())}")
    if err != 0:
        names = ("score", "qle", "tle", "gtle", "gscore", "max_off",
                 "retried")
        rows = [names[k] for k in range(7) if bool((got[k] != want[k]).any())]
        raise RuntimeError(f"CUDA kernel disagrees with its plain version "
                           f"on {n_bad} lanes of the {label} (fields {rows})")

    ms = median_ms(lambda: ext_kernel.extend_batch_pl2(
        qT, qlen, tT, tlen, h0, eb, **kw))
    plain_ms = median_ms(lambda: ext_kernel.extend_batch_pl2_plain(
        qT, qlen, tT, tlen, h0, eb, **kw))
    w1, w2, _ = ext_kernel._bands(
        qlen.to(torch.int32), eb.to(torch.int32), mat_bytes=kw["mat_bytes"],
        o_del=kw["o_del"], e_del=kw["e_del"], o_ins=kw["o_ins"],
        e_ins=kw["e_ins"], w_opt=kw["w_opt"])
    bound_ms, bound_by, nbytes, cells = bound(qlen, tlen, w1, w2, pretried,
                                              tm)
    log(f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, band cells {cells}, "
        f"bytes {nbytes}, bound {bound_ms:.5f} ms ({bound_by}), kernel / "
        f"bound {ms / bound_ms:.1f}")
    return dict(name="ext_pl2_kernel", route="cuda",
                source="bwamem_tpu_torch/csrc/ext_kernel.cu",
                replaces="bwamem_tpu/ops/pallas_ext.py:229",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                retried=n_retried)


def phase_kernel():
    import numpy as np
    import torch
    from bwamem_tpu_torch.config import MemOptions
    opt = MemOptions()
    dev = torch.device("cuda")
    qT, tT, qlen, tlen, h0, eb = (torch.from_numpy(a).to(dev)
                                  for a in ext_lanes())
    res = hold_kernel(
        "generated lanes", qT, qlen, tT, tlen, h0, eb, lq_max=LQ,
        t_max=T_MAX, mat_bytes=np.asarray(opt.mat, np.int8).tobytes(),
        o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins, e_ins=opt.e_ins,
        zdrop=opt.zdrop, w_opt=opt.w)
    if res["retried"] == 0:
        raise RuntimeError("no lane retried: the comparison misses the "
                           "second pass")
    return res


# ------------------------------------------------------------------ phase 3

def phase_main():
    import torch
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import read_fastx
    from bwamem_tpu_torch.ops import ext_kernel
    from bwamem_tpu_torch.pipeline.align import Aligner, align_stream
    from bwamem_tpu_torch.utils import timers
    import se_smoke_data as sd
    prefix, fq = sd.smoke_data(log)
    idx = load_index(prefix)
    reads = list(read_fastx(fq))
    assert len(reads) == sd.BATCH * sd.N_BATCHES
    batches = [reads[k * sd.BATCH:(k + 1) * sd.BATCH]
               for k in range(sd.N_BATCHES)]
    al = Aligner(idx, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    timers.enable(True)
    # keep a copy of the widest extension call of the run, so the kernel
    # can be held against its plain version on lanes the main path built
    wrapper = ext_kernel.extend_batch_pl2
    widest = {}

    def keep_widest(*args, **kw):
        if args[1].shape[0] >= widest.get("B", 0):
            widest.update(B=args[1].shape[0], args=[a.clone() for a in args],
                          kw=dict(kw))
        return wrapper(*args, **kw)

    ext_kernel.extend_batch_pl2 = keep_widest
    ext_kernel.launches = 0                 # count the main path's run only
    sams = []
    t0 = time.perf_counter()
    tb = t0
    try:
        for k, (n, ss) in enumerate(align_stream(al, batches)):
            torch.cuda.synchronize()
            now = time.perf_counter()
            log(f"batch {k}: {n} reads in {now - tb:.3f} s")
            tb = now
            sams.extend(ss)
    finally:
        ext_kernel.extend_batch_pl2 = wrapper
    wall = time.perf_counter() - t0
    launches = ext_kernel.launches
    timers.enable(False)
    snap = timers.snapshot()
    peak = torch.cuda.max_memory_allocated()
    fb = snap.get("front.fallback_rows.count", 0)
    log(f"main path: {len(sams)} reads in {wall:.3f} s = "
        f"{len(sams) / wall:.1f} reads/s on {torch.cuda.get_device_name(0)}")
    log("stage timers:\n" + timers.report())
    log(f"ext kernel launches: {launches}; fallback rows: {fb}; peak CUDA "
        f"memory: {peak / 2**20:.1f} MiB")
    if launches <= 0:
        raise RuntimeError("the main path never launched the CUDA kernel")
    if fb != 0:
        raise RuntimeError(f"{fb} fallback rows")
    if len(sams) != len(reads) or not all(s.endswith("\n") for s in sams):
        raise RuntimeError("SAM output does not cover every read")
    mapped = sum(1 for s in sams if not (int(s.split("\t")[1]) & 4))
    log(f"mapped {mapped}/{len(sams)} reads")
    if mapped < 0.9 * len(sams):
        raise RuntimeError(f"only {mapped} of {len(sams)} reads mapped")

    t1 = time.perf_counter()
    cpu = Aligner(idx, device="cpu").align_batch_se(reads[:CPU_CHECK_READS])
    if cpu != sams[:CPU_CHECK_READS]:
        bad = [i for i in range(CPU_CHECK_READS) if cpu[i] != sams[i]]
        raise RuntimeError(f"GPU and CPU SAM differ on {len(bad)} of "
                           f"{CPU_CHECK_READS} reads (first {bad[:5]}):\n"
                           f"{sams[bad[0]]}{cpu[bad[0]]}")
    log(f"CPU rerun of {CPU_CHECK_READS} reads: SAM identical "
        f"({time.perf_counter() - t1:.1f} s)")
    return launches, widest


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "bwamem_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(bwamem_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    t0 = time.perf_counter()
    phase_env()
    generated = phase_kernel()
    launches, widest = phase_main()
    # the line reports the main path's own lanes; the generated lanes
    # (retries, empty queries, z-drop cuts) add their error
    kern = hold_kernel("main-path lanes", *widest["args"], **widest["kw"])
    kern.pop("retried")
    kern["launches"] = launches
    kern["max_abs_err"] = max(kern["max_abs_err"], generated["max_abs_err"])
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
