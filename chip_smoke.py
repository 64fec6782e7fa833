#!/usr/bin/env python3
"""Smoke run of bwamem_tpu_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py

Three phases; any failure exits non-zero without printing a result.

1. Environment: the card's name and power limit, then the build of every
   native source the main path needs (the CUDA extension kernels with nvcc
   for sm_90a — one source holds both —, the host kernels and the
   suffix-array code with cc), all compilers started together.
2. Kernels against plain, on lanes made with numpy from a fixed seed:
   * ext_pl2_kernel (band-doubling retry in the lane): ~16k lanes shaped
     like the front's EXT lanes (query rows 128, target rows 256, default
     scoring; lanes that retry at the doubled band, empty queries and
     z-drop cuts included), all 7 outputs;
   * ext_pl_kernel (one pass at a per-lane band): the same 16k lanes with
     bands 100 and 200 alternating, and ~1k long lanes (query rows 4095,
     target rows 4608, queries of 1000-4095 bases), all 6 outputs.
   A kernel must equal its plain PyTorch version; both are timed with
   CUDA events.
3. Main paths at full size on a 5 Mbp genome (tools/se_smoke_data.py:
   simdata.py with fixed seeds, indexed with the port's build_index and
   cached under build/):
   * 2 x 8192 single-end 101 bp reads through align_stream: the device
     front and ext_pl2_kernel; no row may fall back;
   * 512 reads of 1000 bp: every row is handed to the host-compacted
     front, whose fused path launches ext_pl2_kernel;
   * 128 reads of 5000 bp: the host-compacted front's side path, which
     launches ext_pl_kernel and sends queries over 4095 bases to the plain
     extension.
   Each path runs with both launch counts set to 0 just before it and
   read just after; a path that never launched its kernel, or launched
   the other path's, fails.  Each prints reads/s, the stage timers and the
   peak device memory; requires nearly every read of the path mapped, and
   mapped where simdata sampled it (the read's name says where); then
   reruns its first reads (256, 32, 2) on the CPU and requires
   byte-identical SAM.  The 5000 bp path also reruns its first 32 reads on
   the card as a batch of their own, byte-identical again.  The widest
   call of each kernel in its path is kept, and the kernel is held against
   its plain version on those lanes too; the kernels line reports these
   main-path lanes.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA device and no network.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CPU_CHECK_READS = 256
# reads of each long-read batch rerun on the CPU (a 5000 bp read takes the
# CPU tens of seconds, most of it the plain extension), and reads rerun on
# the card as a batch of their own
LONG_CPU_CHECK = {1000: 32, 5000: 2}
LONG_SUB_BATCH = {5000: 32}
# lanes of the kernel comparison: the main path's EXT shape
LANES, LQ, T_MAX = 16384, 128, 256
# long lanes of the one-pass kernel's comparison
LONG_LANES, LONG_LQ, LONG_T_MAX = 1024, 4095, 4608
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
        ("ext_kernel.cu, both kernels (nvcc sm_90a)", ext_kernel.load),
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


def bound(qlen, tlen, w1, w2, retried, t_max, lane_words=4 + 7):
    """Least time the card could take for these lanes, from the inputs:
    (bound_ms, bound_by, bytes, cells).  Bytes: the query and target rows
    of each nonempty lane (rows < qlen, rows < min(tlen, t_max)) read once,
    and `lane_words` int32 per lane: the per-lane inputs read once and the
    outputs written once (4 + 7 for ext_pl2_kernel).  Cells:
    ksw's band, min(qlen, i + w + 1) - max(0, i - w) columns at each row
    i < min(tlen, t_max), at w1 for every lane and again at w2 for the
    lanes that retry (the plain version's `retried`).  The window shrink
    and z-drop of ksw can leave fewer cells; they are not subtracted."""
    import torch
    B = qlen.shape[0]
    q = qlen.to(torch.int64)
    rows = tlen.to(torch.int64).clamp(0, t_max)
    live = (q > 0) & (rows > 0)
    nbytes = 4 * (int(torch.where(live, q + rows, 0).sum()) + lane_words * B)

    def band_cells(w):
        # rows in chunks: [t_max, B] int64 temporaries would be GBs for
        # the long lanes
        w = w.to(torch.int64)[None, :]
        total = torch.zeros_like(q)
        for r0 in range(0, t_max, 512):
            i = torch.arange(r0, min(r0 + 512, t_max), device=q.device,
                             dtype=torch.int64)[:, None]
            c = (torch.minimum(q[None, :], i + w + 1) - (i - w).clamp(min=0))
            total += torch.where(i < rows[None, :], c.clamp(min=0), 0).sum(0)
        return total

    cells = int(band_cells(w1).sum()) + int(
        torch.where(retried.bool(), band_cells(w2), 0).sum())
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = cells * OPS_PER_CELL / PEAK_INT32_OPS * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else
            "bytes", nbytes, cells)


def hold_kernel(label, qT, qlen, tT, tlen, h0, eb, **kw):
    """ext_pl2_kernel against its plain version on one set of lanes (all
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


def ext_lanes_long():
    """Long lanes for the one-pass kernel: queries of 1000-4095 bases
    against their own mutated copy (2% substitutions, a deletion and an
    insertion of a few bases, a random tail), one lane in eight against an
    unrelated target (z-drop), and padding lanes (qlen = tlen = 0, h0 = 1)
    at the end, as the long-read path builds them."""
    import numpy as np
    import se_smoke_data as sd
    rng = np.random.default_rng(sd.SEED + 1)
    B = LONG_LANES
    qT = np.full((LONG_LQ, B), 4, np.int32)
    tT = np.full((LONG_T_MAX, B), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    h0 = np.ones(B, np.int32)
    for b in range(B - 64):
        ql = int(rng.integers(1000, LONG_LQ + 1))
        q = rng.integers(0, 4, ql)
        if b % 8 == 7:
            t = rng.integers(0, 4, int(rng.integers(500, LONG_T_MAX)))
        else:
            m = q.copy()
            sub = rng.random(ql) < 0.02
            m[sub] = rng.integers(0, 4, int(sub.sum()))
            cut = int(rng.integers(100, ql - 100))
            gap = int(rng.integers(1, 40))
            t = np.concatenate([m[:cut], rng.integers(0, 4, gap),
                                m[cut + gap // 2:],
                                rng.integers(0, 4, int(rng.integers(0, 300)))])
        t = t[:LONG_T_MAX]
        qT[:ql, b] = q
        tT[:len(t), b] = t
        qlen[b], tlen[b], h0[b] = ql, len(t), int(rng.integers(19, 300))
    eb = np.full(B, 5, np.int32)
    return qT, tT, qlen, tlen, h0, eb


def hold_kernel_pl(label, qT, qlen, tT, tlen, h0, w, eb, plain_reps=5,
                   **kw):
    """ext_pl_kernel against its plain version on one set of lanes (all 6
    outputs must be equal), both timed with CUDA events; returns the
    kernel's entry of the kernels line (launches filled in later)."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops import ext_kernel
    from bwamem_tpu_torch.ops.extend import _adjust_w
    B = qlen.shape[0]
    lq, tm = kw["lq_max"], kw["t_max"]
    args = (qT, qlen, tT, tlen, h0, w, eb)
    res = ext_kernel.extend_batch_pl(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pres = ext_kernel.extend_batch_pl_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_first = (time.perf_counter() - t0) * 1e3
    got = torch.stack(list(res)).to(torch.int64)
    want = torch.stack(list(pres)).to(torch.int64)
    err = int((got - want).abs().max().item())
    n_bad = int((got != want).any(0).sum().item())
    log(f"one-pass kernel vs plain, {label}: {B} lanes x {lq} query rows x "
        f"{tm} target rows, {n_bad} differ, max_abs_err {err}, empty lanes "
        f"{int(((qlen == 0) & (tlen == 0)).sum())}, longest query "
        f"{int(qlen.max())}, longest target {int(tlen.max())}")
    if err != 0:
        names = ("score", "qle", "tle", "gtle", "gscore", "max_off")
        rows = [names[k] for k in range(6) if bool((got[k] != want[k]).any())]
        raise RuntimeError(f"the one-pass CUDA kernel disagrees with its "
                           f"plain version on {n_bad} lanes of the {label} "
                           f"(fields {rows})")
    ms = median_ms(lambda: ext_kernel.extend_batch_pl(*args, **kw))
    # the plain version of a long shape runs thousands of row trips (many
    # seconds): its one run above, on the host clock, is its time
    plain_ms = (median_ms(lambda: ext_kernel.extend_batch_pl_plain(
        *args, **kw), reps=plain_reps) if plain_reps > 1 else plain_first)
    mat = np.frombuffer(kw["mat_bytes"], np.int8)
    wadj = _adjust_w(w.to(torch.int32), qlen.to(torch.int32), int(mat.max()),
                     eb.to(torch.int32), kw["o_ins"], kw["e_ins"],
                     kw["o_del"], kw["e_del"])
    bound_ms, bound_by, nbytes, cells = bound(
        qlen, tlen, wadj, wadj, torch.zeros_like(qlen), tm,
        lane_words=4 + 6)
    log(f"one-pass kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, band cells "
        f"{cells}, bytes {nbytes}, bound {bound_ms:.5f} ms ({bound_by}), "
        f"kernel / bound {ms / bound_ms:.1f}")
    return dict(name="ext_pl_kernel", route="cuda",
                source="bwamem_tpu_torch/csrc/ext_kernel.cu",
                replaces="bwamem_tpu/ops/pallas_ext.py:213",
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_kernel():
    """Both kernels against their plain versions on generated lanes;
    returns the largest error of each kernel."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.config import MemOptions
    opt = MemOptions()
    dev = torch.device("cuda")
    score = dict(mat_bytes=np.asarray(opt.mat, np.int8).tobytes(),
                 o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                 e_ins=opt.e_ins, zdrop=opt.zdrop)
    qT, tT, qlen, tlen, h0, eb = (torch.from_numpy(a).to(dev)
                                  for a in ext_lanes())
    res = hold_kernel("generated lanes", qT, qlen, tT, tlen, h0, eb,
                      lq_max=LQ, t_max=T_MAX, w_opt=opt.w, **score)
    if res["retried"] == 0:
        raise RuntimeError("no lane retried: the comparison misses the "
                           "second pass")
    # the one-pass kernel: the same lanes at bands w and 2w, then long lanes
    w = torch.where(torch.arange(LANES, device=dev) % 2 == 0, opt.w,
                    2 * opt.w).to(torch.int32)
    short = hold_kernel_pl("generated short lanes", qT, qlen, tT, tlen, h0,
                           w, eb, lq_max=LQ, t_max=T_MAX, **score)
    qT, tT, qlen, tlen, h0, eb = (torch.from_numpy(a).to(dev)
                                  for a in ext_lanes_long())
    w = torch.where(torch.arange(LONG_LANES, device=dev) % 2 == 0, opt.w,
                    2 * opt.w).to(torch.int32)
    long_ = hold_kernel_pl("generated long lanes", qT, qlen, tT, tlen, h0,
                           w, eb, plain_reps=1, lq_max=LONG_LQ,
                           t_max=LONG_T_MAX, **score)
    return res["max_abs_err"], max(short["max_abs_err"],
                                   long_["max_abs_err"])


# ------------------------------------------------------------------ phase 3

class WidestCall:
    """Wraps a kernel wrapper of ops/ext_kernel for one main-path run: the
    launch count starts at 0, and a copy of the widest call (most lanes
    times target rows) is kept so the kernel can be held against its plain
    version on lanes the main path built."""

    def __init__(self, name, counter):
        from bwamem_tpu_torch.ops import ext_kernel
        self.mod, self.name, self.counter = ext_kernel, name, counter
        self.wrapper = getattr(ext_kernel, name)
        self.size, self.args, self.kw = 0, None, None

    def __call__(self, *args, **kw):
        size = args[1].shape[0] * kw["t_max"]
        if size >= self.size:
            self.size, self.kw = size, dict(kw)
            self.args = [a.clone() for a in args]
        return self.wrapper(*args, **kw)

    def __enter__(self):
        setattr(self.mod, self.name, self)
        setattr(self.mod, self.counter, 0)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.wrapper)
        self.launches = getattr(self.mod, self.counter)


def placement(read, sam):
    """Where the read's primary SAM line puts it, against where simdata
    sampled it: the read is named rd<i>_<contig>_<0-based start>, and the
    start of the alignment, less the clipped bases before it, must lie
    within 20 + L/50 bases of that start (indels shift it by a few
    bases).  "origin", or "repeat" for another place at a mapping quality
    under 20 (the genome carries repeats), else "wrong"."""
    contig, start = read.name.split("_", 1)[1].rsplit("_", 1)
    for line in sam.splitlines():
        f = line.split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        if flag & 4:
            break
        clip = re.match(r"(\d+)[SH]", f[5])
        qlen = sum(int(n) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5])
                   if op in "MIS=XH")
        got = int(f[3]) - 1 - (int(clip.group(1)) if clip else 0)
        if qlen != read.seq.shape[0]:
            break
        if f[2] == contig and abs(got - int(start)) <= 20 + qlen // 50:
            return "origin"
        return "repeat" if int(f[4]) < 20 else "wrong"
    return "wrong"


def check_sams(label, sams, reads, min_mapped=0.9, min_origin=0.8,
               max_wrong=0.01):
    """Every read has SAM; nearly all are mapped, and mapped where they
    were sampled (every read of the path, not only the ones rerun)."""
    if len(sams) != len(reads) or not all(s.endswith("\n") for s in sams):
        raise RuntimeError(f"{label}: SAM output does not cover every read")
    mapped = sum(1 for s in sams if not (int(s.split("\t")[1]) & 4))
    where = [placement(r, s) for r, s in zip(reads, sams)]
    origin, wrong = where.count("origin"), where.count("wrong")
    log(f"{label}: mapped {mapped}/{len(sams)} reads; {origin} at the "
        f"position they were sampled from, {where.count('repeat')} at "
        f"another copy of a repeat, {wrong} unmapped or misplaced")
    if mapped < min_mapped * len(sams):
        raise RuntimeError(f"{label}: only {mapped} of {len(sams)} reads "
                           f"mapped")
    if origin < min_origin * len(sams) or wrong > max_wrong * len(sams):
        raise RuntimeError(f"{label}: {origin} of {len(sams)} reads are "
                           f"aligned where they were sampled and {wrong} "
                           f"are misplaced")


def check_cpu(label, cpu_al, reads, sams, k):
    """Rerun the first k reads on the CPU: byte-identical SAM (so the same
    reads are unmapped in both)."""
    t1 = time.perf_counter()
    cpu = cpu_al.align_batch_se(reads[:k])
    if cpu != sams[:k]:
        bad = [i for i in range(k) if cpu[i] != sams[i]]
        raise RuntimeError(f"{label}: GPU and CPU SAM differ on {len(bad)} "
                           f"of {k} reads (first {bad[:5]}):\n"
                           f"{sams[bad[0]]}{cpu[bad[0]]}")
    log(f"{label}: CPU rerun of {k} reads: SAM identical "
        f"({time.perf_counter() - t1:.1f} s)")


def check_sub_batch(label, al, reads, sams, k):
    """Rerun the first k reads on the card as a batch of their own (other
    tensor sizes, lane tiles and row positions): byte-identical SAM."""
    import torch
    t1 = time.perf_counter()
    sub = al.align_batch_se(reads[:k])
    torch.cuda.synchronize()
    if sub != sams[:k]:
        bad = [i for i in range(k) if sub[i] != sams[i]]
        raise RuntimeError(f"{label}: SAM of {len(bad)} of the first {k} "
                           f"reads depends on the batch they are in (first "
                           f"{bad[:5]}):\n{sams[bad[0]]}{sub[bad[0]]}")
    log(f"{label}: rerun of {k} reads as their own batch on the card: SAM "
        f"identical ({time.perf_counter() - t1:.1f} s)")


def phase_main(idx, cpu_al):
    """The 101 bp path: device front + ext_pl2_kernel.  Returns the
    aligner and the two kernels' hooks (launch count, widest call)."""
    import torch
    from bwamem_tpu_torch.io.fastq import read_fastx
    from bwamem_tpu_torch.pipeline.align import Aligner, align_stream
    from bwamem_tpu_torch.utils import timers
    import se_smoke_data as sd
    _, fq = sd.smoke_data(log)
    reads = list(read_fastx(fq))
    assert len(reads) == sd.BATCH * sd.N_BATCHES
    batches = [reads[k * sd.BATCH:(k + 1) * sd.BATCH]
               for k in range(sd.N_BATCHES)]
    al = Aligner(idx, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    timers.enable(True)
    sams = []
    t0 = time.perf_counter()
    tb = t0
    with WidestCall("extend_batch_pl2", "launches") as pl2, \
            WidestCall("extend_batch_pl", "launches_pl") as pl:
        for k, (n, ss) in enumerate(align_stream(al, batches)):
            torch.cuda.synchronize()
            now = time.perf_counter()
            log(f"batch {k}: {n} reads in {now - tb:.3f} s")
            tb = now
            sams.extend(ss)
    wall = time.perf_counter() - t0
    timers.enable(False)
    snap = timers.snapshot()
    peak = torch.cuda.max_memory_allocated()
    fb = snap.get("front.fallback_rows.count", 0)
    log(f"main path: {len(sams)} reads in {wall:.3f} s = "
        f"{len(sams) / wall:.1f} reads/s on {torch.cuda.get_device_name(0)}")
    log("stage timers:\n" + timers.report())
    log(f"ext_pl2_kernel launches: {pl2.launches}; ext_pl_kernel launches: "
        f"{pl.launches}; fallback rows: {fb}; peak CUDA memory: "
        f"{peak / 2**20:.1f} MiB")
    if pl2.launches <= 0:
        raise RuntimeError("the main path never launched the CUDA kernel")
    if pl.launches != 0:
        raise RuntimeError(f"101 bp path: the one-pass kernel belongs to the "
                           f"long-read side path, got {pl.launches} launches")
    if fb != 0:
        raise RuntimeError(f"{fb} fallback rows")
    check_sams("main path", sams, reads)
    check_cpu("main path", cpu_al, reads, sams, CPU_CHECK_READS)
    return al, pl2, pl


def phase_long(al, cpu_al, read_len):
    """One long-read batch through align_batch_se on the card: every row
    goes to the host-compacted front.  Returns the two kernels' hooks."""
    import torch
    from bwamem_tpu_torch.io.fastq import read_fastx
    from bwamem_tpu_torch.utils import timers
    import se_smoke_data as sd
    label = f"{read_len} bp path"
    reads = list(read_fastx(sd.long_reads(read_len, log)))
    assert len(reads) == sd.LONG_SETS[read_len][0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    timers.enable(True)
    t0 = time.perf_counter()
    with WidestCall("extend_batch_pl2", "launches") as pl2, \
            WidestCall("extend_batch_pl", "launches_pl") as pl:
        sams = al.align_batch_se(reads)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timers.enable(False)
    snap = timers.snapshot()
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: {len(sams)} reads in {wall:.3f} s = "
        f"{len(sams) / wall:.2f} reads/s on {torch.cuda.get_device_name(0)}")
    log("stage timers:\n" + timers.report())
    log(f"{label}: ext_pl2_kernel launches {pl2.launches}, ext_pl_kernel "
        f"launches {pl.launches}, rows through the host-compacted front "
        f"{snap.get('front.fallback_rows.count', 0)}, plain-extension "
        f"dispatches of over-long lanes "
        f"{snap.get('dispatch.extend_long.count', 0)}, peak CUDA memory "
        f"{peak / 2**20:.1f} MiB")
    if snap.get("front.fallback_rows.count", 0) != len(reads):
        raise RuntimeError(f"{label}: not every row took the host front")
    check_sams(label, sams, reads)
    check_cpu(label, cpu_al, reads, sams, LONG_CPU_CHECK[read_len])
    if read_len in LONG_SUB_BATCH:
        check_sub_batch(label, al, reads, sams, LONG_SUB_BATCH[read_len])
    return pl2, pl


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
    err_pl2, err_pl = phase_kernel()
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.pipeline.align import Aligner
    import se_smoke_data as sd
    idx = load_index(sd.smoke_data(log)[0])
    cpu_al = Aligner(idx, device="cpu")
    al, main_pl2, main_pl = phase_main(idx, cpu_al)
    fused_pl2, none_pl = phase_long(al, cpu_al, 1000)
    if fused_pl2.launches <= 0 or none_pl.launches != 0:
        raise RuntimeError(
            f"1000 bp path: expected the fused path (ext_pl2_kernel) "
            f"only, got {fused_pl2.launches} and {none_pl.launches} "
            f"launches")
    side_pl2, side_pl = phase_long(al, cpu_al, 5000)
    if side_pl.launches <= 0:
        raise RuntimeError("5000 bp path: ext_pl_kernel was never launched")
    # the line reports each kernel on its main path's own widest call; the
    # other held calls (generated lanes with retries, empty queries and
    # z-drop cuts; the fused path's lanes) add their error
    kern2 = hold_kernel("main-path lanes, 101 bp", *main_pl2.args,
                        **main_pl2.kw)
    fused = hold_kernel("fused-path lanes, 1000 bp", *fused_pl2.args,
                        **fused_pl2.kw)
    kern2.pop("retried")
    kern2["launches"] = main_pl2.launches
    kern2["launches_by_path"] = {"101bp": main_pl2.launches,
                                 "1000bp": fused_pl2.launches,
                                 "5000bp": side_pl2.launches}
    kern2["max_abs_err"] = max(kern2["max_abs_err"], fused["max_abs_err"],
                               err_pl2)
    kern1 = hold_kernel_pl("main-path lanes, 5000 bp", *side_pl.args,
                           plain_reps=1, **side_pl.kw)
    kern1["launches"] = side_pl.launches
    kern1["launches_by_path"] = {"101bp": main_pl.launches,
                                 "1000bp": none_pl.launches,
                                 "5000bp": side_pl.launches}
    kern1["max_abs_err"] = max(kern1["max_abs_err"], err_pl)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kern2, kern1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
