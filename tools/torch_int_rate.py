#!/usr/bin/env python3
"""The card's int32 rate outside the tensor cores, measured.

    python3 tools/torch_int_rate.py

Runs the five mixes of bwamem_tpu_torch/csrc/int_rate_kernel.cu
(ops/int_rate: alu = IADD3 and IMNMX on chain pairs, cell = dp_eh's cell
written plainly, cell_dpx = the same with __viaddmax_s32, s16x2 =
__viaddmax_s16x2_relu, two 16-bit cells an instruction, dpx32 =
__viaddmax_s32 alone on three registers) on a grid that
fills every SM (8 blocks of 256 threads an SM, 8 independent chains a
thread), each first held against its plain version on a small grid, then
timed with CUDA events (the median of REPS launches of ITERS iterations).
Prints, for each mix, int32 operations a second (its function's
operations: a DPX instruction counts its add and its max), then ptxas's
registers a kernel (nvcc -Xptxas -v) and the SASS mnemonics of each
kernel's loop from `cuobjdump -sass` where the toolkit has it, so that one
sees which instructions, and so which pipe, each mix ran on.
chip_smoke.PEAK_INT32_OPS is the highest of the 32-bit mixes (alu, cell,
cell_dpx, dpx32) rounded up; a kernel that packs two cells in 16 bits
takes its bound from s16x2's.  A kernel's SASS holds its loop unrolled
and its remainder, so counts are per listing, not per step.  The card's
name and power limit are printed first.  Needs a CUDA device and a
checkout of the repository; exits non-zero without either.
"""
from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
BLOCKS_PER_SM = 8       # 8 x 256 threads: the SM's 2048
ITERS = 2048            # iterations a launch (16 steps of 8 chains each)
REPS = 5
CHECK_BLOCKS, CHECK_ITERS = 2, 3
# the 32-bit mixes, the highest of whose rates is PEAK_INT32_OPS
MIXES_32 = ("alu", "cell", "cell_dpx", "dpx32")


def sass_counts(so_path: str) -> dict:
    """{kernel: Counter of SASS mnemonics} of a built library, from
    cuobjdump -sass; {} when the toolkit has no cuobjdump."""
    from bwamem_tpu_torch.ops.launch import nvcc
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    r = subprocess.run([tool, "-sass", so_path], capture_output=True,
                       text=True, timeout=120)
    out, name = {}, None
    for line in r.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and name:
            out[name][m.group(1).split(".")[0]] += 1
    return out


def measure(log=print) -> dict:
    """Times each mix on the current CUDA device; returns {mix: dict(ms,
    ops, rate)} and "sass" ({kernel: {mnemonic: count}}); raises when a
    mix's kernel differs from its plain version."""
    import torch
    from bwamem_tpu_torch.ops import int_rate
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from torch_pl_gather_probe2 import median_ms
    dev = torch.device("cuda")
    for mix in int_rate.MIXES:
        got = int_rate.run(mix, CHECK_BLOCKS, CHECK_ITERS, seed=5)
        want = int_rate.plain(mix, CHECK_BLOCKS * int_rate.THREADS,
                              CHECK_ITERS, seed=5, device=dev)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"int_rate {mix}: the kernel differs from its "
                               f"plain version on "
                               f"{int((got != want).sum())} threads")
    log(f"int_rate: every mix equals its plain version "
        f"({CHECK_BLOCKS} blocks, {CHECK_ITERS} iterations)")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    res = {}
    for mix in int_rate.MIXES:
        ms = median_ms(lambda mix=mix: int_rate.run(mix, blocks, ITERS),
                       REPS)
        ops = int_rate.ops_per_thread(mix, ITERS) * blocks * int_rate.THREADS
        res[mix] = dict(ms=ms, ops=ops, rate=ops / ms * 1e3)
        log(f"int_rate {mix:9s} {blocks} blocks x {int_rate.THREADS} "
            f"threads, {ITERS} iterations: {ms:.4f} ms, {ops:.4g} "
            f"operations, {ops / ms * 1e3 / 1e12:.3f} T int32 operations/s")
    top = max(MIXES_32, key=lambda m: res[m]["rate"])
    log(f"int_rate: highest 32-bit rate {res[top]['rate'] / 1e12:.3f} T/s "
        f"({top}); 16x2 {res['s16x2']['rate'] / 1e12:.3f} T/s")
    from bwamem_tpu_torch._build import BUILD_DIR
    so = os.path.join(BUILD_DIR, int_rate.LIB.so_name)
    for line in open(so + ".log"):
        if "Used" in line or "Compiling entry" in line:
            log("ptxas " + line.strip())
    sass = sass_counts(so)
    for name, counts in sass.items():
        log(f"sass {name}: " + ", ".join(f"{k} {v}" for k, v in
                                          counts.most_common(12)))
    if not sass:
        log("sass: no cuobjdump in this toolkit")
    res["sass"] = {k: dict(v) for k, v in sass.items()}
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_int_rate: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "bwamem_tpu_torch")):
        print("torch_int_rate: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    measure(lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
