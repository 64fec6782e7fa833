#!/usr/bin/env python3
"""Times the designs of kernels 6B (gp2_take_ax0: 32 steps of kk = (kk +
tab[kk, j]) mod R on [512, 128]) and 6C (gp2_take_ax1: 32 steps of kk =
(kk + tab[i, kk]) mod 128 on [128, 128] and [8, 128]) against each other
and against the designs they replaced, on one NVIDIA GPU, in one process.

    python3 tools/torch_take2_variants.py [--json PATH]

Every design but the replaced ones takes a step as a fixed map of the
element's state within its line (6B: column j's T_j(k) = (k + tab[k, j])
mod R; 6C: row i's T_i(k) = (k + tab[i, k]) mod 128, the int32 wrap and
the sign of the remainder inside the map) or composes that map.  The
designs are the kernels of tools/take2_variants.cu (its header lists
them), the shipped ones called through the wrappers of ops/gather_probe2
("shipped": csrc/line_pow.cuh's kernels, which gp3_dg launches too:
at R = 512 a block a column, at 128 words a warp a row, each squaring
its map) and, for 6B, 5d's column design through
ops/gather_probe.gp_take_ax0 ("col_5d": the same function, three
launches).  Every 6B design is also timed at 0 steps (its fixed cost).

Every design must equal the plain version (ops/gather_probe2.
take_ax0_plain, take_ax1_plain) after each of CHECK_STEPS (no bit set;
one; low bits; five set bits; one high bit; both ends) on the probe's
input and on tables drawn from each of RANGES (the CPU tests': the
probe's [0, 2^20), [2^31 - 4096, 2^31) and all of int32, where the adds
wrap), 6B at each R of CHECK_R (the warp-segment design's sizes and its
edge, the block design's first, the warp-a-line design's one size, the
block design past it, the probe's, and 58112, the wrapper's limit: two
16-bit maps in 232448 bytes of shared memory) and 6C at each S of
CHECK_S, each design at the sizes it takes (exit 1 otherwise).  Then
each kernel's calls on the probe's input (tools/torch_pl_gather_probe2.
make_inputs) run in turns, in order and then in reverse, ROUNDS rounds,
each timed on the device alone (behind a spin of the card longer than
its issue: `device_ms`) and between two events (`ms`), each number the
median of its rounds, with the fastest and slowest round on the device
(`device_lo`, `device_hi`; tools/torch_ct_variants.in_turns).  Beside
the designs: the shipped call at 0 steps (the launch and the map).

The library is tools/take2_variants.cu with copies of the shipped sources
beside it, written to build/take2_variants/ and built with the shipped
nvcc flags and -Xptxas -v.  Prints the card's name and power limit,
ptxas's registers and spills for every kernel built (a design that spills
is not shipped), the checks and one line per call and input, fastest
first; --json writes every number to PATH.  chip_smoke.py builds this
library and holds and times only the shipped and the replaced designs
(designs=("replaced",)).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

STEPS = 32
SEED = 0                       # the probe script's own default
ROUNDS = 6
RANGES = ((0, 1 << 20), ((1 << 31) - 4096, 1 << 31), (-(1 << 31), 1 << 31))
CHECK_STEPS = (0, 1, 5, 31, 32, 33)
CHECK_R = (1, 5, 32, 33, 128, 129, 512, 58112)
CHECK_S = (1, 8, 128, 1000)
# the designs' numbers in take2_variant (tools/take2_variants.cu), by axis
DESIGNS = {"replaced": 0, "map_chain": 1, "slab": 2, "slab_pow": 3,
           "slab_cluster": 4, "block_pow": 5, "warp_chain": 6}
AXIS_DESIGNS = {0: ("replaced", "map_chain", "slab", "slab_pow",
                    "slab_cluster", "col_5d"),
                1: ("replaced", "map_chain", "block_pow", "warp_chain")}
SMEM_MAX = 232448
# line_pow.cuh's three kernels, each at both axes
SHIPPED_KERNELS = 6
# the timed inputs: (label, axis, tab key, kk key of make_inputs)
TIMED = (("6B [512,128]", 0, "b_tab", "b_kk"),
         ("6C [128,128]", 1, "c128_tab", "c128_kk"),
         ("6C [8,128]", 1, "c8_tab", "c8_kk"))
SOURCES = ("gather_probe2_kernel.cu", "line_pow.cuh", "col0.cuh",
           "smem.cuh")
EXTRAS = os.path.join(REPO, "tools", "take2_variants.cu")


def library():
    """ops.launch.Library of tools/take2_variants.cu, written with copies
    of the shipped sources to build/take2_variants/ and built there with
    -Xptxas -v; raises if the build fails."""
    import ctypes
    from bwamem_tpu_torch._build import BUILD_DIR
    from bwamem_tpu_torch.ops.launch import CSRC, Library
    d = os.path.join(BUILD_DIR, "take2_variants")
    os.makedirs(d, exist_ok=True)
    for src in (EXTRAS, *(os.path.join(CSRC, n) for n in SOURCES)):
        dst = os.path.join(d, os.path.basename(src))
        if not os.path.exists(dst) or open(dst).read() != open(src).read():
            shutil.copyfile(src, dst)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = Library("take2_variants.cu", {"take2_variant": [vp] * 3 + [ci] * 4},
                  ["-Xptxas", "-v"])
    lib.src = os.path.join(d, "take2_variants.cu")
    lib.so_name = os.path.join("take2_variants", "libtake2_variants.so")
    lib.load()
    return lib


def ptxas(lib) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} of every
    kernel in the library's -Xptxas -v log."""
    from torch_row_variants import ptxas as rows
    return {name: tuple(r) for name, *r in rows(lib)}


def shipped_ptxas(lib) -> dict:
    """ptxas's lines of the shipped chains: line_pow.cuh's three kernels
    at both axes with ModStep (SHIPPED_KERNELS of them)."""
    return {k: v for k, v in ptxas(lib).items()
            if "ModStep" in k and "pow_" in k}


def takes(design: str, n: int) -> bool:
    """Whether a design takes a table of n rows (6B) or n rows of 128
    words (6C): the slab designs hold the slab's maps (or two buffers of
    them) 16-bit in one block's shared memory."""
    if design in ("slab", "slab_cluster"):
        return n * 16 <= SMEM_MAX
    if design == "slab_pow":
        return n * 32 <= SMEM_MAX
    return True


def variant_call(lib, design: str, tab, kk, steps: int, axis: int):
    """One call of take2_variant's design after the wrapper's checks
    (gather_probe2._prep_take0 / _prep_take1)."""
    from bwamem_tpu_torch.ops import gather_probe2 as gp2
    prep = gp2._prep_take0 if axis == 0 else gp2._prep_take1
    out, args = prep(tab, kk, steps)
    lib.launch("take2_variant", out.get_device(),
               (*args, axis, DESIGNS[design]), f"take2 {design}")
    return out


def calls(lib, tab, kk, steps: int, axis: int, designs=None) -> dict:
    """{label: call} on one input: the shipped wrapper and each design of
    `designs` (default: all of the axis's) that takes its size."""
    from bwamem_tpu_torch.ops import gather_probe as gp
    from bwamem_tpu_torch.ops import gather_probe2 as gp2
    shipped = gp2.gp2_take_ax0 if axis == 0 else gp2.gp2_take_ax1
    out = {"shipped": lambda: shipped(tab, kk, steps)}
    for name in designs if designs is not None else AXIS_DESIGNS[axis]:
        if name not in AXIS_DESIGNS[axis] or not takes(name, tab.shape[0]):
            continue
        if name == "col_5d":
            out[name] = lambda: gp.gp_take_ax0(tab, kk, steps)
        else:
            out[name] = (lambda d=name: variant_call(lib, d, tab, kk, steps,
                                                     axis))
    return out


def range_inputs(n: int, axis: int, lo: int, hi: int, seed: int, device):
    """(tab, kk) int32 [n, 128]: tab from [lo, hi), kk in [0, hi of the
    chain's modulus) (n at axis 0, 128 at axis 1)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    tab = rng.integers(lo, hi, (n, 128), dtype=np.int64).astype(np.int32)
    kk = rng.integers(0, n if axis == 0 else 128, (n, 128), dtype=np.int32)
    return (torch.from_numpy(tab).to(device),
            torch.from_numpy(kk).to(device))


def check(lib, x: dict, log=print, designs=None) -> tuple:
    """Every call of `calls` against the plain version after each of
    CHECK_STEPS on the probe's inputs x (make_inputs) and on RANGES' tables
    at CHECK_R (6B) and CHECK_S (6C); returns ({label: max_abs_err}, the
    number of calls held); raises on a difference."""
    import torch
    from bwamem_tpu_torch.ops import gather_probe2 as gp2
    errs = {}
    n_calls = 0
    dev = x["b_tab"].device

    def hold(label, tab, kk, axis):
        nonlocal n_calls
        plain = gp2.take_ax0_plain if axis == 0 else gp2.take_ax1_plain
        for steps in CHECK_STEPS:
            want = plain(tab, kk, steps).to(torch.int64)
            for name, fn in calls(lib, tab, kk, steps, axis,
                                  designs).items():
                got = fn().to(torch.int64)
                torch.cuda.synchronize()
                n_calls += 1
                err = int((got - want).abs().max())
                key = f"{label} {name}"
                errs[key] = max(errs.get(key, 0), err)
                if err:
                    raise RuntimeError(
                        f"{key}, {steps} steps, table {tuple(tab.shape)}: "
                        f"{int((got != want).sum())} outputs differ from "
                        "the plain version")
    for label, axis, t, k in TIMED:
        hold(label, x[t], x[k], axis)
    for axis, sizes in ((0, CHECK_R), (1, CHECK_S)):
        for n in sizes:
            for i, (lo, hi) in enumerate(RANGES):
                tab, kk = range_inputs(n, axis, lo, hi, 11 + i, dev)
                hold(f"6{'BC'[axis]}", tab, kk, axis)
    log(f"take2 variants: {n_calls} calls of {len(errs)} designs and inputs "
        f"equal their plain version after steps {CHECK_STEPS} on the "
        f"probe's inputs and tables from {len(RANGES)} ranges (adds that "
        f"wrap) at R {CHECK_R} (6B) and S {CHECK_S} (6C)")
    return errs, n_calls


def times(lib, x: dict, log=print, designs=None, extras=True) -> dict:
    """{label: {call: dict(device_ms, ms, device_lo, device_hi)}}: each
    kernel's calls in turns on the probe's inputs x
    (torch_ct_variants.in_turns, ROUNDS rounds); extras: also the shipped
    call at 0 steps, and for 6B every design at 0 steps (its fixed cost,
    "<label> 0 steps")."""
    from bwamem_tpu_torch.ops import gather_probe2 as gp2
    from torch_ct_variants import in_turns
    runs = []
    for label, axis, t, k in TIMED:
        tab, kk = x[t], x[k]
        fns = calls(lib, tab, kk, STEPS, axis, designs)
        if extras:
            shipped = gp2.gp2_take_ax0 if axis == 0 else gp2.gp2_take_ax1
            fns["shipped, 0 steps"] = lambda f=shipped, a=tab, b=kk: f(a, b, 0)
        runs.append((label, fns))
        if extras and axis == 0:
            runs.append((f"{label} 0 steps", calls(lib, tab, kk, 0, axis,
                                                   designs)))
    out = {}
    for label, fns in runs:
        out[label] = in_turns(fns, ROUNDS)
        for name, r in sorted(out[label].items(),
                              key=lambda kv: kv[1]["device_ms"]):
            log(f"{label:22s} {name:17s} device {r['device_ms']:.5f} ms "
                f"(rounds {r['device_lo']:.5f}-{r['device_hi']:.5f}), "
                f"between events {r['ms']:.5f} ms (medians of {ROUNDS} "
                f"rounds in turns)")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_take2_variants: no CUDA device", file=sys.stderr)
        return 2
    from torch_pl_gather_probe2 import make_inputs
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    lib = library()
    regs = ptxas(lib)
    for kern, (r, ss, sl) in sorted(regs.items()):
        print(f"ptxas {kern:56s} {r:3d} registers, {ss} bytes spill "
              f"stores, {sl} loads", flush=True)
    x = make_inputs(SEED, torch.device("cuda"))

    def log(m):
        print(m, flush=True)
    try:
        errs, _ = check(lib, x, log)
    except RuntimeError as e:
        print(f"torch_take2_variants: {e}", file=sys.stderr)
        return 1
    res = dict(card=card, ptxas=regs, max_abs_err=errs,
               times=times(lib, x, log))
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
