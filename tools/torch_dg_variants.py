#!/usr/bin/env python3
"""Times the designs of kernels 5d (gp_take_ax0: 16 steps of kk = (kk +
tab[kk, j]) mod R on [78208, 128]) and 7A (gp3_dg: 512 steps of kk =
clip(kk + take_along_axis(tab, kk, axis), 0, hi - 1) on B8 [8, 128], B32
[32, 128] along axis 0 and C512 [128, 512] along axis 1) against each
other and against the designs they replaced (5d's still ships past the
column design's R), on one NVIDIA GPU, in one process.

    python3 tools/torch_dg_variants.py [--json PATH]

Every design takes a step as a fixed map of the element's state within its
line (5d: column j's T_j(k) = (k + tab[k, j]) mod R; 7A: the line's T(k) =
clip(k + line[k], 0, hi - 1)) or composes that map; the designs are the
kernels of tools/dg_variants.cu (its header lists them) and the shipped
ones, called through the wrappers of ops/gather_probe and ops/gather_probe3
("shipped": at the probe's shapes 5d's column design and 7A's warp design
for B8 and B32, the block design for C512).  Inputs from
ops/gather_probe.take_inputs and ops/gather_probe3.dg_inputs with SEEDS:
"probe", the TPU script's draw (5d: kk zero past its first 64 rows, so the
chains of a column share a state; 7A: a table from [0, 2^20), every chain
at hi - 1 after a step), and "spread" (5d: every row of kk its own start;
7A: a table from [-hi, hi], chains that keep moving), both timed; "wrap"
(adds that wrap in int32) checked only.

The library is tools/dg_variants.cu with copies of the shipped sources
beside it, written to build/dg_variants/ and built with the shipped nvcc
flags and -Xptxas -v.  Every design must equal the plain version
(ops/gather_probe.take_ax0_plain, ops/gather_probe3.dg_plain) on every
input kind at the timed shapes after 0, 1, a count that is no power of two
and the probe's steps, and the shipped wrappers also at other sizes: 5d at
R = 1, 33, 1000 and at 109376 and 109377 (the last R whose columns' maps
fit a block's shared memory, and the first that takes a thread an
element),
7A at every design csrc/line_pow.cuh takes by the gathered axis's size
hi, each at both axes: [5, 7] and [1, 3] along axis 0 and [7, 5] along
axis 1 (hi 5 and 1: the warp-segment design), [128, 3] along axis 0 and
[2, 128] along axis 1 (hi 128: a warp a line), [40, 3] along axis 0,
[3, 40], [128, 1000] and [4, 2000] along axis 1 (the block design, more
rows than threads at 2000) (exit 1 otherwise).  Then each
kernel and input runs its calls in turns, in order and then in reverse,
ROUNDS rounds, each timed on the device alone (behind a spin of the card longer
than its issue: `device_ms`) and between two events (`ms`), each number
the median of its rounds (tools/torch_ct_variants.in_turns).  Beside the
designs: 5d's map pass alone and the shipped call at 0 steps (its fixed
cost); 7A's chain at 0 steps.  Last, the latency of one step of a
dependent chain that does nothing else (chase: one warp, k = t[k], clock64
around the loop): in shared memory (7A's chain) and in device memory, a
16 KB table (L1) and a 40 MB one (a random cycle: L2 and device memory).
Prints the card's name and power limit, ptxas's registers and spills for
every kernel built (a design that spills is not shipped), the checks, one
line per call and input, fastest first, and the chase; --json writes
every number to PATH.  chip_smoke.py times only the shipped and the
replaced designs (compare with designs=("replaced",)).
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

TAKE_R, TAKE_LANES, TAKE_STEPS = 78208, 8192, 16
DG_STEPS = 512
DG_SHAPES = (("B8", 8, 128, 0), ("B32", 32, 128, 0), ("C512", 128, 512, 1))
SEEDS = {"probe": 0, "spread": 9, "wrap": 11}
ROUNDS = 6
# the designs' numbers in take_variant and dg_variant (tools/dg_variants.cu)
TAKE_DESIGNS = {"replaced": 0, "map_rows": 1, "magic_rows": 2,
                "map_cols": 3, "magic_cols": 4, "col_strided": 5,
                "double": 6}
TAKE_MAP_PASS = 7
TAKE_SCRATCH = {1: 1, 3: 1, 6: 2, 7: 1}     # design: scratch tables
DG_DESIGNS = {"replaced": 0, "chain": 1, "double_block": 2,
              "double_warp": 3}
TAKE_CHECK_STEPS = (0, 1, 5, TAKE_STEPS)
DG_CHECK_STEPS = (0, 1, 37, 511, DG_STEPS)
TAKE_CHECK_R = (1, 33, 1000, 109376, 109377)
DG_CHECK_SHAPES = ((5, 7, 0), (1, 3, 0), (7, 5, 1), (128, 3, 0),
                   (2, 128, 1), (40, 3, 0), (3, 40, 1), (128, 1000, 1),
                   (4, 2000, 1))
# chase: (label, words, steps, in shared memory)
CHASES = (("shared, 512 words", 512, 100_000, True),
          ("device memory, 16 KB", 4096, 100_000, False),
          ("device memory, 40 MB", 10_000_000, 20_000, False))
SOURCES = ("gather_probe_kernel.cu", "gather_probe3_kernel.cu", "col0.cuh",
           "line_pow.cuh", "smem.cuh")
EXTRAS = os.path.join(REPO, "tools", "dg_variants.cu")


def library():
    """ops.launch.Library of tools/dg_variants.cu, written with copies of
    the shipped sources to build/dg_variants/ and built there with -Xptxas
    -v; raises if the build fails."""
    import ctypes
    from bwamem_tpu_torch._build import BUILD_DIR
    from bwamem_tpu_torch.ops.launch import CSRC, Library
    d = os.path.join(BUILD_DIR, "dg_variants")
    os.makedirs(d, exist_ok=True)
    for src in (EXTRAS, *(os.path.join(CSRC, n) for n in SOURCES)):
        dst = os.path.join(d, os.path.basename(src))
        if not os.path.exists(dst) or open(dst).read() != open(src).read():
            shutil.copyfile(src, dst)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = Library("dg_variants.cu", {
        "take_variant": [vp] * 5 + [ci] * 3,
        "dg_variant": [vp] * 3 + [ci] * 5,
        "chase": [vp, ci, ci, ci, vp, vp]}, ["-Xptxas", "-v"])
    lib.src = os.path.join(d, "dg_variants.cu")
    lib.so_name = os.path.join("dg_variants", "libdg_variants.so")
    lib.load()
    return lib


def ptxas(lib) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    5d and 7A kernels in the library's -Xptxas -v log."""
    from torch_row_variants import ptxas as rows
    return {name: tuple(r) for name, *r in rows(lib)
            if "take" in name or "dg_" in name or "pow_" in name
            or "chase" in name}


def take_call(lib, design: int, tab, kk, steps=TAKE_STEPS):
    """One call of take_variant's design after the wrapper's checks
    (gather_probe._prep_take), scratch from kk.new_empty; returns out
    (for the map pass alone, the scratch table)."""
    from bwamem_tpu_torch.ops import gather_probe as gp
    out, args = gp._prep_take(tab, kk, steps)
    tables = [kk.new_empty(kk.shape)
              for _ in range(TAKE_SCRATCH.get(design, 0))]
    s = [t.data_ptr() for t in tables] + [0] * (2 - len(tables))
    lib.launch("take_variant", out.get_device(),
               (*args[:3], *s, *args[3:], design))
    return tables[0] if design == TAKE_MAP_PASS else out


def dg_call(lib, design: int, tab, kk, steps, axis):
    """One call of dg_variant's design after the wrapper's checks
    (gather_probe3._prep_dg)."""
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    out, args = gp3._prep_dg(tab, kk, steps, axis)
    lib.launch("dg_variant", out.get_device(), (*args, design))
    return out


def take_calls(lib, tab, kk, steps=TAKE_STEPS, designs=TAKE_DESIGNS):
    """{label: call} for 5d on one input: the shipped wrapper and the
    designs of `designs`."""
    from bwamem_tpu_torch.ops import gather_probe as gp
    out = {"shipped": lambda: gp.gp_take_ax0(tab, kk, steps)}
    for name in designs:
        out[name] = (lambda d=TAKE_DESIGNS[name]:
                     take_call(lib, d, tab, kk, steps))
    return out


def dg_calls(lib, tab, kk, axis, steps=DG_STEPS, designs=DG_DESIGNS):
    """{label: call} for 7A on one input (double_warp only at hi <= 32)."""
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    out = {"shipped": lambda: gp3.gp3_dg(tab, kk, steps, axis)}
    for name in designs:
        if name == "double_warp" and tab.shape[axis] > 32:
            continue
        out[name] = (lambda d=DG_DESIGNS[name]:
                     dg_call(lib, d, tab, kk, steps, axis))
    return out


def take_inputs(device) -> dict:
    """{kind: (tab, kk)} at the probe's R for the kinds of SEEDS."""
    from bwamem_tpu_torch.ops import gather_probe as gp
    return {kind: gp.take_inputs(kind, TAKE_R, TAKE_LANES, seed, device)
            for kind, seed in SEEDS.items()}


def dg_inputs(device) -> dict:
    """{(tag, kind): (tab, kk, axis)} at DG_SHAPES for the kinds of
    SEEDS."""
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    return {(tag, kind): (*gp3.dg_inputs(kind, S, L, axis, seed + i,
                                         device), axis)
            for i, (tag, S, L, axis) in enumerate(DG_SHAPES)
            for kind, seed in SEEDS.items()}


def check(lib, tx: dict, dx: dict, log=print,
          take_designs=TAKE_DESIGNS, dg_designs=DG_DESIGNS) -> dict:
    """Every call of take_calls and dg_calls (for `take_designs` and
    `dg_designs`) against the plain version on every input of tx and dx
    after each of TAKE_CHECK_STEPS and DG_CHECK_STEPS, and the shipped
    wrappers at TAKE_CHECK_R and DG_CHECK_SHAPES on every kind after the
    same steps; returns ({label: max_abs_err}, the number of calls held);
    raises on a difference."""
    import torch
    from bwamem_tpu_torch.ops import gather_probe as gp
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    errs = {}
    calls = 0

    def hold(label, got, want):
        nonlocal calls
        calls += 1
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        errs[label] = max(errs.get(label, 0), err)
        if err:
            raise RuntimeError(f"{label}: {int((got != want).sum())} "
                               f"outputs differ from the plain version")
    for kind, (tab, kk) in tx.items():
        for steps in TAKE_CHECK_STEPS:
            want = gp.take_ax0_plain(tab, kk, steps)
            for label, fn in take_calls(lib, tab, kk, steps,
                                        take_designs).items():
                hold(f"5d {label}", fn(), want)
    dev = next(iter(tx.values()))[0].device
    for R in TAKE_CHECK_R:
        for kind, seed in SEEDS.items():
            tab, kk = gp.take_inputs(kind, R, min(TAKE_LANES, R * 128),
                                     seed, dev)
            for steps in TAKE_CHECK_STEPS:
                hold(f"5d shipped R={R}", gp.gp_take_ax0(tab, kk, steps),
                     gp.take_ax0_plain(tab, kk, steps))
    for (tag, kind), (tab, kk, axis) in dx.items():
        for steps in DG_CHECK_STEPS:
            want = gp3.dg_plain(tab, kk, steps, axis)
            for label, fn in dg_calls(lib, tab, kk, axis, steps,
                                      dg_designs).items():
                hold(f"7A {tag} {label}", fn(), want)
    for i, (S, L, axis) in enumerate(DG_CHECK_SHAPES):
        for kind, seed in SEEDS.items():
            tab, kk = gp3.dg_inputs(kind, S, L, axis, seed + i, dev)
            for steps in DG_CHECK_STEPS:
                hold(f"7A shipped [{S},{L}] ax{axis}",
                     gp3.gp3_dg(tab, kk, steps, axis),
                     gp3.dg_plain(tab, kk, steps, axis))
    log(f"dg variants: {calls} calls of {len(errs)} designs and shapes "
        f"equal their plain version on the {', '.join(SEEDS)} inputs after "
        f"5d steps {TAKE_CHECK_STEPS}, 7A steps {DG_CHECK_STEPS}; the "
        f"shipped wrappers also at R {TAKE_CHECK_R} and [S, L, axis] "
        f"{DG_CHECK_SHAPES}")
    return errs, calls


def times(lib, tx: dict, dx: dict, log=print, kinds=("probe", "spread"),
          take_designs=TAKE_DESIGNS, dg_designs=DG_DESIGNS,
          extras=True) -> dict:
    """{"5d": {kind: {label: dict(device_ms, ms)}}, "7A <tag>": {...}}: each
    kernel's calls in turns on each of `kinds` (torch_ct_variants.in_turns,
    ROUNDS rounds); extras: also 5d's map pass alone and shipped call at
    0 steps, 7A's chain at 0 steps."""
    from bwamem_tpu_torch.ops import gather_probe as gp
    from torch_ct_variants import in_turns
    out = {"5d": {}}
    for kind in kinds:
        tab, kk = tx[kind]
        fns = take_calls(lib, tab, kk, TAKE_STEPS, take_designs)
        if extras:
            fns["map pass alone"] = lambda t=tab, k=kk: take_call(
                lib, TAKE_MAP_PASS, t, k)
            fns["shipped, 0 steps"] = lambda t=tab, k=kk: gp.gp_take_ax0(
                t, k, 0)
        out["5d"][kind] = in_turns(fns, ROUNDS)
    for tag, S, L, axis in DG_SHAPES:
        key = f"7A {tag}"
        out[key] = {}
        for kind in kinds:
            tab, kk, _ = dx[(tag, kind)]
            fns = dg_calls(lib, tab, kk, axis, DG_STEPS, dg_designs)
            if extras:
                fns["chain, 0 steps"] = lambda t=tab, k=kk, a=axis: dg_call(
                    lib, DG_DESIGNS["chain"], t, k, 0, a)
            out[key][kind] = in_turns(fns, ROUNDS)
    for key, by_kind in out.items():
        steps = TAKE_STEPS if key == "5d" else DG_STEPS
        for kind, t in by_kind.items():
            for label, r in sorted(t.items(),
                                   key=lambda kv: kv[1]["device_ms"]):
                per = r["device_ms"] / steps * 1e3
                log(f"{key:8s} {kind:6s} {label:18s} device "
                    f"{r['device_ms']:.5f} ms ({per:.4f} us a step), "
                    f"between events {r['ms']:.5f} ms (medians of {ROUNDS} "
                    f"rounds in turns)")
    return out


def chase(lib, device, log=print) -> dict:
    """{label: dict(cycles, ns)} a step of CHASES: clock64 cycles a step
    inside the kernel, and the kernel's time between events a step (the
    median of three, the table's copy in shared memory included)."""
    import numpy as np
    import torch
    from torch_pl_gather_probe2 import median_ms
    rng = np.random.default_rng(5)
    res = {}
    for label, n, steps, shared in CHASES:
        perm = rng.permutation(n)
        t = np.empty(n, np.int32)
        t[perm] = np.roll(perm, -1)           # one cycle through every word
        t = torch.from_numpy(t).to(device)
        cyc = torch.zeros(1, dtype=torch.int64, device=device)
        sink = torch.empty(32, dtype=torch.int32, device=device)

        def run(t=t, n=n, steps=steps, shared=shared, cyc=cyc, sink=sink):
            lib.launch("chase", device.index or 0,
                       (t.data_ptr(), n, steps, int(shared), cyc.data_ptr(),
                        sink.data_ptr()))
        ms = median_ms(run, 3)
        res[label] = dict(cycles=int(cyc.item()) / steps,
                          ns=ms * 1e6 / steps)
        log(f"chase {label:22s} {res[label]['cycles']:.1f} cycles a step "
            f"(clock64), {res[label]['ns']:.2f} ns a step (events)")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_dg_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    lib = library()
    regs = ptxas(lib)
    for kern, (r, ss, sl) in sorted(regs.items()):
        print(f"ptxas {kern:44s} {r:3d} registers, {ss} bytes spill "
              f"stores, {sl} loads", flush=True)
    dev = torch.device("cuda")
    tx, dx = take_inputs(dev), dg_inputs(dev)

    def log(m):
        print(m, flush=True)
    try:
        errs, _ = check(lib, tx, dx, log)
    except RuntimeError as e:
        print(f"torch_dg_variants: {e}", file=sys.stderr)
        return 1
    res = dict(card=card, ptxas=regs, max_abs_err=errs,
               times=times(lib, tx, dx, log), chase=chase(lib, dev, log))
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
