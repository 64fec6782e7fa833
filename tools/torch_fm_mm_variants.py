#!/usr/bin/env python3
"""Times the designs of kernels #3 (fm_chain_words, fm_chain_rows: 64
steps of k = (k + the wrapping sum of row cmb[k >> 7]) mod seq_len on 8192
lanes of chip_smoke.py's 5 Mbp index) and 7D (gp3_mm: 64 ordered float32
additions of (a @ b)[:8], a [1024, 640], b [640, 128]) against each other
and against the designs they replaced, on one NVIDIA GPU, in one process.

    python3 tools/torch_fm_mm_variants.py [--json PATH]

The designs are the kernels of tools/fm_mm_variants.cu (its header lists
them) and the shipped ones, called through the wrappers of ops/fm_probe
and ops/gather_probe3 ("shipped_words", "shipped_rows", "shipped").  #3's
inputs: the index's table at its seq_len and at the largest seq_len the
wrapper takes for it (rows x 128), and a random table of BIG_ROWS rows at
its largest seq_len (past what the cluster designs of 4 and 8 blocks
hold); lanes from numpy with se_smoke_data.SEED.  7D's:
tools/torch_pl_gather_probe3.make_inputs (normal and integer-valued a, b).

Every design must equal the plain version (ops/fm_probe.chain_gather) at
0, 1, 37 and 64 steps on every #3 input it can take, and the count of
steps whose k + S wraps is printed; every 7D design must equal
ops/gather_probe3.mm_plain exactly on the integer inputs, lie within
mm_tolerance on the normal ones, and give the same bits twice; the shipped
gp3_mm also at other shapes (exit 1 otherwise).  Then each kernel's calls
run in turns, in order and then in reverse, ROUNDS rounds, each timed on
the device alone (behind a spin of the card: `device_ms`) and between two
events (`ms`), each number the median of its rounds
(tools/torch_ct_variants.in_turns), 7D beside its library call, #3 beside
the row-sum pass alone and the shipped call at 0 steps (its fixed cost).
Then one serial step of each #3 design that reads a whole row (the
replaced ones, the full-row ones) and of the shipped one, the step table
and a cluster design: one block of 128 lanes over
SERIAL_STEPS steps, time / steps.  Last, the latency of one dependent load
(chase: one warp, clock64 around the loop) from shared memory, from the
313 KB step table in device memory, of a whole 48-byte row of the 3.75
MB table (in one 128-byte line, and across two), and from a cluster
peer's shared memory.  Prints the card's name and power limit, ptxas's
registers and spills for every kernel (a design that spills is not
shipped), the checks, one line per call, fastest first, the serial steps
and the chase; --json writes every number to PATH.  chip_smoke.py
times only the shipped and the replaced designs.
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

FM_LANES, FM_STEPS = 8192, 64
FM_CHECK_STEPS = (0, 1, 37, FM_STEPS)
SERIAL_STEPS = 4096
ROUNDS = 6
PART_MAX = 32768            # entries of a cluster block's part (2^15)
BIG_ROWS = 262145           # rows of the random table (seq_len 33554560)
# fm_variant's designs (tools/fm_mm_variants.cu); the clusters' (CS, P)
# come from the library
FM_FIXED = {"replaced_words": 0, "replaced_rows": 1, "l2_table": 2,
            "l2_x1": 3, "l2_x2": 4}
FM_CLUSTER0 = 5
FM_REPLACED = ("replaced_words", "replaced_rows")
MM_DESIGNS = {"replaced": 0, "cluster8": 1, "pull16": 2,
              "cluster8x2": 3, "block4": 4, "blocks16": 5, "blocks40": 6}
MM_SCRATCH_CHUNKS = 40
MM_SHAPES = ((1, 1, 1), (8, 5, 7), (13, 640, 300), (8, 2000, 128))
# chase: (label, mode, words or rows, steps)
CHASES = (("shared, 156 KB", 0, 39104, 100_000),
          ("device, 313 KB step table", 1, 78208, 20_000),
          ("device, 48-byte row in one line", 2, 78208, 20_000),
          ("device, 48-byte row across two lines", 2, 78208, 20_000),
          ("cluster peer's shared, 156 KB", 3, 39104, 50_000),
          ("own shared by ld.shared::cluster", 4, 39104, 50_000))
SOURCES = ("fm_probe_kernel.cu", "gather_probe3_kernel.cu", "col0.cuh",
           "line_pow.cuh", "smem.cuh")
EXTRAS = os.path.join(REPO, "tools", "fm_mm_variants.cu")


def library():
    """ops.launch.Library of tools/fm_mm_variants.cu, written with copies
    of the shipped sources to build/fm_mm_variants/ and built there with
    -Xptxas -v; raises if the build fails."""
    import ctypes
    from bwamem_tpu_torch._build import BUILD_DIR
    from bwamem_tpu_torch.ops.launch import CSRC, Library
    d = os.path.join(BUILD_DIR, "fm_mm_variants")
    os.makedirs(d, exist_ok=True)
    for src in (EXTRAS, *(os.path.join(CSRC, n) for n in SOURCES)):
        dst = os.path.join(d, os.path.basename(src))
        if not os.path.exists(dst) or open(dst).read() != open(src).read():
            shutil.copyfile(src, dst)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = Library("fm_mm_variants.cu", {
        "fm_variant": [vp] * 4 + [ci] * 5,
        "fm_chase": [vp, ci, ci, ci, vp, vp],
        "mm_variant": [vp] * 4 + [ci] * 5}, ["-Xptxas", "-v"])
    lib.src = os.path.join(d, "fm_mm_variants.cu")
    lib.so_name = os.path.join("fm_mm_variants", "libfm_mm_variants.so")
    lib.load()
    return lib


def ptxas(lib) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} of the
    library's -Xptxas -v log, for the #3 and 7D kernels."""
    from torch_row_variants import ptxas as rows
    return {name: tuple(r) for name, *r in rows(lib)
            if "fm_" in name or "mm_" in name or "chain" in name
            or "row" in name or "sums" in name}


def fm_designs(lib) -> dict:
    """{name: fm_variant design}, with each cluster design's capacity in
    rows: {name: (design, rows it holds or None)}."""
    out = {n: (d, None) for n, d in FM_FIXED.items()}
    i = 0
    while (v := lib.value("fm_cluster_design", i)) >= 0:
        cs, p = divmod(v, 1000)
        out[f"cluster{cs}_p{p}"] = (FM_CLUSTER0 + i, cs * PART_MAX)
        i += 1
    full = FM_CLUSTER0 + i
    out["full_ldg"] = (full, None)
    out["full_cg"] = (full + 1, None)
    out["sums pass alone"] = (full + 2, None)
    return out


def fm_call(lib, design: int, cmb32, k0, steps, seq_len):
    """One call of fm_variant's design after the wrapper's checks
    (fm_probe._prep: the step table from new_empty)."""
    from bwamem_tpu_torch.ops import fm_probe
    out, args = fm_probe._prep("fm_variant", cmb32, k0, steps, seq_len)
    lib.launch("fm_variant", cmb32.get_device(), (*args, design))
    return out


def fm_inputs(device, log=print) -> dict:
    """{label: (cmb32, k0, seq_len)}: "index" (the smoke index's table at
    its seq_len, FM_LANES lanes from se_smoke_data.SEED), "index max" (the
    same at rows x 128), "random" (a random table of BIG_ROWS rows at its
    largest seq_len)."""
    import numpy as np
    import torch
    import se_smoke_data as sd
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops import fm as fmops
    from bwamem_tpu_torch.ops import fm_probe
    fm = fmops.fm_from_index(load_index(sd.smoke_data(log)[0]), device)
    cmb32 = fm_probe.words32(fm.cmb)
    rng = np.random.default_rng(sd.SEED)

    def lanes(seq_len):
        return torch.from_numpy(rng.integers(0, seq_len, FM_LANES).astype(
            np.int32)).to(device)
    x = {"index": (cmb32, lanes(fm.seq_len), fm.seq_len)}
    top = cmb32.shape[0] * 128
    x["index max"] = (cmb32, lanes(top), top)
    big = torch.from_numpy(rng.integers(
        -2**31, 2**31, (BIG_ROWS, cmb32.shape[1]), dtype=np.int64).astype(
            np.int32))
    x["random"] = (big.to(device), lanes(BIG_ROWS * 128), BIG_ROWS * 128)
    return x


def wraps(cmb32, k0, steps, seq_len) -> int:
    """Steps of the chain (over every lane) where k + S leaves the int32
    range, S the row's wrapping sum (int64 on the tensors' device)."""
    import torch
    S = cmb32.to(torch.int64).sum(1)
    S = (S + 2**31) % 2**32 - 2**31
    k = k0.to(torch.int64)
    n = 0
    for _ in range(steps):
        v = k + S[k >> 7]
        n += int((v >= 2**31).sum())
        k = ((v + 2**31) % 2**32 - 2**31) % seq_len
    return n


def fm_calls(lib, designs, cmb32, k0, steps, seq_len, names) -> dict:
    """{label: call} for #3 on one input: both shipped wrappers and the
    designs of `names` that can take the table."""
    from bwamem_tpu_torch.ops import fm_probe
    out = {"shipped_words": lambda: fm_probe.chain_words(cmb32, k0, steps,
                                                         seq_len),
           "shipped_rows": lambda: fm_probe.chain_rows(cmb32, k0, steps,
                                                       seq_len)}
    nb = (seq_len + 127) // 128
    for name in names:
        d, cap = designs[name]
        if cap is not None and nb > cap:
            continue
        out[name] = (lambda d=d: fm_call(lib, d, cmb32, k0, steps, seq_len))
    return out


def check_fm(lib, x: dict, log=print, names=None) -> dict:
    """Every #3 call against chain_gather on every input of x after each
    of FM_CHECK_STEPS (designs: `names`, default all but the sums pass);
    returns {label: max_abs_err}; raises on a difference."""
    import torch
    from bwamem_tpu_torch.ops import fm_probe
    designs = fm_designs(lib)
    if names is None:
        names = [n for n in designs if n != "sums pass alone"]
    errs = {}
    for inp, (cmb32, k0, seq_len) in x.items():
        for steps in FM_CHECK_STEPS:
            want = fm_probe.chain_gather(cmb32, k0, steps, seq_len)
            for label, fn in fm_calls(lib, designs, cmb32, k0, steps,
                                      seq_len, names).items():
                got = fn()
                torch.cuda.synchronize()
                err = int((got.to(torch.int64) - want.to(torch.int64))
                          .abs().max())
                key = f"{label} {inp}"
                errs[key] = max(errs.get(key, 0), err)
                if err:
                    raise RuntimeError(f"#3 {label} on {inp} at {steps} "
                                       f"steps: {int((got != want).sum())} "
                                       f"lanes differ from chain_gather")
        log(f"#3 {inp}: table {tuple(cmb32.shape)}, seq_len {seq_len}, "
            f"{k0.shape[0]} lanes: every call equals chain_gather after "
            f"steps {FM_CHECK_STEPS}; {wraps(cmb32, k0, FM_STEPS, seq_len)} "
            f"steps of {k0.shape[0] * FM_STEPS} wrap k + S")
    return errs


def mm_inputs(device) -> dict:
    """{"normal": (a, b), "integer": (a, b)}: the probe's inputs."""
    import se_smoke_data as sd
    from torch_pl_gather_probe3 import make_inputs
    x = make_inputs(sd.SEED, device)
    return {"normal": (x["e_a"], x["e_b"]),
            "integer": (x["e_a_int"], x["e_b_int"])}


def mm_call(lib, design: int, a, b):
    """One call of mm_variant's design after the wrapper's checks."""
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    out, args = gp3._prep_mm(a, b, gp3.MM_REPS, gp3.MM_ROWS)
    R, N = out.shape
    tiles = -(-R // 8) * -(-N // 128)
    scratch = a.new_empty(tiles * MM_SCRATCH_CHUNKS * 8 * 128)
    lib.launch("mm_variant", out.get_device(),
               (*args[:3], scratch.data_ptr(), *args[3:], design))
    return out


def mm_calls(lib, a, b, names=MM_DESIGNS) -> dict:
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    out = {"shipped": lambda: gp3.gp3_mm(a, b)}
    for name in names:
        out[name] = lambda d=MM_DESIGNS[name]: mm_call(lib, d, a, b)
    return out


def check_mm(lib, x: dict, log=print, names=MM_DESIGNS) -> dict:
    """Every 7D call on both inputs of x: exact against mm_plain on the
    integer ones, within mm_tolerance on the normal ones, the same bits
    twice; the shipped call also at MM_SHAPES on both kinds.  Returns
    {label: max_abs_err}; raises on a failure."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    errs = {}

    def hold(label, kind, a, b, fn, reps=gp3.MM_REPS, rows=gp3.MM_ROWS):
        want = gp3.mm_plain(a, b, reps, rows).double()
        got, again = fn(), fn()
        torch.cuda.synchronize()
        err = float((got.double() - want).abs().max())
        exact = gp3.mm_exact(a, b, reps, rows)
        tol = 0.0 if exact else gp3.mm_tolerance(a, b, reps, rows)
        errs[f"{label} {kind}"] = err
        if err > tol or not torch.equal(got, again):
            raise RuntimeError(f"7D {label} on {kind}: max_abs_err {err} "
                               f"(tolerance {tol}), repeat equal "
                               f"{torch.equal(got, again)}")
    for kind, (a, b) in x.items():
        for label, fn in mm_calls(lib, a, b, names).items():
            hold(label, kind, a, b, fn)
    dev = next(iter(x.values()))[0].device
    rng = np.random.default_rng(3)
    for M, K, N in MM_SHAPES:
        for kind in ("normal", "integer"):
            shape = ((max(M, 8), K), (K, N))
            a, b = (torch.from_numpy(
                (rng.standard_normal(s) if kind == "normal" else
                 rng.integers(-8, 9, s)).astype(np.float32)).to(dev)
                for s in shape)
            rows = M
            hold(f"shipped [{M},{K},{N}]", kind, a, b,
                 lambda a=a, b=b, rows=rows: gp3.gp3_mm(a, b, gp3.MM_REPS,
                                                        rows),
                 rows=rows)
    log(f"7D: every call within its tolerance of mm_plain (exact on the "
        f"integer inputs) and the same bits twice; the shipped call also at "
        f"[M, K, N] {MM_SHAPES}: {errs}")
    return errs


def times_fm(lib, x: dict, log=print, names=None) -> dict:
    """{label: dict(device_ms, ms)}: #3's calls in turns on the index
    input (torch_ct_variants.in_turns, ROUNDS rounds)."""
    from torch_ct_variants import in_turns
    designs = fm_designs(lib)
    cmb32, k0, seq_len = x["index"]
    fns = fm_calls(lib, designs, cmb32, k0, FM_STEPS, seq_len,
                   designs if names is None else names)
    if names is None:              # the shipped call's fixed cost
        fns["shipped_rows, 0 steps"] = fm_calls(
            lib, designs, cmb32, k0, 0, seq_len, ())["shipped_rows"]
    t = in_turns(fns, ROUNDS)
    for label, r in sorted(t.items(), key=lambda kv: kv[1]["device_ms"]):
        log(f"#3 {label:22s} device {r['device_ms']:.5f} ms "
            f"({r['device_ms'] / FM_STEPS * 1e6:.1f} ns a step), between "
            f"events {r['ms']:.5f} ms (medians of {ROUNDS} rounds in turns)")
    return t


def serial_steps(lib, x: dict, log=print, names=None) -> dict:
    """{label: ns}: one block of 128 lanes over SERIAL_STEPS steps on the
    index input, time between events / steps (the median of five): one
    step of a lane with nothing to overlap it."""
    from torch_pl_gather_probe2 import median_ms
    designs = fm_designs(lib)
    if names is None:
        names = ("replaced_words", "replaced_rows", "full_ldg", "full_cg")
    cmb32, k0, seq_len = x["index"]
    fns = fm_calls(lib, designs, cmb32, k0[:128], SERIAL_STEPS, seq_len,
                   names)
    fns.pop("shipped_words")
    out = {}
    for label, fn in fns.items():
        out[label] = median_ms(fn) / SERIAL_STEPS * 1e6
        log(f"#3 {label:22s} one serial step {out[label]:.1f} ns (one block "
            f"of 128 lanes, {SERIAL_STEPS} steps)")
    return out


def times_mm(lib, x: dict, log=print, names=MM_DESIGNS) -> dict:
    """{kind: {label: dict(device_ms, ms)}}: 7D's calls and the library
    call (torch_pl_gather_probe3.torch_mm) in turns on both inputs."""
    from torch_ct_variants import in_turns
    from torch_pl_gather_probe3 import torch_mm
    out = {}
    for kind, (a, b) in x.items():
        fns = mm_calls(lib, a, b, names)
        fns["library"] = lambda a=a, b=b: torch_mm(a, b)
        out[kind] = t = in_turns(fns, ROUNDS)
        for label, r in sorted(t.items(), key=lambda kv: kv[1]["device_ms"]):
            log(f"7D {kind:8s} {label:12s} device {r['device_ms']:.5f} ms, "
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
    for label, mode, n, steps in CHASES:
        if mode == 2:            # rows of 12 words, a cycle through a class
            straddle = "two" in label
            rows = np.arange(n)
            rows = rows[np.isin(rows % 8, (2, 5)) == straddle]
            perm = rng.permutation(rows)
            t = np.zeros((n, 12), np.int32)
            t[perm, 0] = np.roll(perm, -1)
        else:
            perm = rng.permutation(n)
            t = np.empty(n, np.int32)
            t[perm] = np.roll(perm, -1)        # one cycle through every word
        t = torch.from_numpy(t.reshape(-1)).to(device)
        cyc = torch.zeros(1, dtype=torch.int64, device=device)
        sink = torch.empty(32, dtype=torch.int32, device=device)

        def run(t=t, n=n, steps=steps, mode=mode, cyc=cyc, sink=sink):
            lib.launch("fm_chase", device.index or 0,
                       (t.data_ptr(), n, steps, mode, cyc.data_ptr(),
                        sink.data_ptr()))
        ms = median_ms(run, 3)
        res[label] = dict(cycles=int(cyc.item()) / steps,
                          ns=ms * 1e6 / steps)
        log(f"chase {label:38s} {res[label]['cycles']:.1f} cycles a step "
            f"(clock64), {res[label]['ns']:.2f} ns a step (events)")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_fm_mm_variants: no CUDA device", file=sys.stderr)
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
        print(f"ptxas {kern:60s} {r:3d} registers, {ss} bytes spill "
              f"stores, {sl} loads", flush=True)
    dev = torch.device("cuda")

    def log(m):
        print(m, flush=True)
    fx, mx = fm_inputs(dev, log), mm_inputs(dev)
    try:
        errs = check_fm(lib, fx, log)
        errs.update(check_mm(lib, mx, log))
    except RuntimeError as e:
        print(f"torch_fm_mm_variants: {e}", file=sys.stderr)
        return 1
    res = dict(card=card, ptxas=regs, max_abs_err=errs,
               fm_times=times_fm(lib, fx, log),
               fm_serial_ns=serial_steps(
                   lib, fx, log, (*FM_REPLACED, "full_ldg", "full_cg",
                                  "l2_table", "cluster4_p64")),
               mm_times=times_mm(lib, mx, log), chase=chase(lib, dev, log))
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
