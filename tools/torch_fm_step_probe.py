#!/usr/bin/env python3
"""What a step of the seeding scans costs on a GPU, issued from PyTorch and
in one call of hand-written kernels.

    python3 tools/torch_fm_step_probe.py [n_lanes] [steps]

On chip_smoke.py's 5 Mbp index (tools/se_smoke_data.py, cached under
build/chip_smoke/), with n_lanes lanes (8192) and `steps` chained steps
(64), it times:

1. the chained ops/fm.extend step as PyTorch issues it: the body of the
   SMEM scans of ops/smem (two occ4 row gathers, popcounts and selects per
   step, a few dozen launches);
2. the chained bare gather of one combined index row per lane per step, and
   of two rows, in PyTorch: the gather without the popcount work;
3. the same chained one-row gather in one call of the hand-written CUDA
   kernels (ops/fm_probe: a pass takes every row's sum, fm_chain_words
   reading the row word by word and fm_chain_rows with 16-byte vector
   loads, then one kernel runs every lane's chain through the sums).

Both kernel outputs are checked against the plain chain_gather for exact
equality before anything is timed; a difference exits non-zero.  Times are
the best of 5 runs between CUDA events, printed in ms and in us per step
with the card's name and power limit.  The gap between (1) and (3) is what
a seeding kernel (or a captured graph) could save per scan step.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5


def best_ms(fn, reps: int = REPS) -> float:
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
    return min(times)


def chain_extend(fm, k0, steps: int):
    """`steps` chained bidirectional extensions of every lane's interval,
    each step choosing a symbol from the lane's own state: the body of the
    SMEM scans, one dependent ops/fm.extend per step."""
    import torch
    from bwamem_tpu_torch.ops import fm as fmops
    x0 = k0.to(fm.itype)
    x1 = x0
    x2 = torch.full_like(x0, 7)
    for i in range(steps):
        n0, n1, ns = fmops.extend(fm, x0, x1, x2, is_back=False)
        c = (x0 + i) & 3
        # keep the values in range
        x0 = torch.remainder(fmops._select4(n0, c), fm.seq_len)
        x1 = torch.remainder(fmops._select4(n1, c), fm.seq_len)
        x2 = torch.remainder(fmops._select4(ns, c), 64).clamp(min=1)
    return x0, x1, x2


def torch_chain(cmb32, k0, steps: int, seq_len: int, rows: int = 1):
    """The chained row gather as plain int32 PyTorch calls, `rows` (1 or 2)
    gathers a step: index, sum, add, remainder.  It is only timed: the
    plain version that the kernels are held against is
    ops/fm_probe.chain_gather.  With one row it computes that function in a
    third of the launches (int32 overflow wraps on the card), which probe()
    checks once."""
    import torch
    nb = cmb32.shape[0]
    k = k0
    for _ in range(steps):
        blk = k >> 7
        acc = cmb32[blk].sum(-1, dtype=torch.int32)
        if rows == 2:
            acc = acc + cmb32[(blk + 1).clamp(max=nb - 1)].sum(
                -1, dtype=torch.int32)
        k = torch.remainder(k + acc, seq_len)
    return k


def probe(n_lanes: int = 8192, steps: int = 64, log=print) -> dict:
    """Runs the probe on the current CUDA device; returns its times in ms
    by name.  Raises when a kernel disagrees with chain_gather."""
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import se_smoke_data as sd
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops import fm as fmops
    from bwamem_tpu_torch.ops import fm_probe

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    dev = torch.device("cuda")
    fm = fmops.fm_from_index(load_index(sd.smoke_data(log)[0]), dev)
    cmb32 = fm_probe.words32(fm.cmb)
    seq_len = fm.seq_len
    log(f"cmb table: {tuple(cmb32.shape)} = {cmb32.numel() * 4 / 1e6:.2f} "
        f"MB, lanes={n_lanes}, steps={steps}")
    k0 = torch.from_numpy(np.random.default_rng(0).integers(
        0, seq_len, n_lanes).astype(np.int32)).to(dev)

    want = fm_probe.chain_gather(cmb32, k0, steps, seq_len)
    for name, fn in (("fm_chain_words", fm_probe.chain_words),
                     ("fm_chain_rows", fm_probe.chain_rows)):
        got = fn(cmb32, k0, steps, seq_len)
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        if n_bad:
            raise RuntimeError(f"{name} differs from chain_gather on "
                               f"{n_bad} of {n_lanes} lanes")
    if not torch.equal(torch_chain(cmb32, k0, steps, seq_len), want):
        raise RuntimeError("the int32 PyTorch chain differs from "
                           "chain_gather")
    log("both kernels equal chain_gather on every lane")

    out = {}
    for name, fn in (
            ("torch chained fm.extend", lambda: chain_extend(fm, k0, steps)),
            ("torch chained gather(1 row)+sum",
             lambda: torch_chain(cmb32, k0, steps, seq_len)),
            ("torch chained gather(2 rows)+sum",
             lambda: torch_chain(cmb32, k0, steps, seq_len, rows=2)),
            ("kernel fm_chain_words",
             lambda: fm_probe.chain_words(cmb32, k0, steps, seq_len)),
            ("kernel fm_chain_rows",
             lambda: fm_probe.chain_rows(cmb32, k0, steps, seq_len))):
        ms = best_ms(fn)
        out[name] = ms
        log(f"{name:34s} {ms:10.4f} ms  ({ms / max(steps, 1) * 1e3:9.3f} "
            f"us/step)")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_fm_step_probe: no CUDA device", file=sys.stderr)
        return 2
    n_lanes = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    probe(n_lanes, steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
