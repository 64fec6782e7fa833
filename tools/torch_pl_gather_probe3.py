#!/usr/bin/env python3
"""Round 3 of the gather probe, priced on a GPU.

    python3 tools/torch_pl_gather_probe3.py [steps]

The counterpart of tools/pl_gather_probe3.py (the TPU probe) at its
shapes: `steps` = 512 chained steps, and the four hand-written CUDA kernels
of ops/gather_probe3 on seeded numpy inputs:

  7A  gp3_dg    a clipped chain along axis 0 on B8 [8, 128] and B32
                [32, 128], and along axis 1 on C512 [128, 512]
  7B  gp3_ct    the take, transpose and take chain on [128, 128]
  7C  gp3_col0  word 0 of 8 rows of a [78208, 8] table
  7D  gp3_mm    64 ordered float32 additions of (a @ b)[:8], a [1024, 640]
                and b [640, 128] drawn from a normal distribution

Tables of the chains are drawn from [0, 2^20), as the TPU probe's: on them
nearly every chain sits at hi - 1 after its first step.  So each chain
kernel is also held and timed on a spread input
(ops/gather_probe3.spread_inputs: values in [-hi, hi], chains that keep
moving and meet both ends of the clip; 7B's gathers then spread over the
banks of shared memory), and 7A held on a table within 64 of +-2^31
(gather_probe3.dg_inputs("wrap"): every add wraps); gp3_mm on
integer-valued a, b in [-8, 8], where every sum is exact.  Each kernel's
output must equal its plain PyTorch version
exactly (gp3_mm on the normal inputs: within ops/gather_probe3.mm_tolerance)
before anything is timed, and so must each library call's; a difference
exits non-zero.  Times are the median of 5 runs between CUDA events after
a warm-up, beside the plain version and a PyTorch call computing the same
function: the 512-step chain of torch.gather, add and clamp (for 7B with
the transpose) issued from PyTorch, tab[k, 0] for 7C, and for 7D
torch.matmul(a[:8], b) followed by the 64 additions (TF32 off).  Each
kernel's call is also timed on the device alone (`device_ms`: the events
and the launch are queued behind a 1 ms spin of the card).  7C, at a
launch's latency on the device and on the host, is timed as row 6D is
(torch_pl_gather_probe2.col0_times: 200 back-to-back calls between two
events, the same behind an 8 ms spin, one call between events as
`single_ms`, the host clock as `issue_us`), and so is its library call,
the two in turns.
The card's name and power limit are printed first.  Needs a CUDA device;
exits non-zero without one.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
STEPS = 512
DG_SHAPES = (("B8", 8, 128, 0), ("B32", 32, 128, 0), ("C512", 128, 512, 1))
CT_N = 128
D_ROWS, D_W, D_LANES = 78208, 8, 8
E_M, E_K, E_N = 1024, 640, 128


def make_inputs(seed: int, device) -> dict:
    """The probe's inputs from numpy with `seed`, on `device`, and the
    extra inputs the kernels are also held on (*_spread, *_wrap,
    e_int)."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    rng = np.random.default_rng(seed)

    def ints(hi, shape):
        return rng.integers(0, hi, shape, dtype=np.int32)
    x = {}
    for tag, S, L, axis in DG_SHAPES:
        x[f"{tag}_tab"] = ints(1 << 20, (S, L))
        x[f"{tag}_kk"] = ints((S, L)[axis], (S, L))
    x["ct_tab"] = ints(1 << 20, (CT_N, CT_N))
    x["ct_kk"] = ints(CT_N, (CT_N, CT_N))
    x["d_tab"] = ints(1 << 20, (D_ROWS, D_W))
    x["d_k"] = ints(D_ROWS, D_LANES)
    x["e_a"] = rng.standard_normal((E_M, E_K)).astype(np.float32)
    x["e_b"] = rng.standard_normal((E_K, E_N)).astype(np.float32)
    x["e_a_int"] = rng.integers(-8, 9, (E_M, E_K)).astype(np.float32)
    x["e_b_int"] = rng.integers(-8, 9, (E_K, E_N)).astype(np.float32)
    out = {n: torch.from_numpy(a).to(device) for n, a in x.items()}
    for i, (tag, S, L, axis) in enumerate(DG_SHAPES):
        out[f"{tag}_tab_spread"], out[f"{tag}_kk_spread"] = \
            gp3.spread_inputs(seed + 1 + i, S, L, axis, device)
        out[f"{tag}_tab_wrap"], out[f"{tag}_kk_wrap"] = gp3.dg_inputs(
            "wrap", S, L, axis, seed + 20 + i, device)
    out["ct_tab_spread"], out["ct_kk_spread"] = gp3.spread_inputs(
        seed + 9, CT_N, CT_N, 1, device)
    return out


def torch_dg(tab, kk, steps: int, axis: int):
    """The chain issued from PyTorch in int32 (the add wraps as int32's
    does on the card)."""
    import torch
    hi = tab.shape[axis]
    for _ in range(steps):
        kk = torch.clamp(kk + torch.gather(tab, axis, kk.long()), 0, hi - 1)
    return kk


def torch_ct(tab, kk, steps: int):
    import torch
    N = tab.shape[0]
    for _ in range(steps):
        k = kk.long()
        g2 = torch.gather(torch.gather(tab, 1, k).t(), 1, k)
        kk = torch.clamp(kk + g2, 0, N - 1)
    return kk


def torch_mm(a, b):
    """torch.matmul(a[:8], b) (TF32 off), then the 64 additions."""
    import torch
    m = torch.matmul(a[:8], b)
    acc = torch.zeros_like(m)
    for _ in range(64):
        acc = acc + m
    return acc


def cases(x: dict, steps: int) -> list:
    """(label, kernel name, kernel call, plain call, library call, tolerance
    against the plain version, timed) for each kernel, shape and input the
    probe holds; the untimed cases are 7A's wrapping tables and 7D's
    integer-valued inputs."""
    from bwamem_tpu_torch.ops import col0, gather_probe3 as gp3
    out = []
    for tag, S, L, axis in DG_SHAPES:
        for sfx in ("", "_spread", "_wrap"):
            tab, kk = x[f"{tag}_tab{sfx}"], x[f"{tag}_kk{sfx}"]
            out.append((f"7A dg {tag} ax{axis} [{S},{L}]{sfx}", "gp3_dg",
                        lambda t=tab, k=kk, a=axis: gp3.gp3_dg(t, k, steps,
                                                               a),
                        lambda t=tab, k=kk, a=axis: gp3.dg_plain(t, k, steps,
                                                                 a),
                        lambda t=tab, k=kk, a=axis: torch_dg(t, k, steps, a),
                        0.0, sfx != "_wrap"))
    for sfx in ("", "_spread"):
        tab, kk = x[f"ct_tab{sfx}"], x[f"ct_kk{sfx}"]
        out.append((f"7B ct [{CT_N},{CT_N}]{sfx}", "gp3_ct",
                    lambda t=tab, k=kk: gp3.gp3_ct(t, k, steps),
                    lambda t=tab, k=kk: gp3.ct_plain(t, k, steps),
                    lambda t=tab, k=kk: torch_ct(t, k, steps), 0.0, True))
    k64 = x["d_k"].long()
    out.append((f"7C col0 x{D_LANES} [{D_ROWS},{D_W}]", "gp3_col0",
                lambda: gp3.gp3_col0(x["d_tab"], x["d_k"]),
                lambda: col0.plain(x["d_tab"], x["d_k"]),
                lambda: x["d_tab"][k64, 0], 0.0, True))
    for sfx, timed in (("", True), ("_int", False)):
        a, b = x[f"e_a{sfx}"], x[f"e_b{sfx}"]
        tol = 0.0 if gp3.mm_exact(a, b) else gp3.mm_tolerance(a, b)
        out.append((f"7D mm {E_M}x{E_K}x{E_N} x64{sfx}", "gp3_mm",
                    lambda a=a, b=b: gp3.gp3_mm(a, b),
                    lambda a=a, b=b: gp3.mm_plain(a, b),
                    lambda a=a, b=b: torch_mm(a, b), tol, timed))
    return out


def probe(steps: int = STEPS, seed: int = 0, log=print) -> dict:
    """Runs the probe on the current CUDA device.  Returns dict(inputs=...
    (make_inputs), results={label: dict(name, ms, device_ms, plain_ms,
    library_ms, max_abs_err, tolerance, steps)} for the timed cases,
    checks={label: (max_abs_err, tolerance)} for every case); raises when
    a kernel or a library call differs from its plain version by more
    than the case's tolerance; 7C's result has col0_times' keys.  Each
    kernel launches 12 times a timed case (1 check, 1 warm-up and 5 timed
    calls, then 5 on the device alone; 7C 13255, as probe 2's D), and
    once an untimed case: 7A 75 times in all (three shapes, the probe's
    and the spread input timed, the wrapping one held), 7B 24 (both
    inputs timed)."""
    import torch
    from torch_pl_gather_probe2 import (col0_times, device_ms, log_col0,
                                        median_ms)
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    x = make_inputs(seed, torch.device("cuda"))
    log(f"steps={steps}; 7A {[(S, L, a) for _, S, L, a in DG_SHAPES]}, 7B "
        f"[{CT_N},{CT_N}], 7C {D_LANES} lanes of [{D_ROWS},{D_W}], 7D "
        f"[{E_M},{E_K}] x [{E_K},{E_N}] x 64; TF32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    todo = cases(x, steps)
    checks = {}
    for label, _, kern, plain, lib, tol, _ in todo:
        want = plain().double()
        errs = []
        for what, fn in (("kernel", kern), ("library call", lib)):
            got = fn().double()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if err > tol:
                raise RuntimeError(f"{label}: the {what} differs from the "
                                   f"plain version by {err} (tolerance "
                                   f"{tol})")
            errs.append(err)
        checks[label] = (errs[0], tol)
        log(f"{label:34s} kernel vs plain max_abs_err {errs[0]} (tolerance "
            f"{tol:.6g}), library {errs[1]}")
    results = {}
    for label, name, kern, plain, lib, tol, timed in todo:
        if not timed:
            continue
        if name == "gp3_col0":
            r = dict(name=name, max_abs_err=checks[label][0], tolerance=tol,
                     steps=1, **col0_times(kern, plain, lib))
            results[label] = r
            log_col0(label, r, log)
            continue
        per = 64 if name == "gp3_mm" else steps
        r = dict(name=name, max_abs_err=checks[label][0], tolerance=tol,
                 steps=per, ms=median_ms(kern), device_ms=device_ms(kern),
                 plain_ms=median_ms(plain), library_ms=median_ms(lib))
        results[label] = r
        log(f"{label:34s} kernel {r['ms']:8.4f} ms "
            f"({r['ms'] / per * 1e3:8.3f} us/step), on the device alone "
            f"{r['device_ms']:8.4f} ms, plain {r['plain_ms']:8.4f} ms, "
            f"library {r['library_ms']:8.4f} ms")
    return dict(inputs=x, results=results, checks=checks)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_pl_gather_probe3: no CUDA device", file=sys.stderr)
        return 2
    probe(int(sys.argv[1]) if len(sys.argv) > 1 else STEPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
