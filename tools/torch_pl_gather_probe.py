#!/usr/bin/env python3
"""Gather strategies for an in-kernel FM scan, priced on a GPU.

    python3 tools/torch_pl_gather_probe.py [n_lanes] [steps]

The counterpart of tools/pl_gather_probe.py (the TPU probe) with its
shapes: n_lanes lanes (8192, a multiple of 128), `steps` dependent steps
(16) for the take, a table of R = 78208 rows (the combined
rows of a 5 Mbp index, padded to a multiple of 128), W = 8 words a row for
the two-word read, and A = R / 128 = 611 rows for the one-hot product.
The four hand-written CUDA kernels of ops/gather_probe run on the same
seeded numpy tables:

  gp_scalar    a per-lane 4-byte load, one pass (the TPU kernel's passes
               price one; its output does not depend on them)
  gp_scalar2   a per-lane 8-byte row read (two words, added), one pass
               (as gp_scalar)
  gp_onehot    the gather the TPU probe's one-hot product computes: one
               load of the [611, 128] table a lane, rounded to bf16
  gp_take_ax0  a chained take along axis 0 over the whole [R, 128] table,
               `steps` dependent steps, on the probe's indices (zero past
               the lanes' rows: the chains of a column share a state
               there) and timed again on spread ones (every row its own
               start: ops/gather_probe.take_inputs), held on a table
               whose adds wrap too

Each kernel's output must equal its plain PyTorch version exactly before
anything is timed (a difference exits non-zero); gp_onehot also on the
inputs of ops/gather_probe.onehot_inputs (the CPU tests' cases: values
where bf16 rounds, its ties, k outside the table and at both ends of
int32), at the tests' size and at the probe's.  Times are the median of 5
runs between CUDA events after a warm-up, in ms and us per step, and on
the device alone (torch_pl_gather_probe2.device_ms: the launch queued
behind a spin of the card, so the host's issue is off the clock), and for
the three at a launch's latency on the host clock with their library
call (`issue_us`, `library_issue_us`: torch_dispatch_probe.issue_us, 200
calls back to back), beside the plain version and a PyTorch call
computing the same function: torch.gather for gp_scalar; for gp_scalar2
tab[k, :2].sum(-1, dtype=int32), two ops (an index and a reduce); for
gp_onehot the gather its pick equals, torch.take of the bf16-rounded
table at k, 0 outside the table; the take chain issued from PyTorch in
int32.  Each library call must equal the plain version too.  The card's
name and power limit are printed first.  Needs a CUDA device; exits
non-zero without one.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
R = 78208            # table rows (5 Mbp cmb), padded to /128
W = 8                # words a row of the two-word table
REPS = 5


def median_ms(fn, reps: int = REPS) -> float:
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


def make_inputs(n_lanes: int, seed: int, device) -> dict:
    """The probe's tables and lanes, from numpy with `seed`, on `device`:
    tab [R, 128] in [0, 2^20) and kfull [R, 128], lanes in [0, R) in its
    first n_lanes / 128 rows and 0 below (the take's table-shaped indices:
    ops/gather_probe.take_inputs("probe")), k [n_lanes/128, 128] those
    lanes, tabw [R, W] in [0, 2^20), tab3 [R/128, 128] in [0, 255); and
    the take's other inputs, tab_spread with kfull_spread and tab_wrap
    with kfull_wrap (take_inputs' "spread" and "wrap")."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops import gather_probe as gp
    if n_lanes <= 0 or n_lanes % 128 or n_lanes > R * 128:
        raise ValueError(f"n_lanes {n_lanes}: a positive multiple of 128 "
                         f"up to {R * 128}")
    x = {}
    x["tab"], x["kfull"] = gp.take_inputs("probe", R, n_lanes, seed, device)
    x["k"] = x["kfull"][:n_lanes // 128].clone()
    for i, kind in enumerate(("spread", "wrap")):
        x[f"tab_{kind}"], x[f"kfull_{kind}"] = gp.take_inputs(
            kind, R, n_lanes, seed + 1 + i, device)
    rng = np.random.default_rng(seed + 3)
    x["tabw"] = torch.from_numpy(rng.integers(0, 1 << 20, (R, W),
                                              dtype=np.int32)).to(device)
    x["tab3"] = torch.from_numpy(rng.integers(0, 255, (R // 128, 128),
                                              dtype=np.int32)).to(device)
    return x


def check_onehot(n_lanes: int, device, log=print) -> dict:
    """gp_onehot against onehot_plain on every case of
    ops/gather_probe.onehot_inputs (seed 3), at the CPU tests' size (A = 8,
    256 lanes: their inputs) and at the probe's (A = R / 128, n_lanes).
    Returns {"case A=.. n=..": max_abs_err}; raises on any difference, or
    when the bf16_rounding case leaves half of its values unrounded."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops import gather_probe as gp
    errs = {}
    for case in gp.ONEHOT_CASES:
        for A, n in ((8, 256), (R // 128, max(n_lanes, 256))):
            tab3, k = gp.onehot_inputs(case, A, n)
            t, kk = (torch.from_numpy(x).to(device) for x in (tab3, k))
            got = gp.gp_onehot(t, kk).to(torch.int64)
            want = gp.onehot_plain(t, kk).to(torch.int64)
            torch.cuda.synchronize()
            label = f"{case} A={A} n={n}"
            errs[label] = int((got - want).abs().max().item())
            if errs[label]:
                raise RuntimeError(f"gp_onehot differs from its plain "
                                   f"version on {label}: "
                                   f"{int((got != want).sum())} outputs")
            if case == "bf16_rounding":
                raw = tab3[k >> 7, k & 127]
                share = float((got.cpu().numpy() != raw).mean())
                if share <= 0.5:
                    raise RuntimeError(f"{label}: only {share:.2f} of the "
                                       f"values round in bf16")
    log(f"gp_onehot vs plain, max_abs_err: {errs}")
    return errs


SCALAR2_WIDTHS = (2, 3, 7, 8)   # gp_scalar2 also held at these row widths


def check_scalar2(n_lanes: int, device, seed: int = 5, log=print) -> dict:
    """gp_scalar2 against scalar2_plain on tables of SCALAR2_WIDTHS words a
    row (odd widths take two 4-byte loads a lane, even ones one 8-byte
    load), on the same even width at a table start 4 bytes past an 8-byte
    boundary (two loads), and with values within 64 of 2^31, where every
    sum wraps.  Returns {label: max_abs_err}; raises on a difference."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops import gather_probe as gp
    rng = np.random.default_rng(seed)
    k = torch.from_numpy(rng.integers(0, 1000, (n_lanes // 128, 128),
                                      dtype=np.int32)).to(device)
    errs = {}
    for w in SCALAR2_WIDTHS:
        for lo, hi in ((0, 1 << 20), ((1 << 31) - 64, 1 << 31)):
            flat = torch.from_numpy(rng.integers(
                lo, hi, 1000 * w + 1, dtype=np.int64).astype(np.int32)
            ).to(device)
            for off in (0, 1):
                tab = flat[off:off + 1000 * w].view(1000, w)
                got = gp.gp_scalar2(tab, k).to(torch.int64)
                want = gp.scalar2_plain(tab, k).to(torch.int64)
                torch.cuda.synchronize()
                label = (f"W={w} at {tab.data_ptr() % 8} past 8 bytes, "
                         f"values from {lo}")
                errs[label] = int((got - want).abs().max().item())
                if errs[label]:
                    raise RuntimeError(f"gp_scalar2 differs from its plain "
                                       f"version on {label}")
    log(f"gp_scalar2 vs plain at widths {SCALAR2_WIDTHS}, aligned and not, "
        f"sums that wrap: max_abs_err {max(errs.values())}")
    return errs


def probe(n_lanes: int = 8192, steps: int = 16, seed: int = 0,
          log=print) -> dict:
    """Runs the probe on the current CUDA device.  Returns dict(inputs=...
    (make_inputs), results={label: dict(ms, device_ms, plain_ms,
    library_ms, max_abs_err, and but for gp_take_ax0 issue_us,
    library_issue_us)} (labels the kernels' names, and gp_take_ax0_spread
    for the take on the spread input), onehot=check_onehot's errors,
    scalar2=check_scalar2's); raises when a kernel differs from its plain
    version.  gp_take_ax0 is also held, not timed, on the wrapping
    input."""
    import torch
    sys.path.insert(0, REPO)
    from bwamem_tpu_torch.ops import gather_probe as gp
    from torch_dispatch_probe import issue_us
    from torch_pl_gather_probe2 import device_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    dev = torch.device("cuda")
    x = make_inputs(n_lanes, seed, dev)
    tab, tabw, tab3, k = (x[n] for n in ("tab", "tabw", "tab3", "k"))
    log(f"lanes={n_lanes}, steps={steps}, R={R}, W={W}, A="
        f"{tab3.shape[0]}; tab {tab.numel() * 4 / 1e6:.2f} MB")

    k64 = k.to(torch.int64)
    t3 = tab3.to(torch.bfloat16)          # the product's operand rounding

    def scalar2_sum():                     # values < 2^21: no wrap
        return tabw[k64, :2].sum(-1, dtype=torch.int32)

    def onehot_gather():
        inside = (k64 >= 0) & (k64 < t3.numel())
        got = torch.take(t3, k64.clamp(0, t3.numel() - 1))
        return torch.where(inside, got, 0).to(torch.int32)

    def take_chain(tab, kk):
        for _ in range(steps):
            kk = torch.remainder(kk + torch.gather(tab, 0, kk.long()), R)
        return kk

    # (label, kernel, call, plain, library call, timed)
    cases = [
        ("gp_scalar", "gp_scalar", lambda: gp.gp_scalar(tab, k),
         lambda: gp.scalar_plain(tab, k),
         lambda: torch.gather(tab, 0, k64), True),
        ("gp_scalar2", "gp_scalar2", lambda: gp.gp_scalar2(tabw, k),
         lambda: gp.scalar2_plain(tabw, k), scalar2_sum, True),
        ("gp_onehot", "gp_onehot", lambda: gp.gp_onehot(tab3, k),
         lambda: gp.onehot_plain(tab3, k), onehot_gather, True)]
    for sfx in ("", "_spread", "_wrap"):
        t, kk = x["tab" + sfx], x["kfull" + sfx]
        cases.append((
            "gp_take_ax0" + sfx, "gp_take_ax0",
            lambda t=t, kk=kk: gp.gp_take_ax0(t, kk, steps),
            lambda t=t, kk=kk: gp.take_ax0_plain(t, kk, steps),
            lambda t=t, kk=kk: take_chain(t, kk), sfx != "_wrap"))
    for label, _, kern, plain, lib, _ in cases:
        want = plain().to(torch.int64)
        for what, fn in (("kernel", kern), ("library call", lib)):
            got = fn().to(torch.int64)
            torch.cuda.synchronize()
            n_bad = int((got != want).sum())
            if n_bad:
                raise RuntimeError(f"{label}: the {what} differs from its "
                                   f"plain version on {n_bad} of "
                                   f"{want.numel()} outputs")
    log("every kernel and library call equals its plain version on every "
        "output (gp_take_ax0 on the probe's, spread and wrapping inputs)")
    onehot = check_onehot(n_lanes, dev, log)
    scalar2 = check_scalar2(n_lanes, dev, log=log)

    results = {}
    for label, name, kern, plain, lib, timed in cases:
        if not timed:
            continue
        r = dict(max_abs_err=0, ms=median_ms(kern), device_ms=device_ms(kern),
                 plain_ms=median_ms(plain), library_ms=median_ms(lib))
        results[label] = r
        per = steps if name == "gp_take_ax0" else 1
        log(f"{label:18s} kernel {r['ms']:9.4f} ms ({r['ms'] / per * 1e3:9.3f}"
            f" us/step), on the device alone {r['device_ms']:9.4f} ms, plain "
            f"{r['plain_ms']:9.4f} ms, library {r['library_ms']:.4f} ms")
        if name != "gp_take_ax0":
            r.update(issue_us=issue_us(kern), library_issue_us=issue_us(lib))
            log(f"{label:18s} host issue {r['issue_us']:.2f} us a call, "
                f"library {r['library_issue_us']:.2f} us")
    return dict(inputs=x, results=results, onehot=onehot, scalar2=scalar2)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_pl_gather_probe: no CUDA device", file=sys.stderr)
        return 2
    n_lanes = int(sys.argv[1]) if len(sys.argv) > 1 else 8192
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    probe(n_lanes, steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
