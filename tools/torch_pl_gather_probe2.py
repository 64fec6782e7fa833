#!/usr/bin/env python3
"""Round 2 of the gather probe, priced on a GPU.

    python3 tools/torch_pl_gather_probe2.py [steps]

The counterpart of tools/pl_gather_probe2.py (the TPU probe) at its
defaults: `steps` = 32 chained steps, and the four hand-written CUDA
kernels of ops/gather_probe2 on seeded numpy tables:

  B  gp2_take_ax0    a chained gather along axis 0 on [512, 128]
  C  gp2_take_ax1    a chained gather along axis 1 on [128, 128] and on
                     [8, 128]
  D  gp2_col0        word 0 of 1024 rows of a [78208, 8] table (the
                     combined rows of a 5 Mbp index: one `aln` round's
                     lookups at 1024 lanes)
  E  gp2_onehot_f32  the gather that the TPU kernel's float32 one-hot
                     [1024, 640] x [640, 128] product and pick of one
                     column per query compute: one load a query

It also times probe A, which has no Pallas kernel: the 32-step
take_along_axis chain on [611, 128], as torch.gather calls issued from
PyTorch.  Each kernel's output must equal its plain PyTorch version
exactly before anything is timed (a difference exits non-zero), and so
must each library call's.  Times are the median of 5 runs between CUDA
events after a warm-up, in ms and us per step, beside the plain version
and a PyTorch call computing the same function: the chain of
torch.gather, add and remainder for B and C, tab[k, 0] for D, and for E
the gather the one-hot product's pick equals: torch.take of the table at
k (row k >> 7, column k & 127), 0 where k lies outside the table.  Each
kernel's call is also timed on the device alone (`device_ms`: the events
and the launch are queued behind a 1 ms spin of the card, so the host's
cost of issuing the call is off the clock), and E's, at a launch's
latency on the device, also on the host clock with its library call
(`issue_us`, `library_issue_us`: torch_dispatch_probe.issue_us, 200 calls
back to back).  D, a launch's latency on the device and on the host, is
timed as a run of 200 back-to-back calls between two events (`ms`), the
same run behind an 8 ms spin of the card (`device_ms`), one call between
events as the other rows (`single_ms`) and on the host clock
(`issue_us`), and so is its library call, the two in turns, six rounds
(col0_times).  The card's name and power limit are printed first.  Needs
a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 32
B_ROWS = 512                # probe B's table rows
C_ROWS = (128, 8)           # probe C's table rows
D_ROWS, D_W, D_LANES = 78208, 8, 1024
E_Q, E_A = 1024, 640
A_ROWS = 611                # probe A's table rows
REPS = 5
SPIN_CYCLES = 2_000_000     # about 1 ms of the card's clock
B2B_CALLS = 200             # calls of a back-to-back run
B2B_SPIN_CYCLES = 16_000_000  # about 8 ms: longer than issuing a run
COL0_ROUNDS = 6             # turns of a column-0 gather and its library call


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


def device_ms(fn, reps: int = REPS) -> float:
    """Median time of fn() on the device alone: a spin kernel keeps the
    card busy while the host records the first event, issues fn's
    launches and records the second, so the events bracket the device's
    work and not the host's.  fn must issue in less time than the spin
    (about 1 ms)."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def b2b_ms(fn, calls: int = B2B_CALLS, reps: int = REPS) -> float:
    """Time of one fn() in a run of `calls` back-to-back calls between two
    CUDA events, after a warm-up: the median of `reps` runs, divided by
    `calls`.  For a call at a launch's latency this is the larger of its
    host issue and its time on the device."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return sorted(times)[len(times) // 2]


def b2b_device_ms(fn, calls: int = B2B_CALLS, reps: int = REPS) -> float:
    """b2b_ms with the run queued behind a spin of the card (about 8 ms),
    so that every call is issued before the device reaches the first and
    the host's issue is off the clock: the device's time a call, the
    launch's latency between two kernels included.  A run whose spin ended
    before its last call was issued is dropped and taken again behind a
    spin twice as long; raises past 64 times the first spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    spin = B2B_SPIN_CYCLES
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        ended = a.query()
        torch.cuda.synchronize()
        if not ended:
            times.append(a.elapsed_time(b) / calls)
        elif spin >= 64 * B2B_SPIN_CYCLES:
            raise RuntimeError("b2b_device_ms: the host did not issue the "
                               "run within the longest spin")
        else:
            spin *= 2
    return sorted(times)[len(times) // 2]


def call_times(fn) -> dict:
    """ms and device_ms back to back (b2b_ms, b2b_device_ms), single_ms
    (one call between events, as the probe's other rows are timed) and
    issue_us (host clock, torch_dispatch_probe.issue_us) of one call."""
    from torch_dispatch_probe import issue_us
    return dict(ms=b2b_ms(fn), device_ms=b2b_device_ms(fn),
                single_ms=median_ms(fn), issue_us=issue_us(fn))


def interleaved(fns: dict, rounds: int = COL0_ROUNDS) -> dict:
    """{name: call_times, each number the median over `rounds` rounds}:
    the calls run in turns (A B C, C B A, ...), since the host's clock
    drifts by tens of percent within a run."""
    runs = {name: [] for name in fns}
    order = list(fns)
    for i in range(rounds):
        for name in (order if i % 2 == 0 else order[::-1]):
            runs[name].append(call_times(fns[name]))
    return {name: {m: sorted(r[m] for r in rs)[len(rs) // 2]
                   for m in rs[0]} for name, rs in runs.items()}


def col0_times(kern, plain, lib) -> dict:
    """The times of a column-0 gather (rows 6D and 7C) and its library
    call on one input, taken in turns (interleaved): call_times' keys for
    the kernel, and as library_* for the library call; plain_ms back to
    back."""
    t = interleaved({"kernel": kern, "library": lib})
    r = dict(t["kernel"], plain_ms=b2b_ms(plain))
    r.update({f"library_{m}": v for m, v in t["library"].items()})
    return r


def log_col0(label: str, r: dict, log=print) -> None:
    """col0_times' numbers of one input, on two lines."""
    log(f"{label:24s} kernel back to back {r['ms']:.4f} ms a call, device "
        f"alone {r['device_ms']:.4f}, one call {r['single_ms']:.4f}, host "
        f"issue {r['issue_us']:.2f} us; plain {r['plain_ms']:.4f} ms")
    log(f"{label:24s} library back to back {r['library_ms']:.4f} ms a call,"
        f" device alone {r['library_device_ms']:.4f}, one call "
        f"{r['library_single_ms']:.4f}, host issue "
        f"{r['library_issue_us']:.2f} us")


def make_inputs(seed: int, device) -> dict:
    """The probe's tables and indices, from numpy with `seed`, on
    `device`; values of every table in [0, 2^20), as the TPU probe's."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def ints(hi, shape):
        return rng.integers(0, hi, shape, dtype=np.int32)
    x = {"b_tab": ints(1 << 20, (B_ROWS, 128)),
         "b_kk": ints(B_ROWS, (B_ROWS, 128)),
         "d_tab": ints(1 << 20, (D_ROWS, D_W)),
         "d_k": ints(D_ROWS, D_LANES),
         "e_tab": ints(1 << 20, (E_A, 128)),
         "e_k": ints(E_A * 128, (E_Q // 128, 128)),
         "a_tab": ints(1 << 20, (A_ROWS, 128)),
         "a_kk": ints(A_ROWS, (A_ROWS, 128))}
    for S in C_ROWS:
        x[f"c{S}_tab"] = ints(1 << 20, (S, 128))
        x[f"c{S}_kk"] = ints(128, (S, 128))
    return {n: torch.from_numpy(a).to(device) for n, a in x.items()}


def torch_chain(tab, kk, steps: int, dim: int):
    """The chain kk = (kk + tab.gather(dim, kk)) mod tab.shape[dim] issued
    from PyTorch in int32 (the add cannot wrap: values < 2^21)."""
    import torch
    m = tab.shape[dim]
    for _ in range(steps):
        kk = torch.remainder(kk + torch.gather(tab, dim, kk.long()), m)
    return kk


def cases(x: dict, steps: int) -> list:
    """(label, kernel name, kernel call, plain call, library call, steps a
    launch) for each kernel and shape of the probe."""
    import torch
    from bwamem_tpu_torch.ops import col0, gather_probe2 as gp2
    out = [("B take_ax0 [512,128]", "gp2_take_ax0",
            lambda: gp2.gp2_take_ax0(x["b_tab"], x["b_kk"], steps),
            lambda: gp2.take_ax0_plain(x["b_tab"], x["b_kk"], steps),
            lambda: torch_chain(x["b_tab"], x["b_kk"], steps, 0), steps)]
    for S in C_ROWS:
        tab, kk = x[f"c{S}_tab"], x[f"c{S}_kk"]
        out.append((f"C take_ax1 [{S},128]", "gp2_take_ax1",
                    lambda tab=tab, kk=kk: gp2.gp2_take_ax1(tab, kk, steps),
                    lambda tab=tab, kk=kk: gp2.take_ax1_plain(tab, kk, steps),
                    lambda tab=tab, kk=kk: torch_chain(tab, kk, steps, 1),
                    steps))
    k64 = x["d_k"].long()
    out.append(("D col0 x1024 [78208,8]", "gp2_col0",
                lambda: gp2.gp2_col0(x["d_tab"], x["d_k"]),
                lambda: col0.plain(x["d_tab"], x["d_k"]),
                lambda: x["d_tab"][k64, 0], 1))
    ek, n_e = x["e_k"].long(), x["e_tab"].numel()

    def e_library():
        inside = (ek >= 0) & (ek < n_e)
        return torch.where(inside,
                           torch.take(x["e_tab"], ek.clamp(0, n_e - 1)), 0)
    out.append(("E onehot_f32 Q1024 A640", "gp2_onehot_f32",
                lambda: gp2.gp2_onehot_f32(x["e_tab"], x["e_k"]),
                lambda: gp2.onehot_f32_plain(x["e_tab"], x["e_k"]),
                e_library, 1))
    return out


def probe(steps: int = STEPS, seed: int = 0, log=print) -> dict:
    """Runs the probe on the current CUDA device.  Returns dict(inputs=...
    (make_inputs), results={label: dict(name, ms, device_ms, plain_ms,
    library_ms, max_abs_err, steps)}, E's also with issue_us and
    library_issue_us, D's with col0_times' keys, a_ms=probe A's chain);
    raises when a kernel or a library call differs from its plain
    version.  Each kernel launches 12 times a shape: 1 check, 1 warm-up
    and 5 timed calls, then 5 timed on the device alone; E 201 more for
    its issue; D 13255 (1 check, then six rounds of two warmed runs of 5
    x 200, a warmed single call 5 times and 201 for the issue)."""
    import torch
    from torch_dispatch_probe import issue_us
    sys.path.insert(0, REPO)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    x = make_inputs(seed, torch.device("cuda"))
    log(f"steps={steps}; B [{B_ROWS},128], C {[(S, 128) for S in C_ROWS]}"
        f", D {D_LANES} lanes of [{D_ROWS},{D_W}], E Q={E_Q} A={E_A}")
    todo = cases(x, steps)
    for label, _, kern, plain, lib, _ in todo:
        want = plain().to(torch.int64)
        for what, fn in (("kernel", kern), ("library call", lib)):
            got = fn().to(torch.int64)
            torch.cuda.synchronize()
            n_bad = int((got != want).sum())
            if n_bad:
                raise RuntimeError(f"{label}: the {what} differs from "
                                   f"the plain version on {n_bad} of "
                                   f"{want.numel()} outputs")
    log("every kernel and library call equals its plain version on "
        "every output")
    results = {}
    for label, name, kern, plain, lib, per in todo:
        if name == "gp2_col0":
            r = dict(name=name, max_abs_err=0, steps=per,
                     **col0_times(kern, plain, lib))
            results[label] = r
            log_col0(label, r, log)
            continue
        r = dict(name=name, max_abs_err=0, steps=per, ms=median_ms(kern),
                 device_ms=device_ms(kern), plain_ms=median_ms(plain),
                 library_ms=median_ms(lib))
        results[label] = r
        log(f"{label:24s} kernel {r['ms']:8.4f} ms "
            f"({r['ms'] / per * 1e3:8.3f} us/step), on the device alone "
            f"{r['device_ms']:8.4f} ms, plain {r['plain_ms']:8.4f} ms, "
            f"library {r['library_ms']:8.4f} ms")
        if name == "gp2_onehot_f32":
            r.update(issue_us=issue_us(kern), library_issue_us=issue_us(lib))
            log(f"{label:24s} host issue {r['issue_us']:.2f} us a call, "
                f"library {r['library_issue_us']:.2f} us")
    a_ms = median_ms(lambda: torch_chain(x["a_tab"], x["a_kk"], steps, 0))
    log(f"{'A torch.gather [611,128]':24s} chain   {a_ms:8.4f} ms "
        f"({a_ms / steps * 1e3:8.3f} us/step), issued from PyTorch (no "
        "Pallas kernel)")
    return dict(inputs=x, results=results, a_ms=a_ms)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_pl_gather_probe2: no CUDA device", file=sys.stderr)
        return 2
    probe(int(sys.argv[1]) if len(sys.argv) > 1 else STEPS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
