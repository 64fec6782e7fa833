#!/usr/bin/env python3
"""The dispatch probe, priced on a GPU.

    python3 tools/torch_dispatch_probe.py

The counterpart of tools/dispatch_probe.py (the TPU probe) at its shapes:
the hand-written CUDA kernel dp_eh of ops/dispatch_probe (eh = max(eh +
(q == t ? 1 : -4), 0) over ROWS target rows, on qT [136, 2048]) and the
copies, on inputs drawn with numpy in the TPU script's order (one (qT, tT)
pair a ROWS of the sweep, then the ROWS = 128 pair: with seed 0 they are
the TPU script's).  It answers the script's questions with CUDA events and
host clocks:

  (a) cost against ROWS in (8, 128, 512, 2048): the host time of a call
      with its fetch (the script's number), the kernel's time between
      events, its time on the device alone (`device_ms`: the events and
      the launch are queued behind a 1 ms spin of the card, so the host's
      issue is off the clock), the plain version's time and the bound;
  (b) n in (1, 4, 16) calls enqueued, then one fetch each: the enqueue
      time, the fetch time and the total a call.  Then the port's own
      issue path, on the host clock over ISSUE_CALLS calls: the wrapper
      whole, its checks and allocation (_prep), ops/launch's stream
      lookup (launch.raw_stream) and device check
      (torch.cuda.current_device()), the launch on prepared arguments
      (_launch: check, lookup, ctypes call), beside the lookup the
      wrappers made before ops/launch (a device context and
      torch.cuda.current_stream(dev).cuda_stream, written out here) and
      torch.cuda.current_stream() alone, against one PyTorch op of the
      same size (qT + 1, and into a given output) on the same stream; and
      the time between events of a call of the wrapper and of qT + 1;
  (c) D2H against size (1x256, 136x2048, 1024x8192 int32): a * 2, then
      a fetch to pageable memory (the script's) and, non-blocking, to
      pinned memory;
  (d) H2D against the same sizes: a completed copy (the copy, then a
      synchronise) from pageable and from pinned memory.  The TPU script
      times a device_put that may not have happened yet.

The kernel must equal its plain version on every input before anything
is timed (a difference exits non-zero).  Times are medians of REPS runs.
The card's name and power limit are printed first.  Needs a CUDA device
and a checkout of the repository; exits non-zero without either.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
L1P, B = 136, 2048
ROWS_SWEEP = (8, 128, 512, 2048)
PIPE_ROWS, PIPE_N = 128, (1, 4, 16)
COPY_SHAPES = ((1, 256), (136, 2048), (1024, 8192))
ISSUE_CALLS = 200
REPS = 5


def host_ms(fn, reps: int = REPS) -> float:
    """Median host time of fn(), which must end in a synchronise or a
    fetch, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def issue_us(fn, calls: int = ISSUE_CALLS) -> float:
    """Host time to issue one fn() (no synchronise inside), over `calls`
    calls after a synchronised warm-up; the card is synchronised after."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def bound(nbytes: int, ops: int,
          packed16: bool = False) -> tuple[float, str]:
    """(bound_ms, bound_by) of a call that moves nbytes and does ops int32
    operations, at chip_smoke.py's H100 peaks (PEAK_INT16X2_OPS for a
    kernel that packs two cells in 16 bits, else PEAK_INT32_OPS)."""
    from chip_smoke import PEAK_BYTES, PEAK_INT16X2_OPS, PEAK_INT32_OPS
    peak = PEAK_INT16X2_OPS if packed16 else PEAK_INT32_OPS
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def make_inputs(seed: int, device) -> dict:
    """{"rows": {ROWS: (qT, tT)}, "pipe": (qT, tT)} drawn in the TPU
    script's order."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def pair(rows):
        qT = rng.integers(0, 4, (L1P, B)).astype(np.int32)
        tT = rng.integers(0, 4, (rows, B)).astype(np.int32)
        return tuple(torch.from_numpy(a).to(device) for a in (qT, tT))
    x = {"rows": {r: pair(r) for r in ROWS_SWEEP}}
    x["pipe"] = pair(PIPE_ROWS)
    return x


def draw(seed: int, L1p: int, B: int, rows: int, kind: str = "probe"):
    """(qT int32 [L1p, B], tT int32 [rows, B]) as numpy arrays of bases in
    [0, 4).  "probe" draws them uniformly, as the TPU script does: a cell
    matches one step in four, so eh falls to 0 within a few steps and out
    depends on the last few target rows only.  "match" gives each lane
    one base, which each of its query and target bases takes with
    probability 0.95 (else a uniform draw): a cell whose query base is
    the lane's (24 in 25) matches about 24 steps in 25, so eh climbs from
    its start by about 0.8 a step and seldom returns to 0, and out depends
    on every target row."""
    import numpy as np
    rng = np.random.default_rng(seed)
    qT = rng.integers(0, 4, (L1p, B))
    tT = rng.integers(0, 4, (rows, B))
    if kind == "match":
        base = rng.integers(0, 4, B)
        qT = np.where(rng.random((L1p, B)) < 0.95, base, qT)
        tT = np.where(rng.random((rows, B)) < 0.95, base, tT)
    return qT.astype(np.int32), tT.astype(np.int32)


# (L1p, B, ROWS) of check_match: the probe's shape at every ROWS, a tile
# of lanes cut short (B 1000), L1p 21 (no multiple of the rows a thread),
# and B 1001 (no multiple of 4 lanes a thread)
MATCH_SHAPES = (*((L1P, B, r) for r in ROWS_SWEEP), (104, 1000, 96),
                (21, 1000, 12), (21, 1000, 96), (L1P, 1001, 8),
                (104, 1001, 512))


def match_plans(B: int) -> list:
    """The plans check_match runs at B lanes: the shipped choice (None),
    PLAN and PLAN_SHORT at 32 bits and at 16 (two rows a thread at
    least), one lane a thread where B % 4 != 0, as plan() does."""
    from bwamem_tpu_torch.ops import dispatch_probe as dp
    plans = [None]
    for p in (dp.PLAN, dp.PLAN_SHORT):
        plans += [p._replace(bits=32),
                  p._replace(bits=16, rpt=max(p.rpt, 2))]
    return [p if p is None or B % 4 == 0 else p._replace(lpt=1)
            for p in plans]


def check_match(seed: int = 0, log=print) -> tuple[int, int]:
    """(largest |dp_eh - plain|, calls) over match_plans at MATCH_SHAPES
    on the match input (draw), which is (0, calls): raises when the
    kernel differs from its plain version, or when the input did not make
    eh climb (its mean over cells not above 8 + ROWS / 4)."""
    import torch
    from bwamem_tpu_torch.ops import dispatch_probe as dp
    n = 0
    for i, (L1p, b, rows) in enumerate(MATCH_SHAPES):
        qT, tT = (torch.from_numpy(a).cuda()
                  for a in draw(seed + i, L1p, b, rows, "match"))
        want = dp.dp_eh_plain(qT, tT)
        mean = float(want.double().mean())
        log(f"dp_eh match input L1p={L1p} B={b} ROWS={rows}: out mean "
            f"{mean:.2f}, max {int(want.max())}, zero "
            f"{int((want == 0).sum())} of {want.numel()}")
        if mean <= 8 + rows / 4:
            raise RuntimeError(f"the match input at L1p={L1p} B={b} "
                               f"ROWS={rows} did not make eh climb (out "
                               f"mean {mean:.2f})")
        for p in match_plans(b):
            got = dp.dp_eh(qT, tT, p)
            torch.cuda.synchronize()
            n_bad = int((got != want).sum())
            n += 1
            if n_bad:
                raise RuntimeError(f"dp_eh match input L1p={L1p} B={b} "
                                   f"ROWS={rows} (plan {p}): the kernel "
                                   f"differs from the plain version on "
                                   f"{n_bad} of {want.numel()}")
    return 0, n


def check(x: dict, p=None) -> int:
    """The largest |dp_eh - plain| over the inputs (make_inputs) at plan p
    (ops/dispatch_probe.Plan; None: the shipped plan), which is 0: raises
    when the kernel differs from its plain version."""
    import torch
    from bwamem_tpu_torch.ops import dispatch_probe as dp
    for label, (qT, tT) in [*((f"ROWS={r}", q) for r, q in x["rows"].items()),
                            ("pipe", x["pipe"])]:
        got, want = dp.dp_eh(qT, tT, p), dp.dp_eh_plain(qT, tT)
        torch.cuda.synchronize()
        n_bad = int((got != want).sum())
        if n_bad:
            raise RuntimeError(f"dp_eh {label} (plan {p}): the kernel "
                               f"differs from the plain version on {n_bad} "
                               f"of {want.numel()}")
    return 0


def probe(seed: int = 0, log=print) -> dict:
    """Runs the probe on the current CUDA device; returns dict(inputs=
    (make_inputs), rows={ROWS: dict(fetch_ms, ms, device_ms, plain_ms,
    bound_ms, bound_by)}, pipe={n: dict(enqueue_ms, fetch_ms,
    per_call_ms)}, issue={...: us a call}, issue_ms={...: ms between
    events}, d2h={shape: dict(pageable_ms, pinned_ms)}, h2d={shape:
    dict(pageable_ms, pinned_ms)}); raises when the kernel differs from its
    plain version."""
    import numpy as np
    import torch
    sys.path.insert(0, REPO)
    from bwamem_tpu_torch.ops import dispatch_probe as dp
    from bwamem_tpu_torch.ops import launch
    from torch_pl_gather_probe2 import device_ms, median_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    dev = torch.device("cuda")
    x = make_inputs(seed, dev)
    check(x)
    log(f"dp_eh equals its plain version on every output (L1p={L1P}, "
        f"B={B}, ROWS {ROWS_SWEEP} and the ROWS={PIPE_ROWS} pair)")

    log(f"=== (a) cost against ROWS (B={B}, fetch each) ===")
    rows = {}
    for r, (qT, tT) in x["rows"].items():
        call = lambda qT=qT, tT=tT: dp.dp_eh(qT, tT)          # noqa: E731
        b_ms, b_by = bound(*dp.work(L1P, r, B),
                           packed16=dp.plan(L1P, r, B).bits == 16)
        rows[r] = dict(fetch_ms=host_ms(lambda: call().cpu()),
                       ms=median_ms(call), device_ms=device_ms(call),
                       plain_ms=median_ms(lambda qT=qT, tT=tT:
                                          dp.dp_eh_plain(qT, tT)),
                       bound_ms=b_ms, bound_by=b_by)
        e = rows[r]
        log(f"ROWS={r:5d}: call + fetch {e['fetch_ms']:8.4f} ms, kernel "
            f"{e['ms']:8.4f} ms, on the device alone {e['device_ms']:8.4f} "
            f"ms, plain {e['plain_ms']:9.4f} ms, bound {b_ms:.6f} ms "
            f"({b_by}), device / bound {e['device_ms'] / b_ms:.1f}")

    log(f"=== (b) enqueue n, then fetch each (ROWS={PIPE_ROWS}) ===")
    qT, tT = x["pipe"]
    pipe = {}
    for n in PIPE_N:
        runs = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = [dp.dp_eh(qT, tT) for _ in range(n)]
            t1 = time.perf_counter()
            for o in outs:
                o.cpu()
            t2 = time.perf_counter()
            runs.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3))
        te, tf = sorted(runs, key=sum)[len(runs) // 2]
        pipe[n] = dict(enqueue_ms=te, fetch_ms=tf, per_call_ms=(te + tf) / n)
        log(f"n={n:3d}: enqueue {te:8.4f} ms  fetch {tf:8.4f} ms  total/call "
            f"{(te + tf) / n:8.4f} ms")
    q8, t8 = x["rows"][ROWS_SWEEP[0]]
    out, args = dp._prep(q8, t8)
    buf = torch.empty_like(q8)
    index = q8.get_device()

    def old_lookup():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream
    if old_lookup() != launch.raw_stream(index):
        raise RuntimeError("launch.raw_stream differs from the current "
                           "stream's handle")
    parts = {"wrapper dp_eh (ROWS=8)": lambda: dp.dp_eh(q8, t8),
             "  _prep: checks, torch.empty": lambda: dp._prep(q8, t8),
             "  stream lookup (launch.raw_stream)": lambda:
                 launch.raw_stream(index),
             "  device check (current_device())":
                 torch.cuda.current_device,
             "  _launch: check, lookup, ctypes, launch": lambda: dp._launch(
                 out, args),
             "old lookup (device context, current_stream)": old_lookup,
             "  (current_stream() alone)": lambda:
                 torch.cuda.current_stream().cuda_stream,
             "torch op: qT + 1": lambda: q8 + 1,
             "torch op: torch.add(qT, 1, out=)": lambda: torch.add(
                 q8, 1, out=buf)}
    issue = {k: issue_us(fn) for k, fn in parts.items()}
    issue_ms = {k: median_ms(parts[k]) for k in
                ("wrapper dp_eh (ROWS=8)", "torch op: qT + 1")}
    for k, us in issue.items():
        log(f"issue {k:44s} {us:8.2f} us a call (host clock, "
            f"{ISSUE_CALLS} calls)")
    for k, ms in issue_ms.items():
        log(f"events {k:43s} {ms:8.4f} ms a call")
    wrap, op = issue["wrapper dp_eh (ROWS=8)"], issue["torch op: qT + 1"]
    look = issue["  stream lookup (launch.raw_stream)"]
    log(f"the port's issue path takes {wrap / op:.2f} times a PyTorch op's "
        f"host time; the stream lookup is {look / wrap:.2f} of it")

    log("=== (c) D2H against size (a * 2, then a fetch) ===")
    d2h = {}
    for shape in COPY_SHAPES:
        y = torch.ones(shape, dtype=torch.int32, device=dev)
        pin = torch.empty(shape, dtype=torch.int32, pin_memory=True)

        def pinned(y=y, pin=pin):
            pin.copy_(y * 2, non_blocking=True)
            torch.cuda.synchronize()
        d2h[shape] = dict(pageable_ms=host_ms(lambda y=y: (y * 2).cpu()),
                          pinned_ms=host_ms(pinned))
        nb = shape[0] * shape[1] * 4
        log(f"{shape}: pageable {d2h[shape]['pageable_ms']:8.4f} ms, pinned "
            f"{d2h[shape]['pinned_ms']:8.4f} ms ({nb / 1e6:.2f} MB)")

    log("=== (d) H2D against size (a completed copy) ===")
    h2d = {}
    for shape in COPY_SHAPES:
        h = torch.from_numpy(np.zeros(shape, np.int32))
        hp = h.pin_memory()

        def pageable(h=h):
            h.to(dev)
            torch.cuda.synchronize()

        def pinned(hp=hp):
            hp.to(dev, non_blocking=True)
            torch.cuda.synchronize()
        h2d[shape] = dict(pageable_ms=host_ms(pageable),
                          pinned_ms=host_ms(pinned))
        nb = shape[0] * shape[1] * 4
        log(f"{shape}: pageable {h2d[shape]['pageable_ms']:8.4f} ms, pinned "
            f"{h2d[shape]['pinned_ms']:8.4f} ms ({nb / 1e6:.2f} MB)")
    return dict(inputs=x, rows=rows, pipe=pipe, issue=issue,
                issue_ms=issue_ms, d2h=d2h, h2d=h2d)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_dispatch_probe: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "bwamem_tpu_torch")):
        print("torch_dispatch_probe: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    probe()
    return 0


if __name__ == "__main__":
    sys.exit(main())
