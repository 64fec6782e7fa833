"""The port's tracer: stage sections, device sections, counters and gauges.

Off by default, and then free: `section` and `device_section` return one
shared no-op context manager, `start` returns None, and `count` and
`gauge` return at once; nothing is allocated or recorded.  Enable with
BWAMEM_TPU_TIMERS=1 or timers.enable().

When on:
- `section(name)` (a with-block) and `start(name)`/`stop(name, token)`
  (a span that cannot be one block) each record a span
  (name, start_ns, end_ns, parent) on time.time_ns's clock, the clock of
  torch.profiler's device events, so spans line up with a device trace.
  `parent` is the index in `spans()` of the innermost span open when it
  started (None at the top).  `snapshot()` keeps the totals by name,
  (count, seconds).
- `device_section(name, device)` is a section that also times the device:
  on a CUDA device it records a CUDA event pair on the current stream at
  entry and exit.  A pair measures the stream's time from reaching the
  section's work to finishing it: its kernels plus the gaps in which the
  card waited for the host's next launch.  Set against the same
  section's host time, it tells whether the work is bound by its issue
  (host time near the pair's, the card waiting) or by the device (the
  pair longer).  Pairs are read once complete (`Event.query`), when the
  next device section opens, and the rest by `snapshot()` and `spans()`,
  which wait for them: call those after the window, never inside it.
  `snapshot()` gives them as `<name>.gpu` = (count, seconds).
- `count(name, k)` adds to a counter (`<name>.count` in `snapshot()`);
  `gauge(name, v)` keeps the last and the largest value
  (`<name>.gauge` = (last, max)).

`report()` is a table of all of it; `reset()` clears it.  At most
MAX_SPANS spans are kept; past that the totals go on and
`timers.spans_dropped` counts the spans not kept.
"""
from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import nullcontext

MAX_SPANS = 1 << 20

_enabled = bool(int(os.environ.get("BWAMEM_TPU_TIMERS", "0") or 0))
_acc: dict[str, list] = defaultdict(lambda: [0, 0.0])   # name -> [n, secs]
_gpu: dict[str, list] = defaultdict(lambda: [0, 0.0])   # name -> [n, secs]
_counts: dict[str, int] = defaultdict(int)              # name -> count
_gauges: dict[str, list] = {}                           # name -> [last, max]
_spans: list[list] = []         # [name, start_ns, end_ns, parent]
_open: list[tuple] = []         # (record, its index) of open spans
_pending: list[tuple] = []      # (name, start event, end event) in flight
_NOOP = nullcontext()


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enabled() -> bool:
    return _enabled


def reset() -> None:
    _acc.clear()
    _gpu.clear()
    _counts.clear()
    _gauges.clear()
    _spans.clear()
    _open.clear()
    _pending.clear()


def _begin(name: str) -> list:
    rec = [name, time.time_ns(), None, _open[-1][1] if _open else None]
    if len(_spans) < MAX_SPANS:
        _open.append((rec, len(_spans)))
        _spans.append(rec)
    else:
        _counts["timers.spans_dropped"] += 1
    return rec


def _end(rec: list) -> None:
    rec[2] = t1 = time.time_ns()
    for k in range(len(_open) - 1, -1, -1):
        if _open[k][0] is rec:
            del _open[k]
            break
    a = _acc[rec[0]]
    a[0] += 1
    a[1] += (t1 - rec[1]) / 1e9


class _Section:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = _begin(self.name)

    def __exit__(self, *exc):
        _end(self.rec)


def section(name: str):
    return _Section(name) if _enabled else _NOOP


def start(name: str):
    """Opens a span that stop() closes, for sections that cannot be a
    `with` block.  Returns None when disabled, so a mid-section enable()
    cannot record a bogus duration (stop() skips on None)."""
    return _begin(name) if _enabled else None


def stop(name: str, token) -> None:
    if token is not None:
        _end(token)


class _DeviceSection:
    __slots__ = ("name", "host", "dev", "stream", "ev0")

    def __init__(self, name: str, device):
        self.name = name
        # the module's section at call time, so a wrapper put in its
        # place sees device sections too
        self.host = section(name)
        self.dev = device if getattr(device, "type", None) == "cuda" else None

    def __enter__(self):
        if self.dev is not None:
            _resolve(wait=False)
        self.host.__enter__()
        if self.dev is not None:
            import torch

            from bwamem_tpu_torch.ops import launch
            self.stream = launch.caller_streams([self.dev])[self.dev]
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record(self.stream)

    def __exit__(self, exc_type, *exc):
        try:
            if self.dev is not None and exc_type is None:
                import torch
                ev1 = torch.cuda.Event(enable_timing=True)
                ev1.record(self.stream)
                _pending.append((self.name, self.ev0, ev1))
        finally:
            self.host.__exit__(exc_type, *exc)


def device_section(name: str, device):
    """A section whose work is enqueued on `device` (a torch.device); on
    a CUDA device its stream time is kept as `<name>.gpu` (module
    docstring).  Elsewhere it is a section alone."""
    return _DeviceSection(name, device) if _enabled else _NOOP


def _resolve(wait: bool) -> None:
    """Adds the device time of each pair in flight that has completed (of
    every pair with `wait`, after waiting for it) to `_gpu`."""
    keep = []
    for name, ev0, ev1 in _pending:
        if wait:
            ev1.synchronize()
        elif not ev1.query():
            keep.append((name, ev0, ev1))
            continue
        g = _gpu[name]
        g[0] += 1
        g[1] += ev0.elapsed_time(ev1) / 1e3
    _pending[:] = keep


def count(name: str, k: int = 1) -> None:
    """Event counter: device-program dispatches, rows, retries."""
    if _enabled:
        _counts[name] += int(k)


def gauge(name: str, value) -> None:
    """Keeps the last and the largest value given under `name`."""
    if _enabled:
        g = _gauges.get(name)
        if g is None:
            _gauges[name] = [value, value]
        else:
            g[0] = value
            if value > g[1]:
                g[1] = value


def spans() -> list[tuple]:
    """The kept spans in the order they opened: (name, start_ns, end_ns,
    parent), end_ns None for a span still open."""
    _resolve(wait=True)
    return [tuple(r) for r in _spans]


def report() -> str:
    _resolve(wait=True)
    rows = []
    for src, tag in ((_acc, ""), (_gpu, ".gpu")):
        for name in sorted(src):
            n, s = src[name]
            rows.append(f"{name + tag:<32} n={n:<6} total={s * 1e3:9.1f} "
                        f"ms  avg={s / max(n, 1) * 1e3:8.2f} ms")
    for name in sorted(_counts):
        rows.append(f"{name:<32} count={_counts[name]}")
    for name in sorted(_gauges):
        last, mx = _gauges[name]
        rows.append(f"{name:<32} last={last} max={mx}")
    return "\n".join(rows)


def snapshot() -> dict:
    _resolve(wait=True)
    out = {k: tuple(v) for k, v in _acc.items()}
    out.update({k + ".gpu": tuple(v) for k, v in _gpu.items()})
    out.update({k + ".count": _counts[k] for k in _counts})
    out.update({k + ".gauge": tuple(v) for k, v in _gauges.items()})
    return out
