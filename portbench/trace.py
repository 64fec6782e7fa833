"""Reduction of a device trace and of host spans to the per-layer inputs.

Device intervals are (name, start_ns, end_ns) on the profiler's clock,
which for torch.profiler's kineto events is the epoch (time.time_ns);
host spans are (name, start_ns, end_ns) taken on the same clock by the
benchmark.
"""
from __future__ import annotations

import numpy as np

COPY_PREFIXES = ("Memcpy", "Memset")


def device_events(prof, kind: str = "cuda"):
    """(names, start_ns, end_ns) of every operation that ran on a device
    of type `kind` ("cuda"; "cpu" in the CPU tests) in a finished
    torch.profiler.profile: a list and two int64 arrays."""
    want = kind.upper()
    names, st, du = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type().name != want:
            continue
        names.append(e.name())
        st.append(e.start_ns())
        du.append(e.duration_ns())
    s = np.array(st, np.int64)
    return names, s, s + np.array(du, np.int64)


def union(ivs: np.ndarray, w0: int, w1: int) -> np.ndarray:
    """Disjoint sorted [start, end) intervals covering ivs clipped to
    [w0, w1]; ivs is int64 [n, 2]."""
    if not len(ivs):
        return np.zeros((0, 2), np.int64)
    a = np.clip(ivs, w0, w1)
    a = a[a[:, 1] > a[:, 0]]
    if not len(a):
        return np.zeros((0, 2), np.int64)
    a = a[np.argsort(a[:, 0], kind="stable")]
    ends = np.maximum.accumulate(a[:, 1])
    new = np.concatenate([[True], a[1:, 0] > ends[:-1]])
    starts = a[new, 0]
    idx = np.flatnonzero(new)
    stops = ends[np.concatenate([idx[1:] - 1, [len(a) - 1]])]
    return np.stack([starts, stops], 1)


def gaps(busy: np.ndarray, w0: int, w1: int) -> np.ndarray:
    """The idle [start, end) intervals of [w0, w1] between busy ones."""
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    return edges[edges[:, 1] > edges[:, 0]]


def innermost(spans: list[tuple[str, int, int]], t: np.ndarray,
              default: str) -> list[str]:
    """Name of the innermost span covering each time t (sorted or not):
    spans nest, so of the spans that cover t, the one that starts last."""
    order = np.argsort(t, kind="stable")
    ts = t[order]
    lab = np.full(len(t), -1, np.int64)
    names = []
    for k, (name, s, e) in enumerate(sorted(spans, key=lambda x: x[1])):
        lo, hi = np.searchsorted(ts, [s, e], side="left")
        lab[lo:hi] = k
        names.append(name)
    out = [default] * len(t)
    for i, k in zip(order, lab):
        if k >= 0:
            out[i] = names[k]
    return out


def reduce(events, w0: int, w1: int, spans: list[tuple[str, int, int]],
           top: int = 10) -> dict:
    """busy_s, window_s, kernel launches and time by name, and the idle
    time by the host span covering it, over the window [w0, w1].
    `events` is device_events' (names, starts, ends)."""
    names, st, en = events
    keep = (en > w0) & (st < w1)
    idx = np.flatnonzero(keep)
    s, e = st[idx], en[idx]
    busy = union(np.stack([s, e], 1), w0, w1)
    busy_ns = int((busy[:, 1] - busy[:, 0]).sum())
    uniq, inv = np.unique(np.array([names[i] for i in idx], dtype=object),
                          return_inverse=True)
    dur = (np.minimum(e, w1) - np.maximum(s, w0)) / 1e9
    by_name = dict(zip(uniq.tolist(), np.bincount(inv, dur,
                                                  len(uniq)).tolist()))
    counts = np.bincount(inv, minlength=len(uniq))
    launches = int(sum(c for n, c in zip(uniq, counts)
                       if not n.startswith(COPY_PREFIXES)))
    idle = gaps(busy, w0, w1)
    by_label: dict[str, float] = {}
    if len(idle):
        mids = (idle[:, 0] + idle[:, 1]) // 2
        for lab, (a, b) in zip(innermost(spans, mids, "driver"), idle):
            by_label[lab] = by_label.get(lab, 0.0) + (b - a) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idl = sorted(by_label.items(), key=lambda kv: -kv[1])[:top]
    return dict(busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
                events=len(names), inside=len(idx),
                lead_s=((s.min() if len(s) else w0) - w0) / 1e9,
                tail_s=(w1 - (e.max() if len(e) else w1)) / 1e9,
                launches=launches, kernel_s=by_name,
                device_ops=[[n[:160], v] for n, v in ops],
                idle_gaps=[[n, v] for n, v in idl])
