"""Watchdog for blocking device fetches: no code path may wait forever.

The reference checks every launch and bails on error instead of
deadlocking (cuda/errHandler.cuh:7-19).  A CUDA error raises in the copy
that follows it, but a kernel that never finishes (a wait that is never
satisfied, a loop that does not end) makes the copy block forever with no
error at all.  So every blocking device-to-host copy of the fronts runs in
a daemon worker thread while the caller waits with a timeout.  On expiry
the worker is abandoned (a daemon thread does not keep the process alive)
and FetchTimeout is raised: the device front then hands the batch to the
host-compacted front and stays off for the rest of the process
(pipeline/device_front.front_finish).

A timeout is evidence the device may be unhealthy: device_suspect() tells
so for the rest of the process.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading

import torch

from bwamem_tpu_torch.ops import launch

# Well above the slowest legitimate fetch: a fetch waits for every kernel
# queued before it, and a front dispatch of a long-read batch runs for
# minutes on the plain versions.  <= 0 turns the guard off.
DEFAULT_TIMEOUT = float(os.environ.get("BWAMEM_TPU_FETCH_TIMEOUT", "900"))

_suspect = False


class FetchTimeout(RuntimeError):
    pass


def device_suspect() -> bool:
    """True once any fetch has timed out in this process."""
    return _suspect


def _copy(tensors) -> list:
    """The copies themselves: each tensor as a host numpy array."""
    return [t.cpu().numpy() for t in tensors]


def fetch(tensors, *, timeout: float | None = None,
          what: str = "fetch") -> list:
    """Copy a list of tensors to the host with a watchdog.

    Returns [np.ndarray, ...] in order.  Raises FetchTimeout after
    `timeout` seconds (default DEFAULT_TIMEOUT, BWAMEM_TPU_FETCH_TIMEOUT;
    <= 0 copies on the caller's thread with no guard).  The worker copies
    on the caller's current stream of each device, so it waits for the
    same kernels the caller's own copy would."""
    global _suspect
    timeout = DEFAULT_TIMEOUT if timeout is None else timeout
    tensors = list(tensors)
    if timeout <= 0:
        return _copy(tensors)
    streams = launch.caller_streams({t.device for t in tensors
                                     if t.device.type == "cuda"})
    out: list = [None]
    err: list = [None]

    def work():
        try:
            with contextlib.ExitStack() as st:
                for s in streams.values():
                    st.enter_context(torch.cuda.stream(s))
                out[0] = _copy(tensors)
        except BaseException as e:       # surfaced to the caller
            err[0] = e

    t = threading.Thread(target=work, daemon=True, name=f"fetch:{what}")
    t.start()
    t.join(timeout)
    if t.is_alive():
        _suspect = True
        print(f"[bwamem_tpu_torch] WATCHDOG: device fetch '{what}' exceeded "
              f"{timeout:.0f}s; abandoning it", file=sys.stderr, flush=True)
        raise FetchTimeout(what)
    if err[0] is not None:
        raise err[0]
    return out[0]
