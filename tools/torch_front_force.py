"""The device front's first-dispatch arena sizes, forced, to drive its
grow-and-retry loop and its bail-out to the host front.

Both fronts size their arenas in `_sizes_for` (bwamem_tpu_torch/pipeline/
device_front.py, bwamem_tpu/pipeline/device_front.py); `sized` rewrites
what it returns:

  how="small"   every arena of SMALL_ARENAS starts there, small enough
                that a batch of 96 short reads (or 48 pairs) overflows
                them: the front grows and reruns, and converges;
  how="pinned"  the item arena (a_it) stays at PINNED_A_IT whatever
                growth asks for: growth cannot converge, and the front
                bails after its retries.

`forced_front(how)` patches the port's `_sizes_for` for the length of a
with-block.  Imports neither package at module level.
"""
from __future__ import annotations

from contextlib import contextmanager

SMALL_ARENAS = dict(kmax=64, emax=32, a_seed=64, a_ch=32, a_it=64, cap=32)
PINNED_A_IT = 64


class PinnedItemArena(dict):
    """Arena sizes whose item arena stays at PINNED_A_IT whatever growth
    asks for."""

    def __init__(self, sizes):
        super().__init__(sizes)
        self["a_it"] = PINNED_A_IT

    def __setitem__(self, key, value):
        super().__setitem__(key, PINNED_A_IT if key == "a_it" else value)


def sized(sizes: dict, how: str) -> dict:
    """`sizes` as `_sizes_for` returned them, forced as `how` says."""
    if how == "small":
        return {**sizes, **SMALL_ARENAS}
    if how == "pinned":
        return PinnedItemArena(sizes)
    raise ValueError(f"how must be 'small' or 'pinned', got {how!r}")


@contextmanager
def forced_front(how: str):
    """The port's device front with its first-dispatch sizes forced."""
    from bwamem_tpu_torch.pipeline import device_front
    orig = device_front._sizes_for
    device_front._sizes_for = lambda hist, N, Lr: sized(orig(hist, N, Lr),
                                                        how)
    try:
        yield
    finally:
        device_front._sizes_for = orig
