"""Lane-count shape policy.

PyTorch runs eagerly: a new shape costs no compile, and every padded lane
is real work for the plain tensor programs (the hand-written kernels skip a
lane with qlen == tlen == 0 at once).  So lane counts snap to snug
power-of-2 buckets on every device; only the floor differs — on a card a
dispatch below a few hundred lanes leaves most of it idle anyway, and the
larger floor keeps the set of tensor sizes the caching allocator sees
small.  No result depends on a bucket: padded lanes are masked.
"""
from __future__ import annotations

import torch


def pow2_bucket(x: int, lo: int) -> int:
    n = lo
    while n < x:
        n <<= 1
    return n


def lanes(x: int, device: torch.device, *, fine_lo: int,
          coarse_lo: int, shards: int = 1) -> int:
    """Batch-lane bucket: power of 2 from `fine_lo` on the CPU, from
    `coarse_lo` on a card, and from `shards` under a mesh of that many
    shards (a power of two), so that every shard gets lanes."""
    lo = fine_lo if device.type == "cpu" else coarse_lo
    return pow2_bucket(x, max(lo, shards))


# The plain tensor programs (ops/extend.extend_batch, ops/local_sw) carry
# about twenty [lanes, columns] int32 temporaries per row trip; tiling the
# lanes bounds that working set whatever the batch holds.
LANE_TILE = 2048


def lane_tile(device: torch.device) -> int:
    """Lane tile of a plain tensor program: LANE_TILE on the CPU; eight
    times that on a card, where the temporaries of a tile are still tens
    of MB and every row trip's launches are paid once per tile."""
    return LANE_TILE if device.type == "cpu" else 8 * LANE_TILE


# The extension kernels keep two [columns, lanes] int32 scratch planes and
# read materialized [rows, lanes] query/target blocks; their lane tiles may
# be larger because a lane costs one thread, not a row of every temporary.
# pipeline/extend_host.py narrows the tile further for long classes.
PL_LANE_TILE = 8192


def chunks(n: int, tile: int = LANE_TILE):
    """Yield (start, size) covering range(n) in tiles of at most `tile`."""
    s = 0
    while s < n:
        c = min(tile, n - s)
        yield s, c
        s += c
