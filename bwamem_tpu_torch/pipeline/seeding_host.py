"""Flat-lane compaction shared by the device front's programs."""
from __future__ import annotations

import torch


def _compact_flat(mask, fields, arena):
    """Compact flat lanes: mask [T] bool; fields [(flat tensor, dtype)].
    Returns (outs [arena], n, overflow, pos) — pos is the target slot per
    source lane (for scattering results back to the source grid).  Lanes
    past the arena are DROPPED (written to a spill slot that is cut off),
    so output is only valid when overflow is False — callers must retry
    with a bigger arena.  n and overflow stay 0-d device tensors."""
    pos = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    n_all = pos[-1] + 1
    over = n_all > arena
    tgt = torch.where(mask, torch.clamp(pos, max=arena - 1),
                      torch.full_like(pos, arena)).to(torch.int64)
    outs = []
    for a, dt in fields:
        o = torch.zeros(arena + 1, dtype=dt, device=mask.device)
        o[tgt] = a.reshape(-1).to(dt)
        outs.append(o[:arena])
    return outs, torch.clamp(n_all, max=arena), over, pos
