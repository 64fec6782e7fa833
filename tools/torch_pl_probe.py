#!/usr/bin/env python3
"""The row-body ablation probe, priced on a GPU.

    python3 tools/torch_pl_probe.py [B] [LQ] [ROWS]

The counterpart of tools/pl_probe.py (the TPU probe), with its defaults
B = 2048 lanes, LQ = 128 query bases (L1p = 136 rows) and ROWS = 128
target rows: the hand-written CUDA kernel plp_row of ops/pl_probe for each
of the five variants at its shipped plan (noscan, noreduce, full: a group
of threads a lane, the rows in registers; roll: a warp a lane, several
rows a thread; eh_only: rows of lanes a thread), on qT and tT drawn with
numpy as the TPU script draws them (with seed 0 they are its inputs).
For each variant the kernel's out and aux must equal its plain version's
before anything is timed (a difference exits non-zero); then it prints
the time of a call
with its fetch (the script's number), between CUDA events and on the
device alone (`device_ms`: the events and the launch are queued behind a
1 ms spin of the card), the script's columns from the device time (us a
row-tile of 128 lanes, us a lane), the bound by int32 operations a cell
(ops/pl_probe.OPS_PER_CELL) or bytes, and the plain version's time.  No
PyTorch call computes the row body, so there is no library time.  The
card's name and power limit are printed first.  Needs a CUDA device and a
checkout of the repository; exits non-zero without either.
"""
from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
DEFAULT_B, DEFAULT_LQ, DEFAULT_ROWS = 2048, 128, 128
TB = 128                    # the TPU script's lanes a tile


def draw(seed: int, L1p: int, B: int, ROWS: int, kind: str = "probe"):
    """(qT int32 [L1p, B], tT int32 [ROWS, B]) as numpy arrays of bases in
    [0, 4).  "probe" draws them as the TPU script does.  On those, a
    lane's states fall to 0 within a few target rows and stay there (a
    mismatch costs 4, a match gains 1), so noreduce, full and roll end
    with out all 0 and aux the same in every lane.  "match" then reads
    each lane's target rows from its query along a diagonal that starts
    at a random row from 1 and stays inside the query where ROWS allows,
    one base in ten changed: states grow as in an alignment and spread
    below the diagonal, so the scan, the shift and the reductions all
    decide the result."""
    import numpy as np
    rng = np.random.default_rng(seed)
    qT = rng.integers(0, 4, (L1p, B)).astype(np.int32)
    tT = rng.integers(0, 4, (ROWS, B)).astype(np.int32)
    if kind == "match":
        off = rng.integers(1, max(2, L1p - ROWS + 1), B)
        rows = (np.arange(ROWS)[:, None] + off) % L1p
        keep = rng.random((ROWS, B)) >= 0.1
        tT = np.where(keep, np.take_along_axis(qT, rows, 0), tT)
    return qT, tT.astype(np.int32)


def make_inputs(seed: int, B: int, LQ: int, ROWS: int, device,
                kind: str = "probe"):
    """draw(...) at L1p = l1p_of(LQ), as tensors on `device`."""
    import torch
    from bwamem_tpu_torch.ops import pl_probe as plp
    return tuple(torch.from_numpy(a).to(device)
                 for a in draw(seed, plp.l1p_of(LQ), B, ROWS, kind))


def max_err(qT, tT, variant: str, LQ: int, p=None) -> int:
    """Largest |kernel - plain| over out and aux of one call, at plan p
    (ops/pl_probe.Plan; None: the shipped plan)."""
    import torch
    from bwamem_tpu_torch.ops import pl_probe as plp
    got = plp.plp_row(qT, tT, variant, LQ, p)
    want = plp.plp_plain(qT, tT, variant, LQ)
    torch.cuda.synchronize()
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(got, want))


def probe(B: int = DEFAULT_B, LQ: int = DEFAULT_LQ, ROWS: int = DEFAULT_ROWS,
          seed: int = 0, log=print) -> dict:
    """Runs the probe on the current CUDA device; returns dict(inputs=(qT,
    tT), LQ=LQ, results={variant: dict(max_abs_err, fetch_ms, ms,
    device_ms, us_row_tile, us_lane, bound_ms, bound_by, plain_ms)});
    raises when a variant differs from its plain version."""
    import torch
    sys.path.insert(0, REPO)
    from bwamem_tpu_torch.ops import pl_probe as plp
    from torch_dispatch_probe import bound, host_ms
    from torch_pl_gather_probe2 import device_ms, median_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"card: {smi.stdout.strip().splitlines()[0]}")
    qT, tT = make_inputs(seed, B, LQ, ROWS, torch.device("cuda"))
    L1p = qT.shape[0]
    tiles = -(-B // TB) * ROWS
    log(f"B={B} LQ={LQ} L1p={L1p} ROWS={ROWS} row-tiles={tiles}")
    errs = {v: max_err(qT, tT, v, LQ) for v in plp.VARIANTS}
    if any(errs.values()):
        raise RuntimeError(f"plp_row differs from its plain version: {errs}")
    log("every variant equals its plain version on out and aux")
    results = {}
    for v in plp.VARIANTS:
        call = lambda v=v: plp.plp_row(qT, tT, v, LQ)         # noqa: E731
        dev = device_ms(call)
        b_ms, b_by = bound(*plp.work(v, L1p, ROWS, B))
        r = dict(max_abs_err=errs[v],
                 fetch_ms=host_ms(lambda: call()[0].cpu()),
                 ms=median_ms(call), device_ms=dev,
                 us_row_tile=dev * 1e3 / tiles, us_lane=dev * 1e3 / B,
                 bound_ms=b_ms, bound_by=b_by,
                 plain_ms=median_ms(lambda v=v: plp.plp_plain(qT, tT, v,
                                                              LQ)))
        results[v] = r
        log(f"{v:10s} call + fetch {r['fetch_ms']:8.4f} ms, kernel "
            f"{r['ms']:8.4f} ms, device {dev:8.4f} ms  "
            f"{r['us_row_tile']:7.4f} us/row-tile  {r['us_lane']:7.4f} "
            f"us/lane, bound {b_ms:.6f} ms ({b_by}), device / bound "
            f"{dev / b_ms:.1f}, plain {r['plain_ms']:9.4f} ms")
    return dict(inputs=(qT, tT), LQ=LQ, results=results)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_pl_probe: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "bwamem_tpu_torch")):
        print("torch_pl_probe: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    args = [int(a) for a in sys.argv[1:4]]
    probe(*args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
