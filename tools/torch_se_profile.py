#!/usr/bin/env python3
"""Where the time of bwamem_tpu_torch's single-end path goes on a GPU.

    python3 tools/torch_se_profile.py [--read-len 101|1000|5000]
                                      [--out se_trace.json]

Uses chip_smoke.py's data sets (tools/se_smoke_data.py: a 5 Mbp genome with
2 x 8192 reads of 101 bp, 512 reads of 1000 bp or 128 reads of 5000 bp,
fixed seeds, cached under build/chip_smoke/).  Batch 0 runs unprofiled and
sizes the arenas; batch 1 (for the long reads: the same batch again) runs
under torch.profiler (CPU + CUDA activities).
Prints the wall time of batch 1, the device busy time (the union of the
CUDA kernel and memcpy intervals) and the idle share, the launch count,
the CUDA kernels with the most time, and the host timer sections.
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def busy_us(events) -> float:
    """Length of the union of [start, end) intervals, in microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--read-len", type=int, default=101,
                    choices=(101, 1000, 5000),
                    help="which of the smoke data sets to align")
    ap.add_argument("--out", default=None,
                    help="write a chrome trace of batch 1 here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_se_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import se_smoke_data as sd
    from torch.profiler import ProfilerActivity, profile
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import read_fastx
    from bwamem_tpu_torch.pipeline.align import Aligner
    from bwamem_tpu_torch.utils import timers

    prefix, fq = sd.smoke_data()
    if args.read_len == sd.READ_LEN:
        reads = list(read_fastx(fq))
        b0, b1 = reads[:sd.BATCH], reads[sd.BATCH:2 * sd.BATCH]
    else:
        b0 = b1 = list(read_fastx(sd.long_reads(args.read_len)))
    al = Aligner(load_index(prefix), device="cuda")
    al.align_batch_se(b0, 0)                     # sizes the arenas
    torch.cuda.synchronize()
    timers.reset()
    timers.enable(True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        al.align_batch_se(b1, len(b0))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    timers.enable(False)
    dev_events = [e for e in prof.events()
                  if e.device_type.name == "CUDA"]
    busy = busy_us(dev_events) / 1e6
    print(f"GPU {torch.cuda.get_device_name(0)}")
    print(f"batch 1: {len(b1)} reads, wall {wall:.4f} s, device busy "
          f"{busy:.4f} s, idle share {1 - busy / wall:.4f}, device events "
          f"{len(dev_events)}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15))
    print(timers.report())
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        prof.export_chrome_trace(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
