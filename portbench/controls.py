"""Readings the limits of a cell's check are set from, in one process.

    python3 portbench/controls.py --workload <cell> --seeds 11,12,... \
        [--batches 2] [--control-seeds 4]

One set-up (the cell's genome, the program's index and Aligner, as a run
makes them); then for each seed the cell's traffic from that seed, its
first --batches batches aligned through align_stream at the cell's batch
size, and the window's SAM judged by portbench/ref/check.py:
- "program": the SAM as the program wrote it (the lower readings);
- "control.local": the reference in the program's place with the
  clipping rule dropped (every end clipped where that scores higher):
  the guarantee the configuration states on clipping, broken;
- "control.int8": the reference in the program's place with its cells in
  saturating int8, the lower precision of the extension's scores;
- "fault.half": the records of the second half of every batch left out;
- "fault.altered": every 50th read's primary record moved one base on;
- "fault.score": every 20th read's primary record with AS one lower;
- "fault.strand": every 50th read's primary record with its strand bit
  (0x10) flipped;
- "fault.mapq": every 20th read's mapped primary record with MAPQ one
  higher.
The first --control-seeds seeds read the controls and faults too.  One
JSON line a seed and reading on stdout.  The benchmark's own runs do
not run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness  # noqa: E402
from portbench.gen import reads as gen_reads  # noqa: E402
from portbench.ref import check  # noqa: E402


def drop_half(sams):
    return [[t if i < len(b) // 2 else "" for i, t in enumerate(b)]
            for b in sams]


def shift_pos(text: str) -> str:
    out = []
    for ln in text.split("\n"):
        f = ln.split("\t")
        if len(f) > 3 and not int(f[1]) & 0x904:
            f[3] = str(int(f[3]) + 1)
        out.append("\t".join(f))
    return "\n".join(out)


def lower_as(text: str) -> str:
    out = []
    for ln in text.split("\n"):
        f = ln.split("\t")
        if len(f) > 3 and not int(f[1]) & 0x904:
            f = [f"AS:i:{int(x[5:]) - 1}" if x.startswith("AS:i:") else x
                 for x in f]
        out.append("\t".join(f))
    return "\n".join(out)


def flip_strand(text: str) -> str:
    out = []
    for ln in text.split("\n"):
        f = ln.split("\t")
        if len(f) > 3 and not int(f[1]) & 0x900:
            f[1] = str(int(f[1]) ^ 0x10)
        out.append("\t".join(f))
    return "\n".join(out)


def raise_mapq(text: str) -> str:
    out = []
    for ln in text.split("\n"):
        f = ln.split("\t")
        if len(f) > 4 and not int(f[1]) & 0x904:
            f[4] = str(int(f[4]) + 1)
        out.append("\t".join(f))
    return "\n".join(out)


def every(fn, k: int):
    def fault(sams):
        return [[fn(t) if i % k == 0 else t for i, t in enumerate(b)]
                for b in sams]
    return fault


FAULTS = {"fault.half": drop_half, "fault.altered": every(shift_pos, 50),
          "fault.score": every(lower_as, 20),
          "fault.strand": every(flip_strand, 50),
          "fault.mapq": every(raise_mapq, 20)}


def readings(spec, g, al, seed: int, n_batches: int, paired: bool,
             controls: bool = True):
    """{reading: numbers} for one seed (the program's alone unless
    `controls`)."""
    traffic, runcfg, cfg = spec["traffic"], spec["run"], spec["config"]
    n_b = gen_reads.batch_reads(traffic)
    pool = []
    for k in range(n_batches):
        b = gen_reads.make_batch(g, traffic, seed, 1 + k, n_b, k * n_b)
        pool.append((b, harness.to_reads(b, paired)))
    issued, sams, secs = harness.window(al, pool, None, paired)
    n = sum(len(b.seqs) for b in issued)
    names = [harness.read_names(b, paired) for b in issued]
    sample = harness.sample_reads(seed, n, int(runcfg["check_reads"]),
                                  paired)
    out = {}
    t0 = time.perf_counter()
    args = (issued, names, g, cfg["aligner"], paired, sample)
    out["program"] = check.judge(sams, *args)
    out["program"]["ref_s"] = time.perf_counter() - t0
    out["program"]["reads_per_s"] = n / secs
    if not controls:
        return out
    for c in ("local", "int8"):
        out["control." + c] = check.judge(sams, *args, control=c)
    for k, f in FAULTS.items():
        out[k] = check.judge(f(sams), *args)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--control-seeds", type=int, default=4,
                    help="seeds (the first ones) that also read the "
                         "controls and faults")
    a = ap.parse_args(argv)
    spec = harness.cell_spec(harness.ROOT, a.workload)
    paired = bool(spec["traffic"]["paired"])
    cdir = harness.cache_dir(spec)
    os.makedirs(cdir, exist_ok=True)
    os.environ.pop("BWAMEM_TPU_HWM_DIR", None)
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.pipeline.align import Aligner
    g, prefix, _ = harness.genome_and_index(spec, cdir)
    al = Aligner(load_index(prefix), harness.options(spec["config"], paired),
                 device="cuda:0")
    for i, s in enumerate(a.seeds.split(",")):
        for k, v in readings(spec, g, al, int(s), a.batches, paired,
                             i < a.control_seeds).items():
            print(json.dumps(dict(cell=a.workload, seed=int(s), reading=k,
                                  **v)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
