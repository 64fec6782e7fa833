#!/usr/bin/env python3
"""Smoke run of bwamem_tpu_torch on one NVIDIA GPU (an H100 is the target).

    python3 chip_smoke.py
    python3 chip_smoke.py --only chain [--cell chr1.pe150 --seed N]

Three phases; any failure exits non-zero without printing a result.
`--only chain` runs the chain kernel's phase alone (below, after the 101
bp path), its main-path input from the 5 Mbp smoke genome or, with
`--cell`, from three batches of a benchmark cell (portbench: the cell's
genome and index, built into portbench/.cache at a checkout's first use).

1. Environment: the card's name and power limit, then the build of every
   native source the paths below need (the CUDA extension kernels — one
   source holds both —, the FM probe kernels, the four gather-probe
   kernels and the chain kernel with nvcc for sm_90a, the host kernels and the suffix-array code
   with cc), all compilers started together; then the registers, spills
   and shared memory that ptxas reported for each instantiation of the
   extension kernels (G = 8, 16, 32; shared or global storage).  Then
   the card's int32 rate (tools/torch_int_rate.py: five mixes, each held
   against its plain version, timed on every SM, with ptxas's lines and
   the SASS mnemonics of each): the run fails if the card beats
   PEAK_INT32_OPS or PEAK_INT16X2_OPS, the peaks every bound by
   operations divides by.  Last, ptxas's registers and spills of the
   shipped plans of kernels #4 and #8; a spill fails the run.
1b. The launch path (bwamem_tpu_torch/ops/launch.py, through which every
   kernel launches): its raw stream handle equals
   torch.cuda.current_stream().cuda_stream on the default stream and
   inside torch.cuda.stream(side), and gp3_col0 launched inside `side`
   equals its plain version after side.synchronize().
2. Kernels against plain, on lanes made with numpy from a fixed seed:
   * ext_pl2_kernel (band-doubling retry in the lane): ~16k lanes shaped
     like the front's EXT lanes (query rows 128, target rows 256, default
     scoring; lanes that retry at the doubled band, empty queries and
     z-drop cuts included), all 7 outputs;
   * ext_pl_kernel (one pass at a per-lane band): the same 16k lanes with
     bands 100 and 200 alternating, ~1k long lanes (query rows 4095,
     target rows 4608, queries of 1000-4095 bases) and 256 over-long lanes
     (query rows 5000, target rows 5376, queries of 4096-5000 bases: past
     what the TPU kernel's packing held), all 6 outputs.
   * both kernels on 1024 ring-wrap lanes (queries of 1500-3000 bases
     against their mutated copy): the one-pass kernel at band 10, ext_pl2
     at w_opt 5 (w2 10): a ring of 32 columns that wraps about 90 times.
   A kernel must equal its plain PyTorch version; both are timed with
   CUDA events.  Each held call prints its plan (G, storage, ring R, lane
   area, dynamic shared memory a block), its time, band cells/s and
   times its bound.
2b. The gather-strategy probe (tools/torch_pl_gather_probe.py) at the TPU
   script's defaults (8192 lanes, 16 steps of the take, a table of 78208
   rows; tables from numpy with the smoke seed): gp_scalar and gp_scalar2
   (one pass each: the TPU kernels' passes only price one), gp_onehot and
   gp_take_ax0, each launched by the probe (counts from 0),
   then held against its plain version (max_abs_err 0) and reported with
   the probe's CUDA-event times (and on the device alone), its plain and
   library times (5b's library call two ops) and its bound; gp_onehot is
   also held on the CPU tests' inputs, where bf16 rounds and k lies
   outside the table and at both ends of int32
   (ops/gather_probe.onehot_inputs), at their size and at the probe's,
   and gp_scalar2 at row widths 2, 3, 7 and 8, at a table off an 8-byte
   boundary and on sums that wrap (check_scalar2: its 8-byte and its two
   4-byte loads).  gp_take_ax0 is also timed on a spread input (every row
   of kk its own start: its chains share no state; the probe's share one
   a column past the lanes' rows) and held on a table whose adds wrap
   (ops/gather_probe.take_inputs).
2c. Round 2 of the gather probe (tools/torch_pl_gather_probe2.py) at the
   TPU script's defaults (32 steps; B on [512,128], C on [128,128] and
   [8,128], D on 1024 lanes of a [78208,8] table, E with Q = 1024 and
   A = 640): gp2_take_ax0, gp2_take_ax1, gp2_col0 and gp2_onehot_f32 (the
   gather the TPU kernel's float32 one-hot product computes), the same way,
   each also timed on the device alone; gp2_onehot_f32 is also held on a
   small input past the probe's range (table values up to +-2^23, and in
   (2^24, 2^30) with float32 ties, where int32 -> float32 rounds; k at both
   ends of the table and outside it).  gp2_take_ax0 and gp2_take_ax1 (the
   kernels of csrc/line_pow.cuh, which gp3_dg launches too) are also
   held, with the designs they replaced, on tables from the CPU tests'
   ranges (adds that wrap past int32) after 0, 1, 5, 31, 32 and 33
   steps, at R 1, 5, 32, 33, 128, 129, 512 and 58112 (the warp-segment
   design and its edge, the block design's first, the warp-a-line
   design's one size, the block design past it, the probe's, and the
   wrapper's limit) and S 1, 8, 128 and 1000;
   ptxas's registers and spills of the shipped kernels printed (a spill
   fails the run); then each timed on the device alone in turns with the
   design it replaced on the probe's inputs
   (tools/torch_take2_variants.py, which alone times the other designs).
2d. Round 3 of the gather probe (tools/torch_pl_gather_probe3.py) at the
   TPU script's shapes (512 steps; the clipped chain on B8 [8,128] and B32
   [32,128] along axis 0 and C512 [128,512] along axis 1, the transpose
   chain on [128,128], 8 lanes of a [78208,8] table, 64 additions of
   rows :8 of a [1024,640] x [640,128] float32 product): gp3_dg, gp3_ct,
   gp3_col0 and gp3_mm, the same way, and the chains also on spread
   tables (values in [-hi, hi]: the probe's saturate after one step;
   gp3_dg timed there too) and gp3_dg on tables whose adds wrap,
   gp3_mm exact on integer-valued inputs and within its rounding bound on
   the probe's normal ones.  gp3_ct is timed on its spread input too
   (the chains keep moving there), held at N = 128, 139, 33 and 1 on the
   probe's, spread and wrapping tables after 0, 1 and 512 steps (at 128
   the cluster of 16 blocks, at the other N the one block), and timed
   on the device alone in turns with the design it replaced
   (tools/torch_ct_variants.py, which alone times the other designs).
   gp_take_ax0 and gp3_dg are held on the probe's, spread and wrapping
   inputs after 0, 1, 5 and 16 steps (5d, at the probe's R, where it
   takes its column design, and at R 1, 33, 1000, 109376 and 109377, the
   first R where it takes a thread an element) and 0, 1, 37, 511 and 512
   (7A, its three shapes and lines of 1, 5, 128, 40, 1000 and 2000 words:
   the warp-segment, warp-a-line and block designs, each at both axes),
   ptxas's registers and spills of both shipped designs printed (a spill
   fails the run), then each timed on the device alone in turns with the
   design it replaced on the probe's and the spread input
   (tools/torch_dg_variants.py, which alone times the other designs).
   The column-0 gathers of 2c and 2d (D, gp2_col0, and gp3_col0: one
   kernel, csrc/col0.cuh) are timed as 200 back-to-back calls, on the
   device alone and on the host clock, in turns with tab[k, 0]; then
   both wrappers are held against the plain version at 1, 8, 33 and 1024
   lanes of tables 1, 3 and 8 words wide and on 64-launch chains where
   each launch reads the last one's output, and timed in turns beside the
   design they replaced and tab[k, 0] (tools/torch_col0_variants.py).
2e. The dispatch probe (tools/torch_dispatch_probe.py) and the row-body
   ablation probe (tools/torch_pl_probe.py) at the TPU scripts' shapes and
   inputs (seed 0): dp_eh on qT [136,2048] at ROWS 8, 128, 512 and 2048,
   the enqueue-then-fetch queue, the port's issue path against a PyTorch
   op, and D2H and H2D copies of 1x256 to 1024x8192 int32 from pageable
   and pinned memory; plp_row's five variants at B = 2048, LQ = ROWS = 128.
   Both launched by the probes (counts from 0), then held against their
   plain versions (max_abs_err 0, plp_row's aux too) on the probes'
   inputs (dp_eh at its shipped plan and with 32-bit and 16x2 cells),
   and plp_row once more on a shape of its own (B = 1000, LQ = 101,
   ROWS = 96: neither a multiple of the TPU's tiles).  The probe's
   inputs decay to state 0, so plp_row is also held at both shapes on a
   "match" input (target rows copied from the query along a diagonal)
   whose states grow, with out's max over 20 and aux varying across
   lanes required, and at L1p = 21 (no multiple of G); on the second
   shape and at L1p 21 the group design also runs at each G with its
   chunk in registers and in shared memory, and roll in shared memory;
   every variant also at B = 1001 (no multiple of 4 lanes a thread).
   dp_eh is held again on its own "match" input (each lane's bases
   mostly one base, so eh climbs and out depends on every target row,
   through every chunk a tile stages) at its shipped plans, 32 and 16x2
   bits, at the probe's shape at each ROWS, B = 1000 with L1p 104 and
   21, and B = 1001 (tools/torch_dispatch_probe.MATCH_SHAPES).
   No device time may be under its bound.  The other designs and the
   replaced ones are timed by tools/torch_row_variants.py, not here.
3. Main paths at full size on a 5 Mbp genome (tools/se_smoke_data.py:
   simdata.py with fixed seeds, indexed with the port's build_index and
   cached under build/):
   * 2 x 8192 single-end 101 bp reads through align_stream: the device
     front and ext_pl2_kernel; no row may fall back.  align_stream
     enqueues a batch's front during the tail of the batch before, so the
     stream carries batch 0 a second time behind batch 1 (its SAM is
     dropped) and the rate of batch 1, in mid-stream, is the one printed;
   * the chain kernel (phase_chain: chain_kernel of
     csrc/chain_kernel.cu, ops/chain.chain_seeds on CUDA tensors) against
     the plain lockstep loop, every Chains field exact: on
     tools/torch_chain_cases's crafted grids at both index types (held to
     the sequential mem_chain too), on a heavy-tailed random grid of
     65,536 rows at S = C = 1024 (int32) and of 8192 rows (int64), and
     on the widest CHAIN call of the 101 bp path streamed again (its real
     EXPAND output; its launch count must rise); each timed grid prints
     the kernel's device time, its bound by bytes, the plain loop's time
     and the kernel on its heaviest row alone;
   * the single-program front half (phase_seedchain): batch 0's 8192 reads
     through pipeline/seedchain.align_regs on the card (pass-1 candidate
     cap 128), whose extensions launch ext_pl2_kernel (its plain version
     must not run): its regions must equal the main path's before dedup
     (the device front, fallback rows through the host-compacted front)
     on every read with no overflow flag (at most 1 % flagged); reads
     whose heavy chains tie in weight are extended again with the chains
     kept and ordered as ks_introsort leaves them, as the main path does,
     and those regions are required; its first 64 reads must equal its
     plain run on the CPU; its widest ext_pl2_kernel call is held against
     plain too;
   * 2 x 4096 pairs of 150 bp (insert 400 +- 40) through
     align_stream(pe=True), streamed the same way: the same device front,
     then insert-size inference, mate rescue and pair scoring on the
     host.  No row may fall back; both mates of at least 90 % of the pairs
     lie where simdata sampled them, at least 90 % of the pairs are flagged
     proper, the inferred FR insert mean is within 400 +- 10 and mate
     rescue ran; one batch of 128 pairs run whole on the card and on the
     CPU gives byte-identical SAM;
   * the first 128 reads and the 128 pairs rerun on the CPU, on the card
     again with the device front's first arenas forced small (it must
     grow and retry, no row falling back) and with its item arena pinned
     (it must bail to the host-compacted front after its 16 retries,
     every row a fallback row): the SAM must equal the CPU's bytes, and
     front.retries, front.bailouts and the fallback rows are printed;
   * 512 reads of 1000 bp: every row is handed to the host-compacted
     front, whose fused path launches ext_pl2_kernel;
   * 32 reads of 5000 bp: the host-compacted front's side path, which
     gives every lane, the ones with a query over 4095 bases included, to
     ext_pl_kernel: 0 dispatches of the plain extension;
   * multi-process mem (phase_multihost): 4 -K chunks of 8192 reads of
     101 bp (the 2 x 8192 twice over) through cli.main in this process,
     then through two processes of `python3 -m bwamem_tpu_torch.cli mem`
     joined over gloo on a local port, 2 chunks a rank, both starting
     from the main path's saved arena sizes; rank 0's merged SAM must
     equal this process's bytes, and each rank must launch
     ext_pl2_kernel (its count, fallback rows and wall time printed);
   * the data-parallel mesh (phase_mesh): the 101 bp and 150 bp batches
     again through Aligner(mesh=make_mesh(devs)), devs the first two
     cards or cuda:0 twice on a one-card machine, the shards' arenas sized
     from the main path's; the SAM must equal the one-device run's,
     ext_pl2_kernel must launch in
     every shard (launches a shard printed) and no row may fall back;
   * the FM-step probe (tools/torch_fm_step_probe.py, 8192 lanes, 64
     steps): the chained index-row gather in one call (fm_chain_words,
     fm_chain_rows: the row sums once, then the chain through them) beside
     the same chain and the real scan step issued from PyTorch.
   Each path runs with every launch count set to 0 just before it and
   read just after; a path that never launched its kernel, or launched
   another path's, fails, and so does a path with a device fetch that
   outlasted its watchdog (front.fetch_timeouts).  Each alignment path
   prints reads/s, the stage timers and the peak device memory; requires
   nearly every read mapped, and mapped where simdata sampled it; then
   reruns its first reads (128, 8, 1) on the CPU and requires
   byte-identical SAM.  The 5000 bp path
   also reruns its first 8 reads on the card as a batch of their own,
   byte-identical again.  The widest call of each extension kernel in its
   path (for the 5000 bp path: the widest with a query over 4095 bases) is
   kept, and the kernel is held against its plain version on those lanes
   too, and timed at each G (each G's output held to plain as well); the
   kernels line reports these main-path lanes.  The FM probe
   kernels are held against their plain version on the probe's own lanes,
   then (phase_fm_mm, tools/torch_fm_mm_variants.py) after 0, 1, 37 and
   64 steps on the index's table at its seq_len and at rows x 128, and on
   a random table of 262145 rows at rows x 128, where k + S wraps past
   int32 on some steps; timed in turns with the
   design they replaced on the device alone, beside one serial step of
   that design and of the full-row step a seeding kernel would pay.
   gp3_mm is held the same way (exact on integer-valued inputs, within
   mm_tolerance on normal ones, the same bits twice, and at other shapes)
   and timed in turns with the design it replaced.
   Last, the seeding and merging tools through cli.main on the card, with
   the stage timers on: fastmap and maxk over the first 8192 reads of
   101 bp (two CLI batches of 4096; no extension kernel may launch;
   reads/s, scan trips and reruns, peak memory), and pemerge over 4096
   pairs of 100 bp (some pair must merge); the first 256 reads, or pairs,
   run on the card and on the CPU give identical output (stdout, and
   pemerge's stderr too).
   Then the legacy aligner through cli.main on the card: one host-issued
   `aln` round of 1024 lanes (copy in, occ4, copy out) timed beside kernel
   D at 1024 lanes; `aln` + `samse` over the first 2048 reads of 101 bp,
   and `aln` on both mates + `sampe` over 1024 pairs of 101 bp (insert
   300 +- 30; every 16th second mate carries 10 substitutions, so only the
   mate rescue places it): reads/s, rounds and lanes of the search, the
   host time a round, the stage timers, peak memory, at least 90 % of the
   reads (both mates of 90 % of the pairs) where simdata sampled them, and
   some rescued mates; the first 128 reads, and 128 pairs, run whole on
   the card and on the CPU give identical .sai and SAM bytes.
   Last, `bwasw` through cli.main on the card: 128 reads of 500 bp (2 %
   substitutions, 0.2 % indels) and 64 pairs of 300 bp (insert 700 +-
   60): reads/s, pairs/s, the bwasw.* stage timers, the extension
   dispatches (every one a launch of ext_pl_kernel, none of the plain
   extension), peak memory; at least 90 % of the reads where simdata
   sampled them, some pair flagged proper; the first 8 reads and 8 pairs
   run whole on the card and on the CPU give identical SAM bytes.

The line before the last is {"kernels": [...]}, one entry for each of the
nineteen kernels; the last line is
{"ok": true, "device": {...}}.  Needs one CUDA device and no network.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CPU_CHECK_READS = 128
# reads of each long-read batch rerun on the CPU (a 5000 bp read takes the
# CPU tens of seconds, most of it the plain extension), and reads rerun on
# the card as a batch of their own
LONG_CPU_CHECK = {1000: 8, 5000: 1}
LONG_SUB_BATCH = {5000: 8}
# reads of each long-read batch that the smoke run aligns (the first ones
# of se_smoke_data's batch): seeding time is trips, not reads, so fewer
# 5000 bp reads mostly cut the extension and the host tail
LONG_READS = {1000: 512, 5000: 32}
# pairs of the paired-end batch run whole on the card and on the CPU
PE_CPU_CHECK_PAIRS = 256
# lanes of the kernel comparison: the main path's EXT shape
LANES, LQ, T_MAX = 16384, 128, 256
# long lanes of the one-pass kernel's comparison
LONG_LANES, LONG_LQ, LONG_T_MAX = 1024, 4095, 4608
# over-long lanes: queries past the 4095 bases of the TPU kernel's packing
OVER_LANES, OVER_LQ, OVER_T_MAX = 256, 5000, 5376
# lanes whose ring of columns wraps: queries of 1500-3000 bases at band 10
RING_LANES, RING_LQ = 1024, 3000
# the FM probe's shape
FM_LANES, FM_STEPS = 8192, 64
# H100 SXM peaks: HBM bytes/s (data sheet), and int32 operations a second
# outside the tensor cores as phase 1 measures them (tools/torch_int_rate.py
# on an NVIDIA H100 80GB HBM3 at 700 W): dp_eh's cell written
# plainly ran at 32.32-33.04 T/s (VIADD, ISETP, VIMNMX: one instruction a
# clock a scheduler, the issue limit, 33.45 T/s at 1.98 GHz), the 32-bit
# DPX add-max alone at 31.8-31.9 (two operations an instruction at half
# that rate), IADD3 with a max at 24.1-24.7; the highest, rounded up.  A
# kernel that packs two cells in 16 bits takes PEAK_INT16X2_OPS:
# __viaddmax_s16x2_relu ran at 59.5-60.6 T/s, rounded up to the rate of
# its four operations an instruction at half the issue limit (66.9 T/s).
PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 33.5e12
PEAK_INT16X2_OPS = 67e12
OPS_PER_CELL = 16      # int32 operations of ksw's recurrence per DP cell
# the gather-strategy probe at tools/pl_gather_probe.py's defaults
GP_LANES, GP_STEPS = 8192, 16
# round 2 of the gather probe, at tools/pl_gather_probe2.py's defaults
GP2_STEPS = 32
# round 3, at tools/pl_gather_probe3.py's: 512 chained steps
GP3_STEPS = 512
# H100 SXM float32 rate outside the tensor cores (data sheet)
PEAK_F32_OPS = 67e12
# the legacy aligner: reads of aln + samse (the first of the 101 bp set),
# pairs of aln x 2 + sampe (the first of se_smoke_data's set), the reads
# and pairs run whole on the card and on the CPU, and the lanes of the
# host-issued round timed beside kernel D
LEG_READS, LEG_PAIRS = 2048, 1024
LEG_CPU_READS, LEG_CPU_PAIRS, LEG_ROUND_LANES = 256, 256, 1024
# reads of the fastmap/maxk path (the first of the 101 bp set; two CLI
# batches of 4096), and the reads and pairs rerun on the CPU
TOOL_READS, TOOL_CPU_READS, PEM_CPU_PAIRS = 8192, 256, 256
# bwasw: the reads of 500 bp aligned (the first of se_smoke_data's set),
# and the reads and pairs run whole on the card and on the CPU
BWASW_SE_READS = 128
BWASW_CPU_READS, BWASW_CPU_PAIRS = 8, 8
# multi-process mem: ranks, and -K chunks of se_smoke_data.BATCH reads (the
# 101 bp set twice over), dealt round-robin, 2 a rank
MH_RANKS, MH_CHUNKS = 2, 4
# seconds the ranks of the multi-process run may take, start-up included
MH_DEADLINE = 300
# the single-program front half (phase_seedchain): reads of batch 0 of the
# 101 bp stream, reads rerun on the CPU, the share of reads an overflow
# flag may take out of the region comparison, and the pass-1 candidate cap
# (SeedingCaps.cand1: at the default 64, reads over this genome's repeats
# overflow it on more reads than that share)
SC_READS, SC_CPU_READS, SC_MAX_FLAGGED, SC_CAND1 = 8192, 64, 0.01, 128
SC_REG_FIELDS = ("rb", "re", "qb", "qe", "rid", "score", "truesc", "w",
                 "seedcov", "seedlen0")
# the chain kernel's random grid (phase_chain): the rows and the grown
# seed cap of a chr1.pe150 batch, rounds of its timing, and chr1's l_pac
CHAIN_N, CHAIN_S, CHAIN_ROUNDS = 65536, 1024, 5
CHAIN_L_PAC = 248_956_422


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 5) -> float:
    import torch
    fn()                                   # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


# ------------------------------------------------------------------ phase 1

def phase_env():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")

    from bwamem_tpu_torch import native
    from bwamem_tpu_torch.index import native as sais
    from bwamem_tpu_torch.ops import (chain, dispatch_probe, ext_kernel,
                                      fm_probe, gather_probe, gather_probe2,
                                      gather_probe3, int_rate, pl_probe)
    import torch_dg_variants
    import torch_fm_mm_variants
    import torch_take2_variants
    errors = []

    def build(name, fn):
        t0 = time.perf_counter()
        try:
            fn()
            log(f"build {name}: {time.perf_counter() - t0:.1f} s")
        except BaseException as e:        # reported after the join
            errors.append(f"{name}: {e}")

    def load_sais():
        if not sais.available():
            raise RuntimeError("the suffix-array builder did not build")

    jobs = [threading.Thread(target=build, args=a) for a in (
        ("ext_kernel.cu, both kernels (nvcc sm_90a)", ext_kernel.LIB.load),
        ("fm_probe_kernel.cu, both entries (nvcc sm_90a)", fm_probe.LIB.load),
        ("gather_probe_kernel.cu, four kernels (nvcc sm_90a)",
         gather_probe.LIB.load),
        ("gather_probe2_kernel.cu, four kernels (nvcc sm_90a)",
         gather_probe2.LIB.load),
        ("gather_probe3_kernel.cu, four kernels (nvcc sm_90a)",
         gather_probe3.LIB.load),
        ("dispatch_probe_kernel.cu (nvcc sm_90a)", dispatch_probe.LIB.load),
        ("pl_probe_kernel.cu, five variants (nvcc sm_90a)", pl_probe.LIB.load),
        ("int_rate_kernel.cu, five mixes (nvcc sm_90a)", int_rate.LIB.load),
        ("chain_kernel.cu (nvcc sm_90a)", chain.LIB.load),
        ("tools/dg_variants.cu, the 5d and 7A designs weighed (nvcc "
         "sm_90a)", torch_dg_variants.library),
        ("tools/fm_mm_variants.cu, the #3 and 7D designs weighed (nvcc "
         "sm_90a)", torch_fm_mm_variants.library),
        ("tools/take2_variants.cu, the 6B and 6C designs weighed (nvcc "
         "sm_90a)", torch_take2_variants.library),
        ("hostops.c (cc)", native.load),
        ("sais.c (cc)", load_sais))]
    t0 = time.perf_counter()
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    if errors:
        raise RuntimeError("build failed: " + "; ".join(errors))
    log(f"build total: {time.perf_counter() - t0:.1f} s")
    log_ptxas(ext_kernel.LIB)
    phase_int_rate()
    log_shipped_ptxas()
    return smi.stdout.strip().splitlines()[0]


def log_ptxas(lib, keep=None, bools=("global", "shared")):
    """The registers, spills and shared memory that ptxas reported for
    each kernel of `lib` (built with -Xptxas -v; the build's output is
    kept in build/<library>.log), or for those whose (name, template
    arguments) `keep` takes; a bool template argument is printed as
    bools[0] or bools[1].  Returns [(kernel, registers, spill store bytes,
    spill load bytes)] of the kernels printed."""
    from bwamem_tpu_torch._build import BUILD_DIR
    path = os.path.join(BUILD_DIR, lib.so_name + ".log")
    if not os.path.exists(path):
        raise RuntimeError(f"no build log {path}")
    name, spill, out = None, (0, 0), []
    for line in open(path):
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)I"
                      r"((?:L[ib]\d+E)+)E", line)
        if m:
            pairs = re.findall(r"L([ib])(\d+)E", m.group(2))
            args = [int(v) for _, v in pairs]
            shown = ", ".join(bools[int(v)] if k == "b" else v
                              for k, v in pairs)
            name = (f"{m.group(1)}<{shown}>"
                    if keep is None or keep(m.group(1), args) else None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            log(f"ptxas {name}: {m.group(1)} registers, {spill[0]} bytes "
                f"spill stores, {spill[1]} loads{m.group(2)}")
            out.append((name, int(m.group(1)), *spill))
        if m:
            name, spill = None, (0, 0)
    if not out:
        raise RuntimeError(f"{path} reports no kept kernel's registers")
    return out


def phase_int_rate():
    """The card's int32 rate (tools/torch_int_rate.measure: five mixes
    held against their plain version, then timed on every SM), which
    PEAK_INT32_OPS and PEAK_INT16X2_OPS must not be under: a bound by
    operations taken at a lower peak would not be a bound."""
    import torch_int_rate
    res = torch_int_rate.measure(log)
    top = max(res[m]["rate"] for m in torch_int_rate.MIXES_32)
    log(f"int32 rate: measured {top / 1e12:.3f} T/s (32-bit), "
        f"{res['s16x2']['rate'] / 1e12:.3f} T/s (16x2); the bounds take "
        f"{PEAK_INT32_OPS / 1e12:.1f} and {PEAK_INT16X2_OPS / 1e12:.1f}")
    if top > PEAK_INT32_OPS or res["s16x2"]["rate"] > PEAK_INT16X2_OPS:
        raise RuntimeError("the card ran int32 operations faster than "
                           "PEAK_INT32_OPS or PEAK_INT16X2_OPS: raise them")


def log_shipped_ptxas():
    """ptxas's registers and spills of the shipped plans of kernels #4
    (plp_row at the probe's L1p 136, B 2048) and #8 (dp_eh); RuntimeError
    if one spills."""
    from bwamem_tpu_torch.ops import dispatch_probe as dp
    from bwamem_tpu_torch.ops import pl_probe as plp
    L1p, B = 136, 2048
    g = plp.plan("full", L1p, B)
    roll = plp.plan("roll", L1p, B)
    eh = plp.plan("eh_only", L1p, B)
    dps = [dp.plan(L1p, r, B) for r in (8, 128)]

    def rows_kernel(rpt, lpt, threads, lgb):  # rows.cuh's kernel of a plan
        return "rows_kernel" if lgb == threads else "rows_tile_kernel"
    rows = log_ptxas(plp.LIB, lambda n, a: (
        (n == "plp_group_kernel" and a[:2] == [g.p0, g.p1])
        or (n == "plp_roll_warp_kernel" and a == [roll.p1])
        or (n == rows_kernel(*eh) and a == [eh.p0, eh.p1, 2])))
    rows += log_ptxas(dp.LIB, lambda n, a: any(
        n == rows_kernel(p.rpt, p.lpt, p.threads, p.lgb)
        and a == [p.rpt, p.lpt, 1 if p.bits == 16 else 0] for p in dps))
    bad = [r for r in rows if r[2] or r[3]]
    if bad:
        raise RuntimeError(f"a shipped kernel of #4 or #8 spills: {bad}")


# ------------------------------------------------------------------ phase 2

def ext_lanes():
    """EXT-shaped lanes: queries of up to 101 bases in [LQ, B] rows,
    targets of up to T_MAX rows; categories cover plain extensions, empty
    queries, z-drop cuts, lanes whose best cell sits 80 off the diagonal
    (they retry at the doubled band) and unrelated targets."""
    import numpy as np
    import se_smoke_data as sd
    rng = np.random.default_rng(sd.SEED)
    qT = np.full((LQ, LANES), 4, np.int32)
    tT = np.full((T_MAX, LANES), 4, np.int32)
    qlen = np.zeros(LANES, np.int32)
    tlen = np.zeros(LANES, np.int32)
    h0 = rng.integers(1, 102, LANES).astype(np.int32)
    kind = rng.integers(0, 10, LANES)
    for b in range(LANES):
        k = kind[b]
        ql = 0 if k == 0 else int(rng.integers(1, sd.READ_LEN + 1))
        q = rng.integers(0, 4, ql)
        m = q.copy()
        sub = rng.random(ql) < 0.02
        m[sub] = rng.integers(0, 4, int(sub.sum()))
        if k == 0:                         # empty query
            t = rng.integers(0, 4, int(rng.integers(1, 120)))
        elif k == 1:                       # z-drop: match, then garbage
            cut = ql // 3
            t = np.concatenate([m[:cut], rng.integers(0, 4, 150)])
        elif k == 2:                       # 80-base gap: retry lanes
            h0[b] = 100
            t = np.concatenate([rng.integers(0, 4, 80), m,
                                rng.integers(0, 4, 20)])
        elif k == 3:                       # unrelated
            t = rng.integers(0, 4, int(rng.integers(1, T_MAX)))
        else:                              # ordinary extension + tail
            t = np.concatenate([m, rng.integers(0, 4,
                                                int(rng.integers(0, 100)))])
        t = t[:T_MAX]
        qT[:ql, b] = q
        tT[:len(t), b] = t
        qlen[b], tlen[b] = ql, len(t)
    eb = np.full(LANES, 5, np.int32)
    return qT, tT, qlen, tlen, h0, eb


def bound(qlen, tlen, w1, w2, retried, t_max, lane_words=4 + 7):
    """Least time the card could take for these lanes, from the inputs:
    (bound_ms, bound_by, bytes, cells).  Bytes: the query and target rows
    of each nonempty lane (rows < qlen, rows < min(tlen, t_max)) read once,
    and `lane_words` int32 per lane: the per-lane inputs read once and the
    outputs written once (4 + 7 for ext_pl2_kernel).  Cells:
    ksw's band, min(qlen, i + w + 1) - max(0, i - w) columns at each row
    i < min(tlen, t_max), at w1 for every lane and again at w2 for the
    lanes that retry (the plain version's `retried`).  The window shrink
    and z-drop of ksw can leave fewer cells; they are not subtracted."""
    import torch
    B = qlen.shape[0]
    q = qlen.to(torch.int64)
    rows = tlen.to(torch.int64).clamp(0, t_max)
    live = (q > 0) & (rows > 0)
    nbytes = 4 * (int(torch.where(live, q + rows, 0).sum()) + lane_words * B)

    def band_cells(w):
        # rows in chunks: [t_max, B] int64 temporaries would be GBs for
        # the long lanes
        w = w.to(torch.int64)[None, :]
        total = torch.zeros_like(q)
        for r0 in range(0, t_max, 512):
            i = torch.arange(r0, min(r0 + 512, t_max), device=q.device,
                             dtype=torch.int64)[:, None]
            c = (torch.minimum(q[None, :], i + w + 1) - (i - w).clamp(min=0))
            total += torch.where(i < rows[None, :], c.clamp(min=0), 0).sum(0)
        return total

    cells = int(band_cells(w1).sum()) + int(
        torch.where(retried.bool(), band_cells(w2), 0).sum())
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = cells * OPS_PER_CELL / PEAK_INT32_OPS * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else
            "bytes", nbytes, cells)


def ext_bands(qlen, eb, w, kw):
    """The bands the extension kernels run at: w ([B] or an int) clamped
    per lane as ksw.c:399-407 does."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops.extend import _adjust_w
    mat = np.frombuffer(kw["mat_bytes"], np.int8)
    w = torch.as_tensor(w, dtype=torch.int32, device=qlen.device)
    return _adjust_w(w.expand(qlen.shape), qlen.to(torch.int32),
                     int(mat.max()), eb.to(torch.int32), kw["o_ins"],
                     kw["e_ins"], kw["o_del"], kw["e_del"])


def ext_groups(label, launch, args, kw, lq, w_max, want):
    """The kernel at each G on these lanes through its launch function
    (ops/ext_kernel.launch_pl2 or launch_pl), each held to `want`:
    {G: ms}, timed with CUDA events."""
    import torch
    from bwamem_tpu_torch.ops import ext_kernel

    def flat(r):
        return torch.stack(list(r[0]) + [r[1]] if isinstance(r, tuple)
                           and len(r) == 2 else list(r)).to(torch.int64)
    times = {}
    for g in ext_kernel.GROUPS:
        p = ext_kernel.plan(lq, w_max, g)
        got = flat(launch(*args, p, **kw))
        if not torch.equal(got, want):
            raise RuntimeError(f"{label}: the kernel at G = {g} disagrees "
                               f"with its plain version")
        times[g] = median_ms(lambda: launch(*args, p, **kw))
    log(f"{label}: kernel ms by G " + ", ".join(
        f"{g}: {t:.4f}" for g, t in times.items()) + " (each equal to plain)")
    return times


def plan_line(label, p, ms, cells, bound_ms):
    log(f"{label}: G {p.group}, {p.storage} storage, ring R {p.R}, lane "
        f"area {p.area} bytes, dynamic shared memory {p.smem} bytes a "
        f"block; kernel {ms:.4f} ms, {cells / ms * 1e3:.4g} band cells/s, "
        f"{ms / bound_ms:.1f} x bound")


def hold_kernel(label, qT, qlen, tT, tlen, h0, eb, groups=False, **kw):
    """ext_pl2_kernel against its plain version on one set of lanes (all
    7 outputs must be equal), both timed with CUDA events, the kernel also
    at each G when `groups`; returns the kernel's entry of the kernels line
    (launches filled in later)."""
    import torch
    from bwamem_tpu_torch.ops import ext_kernel
    B = qlen.shape[0]
    lq, tm = kw["lq_max"], kw["t_max"]
    res, retried = ext_kernel.extend_batch_pl2(qT, qlen, tT, tlen, h0, eb,
                                               **kw)
    torch.cuda.synchronize()
    pres, pretried = ext_kernel.extend_batch_pl2_plain(qT, qlen, tT, tlen,
                                                       h0, eb, **kw)
    got = torch.stack(list(res) + [retried]).to(torch.int64)
    want = torch.stack(list(pres) + [pretried]).to(torch.int64)
    err = int((got - want).abs().max().item())
    n_bad = int((got != want).any(0).sum().item())
    n_retried = int(pretried.sum())
    log(f"kernel vs plain, {label}: {B} lanes x {lq} query rows x {tm} "
        f"target rows, {n_bad} differ, max_abs_err {err}, retried "
        f"{n_retried}, empty queries {int((qlen == 0).sum())}")
    if err != 0:
        names = ("score", "qle", "tle", "gtle", "gscore", "max_off",
                 "retried")
        rows = [names[k] for k in range(7) if bool((got[k] != want[k]).any())]
        raise RuntimeError(f"CUDA kernel disagrees with its plain version "
                           f"on {n_bad} lanes of the {label} (fields {rows})")

    ms = median_ms(lambda: ext_kernel.extend_batch_pl2(
        qT, qlen, tT, tlen, h0, eb, **kw))
    plain_ms = median_ms(lambda: ext_kernel.extend_batch_pl2_plain(
        qT, qlen, tT, tlen, h0, eb, **kw))
    w1 = ext_bands(qlen, eb, kw["w_opt"], kw)
    w2 = ext_bands(qlen, eb, 2 * kw["w_opt"], kw)
    bound_ms, bound_by, nbytes, cells = bound(qlen, tlen, w1, w2, pretried,
                                              tm)
    p = ext_kernel.plan(lq, 2 * kw["w_opt"])
    log(f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, band cells {cells}, "
        f"bytes {nbytes}, bound {bound_ms:.5f} ms ({bound_by}), kernel / "
        f"bound {ms / bound_ms:.1f}")
    plan_line(label, p, ms, cells, bound_ms)
    entry = dict(name="ext_pl2_kernel", route="cuda",
                 source="bwamem_tpu_torch/csrc/ext_kernel.cu",
                 replaces="bwamem_tpu/ops/pallas_ext.py:229",
                 launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                 retried=n_retried, group=p.group, storage=p.storage,
                 smem_bytes=p.smem, cells=cells)
    if groups:
        entry["ms_by_group"] = ext_groups(
            label, ext_kernel.launch_pl2, (qT, qlen, tT, tlen, h0, eb), kw,
            lq, 2 * kw["w_opt"], want)
    return entry


def ext_lanes_long(B=LONG_LANES, lq=LONG_LQ, t_max=LONG_T_MAX, q_lo=1000,
                   pad=64, seed=1):
    """Long lanes for the one-pass kernel: queries of q_lo-lq bases
    (1000-4095 by default) against their own mutated copy (2% substitutions,
    a deletion and an insertion of a few bases, a random tail), one lane in
    eight against an unrelated target (z-drop), and `pad` padding lanes
    (qlen = tlen = 0, h0 = 1) at the end, as the long-read path builds
    them."""
    import numpy as np
    import se_smoke_data as sd
    rng = np.random.default_rng(sd.SEED + seed)
    qT = np.full((lq, B), 4, np.int32)
    tT = np.full((t_max, B), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    h0 = np.ones(B, np.int32)
    for b in range(B - pad):
        ql = int(rng.integers(q_lo, lq + 1))
        q = rng.integers(0, 4, ql)
        if b % 8 == 7:
            t = rng.integers(0, 4, int(rng.integers(500, t_max)))
        else:
            m = q.copy()
            sub = rng.random(ql) < 0.02
            m[sub] = rng.integers(0, 4, int(sub.sum()))
            cut = int(rng.integers(100, ql - 100))
            gap = int(rng.integers(1, 40))
            t = np.concatenate([m[:cut], rng.integers(0, 4, gap),
                                m[cut + gap // 2:],
                                rng.integers(0, 4, int(rng.integers(0, 300)))])
        t = t[:t_max]
        qT[:ql, b] = q
        tT[:len(t), b] = t
        qlen[b], tlen[b], h0[b] = ql, len(t), int(rng.integers(19, 300))
    eb = np.full(B, 5, np.int32)
    return qT, tT, qlen, tlen, h0, eb


def hold_kernel_pl(label, qT, qlen, tT, tlen, h0, w, eb, plain_reps=5,
                   groups=False, **kw):
    """ext_pl_kernel against its plain version on one set of lanes (all 6
    outputs must be equal), both timed with CUDA events, the kernel also at
    each G when `groups`; returns the kernel's entry of the kernels line
    (launches filled in later)."""
    import torch
    from bwamem_tpu_torch.ops import ext_kernel
    B = qlen.shape[0]
    lq, tm = kw["lq_max"], kw["t_max"]
    args = (qT, qlen, tT, tlen, h0, w, eb)
    res = ext_kernel.extend_batch_pl(*args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pres = ext_kernel.extend_batch_pl_plain(*args, **kw)
    torch.cuda.synchronize()
    plain_first = (time.perf_counter() - t0) * 1e3
    got = torch.stack(list(res)).to(torch.int64)
    want = torch.stack(list(pres)).to(torch.int64)
    err = int((got - want).abs().max().item())
    n_bad = int((got != want).any(0).sum().item())
    log(f"one-pass kernel vs plain, {label}: {B} lanes x {lq} query rows x "
        f"{tm} target rows, {n_bad} differ, max_abs_err {err}, empty lanes "
        f"{int(((qlen == 0) & (tlen == 0)).sum())}, longest query "
        f"{int(qlen.max())}, longest target {int(tlen.max())}")
    if err != 0:
        names = ("score", "qle", "tle", "gtle", "gscore", "max_off")
        rows = [names[k] for k in range(6) if bool((got[k] != want[k]).any())]
        raise RuntimeError(f"the one-pass CUDA kernel disagrees with its "
                           f"plain version on {n_bad} lanes of the {label} "
                           f"(fields {rows})")
    ms = median_ms(lambda: ext_kernel.extend_batch_pl(*args, **kw))
    # the plain version of a long shape runs thousands of row trips (many
    # seconds): its one run above, on the host clock, is its time
    plain_ms = (median_ms(lambda: ext_kernel.extend_batch_pl_plain(
        *args, **kw), reps=plain_reps) if plain_reps > 1 else plain_first)
    wadj = ext_bands(qlen, eb, w, kw)
    bound_ms, bound_by, nbytes, cells = bound(
        qlen, tlen, wadj, wadj, torch.zeros_like(qlen), tm,
        lane_words=5 + 6)
    w_max = int(w.max())
    p = ext_kernel.plan(lq, w_max)
    log(f"one-pass kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, band cells "
        f"{cells}, bytes {nbytes}, bound {bound_ms:.5f} ms ({bound_by}), "
        f"kernel / bound {ms / bound_ms:.1f}")
    plan_line(label, p, ms, cells, bound_ms)
    entry = dict(name="ext_pl_kernel", route="cuda",
                 source="bwamem_tpu_torch/csrc/ext_kernel.cu",
                 replaces="bwamem_tpu/ops/pallas_ext.py:213",
                 launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                 group=p.group, storage=p.storage, smem_bytes=p.smem,
                 cells=cells)
    if groups:
        entry["ms_by_group"] = ext_groups(label, ext_kernel.launch_pl, args,
                                          kw, lq, w_max, want)
    return entry


def ext_lanes_ring(B=RING_LANES, lq=RING_LQ, pad=16):
    """Lanes whose ring of columns wraps: queries of 1500-3000 bases
    against their mutated copy (2 % substitutions, two short indels, a
    random tail of 40), h0 20-60, and `pad` padding lanes."""
    import numpy as np
    import se_smoke_data as sd
    rng = np.random.default_rng(sd.SEED + 3)
    t_max = lq + 64
    qT = np.full((lq, B), 4, np.int32)
    tT = np.full((t_max, B), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    h0 = np.ones(B, np.int32)
    for b in range(B - pad):
        ql = int(rng.integers(1500, lq + 1))
        q = rng.integers(0, 4, ql)
        m = q.copy()
        sub = rng.random(ql) < 0.02
        m[sub] = rng.integers(0, 4, int(sub.sum()))
        for _ in range(2):
            at = int(rng.integers(100, len(m) - 100))
            n = int(rng.integers(1, 4))
            m = (np.concatenate([m[:at], rng.integers(0, 4, n), m[at:]])
                 if rng.random() < 0.5 else
                 np.concatenate([m[:at], m[at + n:]]))
        t = np.concatenate([m, rng.integers(0, 4, 40)])[:t_max]
        qT[:ql, b] = q
        tT[:len(t), b] = t
        qlen[b], tlen[b], h0[b] = ql, len(t), int(rng.integers(20, 61))
    eb = np.full(B, 5, np.int32)
    return qT, tT, qlen, tlen, h0, eb


def phase_kernel():
    """Both extension kernels against their plain versions on generated
    lanes; returns the largest error of each kernel."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.config import MemOptions
    opt = MemOptions()
    dev = torch.device("cuda")
    score = dict(mat_bytes=np.asarray(opt.mat, np.int8).tobytes(),
                 o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                 e_ins=opt.e_ins, zdrop=opt.zdrop)
    qT, tT, qlen, tlen, h0, eb = (torch.from_numpy(a).to(dev)
                                  for a in ext_lanes())
    res = hold_kernel("generated lanes", qT, qlen, tT, tlen, h0, eb,
                      lq_max=LQ, t_max=T_MAX, w_opt=opt.w, **score)
    if res["retried"] == 0:
        raise RuntimeError("no lane retried: the comparison misses the "
                           "second pass")
    # the one-pass kernel: the same lanes at bands w and 2w, then long lanes
    w = torch.where(torch.arange(LANES, device=dev) % 2 == 0, opt.w,
                    2 * opt.w).to(torch.int32)
    short = hold_kernel_pl("generated short lanes", qT, qlen, tT, tlen, h0,
                           w, eb, lq_max=LQ, t_max=T_MAX, **score)
    qT, tT, qlen, tlen, h0, eb = (torch.from_numpy(a).to(dev)
                                  for a in ext_lanes_long())
    w = torch.where(torch.arange(LONG_LANES, device=dev) % 2 == 0, opt.w,
                    2 * opt.w).to(torch.int32)
    long_ = hold_kernel_pl("generated long lanes", qT, qlen, tT, tlen, h0,
                           w, eb, plain_reps=1, lq_max=LONG_LQ,
                           t_max=LONG_T_MAX, **score)
    # queries of 4096-5000 bases: every lane is past the TPU kernel's limit
    qT, tT, qlen, tlen, h0, eb = (torch.from_numpy(a).to(dev)
                                  for a in ext_lanes_long(
                                      OVER_LANES, OVER_LQ, OVER_T_MAX,
                                      q_lo=4096, pad=16, seed=2))
    if int(qlen[:-16].min()) <= 4095:
        raise RuntimeError("the over-long lanes are not over-long")
    w = torch.where(torch.arange(OVER_LANES, device=dev) % 2 == 0, opt.w,
                    2 * opt.w).to(torch.int32)
    over = hold_kernel_pl("generated over-long lanes", qT, qlen, tT, tlen,
                          h0, w, eb, plain_reps=1, lq_max=OVER_LQ,
                          t_max=OVER_T_MAX, **score)
    # ring-wrap lanes: band 10 (R = 32 columns) over queries of 1500-3000
    # bases, the one-pass kernel at w = 10 and ext_pl2 at w_opt = 5 (both
    # passes on the ring, w2 = 10)
    qT, tT, qlen, tlen, h0, eb = (torch.from_numpy(a).to(dev)
                                  for a in ext_lanes_ring())
    ring_kw = dict(lq_max=RING_LQ, t_max=RING_LQ + 64, **score)
    ring = hold_kernel_pl("ring-wrap lanes, band 10", qT, qlen, tT, tlen, h0,
                          torch.full_like(qlen, 10), eb, plain_reps=1,
                          **ring_kw)
    ring2 = hold_kernel("ring-wrap lanes, w_opt 5", qT, qlen, tT, tlen, h0,
                        eb, w_opt=5, **ring_kw)
    if ring2["retried"] == 0:
        raise RuntimeError("no ring-wrap lane retried")
    return max(res["max_abs_err"], ring2["max_abs_err"]), max(
        short["max_abs_err"], long_["max_abs_err"], over["max_abs_err"],
        ring["max_abs_err"])


def phase_launch_path():
    """ops/launch on the card: the raw stream handle it launches on is the
    caller's current stream, on the default stream and inside
    torch.cuda.stream(side), and a kernel launched inside `side` (gp3_col0)
    equals its plain version once `side` has finished."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops import col0, gather_probe3 as gp3
    from bwamem_tpu_torch.ops import launch
    index = torch.cuda.current_device()
    main = launch.raw_stream(index)
    if main != torch.cuda.current_stream().cuda_stream:
        raise RuntimeError("launch.raw_stream differs from the default "
                           "stream's handle")
    rng = np.random.default_rng(11)
    tab = torch.from_numpy(rng.integers(-(1 << 30), 1 << 30, (4096, 8),
                                        dtype=np.int32)).cuda()
    k = torch.from_numpy(rng.integers(0, 4096, 1 << 16,
                                      dtype=np.int32)).cuda()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        handle = launch.raw_stream(index)
        if handle != torch.cuda.current_stream().cuda_stream \
                or handle != side.cuda_stream or handle == main:
            raise RuntimeError(f"inside torch.cuda.stream(side): "
                               f"launch.raw_stream {handle:#x}, side "
                               f"{side.cuda_stream:#x}, default {main:#x}")
        got = gp3.gp3_col0(tab, k)
    side.synchronize()
    err = int((got.to(torch.int64) - col0.plain(tab, k).to(
        torch.int64)).abs().max().item())
    log(f"launch path: raw stream {main:#x} on the default stream and "
        f"{handle:#x} inside side, as torch.cuda.current_stream(); gp3_col0 "
        f"launched on side vs plain: max_abs_err {err}")
    if err:
        raise RuntimeError("gp3_col0 launched on a side stream disagrees "
                           "with its plain version")


def chain_ops(words, elems, steps):
    """The int32 operations of `steps` steps of a chain whose step is a
    fixed map of the element's state within its line (5d and 7A), for
    elems chains over tables of `words` words in all: the fewer of the
    step-by-step chain's (gather, add, remainder or clip: 3 a step an
    element) and the composed map's (the map taken once, 3 a word; a
    squaring, T^2 = T[T], 2 a word a round, bit_length(steps) - 1 rounds;
    one lookup an element for each set bit of steps)."""
    if steps == 0:
        return 0
    composed = (3 * words + 2 * words * (steps.bit_length() - 1)
                + elems * bin(steps).count("1"))
    return min(3 * elems * steps, composed)


def gp_bound(name, x, steps, sfx=""):
    """Least time the card could take for one gather-probe kernel on the
    probe's inputs x (gp_take_ax0 on tab<sfx> and kfull<sfx>: "" the
    probe's, "_spread" the spread input): (bound_ms, bound_by, bytes).  Bytes: k
    (or the take's kk) read once, the output written once, and of each
    table only the words these indices touch (computed from the data: a
    word read again, in a later pass or by another lane, is not counted).
    gp_onehot's function is the gather out[q] = bf16(tab3[k >> 7,
    k & 127]) (0 outside the table), so it is priced as that gather, not
    as the one-hot product.  Operations: the int32 work at the int32
    rate (gp_take_ax0: chain_ops, the fewer of the step-by-step chain's
    and the composed map's)."""
    import torch
    k = x["k"].reshape(-1).to(torch.int64)
    n = k.numel()
    if name == "gp_scalar":                # one pass
        words = torch.unique(k * 128 + torch.arange(n, device=k.device) % 128)
        nbytes = 4 * (2 * n + words.numel())
        t_ops = n * 2 / PEAK_INT32_OPS * 1e3
    elif name == "gp_scalar2":             # one pass
        nbytes = 4 * 2 * n + 8 * torch.unique(k).numel()
        t_ops = n * 3 / PEAK_INT32_OPS * 1e3
    elif name == "gp_onehot":
        nbytes = 4 * (2 * n + torch.unique(
            k[(k >= 0) & (k < x["tab3"].numel())]).numel())
        t_ops = n * 2 / PEAK_INT32_OPS * 1e3
    else:
        tab, kk = x["tab" + sfx], x["kfull" + sfx].to(torch.int64)
        R = tab.shape[0]
        touched = torch.zeros(tab.shape, dtype=torch.bool, device=tab.device)
        col = torch.arange(128, device=tab.device)[None, :].expand_as(kk)
        for _ in range(steps):
            touched[kk, col] = True
            kk = torch.remainder(kk + tab.gather(0, kk).to(torch.int64), R)
        nbytes = 4 * (2 * kk.numel() + int(touched.sum()))
        t_ops = chain_ops(tab.numel(), kk.numel(), steps) \
            / PEAK_INT32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else
            "bytes", int(nbytes))


def phase_gather_probe():
    """The gather-strategy probe as its users run it
    (tools/torch_pl_gather_probe.probe, launch counts from 0; it checks
    every kernel against its plain version, gp_onehot also on the inputs
    of ops/gather_probe.onehot_inputs, and times kernel, plain and library
    with CUDA events), then each kernel held against its plain version
    once more on the probe's inputs.  Returns the four kernels-line
    entries."""
    import torch
    import se_smoke_data as sd
    import torch_pl_gather_probe as probe
    from bwamem_tpu_torch.ops import gather_probe as gp
    counters = {"gp_scalar": "launches_scalar",
                "gp_scalar2": "launches_scalar2",
                "gp_onehot": "launches_onehot",
                "gp_take_ax0": "launches_take"}
    for c in counters.values():
        setattr(gp, c, 0)
    res = probe.probe(GP_LANES, GP_STEPS, sd.SEED, log)
    torch.cuda.synchronize()
    launches = {n: getattr(gp, c) for n, c in counters.items()}
    log(f"gather probe: launches {launches}")
    if min(launches.values()) <= 0:
        raise RuntimeError("the gather probe never launched a kernel")
    x = res["inputs"]
    held = {"gp_scalar": (lambda: gp.gp_scalar(x["tab"], x["k"]),
                          lambda: gp.scalar_plain(x["tab"], x["k"]), 65),
            "gp_scalar2": (lambda: gp.gp_scalar2(x["tabw"], x["k"]),
                           lambda: gp.scalar2_plain(x["tabw"], x["k"]), 93),
            "gp_onehot": (lambda: gp.gp_onehot(x["tab3"], x["k"]),
                          lambda: gp.onehot_plain(x["tab3"], x["k"]), 120),
            "gp_take_ax0": (lambda: gp.gp_take_ax0(x["tab"], x["kfull"],
                                                   GP_STEPS),
                            lambda: gp.take_ax0_plain(x["tab"], x["kfull"],
                                                      GP_STEPS), 151)}
    entries = []
    for name, (kern, plain, line) in held.items():
        got = kern().to(torch.int64)
        want = plain().to(torch.int64)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        r = res["results"][name]
        bound_ms, bound_by, nbytes = gp_bound(name, x, GP_STEPS)
        log(f"{name} vs plain: {tuple(want.shape)} outputs, "
            f"{int((got != want).sum())} differ, max_abs_err {err}; kernel "
            f"{r['ms']:.4f} ms (device alone {r['device_ms']:.4f}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']} ms, bytes "
            f"{nbytes}, bound {bound_ms:.6f} ms ({bound_by}), device time / "
            f"bound {r['device_ms'] / bound_ms:.1f}")
        if err:
            raise RuntimeError(f"{name} disagrees with its plain version")
        e = dict(name=name, route="cuda",
                 source="bwamem_tpu_torch/csrc/gather_probe_kernel.cu",
                 replaces=f"tools/pl_gather_probe.py:{line}",
                 launches=launches[name], max_abs_err=err, ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=r["library_ms"],
                 device_ms=r["device_ms"])
        e.update({k: r[k] for k in COL0_KEYS if k in r})
        if name == "gp_onehot":
            # the probe's tab3 lies in [0, 255), where bf16 is exact: the
            # inputs where it rounds, and k outside the table, count too
            e["max_abs_err"] = max(err, *res["onehot"].values())
            e["max_abs_err_by_input"] = res["onehot"]
        if name == "gp_scalar2":           # odd widths, unaligned, wrapping
            e["max_abs_err"] = max(err, *res["scalar2"].values())
        if name == "gp_take_ax0":          # chains that share no state
            # launches counts calls; a call at the probe's R launches the
            # column design's three kernels
            e["kernels_a_call"] = (
                gp.TAKE_COL_KERNELS
                if gp.take_scratch_words(x["tab"].shape[0]) else 1)
            rs = res["results"]["gp_take_ax0_spread"]
            b_s, by_s, nb_s = gp_bound(name, x, GP_STEPS, "_spread")
            e.update(ms_spread=rs["ms"], device_ms_spread=rs["device_ms"],
                     plain_ms_spread=rs["plain_ms"],
                     library_ms_spread=rs["library_ms"],
                     bound_ms_spread=b_s, bound_by_spread=by_s)
            log(f"gp_take_ax0: {launches[name]} calls, "
                f"{e['kernels_a_call']} kernels a call")
            log(f"gp_take_ax0 spread input: kernel {rs['ms']:.4f} ms "
                f"(device alone {rs['device_ms']:.4f}), plain "
                f"{rs['plain_ms']:.4f} ms, library {rs['library_ms']:.4f} "
                f"ms, bytes {nb_s}, bound {b_s:.6f} ms ({by_s}), device "
                f"time / bound {rs['device_ms'] / b_s:.1f}")
        entries.append(e)
    return entries



def gp2_bound(name, tab, k, steps):
    """Least time the card could take for one call of a round-2 probe
    kernel on these inputs: (bound_ms, bound_by, bytes).  Bytes: k (or
    kk) read once, the output written once, and of the table only the
    words these indices touch (computed from the data, each counted once).
    gp2_onehot_f32's function is the gather out[q] = tab[k >> 7, k & 127]
    (0 outside the table), so it is priced as that gather: no operations
    beyond the address, and only the words whose k lies in [0, A x 128).
    Operations: the chains' int32 work (address, add, remainder: 3 a step)
    and the lookups' address at the int32 rate."""
    import torch
    n = k.numel()
    if name in ("gp2_take_ax0", "gp2_take_ax1"):
        dim = 0 if name == "gp2_take_ax0" else 1
        kk = k.to(torch.int64)
        other = torch.arange(kk.shape[1 - dim], device=kk.device)
        other = other[None, :] if dim == 0 else other[:, None]
        other = other.expand_as(kk)
        touched = torch.zeros(tab.shape, dtype=torch.bool, device=tab.device)
        for _ in range(steps):
            if dim == 0:
                touched[kk, other] = True
            else:
                touched[other, kk] = True
            kk = torch.remainder(kk + tab.gather(dim, kk).to(torch.int64),
                                 tab.shape[dim])
        nbytes = 4 * (2 * n + int(touched.sum()))
        t_ops = n * steps * 3 / PEAK_INT32_OPS * 1e3
    elif name == "gp2_col0":
        nbytes = 4 * (2 * n + torch.unique(k).numel())
        t_ops = n * 2 / PEAK_INT32_OPS * 1e3
    else:
        kin = k[(k >= 0) & (k < tab.numel())]
        nbytes = 4 * (2 * n + torch.unique(kin).numel())
        t_ops = n * 2 / PEAK_INT32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else
            "bytes", int(nbytes))


EDGE_BIG_ROWS = 12           # rows of the edge table with |v| in (2^24, 2^30)


def onehot_edge_inputs(seed, dev):
    """A small input for gp2_onehot_f32 past the probe's range: A = 24,
    tab in (-2^23, 2^23) with 2049, 4097 and their negatives in it (values
    a TF32 product would round), its last EDGE_BIG_ROWS rows with |v| in
    (2^24, 2^30), where int32 -> float32 rounds, and the float32 ties
    2^24 + 1, 2^24 + 3, 2^25 + 2, -(2^24 + 1) and the precondition's end
    2^31 - 129 in row 0; k [2, 128] with 0, A x 128 - 1, the ties and
    values below 0, at A x 128 and near +-2^31 (rows outside the table,
    which give 0)."""
    import numpy as np
    import torch
    A = 24
    rng = np.random.default_rng(seed)
    tab = rng.integers(-(1 << 23) + 1, 1 << 23, (A, 128), dtype=np.int32)
    tab.flat[:4] = (2049, 4097, -2049, -4097)
    big = rng.integers((1 << 24) + 1, 1 << 30, (EDGE_BIG_ROWS, 128),
                       dtype=np.int32)
    tab[-EDGE_BIG_ROWS:] = np.where(rng.integers(0, 2, big.shape) == 1, big,
                                    -big)
    tab.flat[4:9] = ((1 << 24) + 1, (1 << 24) + 3, (1 << 25) + 2,
                     -((1 << 24) + 1), (1 << 31) - 129)
    k = rng.integers(-300, A * 128 + 300, (2, 128), dtype=np.int32)
    k.flat[:8] = (0, 1, 2, 3, A * 128 - 1, -1, A * 128, -(1 << 31))
    k.flat[8] = (1 << 31) - 1
    k.flat[9:14] = np.arange(4, 9)
    return torch.from_numpy(tab).to(dev), torch.from_numpy(k).to(dev)


# where the round-2 kernels' code lives, past gather_probe2_kernel.cu
GP2_SOURCES = {"gp2_col0": "bwamem_tpu_torch/csrc/col0.cuh",
               "gp2_take_ax0": "bwamem_tpu_torch/csrc/line_pow.cuh",
               "gp2_take_ax1": "bwamem_tpu_torch/csrc/line_pow.cuh"}


def phase_gather_probe2():
    """Round 2 of the gather probe as its users run it
    (tools/torch_pl_gather_probe2.probe, launch counts from 0; it checks
    every kernel and library call against the plain version and times
    them), then each kernel held against its plain version once more on
    the probe's inputs.  Returns the four kernels-line entries (C's
    [8,128] shape in the *_s8 keys) and kernel D's entry."""
    import torch
    import se_smoke_data as sd
    import torch_pl_gather_probe2 as probe
    from bwamem_tpu_torch.ops import col0, gather_probe2 as gp2
    counters = {"gp2_take_ax0": "launches_take0",
                "gp2_take_ax1": "launches_take1",
                "gp2_col0": "launches_col0",
                "gp2_onehot_f32": "launches_onehot"}
    for c in counters.values():
        setattr(gp2, c, 0)
    t0 = time.perf_counter()
    res = probe.probe(GP2_STEPS, sd.SEED, log)
    torch.cuda.synchronize()
    launches = {n: getattr(gp2, c) for n, c in counters.items()}
    log(f"gather probe 2: launches {launches}; probe A's chain issued from "
        f"PyTorch {res['a_ms']:.4f} ms ({time.perf_counter() - t0:.1f} s)")
    if min(launches.values()) <= 0:
        raise RuntimeError("the gather probe 2 never launched a kernel")
    x = res["inputs"]
    held = {"B take_ax0 [512,128]": (gp2.gp2_take_ax0, gp2.take_ax0_plain,
                                     x["b_tab"], x["b_kk"], 75),
            "C take_ax1 [128,128]": (gp2.gp2_take_ax1, gp2.take_ax1_plain,
                                     x["c128_tab"], x["c128_kk"], 98),
            "C take_ax1 [8,128]": (gp2.gp2_take_ax1, gp2.take_ax1_plain,
                                   x["c8_tab"], x["c8_kk"], 98),
            "D col0 x1024 [78208,8]": (gp2.gp2_col0, col0.plain,
                                       x["d_tab"], x["d_k"], 122),
            "E onehot_f32 Q1024 A640": (gp2.gp2_onehot_f32,
                                        gp2.onehot_f32_plain, x["e_tab"],
                                        x["e_k"], 150)}
    entries = {}
    for label, (kern, plain, tab, k, line) in held.items():
        r = res["results"][label]
        name = r["name"]
        steps = (GP2_STEPS,) if name in ("gp2_take_ax0", "gp2_take_ax1") \
            else ()
        got = kern(tab, k, *steps).to(torch.int64)
        want = plain(tab, k, *steps).to(torch.int64)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        bound_ms, bound_by, nbytes = gp2_bound(name, tab, k, GP2_STEPS)
        log(f"{label} vs plain: {tuple(want.shape)} outputs, "
            f"{int((got != want).sum())} differ, max_abs_err {err}; kernel "
            f"{r['ms']:.4f} ms (device alone {r['device_ms']:.4f}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bytes {nbytes}, bound {bound_ms:.6f} ms ({bound_by}), device "
            f"time / bound {r['device_ms'] / bound_ms:.1f}")
        if err:
            raise RuntimeError(f"{label} disagrees with its plain version")
        if label == "C take_ax1 [8,128]":
            e = entries["gp2_take_ax1"]
            e["max_abs_err"] = max(e["max_abs_err"], err)
            e.update(ms_s8=r["ms"], device_ms_s8=r["device_ms"],
                     plain_ms_s8=r["plain_ms"],
                     library_ms_s8=r["library_ms"], bound_ms_s8=bound_ms,
                     bound_by_s8=bound_by)
            continue
        entries[name] = dict(
            name=name, route="cuda",
            source=GP2_SOURCES.get(
                name, "bwamem_tpu_torch/csrc/gather_probe2_kernel.cu"),
            replaces=f"tools/pl_gather_probe2.py:{line}",
            launches=launches[name], max_abs_err=err, ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=bound_ms, bound_by=bound_by,
            library_ms=r["library_ms"], device_ms=r["device_ms"])
        entries[name].update({k: r[k] for k in COL0_KEYS if k in r})
    tab, k = onehot_edge_inputs(sd.SEED, torch.device("cuda"))
    got = gp2.gp2_onehot_f32(tab, k).to(torch.int64)
    want = gp2.onehot_f32_plain(tab, k).to(torch.int64)
    err = int((got - want).abs().max().item())
    # of the picked words past 2^24, the share that float32 rounds
    hi = (k >> 7).to(torch.int64)
    inside = (hi >= 0) & (hi < tab.shape[0])
    raw = tab.reshape(-1)[k.to(torch.int64).clamp(0, tab.numel() - 1)]
    big = inside & (raw.to(torch.int64).abs() > (1 << 24))
    rounded = float((want != raw.to(torch.int64))[big].float().mean())
    log(f"E onehot_f32 edge input ({tuple(tab.shape)} table in (-2^23, "
        f"2^23), {EDGE_BIG_ROWS} rows in +-(2^24, 2^30) with float32 ties, "
        f"k {tuple(k.shape)} at the ends and outside) vs plain: "
        f"{int((got != want).sum())} differ, max_abs_err {err}; "
        f"{int(big.sum())} picked words past 2^24, {rounded:.2f} of them "
        f"rounded")
    if err:
        raise RuntimeError("gp2_onehot_f32 disagrees with its plain version "
                           "on the edge input")
    if not rounded > 0.5:
        raise RuntimeError("the edge input leaves most words past 2^24 "
                           "unrounded")
    e = entries["gp2_onehot_f32"]
    e["max_abs_err"] = max(e["max_abs_err"], err)
    take2_turns(entries, x)
    return list(entries.values()), entries["gp2_col0"]


def take2_turns(entries, x):
    """Kernels 6B (gp2_take_ax0) and 6C (gp2_take_ax1) held against their
    plain versions through their wrappers, with the designs they replaced
    (tools/torch_take2_variants.check: the probe's inputs x and the wrap
    tables, every step count and size), then ptxas's registers and spills
    of the shipped kernels (a spill or a missing kernel fails), then each
    timed in turns with the design it replaced on the probe's inputs (the
    tool's rounds, on the device alone and between events).  The numbers
    join the kernels-line entries: replaced_device_ms (6C's [8,128] with
    _s8) and `variants` ({input: {shipped | replaced | "shipped, 0 steps":
    dict(device_ms, ms, device_lo, device_hi)}})."""
    import torch_take2_variants as t2v
    t0 = time.perf_counter()
    lib = t2v.library()
    errs, calls = t2v.check(lib, x, log, designs=("replaced",))
    regs = t2v.shipped_ptxas(lib)
    for kern, (r, ss, sl) in sorted(regs.items()):
        log(f"ptxas {kern}: {r} registers, {ss} bytes spill stores, {sl} "
            f"loads")
    if len(regs) < t2v.SHIPPED_KERNELS or any(ss or sl for _, ss, sl in
                                              regs.values()):
        raise RuntimeError(f"a shipped 6B or 6C kernel spills or was not "
                           f"found: {regs}")
    times = t2v.times(lib, x, log, designs=("replaced",), extras=False)
    e = entries["gp2_take_ax0"]
    t = times["6B [512,128]"]
    e.update(max_abs_err=max(e["max_abs_err"], *(
                 v for k, v in errs.items() if k.startswith("6B"))),
             replaced_device_ms=t["replaced"]["device_ms"], variants=t)
    e = entries["gp2_take_ax1"]
    t, t8 = times["6C [128,128]"], times["6C [8,128]"]
    e.update(max_abs_err=max(e["max_abs_err"], *(
                 v for k, v in errs.items() if k.startswith("6C"))),
             replaced_device_ms=t["replaced"]["device_ms"],
             replaced_device_ms_s8=t8["replaced"]["device_ms"],
             variants={"[128,128]": t, "[8,128]": t8})
    log(f"6B and 6C turns: {calls} calls held, "
        f"{time.perf_counter() - t0:.1f} s")


# keys of a kernels-line entry past the contract's: the host issue of the
# kernel's call and of its library call (6D, 6E, 7C); for the column-0
# gathers (6D, 7C, timed back to back) also one call between events, and
# the library call's time on the device alone and in one call
COL0_KEYS = ("issue_us", "library_issue_us", "single_ms", "library_device_ms",
             "library_single_ms")
# the column-0 gather (csrc/col0.cuh) is also held at these lane counts and
# row widths, and on chains of this many launches, each reading the output
# of the launch before
COL0_LANES, COL0_WIDTHS, COL0_CHAIN = (1, 8, 33, 1024), (1, 3, 8), 64


def gp3_bound(name, x):
    """Least time the card could take for one call of a round-3 probe
    kernel on the inputs x (a dict of tab, kk | k | a, b): (bound_ms,
    bound_by, bytes), as gp2_bound counts it.  The chains: kk read once
    and written once, and the table words the chain touches over its
    steps (computed from the data, each counted once); gp3_dg's int32
    operations chain_ops (its step is a fixed map of the line, so the
    composed map's count where that is fewer: 22 an element at 512
    steps, against 3 a step for the step-by-step chain), gp3_ct's 4 a
    step (two loads: its step reads the whole state, so it does not
    compose).
    gp3_col0: k, out and the touched words.  gp3_mm: the function's
    bytes, a[:8], b and out, and its float32 operations, 2 x 8 x K x N
    for the product's 8 rows and 64 x 8 x N adds."""
    import torch
    if name == "gp3_mm":
        K, N = x["b"].shape
        nbytes = 4 * (8 * K + K * N + 8 * N)
        t_ops = (2 * 8 * K * N + 64 * 8 * N) / PEAK_F32_OPS * 1e3
    elif name == "gp3_col0":
        k = x["k"]
        nbytes = 4 * (2 * k.numel() + torch.unique(k).numel())
        t_ops = k.numel() * 2 / PEAK_INT32_OPS * 1e3
    else:
        tab, kk = x["tab"], x["kk"].to(torch.int64)
        touched = torch.zeros(tab.shape, dtype=torch.bool, device=tab.device)
        if name == "gp3_dg":
            axis = x["axis"]
            hi = tab.shape[axis]
            other = torch.arange(kk.shape[1 - axis], device=kk.device)
            other = (other[None, :] if axis == 0 else other[:, None]
                     ).expand_as(kk)
            for _ in range(GP3_STEPS):
                if axis == 0:
                    touched[kk, other] = True
                else:
                    touched[other, kk] = True
                kk = (kk + tab.gather(axis, kk)).clamp(0, hi - 1)
            ops = chain_ops(tab.numel(), kk.numel(), GP3_STEPS)
        else:
            N = tab.shape[0]
            for _ in range(GP3_STEPS):
                col = kk.t().gather(1, kk)          # kk[m, i], m = kk[i, j]
                touched[kk, col] = True
                kk = (kk + tab[kk, col]).clamp(0, N - 1)
            ops = kk.numel() * GP3_STEPS * 4
        nbytes = 4 * (2 * kk.numel() + int(touched.sum()))
        t_ops = ops / PEAK_INT32_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else
            "bytes", int(nbytes))


def phase_gather_probe3():
    """Round 3 of the gather probe as its users run it
    (tools/torch_pl_gather_probe3.probe, launch counts from 0; it holds
    every kernel and library call against the plain version, on the
    probe's inputs, on spread tables and, for gp3_mm, on integer-valued
    inputs, and times them), then each kernel held against its plain
    version once more on the probe's inputs.  Returns the four
    kernels-line entries (7A's B32 and C512 shapes in *_b32 and *_c512
    keys)."""
    import torch
    import se_smoke_data as sd
    import torch_pl_gather_probe3 as probe
    from bwamem_tpu_torch.ops import col0, gather_probe3 as gp3
    counters = {"gp3_dg": "launches_dg", "gp3_ct": "launches_ct",
                "gp3_col0": "launches_col0", "gp3_mm": "launches_mm"}
    for c in counters.values():
        setattr(gp3, c, 0)
    t0 = time.perf_counter()
    res = probe.probe(GP3_STEPS, sd.SEED, log)
    torch.cuda.synchronize()
    launches = {n: getattr(gp3, c) for n, c in counters.items()}
    log(f"gather probe 3: launches {launches} "
        f"({time.perf_counter() - t0:.1f} s)")
    if min(launches.values()) <= 0:
        raise RuntimeError("the gather probe 3 never launched a kernel")
    x = res["inputs"]
    held = {}
    for tag, S, L, axis in probe.DG_SHAPES:
        held[f"7A dg {tag} ax{axis} [{S},{L}]"] = (
            "gp3_dg", dict(tab=x[f"{tag}_tab"], kk=x[f"{tag}_kk"],
                           axis=axis),
            lambda d: gp3.gp3_dg(d["tab"], d["kk"], GP3_STEPS, d["axis"]),
            lambda d: gp3.dg_plain(d["tab"], d["kk"], GP3_STEPS, d["axis"]),
            56)
    held[f"7B ct [{probe.CT_N},{probe.CT_N}]"] = (
        "gp3_ct", dict(tab=x["ct_tab"], kk=x["ct_kk"]),
        lambda d: gp3.gp3_ct(d["tab"], d["kk"], GP3_STEPS),
        lambda d: gp3.ct_plain(d["tab"], d["kk"], GP3_STEPS), 79)
    held[f"7C col0 x{probe.D_LANES} [{probe.D_ROWS},{probe.D_W}]"] = (
        "gp3_col0", dict(tab=x["d_tab"], k=x["d_k"]),
        lambda d: gp3.gp3_col0(d["tab"], d["k"]),
        lambda d: col0.plain(d["tab"], d["k"]), 103)
    held[f"7D mm {probe.E_M}x{probe.E_K}x{probe.E_N} x64"] = (
        "gp3_mm", dict(a=x["e_a"], b=x["e_b"]),
        lambda d: gp3.gp3_mm(d["a"], d["b"]),
        lambda d: gp3.mm_plain(d["a"], d["b"]), 125)
    extra = {lab: err for lab, (err, _) in res["checks"].items()
             if lab not in res["results"]}
    log(f"gather probe 3, the extra inputs (7A's wrapping tables; "
        f"integer-valued a, b for 7D), kernel vs plain max_abs_err: "
        f"{extra}")
    if any(extra.values()):
        raise RuntimeError("a round-3 kernel disagrees with its plain "
                           "version on an extra input")
    entries = {}
    for label, (name, d, kern, plain, line) in held.items():
        r = res["results"][label]
        got = kern(d).double()
        want = plain(d).double()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        bound_ms, bound_by, nbytes = gp3_bound(name, d)
        log(f"{label} vs plain: {tuple(want.shape)} outputs, max_abs_err "
            f"{err} (tolerance {r['tolerance']:.6g}); kernel {r['ms']:.4f} "
            f"ms (device alone {r['device_ms']:.4f}), plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
            f"bytes {nbytes}, bound {bound_ms:.6f} ms ({bound_by}), device "
            f"time / bound {r['device_ms'] / bound_ms:.1f}")
        if err > r["tolerance"]:
            raise RuntimeError(f"{label} disagrees with its plain version")
        if name == "gp3_dg":                      # also where chains move
            tag = label.split()[2]
            sfx = "" if tag == "B8" else "_" + tag.lower()
            rs = res["results"][label + "_spread"]
            b_s, by_s, nb_s = gp3_bound(name, dict(
                tab=x[f"{tag}_tab_spread"], kk=x[f"{tag}_kk_spread"],
                axis=d["axis"]))
            spread = {f"ms_spread{sfx}": rs["ms"],
                      f"device_ms_spread{sfx}": rs["device_ms"],
                      f"plain_ms_spread{sfx}": rs["plain_ms"],
                      f"library_ms_spread{sfx}": rs["library_ms"],
                      f"bound_ms_spread{sfx}": b_s,
                      f"bound_by_spread{sfx}": by_s}
            log(f"{label}_spread: kernel {rs['ms']:.4f} ms (device alone "
                f"{rs['device_ms']:.4f}), plain {rs['plain_ms']:.4f} ms, "
                f"library {rs['library_ms']:.4f} ms, bytes {nb_s}, bound "
                f"{b_s:.6f} ms ({by_s}), device time / bound "
                f"{rs['device_ms'] / b_s:.1f}")
            err = max(err, res["checks"][label + "_spread"][0])
        if name in entries:                       # 7A's B32 and C512
            e = entries[name]
            e.update({f"ms{sfx}": r["ms"], f"device_ms{sfx}": r["device_ms"],
                      f"plain_ms{sfx}": r["plain_ms"],
                      f"library_ms{sfx}": r["library_ms"],
                      f"bound_ms{sfx}": bound_ms, f"bound_by{sfx}": bound_by},
                     **spread)
            e["max_abs_err"] = max(e["max_abs_err"], err)
            continue
        e = dict(name=name, route="cuda",
                 source={"gp3_col0": "bwamem_tpu_torch/csrc/col0.cuh",
                         "gp3_dg": "bwamem_tpu_torch/csrc/line_pow.cuh"}.get(
                     name, "bwamem_tpu_torch/csrc/gather_probe3_kernel.cu"),
                 replaces=f"tools/pl_gather_probe3.py:{line}",
                 launches=launches[name], max_abs_err=err, ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=r["library_ms"],
                 device_ms=r["device_ms"])
        e.update({k: r[k] for k in COL0_KEYS if k in r})
        if name == "gp3_dg":
            e.update(spread)
        if name == "gp3_mm":
            # max_abs_err is the exact check on integer-valued inputs; the
            # probe's normal inputs are held within their rounding bound
            int_label = label + "_int"
            e.update(max_abs_err=res["checks"][int_label][0],
                     normal_inputs_err=err,
                     normal_inputs_tolerance=r["tolerance"],
                     library="torch.matmul(a[:8], b) with TF32 off, then "
                             "the 64 additions")
        if name == "gp3_ct":                # also where the chains move
            sl = label + "_spread"
            rs = res["results"][sl]
            b_s, by_s, nb_s = gp3_bound(name, dict(tab=x["ct_tab_spread"],
                                                   kk=x["ct_kk_spread"]))
            e.update(ms_spread=rs["ms"], device_ms_spread=rs["device_ms"],
                     plain_ms_spread=rs["plain_ms"],
                     library_ms_spread=rs["library_ms"],
                     bound_ms_spread=b_s, bound_by_spread=by_s,
                     max_abs_err=max(err, res["checks"][sl][0]))
            log(f"{sl}: kernel {rs['ms']:.4f} ms (device alone "
                f"{rs['device_ms']:.4f}), plain {rs['plain_ms']:.4f} ms, "
                f"library {rs['library_ms']:.4f} ms, bytes {nb_s}, bound "
                f"{b_s:.6f} ms ({by_s}), device time / bound "
                f"{rs['device_ms'] / b_s:.1f}")
        entries[name] = e
    return list(entries.values())


# gp3_ct is also held at these N (each kind of gather_probe3.CT_KINDS)
# after these steps
CT_HELD_N, CT_HELD_STEPS = (128, 139, 33, 1), (0, 1, 512)


def phase_ct(kerns_gp3):
    """Kernel 7B (gp3_ct) held against ct_plain through its wrapper at
    CT_HELD_N x gather_probe3.CT_KINDS x CT_HELD_STEPS (at N = 128 the
    cluster, at the other N the one block), then timed in turns with the
    design it replaced on the probe's and the spread input
    (tools/torch_ct_variants: its inputs, rounds and timing on the device
    alone and between events; the replaced design is held against
    ct_plain first).  The numbers join 7B's kernels-line
    entry: replaced_device_ms, replaced_device_ms_spread and `variants`
    ({input: {shipped | replaced: dict(device_ms, ms)}})."""
    import torch
    import torch_ct_variants as ctv
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    errs = {}
    for n in CT_HELD_N:
        for kind in gp3.CT_KINDS:
            tab, kk = gp3.ct_inputs(kind, n, ctv.SEEDS[kind], dev)
            for steps in CT_HELD_STEPS:
                want = gp3.ct_plain(tab, kk, steps).to(torch.int64)
                got = gp3.gp3_ct(tab, kk, steps).to(torch.int64)
                torch.cuda.synchronize()
                errs[f"N={n} {kind} steps={steps}"] = int(
                    (got - want).abs().max().item())
    log(f"gp3_ct: {len(errs)} calls at N {CT_HELD_N}, inputs "
        f"{gp3.CT_KINDS}, steps {CT_HELD_STEPS} vs plain: max_abs_err "
        f"{max(errs.values())}")
    bad = {k: v for k, v in errs.items() if v}
    if bad:
        raise RuntimeError(f"gp3_ct disagrees with its plain version: {bad}")
    lib = ctv.libraries(("replaced",))["replaced"]
    x = ctv.make_inputs(dev)
    times = {}
    for kind in ("probe", "spread"):
        tab, kk = x[kind]
        got = ctv.replaced_call(lib, tab, kk)
        if not torch.equal(got, gp3.ct_plain(tab, kk, ctv.STEPS)):
            raise RuntimeError(f"the replaced gp3_ct differs from the plain "
                               f"version on the {kind} input")
        times[kind] = ctv.in_turns({
            "shipped": lambda t=tab, k=kk: gp3.gp3_ct(t, k, ctv.STEPS),
            "replaced": lambda t=tab, k=kk: ctv.replaced_call(lib, t, k)})
        sh, rp = times[kind]["shipped"], times[kind]["replaced"]
        log(f"gp3_ct {kind} input, in turns ({ctv.ROUNDS} rounds): shipped "
            f"(a cluster of {gp3.CT_CLUSTER}) device {sh['device_ms']:.5f} "
            f"ms, "
            f"between events {sh['ms']:.5f}; replaced design device "
            f"{rp['device_ms']:.5f}, between events {rp['ms']:.5f}")
    e = next(e for e in kerns_gp3 if e["name"] == "gp3_ct")
    e.update(max_abs_err=max(e["max_abs_err"], max(errs.values())),
             replaced_device_ms=times["probe"]["replaced"]["device_ms"],
             replaced_device_ms_spread=times["spread"]["replaced"][
                 "device_ms"],
             variants=times)
    log(f"gp3_ct phase: {time.perf_counter() - t0:.1f} s")


# the shipped kernels of 5d and 7A (tools/dg_variants.cu's library holds
# them too, built with -Xptxas -v)
DG_SHIPPED = ("take_in_kernel", "take_col_kernel", "take_out_kernel",
              "gp_take_ax0_kernel", "pow_warp_kernel", "pow_row_kernel",
              "pow_block_kernel")


def phase_take_dg(kerns_gp, kerns_gp3):
    """Kernels 5d (gp_take_ax0) and 7A (gp3_dg) held against their plain
    versions through their wrappers (tools/torch_dg_variants.check: 5d at
    the probe's R, where it takes the column design, on the probe's,
    spread and wrapping inputs after 0, 1, 5 and 16 steps, and at R 1, 33,
    1000, 109376 and 109377, the first R that takes a thread an element; 7A at
    its three shapes on the same kinds after 0, 1, 37, 511 and 512 steps,
    and at shapes of hi 1, 5, 128, 40, 1000 and 2000, the warp-segment,
    warp-a-line and block designs at both axes; the replaced designs the
    same way at
    the timed shapes),
    then ptxas's registers and spills of the shipped kernels (a spill
    fails), then each timed in turns with the design it replaced on the
    probe's and the spread input (the tool's rounds, on the device alone
    and between events).  The numbers join the kernels-line entries:
    replaced_device_ms, replaced_device_ms_spread (7A's B32 and C512 with
    _b32 and _c512) and `variants` ({input: {shipped | replaced:
    dict(device_ms, ms)}}, 7A's by shape)."""
    import torch
    import torch_dg_variants as dgv
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = dgv.library()
    tx, dx = dgv.take_inputs(dev), dgv.dg_inputs(dev)
    errs, calls = dgv.check(lib, tx, dx, log, take_designs=("replaced",),
                            dg_designs=("replaced",))
    regs = {k: v for k, v in dgv.ptxas(lib).items()
            if any(n in k for n in DG_SHIPPED)}
    for kern, (r, ss, sl) in sorted(regs.items()):
        log(f"ptxas {kern}: {r} registers, {ss} bytes spill stores, {sl} "
            f"loads")
    if len(regs) < len(DG_SHIPPED) + 2 or any(ss or sl for _, ss, sl in
                                               regs.values()):
        raise RuntimeError(f"a shipped 5d or 7A kernel spills or was not "
                           f"found: {regs}")
    times = dgv.times(lib, tx, dx, log, take_designs=("replaced",),
                      dg_designs=("replaced",), extras=False)
    e = next(e for e in kerns_gp if e["name"] == "gp_take_ax0")
    e.update(max_abs_err=max(e["max_abs_err"], *(v for k, v in errs.items()
                                                 if k.startswith("5d"))),
             replaced_device_ms=times["5d"]["probe"]["replaced"]["device_ms"],
             replaced_device_ms_spread=times["5d"]["spread"]["replaced"][
                 "device_ms"],
             variants=times["5d"])
    e = next(e for e in kerns_gp3 if e["name"] == "gp3_dg")
    e["max_abs_err"] = max(e["max_abs_err"], *(v for k, v in errs.items()
                                               if k.startswith("7A")))
    e["variants"] = {}
    for tag, *_ in dgv.DG_SHAPES:
        sfx = "" if tag == "B8" else "_" + tag.lower()
        t = times[f"7A {tag}"]
        e[f"replaced_device_ms{sfx}"] = t["probe"]["replaced"]["device_ms"]
        e[f"replaced_device_ms_spread{sfx}"] = \
            t["spread"]["replaced"]["device_ms"]
        e["variants"][tag] = t
    log(f"5d and 7A phase: {calls} calls held, "
        f"{time.perf_counter() - t0:.1f} s")


def phase_col0(kerns_gp2, kerns_gp3):
    """The column-0 gather that gp2_col0 (6D) and gp3_col0 (7C) both launch
    (csrc/col0.cuh): held against its plain version at COL0_LANES x
    COL0_WIDTHS through both wrappers, and on chains of COL0_CHAIN
    launches at 1024 and 8 lanes where each launch reads as k the output
    of the one before (what programmatic dependent launch must wait for);
    then timed in turns beside the design it replaced and tab[k, 0]
    (tools/torch_col0_variants.compare; that tool alone also times the
    kernel's variants and the call's host issue part by part), whose
    numbers (medians of its rounds) join the two kernels-line entries as
    `variants`."""
    import numpy as np
    import torch
    import se_smoke_data as sd
    import torch_col0_variants as variants
    from bwamem_tpu_torch.ops import col0, gather_probe2 as gp2
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    rng = np.random.default_rng(sd.SEED)
    errs = {}
    for n in COL0_LANES:
        for w in COL0_WIDTHS:
            R = 1000
            tab = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (R, w),
                                                dtype=np.int64).astype(
                np.int32)).cuda()
            k = rng.integers(0, R, n, dtype=np.int32)
            k[:2] = (R - 1, 0)[:n]
            k = torch.from_numpy(k).cuda()
            want = col0.plain(tab, k).to(torch.int64)
            for fn in (gp2.gp2_col0, gp3.gp3_col0):
                got = fn(tab, k).to(torch.int64)
                torch.cuda.synchronize()
                errs[f"{fn.__name__} N={n} W={w}"] = int(
                    (got - want).abs().max().item())
    for n in (1024, 8):
        R = 78208
        tab = torch.from_numpy(rng.integers(0, R, (R, 8),
                                            dtype=np.int32)).cuda()
        k0 = torch.from_numpy(rng.integers(0, R, n, dtype=np.int32)).cuda()
        for fn in (gp2.gp2_col0, gp3.gp3_col0):
            got, want = k0, k0
            for _ in range(COL0_CHAIN):
                got = fn(tab, got)
            for _ in range(COL0_CHAIN):
                want = col0.plain(tab, want)
            torch.cuda.synchronize()
            errs[f"{fn.__name__} chain of {COL0_CHAIN} N={n}"] = int(
                (got.to(torch.int64) - want.to(torch.int64)).abs().max()
                .item())
    log(f"col0: {len(errs)} inputs and chains held, max_abs_err "
        f"{max(errs.values())}")
    bad = {k: v for k, v in errs.items() if v}
    if bad:
        raise RuntimeError(f"col0 disagrees with its plain version: {bad}")
    res = variants.compare(variants.libraries(("replaced",)),
                           variants.make_inputs(sd.SEED,
                                                torch.device("cuda")), log)
    for entries, row in ((kerns_gp2, "6D"), (kerns_gp3, "7C")):
        name = "gp2_col0" if row == "6D" else "gp3_col0"
        e = next(e for e in entries if e["name"] == name)
        e["max_abs_err"] = max(e["max_abs_err"], max(errs.values()))
        e["variants"] = res["rows"][row]
        sh, lib = e["variants"]["shipped"], e["variants"]["library"]
        log(f"col0 {row} ({name}), medians of the rounds, against tab[k, "
            f"0]: back to back {sh['ms']:.5f} / {lib['ms']:.5f} ms, device "
            f"alone {sh['device_ms']:.5f} / {lib['device_ms']:.5f} ms, host "
            f"issue {sh['issue_us']:.2f} / {lib['issue_us']:.2f} us; the "
            f"replaced design {e['variants']['replaced']['ms']:.5f} ms, "
            f"{e['variants']['replaced']['device_ms']:.5f} ms, "
            f"{e['variants']['replaced']['issue_us']:.2f} us")


def phase_dispatch_pl_probe():
    """The dispatch probe and the row-body ablation probe as their users
    run them (tools/torch_dispatch_probe.probe, tools/torch_pl_probe.probe
    at the TPU scripts' defaults and inputs, seed 0; launch counts from
    0), then each kernel held against its plain version once more on the
    probes' inputs, and plp_row on a second shape (B = 1000, LQ = 101,
    ROWS = 96) and at both shapes on the match input, dp_eh on its own
    match input at dprobe.MATCH_SHAPES.  Returns the two kernels-line
    entries: dp_eh at ROWS 128
    with *_rows8, *_rows512 and *_rows2048 keys, plp_row at `full` with a
    key set for each other variant."""
    import torch
    import torch_dispatch_probe as dprobe
    import torch_pl_probe as pprobe
    from bwamem_tpu_torch.ops import dispatch_probe as dp
    from bwamem_tpu_torch.ops import pl_probe as plp
    dp.launches = 0
    plp.launches.update(dict.fromkeys(plp.VARIANTS, 0))
    t0 = time.perf_counter()
    dres = dprobe.probe(0, log)
    pres = pprobe.probe(seed=0, log=log)
    torch.cuda.synchronize()
    dp_launches, plp_launches = dp.launches, dict(plp.launches)
    log(f"dispatch and row-body probes: launches dp_eh {dp_launches}, "
        f"plp_row {plp_launches} ({time.perf_counter() - t0:.1f} s)")
    if dp_launches <= 0 or min(plp_launches.values()) <= 0:
        raise RuntimeError("a probe never launched dp_eh or a plp_row "
                           "variant")

    # the shipped plans on the probe's inputs, then the short-run plan and
    # each width of the cell (32 and 16x2 bits) at every ROWS
    dp_err = dprobe.check(dres["inputs"])
    for p in (dp.PLAN_SHORT, *(dp.PLAN._replace(bits=b) for b in dp.BITS)):
        dp_err = max(dp_err, dprobe.check(dres["inputs"], p))
    log(f"dp_eh vs plain on the probe's {len(dres['inputs']['rows']) + 1} "
        f"inputs (ROWS {tuple(dres['rows'])}), the shipped plans {dp.PLAN} "
        f"and {dp.PLAN_SHORT}, and bits {dp.BITS}: max_abs_err {dp_err}")
    # On those eh falls to 0 within a few steps and out hangs on the last
    # few target rows only, whatever a tile did with the chunks of tT it
    # staged before: every plan again on the match input, where eh climbs
    dp_err_m, n_m = dprobe.check_match(0, log)
    log(f"dp_eh vs plain on the match input, {n_m} calls at (L1p, B, ROWS) "
        f"{dprobe.MATCH_SHAPES}: max_abs_err {dp_err_m}")
    dp_err = max(dp_err, dp_err_m)
    qT, tT = pres["inputs"]
    errs = {v: pprobe.max_err(qT, tT, v, pres["LQ"]) for v in plp.VARIANTS}
    q2, t2 = pprobe.make_inputs(1, 1000, 101, 96, torch.device("cuda"))
    errs2 = {v: pprobe.max_err(q2, t2, v, 101) for v in plp.VARIANTS}
    log(f"plp_row vs plain, out and aux, max_abs_err: probe's inputs "
        f"{errs}; B=1000 LQ=101 (L1p {q2.shape[0]}) ROWS=96 {errs2}")
    if dp_err or any(errs.values()) or any(errs2.values()):
        raise RuntimeError("dp_eh or plp_row disagrees with its plain "
                           "version")
    # On the probe's inputs the states of noreduce, full and roll fall to 0
    # and stay there, so out ends all 0 and aux the same in every lane
    # whatever the scan, the shift and the reductions do: every variant is
    # held once more on the match input (tools/torch_pl_probe.draw), where
    # states grow, at both shapes.
    errs_m = {}
    for seed, (B, LQ, R) in ((0, (pprobe.DEFAULT_B, pprobe.DEFAULT_LQ,
                                  pprobe.DEFAULT_ROWS)), (1, (1000, 101, 96))):
        qm, tm = pprobe.make_inputs(seed, B, LQ, R, torch.device("cuda"),
                                    "match")
        errs_m.update({f"{v}_B{B}": pprobe.max_err(qm, tm, v, LQ)
                       for v in plp.VARIANTS})
        out, aux = plp.plp_plain(qm, tm, "full", LQ)
        top = int(out.max())
        distinct = [int(a.unique().numel()) for a in aux]
        log(f"match input B={B} LQ={LQ} ROWS={R}: out max {top}, nonzero "
            f"{int((out != 0).sum())} of {out.numel()}; distinct mj_enc, "
            f"h1_enc, lst over lanes {distinct}")
        if top <= 20 or min(distinct[0], distinct[2]) < 2 \
                or (B == 1000 and distinct[1] < 2):
            raise RuntimeError(f"the match input at B={B} did not make the "
                               f"states grow (out max {top}, distinct aux "
                               f"{distinct})")
    # and query rows that are no multiple of G or of the rows a thread
    # (the probes' L1p are multiples of 8)
    qr, tr = (torch.from_numpy(a).cuda()
              for a in pprobe.draw(2, 21, 1000, 12, "match"))
    errs_m.update({f"{v}_L1p21": pprobe.max_err(qr, tr, v, 17)
                   for v in plp.VARIANTS})
    # and lanes that are no multiple of eh_only's 4 a thread (it takes 1)
    qo, to = (torch.from_numpy(a).cuda()
              for a in pprobe.draw(3, 104, 1001, 96, "match"))
    errs_m.update({f"{v}_B1001": pprobe.max_err(qo, to, v, 101)
                   for v in plp.VARIANTS})
    # and the group design at each G, its chunk in registers and in shared
    # memory, on the second shape's match input and at L1p 21
    qm, tm = pprobe.make_inputs(1, 1000, 101, 96, torch.device("cuda"),
                                "match")
    for label, (q, t, LQ) in (("B1000", (qm, tm, 101)),
                              ("L1p21", (qr, tr, 17))):
        for G in plp.GROUPS:
            for st in plp.STORAGE:
                for v in ("noscan", "noreduce", "full"):
                    p = plp.plan(v, q.shape[0], q.shape[1], G=G, storage=st)
                    errs_m[f"{v}_{label}_G{G}_{st}"] = pprobe.max_err(
                        q, t, v, LQ, p)
        errs_m[f"roll_{label}_shared"] = pprobe.max_err(
            q, t, "roll", LQ, plp.plan("roll", q.shape[0], q.shape[1],
                                       storage="shared"))
    log(f"plp_row vs plain on the match input, out and aux, max_abs_err "
        f"{max(errs_m.values())} over {len(errs_m)} calls: {errs_m}")
    if any(errs_m.values()):
        raise RuntimeError("plp_row disagrees with its plain version on "
                           "the match input")
    # no time may read under its bound
    under = [f"dp_eh ROWS {r}" for r, e in dres["rows"].items()
             if e["device_ms"] < e["bound_ms"]]
    under += [f"plp_row {v}" for v, e in pres["results"].items()
              if e["device_ms"] < e["bound_ms"]]
    if under:
        raise RuntimeError(f"device times under their bound: {under}")

    e_dp = dict(name="dp_eh", route="cuda",
                source="bwamem_tpu_torch/csrc/dispatch_probe_kernel.cu",
                replaces="tools/dispatch_probe.py:32", launches=dp_launches,
                max_abs_err=dp_err, library_ms=None, plan=dp.PLAN._asdict(),
                plan_short=dp.PLAN_SHORT._asdict())
    for r, res in dres["rows"].items():
        sfx = "" if r == dprobe.PIPE_ROWS else f"_rows{r}"
        e_dp.update({f"{k}{sfx}": res[k] for k in (
            "ms", "device_ms", "fetch_ms", "plain_ms", "bound_ms",
            "bound_by")})
    e_dp["issue_us"] = dres["issue"]
    e_dp["copy_ms"] = {f"{k}_{a}x{b}": v for k in ("d2h", "h2d")
                       for (a, b), v in dres[k].items()}

    res = pres["results"]
    e_pl = dict(name="plp_row", route="cuda",
                source="bwamem_tpu_torch/csrc/pl_probe_kernel.cu",
                replaces="tools/pl_probe.py:36",
                launches=sum(plp_launches.values()),
                launches_by_variant=plp_launches,
                plan={v: list(plp.plan(v, qT.shape[0], qT.shape[1]))
                      for v in plp.VARIANTS},
                max_abs_err=max([*errs.values(), *errs2.values(),
                                 *errs_m.values(),
                                 *(r["max_abs_err"] for r in res.values())]),
                library_ms=None)
    for v in plp.VARIANTS:
        sfx = "" if v == "full" else f"_{v}"
        e_pl.update({f"{k}{sfx}": res[v][k] for k in (
            "ms", "device_ms", "fetch_ms", "plain_ms", "bound_ms",
            "bound_by")})
    return [e_dp, e_pl]


# ------------------------------------------------------------------ phase 3

class WidestCall:
    """Wraps a kernel wrapper of ops/ext_kernel for one main-path run: the
    launch count starts at 0, and a copy of the widest call (most lanes
    times target rows; a call with over 4095 query rows before any other;
    with `live`, most lanes with a query) is kept so the kernel can be
    held against its plain version on lanes the main path built."""

    def __init__(self, name, counter, live=False):
        from bwamem_tpu_torch.ops import ext_kernel
        self.mod, self.name, self.counter = ext_kernel, name, counter
        self.wrapper = getattr(ext_kernel, name)
        self.live = live
        self.size, self.args, self.kw = (False, 0), None, None

    def __call__(self, *args, **kw):
        size = (kw["lq_max"] > 4095, int((args[1] > 0).sum()) if self.live
                else args[1].shape[0] * kw["t_max"])
        if size >= self.size:
            self.size, self.kw = size, dict(kw)
            self.args = [a.clone() for a in args]
        return self.wrapper(*args, **kw)

    def __enter__(self):
        setattr(self.mod, self.name, self)
        setattr(self.mod, self.counter, 0)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.wrapper)
        self.launches = getattr(self.mod, self.counter)


def primary_start(sam, read_len):
    """(contig, 0-based start less the clipped bases before it, MAPQ) of
    the primary line of one read's SAM, or None when the read is unmapped
    or the line does not cover the read."""
    for line in sam.splitlines():
        f = line.split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        if flag & 4:
            return None
        clip = re.match(r"(\d+)[SH]", f[5])
        qlen = sum(int(n) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", f[5])
                   if op in "MIS=XH")
        if qlen != read_len:
            return None
        return (f[2], int(f[3]) - 1 - (int(clip.group(1)) if clip else 0),
                int(f[4]))
    return None


def placement(read, sam):
    """Where the read's primary SAM line puts it, against where simdata
    sampled it: the read is named rd<i>_<contig>_<0-based start>, and the
    start of the alignment, less the clipped bases before it, must lie
    within 20 + L/50 bases of that start (indels shift it by a few
    bases).  "origin", or "repeat" for another place at a mapping quality
    under 20 (the genome carries repeats), else "wrong"."""
    contig, start = read.name.split("_", 1)[1].rsplit("_", 1)
    qlen = read.seq.shape[0]
    got = primary_start(sam, qlen)
    if got is None:
        return "wrong"
    if got[0] == contig and abs(got[1] - int(start)) <= 20 + qlen // 50:
        return "origin"
    return "repeat" if got[2] < 20 else "wrong"


def check_sams(label, sams, reads, min_mapped=0.9, min_origin=0.8,
               max_wrong=0.01):
    """Every read has SAM; nearly all are mapped, and mapped where they
    were sampled (every read of the path, not only the ones rerun)."""
    if len(sams) != len(reads) or not all(s.endswith("\n") for s in sams):
        raise RuntimeError(f"{label}: SAM output does not cover every read")
    mapped = sum(1 for s in sams if not (int(s.split("\t")[1]) & 4))
    where = [placement(r, s) for r, s in zip(reads, sams)]
    origin, wrong = where.count("origin"), where.count("wrong")
    log(f"{label}: mapped {mapped}/{len(sams)} reads; {origin} at the "
        f"position they were sampled from, {where.count('repeat')} at "
        f"another copy of a repeat, {wrong} unmapped or misplaced")
    if mapped < min_mapped * len(sams):
        raise RuntimeError(f"{label}: only {mapped} of {len(sams)} reads "
                           f"mapped")
    if origin < min_origin * len(sams) or wrong > max_wrong * len(sams):
        raise RuntimeError(f"{label}: {origin} of {len(sams)} reads are "
                           f"aligned where they were sampled and {wrong} "
                           f"are misplaced")


def check_cpu(label, cpu_al, reads, sams, k):
    """Rerun the first k reads on the CPU: byte-identical SAM (so the same
    reads are unmapped in both).  Returns the CPU's SAM."""
    t1 = time.perf_counter()
    cpu = cpu_al.align_batch_se(reads[:k])
    if cpu != sams[:k]:
        bad = [i for i in range(k) if cpu[i] != sams[i]]
        raise RuntimeError(f"{label}: GPU and CPU SAM differ on {len(bad)} "
                           f"of {k} reads (first {bad[:5]}):\n"
                           f"{sams[bad[0]]}{cpu[bad[0]]}")
    log(f"{label}: CPU rerun of {k} reads: SAM identical "
        f"({time.perf_counter() - t1:.1f} s)")
    return cpu


def check_sub_batch(label, al, reads, sams, k):
    """Rerun the first k reads on the card as a batch of their own (other
    tensor sizes, lane tiles and row positions): byte-identical SAM."""
    import torch
    t1 = time.perf_counter()
    sub = al.align_batch_se(reads[:k])
    torch.cuda.synchronize()
    if sub != sams[:k]:
        bad = [i for i in range(k) if sub[i] != sams[i]]
        raise RuntimeError(f"{label}: SAM of {len(bad)} of the first {k} "
                           f"reads depends on the batch they are in (first "
                           f"{bad[:5]}):\n{sams[bad[0]]}{sub[bad[0]]}")
    log(f"{label}: rerun of {k} reads as their own batch on the card: SAM "
        f"identical ({time.perf_counter() - t1:.1f} s)")


def phase_main(idx, cpu_al):
    """The 101 bp path: device front + ext_pl2_kernel.  Returns the
    aligner, the two kernels' hooks (launch count, widest call) and the
    reads rerun on the CPU with the CPU's SAM."""
    import torch
    from bwamem_tpu_torch.io.fastq import read_fastx
    from bwamem_tpu_torch.pipeline.align import Aligner, align_stream
    from bwamem_tpu_torch.utils import timers
    import se_smoke_data as sd
    _, fq = sd.smoke_data(log)
    reads = list(read_fastx(fq))
    assert len(reads) == sd.BATCH * sd.N_BATCHES
    batches = [reads[k * sd.BATCH:(k + 1) * sd.BATCH]
               for k in range(sd.N_BATCHES)]
    # batch 0 once more behind the last: align_stream enqueues a batch's
    # front during the tail of the batch before, so only a batch with one
    # on either side pays both a front and a tail; the extra batch's SAM
    # is dropped
    stream = batches + batches[:1]
    al = Aligner(idx, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    timers.enable(True)
    sams, walls = [], []
    t0 = time.perf_counter()
    tb = t0
    with WidestCall("extend_batch_pl2", "launches") as pl2, \
            WidestCall("extend_batch_pl", "launches_pl") as pl:
        for k, (n, ss) in enumerate(align_stream(al, stream)):
            torch.cuda.synchronize()
            now = time.perf_counter()
            walls.append(now - tb)
            log(f"batch {k}: {n} reads in {now - tb:.3f} s")
            tb = now
            if k < len(batches):
                sams.extend(ss)
    wall = time.perf_counter() - t0
    timers.enable(False)
    snap = timers.snapshot()
    no_fetch_timeouts("main path", snap)
    peak = torch.cuda.max_memory_allocated()
    fb = snap.get("front.fallback_rows.count", 0)
    log(f"main path: {sum(map(len, stream))} reads in {wall:.3f} s = "
        f"{sum(map(len, stream)) / wall:.1f} reads/s; batch 1 in mid-stream "
        f"{len(stream[1]) / walls[1]:.1f} reads/s; the last batch "
        f"({walls[-1]:.3f} s) is a host tail only; on "
        f"{torch.cuda.get_device_name(0)}")
    log("stage timers:\n" + timers.report())
    log(f"ext_pl2_kernel launches: {pl2.launches}; ext_pl_kernel launches: "
        f"{pl.launches}; fallback rows: {fb}; peak CUDA memory: "
        f"{peak / 2**20:.1f} MiB")
    if pl2.launches <= 0:
        raise RuntimeError("the main path never launched the CUDA kernel")
    if pl.launches != 0:
        raise RuntimeError(f"101 bp path: the one-pass kernel belongs to the "
                           f"long-read side path, got {pl.launches} launches")
    if fb != 0:
        raise RuntimeError(f"{fb} fallback rows")
    check_sams("main path", sams, reads)
    cpu = check_cpu("main path", cpu_al, reads, sams, CPU_CHECK_READS)
    return al, pl2, pl, (reads[:CPU_CHECK_READS], cpu), (batches, sams)


def front_regs(al, reads):
    """The main path's regions before dedup (Aligner._regs_from_device up
    to its dedup): the device front, its fallback rows through the
    host-compacted front.  Returns (per-read AlnReg lists, fallback rows,
    packed batch)."""
    from bwamem_tpu_torch.pipeline import device_front
    front = al.begin_batch(reads)
    if front["tok"] is None:
        raise RuntimeError("seedchain: the device front did not take the "
                           "batch")
    out, fb_rows = device_front.front_finish(al, front["tok"])
    if fb_rows:
        sub = al._regs_host_front([reads[i] for i in fb_rows])
        for gi, i in enumerate(fb_rows):
            out[i] = sub[gi]
    return out, fb_rows, front


def tied_rows(res, min_chain_weight):
    """Reads whose heavy chains hold two equal weights: there the
    single-program filter (ops/chain.filter_chains) orders the tied chains
    stably, where the main path replays ks_introsort's order
    (native/hostops.c on the device front, pipeline/chainflt_host.
    fix_tied_rows on the host-compacted front), so the order of their
    regions, and the kept set, may differ."""
    import torch
    w, n = res.weights, res.chains.n
    C = w.shape[1]
    heavy = ((torch.arange(C, device=w.device)[None, :] < n[:, None])
             & (w >= min_chain_weight))
    ws = torch.sort(torch.where(heavy, w.to(torch.int64), -1), dim=1).values
    return ((ws[:, 1:] == ws[:, :-1]) & (ws[:, 1:] >= 0)).any(dim=1)


def replay_tied(al, seq, l_seq, res, rows, reg_cap):
    """The single-program extension (ops/align_ext.extend_all) of reads
    `rows` again, on the single-program's seeds and chains, with the
    chains kept and ordered as mem_chain_flt keeps them: pipeline/
    chainflt_host.chain_flt_exact (ks_introsort's permutation of equal
    weights, and the kept set it leads to) in place of ops/chain.
    filter_chains' stable order.  Returns (Regs of `rows`, the number of
    those reads whose kept chain set differs from the stable filter's)."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops import align_ext
    from bwamem_tpu_torch.pipeline import seedchain
    from bwamem_tpu_torch.pipeline.chainflt_host import chain_flt_exact
    opt = al.opt
    idx = torch.as_tensor(rows, dtype=torch.int64, device=seq.device)
    seeds, chains, fl = (type(t)(*(x[idx] for x in t))
                         for t in (res.seeds, res.chains, res.filtered))
    ch = {f: getattr(chains, f).cpu().numpy()
          for f in ("pos", "first_qbeg", "last_qbeg", "last_len", "is_alt",
                    "n")}
    w = res.weights[idx].cpu().numpy()
    st_order, st_kept = fl.order.cpu().numpy(), fl.kept.cpu().numpy()
    C = w.shape[1]
    order = np.tile(np.arange(C, dtype=st_order.dtype), (len(rows), 1))
    kept = np.zeros_like(st_kept)
    kept_diff = 0
    for k in range(len(rows)):
        nc = int(ch["n"][k])
        trav = sorted(range(nc), key=lambda c: (int(ch["pos"][k, c]), c))
        ids = chain_flt_exact(
            trav, w[k], ch["first_qbeg"][k],
            ch["last_qbeg"][k] + ch["last_len"][k], ch["is_alt"][k],
            mask_level=opt.mask_level, drop_ratio=opt.drop_ratio,
            min_seed_len=opt.min_seed_len, max_chain_gap=opt.max_chain_gap,
            min_chain_weight=opt.min_chain_weight,
            max_chain_extend=opt.max_chain_extend)
        order[k] = ids + [c for c in range(C) if c not in ids]
        kept[k, :len(ids)] = 1
        kept_diff += set(ids) != set(st_order[k][st_kept[k] > 0].tolist())
    order_t = torch.from_numpy(order).to(fl.order.device)
    fl = fl._replace(order=order_t, kept=torch.from_numpy(kept).to(fl.kept),
                     w=torch.gather(res.weights[idx], 1,
                                    order_t.to(torch.int64)).to(fl.w.dtype))
    regs = align_ext.extend_all(
        al.fm, al.ctg_offsets, al.ctg_is_alt, seq[idx], l_seq[idx], seeds,
        chains, fl, **seedchain.extend_kw(opt), reg_cap=reg_cap)
    return regs, kept_diff


def reg_lists(regs):
    """Per-read lists of the SC_REG_FIELDS tuples of a Regs."""
    cols = {f: getattr(regs, f).cpu().numpy() for f in SC_REG_FIELDS}
    return [[tuple(int(cols[f][i, j]) for f in SC_REG_FIELDS)
             for j in range(n)] for i, n in enumerate(regs.n.cpu().numpy())]


def phase_seedchain(al, cpu_al, se_run):
    """The single-program front half (pipeline/seedchain.align_regs:
    collect_intervals, expand_seeds, chaining, extend_all with kernel #1)
    on the card over batch 0 of the main path's 101 bp stream, held read by
    read against the main path's regions before dedup (the device front
    and its fallback rows) on every read no overflow flag takes out: as it
    ran on reads whose heavy chains hold no tied weight, and rerun with
    mem_chain_flt's tie order (replay_tied) on the others; and against its
    own plain run on the CPU for the first reads.  Returns the kernel #1
    hook (launches, widest call; ext_pl_kernel's launches in pl_launches)."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.ops import ext_kernel
    from bwamem_tpu_torch.ops.smem import SeedingCaps
    from bwamem_tpu_torch.pipeline import seedchain
    caps = SeedingCaps(cand1=SC_CAND1)
    reads = se_run[0][0][:SC_READS]
    n = len(reads)
    t0 = time.perf_counter()
    main_regs, fb_rows, front = front_regs(al, reads)
    t_main = time.perf_counter() - t0
    seq = torch.from_numpy(front["seq"]).to(al.device)
    l_seq = torch.from_numpy(front["l_seq"]).to(al.device)

    plain = []
    saved = {}
    for name in ("extend_batch_pl2_plain", "extend_batch_pl_plain"):
        saved[name] = fn = getattr(ext_kernel, name)
        setattr(ext_kernel, name, lambda *a, _n=name, _f=fn, **k: (
            plain.append(_n), _f(*a, **k))[1])
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with WidestCall("extend_batch_pl2", "launches", live=True) as pl2, \
                WidestCall("extend_batch_pl", "launches_pl") as pl:
            res, regs = seedchain.align_regs(
                al.fm, al.ctg_offsets, al.ctg_is_alt, seq, l_seq, al.opt,
                caps=caps)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        flagged = (res.intervals.overflow | res.seeds.overflow
                   | res.chains.overflow | regs.overflow)[:n].cpu().numpy()
        tied = tied_rows(res, al.opt.min_chain_weight)[:n].cpu().numpy()
        rows = np.flatnonzero(tied & ~flagged)
        t2 = time.perf_counter()
        with WidestCall("extend_batch_pl2", "launches") as rpl2, \
                WidestCall("extend_batch_pl", "launches_pl") as rpl:
            rep, kept_diff = replay_tied(al, seq, l_seq, res, rows,
                                         regs.score.shape[1])
            torch.cuda.synchronize()
        t_rep = time.perf_counter() - t2
    finally:
        for name, fn in saved.items():
            setattr(ext_kernel, name, fn)
    log(f"seedchain: align_regs over {n} reads of {seq.shape[1]} rows on "
        f"the card in {wall:.3f} s = {n / wall:.1f} reads/s; "
        f"ext_pl2_kernel launches {pl2.launches}, ext_pl_kernel launches "
        f"{pl.launches}, plain extensions reached {len(plain)}; the main "
        f"path's front for the same reads {t_main:.3f} s ({len(fb_rows)} "
        f"fallback rows); the tied reads' replay {t_rep:.3f} s "
        f"(ext_pl2_kernel launches {rpl2.launches}, ext_pl_kernel "
        f"{rpl.launches}); on {torch.cuda.get_device_name(0)}")
    if plain:
        raise RuntimeError(f"seedchain: the plain extension ran on the card "
                           f"({sorted(set(plain))})")
    if pl2.launches <= 0 or pl.launches != 0:
        raise RuntimeError(f"seedchain: expected ext_pl2_kernel only, got "
                           f"{pl2.launches} and {pl.launches} launches")

    rep_flag = rep.overflow.cpu().numpy()
    flagged[rows[rep_flag]] = True
    got = reg_lists(regs)
    stable = {}
    for i, r in zip(rows, reg_lists(rep)):
        stable[i], got[i] = got[i], r
    want = [[tuple(int(getattr(r, f)) for f in SC_REG_FIELDS) for r in rs]
            for rs in main_regs]
    cmp = np.flatnonzero(~flagged)
    bad = [i for i in cmp if got[i] != want[i]]
    tied_diff = [i for i in stable if not flagged[i] and stable[i] != want[i]]
    tied_perm = sum(sorted(stable[i]) == sorted(want[i]) for i in tied_diff)
    log(f"seedchain: regions of {cmp.size} reads compared with the main "
        f"path's before dedup ({sum(len(got[i]) for i in cmp)} regions), "
        f"{len(bad)} differ; {int(flagged.sum())} reads flagged "
        f"by an overflow (intervals {int(res.intervals.overflow[:n].sum())}, "
        f"seeds {int(res.seeds.overflow[:n].sum())}, chains "
        f"{int(res.chains.overflow[:n].sum())}, regions "
        f"{int(regs.overflow[:n].sum())}, regions of the replay "
        f"{int(rep_flag.sum())}); {len(rows)} reads with tied chain "
        f"weights, compared as replayed with mem_chain_flt's tie order: "
        f"the stable filter's regions differ from the main path's on "
        f"{len(tied_diff)} of them ({tied_perm} the same regions in another "
        f"order), its kept chain set from the replay's on {kept_diff}")
    if bad:
        i = bad[0]
        raise RuntimeError(
            f"seedchain: regions of {len(bad)} reads differ from the main "
            f"path's (first {bad[:5]}, of them tied "
            f"{[j for j in bad[:5] if j in stable]}): read {reads[i].name}"
            f"\n{got[i]}\n{want[i]}")
    if flagged.sum() > SC_MAX_FLAGGED * n:
        raise RuntimeError(f"seedchain: {int(flagged.sum())} of {n} reads "
                           f"flagged by an overflow")

    k = SC_CPU_READS
    t3 = time.perf_counter()
    cres, cregs = seedchain.align_regs(
        cpu_al.fm, cpu_al.ctg_offsets, cpu_al.ctg_is_alt, seq[:k].cpu(),
        l_seq[:k].cpu(), cpu_al.opt, caps=caps)
    diff = [f for f in type(regs)._fields
            if not torch.equal(getattr(regs, f)[:k].cpu(), getattr(cregs, f))]
    log(f"seedchain: CPU run of the first {k} reads "
        f"({time.perf_counter() - t3:.1f} s): "
        + (f"fields {diff} differ" if diff else "every Regs field equal"))
    if diff:
        raise RuntimeError(f"seedchain: card and CPU differ on {diff}")
    log(f"seedchain: phase {time.perf_counter() - t0:.1f} s")
    pl2.wall, pl2.pl_launches = wall, pl.launches
    return pl2


class ChainCalls:
    """Wraps ops/chain.chain_seeds for a main-path run: the launch count
    starts at 0, every call is counted, and a copy of the arguments of
    the call with the most seed slots (N x S) is kept, so the kernel can
    be held against the plain loop on a batch's real EXPAND output."""

    def __init__(self):
        from bwamem_tpu_torch.ops import chain as chainops
        self.mod, self.wrapper = chainops, chainops.chain_seeds
        self.calls, self.slots, self.args = 0, -1, None

    def __call__(self, seeds, *args, **kw):
        import inspect
        self.calls += 1
        if seeds.rbeg.numel() >= self.slots:
            a = inspect.signature(self.wrapper).bind(seeds, *args,
                                                     **kw).arguments
            self.slots = seeds.rbeg.numel()
            self.args = (type(seeds)(*(x.clone() for x in seeds)),
                         a["ctg_is_alt"].clone(), a["l_pac"], a["w"],
                         a["max_chain_gap"], a["chain_cap"])
        return self.wrapper(seeds, *args, **kw)

    def __enter__(self):
        self.mod.chain_seeds = self
        self.mod.launches = 0
        return self

    def __exit__(self, *exc):
        self.mod.chain_seeds = self.wrapper
        self.launches = self.mod.launches


def chain_bytes(seeds, C):
    """Bytes chain_kernel must move: the valid grid and the valid seeds'
    four fields read once, the [N, C] chain fields (three of the index
    type, five int32, one byte), n, overflow and the [N, S] seed_chain
    written once."""
    it = seeds.rbeg.element_size()
    N, S = seeds.rbeg.shape
    nv = int(seeds.valid.sum())
    return N * S + nv * (it + 12) + N * C * (3 * it + 21) + N * 5 + N * S * 4


def hold_chain(label, seeds, alt_of, l_pac, w, gap, C, timed=True):
    """chain_kernel against the plain lockstep loop on one input, every
    Chains field exact; with `timed`, the kernel's device time (medians of
    CHAIN_ROUNDS rounds between events), its bound by bytes, the plain
    loop's time (one run between events) and the kernel alone on the row
    with the most seeds (the serial walk's floor).  Returns the line's
    numbers."""
    import torch
    from bwamem_tpu_torch.ops import chain as chainops
    args = (alt_of, l_pac, w, gap, C)
    n0 = chainops.launches
    got = chainops.chain_seeds(seeds, *args)
    torch.cuda.synchronize()
    if chainops.launches != n0 + 1:
        raise RuntimeError(f"chain {label}: the kernel did not launch")
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    want = chainops.chain_seeds_plain(seeds, *args)
    b.record()
    torch.cuda.synchronize()
    plain_ms = a.elapsed_time(b)
    bad = [f for f in want._fields
           if not torch.equal(getattr(want, f), getattr(got, f))]
    per_row = seeds.valid.sum(dim=1)
    out = dict(label=label, N=seeds.rbeg.shape[0], S=seeds.rbeg.shape[1],
               C=C, itype=str(seeds.rbeg.dtype).split(".")[-1],
               seeds=int(per_row.sum()), most_seeds=int(per_row.max()),
               most_chains=int(want.n.max()),
               overflow_rows=int(want.overflow.sum()), plain_ms=plain_ms)
    if bad:
        raise RuntimeError(f"chain {label}: fields {bad} differ from the "
                           f"plain loop")
    if timed:
        out["ms"] = median_ms(lambda: chainops.chain_seeds(seeds, *args),
                              reps=CHAIN_ROUNDS)
        out["bound_ms"] = chain_bytes(seeds, C) / PEAK_BYTES * 1e3
        r = int(per_row.argmax())
        one = type(seeds)(*(x[r:r + 1] for x in seeds))
        out["heaviest_row_ms"] = median_ms(
            lambda: chainops.chain_seeds(one, *args), reps=CHAIN_ROUNDS)
        if out["ms"] < out["bound_ms"]:
            raise RuntimeError(f"chain {label}: {out['ms']} ms under its "
                               f"bound {out['bound_ms']} ms")
    log(f"chain {label}: every field equal to the plain loop; "
        + ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else f"{k} {v}"
                    for k, v in out.items() if k != "label"))
    return out


def phase_chain(main=None):
    """Kernel chain_kernel (csrc/chain_kernel.cu, ops/chain.chain_seeds on
    CUDA tensors) against the plain lockstep loop on the card, exact on
    every Chains field: its ptxas line; tools/torch_chain_cases's crafted
    grids at both index types (also held to the sequential mem_chain);
    a heavy-tailed random grid at N = CHAIN_N, S = C = CHAIN_S (int32,
    the benchmark's index type) and one of 8192 rows at int64; and, with
    `main` = (aligner, batches, paired, label), the widest CHAIN call of
    the main path streaming those batches (its real EXPAND output), whose
    launch count must have risen.  Each timed input prints the kernel's
    device time, its bound by bytes and the plain loop's time.  Returns
    the kernel's entry of the kernels line."""
    import numpy as np
    import torch
    from bwamem_tpu_torch._build import BUILD_DIR
    from bwamem_tpu_torch.ops import chain as chainops
    import torch_chain_cases as cc
    t0 = time.perf_counter()
    chainops.LIB.load()
    log(f"build chain_kernel.cu (nvcc sm_90a): "
        f"{time.perf_counter() - t0:.1f} s")
    for line in open(os.path.join(BUILD_DIR, chainops.LIB.so_name
                                  + ".log")):
        if re.search(r"registers|spill|Compiling entry", line):
            log("ptxas " + line.strip())
            if re.search(r"[1-9]\d* bytes spill", line):
                raise RuntimeError("chain_kernel spills: " + line.strip())
    dev = torch.device("cuda")

    def on_card(grids):
        N = grids[0].shape[0]
        return chainops.Seeds(
            *(torch.from_numpy(np.ascontiguousarray(g)).to(dev)
              for g in grids), frac_rep=torch.zeros(N, device=dev),
            overflow=torch.zeros(N, dtype=torch.bool, device=dev))

    chainops.launches = 0
    for name in cc.CASES:
        for itype in cc.ITYPES:
            grids, alt_of, p, want = cc.case(name, itype)
            got = chainops.chain_seeds(
                on_card(grids), torch.from_numpy(alt_of).to(dev),
                p["l_pac"], p["w"], p["gap"], p["C"])
            bad = [f for f in cc.FIELDS if not np.array_equal(
                getattr(got, f).cpu().numpy(), want[f])]
            if bad:
                raise RuntimeError(f"chain case {name} {itype}: fields "
                                   f"{bad} differ from the sequential "
                                   f"mem_chain")
            hold_chain(f"case {name} {itype}", on_card(grids),
                       torch.from_numpy(alt_of).to(dev), p["l_pac"], p["w"],
                       p["gap"], p["C"], timed=False)
    log(f"chain: {len(cc.CASES)} crafted cases at both index types equal "
        f"the sequential mem_chain and the plain loop "
        f"({chainops.launches} launches)")

    lines = []
    for N, itype, seed in ((CHAIN_N, np.int32, 1), (8192, np.int64, 2)):
        l_pac = CHAIN_L_PAC if itype == np.int32 else CHAIN_L_PAC << 3
        grids, alt_of = cc.heavy_grid(N, CHAIN_S, seed=seed, itype=itype,
                                      l_pac=l_pac)
        lines.append(hold_chain(
            f"heavy-tailed grid {N} x {CHAIN_S} {itype.__name__}",
            on_card(grids), torch.from_numpy(alt_of).to(dev), l_pac, 100,
            10_000, CHAIN_S))
        del grids
    if main is not None:
        al, batches, paired, label = main
        from bwamem_tpu_torch.pipeline.align import align_stream
        with ChainCalls() as cc_hook:
            for _ in align_stream(al, batches, pe=paired):
                pass
            torch.cuda.synchronize()
        if cc_hook.calls == 0 or cc_hook.launches < cc_hook.calls:
            raise RuntimeError(f"chain {label}: {cc_hook.calls} calls, "
                               f"{cc_hook.launches} kernel launches")
        log(f"chain {label}: {cc_hook.calls} CHAIN calls, "
            f"{cc_hook.launches} kernel launches; holding the widest")
        lines.append(hold_chain(f"{label} EXPAND output", *cc_hook.args))
    log(f"chain: phase {time.perf_counter() - t0:.1f} s")
    return dict(kernel="chain_kernel", lines=lines)


def phase_front_forced(al, se, pe):
    """The device front's grow-and-retry loop and its bail-out on the card:
    the batches run whole on the CPU by phase_main (`se`: reads, SAM) and
    phase_pe (`pe`: interleaved pairs, SAM), again on the card with the
    first-dispatch arenas forced small (the front must retry and no row
    fall back) and with the item arena pinned (tools/torch_front_force;
    the front must bail once after device_front.MAX_RETRIES retries,
    every row re-run on the host-compacted front).  Each run's SAM must
    equal the CPU's bytes, and ext_pl2_kernel must launch in it (counted
    from 0)."""
    import torch
    from torch_front_force import forced_front
    from bwamem_tpu_torch.pipeline import device_front
    from bwamem_tpu_torch.utils import timers
    for how in ("small", "pinned"):
        for kind, (reads, cpu) in (("SE", se), ("PE", pe)):
            label = f"front, {kind}, {how} arenas"
            timers.reset()
            timers.enable(True)
            t0 = time.perf_counter()
            with forced_front(how), \
                    WidestCall("extend_batch_pl2", "launches") as pl2:
                sams = (al.align_batch_pe(reads) if kind == "PE"
                        else al.align_batch_se(reads))
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            timers.enable(False)
            snap = timers.snapshot()
            no_fetch_timeouts(label, snap)
            got = {k: snap.get(f"front.{k}.count", 0)
                   for k in ("retries", "bailouts", "fallback_rows")}
            log(f"{label}: {len(reads)} reads in {wall:.3f} s; "
                f"front.retries {got['retries']}, front.bailouts "
                f"{got['bailouts']}, fallback rows {got['fallback_rows']}, "
                f"ext_pl2_kernel launches {pl2.launches}")
            if sams != cpu:
                bad = [i for i in range(len(cpu)) if sams[i] != cpu[i]]
                raise RuntimeError(f"{label}: GPU and CPU SAM differ on "
                                   f"{len(bad)} of {len(cpu)} reads (first "
                                   f"{bad[:5]}):\n{sams[bad[0]]}{cpu[bad[0]]}")
            want = (dict(bailouts=0, fallback_rows=0) if how == "small" else
                    dict(retries=device_front.MAX_RETRIES, bailouts=1,
                         fallback_rows=len(reads)))
            if any(got[k] != v for k, v in want.items()) or (
                    how == "small" and got["retries"] < 1) \
                    or pl2.launches <= 0:
                raise RuntimeError(f"{label}: expected {want} (and a retry "
                                   f"for small arenas) and launches of "
                                   f"ext_pl2_kernel, got {got}, "
                                   f"{pl2.launches} launches")
            log(f"{label}: SAM identical to the CPU's")


def phase_long(al, cpu_al, read_len):
    """One long-read batch through align_batch_se on the card: every row
    goes to the host-compacted front.  Returns the two kernels' hooks."""
    import torch
    from bwamem_tpu_torch.io.fastq import read_fastx
    from bwamem_tpu_torch.utils import timers
    import se_smoke_data as sd
    label = f"{read_len} bp path"
    reads = list(read_fastx(sd.long_reads(read_len, log)))
    assert len(reads) == sd.LONG_SETS[read_len][0]
    reads = reads[:LONG_READS[read_len]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    timers.enable(True)
    t0 = time.perf_counter()
    with WidestCall("extend_batch_pl2", "launches") as pl2, \
            WidestCall("extend_batch_pl", "launches_pl") as pl:
        sams = al.align_batch_se(reads)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timers.enable(False)
    snap = timers.snapshot()
    no_fetch_timeouts(label, snap)
    peak = torch.cuda.max_memory_allocated()
    log(f"{label}: {len(sams)} reads in {wall:.3f} s = "
        f"{len(sams) / wall:.2f} reads/s on {torch.cuda.get_device_name(0)}")
    log("stage timers:\n" + timers.report())
    log(f"{label}: ext_pl2_kernel launches {pl2.launches}, ext_pl_kernel "
        f"launches {pl.launches}, rows through the host-compacted front "
        f"{snap.get('front.fallback_rows.count', 0)}, plain-extension "
        f"dispatches of over-long lanes "
        f"{snap.get('dispatch.extend_long.count', 0)}, peak CUDA memory "
        f"{peak / 2**20:.1f} MiB")
    if snap.get("front.fallback_rows.count", 0) != len(reads):
        raise RuntimeError(f"{label}: not every row took the host front")
    if snap.get("dispatch.extend_long.count", 0) != 0:
        raise RuntimeError(f"{label}: the plain extension was dispatched on "
                           f"the card")
    check_sams(label, sams, reads)
    check_cpu(label, cpu_al, reads, sams, LONG_CPU_CHECK[read_len])
    if read_len in LONG_SUB_BATCH:
        check_sub_batch(label, al, reads, sams, LONG_SUB_BATCH[read_len])
    return pl2, pl


def phase_pe(al, cpu_al):
    """The paired-end path: 2 x 4096 pairs of 150 bp through
    align_stream(pe=True) on the card.  Returns the two extension kernels'
    hooks and the batch of pairs run whole on the CPU with its SAM."""
    import torch
    from bwamem_tpu_torch.io.fastq import interleave, read_fastx
    from bwamem_tpu_torch.pipeline.align import align_stream
    from bwamem_tpu_torch.utils import timers
    import se_smoke_data as sd
    label = "PE 150 bp path"
    fq1, fq2, origins = sd.pe_reads(log)
    reads = list(interleave(read_fastx(fq1), read_fastx(fq2)))
    assert len(reads) == 2 * sd.PE_PAIRS == 2 * len(origins)
    per = 2 * sd.PE_BATCH_PAIRS
    batches = [reads[k:k + per] for k in range(0, len(reads), per)]
    # batch 0 once more behind the last, as in phase_main: batch 1 is then
    # in mid-stream; the extra batch's SAM is dropped
    stream = batches + batches[:1]
    inferred = []      # the insert-size distribution each batch infers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    timers.enable(True)
    sams, walls, snaps = [], [], []
    t0 = time.perf_counter()
    tb = t0
    with WidestCall("extend_batch_pl2", "launches") as pl2, \
            WidestCall("extend_batch_pl", "launches_pl") as pl:
        for k, (n, ss) in enumerate(align_stream(al, stream, pe=True)):
            torch.cuda.synchronize()
            now = time.perf_counter()
            walls.append(now - tb)
            log(f"PE batch {k}: {n} reads in {now - tb:.3f} s")
            tb = now
            snaps.append(timers.snapshot())
            if k < len(batches):
                sams.extend(ss)
                inferred.append(al.last_pes)
    wall = time.perf_counter() - t0
    timers.enable(False)
    snap = timers.snapshot()
    no_fetch_timeouts(label, snap)
    peak = torch.cuda.max_memory_allocated()
    fb = snap.get("front.fallback_rows.count", 0)
    log(f"{label}: {sum(map(len, stream))} reads in {wall:.3f} s = "
        f"{sum(map(len, stream)) / wall:.1f} reads/s; batch 1 in mid-stream "
        f"{len(stream[1]) / walls[1]:.1f} reads/s; the last batch "
        f"({walls[-1]:.3f} s) is a host tail only; on "
        f"{torch.cuda.get_device_name(0)}")
    log("stage timers:\n" + timers.report())

    def mid(name):
        return snaps[1].get(name, (0, 0.0))[1] - snaps[0].get(name,
                                                              (0, 0.0))[1]
    log(f"{label}, host sections of batch 1 (s): " + ", ".join(
        f"{k} {mid(k):.3f}" for k in ("pestat.batch", "matesw.batch",
                                         "pair.native", "pair.batch",
                                         "cigar.jobs")))
    jobs = snap.get("matesw.jobs.count", 0)
    log(f"{label}: ext_pl2_kernel launches {pl2.launches}, ext_pl_kernel "
        f"launches {pl.launches}, fallback rows {fb}, mate-rescue jobs "
        f"{jobs}, peak CUDA memory {peak / 2**20:.1f} MiB")
    if pl2.launches <= 0 or pl.launches != 0:
        raise RuntimeError(f"{label}: expected the device front's kernel "
                           f"only, got {pl2.launches} and {pl.launches} "
                           f"launches")
    if fb != 0:
        raise RuntimeError(f"{label}: {fb} fallback rows")
    if jobs <= 0:
        raise RuntimeError(f"{label}: mate rescue never ran")
    if len(sams) != len(reads) or not all(x.endswith("\n") for x in sams):
        raise RuntimeError(f"{label}: SAM output does not cover every read")

    # both mates where simdata sampled the pair, and the proper-pair flag
    L = sd.PE_READ_LEN
    tol = 20 + L // 50
    placed = proper = 0
    for p, (contig, a, b) in enumerate(origins):
        got = [primary_start(sams[2 * p + e], L) for e in range(2)]
        want = (a, b - L)
        if all(g is not None and g[0] == contig for g in got) and any(
                abs(got[0][1] - want[e]) <= tol
                and abs(got[1][1] - want[1 - e]) <= tol for e in range(2)):
            placed += 1
        proper += all(int(sams[2 * p + e].split("\t")[1]) & 2
                      for e in range(2))
    means = [pes[1].avg for pes in inferred]
    log(f"{label}: both mates at their origin in {placed}/{len(origins)} "
        f"pairs, proper-pair flag on {proper}/{len(origins)}, inferred FR "
        f"insert mean per batch {[round(m, 2) for m in means]} (sd "
        f"{[round(pes[1].std, 2) for pes in inferred]})")
    if placed < 0.9 * len(origins) or proper < 0.9 * len(origins):
        raise RuntimeError(f"{label}: {placed} pairs placed and {proper} "
                           f"proper of {len(origins)}")
    if len(means) != len(batches) or any(
            pes[1].failed or abs(pes[1].avg - sd.PE_INSERT[0]) > 10
            for pes in inferred):
        raise RuntimeError(f"{label}: inferred FR insert means {means}")

    # pestat is per batch: compare the card and the CPU on one batch of 256
    # pairs that each runs whole
    k = 2 * PE_CPU_CHECK_PAIRS
    t1 = time.perf_counter()
    gpu = al.align_batch_pe(reads[:k])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    cpu = cpu_al.align_batch_pe(reads[:k])
    if cpu != gpu:
        bad = [i for i in range(k) if cpu[i] != gpu[i]]
        raise RuntimeError(f"{label}: GPU and CPU SAM differ on {len(bad)} "
                           f"of {k} reads (first {bad[:5]}):\n"
                           f"{gpu[bad[0]]}{cpu[bad[0]]}")
    log(f"{label}: a batch of {PE_CPU_CHECK_PAIRS} pairs on the card "
        f"({t2 - t1:.1f} s) and on the CPU ({time.perf_counter() - t2:.1f} "
        f"s): SAM identical")
    return pl2, pl, (reads[:k], cpu), (batches, sams)


def no_fetch_timeouts(label, snap):
    """Fail the run when a device fetch of the path outlasted its watchdog
    (utils/fetchguard: the batch would have been re-run on the host front
    and the device front turned off)."""
    n = snap.get("front.fetch_timeouts.count", 0)
    if n:
        raise RuntimeError(f"{label}: {n} device fetch timeouts")


def _same_sam(label, want, got):
    if got != want:
        bad = [i for i in range(min(len(want), len(got)))
               if got[i] != want[i]]
        raise RuntimeError(f"{label}: SAM differs from the single-device "
                           f"run's on {len(bad)} of {len(want)} reads "
                           f"(first {bad[:5]}; {len(got)} records):\n"
                           + (f"{want[bad[0]]}{got[bad[0]]}" if bad
                              else ""))


def shard_hist(al, nsh):
    """The arena high-water marks of the one-device aligner `al`, keyed to
    a shard's rows of the same batches: a shard aligns a subset of the
    batch's reads, so no count it reaches exceeds the batch's, and its
    arenas start large enough not to regrow."""
    return {(kind, name, (n // nsh, lr)): v
            for (kind, name, (n, lr)), v in al._front_hist.items()}


class ShardLaunches:
    """ext_pl2_kernel launches by mesh shard within a with-block; the
    launch count starts at 0.  Every parallel/mesh.rowmap call runs its
    function once a shard, in shard order, so the wrapper credits the k-th
    call's launches to shard k mod the mesh size."""

    def __enter__(self):
        import collections
        from bwamem_tpu_torch.ops import ext_kernel
        from bwamem_tpu_torch.parallel import mesh as pmesh
        self.mod, self.pmesh = ext_kernel, pmesh
        self.orig = pmesh.rowmap
        self.by_shard = collections.Counter()
        by_shard, orig = self.by_shard, self.orig

        def rowmap(mesh, fn, *args, **kw):
            calls = [0]

            def shard_fn(*a, **k):
                s = calls[0] % mesh.size
                calls[0] += 1
                before = ext_kernel.launches
                try:
                    return fn(*a, **k)
                finally:
                    by_shard[s] += ext_kernel.launches - before
            return orig(mesh, shard_fn, *args, **kw)
        pmesh.rowmap = rowmap
        ext_kernel.launches = ext_kernel.launches_pl = 0
        return self

    def __exit__(self, *exc):
        self.pmesh.rowmap = self.orig
        self.launches, self.launches_pl = (self.mod.launches,
                                           self.mod.launches_pl)


def phase_mesh(idx, se, pe, main_al):
    """The data-parallel mesh (parallel/mesh.py): Aligner(mesh=...) over
    the first two cards, or over cuda:0 twice on a one-card machine (two
    shards on one card: twice the launches, one index).  The SE batches
    of phase_main and the PE batches of phase_pe through align_stream,
    the arenas sized from the main path's high-water marks (shard_hist);
    the SAM must equal the single-device run's bytes.  Prints the
    stream's rate, the front's retries, the fallback rows and
    ext_pl2_kernel's launches a shard.  Returns the launches by path."""
    import torch
    from bwamem_tpu_torch.parallel import make_mesh
    from bwamem_tpu_torch.pipeline.align import Aligner, align_stream
    from bwamem_tpu_torch.utils import timers
    n_dev = torch.cuda.device_count()
    devs = ["cuda:0", "cuda:1"] if n_dev >= 2 else ["cuda:0", "cuda:0"]
    log(f"mesh: {devs} ({'two cards' if n_dev >= 2 else 'two shards on '
                         'one card'}; {n_dev} visible)")
    al = Aligner(idx, mesh=make_mesh(devs))
    al._front_hist.update(shard_hist(main_al, len(devs)))
    launches = {}
    for kind, (batches, want) in (("SE", se), ("PE", pe)):
        label = f"mesh, {kind}"
        torch.cuda.synchronize()
        timers.reset()
        timers.enable(True)
        sams, walls = [], []
        t0 = tb = time.perf_counter()
        with ShardLaunches() as sl:
            for _, ss in align_stream(al, batches, pe=kind == "PE"):
                torch.cuda.synchronize()
                now = time.perf_counter()
                walls.append(now - tb)
                tb = now
                sams.extend(ss)
        wall = time.perf_counter() - t0
        timers.enable(False)
        snap = timers.snapshot()
        no_fetch_timeouts(label, snap)
        fb = snap.get("front.fallback_rows.count", 0)
        n_reads = sum(map(len, batches))
        log(f"{label}: {n_reads} reads in {wall:.3f} s = "
            f"{n_reads / wall:.1f} reads/s (batches "
            f"{[round(w, 3) for w in walls]} s); fallback rows {fb}; "
            f"ext_pl2_kernel launches by shard "
            f"{dict(sorted(sl.by_shard.items()))}, ext_pl_kernel "
            f"{sl.launches_pl}; front retries "
            f"{snap.get('front.retries.count', 0)}; on "
            f"{torch.cuda.get_device_name(0)}")
        _same_sam(label, want, sams)
        if any(sl.by_shard.get(s, 0) <= 0 for s in range(len(devs))) \
                or sl.launches_pl:
            raise RuntimeError(f"{label}: expected ext_pl2_kernel launches "
                               f"on every shard and no ext_pl_kernel, got "
                               f"{dict(sl.by_shard)}, {sl.launches_pl}")
        if fb:
            raise RuntimeError(f"{label}: {fb} fallback rows")
        log(f"{label}: SAM of {len(sams)} reads identical to the "
            f"single-device run's")
        launches[kind] = (sl.launches, sl.launches_pl)
    return launches


def phase_multihost(prefix, fq, main_al):
    """Multi-process mem (parallel/multihost.py): MH_RANKS processes of
    `python3 -m bwamem_tpu_torch.cli mem` on the card, joined over gloo
    through a local coordinator, each aligning 2 of the MH_CHUNKS -K chunks
    of 8192 reads; rank 0 merges the shards.  The output must equal, byte
    for byte, the same command run in one process (in this one, on the
    card).  The ranks and the one-process run start from the main path's
    arena history (BWAMEM_TPU_HWM_DIR).  Each rank reports its wall time,
    ext_pl2_kernel launches (above 0), fallback rows and fetch timeouts
    (0).  Returns the ranks' launches of both extension kernels."""
    import shutil
    from bwamem_tpu_torch.pipeline import device_front
    import se_smoke_data as sd
    work = os.path.join(sd.WORK, "multihost")
    shutil.rmtree(work, ignore_errors=True)
    for d in ("one", "ranks"):
        os.makedirs(os.path.join(work, d))
    os.environ["BWAMEM_TPU_HWM_DIR"] = os.path.join(work, "hwm")
    try:
        device_front.hist_save(main_al)
        return _multihost_runs(prefix, fq, work)
    finally:
        del os.environ["BWAMEM_TPU_HWM_DIR"]


def _multihost_runs(prefix, fq, work):
    """phase_multihost's two runs, in `work`."""
    import socket
    import torch
    from bwamem_tpu_torch.ops import ext_kernel
    from bwamem_tpu_torch.utils import timers
    import se_smoke_data as sd
    one_dir, mh_dir = os.path.join(work, "one"), os.path.join(work, "ranks")
    # the 101 bp set over and over: MH_CHUNKS chunks of sd.BATCH reads
    src = open(fq).read()
    n_copies = MH_CHUNKS * sd.BATCH // (sd.BATCH * sd.N_BATCHES)
    mh_fq = os.path.join(work, "reads.fq")
    with open(mh_fq, "w") as f:
        f.write(src * n_copies)
    n_reads = MH_CHUNKS * sd.BATCH
    argv = ["mem", "-K", str(sd.BATCH * sd.READ_LEN), "-o", "out.sam",
            prefix, mh_fq]

    cwd = os.getcwd()
    ext_kernel.launches = 0
    timers.reset()
    timers.enable(True)
    t0 = time.perf_counter()
    try:
        os.chdir(one_dir)
        run_cli(argv, "cuda")
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        timers.enable(False)
    one_wall = time.perf_counter() - t0
    snap = timers.snapshot()
    no_fetch_timeouts("multi-process, one process", snap)
    log(f"multi-process, one process: {n_reads} reads in {one_wall:.3f} s "
        f"= {n_reads / one_wall:.1f} reads/s; ext_pl2_kernel launches "
        f"{ext_kernel.launches}; front retries "
        f"{snap.get('front.retries.count', 0)}")
    want = open(os.path.join(one_dir, "out.sam"), "rb").read()

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs, errs = [], []
    t0 = time.perf_counter()
    for r in range(MH_RANKS):
        env = dict(os.environ, PYTHONPATH=REPO, BWAMEM_TPU_TIMERS="1",
                   BWAMEM_COORDINATOR=f"localhost:{port}",
                   BWAMEM_NUM_PROCESSES=str(MH_RANKS),
                   BWAMEM_PROCESS_ID=str(r))
        errs.append(open(os.path.join(work, f"rank{r}.err"), "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "bwamem_tpu_torch.cli", *argv],
            cwd=mh_dir, env=env, stdout=subprocess.DEVNULL,
            stderr=errs[-1]))
    walls = [None] * MH_RANKS
    try:
        while any(w is None for w in walls):
            for r, p in enumerate(procs):
                if walls[r] is None and p.poll() is not None:
                    walls[r] = time.perf_counter() - t0
                    if p.returncode != 0:
                        raise RuntimeError(
                            f"multi-process: rank {r} exited "
                            f"{p.returncode}:\n" + open(os.path.join(
                                work, f"rank{r}.err")).read()[-3000:])
            if time.perf_counter() - t0 > MH_DEADLINE:
                raise RuntimeError(f"multi-process: the ranks took over "
                                   f"{MH_DEADLINE} s")
            time.sleep(0.2)
    finally:
        for p, f in zip(procs, errs):
            if p.poll() is None:
                p.kill()
            p.wait()
            f.close()
    wall = time.perf_counter() - t0
    launches = []
    for r in range(MH_RANKS):
        err = open(os.path.join(work, f"rank{r}.err")).read()
        m = re.search(r"rank \d+: (\d+) reads in ([\d.]+) s; "
                      r"ext_pl2_kernel launches (\d+), ext_pl_kernel "
                      r"launches (\d+), fallback rows (\d+), fetch "
                      r"timeouts (\d+)", err)
        if not m:
            raise RuntimeError(f"multi-process: rank {r} reported no "
                               f"counts:\n{err[-2000:]}")
        done, secs, pl2, pl, fb, to = (float(x) for x in m.groups())
        merge = re.search(r"merged (\d+) chunks of \d+ shards in ([\d.]+) "
                          r"s", err)
        log(f"multi-process, rank {r}: {int(done)} reads aligned in "
            f"{secs:.3f} s, process wall {walls[r]:.3f} s; ext_pl2_kernel "
            f"launches {int(pl2)}, ext_pl_kernel {int(pl)}, fallback rows "
            f"{int(fb)}, fetch timeouts {int(to)}"
            + (f"; merge of {merge.group(1)} chunks "
               f"{float(merge.group(2)):.3f} s" if merge else ""))
        if pl2 <= 0 or to:
            raise RuntimeError(f"multi-process: rank {r} launched "
                               f"ext_pl2_kernel {int(pl2)} times with "
                               f"{int(to)} fetch timeouts")
        if r == 0 and not merge:
            raise RuntimeError("multi-process: rank 0 did not merge")
        launches.append((int(pl2), int(pl)))
    got = open(os.path.join(mh_dir, "out.sam"), "rb").read()
    if got != want:
        raise RuntimeError(f"multi-process: the merged SAM ({len(got)} "
                           f"bytes) differs from one process's "
                           f"({len(want)} bytes)")
    log(f"multi-process: {MH_RANKS} ranks, {n_reads} reads in {wall:.3f} s "
        f"= {n_reads / wall:.1f} reads/s overall (start-up and merge "
        f"included); merged SAM identical to one process's ({len(got)} "
        f"bytes) on {torch.cuda.get_device_name(0)}")
    return launches


def fm_bound(n_lanes, steps, nb, W):
    """Least time the card could take for the chained gather, from the
    shapes: (bound_ms, bound_by, bytes, operations).  Bytes: each input
    read once and the output written once — of the table no more rows than
    the chain can touch, min(nb, lanes x steps) rows of W words (a row read
    again comes from L2 and is not counted), plus k0 and the result.
    Operations: W adds, the shift and address, the add and the non-negative
    remainder per lane and step (W + 6 int32 operations).  Neither is what
    holds the kernel: a lane's steps are serial, so it cannot finish before
    `steps` dependent loads have come back; phase_fm_mm measures one
    serial step and prints it beside the bound."""
    nbytes = min(nb, n_lanes * steps) * W * 4 + 2 * 4 * n_lanes
    ops = n_lanes * steps * (W + 6)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_INT32_OPS * 1e3
    return (max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else
            "bytes", nbytes, ops)


def phase_fm_probe():
    """The FM-step probe as its users run it (launch counts from 0), then
    both kernel entries against the plain chain_gather on the probe's
    lanes, timed with CUDA events.  Returns the two kernels-line entries
    (phase_fm_mm adds the device times and the serial steps)."""
    import numpy as np
    import torch
    import se_smoke_data as sd
    import torch_fm_step_probe as probe
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.ops import fm as fmops
    from bwamem_tpu_torch.ops import fm_probe
    fm_probe.launches_words = fm_probe.launches_rows = 0
    times = probe.probe(FM_LANES, FM_STEPS, log)
    torch.cuda.synchronize()
    launches = {"fm_chain_words": fm_probe.launches_words,
                "fm_chain_rows": fm_probe.launches_rows}
    log(f"FM probe: launches {launches}")
    if min(launches.values()) <= 0:
        raise RuntimeError("the FM probe never launched its kernels")

    dev = torch.device("cuda")
    fm = fmops.fm_from_index(load_index(sd.smoke_data(log)[0]), dev)
    cmb32 = fm_probe.words32(fm.cmb)
    nb, W = cmb32.shape
    seq_len = fm.seq_len
    k0 = torch.from_numpy(np.random.default_rng(sd.SEED).integers(
        0, seq_len, FM_LANES).astype(np.int32)).to(dev)
    args = (cmb32, k0, FM_STEPS, seq_len)
    want = fm_probe.chain_gather(*args).to(torch.int64)
    plain_ms = median_ms(lambda: fm_probe.chain_gather(*args))
    # the same chain as int32 PyTorch calls (probe() holds it against
    # chain_gather): the nearest thing to a library call
    library_ms = median_ms(lambda: probe.torch_chain(*args))
    bound_ms, bound_by, nbytes, ops = fm_bound(FM_LANES, FM_STEPS, nb, W)
    extend_us = times["torch chained fm.extend"] / FM_STEPS * 1e3
    log(f"FM probe: plain chain_gather {plain_ms:.2f} ms, PyTorch-issued "
        f"int32 chain {library_ms:.2f} ms "
        f"({library_ms / FM_STEPS * 1e3:.1f} us/step), PyTorch-issued "
        f"fm.extend step {extend_us:.1f} us/step; bytes {nbytes}, "
        f"operations {ops}, bound {bound_ms:.5f} ms ({bound_by})")
    entries = []
    for name, fn, line in (("fm_chain_words", fm_probe.chain_words, 120),
                           ("fm_chain_rows", fm_probe.chain_rows, 150)):
        got = fn(*args).to(torch.int64)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item())
        log(f"{name} vs plain: {FM_LANES} lanes x {FM_STEPS} steps on the "
            f"{(nb, W)} table, {int((got != want).sum())} differ, "
            f"max_abs_err {err}")
        if err:
            raise RuntimeError(f"{name} disagrees with chain_gather")
        ms = median_ms(lambda: fn(*args))
        log(f"{name} {ms:.4f} ms ({ms / FM_STEPS * 1e3:.3f} us/step), "
            f"{ms / bound_ms:.1f} times the bound")
        entries.append(dict(
            name=name, route="cuda",
            source="bwamem_tpu_torch/csrc/fm_probe_kernel.cu",
            replaces=f"tools/fm_step_probe.py:{line}",
            launches=launches[name], max_abs_err=err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=library_ms, torch_extend_step_us=extend_us))
    return entries


# the shipped kernels of #3 and 7D (every instantiation in
# tools/fm_mm_variants.cu's library, built with -Xptxas -v)
FM_MM_SHIPPED = ("fm_sums_kernel", "fm_l2_kernel", "mm_split_kernel")


def phase_fm_mm(kerns3, kerns_gp3):
    """Kernels #3 (fm_chain_words, fm_chain_rows) and 7D (gp3_mm) against
    the designs they replaced (tools/torch_fm_mm_variants.py, whose
    library phase 1 builds).  #3: both wrappers and the replaced designs
    held against chain_gather after 0, 1, 37 and 64 steps on the index's
    table at its seq_len and at rows x 128 and on a random table of
    262145 rows at rows x 128, where some steps must wrap k + S past
    int32; then timed in turns on the device alone; then one serial
    step (one block of 128 lanes over 4096 steps) of each replaced design
    (serial_step_ns, measured as before on the design then shipped),
    of the shipped one and of the full-row step by four threads a lane
    (full_row_step_ns: the better load of two, the step a seeding kernel
    would pay).  7D: the shipped and the replaced design held on the
    probe's normal and integer-valued inputs (exact there, and the same
    bits twice), the shipped one also at other shapes, then timed in
    turns.  The numbers join the kernels-line entries: device_ms,
    replaced_device_ms, serial_step_ns, shipped_serial_step_ns and
    full_row_step_ns (#3); replaced_device_ms (normal inputs) and
    `variants` ({kind: {shipped | replaced | library: dict(device_ms,
    ms)}}) (7D)."""
    import torch
    import torch_fm_mm_variants as fmv
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    lib = fmv.library()
    regs = fmv.ptxas(lib)
    shipped = {k: v for k, v in regs.items()
               if any(n in k for n in FM_MM_SHIPPED)}
    for kern, (r, ss, sl) in sorted(shipped.items()):
        log(f"ptxas {kern}: {r} registers, {ss} bytes spill stores, {sl} "
            f"loads")
    if len(shipped) < len(FM_MM_SHIPPED) or any(
            ss or sl for _, ss, sl in shipped.values()):
        raise RuntimeError(f"a #3 or 7D kernel spills: {shipped}")
    x = fmv.fm_inputs(dev, log)
    for label in ("index max", "random"):
        if fmv.wraps(*x[label][:2], fmv.FM_STEPS, x[label][2]) <= 0:
            raise RuntimeError(f"#3 {label}: no step wraps k + S")
    errs = fmv.check_fm(lib, x, log, names=fmv.FM_REPLACED)
    times = fmv.times_fm(lib, x, log, names=fmv.FM_REPLACED)
    serial = fmv.serial_steps(lib, x, log, (*fmv.FM_REPLACED, "full_ldg",
                                            "full_cg"))
    full = min(serial["full_ldg"], serial["full_cg"])
    for e in kerns3:
        kind = "words" if e["name"] == "fm_chain_words" else "rows"
        e.update(
            max_abs_err=max(e["max_abs_err"], *(
                v for k, v in errs.items()
                if k.startswith(f"shipped_{kind} "))),
            device_ms=times[f"shipped_{kind}"]["device_ms"],
            replaced_device_ms=times[f"replaced_{kind}"]["device_ms"],
            serial_step_ns=serial[f"replaced_{kind}"],
            shipped_serial_step_ns=serial["shipped_rows"],
            full_row_step_ns=full)
        log(f"{e['name']}: device {e['device_ms']:.5f} ms against the "
            f"replaced design's {e['replaced_device_ms']:.5f} (in turns); "
            f"a serial step {e['serial_step_ns']:.1f} ns replaced, "
            f"{serial['shipped_rows']:.1f} shipped, full row {full:.1f}; "
            f"bound {e['bound_ms']:.5f} ms, device time / bound "
            f"{e['device_ms'] / e['bound_ms']:.1f}")
    mx = fmv.mm_inputs(dev)
    fmv.check_mm(lib, mx, log, names=("replaced",))
    mt = fmv.times_mm(lib, mx, log, names=("replaced",))
    e = next(e for e in kerns_gp3 if e["name"] == "gp3_mm")
    e.update(replaced_device_ms=mt["normal"]["replaced"]["device_ms"],
             variants=mt)
    log("gp3_mm in turns, device ms, normal / integer inputs: shipped "
        + " / ".join(f"{mt[k]['shipped']['device_ms']:.5f}" for k in mt)
        + ", replaced "
        + " / ".join(f"{mt[k]['replaced']['device_ms']:.5f}" for k in mt))
    log(f"#3 and 7D phase: {time.perf_counter() - t0:.1f} s")


def run_cli(argv, device):
    """cli.main(argv, device=device) with its standard output and error
    captured: (exit code, stdout, stderr)."""
    import contextlib
    import io
    from bwamem_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv, device=device)
    if rc != 0:
        raise RuntimeError(f"{' '.join(argv[:1])} on {device} exited {rc}: "
                           f"{err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue()


def head_fastq(src, n):
    """Path of a FASTQ holding the first n records of src (made once)."""
    dst = f"{src[:-3]}.first{n}.fq"
    if not os.path.exists(dst):
        with open(src) as f, open(dst + ".tmp", "w") as g:
            for _ in range(4 * n):
                g.write(f.readline())
        os.replace(dst + ".tmp", dst)
    return dst


def run_timed(label, argv, n_items, unit):
    """One CLI command on the card with the stage timers on and the
    extension kernels' launch counts from 0: (stdout, stderr, timer
    snapshot).  Prints the rate, the timers, the launches and the peak
    device memory."""
    import torch
    from bwamem_tpu_torch.ops import ext_kernel
    from bwamem_tpu_torch.utils import timers
    ext_kernel.launches = ext_kernel.launches_pl = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    timers.enable(True)
    t0 = time.perf_counter()
    try:
        out, err = run_cli(argv, "cuda")
        torch.cuda.synchronize()
    finally:
        timers.enable(False)
    wall = time.perf_counter() - t0
    snap = timers.snapshot()
    ext = ext_kernel.launches + ext_kernel.launches_pl
    sections = ", ".join(f"{k} {v[1]:.3f} s" for k, v in sorted(snap.items())
                         if isinstance(v, tuple))
    log(f"{label}: {n_items} {unit} in {wall:.3f} s = "
        f"{n_items / wall:.1f} {unit}/s on {torch.cuda.get_device_name(0)}; "
        f"{sections}; scan trips {snap.get('seed.scan.trips.count', 0)}, "
        f"reruns "
        f"{snap.get('seed.scan.reruns.count', 0)}; extension kernel launches "
        f"{ext}; peak CUDA memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    if ext:
        raise RuntimeError(f"{label}: {ext} extension kernel launches")
    return out, err, snap


def phase_tools(prefix):
    """fastmap and maxk over the first 8192 reads of 101 bp (two CLI
    batches of 4096) and pemerge over 4096 pairs of 100 bp, each through
    cli.main on the card; the first 256 reads or pairs rerun on the CPU
    give the same bytes."""
    import se_smoke_data as sd
    fq = head_fastq(sd.smoke_data(log)[1], TOOL_READS)
    fq_cpu = head_fastq(fq, TOOL_CPU_READS)

    out, _, snap = run_timed("fastmap", ["fastmap", prefix, fq], TOOL_READS,
                             "reads")
    recs = out.split("//\n")
    if len(recs) != TOOL_READS + 1 or recs[-1] != "":
        raise RuntimeError(f"fastmap: {len(recs) - 1} records for "
                           f"{TOOL_READS} reads")
    if snap.get("seed.scan.trips.count", 0) <= 0:
        raise RuntimeError("fastmap: no scan trip was counted")
    em = out.count("\nEM\t")
    t1 = time.perf_counter()
    cpu, _ = run_cli(["fastmap", prefix, fq_cpu], "cpu")
    head = "".join(r + "//\n" for r in recs[:TOOL_CPU_READS])
    if cpu != head:
        raise RuntimeError("fastmap: GPU and CPU output differ on the first "
                           f"{TOOL_CPU_READS} reads")
    log(f"fastmap: {em} SMEM lines; CPU rerun of {TOOL_CPU_READS} reads "
        f"({time.perf_counter() - t1:.1f} s): output identical "
        f"({len(cpu)} bytes)")

    out, _, _ = run_timed("maxk", ["maxk", prefix, fq], TOOL_READS, "reads")
    hist = [int(line.split("\t")[1]) for line in out.splitlines()]
    if len(hist) != 256 or sum(hist) != TOOL_READS * sd.READ_LEN:
        raise RuntimeError(f"maxk: {len(hist)} bins, {sum(hist)} bases")
    gpu, _ = run_cli(["maxk", prefix, fq_cpu], "cuda")
    t1 = time.perf_counter()
    cpu, _ = run_cli(["maxk", prefix, fq_cpu], "cpu")
    if cpu != gpu:
        raise RuntimeError(f"maxk: GPU and CPU histograms differ on the "
                           f"first {TOOL_CPU_READS} reads")
    log(f"maxk: bases in bins 0-16 {sum(hist[:17])}, 17-100 "
        f"{sum(hist[17:101])}, 101+ {sum(hist[101:])}; histogram of the "
        f"first {TOOL_CPU_READS} reads on the CPU "
        f"({time.perf_counter() - t1:.1f} s): identical")

    fq1, fq2 = sd.pemerge_pairs(log)
    _, err, _ = run_timed("pemerge", ["pemerge", fq1, fq2], sd.PEM_PAIRS,
                          "pairs")
    log("pemerge: " + "; ".join(line.strip() for line in err.splitlines()))
    merged = int(err.split()[0])
    if merged <= 0:
        raise RuntimeError("pemerge: no pair merged")
    p1, p2 = head_fastq(fq1, PEM_CPU_PAIRS), head_fastq(fq2, PEM_CPU_PAIRS)
    gpu = run_cli(["pemerge", p1, p2], "cuda")
    t1 = time.perf_counter()
    cpu = run_cli(["pemerge", p1, p2], "cpu")
    if cpu != gpu:
        raise RuntimeError(f"pemerge: GPU and CPU output differ on the "
                           f"first {PEM_CPU_PAIRS} pairs")
    log(f"pemerge: {merged} of {sd.PEM_PAIRS} pairs merged; the first "
        f"{PEM_CPU_PAIRS} pairs on the CPU ({time.perf_counter() - t1:.1f} "
        f"s): stdout and stderr identical ({int(cpu[1].split()[0])} merged)")


def _sam_records(path):
    """The non-header lines of a SAM file, one string (with its newline)
    each."""
    with open(path) as f:
        return [line for line in f if not line.startswith("@")]


def _legacy_counts(label, snap, n_items, kernel_d):
    """Prints the search's rounds and lanes and the host time a round
    beside kernel D's time at 1024 lanes; returns the rounds."""
    rounds = snap.get("aln.rounds.count", 0)
    lanes = snap.get("aln.lanes.count", 0)
    match = snap.get("aln.match", (0, 0.0))[1]
    occ = snap.get("aln.occ", (0, 0.0))[1]
    scan = snap.get("aln.width_scan", (0, 0.0))[1]
    log(f"{label}: {rounds} rounds, {lanes} lanes ({lanes / max(rounds, 1):.1f}"
        f" a round, {lanes / n_items:.0f} a read); width scan {scan:.3f} s, "
        f"search {match:.3f} s, of it the rounds' copies and occ4 {occ:.3f} "
        f"s; host time a round {match / max(rounds, 1) * 1e3:.4f} ms (copies "
        f"and occ4 {occ / max(rounds, 1) * 1e3:.4f} ms) against kernel D "
        f"(gp2_col0) at 1024 lanes {kernel_d['single_ms']:.4f} ms one call, "
        f"{kernel_d['ms']:.4f} ms a call back to back, "
        f"{kernel_d['device_ms']:.4f} ms on the device alone back to back")
    if rounds <= 0:
        raise RuntimeError(f"{label}: the search issued no round")
    return rounds


def phase_legacy(prefix, kernel_d):
    """The legacy aligner through cli.main on the card, on the 5 Mbp smoke
    genome: one host-issued aln round of 1024 lanes beside kernel D; aln +
    samse over 2048 reads of 101 bp; aln on both mates + sampe over 1024
    pairs of 101 bp with mate-rescue bait.  At least 90 % of the reads
    (both mates of 90 % of the pairs) where simdata sampled them; the
    first 128 reads and 128 pairs give the CPU's .sai and SAM bytes."""
    import numpy as np
    import torch
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import read_fastx
    from bwamem_tpu_torch.legacy import aln as la
    from bwamem_tpu_torch.ops import fm as fmops
    import se_smoke_data as sd
    work = os.path.join(sd.WORK, "legacy")
    os.makedirs(work, exist_ok=True)
    t_phase = time.perf_counter()

    # one round of the search as aln issues it, at kernel D's lane count
    fm = fmops.fm_from_index(load_index(prefix), "cuda")
    rng = np.random.default_rng(sd.SEED)
    km1 = rng.integers(-1, fm.seq_len, LEG_ROUND_LANES)
    l_ = rng.integers(0, fm.seq_len + 1, LEG_ROUND_LANES)
    batcher = la.OccBatcher(fm)
    batcher.query(km1, l_)
    ts = []
    for _ in range(5):
        t0 = time.perf_counter()
        batcher.query(km1, l_)
        ts.append((time.perf_counter() - t0) * 1e3)
    round_ms = sorted(ts)[2]
    log(f"aln round of {LEG_ROUND_LANES} lanes issued from the host (copy "
        f"in, occ4, copy out), median of 5: {round_ms:.4f} ms; kernel D "
        f"(gp2_col0) at {LEG_ROUND_LANES} lanes {kernel_d['single_ms']:.4f} "
        f"ms one call, {kernel_d['ms']:.4f} ms a call back to back, "
        f"{kernel_d['device_ms']:.4f} ms on the device alone back to back "
        f"(col0 after col0: the dependent launch overlaps only that): the "
        f"round costs {round_ms / kernel_d['single_ms']:.1f} times one call "
        f"of the kernel, {round_ms / kernel_d['ms']:.1f} times a call back "
        f"to back")
    del fm, batcher

    # single-end: aln + samse
    fq = head_fastq(sd.smoke_data(log)[1], LEG_READS)
    sai, sam = os.path.join(work, "se.sai"), os.path.join(work, "se.sam")
    t0 = time.perf_counter()
    _, _, snap = run_timed("aln (SE)", ["aln", "-f", sai, prefix, fq],
                           LEG_READS, "reads")
    _legacy_counts("aln (SE)", snap, LEG_READS, kernel_d)
    _, _, snap = run_timed("samse", ["samse", "-f", sam, prefix, sai, fq],
                           LEG_READS, "reads")
    wall = time.perf_counter() - t0
    log(f"aln + samse: {LEG_READS} reads in {wall:.3f} s = "
        f"{LEG_READS / wall:.1f} reads/s")
    reads = list(read_fastx(fq))
    recs = _sam_records(sam)
    if [r.split("\t", 1)[0] for r in recs] != [r.name for r in reads]:
        raise RuntimeError("samse: one SAM line a read, in order, expected")
    # aln leaves a read unmapped by design when it is past max_diff or
    # lies over one of the genome's N runs: unmapped reads count against
    # the origin share, not as misplaced ones beyond 3 %
    check_sams("aln + samse", recs, reads, min_origin=0.9, max_wrong=0.03)

    # paired-end: aln on both mates + sampe
    fq1, fq2, origins = sd.legacy_pairs(log)
    fq1, fq2 = head_fastq(fq1, LEG_PAIRS), head_fastq(fq2, LEG_PAIRS)
    origins = origins[:LEG_PAIRS]
    sais = [os.path.join(work, f"pe{e}.sai") for e in (1, 2)]
    pe_sam = os.path.join(work, "pe.sam")
    t0 = time.perf_counter()
    for e, (f, x) in enumerate(((fq1, sais[0]), (fq2, sais[1])), 1):
        _, _, snap = run_timed(f"aln (mate {e})", ["aln", "-f", x, prefix, f],
                               LEG_PAIRS, "reads")
        _legacy_counts(f"aln (mate {e})", snap, LEG_PAIRS, kernel_d)
    _, err, snap = run_timed("sampe", ["sampe", "-f", pe_sam, prefix, *sais,
                                       fq1, fq2], LEG_PAIRS, "pairs")
    wall = time.perf_counter() - t0
    log(f"aln x 2 + sampe: {LEG_PAIRS} pairs in {wall:.3f} s = "
        f"{LEG_PAIRS / wall:.1f} pairs/s; "
        + "; ".join(x for x in err.splitlines() if "paired_sw" in x
                    or "inferred external" in x))
    recs = _sam_records(pe_sam)
    if len(recs) != 2 * LEG_PAIRS:
        raise RuntimeError(f"sampe: {len(recs)} lines for {LEG_PAIRS} "
                           "pairs")
    L, tol = sd.LEG_READ_LEN, 20 + sd.LEG_READ_LEN // 50
    placed = 0
    for p, (contig, a, b) in enumerate(origins):
        got = [primary_start(recs[2 * p + e], L) for e in range(2)]
        want = (a, b - L)
        if all(g is not None and g[0] == contig for g in got) and any(
                abs(got[0][1] - want[e]) <= tol
                and abs(got[1][1] - want[1 - e]) <= tol for e in range(2)):
            placed += 1
    rescued = sum("\tXT:A:M" in r for r in recs)
    bait = len(range(0, LEG_PAIRS, sd.LEG_BAIT_EVERY))
    log(f"sampe: both mates at their origin in {placed}/{LEG_PAIRS} "
        f"pairs; {rescued} mates placed by the mate rescue ({bait} pairs "
        f"carry bait)")
    if placed < 0.9 * LEG_PAIRS or rescued <= 0:
        raise RuntimeError(f"sampe: {placed} of {LEG_PAIRS} pairs placed, "
                           f"{rescued} rescued")

    # the first reads and pairs, whole, on the card and on the CPU
    fq_c = head_fastq(fq, LEG_CPU_READS)
    p1, p2 = head_fastq(fq1, LEG_CPU_PAIRS), head_fastq(fq2, LEG_CPU_PAIRS)
    outs = {}
    for dev in ("cuda", "cpu"):
        t1 = time.perf_counter()
        x = {k: os.path.join(work, f"{dev}.{k}")
             for k in ("se.sai", "se.sam", "1.sai", "2.sai", "pe.sam")}
        run_cli(["aln", "-f", x["se.sai"], prefix, fq_c], dev)
        run_cli(["samse", "-f", x["se.sam"], prefix, x["se.sai"], fq_c], dev)
        run_cli(["aln", "-f", x["1.sai"], prefix, p1], dev)
        run_cli(["aln", "-f", x["2.sai"], prefix, p2], dev)
        run_cli(["sampe", "-f", x["pe.sam"], prefix, x["1.sai"], x["2.sai"],
                 p1, p2], dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[dev] = {}
        for k, path in x.items():
            with open(path, "rb") as f:
                outs[dev][k] = f.read()
        log(f"legacy, {LEG_CPU_READS} reads and {LEG_CPU_PAIRS} pairs whole "
            f"on {dev}: {time.perf_counter() - t1:.1f} s")
    bad = [k for k in outs["cuda"] if outs["cuda"][k] != outs["cpu"][k]]
    if bad:
        raise RuntimeError(f"legacy: GPU and CPU bytes differ in {bad}")
    log(f"legacy: .sai and SAM bytes identical on the card and on the CPU "
        f"({', '.join(f'{k} {len(v)}' for k, v in outs['cpu'].items())} "
        f"bytes); phase {time.perf_counter() - t_phase:.1f} s")


def _by_read(recs):
    """SAM records grouped by read, in order: {name: "line\nline\n"}."""
    out = {}
    for r in recs:
        name = r.split("\t", 1)[0]
        out[name] = out.get(name, "") + r
    return out


def run_bwasw(label, argv, n_items, unit):
    """bwasw through cli.main on the card, timers on and the extension
    kernels' launch counts from 0: (stderr, timer snapshot).  Every
    extension dispatch must launch ext_pl_kernel (none runs the plain
    extension, none launches ext_pl2_kernel).  Prints the rate, the
    bwasw timers, the launches and the peak device memory."""
    import torch
    from bwamem_tpu_torch.ops import ext_kernel
    from bwamem_tpu_torch.utils import timers
    ext_kernel.launches = ext_kernel.launches_pl = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    timers.enable(True)
    t0 = time.perf_counter()
    try:
        _, err = run_cli(argv, "cuda")
        torch.cuda.synchronize()
    finally:
        timers.enable(False)
    wall = time.perf_counter() - t0
    snap = timers.snapshot()
    calls = {k: snap.get(f"bwasw.{k}.calls.count", 0)
             for k in ("ext_left", "ext_rght", "ext_plain")}
    sections = ", ".join(f"{k} {v[1]:.3f} s ({v[0]})"
                         for k, v in sorted(snap.items())
                         if isinstance(v, tuple) and k.startswith("bwasw."))
    log(f"{label}: {n_items} {unit} in {wall:.3f} s = "
        f"{n_items / wall:.2f} {unit}/s on {torch.cuda.get_device_name(0)}; "
        f"{sections}; extension dispatches {calls}, ext_pl_kernel launches "
        f"{ext_kernel.launches_pl}, ext_pl2_kernel {ext_kernel.launches}; "
        f"peak CUDA memory {torch.cuda.max_memory_allocated() / 2**20:.1f} "
        f"MiB")
    if ext_kernel.launches_pl <= 0 or calls["ext_plain"] or \
            ext_kernel.launches or ext_kernel.launches_pl != \
            calls["ext_left"] + calls["ext_rght"]:
        raise RuntimeError(f"{label}: every extension dispatch must launch "
                           f"ext_pl_kernel")
    return err, snap


def phase_bwasw(prefix):
    """bwasw through cli.main on the card, on the 5 Mbp smoke genome: 128
    reads of 500 bp and 64 pairs of 300 bp (insert 700 +- 60).  Every
    extension launches ext_pl_kernel; at least 90 % of the single-end reads
    lie where simdata sampled them; some pair is proper; the first 8 reads
    and 8 pairs, run whole on the card and on the CPU, give the same SAM
    bytes."""
    import torch
    from bwamem_tpu_torch.io.fastq import read_fastx
    import se_smoke_data as sd
    work = os.path.join(sd.WORK, "bwasw")
    os.makedirs(work, exist_ok=True)
    t_phase = time.perf_counter()
    fq, fq1, fq2, origins = sd.bwasw_reads(log)
    fq = head_fastq(fq, BWASW_SE_READS)
    n_se, n_pe = BWASW_SE_READS, sd.BWASW_PE[0]

    sam = os.path.join(work, "se.sam")
    run_bwasw("bwasw (SE 500 bp)", ["bwasw", "-f", sam, prefix, fq], n_se,
              "reads")
    reads = list(read_fastx(fq))
    by_read = _by_read(_sam_records(sam))
    if list(by_read) != [r.name for r in reads]:
        raise RuntimeError("bwasw: SAM lines for every read, in order, "
                           "expected")
    check_sams("bwasw (SE 500 bp)", list(by_read.values()), reads,
               min_origin=0.9, max_wrong=0.03)

    pe_sam = os.path.join(work, "pe.sam")
    run_bwasw("bwasw (PE 300 bp)", ["bwasw", "-f", pe_sam, prefix, fq1, fq2],
              n_pe, "pairs")
    recs = _sam_records(pe_sam)
    flags = [int(r.split("\t")[1]) for r in recs]
    proper = sum(1 for f in flags if f & 2 and not f & 4)
    L = sd.BWASW_PE[1]
    tol = 20 + L // 50
    placed = 0
    for p, (contig, a, b) in enumerate(origins):
        mine = [r for r in recs if r.split("\t", 1)[0] == f"rd{p}"]
        got = []
        for bit in (0x40, 0x80):
            line = next((r for r in mine if int(r.split("\t")[1]) & bit),
                        None)
            got.append(primary_start(line, L) if line else None)
        if all(g is not None and g[0] == contig for g in got) and any(
                abs(got[0][1] - (a, b - L)[e]) <= tol
                and abs(got[1][1] - (a, b - L)[1 - e]) <= tol
                for e in range(2)):
            placed += 1
    log(f"bwasw (PE 300 bp): {len(recs)} SAM lines for {n_pe} pairs, "
        f"{proper} flagged proper; both mates at their origin in "
        f"{placed}/{n_pe} pairs")
    if not proper:
        raise RuntimeError("bwasw: no pair is flagged proper")

    se_c = head_fastq(fq, BWASW_CPU_READS)
    p1, p2 = head_fastq(fq1, BWASW_CPU_PAIRS), head_fastq(fq2,
                                                          BWASW_CPU_PAIRS)
    outs = {}
    for dev in ("cuda", "cpu"):
        t1 = time.perf_counter()
        x = {k: os.path.join(work, f"{dev}.{k}.sam") for k in ("se", "pe")}
        run_cli(["bwasw", "-f", x["se"], prefix, se_c], dev)
        run_cli(["bwasw", "-f", x["pe"], prefix, p1, p2], dev)
        if dev == "cuda":
            torch.cuda.synchronize()
        outs[dev] = {}
        for k, path in x.items():
            with open(path, "rb") as f:
                outs[dev][k] = f.read()
        log(f"bwasw, {BWASW_CPU_READS} reads and {BWASW_CPU_PAIRS} pairs "
            f"whole on {dev}: {time.perf_counter() - t1:.1f} s")
    bad = [k for k in outs["cuda"] if outs["cuda"][k] != outs["cpu"][k]]
    if bad:
        raise RuntimeError(f"bwasw: GPU and CPU bytes differ in {bad}")
    log(f"bwasw: SAM bytes identical on the card and on the CPU "
        f"({', '.join(f'{k} {len(v)}' for k, v in outs['cpu'].items())} "
        f"bytes); phase {time.perf_counter() - t_phase:.1f} s")


def cell_main(cell: str, seed: int, n_batches: int = 3):
    """phase_chain's main-path input from a benchmark cell (portbench):
    the cell's configuration, its genome and index from portbench/.cache
    (built there by the first run in a checkout), an Aligner with its
    options, and n_batches of its batches from `seed`."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.pipeline.align import Aligner
    from portbench import harness
    from portbench.gen import reads as gen_reads
    spec = harness.cell_spec(REPO, cell)
    cdir = harness.cache_dir(spec)
    t0 = time.perf_counter()
    g, prefix, built = harness.genome_and_index(spec, cdir)
    log(f"{cell}: genome and index {'built' if built else 'loaded'} in "
        f"{time.perf_counter() - t0:.1f} s")
    paired = bool(spec["traffic"]["paired"])
    al = Aligner(load_index(prefix), harness.options(spec["config"], paired),
                 device="cuda")
    n_b = gen_reads.batch_reads(spec["traffic"])
    batches = [harness.to_reads(gen_reads.make_batch(
        g, spec["traffic"], seed, 1 + k, n_b, k * n_b), paired)
        for k in range(n_batches)]
    return al, batches, paired, f"{cell} seed {seed}"


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("chain",),
                    help="run phase_chain alone (after the card's name)")
    ap.add_argument("--cell", help="with --only chain: the main-path input "
                    "from this benchmark cell (portbench) in place of the "
                    "5 Mbp smoke genome's 101 bp reads")
    ap.add_argument("--seed", type=int, default=1)
    opts = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "bwamem_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(bwamem_tpu_torch/ not found beside this script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    t0 = time.perf_counter()
    if opts.only == "chain":
        log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60).stdout.strip())
        if opts.cell:
            main_in = cell_main(opts.cell, opts.seed)
        else:
            from bwamem_tpu_torch.index import load_index
            from bwamem_tpu_torch.io.fastq import read_fastx
            from bwamem_tpu_torch.pipeline.align import Aligner
            import se_smoke_data as sd
            prefix, fq = sd.smoke_data(log)
            reads = list(read_fastx(fq))
            main_in = (Aligner(load_index(prefix), device="cuda"),
                       [reads[k * sd.BATCH:(k + 1) * sd.BATCH]
                        for k in range(sd.N_BATCHES)], False,
                       "101 bp main path")
        kern = phase_chain(main_in)
        log(f"total {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"kernels": [kern]}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    phase_env()
    phase_launch_path()
    err_pl2, err_pl = phase_kernel()
    kerns3 = phase_fm_probe()
    kerns_gp = phase_gather_probe()
    kerns_gp2, kernel_d = phase_gather_probe2()
    kerns_gp3 = phase_gather_probe3()
    phase_ct(kerns_gp3)
    phase_take_dg(kerns_gp, kerns_gp3)
    phase_fm_mm(kerns3, kerns_gp3)
    phase_col0(kerns_gp2, kerns_gp3)
    kerns_dp_pl = phase_dispatch_pl_probe()
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.pipeline.align import Aligner
    import se_smoke_data as sd
    idx = load_index(sd.smoke_data(log)[0])
    cpu_al = Aligner(idx, device="cpu")
    al, main_pl2, main_pl, se_check, se_run = phase_main(idx, cpu_al)
    kern_chain = phase_chain((al, se_run[0], False, "101 bp main path"))
    sc_pl2 = phase_seedchain(al, cpu_al, se_run)
    pe_pl2, pe_pl, pe_check, pe_run = phase_pe(al, cpu_al)
    phase_front_forced(al, se_check, pe_check)
    fused_pl2, none_pl = phase_long(al, cpu_al, 1000)
    if fused_pl2.launches <= 0 or none_pl.launches != 0:
        raise RuntimeError(
            f"1000 bp path: expected the fused path (ext_pl2_kernel) "
            f"only, got {fused_pl2.launches} and {none_pl.launches} "
            f"launches")
    side_pl2, side_pl = phase_long(al, cpu_al, 5000)
    mh_launches = phase_multihost(sd.smoke_data(log)[0],
                                  sd.smoke_data(log)[1], al)
    mesh_launches = phase_mesh(idx, se_run, pe_run, al)
    if side_pl.launches <= 0:
        raise RuntimeError("5000 bp path: ext_pl_kernel was never launched")
    if side_pl.kw["lq_max"] <= 4095 or int(side_pl.args[1].max()) <= 4095:
        raise RuntimeError("5000 bp path: no kernel call held a query over "
                           "4095 bases")
    # the line reports each kernel on its main path's own widest call; the
    # other held calls (generated lanes with retries, empty queries and
    # z-drop cuts; the fused path's lanes) add their error
    kern2 = hold_kernel("main-path lanes, 101 bp", *main_pl2.args,
                        groups=True, **main_pl2.kw)
    pe_k = hold_kernel("PE-path lanes, 150 bp", *pe_pl2.args, groups=True,
                       **pe_pl2.kw)
    fused = hold_kernel("fused-path lanes, 1000 bp", *fused_pl2.args,
                        groups=True, **fused_pl2.kw)
    sc_k = hold_kernel("seedchain lanes, 101 bp", *sc_pl2.args, **sc_pl2.kw)
    kern2.pop("retried")
    kern2["launches"] = main_pl2.launches
    kern2["launches_by_path"] = {"101bp": main_pl2.launches,
                                 "pe150bp": pe_pl2.launches,
                                 "1000bp": fused_pl2.launches,
                                 "5000bp": side_pl2.launches,
                                 "multihost_ranks": [
                                     x[0] for x in mh_launches],
                                 "mesh_se": mesh_launches["SE"][0],
                                 "mesh_pe": mesh_launches["PE"][0],
                                 "seedchain": sc_pl2.launches}
    kern2["max_abs_err"] = max(kern2["max_abs_err"], pe_k["max_abs_err"],
                               fused["max_abs_err"], sc_k["max_abs_err"],
                               err_pl2)
    kern2["ms_pe150bp"] = pe_k["ms"]
    kern2["ms_1000bp"] = fused["ms"]
    kern2["ms_seedchain"] = sc_k["ms"]
    kern2["seedchain_wall_s"] = sc_pl2.wall
    kern2["ms_by_group"] = {"101bp": kern2["ms_by_group"],
                            "pe150bp": pe_k["ms_by_group"],
                            "1000bp": fused["ms_by_group"]}
    kern1 = hold_kernel_pl("main-path lanes, 5000 bp, the widest call with "
                           "queries over 4095 bases", *side_pl.args,
                           plain_reps=1, groups=True, **side_pl.kw)
    kern1["launches"] = side_pl.launches
    kern1["launches_by_path"] = {"101bp": main_pl.launches,
                                 "pe150bp": pe_pl.launches,
                                 "1000bp": none_pl.launches,
                                 "5000bp": side_pl.launches,
                                 "multihost_ranks": [
                                     x[1] for x in mh_launches],
                                 "mesh_se": mesh_launches["SE"][1],
                                 "mesh_pe": mesh_launches["PE"][1],
                                 "seedchain": sc_pl2.pl_launches}
    kern1["max_abs_err"] = max(kern1["max_abs_err"], err_pl)
    phase_tools(sd.smoke_data(log)[0])
    phase_legacy(sd.smoke_data(log)[0], kernel_d)
    phase_bwasw(sd.smoke_data(log)[0])
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [kern2, kern1, *kerns3, *kerns_gp,
                                  *kerns_gp2, *kerns_gp3, *kerns_dp_pl,
                                  kern_chain]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
