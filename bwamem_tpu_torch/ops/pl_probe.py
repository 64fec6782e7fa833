"""The row-body ablation probe's kernel: the hand-written CUDA kernel
(csrc/pl_probe_kernel.cu) and its plain PyTorch version.

It is the function of the TPU probe kernel of the reference package's
tools/pl_probe.py (make(variant).kernel, :36): five ablations of the
extension kernel's row body, each run per lane over ROWS target rows on
qT int32 [L1p, B] (a query base a row) and tT int32 [ROWS, B]:

  eh_only   Mq = M != 0 ? M + (qT == tT[i] ? 1 : -4) : 0 alone (M the state
            eh_h; not clamped, so it goes negative), no shift
  noscan    t_ins = max(Mq - 7, 0), A = t_ins + row, F = A, h = max(Mq, F),
            eh_e = max(eh_e - 1, max(Mq - 8, 0)), then eh_h = h shifted down
            one row, row 0 keeping h[0]
  noreduce  noscan with F[r] = max(max_{j<r} A[j] - r, 0)
  full      noreduce and the reductions mj_enc = max_r ((h << 12) | r),
            h1_enc = h[LQ - 1], lst = the last row with h or eh_e nonzero
  roll      full, its prefix max by a masked roll on the TPU

eh_h starts at row * 3 % 17 and eh_e at 0; the output is eh_h.  noreduce,
full and roll give the same output: the TPU kernel multiplies the
reductions by zero (:85).  Here they go to a side output `aux` int32
[3, B] (mj_enc, h1_enc, lst of the last step; 0 for the other variants),
so that the kernel has to compute them.  The shift of mj_enc wraps in
int32, as jnp's does.

On a CUDA tensor plp_row launches the kernel at its plan and counts the
launch in launches[variant]; on a CPU tensor it runs the plain version and
counts nothing.  There is no fallback between the two: a failed build or
launch raises.  The kernel is built and launched through ops/launch (nvcc
for sm_90a at first use, the caller's current stream).

What bounds it on an H100: int32 operations (OPS_PER_CELL a cell, at the
rate chip_smoke.py phase 1 measures, PEAK_INT32_OPS), each lane a chain
of dependent steps and, inside a step, the scan and the shift chaining
its rows.  So the designs (csrc/pl_probe_kernel.cu) keep the rows in
registers and spread a lane over threads: noscan, noreduce and full run a
group of G threads a lane, each thread a chunk of rows (in shared memory
past CHUNKS[-1] rows a thread), the chunk maxima scanned by shuffles;
roll runs a warp a lane with the log-step masked scan, several rows a
thread; eh_only, whose cells are independent, runs dp_eh's design
(csrc/rows.cuh), RPT rows of LPT lanes a thread.  plan() picks each one's
launch and owns its layout; the shipped G and plans were chosen by
tools/torch_row_variants.py (PERF.md §6).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from bwamem_tpu_torch.ops import dispatch_probe
from bwamem_tpu_torch.ops.dispatch_probe import check_tables
from bwamem_tpu_torch.ops.gather_probe import _wrap32
from bwamem_tpu_torch.ops.launch import Library

VARIANTS = ("eh_only", "noscan", "noreduce", "full", "roll")
NEG = -0x40000000           # the TPU kernel's NEGc
SMEM_MAX = 232448           # bytes of shared memory a block may opt into
GROUPS = (8, 16, 32)        # threads a lane of the group design
# rows a thread the group design holds in registers (PLP_FOR_CHUNKS of the
# source)
CHUNKS = (1, 2, 3, 4, 5, 6, 8, 9, 12, 13, 16, 17, 24, 32)
# rows a thread of roll's warp a lane (PLP_FOR_SLOTS of the source)
SLOTS = (1, 2, 3, 4, 5, 6, 8, 12, 16)
STORAGE = ("registers", "shared")
GROUP_THREADS, ROLL_MAX = 128, 1024
# The shipped G and eh_only's plan (rows a thread, lanes a thread,
# threads a block, lane groups a block), chosen by
# tools/torch_row_variants.py on the card (PERF.md §6).
GROUP = 32
EH_PLAN = (2, 4, 128, 128)
# int32 operations a cell of each variant's function, counted from its
# minimum: eh_only 5 (compare, select, != 0, add, select); noscan 13 (+
# t_ins's sub and max, A's add, h's max, eh_e's two subs and two maxes;
# the one-row shift moves data and does no operation); noreduce 16 (+ the
# prefix max, its - row and max with 0); full 23 (+ mj_enc's shift, or,
# max; lst's (h | eh_e) != 0 as or and compare, its select and max;
# h1_enc reads one row a lane and does no work a cell); roll as full
OPS_PER_CELL = {"eh_only": 5, "noscan": 13, "noreduce": 16, "full": 23,
                "roll": 23}

# (qT, tT, out, aux, L1p, rows, B, LQ, variant, the plan's four ints)
LIB = Library("pl_probe_kernel.cu",
              {"plp_row": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9},
              flags=["-Xptxas", "-v"])
SRC = LIB.src

launches = dict.fromkeys(VARIANTS, 0)   # kernel launches (CUDA tensors)


class Plan(NamedTuple):
    """The C entry's four plan ints (csrc/pl_probe_kernel.cu, plp_row):
    noscan, noreduce, full: (G, rows a thread in registers or 0 for
    shared memory, lanes a block, shared bytes a block); roll: (threads a
    lane, rows a thread in registers or 0 for shared memory, lanes a
    block, shared bytes); eh_only: (rows a thread, lanes a thread, threads
    a block, lane groups a block)."""
    p0: int
    p1: int
    p2: int
    p3: int


def l1p_of(LQ: int) -> int:
    """The TPU script's query rows for a query of LQ bases (:30)."""
    return (LQ + 1 + 7) // 8 * 8


def plan(variant: str, L1p: int, B: int, G: int | None = None,
         storage: str | None = None, aligned: bool = True) -> Plan:
    """The kernel's plan for a variant at L1p query rows and B lanes.

    noscan, noreduce, full: a group of G threads a lane (default GROUP),
    ceil(L1p / G) rows a thread rounded up to one of CHUNKS in registers,
    or, past the largest (or with storage "shared"), ceil(L1p / G) rows a
    thread in shared memory, two words a row, as many lanes a block as fit
    (up to GROUP_THREADS / G threads).  roll: a warp a lane, ceil(L1p / 32)
    rows a thread rounded up to one of SLOTS in registers; past the largest
    (or with storage "shared") a block of up to ROLL_MAX threads a lane,
    row r on thread r % T, h and e in shared memory, and 7 words a warp.
    eh_only: EH_PLAN, one
    lane a thread where B % 4 != 0 or a table is not 16-byte aligned.
    ValueError where the state does not fit or the storage cannot hold
    it."""
    if storage not in (None, *STORAGE):
        raise ValueError(f"plp_row: storage {storage!r}: need one of "
                         f"{STORAGE}")
    if variant == "eh_only":
        rpt, lpt, threads, lgb = EH_PLAN
        return Plan(rpt, lpt if B % lpt == 0 and aligned else 1, threads,
                    lgb)
    if variant == "roll":
        k = next((k for k in SLOTS if 32 * k >= L1p), None)
        if storage != "shared" and k is not None:
            return Plan(32, k, GROUP_THREADS // 32, 0)
        if storage == "registers":
            raise ValueError(f"plp_row: roll holds {SLOTS[-1]} rows a thread "
                             f"in registers, up to {32 * SLOTS[-1]} rows, "
                             f"not {L1p}")
        T = min(ROLL_MAX, -(-L1p // 32) * 32)
        smem = 4 * (7 * T // 32 + 2 * L1p)
        if smem > SMEM_MAX:
            raise ValueError(f"plp_row: roll's state of {smem} bytes at L1p "
                             f"{L1p} does not fit in {SMEM_MAX} bytes of "
                             f"shared memory")
        return Plan(T, 0, 0, smem)
    G = GROUP if G is None else G
    if G not in GROUPS:
        raise ValueError(f"plp_row: G {G}: need one of {GROUPS}")
    need = -(-L1p // G)
    ch = next((c for c in CHUNKS if c >= need), None)
    lanes = GROUP_THREADS // G
    if storage != "shared" and ch is not None:
        return Plan(G, ch, lanes, 0)
    if storage == "registers":
        raise ValueError(f"plp_row: {need} rows a thread at L1p {L1p}, G {G} "
                         f"pass the {CHUNKS[-1]} a thread holds in "
                         f"registers")
    per = 2 * L1p * 4
    lanes = min(lanes, SMEM_MAX // per)
    if lanes < 1:
        raise ValueError(f"plp_row: a lane's state of {per} bytes at L1p "
                         f"{L1p} does not fit in {SMEM_MAX} bytes of shared "
                         f"memory ({variant})")
    return Plan(G, 0, lanes, lanes * per)


def check_plan(variant: str, p: Plan, L1p: int, B: int,
               aligned: bool = True) -> None:
    """ValueError unless the kernel takes plan p for the variant at L1p
    query rows and B lanes: the sizes plan() gives its layouts (rows a
    thread in CHUNKS or SLOTS covering L1p, the shared bytes a block at
    least what the layout puts there and at most SMEM_MAX), and eh_only's
    plan as dispatch_probe.check_plan takes it (4 lanes a thread only on
    16-byte aligned tables with B % 4 == 0)."""
    if variant == "eh_only":
        dispatch_probe.check_plan(
            dispatch_probe.Plan(p.p0, p.p1, 32, p.p2, p.p3), 0, B, aligned,
            "plp_row (eh_only)")
        return
    G, ch, lanes, smem = p
    if variant == "roll":
        if ch:
            ok = G == 32 and ch in SLOTS and 32 * ch >= L1p
        else:
            ok = 32 <= G <= ROLL_MAX and G % 32 == 0 \
                and 4 * (7 * G // 32 + 2 * L1p) <= smem <= SMEM_MAX
        if not ok:
            raise ValueError(f"plp_row: roll's plan {p} at L1p {L1p}: need "
                             f"(32, one of {SLOTS} covering L1p, ..) or "
                             f"(32 to {ROLL_MAX} threads in warps, 0, .., "
                             f"shared bytes for 7 words a warp and 2 a row "
                             f"up to {SMEM_MAX})")
        return
    ok = G in GROUPS and lanes >= 1 and lanes * G <= GROUP_THREADS
    if ch:
        ok = ok and ch in CHUNKS and ch * G >= L1p
    else:
        ok = ok and 2 * L1p * 4 * lanes <= smem <= SMEM_MAX
    if not ok:
        raise ValueError(f"plp_row: {variant}'s plan {p} at L1p {L1p}: need "
                         f"G in {GROUPS}, 1 to {GROUP_THREADS} // G lanes a "
                         f"block, and one of {CHUNKS} rows a thread covering "
                         f"L1p, or 0 with shared bytes for 2 words a row a "
                         f"lane up to {SMEM_MAX}")


def work(variant: str, L1p: int, rows: int, B: int) -> tuple[int, int]:
    """(bytes, int32 operations) of one call's function: qT, tT, out and
    aux moved once, OPS_PER_CELL[variant] a cell of L1p x B x rows."""
    return (4 * (2 * L1p * B + rows * B + 3 * B),
            OPS_PER_CELL[variant] * L1p * B * rows)


def _check_args(qT, tT, variant, LQ):
    check_tables("plp_row", qT, tT)
    if variant not in VARIANTS or not 0 < LQ <= qT.shape[0]:
        raise ValueError(f"plp_row: variant {variant!r}, LQ {LQ}, L1p "
                         f"{qT.shape[0]}: need one of {VARIANTS} and "
                         f"0 < LQ <= L1p")


def plp_plain(qT: torch.Tensor, tT: torch.Tensor, variant: str,
              LQ: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The variant's function on [L1p, B] tensors, as the TPU script writes
    it, the prefix max as a cummax and the shifts as concatenations."""
    _check_args(qT, tT, variant, LQ)
    L1p, B = qT.shape
    dev = qT.device
    i32 = torch.int32
    row = torch.arange(L1p, dtype=i32, device=dev)[:, None]
    one = torch.ones((), dtype=i32, device=dev)
    h = (row * 3 % 17).expand(L1p, B)
    e = torch.zeros((L1p, B), dtype=i32, device=dev)
    neg = torch.full((1, B), NEG, dtype=i32, device=dev)
    aux = torch.zeros((3, B), dtype=i32, device=dev)
    for i in range(tT.shape[0]):
        qrow = torch.where(qT == tT[i], one, -4 * one)
        Mq = torch.where(h != 0, h + qrow, 0 * one)
        if variant == "eh_only":
            h = Mq
            continue
        A = (Mq - 7).clamp_min(0) + row
        if variant == "noscan":
            F = A
        else:
            G = torch.cummax(A, dim=0).values
            F = (torch.cat([neg, G[:-1]]) - row).clamp_min(0)
        hv = torch.maximum(Mq, F)
        e = torch.maximum(e - 1, (Mq - 8).clamp_min(0))
        if variant in ("full", "roll"):
            enc = _wrap32((hv.to(torch.int64) << 12) | row.to(torch.int64))
            nz = (hv != 0) | (e != 0)
            aux = torch.stack([
                enc.amax(0).to(i32), hv[LQ - 1],
                torch.where(nz, row, -one).amax(0)])
        h = torch.cat([hv[:1], hv[:-1]])
    return h.contiguous(), aux


def _prep(qT, tT, variant, LQ, p: Plan | None = None):
    """Checks a call's tensors and plan (ValueError on anything the kernel
    does not take) and returns the outputs and the C entry's arguments; p
    None takes plan()."""
    _check_args(qT, tT, variant, LQ)
    L1p, B = qT.shape
    out = torch.empty_like(qT)
    aux = torch.empty((3, B), dtype=torch.int32, device=qT.device)
    aligned = all(t.data_ptr() % 16 == 0 for t in (qT, tT, out))
    if p is None:
        p = plan(variant, L1p, B, aligned=aligned)
    check_plan(variant, Plan(*p), L1p, B, aligned)
    return (out, aux), (qT.data_ptr(), tT.data_ptr(), out.data_ptr(),
                        aux.data_ptr(), L1p, tT.shape[0], B, int(LQ),
                        VARIANTS.index(variant), *p)


def plp_row(qT: torch.Tensor, tT: torch.Tensor, variant: str, LQ: int,
            p: Plan | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """qT int32 [L1p, B], tT int32 [ROWS, B], 0 < LQ <= L1p -> (out int32
    [L1p, B], aux int32 [3, B]) of the variant (see plp_plain), by the
    kernel at plan p (None: plan()) on a CUDA tensor."""
    if not qT.is_cuda:
        return plp_plain(qT, tT, variant, LQ)
    outs, args = _prep(qT, tT, variant, LQ, p)
    LIB.launch("plp_row", qT.get_device(), args, f"plp_row ({variant})")
    launches[variant] += 1
    return outs
