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

On a CUDA tensor plp_row launches the kernel (a thread a lane for the
first four variants, a warp a lane for roll) and counts the launch in
launches[variant]; on a CPU tensor it runs the plain version and counts
nothing.  There is no fallback between the two: a failed build or launch
raises.  The kernel is built and launched through ops/launch (nvcc for
sm_90a at first use, the caller's current stream).
"""
from __future__ import annotations

import ctypes

import torch

from bwamem_tpu_torch.ops.dispatch_probe import check_tables
from bwamem_tpu_torch.ops.gather_probe import _wrap32
from bwamem_tpu_torch.ops.launch import Library

VARIANTS = ("eh_only", "noscan", "noreduce", "full", "roll")
NEG = -0x40000000           # the TPU kernel's NEGc
SMEM_MAX = 232448           # bytes of shared memory a block may opt into
LANE_BLOCK, WARP_BLOCK = 32, 4   # lanes a block (a thread a lane), warps
# int32 operations a cell of each variant's function, counted from its
# minimum: eh_only 5 (compare, select, != 0, add, select); noscan 13 (+
# t_ins's sub and max, A's add, h's max, eh_e's two subs and two maxes;
# the one-row shift moves data and does no operation); noreduce 16 (+ the
# prefix max, its - row and max with 0); full 23 (+ mj_enc's shift, or,
# max; lst's (h | eh_e) != 0 as or and compare, its select and max;
# h1_enc reads one row a lane and does no work a cell); roll as full
OPS_PER_CELL = {"eh_only": 5, "noscan": 13, "noreduce": 16, "full": 23,
                "roll": 23}

# (qT, tT, out, aux, L1p, rows, B, LQ, variant, lanes a block, shared
# bytes)
LIB = Library("pl_probe_kernel.cu",
              {"plp_row": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7})
SRC = LIB.src

launches = dict.fromkeys(VARIANTS, 0)   # kernel launches (CUDA tensors)


def l1p_of(LQ: int) -> int:
    """The TPU script's query rows for a query of LQ bases (:30)."""
    return (LQ + 1 + 7) // 8 * 8


def lanes_per_block(variant: str, L1p: int) -> tuple[int, int]:
    """(n, shared bytes) of a block: n lanes of a thread each (eh_h and
    eh_e, 2 x L1p words a lane), or for roll n warps of a lane each (qT,
    eh_h and eh_e, 3 x L1p words); as many as fit, up to LANE_BLOCK or
    WARP_BLOCK.  Raises ValueError when one lane's state does not fit."""
    words, top = (3, WARP_BLOCK) if variant == "roll" else (2, LANE_BLOCK)
    per = words * L1p * 4
    n = min(top, SMEM_MAX // per) if L1p > 0 else top
    if n < 1:
        raise ValueError(f"plp_row: a lane's state of {per} bytes at L1p "
                         f"{L1p} does not fit in {SMEM_MAX} bytes of shared "
                         f"memory ({variant})")
    return n, n * per


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


def _prep(qT, tT, variant, LQ):
    """Checks a call's tensors (ValueError on anything the kernel does not
    take) and returns the outputs and the C entry's arguments."""
    _check_args(qT, tT, variant, LQ)
    L1p, B = qT.shape
    n, smem = lanes_per_block(variant, L1p)
    out = torch.empty_like(qT)
    aux = torch.empty((3, B), dtype=torch.int32, device=qT.device)
    return (out, aux), (qT.data_ptr(), tT.data_ptr(), out.data_ptr(),
                        aux.data_ptr(), L1p, tT.shape[0], B, int(LQ),
                        VARIANTS.index(variant), n, smem)


def plp_row(qT: torch.Tensor, tT: torch.Tensor, variant: str,
            LQ: int) -> tuple[torch.Tensor, torch.Tensor]:
    """qT int32 [L1p, B], tT int32 [ROWS, B], 0 < LQ <= L1p -> (out int32
    [L1p, B], aux int32 [3, B]) of the variant (see plp_plain)."""
    if not qT.is_cuda:
        return plp_plain(qT, tT, variant, LQ)
    outs, args = _prep(qT, tT, variant, LQ)
    LIB.launch("plp_row", qT.get_device(), args, f"plp_row ({variant})")
    launches[variant] += 1
    return outs
