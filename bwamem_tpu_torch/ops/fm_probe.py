"""The chained FM-row gather probe: the hand-written CUDA kernels
(csrc/fm_probe_kernel.cu) and their plain PyTorch version.

The seeding scans (ops/smem over ops/fm.extend) are chains of dependent
index-row gathers that PyTorch issues one step at a time.  This probe runs
the same dependent chain — for each lane independently, `steps` times:

    blk = k >> 7
    acc = the sum of the W 32-bit words of row cmb[blk], each taken as
          int32, in wrapping int32 arithmetic
    k   = (k + acc) mod seq_len      wrapping add; the result is in
                                     [0, seq_len) as Python's % gives it

— on the card in one call, so the per-step cost of a host-issued scan step
can be held against the cost of the same step with no launch between
steps.

chain_words and chain_rows replace the two Pallas TPU probe kernels of the
reference package's tools/fm_step_probe.py (`kernel` at :120, `kernel_rows`
at :150): on a CUDA tensor each launches its kernels; on a CPU tensor each
runs chain_gather, the plain version.  There is no fallback between a
kernel and the plain version: a failed build or launch raises.  Each
wrapper counts its own launches (one a call).

What holds them on an H100 is the serial chain, not bytes or operations: a
lane cannot finish before `steps` dependent loads have come back from L2.  A
step reads its row only through the row's sum, so both take the sums once a
call (a coalesced pass over the table, word by word for chain_words, in
16-byte vectors for chain_rows) into a scratch of one int32 a row that the
wrapper allocates; the chain, a lane every four threads, then reads one
word a step and takes the remainder by an invariant divisor.  That is the
same function; a seeding step cannot take it, since the FM step reads the
part of a row that its next base picks.

The kernels are built and launched through ops/launch (nvcc for sm_90a at
first use, the caller's current stream).
"""
from __future__ import annotations

import ctypes

import torch

from bwamem_tpu_torch.ops.launch import Library

LANES = 128                  # lanes come in multiples of this
# (cmb, k0, out, sums, N, W, steps, seq_len)
LIB = Library("fm_probe_kernel.cu", {
    name: [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    for name in ("fm_chain_words", "fm_chain_rows")})
SRC = LIB.src

launches_words = 0  # kernel launches by chain_words (CUDA tensors)
launches_rows = 0   # kernel launches by chain_rows (CUDA tensors)


def words32(cmb: torch.Tensor) -> torch.Tensor:
    """The combined-row table as contiguous int32 words [nb, W] with the
    uint32 bit patterns kept.  ops/fm.FM holds the words as non-negative
    int64 (PyTorch has no uint32 arithmetic on the CPU); narrow it ONCE and
    hand the result to chain_gather / chain_words / chain_rows."""
    if cmb.dtype == torch.int32:
        return cmb.contiguous()
    if cmb.dtype != torch.int64:
        raise ValueError(f"cmb of dtype {cmb.dtype}")
    return (((cmb + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(
        torch.int32).contiguous()


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values wrapped to the int32 range (two's complement)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def chain_gather(cmb: torch.Tensor, k0: torch.Tensor, steps: int,
                 seq_len: int) -> torch.Tensor:
    """The plain version: `steps` chained one-row gathers issued from
    PyTorch, on the device of its tensors.  cmb: int32 [nb, W] (words32);
    k0: int32 [N] in [0, seq_len).  Returns int32 [N].  The wrapping int32
    arithmetic is spelled out in int64, so it does not lean on what a
    backend does on overflow."""
    cmb = words32(cmb)
    k = k0.to(torch.int64)
    for _ in range(steps):
        acc = cmb[k >> 7].to(torch.int64).sum(-1)
        k = torch.remainder(_wrap32(k + _wrap32(acc)), seq_len)
    return k.to(torch.int32)


def _prep(name: str, cmb, k0, steps: int, seq_len: int):
    """The kernels' checks; returns (out, the C entry's arguments): out and
    the scratch of row sums (one int32 a row a lane can reach) from
    new_empty."""
    if cmb.dtype != torch.int32 or cmb.dim() != 2 or not cmb.is_contiguous():
        raise ValueError(f"{name}: cmb must be contiguous int32 [nb, W] "
                         "(see words32)")
    nb, W = cmb.shape
    if W % 4 or cmb.data_ptr() % 16:
        raise ValueError(f"{name}: rows of {W} words at {cmb.data_ptr():#x} "
                         "are not 16-byte aligned")
    if k0.dtype != torch.int32 or k0.dim() != 1 or not k0.is_contiguous() \
            or k0.get_device() != cmb.get_device():
        raise ValueError(f"{name}: k0 must be contiguous int32 [N] on "
                         f"{cmb.device}")
    N = k0.shape[0]
    if N % LANES:
        raise ValueError(f"{name}: {N} lanes is not a multiple of {LANES}")
    if not 0 < seq_len < (1 << 31) or seq_len > nb * 128 or steps < 0:
        raise ValueError(f"{name}: seq_len {seq_len} for {nb} rows, "
                         f"steps {steps}")
    out = k0.new_empty(N)
    sums = cmb.new_empty((seq_len + 127) // 128)
    return out, (cmb.data_ptr(), k0.data_ptr(), out.data_ptr(),
                 sums.data_ptr(), int(N), int(W), int(steps), int(seq_len))


def _launch(name: str, cmb, k0, steps: int, seq_len: int):
    out, args = _prep(name, cmb, k0, steps, seq_len)
    LIB.launch(name, cmb.get_device(), args)
    return out


def chain_words(cmb: torch.Tensor, k0: torch.Tensor, steps: int,
                seq_len: int) -> torch.Tensor:
    """chain_gather on the card (fm_chain_words: the row sums read word by
    word, then the chain through them).  cmb: int32 [nb, W] from words32;
    k0: int32 [N] in [0, seq_len), N a multiple of 128."""
    if not cmb.is_cuda:
        return chain_gather(cmb, k0, steps, seq_len)
    global launches_words
    out = _launch("fm_chain_words", cmb, k0, steps, seq_len)
    launches_words += 1
    return out


def chain_rows(cmb: torch.Tensor, k0: torch.Tensor, steps: int,
               seq_len: int) -> torch.Tensor:
    """As chain_words, the row sums read with 16-byte vector loads
    (fm_chain_rows)."""
    if not cmb.is_cuda:
        return chain_gather(cmb, k0, steps, seq_len)
    global launches_rows
    out = _launch("fm_chain_rows", cmb, k0, steps, seq_len)
    launches_rows += 1
    return out
