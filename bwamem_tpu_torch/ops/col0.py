"""The column-0 gather out[q] = tab[k[q], 0] of an int32 table [R, W] at
int32 indices k [N] in [0, R): its plain PyTorch version and the one call
path of col0_kernel (csrc/col0.cuh), which two TPU probe kernels price at
two widths:

  gp2_col0 (ops/gather_probe2; tools/pl_gather_probe2.py:122, probe_d)
           1024 lanes, one `aln` occ round's lookups
  gp3_col0 (ops/gather_probe3; tools/pl_gather_probe3.py:103, probe_d2)
           8 lanes

Each of the two libraries (csrc/gather_probe2_kernel.cu,
gather_probe3_kernel.cu) has its own C entry to the kernel; the wrappers
keep their names and launch counters and both come here.  The kernel is at
a launch's latency, so the host's issue is most of a call: `launch` checks
each tensor attribute once, allocates the output with k.new_empty (0.6 us
a call below torch.empty with a device argument on the H100) and goes
through ops/launch.  Precondition the kernel does not check (the plain
version raises): k in [0, R).
"""
from __future__ import annotations

import torch

I32 = torch.int32


def plain(tab: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return tab[k.to(torch.int64), 0]


def prep(name: str, tab: torch.Tensor, k: torch.Tensor):
    """(out, the C entry's arguments before the stream) for one call;
    ValueError on anything the kernel does not take: a table that is not
    a nonempty contiguous int32 [R, W], indices that are not contiguous
    int32 [N], or the two on different devices."""
    if (tab.dtype != I32 or k.dtype != I32 or tab.dim() != 2
            or k.dim() != 1 or not tab.is_contiguous()
            or not k.is_contiguous() or tab.numel() == 0
            or k.get_device() != tab.get_device()):
        raise ValueError(f"{name}: tab must be a nonempty contiguous int32 "
                         f"[R, W] and k a contiguous int32 [N] on its "
                         f"device, got tab {tab.dtype} {tuple(tab.shape)} on "
                         f"{tab.device}, k {k.dtype} {tuple(k.shape)} on "
                         f"{k.device}")
    n = k.shape[0]
    out = k.new_empty(n)
    return out, (tab.data_ptr(), k.data_ptr(), out.data_ptr(), n,
                 tab.shape[1])


def launch(lib, entry: str, tab: torch.Tensor,
           k: torch.Tensor) -> torch.Tensor:
    """tab[k, 0] by col0_kernel through `entry` of the ops/launch.Library
    `lib`, on the caller's current stream of the tensors' device."""
    out, args = prep(entry, tab, k)
    lib.launch(entry, tab.get_device(), args)
    return out
