"""Kernel #1 (ext_pl2_kernel) against its roofline, in %: the least time
of the window's calls (portbench/roofline.py: band cells at the int32
peak or bytes at the HBM peak, whichever is larger, from each call's
lanes) over the kernel's device time in the profiler's trace."""


def read(ctx):
    tr, bound = ctx["trace"], ctx["ext_bound_s"]
    if tr is None or bound is None:
        return None
    dev = sum(v for k, v in tr["kernel_s"].items() if "ext_pl2_kernel" in k)
    return 100.0 * bound / dev if dev > 0 else None
