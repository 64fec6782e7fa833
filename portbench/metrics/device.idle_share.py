"""1 - (union of the device's kernel and copy intervals) / window, from
the profiler's trace of the window (CUDA activity only)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
