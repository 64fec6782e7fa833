"""Kernel launches in the profiler's trace of the window (copies and
memsets not counted) per 1000 reads."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["reads"] or not tr["launches"]:
        return None
    return tr["launches"] / (ctx["reads"] / 1000.0)
