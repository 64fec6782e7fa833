"""Milliseconds of the paired-end host tail (the program's timers
pestat.batch, matesw.batch, pair.batch) per 1000 reads; pairs only."""

NAMES = ("pestat.batch", "matesw.batch", "pair.batch")


def read(ctx):
    t = ctx["timers"]
    if not ctx["paired"] or not ctx["reads"] or not any(n in t
                                                        for n in NAMES):
        return None
    ms = 1e3 * sum(t[n][1] for n in NAMES if n in t)
    return ms / (ctx["reads"] / 1000.0)
