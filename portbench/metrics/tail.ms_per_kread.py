"""Milliseconds of the host tail (the program's timers dedup.batch,
mark.batch, select.batch, cigar.jobs, phaseC.batch, sam.render) per 1000
reads."""

NAMES = ("dedup.batch", "mark.batch", "select.batch", "cigar.jobs",
         "phaseC.batch", "sam.render")


def read(ctx):
    t = ctx["timers"]
    if not ctx["reads"] or not any(n in t for n in NAMES):
        return None
    ms = 1e3 * sum(t[n][1] for n in NAMES if n in t)
    return ms / (ctx["reads"] / 1000.0)
