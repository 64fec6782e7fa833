"""Milliseconds of the device front's reruns after an arena overflow
(the program's section front.regrow: each re-dispatch to the end of the
meta fetch that waits for it) per 1000 reads.  0 where the device front
counted its trips (front.trips.run) and reran nothing; None for a
program without these timers."""


def read(ctx):
    t = ctx["timers"]
    if not ctx["reads"]:
        return None
    if "front.regrow" in t:
        ms = 1e3 * t["front.regrow"][1]
    elif "front.trips.run.count" in t:
        ms = 0.0
    else:
        return None
    return ms / (ctx["reads"] / 1000.0)
