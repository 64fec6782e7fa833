"""Milliseconds of the host-compacted front (the program's section
front.host, the whole of Aligner._regs_host_front) per 1000 reads.  0
where the device front counted its trips (front.trips.run) and no row
fell back; None for a program without these timers."""


def read(ctx):
    t = ctx["timers"]
    if not ctx["reads"]:
        return None
    if "front.host" in t:
        ms = 1e3 * t["front.host"][1]
    elif "front.trips.run.count" in t:
        ms = 0.0
    else:
        return None
    return ms / (ctx["reads"] / 1000.0)
