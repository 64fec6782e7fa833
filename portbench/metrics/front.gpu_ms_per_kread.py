"""Device milliseconds of the device front's seven programs (the
program's device sections front.p1, .p2, .p3, .expand, .chain, .ext and
.ext2: CUDA event pairs on the front's stream, `.gpu` in its timers) per
1000 reads; None without them (on the CPU, or a program without device
sections)."""

NAMES = tuple(f"front.{p}.gpu" for p in ("p1", "p2", "p3", "expand",
                                         "chain", "ext", "ext2"))


def read(ctx):
    t = ctx["timers"]
    if not ctx["reads"] or not any(n in t for n in NAMES):
        return None
    ms = 1e3 * sum(t[n][1] for n in NAMES if n in t)
    return ms / (ctx["reads"] / 1000.0)
