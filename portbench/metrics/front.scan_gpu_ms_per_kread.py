"""Device milliseconds of the seeding scans (the program's device
sections front.p1, front.p2, front.p3: CUDA event pairs on the front's
stream, `.gpu` in its timers) per 1000 reads; None without them (on the
CPU, or a program without device sections)."""

NAMES = ("front.p1.gpu", "front.p2.gpu", "front.p3.gpu")


def read(ctx):
    t = ctx["timers"]
    if not ctx["reads"] or not any(n in t for n in NAMES):
        return None
    ms = 1e3 * sum(t[n][1] for n in NAMES if n in t)
    return ms / (ctx["reads"] / 1000.0)
