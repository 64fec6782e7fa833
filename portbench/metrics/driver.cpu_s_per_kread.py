"""Host CPU seconds of the run's process (user + system, getrusage) over
the window, per 1000 reads the window yielded."""


def read(ctx):
    return ctx["cpu_s"] / (ctx["reads"] / 1000.0) if ctx["reads"] else None
