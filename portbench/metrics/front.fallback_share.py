"""Reads the host-compacted front had to take (the program's counter
front.fallback_rows) over the reads of the window."""


def read(ctx):
    if not ctx["reads"]:
        return None
    return ctx["timers"].get("front.fallback_rows.count", 0) / ctx["reads"]
