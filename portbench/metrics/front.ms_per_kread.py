"""Host milliseconds inside the device front's two calls
(device_front.front_start, front_finish; the benchmark's spans, device
waits included) per 1000 reads."""


def read(ctx):
    s = ctx["spans"]
    if not ctx["reads"] or ("front_start" not in s
                            and "front_finish" not in s):
        return None
    ms = 1e3 * (s.get("front_start", 0.0) + s.get("front_finish", 0.0))
    return ms / (ctx["reads"] / 1000.0)
