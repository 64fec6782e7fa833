"""Scan trips the device front's batches needed over the trips they ran
(the program's counters front.trips.used and front.trips.run: the
seeding scans' steps with a lane active, against t1s + t2s + t3s of
each batch's kept dispatch); None without them."""


def read(ctx):
    t = ctx["timers"]
    run = t.get("front.trips.run.count", 0)
    if not run:
        return None
    return t.get("front.trips.used.count", 0) / run
