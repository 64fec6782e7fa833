"""utils/timers of bwamem_tpu_torch, the port's tracer: the disabled path,
spans with parents on time.time_ns's clock, start/stop spans, counters,
gauges, reset, and device sections (CUDA event pairs, here with fake
events: a pair is read only once complete, snapshot() waits for the
rest)."""
import time

import pytest
import torch

from bwamem_tpu_torch.utils import timers


@pytest.fixture
def on():
    timers.reset()
    timers.enable(True)
    try:
        yield timers
    finally:
        timers.enable(False)
        timers.reset()


def test_disabled_records_nothing():
    timers.reset()
    timers.enable(False)
    cpu = torch.device("cpu")
    assert timers.section("a") is timers.section("b")
    assert timers.device_section("a", cpu) is timers.section("a")
    with timers.section("a"):
        with timers.device_section("b", cpu):
            timers.count("c", 3)
            timers.gauge("d", 7)
    tok = timers.start("e")
    assert tok is None
    timers.stop("e", tok)
    assert timers.snapshot() == {}
    assert timers.spans() == []
    assert timers.report() == ""


def test_spans_nest_with_parents_and_epoch_stamps(on):
    t0 = time.time_ns()
    with timers.section("outer"):
        with timers.section("mid"):
            with timers.section("inner"):
                pass
        with timers.section("mid2"):
            pass
    with timers.section("next"):
        pass
    t1 = time.time_ns()
    sp = timers.spans()
    assert [s[0] for s in sp] == ["outer", "mid", "inner", "mid2", "next"]
    assert [s[3] for s in sp] == [None, 0, 1, 0, None]
    for name, s, e, parent in sp:
        assert t0 <= s <= e <= t1
        if parent is not None:
            assert sp[parent][1] <= s and e <= sp[parent][2]
    snap = timers.snapshot()
    for name, s, e, _ in sp:
        assert snap[name] == (1, pytest.approx((e - s) / 1e9))


def test_start_stop_spans(on):
    tok = timers.start("pair")
    with timers.section("child"):
        inner = timers.start("inner")
        timers.stop("inner", inner)
    with timers.section("child"):
        pass
    timers.stop("pair", tok)
    with timers.section("after"):
        pass
    sp = timers.spans()
    assert [(s[0], s[3]) for s in sp] == [
        ("pair", None), ("child", 0), ("inner", 1), ("child", 0),
        ("after", None)]
    assert all(s[2] is not None for s in sp)
    snap = timers.snapshot()
    assert snap["child"][0] == 2 and snap["pair"][0] == 1


def test_an_open_span_has_no_end(on):
    tok = timers.start("open")
    assert timers.spans() == [("open", tok[1], None, None)]
    timers.stop("open", tok)
    assert timers.spans()[0][2] is not None


def test_counters_and_gauges(on):
    timers.count("rows", 3)
    timers.count("rows")
    for v in (5, 9, 2):
        timers.gauge("size", v)
    snap = timers.snapshot()
    assert snap["rows.count"] == 4
    assert snap["size.gauge"] == (2, 9)
    rep = timers.report()
    assert "rows" in rep and "count=4" in rep and "last=2 max=9" in rep


def test_reset_clears_everything(on):
    with timers.section("a"):
        timers.count("b")
        timers.gauge("c", 1)
    timers.reset()
    assert timers.snapshot() == {} and timers.spans() == []
    with timers.section("d"):
        pass
    assert timers.spans()[0][3] is None


def test_span_cap_keeps_the_totals(on, monkeypatch):
    monkeypatch.setattr(timers, "MAX_SPANS", 2)
    for _ in range(5):
        with timers.section("a"):
            pass
    snap = timers.snapshot()
    assert len(timers.spans()) == 2
    assert snap["a"][0] == 5 and snap["timers.spans_dropped.count"] == 3


def test_device_section_on_the_cpu_is_a_host_span(on):
    with timers.device_section("front.p1", torch.device("cpu")):
        with timers.section("inside"):
            pass
    snap = timers.snapshot()
    assert snap["front.p1"][0] == 1
    assert not any(k.endswith(".gpu") for k in snap)
    assert [(s[0], s[3]) for s in timers.spans()] == [("front.p1", None),
                                                     ("inside", 0)]


class FakeEvent:
    """A CUDA event that completes when the test says; elapsed_time
    raises on a pair still in flight, as CUDA's does."""
    made = []
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.done = False
        self.t = None
        self.stream = None
        FakeEvent.made.append(self)

    def record(self, stream):
        self.stream = stream
        FakeEvent.clock += 1.5
        self.t = FakeEvent.clock

    def query(self):
        return self.done

    def synchronize(self):
        # one stream completes in order: every event before this one too
        for e in FakeEvent.made[:FakeEvent.made.index(self) + 1]:
            e.done = True

    def elapsed_time(self, end):
        assert self.done and end.done, "elapsed_time on a pair in flight"
        return end.t - self.t


def test_device_pairs_resolve_only_when_complete(on, monkeypatch):
    FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: ("s", dev))
    card = torch.device("cuda", 0)
    with timers.device_section("front.p1", card):
        pass
    assert len(FakeEvent.made) == 2
    assert all(e.stream == ("s", card) for e in FakeEvent.made)
    # the next device section finds the first pair in flight: left pending
    with timers.device_section("front.p2", card):
        for e in FakeEvent.made[:2]:
            e.done = True
    assert len(timers._pending) == 2
    # a third finds the first complete, the second not
    with timers.device_section("front.p1", card):
        pass
    assert [p[0] for p in timers._pending] == ["front.p2", "front.p1"]
    assert timers._gpu["front.p1"] == [1, pytest.approx(1.5e-3)]
    snap = timers.snapshot()          # waits for the rest
    assert snap["front.p1.gpu"] == (2, pytest.approx(3e-3))
    assert snap["front.p2.gpu"] == (1, pytest.approx(1.5e-3))
    assert snap["front.p1"][0] == 2 and snap["front.p2"][0] == 1
    assert timers._pending == []


def test_device_section_sees_a_wrapped_section(on, monkeypatch):
    seen = []
    orig = timers.section

    def wrapped(name):
        seen.append(name)
        return orig(name)
    monkeypatch.setattr(timers, "section", wrapped)
    with timers.device_section("front.ext", torch.device("cpu")):
        pass
    assert seen == ["front.ext"]


def test_a_failed_device_section_records_no_pair(on, monkeypatch):
    FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "s")
    card = torch.device("cuda", 0)
    with pytest.raises(ValueError):
        with timers.device_section("front.ext", card):
            raise ValueError
    assert len(FakeEvent.made) == 1 and timers._pending == []
    snap = timers.snapshot()
    assert snap["front.ext"][0] == 1 and "front.ext.gpu" not in snap
