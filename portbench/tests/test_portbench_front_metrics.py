"""The readers of the device front's own timers (portbench/metrics/) on
hand-made contexts: each gives its value from the timers it names, and
None where a run has none of them (a CPU run, or a program without
them)."""
from __future__ import annotations

import os

import pytest

from conftest import ROOT

READS = 40_000
GPU = {"front.p1.gpu": (4, 2.0), "front.p2.gpu": (4, 1.0),
       "front.p3.gpu": (4, 0.5), "front.expand.gpu": (4, 0.25),
       "front.chain.gpu": (4, 0.125), "front.ext.gpu": (4, 0.75),
       "front.ext2.gpu": (2, 0.375)}
TRIPS = {"front.trips.run.count": 4000, "front.trips.used.count": 1000}


def reader(name):
    from portbench import harness
    return harness.metric_reader(os.path.join(ROOT, "portbench"), name)


def ctx(timers, reads=READS):
    return dict(reads=reads, timers=timers)


@pytest.mark.parametrize("name,timers,want", [
    ("front.scan_gpu_ms_per_kread", GPU, 3500.0 / 40),
    ("front.scan_gpu_ms_per_kread", {"front.p2.gpu": (1, 0.04)}, 1.0),
    ("front.gpu_ms_per_kread", GPU, 5000.0 / 40),
    ("host_front.ms_per_kread", dict(TRIPS, **{"front.host": (3, 0.8)}),
     20.0),
    ("host_front.ms_per_kread", TRIPS, 0.0),
    ("host_front.ms_per_kread", {"front.host": (1, 0.4)}, 10.0),
    ("front.regrow_ms_per_kread", dict(TRIPS, **{"front.regrow": (2, 1.2)}),
     30.0),
    ("front.regrow_ms_per_kread", TRIPS, 0.0),
    ("front.trip_use_share", TRIPS, 0.25),
    ("front.trip_use_share", {"front.trips.run.count": 64}, 0.0),
])
def test_reader_values(name, timers, want):
    got = reader(name)(ctx(timers))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "front.scan_gpu_ms_per_kread", "front.gpu_ms_per_kread",
    "host_front.ms_per_kread", "front.regrow_ms_per_kread",
    "front.trip_use_share"])
def test_readers_give_none_without_their_inputs(name):
    # the parent program's timers: sections and counters, none of these
    old = {"front.p1": (4, 3.0), "front.dispatch": (5, 1.0),
           "front.retries.count": 1, "front.fallback_rows.count": 2,
           "seed.collect_rt": (1, 0.5)}
    assert reader(name)(ctx(old)) is None
    assert reader(name)(ctx({})) is None
    if name.endswith("_per_kread"):
        assert reader(name)(ctx(dict(GPU, **TRIPS), reads=0)) is None
