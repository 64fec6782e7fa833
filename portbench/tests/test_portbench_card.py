"""On the card: one short run of a cell through the command, as the
benchmark's check makes it."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("trace", ["0", "1"])
def test_ecoli_cell_runs_correct(card, trace):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ecoli.se101", "--seed", "4000000001", "--seconds",
                        "5", "--trace", trace], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["memory_peak_bytes"] > 0
    if trace == "1":
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert "device.idle_share" in res["metrics"]
