"""Fixtures of the benchmark's own tests (python3 -m pytest portbench/tests).

`tiny_root` is a checkout-like directory with a BENCHMARK.json of two
throwaway cells over a 200 kbp configuration, the repository's metric
readers, and small traffic files; runs there use the CPU.  Tests that
need the card take the `card` fixture and carry the `card` marker."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY_LIMITS = {"missing": 0, "seq_off": 0.0, "nm_md_off": 0.0,
               "mapq_over": 0.0, "as_off": 0.01, "cigar_off": 0.01,
               "misplaced": 0.01}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: run on the card "
                    "(python3 -m pytest portbench/tests -m card)")


def tiny_config() -> dict:
    with open(os.path.join(ROOT, "portbench/configs/grch38_chr1.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", genome_seed=7, contigs=[
        {"name": "c1", "length": 150000, "repeat_model": True,
         "n_runs": {"fixed": [[1000, 500]], "scattered": 3,
                    "scattered_bases": 300}},
        {"name": "c2", "length": 50000, "repeat_model": False}])
    cfg["repeats"][1]["length"] = [500, 2000]
    cfg["repeats"][2]["length"] = [2000, 5000]
    return cfg


def make_root(path: str) -> str:
    """A directory that holds a BENCHMARK.json of the cells t.se and t.pe
    and a portbench/ of their data, beside the real metric readers."""
    d = os.path.join(path, "portbench")
    for sub in ("configs", "workloads", "cells"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    shutil.copytree(os.path.join(ROOT, "portbench/metrics"),
                    os.path.join(d, "metrics"), dirs_exist_ok=True)

    def dump(obj, *p):
        with open(os.path.join(path, *p), "w") as f:
            json.dump(obj, f, indent=1)
    dump(tiny_config(), "portbench/configs/tiny.json")
    for tr, src in (("se", "se101"), ("pe", "pe150")):
        with open(os.path.join(ROOT, f"portbench/workloads/{src}.json")) as f:
            t = json.load(f)
        t["batch_bases"] = t["read_len"] * 256
        dump(t, f"portbench/workloads/{tr}.json")
    dump({"pool_rate": 100, "check_reads": 512, "limits": TINY_LIMITS},
         "portbench/cells/t.se.json")
    dump({"pool_rate": 100, "check_reads": 512,
          "limits": dict(TINY_LIMITS, mate_off=0.0)},
         "portbench/cells/t.pe.json")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"] = [{"name": "tiny", "source": "synthetic",
                     "file": "portbench/configs/tiny.json", "reduced": [],
                     "why": "tests"}]
    b["workloads"] = [
        {"name": "t.se", "config": "tiny", "traffic": "se", "chips": 1,
         "why": "tests"},
        {"name": "t.pe", "config": "tiny", "traffic": "pe", "chips": 1,
         "why": "tests"}]
    for m in b["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["t.pe"]
    dump(b, "BENCHMARK.json")
    return path


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("bench")))


def run_cell(root: str, argv: list[str], capsys) -> dict:
    """harness.run on the CPU; the parsed result line."""
    from portbench import harness
    assert harness.run(argv, device="cpu", root=root) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
