"""Whole runs of the harness on the CPU at a tiny size: the result
line's shape, a cell added as files only, the controls and faults that
must make `correct` false, and what the run and the reference import."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import ROOT, make_root, run_cell

END_TO_END = {"reads_per_s", "setup_s"}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_finds_its_files():
    from portbench import harness
    b = bench()
    for c in b["workloads"]:
        spec = harness.cell_spec(ROOT, c["name"])
        assert spec["config"]["name"] == c["config"]
        assert set(spec["run"]["limits"]) >= {"missing", "seq_off",
                                              "nm_md_off", "mapq_over",
                                              "as_off", "cigar_off",
                                              "misplaced"}
        assert ("mate_off" in spec["run"]["limits"]) == \
            spec["traffic"]["paired"]
    for m in b["per_layer"]:
        assert callable(harness.metric_reader(
            os.path.join(ROOT, "portbench"), m["name"]))
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])


def test_result_line(tiny_root, capsys):
    res = run_cell(tiny_root, ["--workload", "t.se", "--seed",
                               str(2 ** 31 + 7), "--seconds", "0",
                               "--trace", "0"], capsys)
    assert list(res)[:5] == RESULT_KEYS and list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 256
    assert set(res["metrics"]) == END_TO_END
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for k, v in res["check"].items():
        assert v["value"] <= v["limit"], k


def test_traced_result_line(tiny_root, capsys):
    res = run_cell(tiny_root, ["--workload", "t.pe", "--seed", "11",
                               "--seconds", "0", "--trace", "1"], capsys)
    names = {m["name"] for m in bench()["per_layer"]}
    assert res["correct"] is True
    assert set(res["metrics"]) <= names
    # counted and spanned on any device; device-trace ones need a card
    assert {"driver.cpu_s_per_kread", "front.ms_per_kread",
            "front.fallback_share", "pe_tail.ms_per_kread",
            "tail.ms_per_kread"} <= set(res["metrics"])
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    for k in ("device_ops", "idle_gaps"):
        assert 0 < len(res["breakdown"][k]) <= 10
    assert list(res)[-1] == "check"


def test_a_cell_added_as_files_only(tmp_path, capsys):
    """A configuration, traffic mix, cell and per-layer metric that are new
    files and new entries of BENCHMARK.json, with no file edited."""
    root = make_root(str(tmp_path))
    d = os.path.join(root, "portbench")
    shutil.copy(os.path.join(d, "configs/tiny.json"),
                os.path.join(d, "configs/tiny2.json"))
    with open(os.path.join(d, "configs/tiny2.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny2", genome_seed=8)
    with open(os.path.join(d, "configs/tiny2.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(d, "workloads/se.json")) as f:
        t = json.load(f)
    t.update(read_len=76, batch_bases=76 * 200)
    with open(os.path.join(d, "workloads/se76.json"), "w") as f:
        json.dump(t, f)
    shutil.copy(os.path.join(d, "cells/t.se.json"),
                os.path.join(d, "cells/new.se76.json"))
    with open(os.path.join(d, "metrics/reads_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return ctx['reads']\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["configs"].append(dict(b["configs"][0], name="tiny2",
                             file="portbench/configs/tiny2.json"))
    b["workloads"].append({"name": "new.se76", "config": "tiny2",
                           "traffic": "se76", "chips": 1, "why": "new"})
    b["per_layer"].append({"name": "reads_seen", "unit": "reads",
                           "better": "higher", "source": "program_counter",
                           "layer": "driver", "moves": "reads_per_s",
                           "workloads": ["new.se76"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    res = run_cell(root, ["--workload", "new.se76", "--seed", "3",
                          "--seconds", "0", "--trace", "1"], capsys)
    assert res["correct"] is True
    assert res["metrics"]["reads_seen"]["value"] == 200


@pytest.mark.parametrize("cell", ["t.se", "t.pe"])
def test_controls_fail_the_cells_limits(tiny_root, cell):
    """The control (the clipping rule dropped) fails the real cells'
    limits; so does int8 on 150 bp reads; the program passes them."""
    from portbench import controls, harness
    real = harness.cell_spec(ROOT, "chr1.pe150" if cell == "t.pe"
                             else "ecoli.se101")["run"]["limits"]
    out = controls_readings(tiny_root, cell, 21)

    def ok(nums):
        return all(nums[k] <= v for k, v in real.items())
    assert ok(out["program"])
    assert not ok(out["control.local"])
    if cell == "t.pe":
        assert not ok(out["control.int8"])
    for f in controls.FAULTS:
        assert not ok(out[f]), f


def controls_readings(root, cell, seed):
    from portbench import controls, harness
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.pipeline.align import Aligner
    spec = harness.cell_spec(root, cell)
    paired = spec["traffic"]["paired"]
    g, prefix, _ = harness.genome_and_index(spec, harness.cache_dir(spec))
    al = Aligner(load_index(prefix), harness.options(spec["config"], paired),
                 device="cpu")
    return controls.readings(spec, g, al, seed, 2, paired)


def test_an_emptied_pool_gives_no_result(tmp_path, capsys):
    """A window longer than the pool's batches last: no result line."""
    from portbench import harness
    root = make_root(str(tmp_path))
    cell = os.path.join(root, "portbench/cells/t.se.json")
    with open(cell) as f:
        c = json.load(f)
    with open(cell, "w") as f:
        json.dump(dict(c, pool_rate=0), f)     # a pool of two batches
    assert harness.run(["--workload", "t.se", "--seed", "3", "--seconds",
                        "600", "--trace", "0"], device="cpu",
                       root=root) != 0
    assert capsys.readouterr().out.strip() == ""


def test_the_first_run_reports_its_build_apart(tmp_path, capsys):
    """The genome and index build of a checkout's first run is left out
    of setup_s and reported as index_build_s."""
    root = make_root(str(tmp_path))
    argv = ["--workload", "t.se", "--seed", "4", "--seconds", "0",
            "--trace", "0"]
    first = run_cell(root, argv, capsys)
    again = run_cell(root, argv, capsys)
    assert first["index_build_s"] > 0 and "index_build_s" not in again
    assert list(first)[-1] == "check"


def drop_second_half(fn):
    def wrapped(self, reads, *a, **k):
        out = fn(self, reads, *a, **k)
        return out[:len(out) // 2] + [""] * (len(out) - len(out) // 2)
    return wrapped


def move_every_tenth(fn):
    from portbench.controls import shift_pos

    def wrapped(self, reads, *a, **k):
        out = fn(self, reads, *a, **k)
        return [shift_pos(t) if i % 10 == 0 else t for i, t in
                enumerate(out)]
    return wrapped


def lower_every_tenth(fn):
    from portbench.controls import lower_as

    def wrapped(self, reads, *a, **k):
        out = fn(self, reads, *a, **k)
        return [lower_as(t) if i % 10 == 0 else t for i, t in
                enumerate(out)]
    return wrapped


def flip_every_tenth(fn):
    from portbench.controls import flip_strand

    def wrapped(self, reads, *a, **k):
        out = fn(self, reads, *a, **k)
        return [flip_strand(t) if i % 10 == 0 else t for i, t in
                enumerate(out)]
    return wrapped


def raise_every_tenth(fn):
    from portbench.controls import raise_mapq

    def wrapped(self, reads, *a, **k):
        out = fn(self, reads, *a, **k)
        return [raise_mapq(t) if i % 10 == 0 else t for i, t in
                enumerate(out)]
    return wrapped


@pytest.mark.parametrize("fault", [drop_second_half, move_every_tenth,
                                   lower_every_tenth, flip_every_tenth,
                                   raise_every_tenth])
@pytest.mark.parametrize("cell", ["t.se", "t.pe"])
def test_a_broken_path_is_not_correct(tiny_root, capsys, monkeypatch,
                                      fault, cell):
    """The timed path broken underneath: half of each batch's records
    left out, or answers altered where they are produced."""
    from bwamem_tpu_torch.pipeline.align import Aligner
    name = "align_batch_pe" if cell == "t.pe" else "align_batch_se"
    monkeypatch.setattr(Aligner, name, fault(getattr(Aligner, name)))
    res = run_cell(tiny_root, ["--workload", cell, "--seed", "5",
                               "--seconds", "0", "--trace", "0"], capsys)
    assert res["correct"] is False


def test_forbidden_names_compare_whole(monkeypatch):
    import types
    from portbench import harness
    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "bwamem_tpu_torch.ops",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "bwamem_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert harness.forbidden_loaded() == ["bwamem_tpu", "jaxlib"]


IMPORT_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level_after(body: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", IMPORT_PROBE.format(root=ROOT, body=body)],
        capture_output=True, text=True, check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax(tiny_root):
    names = top_level_after(
        "from portbench import harness\n"
        f"harness.run(['--workload', 't.se', '--seed', '1', '--seconds', "
        f"'0', '--trace', '1'], device='cpu', root={tiny_root!r})")
    assert "bwamem_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "bwamem_tpu"}


def test_reference_loads_nothing_of_the_program():
    names = top_level_after(
        "import numpy as np\n"
        "from portbench.ref import check, sw\n"
        "from portbench.gen import genome, reads\n"
        "q = np.zeros((2, 30), np.uint8)\n"
        "sw.best_scores(q, np.zeros((2, 40), np.uint8), dict(a=1, b=4, "
        "o_del=6, e_del=1, o_ins=6, e_ins=1))\n")
    assert not names & {"jax", "jaxlib", "flax", "bwamem_tpu",
                        "bwamem_tpu_torch", "torch"}


def test_no_result_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/: the run
    exits with an error and prints no result line."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ecoli.se101", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_no_result_without_a_card(tmp_path):
    """On a machine without the cell's CUDA devices: exit 3, no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "ecoli.se101", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True)
    assert r.returncode == 3 and r.stdout.strip() == ""
