"""bwamem_tpu_torch stands alone: importing it loads neither JAX nor
bwamem_tpu (checked in a subprocess, since this test process has both),
no source file of the package, chip_smoke.py or the port's tools
(tools/torch_*.py, tools/se_smoke_data.py) imports them, its entry points
(mem, aln, samse, sampe, bwasw, fastmap, maxk, pemerge) refuse to run
without a GPU unless asked for the CPU, and chip_smoke.py, the FM-step
probe, the three gather-strategy probes, the dispatch probe and the
row-body ablation probe fail without a GPU or outside a checkout."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "bwamem_tpu_torch"
MODULES = ["bwamem_tpu_torch", "bwamem_tpu_torch.cli",
           "bwamem_tpu_torch.pipeline.align",
           "bwamem_tpu_torch.pipeline.device_front",
           "bwamem_tpu_torch.pipeline._shapes",
           "bwamem_tpu_torch.pipeline.seeding_host",
           "bwamem_tpu_torch.pipeline.chainflt_host",
           "bwamem_tpu_torch.pipeline.extend_host",
           "bwamem_tpu_torch.pipeline.seedchain",
           "bwamem_tpu_torch.ops.chain", "bwamem_tpu_torch.ops.align_ext",
           "bwamem_tpu_torch.ops.local_sw",
           "bwamem_tpu_torch.ops.ext_kernel", "bwamem_tpu_torch.ops.fm_probe",
           "bwamem_tpu_torch.pair", "bwamem_tpu_torch.finalize",
           "bwamem_tpu_torch.io.sam", "bwamem_tpu_torch.index",
           "bwamem_tpu_torch.index.microcmd", "bwamem_tpu_torch.index.shm",
           "bwamem_tpu_torch.ops.gather_probe", "bwamem_tpu_torch.pemerge",
           "bwamem_tpu_torch.native", "bwamem_tpu_torch.ops.global_sw",
           "bwamem_tpu_torch.ops.gather_probe2", "bwamem_tpu_torch.legacy",
           "bwamem_tpu_torch.legacy.rng", "bwamem_tpu_torch.legacy.aln",
           "bwamem_tpu_torch.legacy.samse", "bwamem_tpu_torch.legacy.sampe",
           "bwamem_tpu_torch.bwasw", "bwamem_tpu_torch.bwasw.aux",
           "bwamem_tpu_torch.bwasw.bwtl", "bwamem_tpu_torch.bwasw.chain",
           "bwamem_tpu_torch.bwasw.core", "bwamem_tpu_torch.bwasw.hostfm",
           "bwamem_tpu_torch.bwasw.ksort", "bwamem_tpu_torch.bwasw.pair",
           "bwamem_tpu_torch.ops.gather_probe3",
           "bwamem_tpu_torch.ops.dispatch_probe",
           "bwamem_tpu_torch.ops.pl_probe", "bwamem_tpu_torch.ops.launch"]


def _clean_env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = str(REPO)
    return env


def test_import_loads_no_jax():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'bwamem_tpu' or "
              "m.startswith('bwamem_tpu.'))\n"
              "print('BAD', bad)\n"
              "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=_clean_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|bwamem_tpu)\b"
                     r"(?!_torch)", re.M)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    + list((REPO / "tools").glob("torch_*.py"))
    + [REPO / "tools" / "se_smoke_data.py"]))
def test_sources_import_neither(path):
    text = (REPO / path).read_text()
    hits = [m.group(0).strip() for m in _IMPORT.finditer(text)]
    assert not hits, f"{path}: {hits}"


def test_entry_points_need_a_gpu_unless_asked(monkeypatch, tmp_path):
    from bwamem_tpu_torch import cli
    from bwamem_tpu_torch.pipeline.align import Aligner, resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Aligner(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    from torch_port_util import make_dataset
    data = make_dataset(tmp_path, genome_len=5000, n_reads=4, kmer=False,
                        n_contigs=1)
    out = tmp_path / "out.sam"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["mem", "-o", str(out), data["prefix"], data["fq"]])
    assert not out.exists()
    for argv in (["fastmap", data["prefix"], data["fq"]],
                 ["maxk", data["prefix"], data["fq"]],
                 ["pemerge", data["fq"], data["fq"]]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
        assert cli.main(argv, device="cpu") == 0
    sai, sam = tmp_path / "r.sai", tmp_path / "r.sam"
    legacy = (["aln", "-f", str(sai), data["prefix"], data["fq"]],
              ["samse", "-f", str(sam), data["prefix"], str(sai),
               data["fq"]],
              ["sampe", "-f", str(sam), data["prefix"], str(sai), str(sai),
               data["fq"], data["fq"]])
    for argv in legacy:
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(argv)
    assert not sai.exists() and not sam.exists()
    for argv in legacy:
        assert cli.main(argv, device="cpu") == 0
        assert sam.exists() or argv[0] == "aln"
    sw = tmp_path / "sw.sam"
    argv = ["bwasw", "-f", str(sw), data["prefix"], data["fq"]]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    assert not sw.exists()
    assert cli.main(argv, device="cpu") == 0 and sw.exists()


def test_cli_refuses_paired_end(tmp_path, capsys):
    """Paired-end input is aligned now (tests/test_torch_align_pe_cli.py):
    what the CLI still refuses is a command line that is not `mem` with an
    index and one or two read files, and it no longer says that paired-end
    is not ported."""
    from bwamem_tpu_torch import cli
    assert cli.main(["mem", "x", "r1.fq", "r2.fq", "r3.fq"],
                    device="cpu") == 1
    assert cli.main(["mem", "-p", "x"], device="cpu") == 1
    err = capsys.readouterr().err
    assert "Usage" in err and "[in2.fq]" in err
    assert "not ported" not in err
    with pytest.raises(FileNotFoundError):      # goes on to load the index
        cli.main(["mem", str(tmp_path / "none"), "r1.fq", "r2.fq"],
                 device="cpu")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_clean_env() | {"CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _run_tool(tool):
    return subprocess.run([sys.executable, f"tools/{tool}"], cwd=REPO,
                          env=_clean_env() | {"CUDA_VISIBLE_DEVICES": ""},
                          capture_output=True, text=True, timeout=120)


def test_fm_probe_tool_fails_without_gpu():
    r = _run_tool("torch_fm_step_probe.py")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "us/step" not in r.stdout


def test_gather_probe_tool_fails_without_gpu():
    r = _run_tool("torch_pl_gather_probe.py")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "us/step" not in r.stdout


def test_gather_probe2_tool_fails_without_gpu():
    r = _run_tool("torch_pl_gather_probe2.py")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "us/step" not in r.stdout


def test_gather_probe3_tool_fails_without_gpu():
    r = _run_tool("torch_pl_gather_probe3.py")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "us/step" not in r.stdout


@pytest.mark.parametrize("tool", ["torch_dispatch_probe.py",
                                  "torch_pl_probe.py"])
def test_dispatch_and_row_probe_tools_fail_without_gpu(tool):
    r = _run_tool(tool)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "ms" not in r.stdout


@pytest.mark.parametrize("tool", ["torch_dispatch_probe.py",
                                  "torch_pl_probe.py"])
def test_dispatch_and_row_probe_tools_fail_outside_checkout(tmp_path, tool):
    shutil.copy(REPO / "tools" / tool, tmp_path / tool)
    r = subprocess.run([sys.executable, tool], cwd=tmp_path,
                       env={k: v for k, v in _clean_env().items()
                            if k != "PYTHONPATH"} | {"CUDA_VISIBLE_DEVICES":
                                                     ""},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "ms" not in r.stdout


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env={k: v for k, v in _clean_env().items()
                            if k != "PYTHONPATH"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
