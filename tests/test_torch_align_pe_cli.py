"""Paired-end `mem` through the CLI of bwamem_tpu_torch on the CPU, SAM
bytes (header included) against bwamem_tpu's: two FASTQs, -p on an
interleaved file, -p with a second file (warned about and ignored), and
-I.  40 pairs of 101 bp in two -K chunks of whole pairs."""
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu import cli as jcli
from bwamem_tpu_torch import cli as tcli

from torch_port_util import make_dataset

N_PAIRS = 40


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = make_dataset(tmp_path_factory.mktemp("pecli"), genome_len=60_000,
                     n_reads=4, seed=77, n_pairs=N_PAIRS, pe_read_len=101)
    il = str(tmp_path_factory.mktemp("il") / "il.fq")
    with open(il, "w") as f:
        for r1, r2 in zip(*(open(d[k]).read().split("@")[1:]
                            for k in ("fq1", "fq2"))):
            f.write("@" + r1 + "@" + r2)
    return dict(d, il=il)


@pytest.mark.parametrize("mode", ["two_files", "-p", "-p_and_second_file",
                                  "-I"])
def test_cli_mem_pe(data, tmp_path, monkeypatch, capsys, mode):
    monkeypatch.setenv("BWAMEM_TPU_DEVICES", "1")     # reference: one chip
    d = data
    # the @PG line echoes the command line: same relative output path;
    # -K 5000 ends the first chunk after 50 reads (25 whole pairs)
    args = ["mem", "-o", "out.sam", "-K", "5000"]
    if mode == "two_files":
        args += [d["prefix"], d["fq1"], d["fq2"]]
    elif mode == "-I":
        args += ["-I", "400,40", d["prefix"], d["fq1"], d["fq2"]]
    elif mode == "-p":
        args += ["-p", d["prefix"], d["il"]]
    else:
        args += ["-p", d["prefix"], d["il"], d["fq2"]]
    for sub, run in (("j", lambda: jcli.main(args)),
                     ("t", lambda: tcli.main(args, device="cpu"))):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert run() == 0
        err = capsys.readouterr().err
        assert ("second query file is ignored" in err) == \
            (mode == "-p_and_second_file")
        assert "processed 50 reads" in err and "processed 80 reads" in err
        assert "not ported" not in err
    want = (tmp_path / "j" / "out.sam").read_text()
    got = (tmp_path / "t" / "out.sam").read_text()
    assert got.startswith("@SQ\t") and "@PG\t" in got
    assert want == got
    body = [l for l in got.splitlines() if not l.startswith("@")]
    assert len(body) >= 2 * N_PAIRS
    flags = [int(l.split("\t")[1]) for l in body]
    assert all(f & 1 for f in flags)
    assert sum(1 for f in flags if f & 2) > N_PAIRS
