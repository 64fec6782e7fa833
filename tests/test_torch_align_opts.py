"""Single-end `mem` of bwamem_tpu_torch at option sets no other test pins,
through both CLIs on the CPU, byte for byte against bwamem_tpu's: -M, -Y,
-a, -C, -5 with -q, -u, and -a -M -Y together.  None of them changes a
device program's shape, so the JAX side compiles once for the file.  The
reads are 96 of 101 bp from a genome with planted repeats (secondary
hits for -a and -M), 8 chimeras joined from two places of the genome
(supplementary lines for -Y, -5 and -q) and a FASTQ comment on every
fourth read (-C).  -x ont2d and an ALT contig need programs and an index
of their own and are not held here."""
import numpy as np
import pytest

import bwamem_tpu  # noqa: F401
from bwamem_tpu import cli as jcli
from bwamem_tpu_torch import cli as tcli

from torch_port_util import make_dataset

import simdata  # noqa: E402  (tools/, put on the path by torch_port_util)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("opts")
    out = make_dataset(d, n_reads=96, kmer=True, seed=17)
    contigs = simdata.make_genome(50_000, seed=17, n_contigs=2)
    seqs = list(contigs.values())
    rng = np.random.default_rng(17)
    with open(out["fq"]) as f:
        lines = f.read().splitlines()
    recs = [lines[i:i + 4] for i in range(0, len(lines), 4)]
    for r in recs[::4]:
        r[0] += " BC:Z:ACGTAC"
    for c in range(8):
        a, b = (int(x) for x in rng.integers(0, 20_000, 2))
        s = seqs[0][a:a + 60] + simdata.revcomp(seqs[1][b:b + 50])
        recs.append([f"@chim{c}", s, "+", "I" * len(s)])
    with open(out["fq"], "w") as f:
        f.write("".join(f"{x}\n" for r in recs for x in r))
    return out


@pytest.mark.parametrize("opts", [["-M"], ["-Y"], ["-a"], ["-C"],
                                  ["-5", "-q"], ["-u"], ["-a", "-M", "-Y"]],
                         ids=lambda o: "".join(o))
def test_cli_mem_options(data, opts, tmp_path, monkeypatch):
    monkeypatch.setenv("BWAMEM_TPU_DEVICES", "1")     # reference: one chip
    # the @PG line echoes the command line: same relative output path
    args = ["mem", *opts, "-o", "out.sam", data["prefix"], data["fq"]]
    for sub, run in (("j", lambda: jcli.main(args)),
                     ("t", lambda: tcli.main(args, device="cpu"))):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert run() == 0
    want = (tmp_path / "j" / "out.sam").read_text()
    got = (tmp_path / "t" / "out.sam").read_text()
    assert got == want
    recs = [x.split("\t") for x in got.splitlines() if x[0] != "@"]
    flags = [int(r[1]) for r in recs]
    assert any(f & 0x800 or (f & 0x100) for f in flags), \
        "no secondary or supplementary line: the options are untested"
    if "-C" in opts:
        assert any(r[-1] == "BC:Z:ACGTAC" for r in recs)
