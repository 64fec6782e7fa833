"""`mem` through the CLI of bwamem_tpu_torch on the CPU at option sets no
other test pins, SAM bytes (header included) against bwamem_tpu's CLI:
paired-end -S -P (no mate rescue, no pairing), single-end scoring (-A 2
-B 5 -O 7 -E 2 -L 3), seeding and output thresholds (-k 15 -c 50 -T 20)
and the -x pacbio preset.  64 reads of 101 bp and 32 pairs of 101 bp on a
60 kbp genome."""
import pytest

import bwamem_tpu  # noqa: F401

from bwamem_tpu import cli as jcli
from bwamem_tpu_torch import cli as tcli

from torch_port_util import make_dataset

N_READS, N_PAIRS = 64, 32
OPTION_SETS = {
    "pe_-S_-P": (["-S", "-P"], True),
    "se_scoring": (["-A", "2", "-B", "5", "-O", "7", "-E", "2", "-L", "3"],
                   False),
    "se_-k15_-c50_-T20": (["-k", "15", "-c", "50", "-T", "20"], False),
    "se_-x_pacbio": (["-x", "pacbio"], False),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("cliopts"),
                        genome_len=60_000, n_reads=N_READS, seed=91,
                        n_pairs=N_PAIRS, pe_read_len=101)


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_cli_mem_options(data, tmp_path, monkeypatch, capsys, name):
    monkeypatch.setenv("BWAMEM_TPU_DEVICES", "1")     # reference: one chip
    opts, pe = OPTION_SETS[name]
    reads = [data["fq1"], data["fq2"]] if pe else [data["fq"]]
    # the @PG line echoes the command line: same relative output path
    args = ["mem", "-o", "out.sam", *opts, data["prefix"], *reads]
    for sub, run in (("j", lambda: jcli.main(args)),
                     ("t", lambda: tcli.main(args, device="cpu"))):
        (tmp_path / sub).mkdir()
        monkeypatch.chdir(tmp_path / sub)
        assert run() == 0
        capsys.readouterr()
    want = (tmp_path / "j" / "out.sam").read_text()
    got = (tmp_path / "t" / "out.sam").read_text()
    assert "@PG\t" in got
    assert want == got
    body = [l for l in got.splitlines() if not l.startswith("@")]
    n = 2 * N_PAIRS if pe else N_READS
    assert len({l.split("\t", 1)[0] for l in body}) == (N_PAIRS if pe
                                                        else n)
    assert sum(1 for l in body if not int(l.split("\t")[1]) & 4) > n // 2
