"""`bwasw` of bwamem_tpu_torch on single-end long reads, against
bwamem_tpu's, byte for byte, through both CLIs on the CPU: 24 reads of
500 bp on a 200 kbp genome (the shape of tests/test_bwasw.py, held to the
JAX package instead of the C oracle), at the default options and with -H
-M (hard clips, secondary flags).  The whole path runs: the prefix-DAG
traversal, the chain filter, the left extensions one dispatch a hit and
the right ones one a strand, the SA walks, the CIGARs of the chunk in one
global-SW batch, and the SAM."""
import pytest

import bwamem_tpu.cli as jcli
import bwamem_tpu_torch.cli as tcli

from torch_port_util import bwasw_dataset, run_cli

N_READS = 24


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return bwasw_dataset(tmp_path_factory.mktemp("bwasw_se"), n_se=N_READS)


@pytest.mark.parametrize("opts", [[], ["-H", "-M"]], ids=["default", "H_M"])
def test_bwasw_se_gives_the_reference_bytes(data, opts, tmp_path):
    sams = {}
    for tag, cli, kw in (("j", jcli, {}), ("t", tcli, {"device": "cpu"})):
        sams[tag] = str(tmp_path / f"{tag}.sam")
        rc, out, err = run_cli(cli, ["bwasw", "-f", sams[tag], "-t1", *opts,
                                     data["prefix"], data["fq"]], **kw)
        assert rc == 0 and out == "", err
    # the JAX package's messages go to the stderr of its first import
    # (a default argument), so only the port's are read here
    assert err.startswith(f"[bsw2_aln] read {N_READS} sequences/pairs")
    with open(sams["j"]) as f, open(sams["t"]) as g:
        want, got = f.read(), g.read()
    assert got == want
    recs = [line.split("\t") for line in got.splitlines()
            if not line.startswith("@")]
    assert {r[0].split("_")[0] for r in recs} == {f"rd{i}"
                                                  for i in range(N_READS)}
    mapped = {r[0] for r in recs if not int(r[1]) & 4}
    assert len(mapped) >= N_READS - 2
    if "-H" in opts:
        assert any("H" in r[5] for r in recs)
