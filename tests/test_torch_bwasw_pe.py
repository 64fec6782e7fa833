"""`bwasw` of bwamem_tpu_torch on paired long reads, against bwamem_tpu's,
byte for byte, through both CLIs on the CPU: 16 pairs of 300 bp (insert
700 +- 60) on a 200 kbp genome (the shape of tests/test_bwasw.py, held to
the JAX package instead of the C oracle): insert-size inference, the mate
SWs batched by stripe width (300 bases is no multiple of 16) and the
pairing decisions, which must mark proper pairs."""
import bwamem_tpu.cli as jcli
import bwamem_tpu_torch.cli as tcli

from torch_port_util import bwasw_dataset, run_cli


def test_bwasw_pe_gives_the_reference_bytes(tmp_path):
    data = bwasw_dataset(tmp_path / "data", n_pairs=16)
    res = {}
    for tag, cli, kw in (("j", jcli, {}), ("t", tcli, {"device": "cpu"})):
        sam = str(tmp_path / f"{tag}.sam")
        rc, out, err = run_cli(cli, ["bwasw", "-f", sam, "-t1",
                                     data["prefix"], data["fq1"],
                                     data["fq2"]], **kw)
        assert rc == 0 and out == "", err
        with open(sam) as f:
            res[tag] = f.read()
    assert res["t"] == res["j"]
    sam = res["t"]
    # the JAX package's messages go to the stderr of its first import (a
    # default argument), so only the port's are read here; their text is
    # held in test_torch_bwasw_parts.py::test_insert_size_inference
    assert "[bsw2_stat] mean and std.dev" in err
    flags = [int(line.split("\t")[1]) for line in sam.splitlines()
             if not line.startswith("@")]
    assert len(flags) >= 32 and all(f & 1 for f in flags)
    assert any(f & 0x2 for f in flags), "no proper pair: pairing untested"
