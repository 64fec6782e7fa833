"""`samse` and `sampe` of bwamem_tpu_torch against bwamem_tpu's on the
CPU: the SAM bytes (and stderr) of `cli.main(["samse" | "sampe", ...],
device="cpu")` from the same .sai files, under samse's defaults, -n 10 (XA
multi-hits) and -r (a read group), and sampe's defaults, -s (no mate
rescue), -A (no insert-size estimate), -a 600, -n/-N (multi-hit limits)
and -o (the occurrence cap of pairing).  The pairs carry mate-rescue bait
(second mates with 10 substitutions, which aln cannot place), so the
default sampe must rescue some of them on the mate SW; the single-end
reads carry indels (gapped hits through the global SW), Ns, mixed lengths
and low-quality tails trimmed by aln -q 15."""
from pathlib import Path

import pytest

import bwamem_tpu.cli as jcli
import bwamem_tpu_torch.cli as tcli
from bwamem_tpu.legacy import sampe as jsampe

from torch_port_util import legacy_dataset, run_cli, torch_pe_opt


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The dataset and the reference's .sai files: se.sai (aln -q 15 on
    the single-end reads), r1.sai and r2.sai (the mates, defaults)."""
    d = legacy_dataset(tmp_path_factory.mktemp("legacy_sam"), n_se=40,
                       n_pairs=48, n_bait=12)
    base = d["prefix"][:-1]
    for name, fq, opts in (("se", d["se"], ["-q", "15"]),
                           ("r1", d["r1"], []), ("r2", d["r2"], [])):
        d[f"{name}.sai"] = f"{base}{name}.sai"
        rc, _, err = run_cli(jcli, ["aln", *opts, "-f", d[f"{name}.sai"],
                                    d["prefix"], fq])
        assert rc == 0, err
    return d


def _same(argv):
    want = run_cli(jcli, argv)
    got = run_cli(tcli, argv, device="cpu")
    assert want[0] == 0, want[2]
    assert got == want
    return got[1]


def test_pe_options_carry_across():
    j = jsampe.PeOptions()
    j.max_isize, j.force_isize, j.n_multi, j.ap_prior = 600, 1, 5, 1e-4
    assert vars(torch_pe_opt(j)) == vars(j)
    assert vars(torch_pe_opt()) == vars(jsampe.PeOptions())


@pytest.mark.parametrize("opts", [[], ["-n", "10"],
                                  ["-r", r"@RG\tID:grp1\tSM:s1"]],
                         ids=["defaults", "-n 10", "-r"])
def test_samse_sam_matches_reference(data, opts):
    sam = _same(["samse", *opts, data["prefix"], data["se.sai"],
                 data["se"]])
    lines = [x for x in sam.splitlines() if not x.startswith("@")]
    assert len(lines) == 44
    assert any("\tXC:i:" in x for x in lines)          # trimmed reads
    assert any("I" in x.split("\t")[5] or "D" in x.split("\t")[5]
               for x in lines)                          # gapped hits
    if opts:
        assert ("\tXA:Z:" in sam) if opts[0] == "-n" else \
            ("\tRG:Z:grp1" in sam)


@pytest.mark.parametrize("opts", [[], ["-s"], ["-A"], ["-a", "600"],
                                  ["-n", "1", "-N", "2"], ["-o", "2"]],
                         ids=lambda o: " ".join(o) or "defaults")
def test_sampe_sam_matches_reference(data, opts):
    sam = _same(["sampe", *opts, data["prefix"], data["r1.sai"],
                 data["r2.sai"], data["r1"], data["r2"]])
    lines = [x for x in sam.splitlines() if not x.startswith("@")]
    assert len(lines) == 2 * (48 + 12)
    rescued = sum("\tXT:A:M" in x for x in lines)
    if opts in ([], ["-a", "600"]):
        assert rescued > 0             # the bait went through the mate SW
    if opts == ["-s"]:
        assert rescued == 0


def test_read_sai_checks_the_magic_and_reads_every_record(data, tmp_path):
    from bwamem_tpu.legacy import samse as jse
    from bwamem_tpu_torch.legacy import samse as tse
    jopt, jrecs = jse.read_sai(data["r1.sai"])
    topt, trecs = tse.read_sai(data["r1.sai"])
    assert vars(jopt) == vars(topt)
    assert list(jrecs) == list(trecs)
    bad = tmp_path / "bad.sai"
    bad.write_bytes(b"BAM\1" + Path(data["r1.sai"]).read_bytes()[4:])
    with pytest.raises(ValueError, match="SAI magic"):
        tse.read_sai(str(bad))
