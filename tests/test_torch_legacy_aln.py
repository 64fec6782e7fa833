"""`aln` of bwamem_tpu_torch against bwamem_tpu's on the CPU: the options
carried across (GapOptions through the packed gap_opt_t), the per-position
width scan against _width_scan_dev, one search round's occ pairs, and the
.sai bytes of `cli.main(["aln", ...])` under the defaults, -n as a rate
and as a count, -q (quality trimming), -l/-k (seeding), -N (non-stop),
-L (log gap penalty) and -e (gap extensions, GAPE off), on 101 bp reads
with substitutions and indels, reads with Ns (one with more than max_diff
of them), reads of 36-90 and 150 bp and reads with low-quality tails
(torch_port_util.legacy_dataset)."""
import numpy as np
import pytest
import torch

import bwamem_tpu.cli as jcli
import bwamem_tpu_torch.cli as tcli
import jax.numpy as jnp
from bwamem_tpu.index import load_index as jload
from bwamem_tpu.legacy import aln as jaln
from bwamem_tpu.ops import fm as jfm
from bwamem_tpu_torch.index import load_index as tload
from bwamem_tpu_torch.legacy import aln as taln
from bwamem_tpu_torch.ops import fm as tfm

from torch_port_util import (assert_same, jfm_arrays, legacy_dataset,
                             run_cli, torch_gap_opt)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return legacy_dataset(tmp_path_factory.mktemp("legacy_aln"), n_se=24)


@pytest.fixture(scope="module")
def fms(data):
    jf = jfm.to_device(jfm.fm_from_index(jload(data["prefix"])))
    tf = tfm.fm_from_arrays(jfm_arrays(jf), "cpu")
    return jf, tf


def test_gap_options_carry_across():
    """The packed gap_opt_t holds fnr as a float: both packages read the
    same float back."""
    for j in (jaln.GapOptions(), jaln.GapOptions(
            s_mm=4, max_diff=3, fnr=-1.0, mode=0x15, seed_len=25,
            max_top2=7, trim_qual=15)):
        t = torch_gap_opt(j)
        assert vars(t) == vars(jaln.GapOptions.unpack(j.pack()))
        assert t.pack() == j.pack()
    assert torch_gap_opt().pack() == taln.GapOptions().pack()


def test_width_scan_matches_reference(data, fms):
    from bwamem_tpu_torch.io.fastq import read_fastx
    jf, tf = fms
    opt = taln.GapOptions()
    reads = [taln.prep_read(r.seq, r.qual, opt)
             for r in read_fastx(data["se"])]
    L = 160
    seq = np.full((len(reads), L), 4, np.uint8)
    lens = np.zeros(len(reads), np.int32)
    for i, (sr, ln) in enumerate(reads):
        seq[i, :ln] = sr
        lens[i] = ln
    jw, jb = jaln._width_scan_dev(jf, jnp.asarray(seq), jnp.asarray(lens),
                                  L=L)
    tw, tb = taln._width_scan_dev(tf, torch.from_numpy(seq), L)
    assert_same(jw, tw, "w")
    assert_same(jb, tb, "bid")
    assert int(tb[:, -1].min()) > 0          # every row restarted


def test_occ_round_matches_reference(fms):
    """One round's (k-1, l) lanes, -1 and the primary included."""
    jf, tf = fms
    rng = np.random.default_rng(0)
    km1 = rng.integers(-1, tf.seq_len, 300)
    l = rng.integers(0, tf.seq_len + 1, 300)
    km1[:3] = (-1, tf.primary, tf.primary - 1)
    want = jaln.OccBatcher(jf).query(km1, l)
    got = taln.OccBatcher(tf).query(km1, l)
    for a, b in zip(want, got):
        assert_same(a, b, "occ")


@pytest.mark.parametrize("opts", [
    [], ["-n", "0.04"], ["-n", "3"], ["-q", "15"], ["-l", "32", "-k", "2"],
    ["-l", "20", "-k", "1"], ["-N"], ["-L"], ["-e", "2"]],
    ids=lambda o: " ".join(o) or "defaults")
def test_sai_bytes_match_reference(data, tmp_path, opts):
    outs = []
    for cli, kw in ((jcli, {}), (tcli, {"device": "cpu"})):
        sai = tmp_path / f"{cli.__name__.split('.')[0]}.sai"
        rc, out, err = run_cli(cli, ["aln", *opts, "-f", str(sai),
                                     data["prefix"], data["se"]], **kw)
        assert rc == 0 and out == "", err
        outs.append((sai.read_bytes(), err))
    assert outs[0][0] == outs[1][0]
    assert outs[0][1] == outs[1][1]                 # stderr too
    assert len(outs[1][0]) > 64 + 4 * 50            # hits were written
