"""The index tools of bwamem_tpu_torch's CLI against bwamem_tpu's, byte for
byte: `index` (the reference-format files; the .bt.npz by arrays), each
micro-command's output file (fa2pac with and without -f, pac2bwt,
pac2bwtgen, bwtupdate, bwt2sa with the default and another -i), their
usage messages and exit codes, and `shm`: the blob, staging, listing,
loading and dropping in a temporary directory, a blob staged by either
package loaded by the other, and load_index taking the staged copy.  The
genome is a tools/simdata.py one with a run of Ns, so the .amb holes and
the seeded N replacement are covered.  The legacy commands `aln`, `samse`
and `sampe` run on that index too, from the CLI, and give the reference's
bytes.  `bwasw`'s usage message, exit codes and flag errors match here;
its alignments are held in tests/test_torch_bwasw_*.py."""
import filecmp

import numpy as np
import pytest

import bwamem_tpu.cli as jcli
import bwamem_tpu_torch.cli as tcli
from bwamem_tpu.index import shm as jshm
from bwamem_tpu_torch.index import shm as tshm

from torch_port_util import run_cli as run  # (puts tools/ on the path)
import simdata  # noqa: E402

REF_EXTS = ("pac", "ann", "amb", "bwt", "sa")


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_index")
    contigs = simdata.make_genome(24_000, seed=5, n_contigs=3)
    name = next(iter(contigs))
    s = contigs[name]
    contigs[name] = s[:500] + "N" * 30 + s[530:900] + "NNRN" + s[904:]
    fa = str(d / "g.fa")
    simdata.write_fasta(contigs, fa)
    return d, fa


@pytest.fixture(scope="module")
def built(genome):
    """Both packages' `index`, then the micro-command chain, into one
    directory (prefix j* for bwamem_tpu, t* for the port)."""
    d, fa = genome
    for pkg, cli in (("j", jcli), ("t", tcli)):
        steps = [["index", fa, f"{d}/{pkg}"],
                 ["fa2pac", fa, f"{d}/{pkg}m"],
                 ["fa2pac", "-f", fa, f"{d}/{pkg}f"],
                 ["pac2bwt", f"{d}/{pkg}m.pac", f"{d}/{pkg}m.bwt"],
                 ["pac2bwtgen", "-b", "1000", f"{d}/{pkg}m.pac",
                  f"{d}/{pkg}g.bwt"],
                 ["bwtupdate", f"{d}/{pkg}m.bwt"],
                 ["bwt2sa", f"{d}/{pkg}m.bwt", f"{d}/{pkg}m.sa"],
                 ["bwt2sa", "-i", "16", f"{d}/{pkg}m.bwt",
                  f"{d}/{pkg}m16.sa"]]
        for argv in steps:
            rc, out, err = run(cli, argv)
            assert (rc, out, err) == (0, "", ""), (pkg, argv, err)
    return d


@pytest.mark.parametrize("ext", REF_EXTS)
def test_index_reference_files_identical(built, ext):
    assert filecmp.cmp(built / f"j.{ext}", built / f"t.{ext}",
                       shallow=False)


def test_index_npz_arrays_identical(built):
    a = np.load(built / "j.bt.npz")
    b = np.load(built / "t.bt.npz")
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        assert a[f].dtype == b[f].dtype, f
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("name", ["m.pac", "m.ann", "m.amb", "f.pac",
                                  "f.ann", "f.amb", "g.bwt", "m.bwt",
                                  "m.sa", "m16.sa"])
def test_micro_command_outputs_identical(built, name):
    assert filecmp.cmp(built / f"j{name}", built / f"t{name}", shallow=False)


def test_micro_command_chain_rebuilds_the_index(built):
    """pac2bwt + bwtupdate + bwt2sa give `index`'s .bwt and .sa."""
    for ext in ("bwt", "sa"):
        assert filecmp.cmp(built / f"tm.{ext}", built / f"t.{ext}",
                           shallow=False)


@pytest.mark.parametrize("argv", [
    [], ["index"], ["fa2pac"], ["fa2pac", "-f"], ["pac2bwt", "x.pac"],
    ["pac2bwtgen", "-d", "x.pac"], ["bwtupdate"], ["bwtupdate", "a", "b"],
    ["bwt2sa", "-i", "16", "x.bwt"], ["shm"], ["fastmap", "x"],
    ["maxk", "-s", "x"], ["pemerge"], ["nosuch"], ["aln"], ["aln", "x"],
    ["aln", "-b", "x", "y"], ["aln", "-I", "x", "y"], ["samse", "x", "y"],
    ["sampe", "x", "y", "z"], ["bwasw"], ["bwasw", "x"],
    ["bwasw", "-Q", "x", "y"]])
def test_usage_messages_and_exit_codes_match(argv):
    assert run(tcli, argv, device="cpu") == run(jcli, argv)


@pytest.fixture(scope="module")
def legacy(built, genome):
    """40 pairs of 101 bp from the indexed genome (insert 300 +- 30) and
    the reference's .sai of each mate file."""
    d, fa = genome
    contigs, name = {}, None
    with open(fa) as f:
        for line in f:
            if line.startswith(">"):
                name = line[1:].strip()
                contigs[name] = []
            else:
                contigs[name].append(line.strip())
    contigs = {n: "".join(v) for n, v in contigs.items()}
    pairs = simdata.sim_reads(contigs, 80, read_len=101, seed=11,
                              sub_rate=0.01, indel_rate=0.002, paired=True,
                              insert_mean=300, insert_std=30)
    files = {}
    for e in (1, 2):
        files[e] = str(d / f"l{e}.fq")
        simdata.write_fastq([(f"{n}/{e}", s, q)
                             for n, s, q in pairs[e - 1::2]], files[e])
        files[f"sai{e}"] = str(d / f"l{e}.sai")
        assert run(jcli, ["aln", "-f", files[f"sai{e}"], str(built / "j"),
                          files[e]])[0] == 0
    return files


@pytest.mark.parametrize("cmd", ["aln", "samse", "sampe"])
def test_legacy_commands_give_the_reference_bytes(built, legacy, cmd,
                                                  tmp_path):
    """Each package on its own index (the files are identical)."""
    outs = []
    for pkg, cli, kw in (("j", jcli, {}), ("t", tcli, {"device": "cpu"})):
        prefix = str(built / pkg)
        out = str(tmp_path / f"{pkg}.out")
        argv = {"aln": ["aln", "-f", out, prefix, legacy[1]],
                "samse": ["samse", "-f", out, prefix, legacy["sai1"],
                          legacy[1]],
                "sampe": ["sampe", "-f", out, prefix, legacy["sai1"],
                          legacy["sai2"], legacy[1], legacy[2]]}[cmd]
        rc, so, err = run(cli, argv, **kw)
        assert rc == 0 and so == "", err
        with open(out, "rb") as f:
            outs.append((f.read(), err))
    assert outs[0] == outs[1]
    if cmd == "sampe":
        assert outs[1][0].count(b"\tXT:A:U") > 50


# ---- shm ----

@pytest.fixture()
def shm_dir(tmp_path, monkeypatch):
    d = tmp_path / "shm"
    monkeypatch.setattr(jshm, "SHM_DIR", str(d))
    monkeypatch.setattr(tshm, "SHM_DIR", str(d))
    return d


def _assert_same_index(a, b):
    for f in ("l_pac", "seq_len", "primary", "sa_intv"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("L2", "bwt_words", "occ", "sa_samples", "pac"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert [vars(c) for c in a.contigs] == [vars(c) for c in b.contigs]
    assert [vars(x) for x in a.ambs] == [vars(x) for x in b.ambs]
    assert (a.kmer_table is None) == (b.kmer_table is None)
    for x, y in zip(a.kmer_table or (), b.kmer_table or ()):
        np.testing.assert_array_equal(x, y)


def test_shm_blob_identical(built):
    from bwamem_tpu.index import BwaIndex as JIdx
    from bwamem_tpu_torch.index import BwaIndex as TIdx
    jb = jshm.pack_bytes(JIdx.load(str(built / "j")))
    tb = tshm.pack_bytes(TIdx.load(str(built / "t")))
    assert jb == tb
    _assert_same_index(tshm.unpack(tb), TIdx.load(str(built / "t")))
    with pytest.raises(ValueError):
        tshm.unpack(b"NOTASHM!" + tb[8:])


def test_shm_stage_list_load_destroy(built, shm_dir):
    from bwamem_tpu_torch.index import BwaIndex, load_index
    prefix = str(built / "t")
    assert not tshm.test(prefix) and tshm.load_staged(prefix) is None
    assert tshm.list_staged() == [] and tshm.destroy() == 0
    rcs = [run(cli, ["shm", prefix]) for cli in (tcli, jcli)]
    assert rcs[0][0] == 0 and "staged" in rcs[0][2]
    assert rcs[1] == (0, "", f"[M::shm] index '{prefix}' is already in "
                             "shared memory\n")
    assert tshm.test(prefix)
    staged = tshm.load_staged(prefix)
    assert staged.bwt_words.base is not None      # a view of the mapping
    _assert_same_index(staged, BwaIndex.load(prefix))
    # load_index takes the staged copy: it loads with the files gone
    want = BwaIndex.load(prefix)
    moved = [built / f"t.{e}" for e in ("bt.npz",) + REF_EXTS]
    for f in moved:
        f.rename(f.with_name(f.name + ".away"))
    try:
        _assert_same_index(load_index(prefix), want)
    finally:
        for f in moved:
            f.with_name(f.name + ".away").rename(f)
    assert run(tcli, ["shm", "-l"]) == run(jcli, ["shm", "-l"]) == \
        (0, prefix + "\n", "")
    assert run(tcli, ["shm", "-d", prefix]) == \
        (0, "", "[M::shm] dropped 1 staged index(es)\n")
    assert not tshm.test(prefix)
    assert run(tcli, ["shm", "-d"]) == run(jcli, ["shm", "-d"])


@pytest.mark.parametrize("stager", ["j", "t"])
def test_shm_blob_staged_by_one_package_loads_in_the_other(
        built, shm_dir, stager):
    from bwamem_tpu.index import load_index as jload
    from bwamem_tpu_torch.index import load_index as tload
    prefix = str(built / stager)
    (jshm if stager == "j" else tshm).stage(prefix)
    other = tshm if stager == "j" else jshm
    assert other.test(prefix)
    path = shm_dir / next(p.name for p in shm_dir.iterdir())
    assert path.read_bytes() == other.pack_bytes(
        (jload if stager == "j" else tload)(prefix))
    _assert_same_index(jload(prefix), tload(prefix))
    assert other.destroy(prefix) == 1
