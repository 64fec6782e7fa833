"""bwamem_tpu_torch.ops.fm against bwamem_tpu.ops.fm on the same index and
the same ranks, in both the i32 and the i64 row layout.  The port's FM is
built from the reference FM's arrays (fm_from_arrays), so both packages
hold the same index.  Exact equality."""
import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401
import jax.numpy as jnp

from bwamem_tpu.index.fmindex import BwaIndex
from bwamem_tpu.ops import fm as jfm_ops
from bwamem_tpu_torch.ops import fm as tfm_ops

from torch_port_util import T, assert_same, jfm_arrays, make_dataset


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("fm"), genome_len=20_000,
                        n_reads=8, kmer=False)


@pytest.fixture(params=["i32", "i64"])
def fms(request, data, monkeypatch):
    if request.param == "i64":
        # the 64-bit layout (genomes >= 2^31) on the small genome
        monkeypatch.setattr(BwaIndex, "itype",
                            property(lambda self: np.int64))
    jfm = jfm_ops.to_device(jfm_ops.fm_from_index(data["jidx"]))
    tfm = tfm_ops.fm_from_arrays(jfm_arrays(jfm), "cpu")
    assert tfm.i64 == (request.param == "i64")
    return jfm, tfm


def _ranks(jfm, n=4000, seed=0):
    rng = np.random.default_rng(seed)
    seq_len = int(jfm.seq_len)
    edge = np.array([-1, 0, 1, int(jfm.primary) - 1, int(jfm.primary),
                     int(jfm.primary) + 1, seq_len - 1, seq_len])
    r = np.concatenate([edge, rng.integers(-1, seq_len + 1, n)])
    return r.astype(np.asarray(jfm.L2).dtype)


def test_occ4_and_bwt(fms):
    jfm, tfm = fms
    k = _ranks(jfm)
    assert_same(jfm_ops.occ4(jfm, jnp.asarray(k)),
                tfm_ops.occ4(tfm, T(k)), "occ4")
    kk = np.clip(k, 0, int(jfm.seq_len) - 1)
    assert_same(jfm_ops.inv_psi(jfm, jnp.asarray(kk)),
                tfm_ops.inv_psi(tfm, T(kk)), "inv_psi")
    x = np.clip(k, 0, int(jfm.seq_len) - 2)
    assert_same(jfm_ops.bwt_b0(jfm, jnp.asarray(x)),
                tfm_ops.bwt_b0(tfm, T(x)), "bwt_b0")


@pytest.mark.parametrize("is_back", [False, True])
def test_extend_and_set_intv(fms, is_back):
    jfm, tfm = fms
    rng = np.random.default_rng(1)
    c = rng.integers(0, 4, 2000)
    x0, x1, x2 = jfm_ops.set_intv(jfm, jnp.asarray(c))
    t0, t1, t2 = tfm_ops.set_intv(tfm, T(c))
    for a, b, nm in ((x0, t0, "x0"), (x1, t1, "x1"), (x2, t2, "x2")):
        assert_same(a, b, f"set_intv.{nm}")
    # walk a few extension steps so the intervals shrink realistically
    for step in range(6):
        base = rng.integers(0, 4, 2000)
        jn = jfm_ops.extend(jfm, x0, x1, x2, is_back=is_back)
        tn = tfm_ops.extend(tfm, t0, t1, t2, is_back=is_back)
        for a, b, nm in zip(jn, tn, ("n0", "n1", "ns")):
            assert_same(a, b, f"extend step {step} {nm}")
        sel = base if is_back else 3 - base
        x0, x1, x2 = (jnp.take_along_axis(a, jnp.asarray(sel)[:, None],
                                          axis=1)[:, 0] for a in jn)
        t0, t1, t2 = (torch.gather(a, 1, T(sel)[:, None])[:, 0]
                      for a in tn)


def test_sa_lookup_and_rid(fms, data):
    jfm, tfm = fms
    rng = np.random.default_rng(2)
    seq_len = int(jfm.seq_len)
    k = rng.integers(0, seq_len + 1, 3000).astype(np.asarray(jfm.L2).dtype)
    ja = jfm_ops.sa_lookup(jfm, jnp.asarray(k))
    ta = tfm_ops.sa_lookup(tfm, T(k))
    assert_same(ja, ta, "sa_lookup")
    idx = data["jidx"]
    it = np.asarray(jfm.L2).dtype
    off = idx.contig_offsets().astype(it)
    rb = np.asarray(ja)
    ln = rng.integers(1, 200, rb.shape[0]).astype(it)
    assert_same(jfm_ops.intv2rid(jfm, jnp.asarray(off), jnp.asarray(rb),
                                 jnp.asarray(rb + ln)),
                tfm_ops.intv2rid(tfm, T(off), T(rb), T(rb + ln)), "intv2rid")
    pos = rng.integers(0, 2 * int(jfm.l_pac), 3000).astype(it)
    assert_same(jfm_ops.ref_base(jfm, jnp.asarray(pos)),
                tfm_ops.ref_base(tfm, T(pos)), "ref_base")
