"""The chained FM-row gather probe of bwamem_tpu_torch (ops/fm_probe) on the
CPU: chain_gather against the chained-gather body of the reference's
tools/fm_step_probe.py restated with jax.numpy on the reference package's
own cmb table (both row layouts), and both lane loops of
csrc/fm_probe_kernel.cu, compiled for the host, against chain_gather.
Exact equality everywhere; the inputs include lanes whose k + acc wraps to
a negative int32, where C's % and Python's differ."""
import ctypes

import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401
import jax
import jax.numpy as jnp

from bwamem_tpu.ops import fm as jfm
from bwamem_tpu_torch._build import shared_lib
from bwamem_tpu_torch.ops import fm as tfm
from bwamem_tpu_torch.ops import fm_probe

from torch_port_util import T, assert_same, jfm_arrays, make_dataset

STEPS = 24


def j_chain(cmb, k0, steps, seq_len):
    """tools/fm_step_probe.py:87-94 (chain_gather), restated.  The one
    change: the row sum names its dtype.  The package turns x64 on, and
    then jnp.sum of int32 accumulates in int64, so the script's XLA chain
    does not wrap where its Pallas kernel (:120-132, int32 accumulator)
    does; the port computes the kernel's function."""
    def body(i, kk):
        row = cmb[(kk >> 7).astype(jnp.int32)]
        s = row.astype(jnp.int32).sum(-1, dtype=jnp.int32)
        return ((kk + s) % seq_len).astype(jnp.int32)

    return jax.lax.fori_loop(0, steps, body, k0)


def j_chain_words(cmb, k0, steps, seq_len):
    """The body of the Pallas `kernel` (tools/fm_step_probe.py:120-132),
    restated outside pallas_call: one take per word column into an int32
    accumulator."""
    W = cmb.shape[1]

    def body(i, kk):
        blk = kk >> 7
        acc = jnp.zeros_like(kk)
        for w in range(W):
            col = jnp.take(cmb[:, w], blk.reshape(-1),
                           axis=0).reshape(kk.shape)
            acc = acc + col.astype(jnp.int32)
        return ((kk + acc) % seq_len).astype(jnp.int32)

    return jax.lax.fori_loop(0, steps, body, k0.astype(jnp.int32))


def _wraps_negative(cmb_u32, k0, steps, seq_len):
    """Lanes whose k + acc goes negative at some step (numpy int64)."""
    c = cmb_u32.astype(np.uint32).view(np.int32).astype(np.int64)
    k = k0.astype(np.int64)
    hit = np.zeros(k.shape, bool)
    for _ in range(steps):
        acc = c[k >> 7].sum(-1)
        acc = ((acc + 2**31) % 2**32) - 2**31
        v = ((k + acc + 2**31) % 2**32) - 2**31
        hit |= v < 0
        k = v % seq_len
    return hit


@pytest.fixture(scope="module")
def index_fm(tmp_path_factory):
    data = make_dataset(tmp_path_factory.mktemp("fmp"), genome_len=40_000,
                        n_reads=4, kmer=False, seed=5)
    arrays = jfm_arrays(jfm.fm_from_index(data["jidx"]))
    return arrays, tfm.fm_from_arrays(arrays, "cpu")


def _synthetic(W, nb=300, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, (nb, W), dtype=np.uint64).astype(
        np.uint32), nb * 128 - 37


def test_words32_keeps_the_bits(index_fm):
    arrays, fm = index_fm
    w = fm_probe.words32(fm.cmb)
    assert w.dtype == torch.int32 and w.is_contiguous()
    assert_same(w.numpy().view(np.uint32), arrays["cmb"], "cmb bits")
    assert fm_probe.words32(w) is w or torch.equal(fm_probe.words32(w), w)


def test_chain_gather_matches_reference_body_on_the_index(index_fm):
    arrays, fm = index_fm
    seq_len = int(arrays["seq_len"])
    rng = np.random.default_rng(0)
    k0 = rng.integers(0, seq_len, 256).astype(np.int32)
    assert _wraps_negative(arrays["cmb"], k0, STEPS, seq_len).any()
    want = j_chain(jnp.asarray(arrays["cmb"]), jnp.asarray(k0), STEPS,
                   seq_len)
    assert want.dtype == jnp.int32
    got = fm_probe.chain_gather(fm_probe.words32(fm.cmb), T(k0), STEPS,
                                seq_len)
    assert got.dtype == torch.int32
    assert_same(want, got, "chain_gather")
    assert_same(j_chain_words(jnp.asarray(arrays["cmb"]), jnp.asarray(k0),
                              STEPS, seq_len), got, "kernel body")
    assert (got >= 0).all() and (got < seq_len).all()


@pytest.mark.parametrize("W", [12, 16])
def test_chain_gather_matches_reference_body_random_rows(W):
    cmb, seq_len = _synthetic(W)
    k0 = np.random.default_rng(2).integers(0, seq_len, 128).astype(np.int32)
    assert _wraps_negative(cmb, k0, STEPS, seq_len).sum() > 32
    want = j_chain(jnp.asarray(cmb), jnp.asarray(k0), STEPS, seq_len)
    got = fm_probe.chain_gather(T(cmb.view(np.int32)), T(k0), STEPS, seq_len)
    assert_same(want, got, f"chain_gather W={W}")
    assert_same(j_chain_words(jnp.asarray(cmb), jnp.asarray(k0), STEPS,
                              seq_len), got, f"kernel body W={W}")


def _host(entry, cmb_i32, k0, steps, seq_len):
    """csrc/fm_probe_kernel.cu's lane loops built as host C++ (the card
    runs the same code per thread)."""
    lib = ctypes.CDLL(shared_lib(
        fm_probe.SRC, "libfm_probe_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    fn = getattr(lib, entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    cmb_i32 = np.ascontiguousarray(cmb_i32, np.int32)
    if cmb_i32.ctypes.data % 16:       # rows are read 16 bytes at a time
        buf = np.empty(cmb_i32.size + 4, np.int32)
        off = (-buf.ctypes.data % 16) // 4
        al = buf[off:off + cmb_i32.size].reshape(cmb_i32.shape)
        al[...] = cmb_i32
        cmb_i32 = al
    k0 = np.ascontiguousarray(k0, np.int32)
    out = np.zeros_like(k0)
    assert fn(cmb_i32.ctypes.data, k0.ctypes.data, out.ctypes.data,
              k0.size, cmb_i32.shape[1], steps, seq_len) == 0
    return out


@pytest.mark.parametrize("entry", ["fm_chain_words_host",
                                   "fm_chain_rows_host"])
@pytest.mark.parametrize("W", [12, 16])
def test_kernel_source_lane_loop_matches_plain(entry, W):
    cmb, seq_len = _synthetic(W, seed=3 + W)
    k0 = np.random.default_rng(4).integers(0, seq_len, 256).astype(np.int32)
    k0[:3] = (0, seq_len - 1, 127)
    assert _wraps_negative(cmb, k0, STEPS, seq_len).sum() > 64
    cmb_i32 = cmb.view(np.int32)
    want = fm_probe.chain_gather(T(cmb_i32), T(k0), STEPS, seq_len)
    assert_same(want, _host(entry, cmb_i32, k0, STEPS, seq_len), entry)
    assert_same(k0, _host(entry, cmb_i32, k0, 0, seq_len), "0 steps")


def test_kernel_source_lane_loop_matches_plain_on_the_index(index_fm):
    arrays, fm = index_fm
    seq_len = int(arrays["seq_len"])
    k0 = np.random.default_rng(6).integers(0, seq_len, 384).astype(np.int32)
    w = fm_probe.words32(fm.cmb)
    want = fm_probe.chain_gather(w, T(k0), 64, seq_len)
    for entry in ("fm_chain_words_host", "fm_chain_rows_host"):
        assert_same(want, _host(entry, w.numpy(), k0, 64, seq_len), entry)


def test_wrappers_take_the_plain_version_on_the_cpu_and_count_nothing():
    cmb, seq_len = _synthetic(12)
    k0 = T(np.arange(128, dtype=np.int32))
    w = T(cmb.view(np.int32))
    before = (fm_probe.launches_words, fm_probe.launches_rows)
    want = fm_probe.chain_gather(w, k0, 5, seq_len)
    assert torch.equal(fm_probe.chain_words(w, k0, 5, seq_len), want)
    assert torch.equal(fm_probe.chain_rows(w, k0, 5, seq_len), want)
    assert (fm_probe.launches_words, fm_probe.launches_rows) == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    cmb, seq_len = _synthetic(12)
    w = T(cmb.view(np.int32))
    k0 = T(np.arange(128, dtype=np.int32))
    for bad in (dict(cmb=w.to(torch.int64)), dict(cmb=w[:, :10]),
                dict(cmb=w[:, :8].contiguous()[:, :6]),
                dict(k0=k0[:100]), dict(k0=k0.to(torch.int64)),
                dict(seq_len=w.shape[0] * 128 + 1), dict(seq_len=0),
                dict(seq_len=1 << 31)):
        kw = dict(cmb=w, k0=k0, steps=4, seq_len=seq_len) | bad
        with pytest.raises(ValueError):
            fm_probe._launch("fm_chain_words", **kw)
