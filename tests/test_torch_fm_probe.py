"""The chained FM-row gather probe of bwamem_tpu_torch (ops/fm_probe) on the
CPU: chain_gather against the chained-gather body of the reference's
tools/fm_step_probe.py restated with jax.numpy on the reference package's
own cmb table (both row layouts), and both lane loops of
csrc/fm_probe_kernel.cu, compiled for the host, against chain_gather.
Exact equality everywhere; the inputs include lanes whose k + acc wraps to
a negative int32, where C's % and Python's differ, and rows whose sum S is
within seq_len of 2^31, where k + S wraps past the int32 range.  The host
builds run the card's algorithm: the row-sum pass, the chain through the
sums, the remainder by an invariant divisor, which fm_mod_host exposes
alone."""
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


def _near_wrap(cmb_u32, seq_len, seed):
    """cmb_u32 with every third row's wrapping sum S moved into [2^31 -
    seq_len, 2^31 - 1] (word 0 adjusted), the first two at the edge where
    k + S starts to wrap: 2^31 - seq_len (no k < seq_len wraps) and one
    more (k = seq_len - 1 wraps)."""
    rng = np.random.default_rng(seed)
    c = cmb_u32.astype(np.uint64)
    rows = np.arange(0, c.shape[0], 3)
    want = (2**31 - 1 - rng.integers(0, seq_len, rows.size)).astype(
        np.uint64)
    want[:2] = (2**31 - seq_len, 2**31 - seq_len + 1)
    rest = c[rows, 1:].sum(1) % 2**32
    c[rows, 0] = (want + 2**32 - rest) % 2**32
    return c.astype(np.uint32)


def _wraps_past(cmb_u32, k0, steps, seq_len):
    """Steps (over all lanes) where k + S leaves the int32 range."""
    c = cmb_u32.astype(np.uint32).view(np.int32).astype(np.int64)
    S = ((c.sum(1) + 2**31) % 2**32) - 2**31
    k = k0.astype(np.int64)
    n = 0
    for _ in range(steps):
        v = k + S[k >> 7]
        n += int((v >= 2**31).sum())
        k = (((v + 2**31) % 2**32) - 2**31) % seq_len
    return n


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


def _lib():
    return ctypes.CDLL(shared_lib(
        fm_probe.SRC, "libfm_probe_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))


def _host(entry, cmb_i32, k0, steps, seq_len):
    """csrc/fm_probe_kernel.cu's algorithm built as host C++: the row-sum
    pass, then each lane's chain through the sums (the card runs the same
    code, the chain a thread a lane)."""
    fn = getattr(_lib(), entry)
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
@pytest.mark.parametrize("W", [4, 8, 12, 16])
def test_kernel_source_lane_loop_matches_plain(entry, W):
    cmb, seq_len = _synthetic(W, seed=3 + W)
    k0 = np.random.default_rng(4).integers(0, seq_len, 256).astype(np.int32)
    k0[:3] = (0, seq_len - 1, 127)
    assert _wraps_negative(cmb, k0, STEPS, seq_len).sum() > 64
    cmb_i32 = cmb.view(np.int32)
    for steps in (0, 1, 37, STEPS):
        want = fm_probe.chain_gather(T(cmb_i32), T(k0), steps, seq_len)
        assert_same(want, _host(entry, cmb_i32, k0, steps, seq_len),
                    f"{entry} {steps} steps")
    assert_same(k0, _host(entry, cmb_i32, k0, 0, seq_len), "0 steps")


@pytest.mark.parametrize("entry", ["fm_chain_words_host",
                                   "fm_chain_rows_host"])
@pytest.mark.parametrize("W", [4, 8, 12])
def test_lane_loop_where_k_plus_s_wraps_at_the_largest_seq_len(entry, W):
    """seq_len = rows x 128, the most the wrapper takes for the table, and
    a third of the rows with S within seq_len of 2^31, so that k + S wraps
    past the int32 range on many steps; held to chain_gather and to the
    reference's body in jax.numpy."""
    cmb, _ = _synthetic(W, nb=64, seed=20 + W)
    seq_len = cmb.shape[0] * 128
    cmb = _near_wrap(cmb, seq_len, seed=W)
    k0 = np.random.default_rng(W).integers(0, seq_len, 256).astype(np.int32)
    k0[:2] = (0, seq_len - 1)
    assert _wraps_past(cmb, k0, STEPS, seq_len) > 100
    assert _wraps_negative(cmb, k0, STEPS, seq_len).sum() > 64
    cmb_i32 = cmb.view(np.int32)
    for steps in (0, 1, 37, STEPS):
        want = fm_probe.chain_gather(T(cmb_i32), T(k0), steps, seq_len)
        assert_same(want, _host(entry, cmb_i32, k0, steps, seq_len),
                    f"{entry} {steps} steps")
    assert_same(j_chain(jnp.asarray(cmb), jnp.asarray(k0), STEPS, seq_len),
                want, "reference body")


def _mod_host(v, L):
    fn = _lib().fm_mod_host
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
    v = np.ascontiguousarray(v, np.int32)
    out = np.zeros_like(v)
    assert fn(v.ctypes.data, out.ctypes.data, v.size, L) == 0
    return out


def test_invariant_divisor_equals_python_mod():
    """fm_mod (csrc/fm_probe_kernel.cu) for divisors from 1 to 2^31 - 1
    and dividends over the whole int32 range: the ends, 0, values at and
    next to multiples of the divisor (and of 2^31 mod it), random ones."""
    rng = np.random.default_rng(11)
    top = 2**31 - 1
    divisors = {1, 2, 3, 5, 7, 127, 128, 129, 10_000_000, 10_010_624,
                2**30 - 1, 2**30, 2**30 + 1, top - 1, top}
    divisors |= {2**e + d for e in range(1, 31) for d in (-1, 0, 1)
                 if 0 < 2**e + d <= top}
    divisors |= set(int(x) for x in rng.integers(1, top, 40))
    divisors |= set(int(x) for x in rng.integers(1, 1000, 20))
    for L in sorted(divisors):
        v = [-2**31, -2**31 + 1, -1, 0, 1, top - 1, top]
        for q in (1, 2, 3, top // L, top // L - 1, -(2**31 // L),
                  -(2**31 // L) + 1):
            for d in (-1, 0, 1):
                x = q * L + d
                if -2**31 <= x <= top:
                    v.append(x)
        c = 2**31 % L
        v += [c - 1, c, c + 1, -c, -c - 1, -c + 1]
        v = np.array([x for x in v if -2**31 <= x <= top]
                     + list(rng.integers(-2**31, 2**31, 200)), np.int64)
        got = _mod_host(v.astype(np.int32), L).astype(np.int64)
        want = v % L
        bad = np.nonzero(got != want)[0]
        assert bad.size == 0, (L, v[bad[:5]], got[bad[:5]], want[bad[:5]])


def test_kernel_source_lane_loop_matches_plain_on_the_index(index_fm):
    arrays, fm = index_fm
    seq_len = int(arrays["seq_len"])
    k0 = np.random.default_rng(6).integers(0, seq_len, 384).astype(np.int32)
    w = fm_probe.words32(fm.cmb)
    want = fm_probe.chain_gather(w, T(k0), 64, seq_len)
    assert_same(j_chain(jnp.asarray(arrays["cmb"]), jnp.asarray(k0), 64,
                        seq_len), want, "reference body")
    for entry in ("fm_chain_words_host", "fm_chain_rows_host"):
        assert_same(want, _host(entry, w.numpy(), k0, 64, seq_len), entry)
    top = w.shape[0] * 128                 # the largest seq_len it takes
    k0 = np.random.default_rng(7).integers(0, top, 384).astype(np.int32)
    want = fm_probe.chain_gather(w, T(k0), 64, top)
    for entry in ("fm_chain_words_host", "fm_chain_rows_host"):
        assert_same(want, _host(entry, w.numpy(), k0, 64, top),
                    f"{entry} at seq_len {top}")


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
