"""ops/global_sw.global_align_batch of bwamem_tpu_torch against
bwamem_tpu's on the CPU: the same seeded (query, target) pairs through
both, and every output (score, ops, lens, n_cigar, overflow) equal.  The
pairs are near copies (substitutions, short and long indels), unrelated
sequences and reverse-complemented pairs (the callers pre-reverse both
for reverse-strand hits), at several bands; with and without the CIGAR,
and with a cigar capacity small enough to set overflow, as samse's retry
meets it."""
import numpy as np
import pytest
import torch

import bwamem_tpu  # noqa: F401  (x64 on, as the reference runs)
import jax.numpy as jnp

from bwamem_tpu.config import fill_scmat
from bwamem_tpu.ops import global_sw as jgsw
from bwamem_tpu_torch.ops import global_sw as tgsw

from torch_port_util import assert_same

COMP = np.array([3, 2, 1, 0, 4], np.uint8)


def _mutate(rng, s, sub, ind):
    out = []
    for b in s:
        r = rng.random()
        if r < ind:
            continue                               # deletion
        if r < 2 * ind:
            out.append(int(rng.integers(0, 4)))    # insertion
        out.append(int(rng.integers(0, 4)) if rng.random() < sub else int(b))
    return np.asarray(out or [0], np.uint8)


def _pairs(seed, n, bands, max_len=150):
    """n (query, target, w) triples; w at least |tlen - qlen| + 3, as
    bwa_gen_cigar2 calls ksw_global2 (bwa.c:300)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q = rng.integers(0, 4, int(rng.integers(4, max_len))).astype(np.uint8)
        kind = i % 5
        if kind == 0:
            t = _mutate(rng, q, 0.03, 0.01)
        elif kind == 1:
            t = _mutate(rng, q, 0.08, 0.04)
        elif kind == 2:
            t = _mutate(rng, q, 0.02, 0.10)
        elif kind == 3:
            t = rng.integers(0, 4, int(rng.integers(4, max_len))
                             ).astype(np.uint8)
        else:                       # a reverse-strand hit, both reversed
            t = _mutate(rng, q, 0.03, 0.02)
            q, t = COMP[q[::-1]], COMP[t[::-1]]
        if i % 11 == 0:
            q = q.copy()
            q[rng.integers(0, len(q))] = 4           # an N
        w = max(int(rng.choice(bands)), abs(len(t) - len(q)) + 3)
        out.append((q, t, w))
    return out


def _both(pairs, *, w_max, max_cigar, with_cigar, mat=(1, 4),
          gaps=(6, 1, 6, 1)):
    B = len(pairs)
    LQ = max(len(q) for q, _, _ in pairs)
    LT = max(len(t) for _, t, _ in pairs)
    q = np.full((B, LQ), 4, np.uint8)
    t = np.full((B, LT), 4, np.uint8)
    qlen, tlen, w = (np.zeros(B, np.int32) for _ in range(3))
    for b, (qq, tt, ww) in enumerate(pairs):
        q[b, :len(qq)], t[b, :len(tt)] = qq, tt
        qlen[b], tlen[b], w[b] = len(qq), len(tt), ww
    kw = dict(o_del=gaps[0], e_del=gaps[1], o_ins=gaps[2], e_ins=gaps[3],
              w_max=w_max, max_cigar=max_cigar, with_cigar=with_cigar)
    m = fill_scmat(*mat)
    want = jgsw.global_align_batch(*(jnp.asarray(a) for a in
                                     (q, qlen, t, tlen, w)), m, **kw)
    got = tgsw.global_align_batch(*(torch.from_numpy(a) for a in
                                    (q, qlen, t, tlen, w)), m, **kw)
    for f in want._fields:
        assert_same(getattr(want, f), getattr(got, f), f)
    return got


@pytest.mark.parametrize("w_max,bands,seed", [(64, (3, 10, 25, 50), 0),
                                              (165, (60, 100, 165), 1)])
def test_global_align_matches_reference(w_max, bands, seed):
    got = _both(_pairs(seed, 60, bands), w_max=w_max, max_cigar=64,
                with_cigar=True)
    assert not bool(got.overflow.any())
    assert int(got.n_cigar.max()) > 3            # indels in some lane


def test_global_align_overflow_matches_reference():
    """A cigar capacity of 4 runs: noisy lanes overflow, the rest fit."""
    got = _both(_pairs(2, 50, (50,)), w_max=64, max_cigar=4,
                with_cigar=True)
    assert 0 < int(got.overflow.sum()) < 50


def test_global_align_score_only_matches_reference():
    got = _both(_pairs(3, 40, (10, 50)), w_max=64, max_cigar=32,
                with_cigar=False, mat=(1, 3), gaps=(5, 1, 5, 1))
    assert int(got.n_cigar.abs().sum()) == 0


def test_global_align_wide_cap_matches_reference():
    """A capacity past the path length (the retry's giant cap)."""
    _both(_pairs(4, 20, (50,), max_len=40), w_max=64, max_cigar=128,
          with_cigar=True, mat=(1, 3), gaps=(5, 1, 5, 1))
