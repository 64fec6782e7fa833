"""Kernel 7B (gp3_ct, csrc/gather_probe3_kernel.cu) on the CPU at the
splits of the rows the card runs: the lane loop built for the host
(gp3_ct_host: T = clip(m + tab[m, c], 0, N - 1) taken once, then every
block's elements in the card's order (ct_place), each gather reading
kk[m, i] at the word the card computes (ct_src: the buffer of the block
that owns row m)) held against the Pallas kernel of the reference's
tools/pl_gather_probe3.py (probe_ct, :79-85, run in interpret mode as
tests/test_torch_gather_probe3.py runs it) and against ct_plain, on the
probe's table (every chain at N - 1 after a step), a spread one (chains
that keep moving) and one near +-2^31 (every add wraps), at N = 128 (the
probe's, where the card runs the cluster of 16 blocks, 8 rows each; the
one block there too) and at N = 139 (the largest a block holds), 33 and 1
(the one block), after 0, 1 and 512 steps.  The cluster's remote loads
themselves (mapa and ld.shared::cluster) and its barrier are held only on
the card, by chip_smoke.py's phase_ct and tools/torch_ct_variants.py."""
import numpy as np
import pytest

import jax.numpy as jnp

from bwamem_tpu_torch.ops import gather_probe3 as gp3

from test_torch_gather_probe3 import _host, pl_ct
from torch_port_util import T, assert_same

STEPS = (0, 1, 512)


def _splits(N):
    """The block counts the card splits N rows into: the cluster's at
    N = CT_N, one block at any N."""
    return (1, gp3.CT_CLUSTER) if N == gp3.CT_N else (1,)


@pytest.mark.parametrize("kind", gp3.CT_KINDS)
@pytest.mark.parametrize("N", [128, 139, 33, 1])
def test_ct_lanes_of_every_plan_match_pallas(N, kind):
    tab, kk = (x.numpy() for x in gp3.ct_inputs(kind, N, seed=N + 7))
    for steps in STEPS:
        want = np.asarray(pl_ct(jnp.asarray(tab), jnp.asarray(kk), steps))
        assert_same(want, gp3.ct_plain(T(tab), T(kk), steps),
                    f"ct_plain {kind} N={N} steps={steps}")
        for blocks in _splits(N):
            assert_same(want, _host("gp3_ct_host", tab, kk,
                                    np.zeros_like(kk), N, steps, blocks),
                        f"ct lanes {kind} N={N} steps={steps} "
                        f"blocks={blocks}")
    if kind == "spread" and N == 128:       # timed there: still moving
        assert (gp3.ct_plain(T(tab), T(kk), 511) != T(want)).any()


def test_ct_plans_place_every_element_once():
    """The host entry returns 0 only where the blocks, placing their
    elements by ct_place, cover the state once each: so for every split
    of the 128 rows into 1-16 blocks (the cluster sizes
    tools/torch_ct_variants.py times), each block's gathers addressed by
    ct_src, with the plain version's result; a split that does not divide
    N is refused."""
    tab, kk = (x.numpy() for x in gp3.ct_inputs("spread", 128, seed=1))
    want = gp3.ct_plain(T(tab), T(kk), 3)
    for blocks in (1, 2, 4, 8, 16):
        assert_same(want, _host("gp3_ct_host", tab, kk, np.zeros_like(kk),
                                128, 3, blocks), f"{blocks} blocks")
    with pytest.raises(AssertionError):     # 3 blocks do not split 128
        _host("gp3_ct_host", tab, kk, np.zeros_like(kk), 128, 1, 3)
