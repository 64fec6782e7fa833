"""CHAIN's semantics pinned by a per-read sequential mem_chain.

tools/torch_chain_cases.py's seq_chain is mem_chain's seed loop with
test_and_merge (bwamem.c:197-307) written straight from the C in Python
integers, read by read, with the port's fixed-width conventions.  It
holds, on that module's crafted seed grids (and on its heavy-tailed
random grid, small), every Chains field of

  * ops/chain.chain_seeds on CPU tensors (the plain lockstep loop, which
    must launch nothing), and
  * csrc/chain_kernel.cu built as host C++ (chain_host: the card's walk
    with the warp's 32 lanes one after the other), reached through the
    wrapper's own launch (ops/chain.launch_chain, its C entry faked by
    the host build on tensors that claim to lie on the card), with the
    seed grids as row-strided views,

for both index types.  The random cases run at sizes the plain loop
takes in a second."""
import ctypes

import numpy as np
import pytest
import torch

from bwamem_tpu_torch._build import shared_lib
from bwamem_tpu_torch.ops import chain as tchain
from bwamem_tpu_torch.ops import launch

from torch_port_util import assert_same   # puts tools/ on sys.path

import torch_chain_cases as cc   # noqa: E402

FIELDS = tchain.Chains._fields
assert FIELDS == cc.FIELDS
CASES, ITYPES, EXPECT = cc.CASES, cc.ITYPES, cc.EXPECT


def _seeds(grids, wrap=torch.from_numpy):
    rbeg, qbeg, slen, rid, valid = (wrap(np.ascontiguousarray(g))
                                    for g in grids)
    N = rbeg.shape[0]
    return tchain.Seeds(rbeg=rbeg, qbeg=qbeg, len=slen, rid=rid,
                        valid=valid, frac_rep=torch.zeros(N),
                        overflow=torch.zeros(N, dtype=torch.bool))


def _check(want, got, label):
    for f in FIELDS:
        assert_same(want[f], getattr(got, f), f"{label}: {f}")


PARAMS = [(c, t) for c in CASES for t in ITYPES]
IDS = [f"{c}-{t}" for c, t in PARAMS]


@pytest.mark.parametrize("case,itype", PARAMS, ids=IDS)
def test_plain_chain_equals_sequential_mem_chain(case, itype):
    grids, alt_of, p, want = cc.case(case, itype)
    before = tchain.launches
    got = tchain.chain_seeds(_seeds(grids), torch.from_numpy(alt_of),
                             p["l_pac"], w=p["w"], max_chain_gap=p["gap"],
                             chain_cap=p["C"])
    assert tchain.launches == before, "a CPU tensor launched the kernel"
    _check(want, got, case)
    assert got.pos.dtype == torch.from_numpy(grids[0]).dtype
    for i, sc in enumerate(EXPECT.get(case, ())):
        # the case reaches the outcome it is about
        assert want["seed_chain"][i, :len(sc)].tolist() == sc, (case, i)


# ------------------------------------------------- the kernel's host build

class OnCard(torch.Tensor):
    """A CPU tensor that the wrapper takes for one on CUDA device 0."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


def _host_lib():
    lib = ctypes.CDLL(shared_lib(
        tchain.SRC, "libchain_kernel_host.so",
        ["c++", "-x", "c++", "-O2", "-shared", "-fPIC"]))
    lib.chain_host.restype = ctypes.c_int
    lib.chain_host.argtypes = tchain.LIB.entries["chain_launch"]
    return lib


def _strided(g, pad=3):
    """g as a view with pad more columns a row (a row-strided grid, as the
    device front's seed grids are)."""
    t = torch.from_numpy(np.ascontiguousarray(g))
    wide = torch.zeros((t.shape[0], t.shape[1] + pad), dtype=t.dtype)
    wide[:, :t.shape[1]] = t
    return wide[:, :t.shape[1]].as_subclass(OnCard)


@pytest.mark.parametrize("case,itype", PARAMS, ids=IDS)
def test_kernel_host_build_equals_sequential_mem_chain(monkeypatch, case,
                                                       itype):
    grids, alt_of, p, want = cc.case(case, itype)
    lib = _host_lib()
    calls = []

    def entry(*args):
        calls.append(args)
        return lib.chain_host(*args[:-1])
    monkeypatch.setattr(tchain.LIB, "_fns", {"chain_launch": entry})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(launch, "raw_stream", lambda i: 0x5EED00 + i)
    seeds = tchain.Seeds(*(_strided(g) for g in grids),
                         frac_rep=torch.zeros(len(grids[0])),
                         overflow=torch.zeros(len(grids[0]),
                                              dtype=torch.bool))
    assert seeds.rbeg.stride(0) == seeds.rbeg.shape[1] + 3
    before = tchain.launches
    got = tchain.chain_seeds(seeds,
                             torch.from_numpy(alt_of).as_subclass(OnCard),
                             p["l_pac"], w=p["w"], max_chain_gap=p["gap"],
                             chain_cap=p["C"])
    assert len(calls) == 1 and calls[0][-1] == 0x5EED00
    assert tchain.launches == before + 1
    _check(want, got, case)
    plain = tchain.chain_seeds_plain(_seeds(grids), torch.from_numpy(alt_of),
                                     p["l_pac"], p["w"], p["gap"], p["C"])
    for f in FIELDS:
        a, b = getattr(plain, f), getattr(got, f)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), f


@pytest.mark.parametrize("itype", list(ITYPES))
def test_heavy_grid_plain_and_host_build(monkeypatch, itype):
    """The heavy-tailed grid chip_smoke.py holds the kernel on at the main
    path's shapes, small: 128 rows of 256 slots, a repeat row among them
    with a chain table past 32 chains."""
    it = ITYPES[itype]
    l_pac = 1 << 28
    grids, alt_of = cc.heavy_grid(128, 256, seed=5, itype=it, l_pac=l_pac)
    C = 256
    want = cc.seq_chain(*grids, alt_of, l_pac=l_pac, w=cc.W, gap=cc.GAP,
                        C=C, it=it)
    assert want["n"].max() > 64 and (want["n"] == 0).mean() > 0.3
    plain = tchain.chain_seeds(_seeds(grids), torch.from_numpy(alt_of),
                               l_pac, w=cc.W, max_chain_gap=cc.GAP,
                               chain_cap=C)
    _check(want, plain, "plain")
    lib = _host_lib()
    monkeypatch.setattr(tchain.LIB, "_fns", {
        "chain_launch": lambda *a: lib.chain_host(*a[:-1])})
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(launch, "raw_stream", lambda i: 0x5EED00 + i)
    got = tchain.chain_seeds(
        tchain.Seeds(*(_strided(g) for g in grids),
                     frac_rep=torch.zeros(128),
                     overflow=torch.zeros(128, dtype=torch.bool)),
        torch.from_numpy(alt_of).as_subclass(OnCard), l_pac, w=cc.W,
        max_chain_gap=cc.GAP, chain_cap=C)
    _check(want, got, "host build")
