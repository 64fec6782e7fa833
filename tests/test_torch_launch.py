"""The one launch path of bwamem_tpu_torch (ops/launch) on the CPU, with
fakes in place of CUDA.

Each kernel wrapper of the port is driven on tensors that claim to lie on
CUDA device 0 (CPU tensors of a subclass whose is_cuda is True), with the
stream lookup, the device calls and the kernel library's C entries faked:
the caller's stream handle must reach the C entry as its last argument and
the wrapper must count one launch; a non-zero code from the entry must
raise RuntimeError naming the kernel and the code and leave the count
alone.  ops/launch must switch the runtime's device only when the
tensors' index differs from the current one.  And no module of the port
but ops/launch may look the stream or the device up itself."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from bwamem_tpu_torch.ops import (chain, dispatch_probe, ext_kernel,
                                  fm_probe, gather_probe, gather_probe2,
                                  gather_probe3, launch, pl_probe)

PKG = Path(__file__).resolve().parent.parent / "bwamem_tpu_torch"
HANDLE = 0x5EED00           # the fake raw stream of device index i: + i


class OnCard(torch.Tensor):
    """A CPU tensor that the wrappers take for one on CUDA device 0."""

    @property
    def is_cuda(self):
        return True

    def get_device(self):
        return 0


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).as_subclass(
        OnCard)


def _ext_args():
    rng = np.random.default_rng(0)
    B, lq, tm = 4, 8, 12
    q = _i32(rng.integers(0, 4, (lq, B)))
    t = _i32(rng.integers(0, 4, (tm, B)))
    qlen, tlen = _i32([8, 5, 0, 3]), _i32([12, 7, 4, 2])
    h0, eb = _i32([10, 3, 5, 1]), _i32([5, 5, 5, 5])
    mat = np.where(np.eye(5, dtype=bool), 1, -4).astype(np.int8)
    kw = dict(lq_max=lq, t_max=tm, mat_bytes=mat.tobytes(), o_del=6,
              e_del=1, o_ins=6, e_ins=1, zdrop=100)
    return q, qlen, t, tlen, h0, eb, kw


def _cases():
    """(label, module, entry, counter, call) for every wrapper."""
    rng = np.random.default_rng(1)
    tab = _i32(rng.integers(0, 1 << 20, (256, 128)))
    tabw = _i32(rng.integers(0, 1 << 20, (256, 8)))
    k = _i32(rng.integers(0, 256, (2, 128)))
    kfull = _i32(rng.integers(0, 256, (256, 128)))
    kk8 = _i32(rng.integers(0, 8, (8, 128)))
    kk128 = _i32(rng.integers(0, 128, (8, 128)))
    k1 = _i32(rng.integers(0, 256, 64))
    sq = _i32(rng.integers(0, 8, (8, 8)))
    a = torch.from_numpy(rng.standard_normal((16, 4), np.float32)) \
        .as_subclass(OnCard)
    b = torch.from_numpy(rng.standard_normal((4, 8), np.float32)) \
        .as_subclass(OnCard)
    qT, tT = _i32(rng.integers(0, 4, (16, 32))), _i32(rng.integers(0, 4,
                                                                   (4, 32)))
    cmb = _i32(rng.integers(0, 1 << 20, (4, 12)))
    k0 = _i32(rng.integers(0, 4 * 128, 128))
    q, qlen, t, tlen, h0, eb, kw = _ext_args()
    gp, gp2, gp3 = gather_probe, gather_probe2, gather_probe3
    seeds = chain.Seeds(
        rbeg=torch.from_numpy(rng.integers(0, 1 << 20, (4, 8))).as_subclass(
            OnCard),
        qbeg=_i32(rng.integers(0, 100, (4, 8))),
        len=_i32(rng.integers(10, 30, (4, 8))), rid=_i32(np.zeros((4, 8))),
        valid=torch.ones((4, 8), dtype=torch.bool).as_subclass(OnCard),
        frac_rep=torch.zeros(4), overflow=torch.zeros(4, dtype=torch.bool))
    return [
        ("extend_batch_pl2", ext_kernel, "ext_pl2_launch", "launches",
         lambda: ext_kernel.extend_batch_pl2(q, qlen, t, tlen, h0, eb,
                                             w_opt=4, **kw)),
        ("extend_batch_pl", ext_kernel, "ext_pl_launch", "launches_pl",
         lambda: ext_kernel.extend_batch_pl(q, qlen, t, tlen, h0,
                                            _i32([4, 4, 8, 8]), eb, **kw)),
        ("chain_words", fm_probe, "fm_chain_words", "launches_words",
         lambda: fm_probe.chain_words(cmb, k0, 3, 4 * 128)),
        ("chain_rows", fm_probe, "fm_chain_rows", "launches_rows",
         lambda: fm_probe.chain_rows(cmb, k0, 3, 4 * 128)),
        ("gp_scalar", gp, "gp_scalar", "launches_scalar",
         lambda: gp.gp_scalar(tab, k)),
        ("gp_scalar2", gp, "gp_scalar2", "launches_scalar2",
         lambda: gp.gp_scalar2(tabw, k)),
        ("gp_onehot", gp, "gp_onehot", "launches_onehot",
         lambda: gp.gp_onehot(tab[:8], k)),
        ("gp_take_ax0", gp, "gp_take_ax0", "launches_take",
         lambda: gp.gp_take_ax0(tab, kfull, 2)),
        ("gp2_take_ax0", gp2, "gp2_take_ax0", "launches_take0",
         lambda: gp2.gp2_take_ax0(tab[:8], kk8, 2)),
        ("gp2_take_ax1", gp2, "gp2_take_ax1", "launches_take1",
         lambda: gp2.gp2_take_ax1(tab[:8], kk128, 2)),
        ("gp2_col0", gp2, "gp2_col0", "launches_col0",
         lambda: gp2.gp2_col0(tabw, k1)),
        ("gp2_onehot_f32", gp2, "gp2_onehot_f32", "launches_onehot",
         lambda: gp2.gp2_onehot_f32(tab[:8], k)),
        ("gp3_dg", gp3, "gp3_dg", "launches_dg",
         lambda: gp3.gp3_dg(tab[:8], kk8, 2, 0)),
        ("gp3_ct", gp3, "gp3_ct", "launches_ct",
         lambda: gp3.gp3_ct(sq, sq, 2)),
        ("gp3_col0", gp3, "gp3_col0", "launches_col0",
         lambda: gp3.gp3_col0(tabw, k1)),
        ("gp3_mm", gp3, "gp3_mm", "launches_mm",
         lambda: gp3.gp3_mm(a, b)),
        ("dp_eh", dispatch_probe, "dp_eh", "launches",
         lambda: dispatch_probe.dp_eh(qT, tT)),
        ("plp_row", pl_probe, "plp_row", "launches",
         lambda: pl_probe.plp_row(qT, tT, "full", 12)),
        ("chain_seeds", chain, "chain_launch", "launches",
         lambda: chain.chain_seeds(seeds, _i32([0, 1]), 1 << 21, 100,
                                   10_000, 8)),
    ]


CASES = _cases()


def _count(mod, counter):
    c = getattr(mod, counter)
    return c["full"] if isinstance(c, dict) else c


@pytest.fixture
def fake_cuda(monkeypatch):
    """Device 0 current, the raw stream of index i HANDLE + i, and a log of
    the devices entered."""
    entered = []

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            entered.append(("exit", self.index))

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(launch, "raw_stream", lambda i: HANDLE + i)
    return entered


def _fake_entry(monkeypatch, mod, entry, rc):
    calls = []

    def fn(*args):
        calls.append(args)
        return rc
    monkeypatch.setattr(mod.LIB, "_fns", {entry: fn})
    # the library's sizes (gp_take_ax0's scratch): a few words
    monkeypatch.setattr(mod.LIB, "value", lambda name, *ints: 64)
    return calls


@pytest.mark.parametrize("label,mod,entry,counter,call", CASES,
                         ids=[c[0] for c in CASES])
def test_the_callers_stream_reaches_the_c_entry(fake_cuda, monkeypatch,
                                                label, mod, entry, counter,
                                                call):
    calls = _fake_entry(monkeypatch, mod, entry, 0)
    before = _count(mod, counter)
    call()
    assert len(calls) == 1 and calls[0][-1] == HANDLE, label
    assert all(isinstance(x, int) for x in calls[0]), label
    assert _count(mod, counter) == before + 1, label
    assert fake_cuda == [], label           # device 0 is already current


@pytest.mark.parametrize("label,mod,entry,counter,call", CASES,
                         ids=[c[0] for c in CASES])
def test_a_failed_launch_raises_and_counts_nothing(fake_cuda, monkeypatch,
                                                   label, mod, entry,
                                                   counter, call):
    calls = _fake_entry(monkeypatch, mod, entry, 98)
    before = _count(mod, counter)
    with pytest.raises(RuntimeError, match=r"launch failed: CUDA error 98"):
        call()
    assert len(calls) == 1, label
    assert _count(mod, counter) == before, label


def test_the_device_is_switched_only_when_the_index_differs(fake_cuda):
    seen = []

    def fn(*args):
        seen.append((args, list(fake_cuda)))
        return 0
    launch.launch(fn, "k", 0, (1, 2))
    assert seen == [((1, 2, HANDLE), [])] and fake_cuda == []
    launch.launch(fn, "k", 3, (4,))
    # entered before the call, left after it, the stream of index 3
    assert seen[1] == ((4, HANDLE + 3), [3])
    assert fake_cuda == [3, ("exit", 3)]
    with pytest.raises(RuntimeError, match="k launch failed: CUDA error 7"):
        launch.launch(lambda *a: 7, "k", 3, ())
    assert fake_cuda[2:] == [3, ("exit", 3)]


def test_no_module_looks_the_stream_or_device_up_but_the_launch_module():
    own = PKG / "ops" / "launch.py"
    pat = re.compile(r"current_stream\(|torch\.cuda\.device\(")
    found = [f"{p.relative_to(PKG)}:{i}" for p in sorted(PKG.rglob("*.py"))
             if p != own
             for i, line in enumerate(p.read_text().splitlines(), 1)
             if pat.search(line)]
    assert found == []
    assert pat.search(own.read_text())       # the scan does see a use
