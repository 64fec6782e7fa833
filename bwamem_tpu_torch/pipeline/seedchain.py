"""Single-program front half: reads -> intervals -> seeds -> chains ->
filtered chains (-> alignment regions), each stage one batched function
over the whole batch.

Mirrors stages 1-7 of the reference GPU driver and the CPU
mem_chain/mem_chain_flt/mem_chain2aln path it must agree with.  No user
path runs it: the aligner's fronts are pipeline/device_front (arenas
sized from the batch, one fetch) and pipeline/seeding_host +
extend_host (host-compacted lanes).  It is the second, independent
driver of seeding, chaining and extension that those fronts' regions are
held against (chip_smoke.py phase_seedchain on the card).

Plain functions on tensors: they run on the device of the tensors passed
in, and launch the extension kernels there (ops/align_ext.extend_all).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from bwamem_tpu_torch.config import MemOptions, fill_scmat
from bwamem_tpu_torch.ops import align_ext
from bwamem_tpu_torch.ops import chain as chainops
from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.ops import smem as smemops


class SeedChainResult(NamedTuple):
    intervals: smemops.Intervals
    seeds: chainops.Seeds
    chains: chainops.Chains
    weights: torch.Tensor
    filtered: chainops.FilteredChains


def seed_and_chain(fm: fmops.FM, ctg_offsets, ctg_is_alt, seq, l_seq, *,
                   min_seed_len: int, split_len: int, split_width: int,
                   max_mem_intv: int, max_occ: int, w: int,
                   max_chain_gap: int, mask_level: float, drop_ratio: float,
                   min_chain_weight: int, max_chain_extend: int,
                   seed_cap: int = 256, chain_cap: int = 64,
                   caps: smemops.SeedingCaps = smemops.SeedingCaps()
                   ) -> SeedChainResult:
    iv = smemops.collect_intervals(
        fm, seq, l_seq, min_seed_len=min_seed_len, split_len=split_len,
        split_width=split_width, max_mem_intv=max_mem_intv, caps=caps)
    sd = chainops.expand_seeds(fm, ctg_offsets, iv, max_occ=max_occ,
                               seed_cap=seed_cap)
    ch = chainops.chain_seeds(sd, ctg_is_alt, fm.l_pac, w=w,
                              max_chain_gap=max_chain_gap,
                              chain_cap=chain_cap)
    wt = chainops.chain_weights(sd, ch)
    fl = chainops.filter_chains(
        ch, wt, sd, mask_level=mask_level, drop_ratio=drop_ratio,
        min_seed_len=min_seed_len, max_chain_gap=max_chain_gap,
        min_chain_weight=min_chain_weight, max_chain_extend=max_chain_extend)
    return SeedChainResult(iv, sd, ch, wt, fl)


def _chain_kw(opt: MemOptions) -> dict:
    return dict(min_seed_len=opt.min_seed_len, split_len=opt.split_len,
                split_width=opt.split_width, max_mem_intv=opt.max_mem_intv,
                max_occ=opt.max_occ, w=opt.w,
                max_chain_gap=opt.max_chain_gap, mask_level=opt.mask_level,
                drop_ratio=opt.drop_ratio,
                min_chain_weight=opt.min_chain_weight,
                max_chain_extend=opt.max_chain_extend)


def _score_kw(opt: MemOptions) -> dict:
    return dict(a=opt.a, o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                e_ins=opt.e_ins)


def extend_kw(opt: MemOptions) -> dict:
    """align_ext.extend_all's scoring and band keywords from `opt`."""
    return dict(**_score_kw(opt), w=opt.w, zdrop=opt.zdrop,
                pen_clip5=opt.pen_clip5, pen_clip3=opt.pen_clip3,
                mat=fill_scmat(opt.a, opt.b))


def seed_and_chain_opts(fm, ctg_offsets, ctg_is_alt, seq, l_seq,
                        opt: MemOptions, **caps) -> SeedChainResult:
    return seed_and_chain(fm, ctg_offsets, ctg_is_alt, seq, l_seq,
                          **_chain_kw(opt), **caps)


def align_regs(fm, ctg_offsets, ctg_is_alt, seq, l_seq, opt: MemOptions, *,
               reg_cap: int = 16, **caps):
    """Reads -> alignment regions (pre-dedup), in mem_chain2aln emission
    order.  `caps`: seed_and_chain's seed_cap, chain_cap and caps.
    Returns (SeedChainResult, align_ext.Regs)."""
    res = seed_and_chain_opts(fm, ctg_offsets, ctg_is_alt, seq, l_seq, opt,
                              **caps)
    regs = align_ext.extend_all(
        fm, ctg_offsets, ctg_is_alt, seq, l_seq, res.seeds, res.chains,
        res.filtered, **extend_kw(opt), reg_cap=reg_cap)
    return res, regs


class WorklistResult(NamedTuple):
    seeds: chainops.Seeds
    seed_chain: torch.Tensor  # [N, S] chain of each seed slot (-1 none)
    wl_slot: torch.Tensor     # [N, S] work order -> seed slot
    wl_chain: torch.Tensor    # [N, S] chain per work item (-1 none)
    wl_n: torch.Tensor        # [N]
    rmax0: torch.Tensor       # [N, C]
    rmax1: torch.Tensor       # [N, C]
    chain_rid: torch.Tensor   # [N, C]
    overflow: torch.Tensor    # [N]


def seed_chain_worklist_kw(fm, ctg_offsets, ctg_is_alt, seq, l_seq, *,
                           a, o_del, e_del, o_ins, e_ins,
                           **chain_kw) -> WorklistResult:
    """The front half WITHOUT extension: the exact work order of
    mem_chain2aln, per-chain reference windows, and the seed tables.
    `chain_kw`: seed_and_chain's keywords (its options and caps)."""
    res = seed_and_chain(fm, ctg_offsets, ctg_is_alt, seq, l_seq, **chain_kw)
    wl = align_ext.build_worklist(res.seeds, res.chains, res.filtered)
    rmax0, rmax1 = align_ext.chain_rmax(
        res.seeds, res.chains, l_seq, fm, ctg_offsets,
        a=a, o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
        w=chain_kw["w"])
    overflow = (res.intervals.overflow | res.seeds.overflow
                | res.chains.overflow)
    return WorklistResult(seeds=res.seeds, seed_chain=res.chains.seed_chain,
                          wl_slot=wl.seed_slot, wl_chain=wl.chain,
                          wl_n=wl.n, rmax0=rmax0, rmax1=rmax1,
                          chain_rid=res.chains.rid, overflow=overflow)


def seed_chain_worklist(fm, ctg_offsets, ctg_is_alt, seq, l_seq,
                        opt: MemOptions, **caps) -> WorklistResult:
    return seed_chain_worklist_kw(fm, ctg_offsets, ctg_is_alt, seq, l_seq,
                                  **_chain_kw(opt), **_score_kw(opt), **caps)
