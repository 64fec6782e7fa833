"""Chain extension windows and the per-read work order (the head of
mem_chain2aln, bwamem.c:639-676)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.ops.chain import Chains, FilteredChains, Seeds


def _cal_max_gap(qlen, a: int, o_del: int, e_del: int, o_ins: int,
                 e_ins: int, w: int):
    """cal_max_gap (bwamem.c:628-635); C double arithmetic + int truncation."""
    qf = qlen.to(torch.float64)
    l_del = ((qf * a - o_del) / e_del + 1.0).to(torch.int32)
    l_ins = ((qf * a - o_ins) / e_ins + 1.0).to(torch.int32)
    l = torch.maximum(l_del, l_ins).clamp(min=1)
    return l.clamp(max=w * 2)


def chain_rmax(seeds: Seeds, chains: Chains, l_seq, fm: fmops.FM,
               ctg_offsets, *, a: int, o_del: int, e_del: int, o_ins: int,
               e_ins: int, w: int):
    """Reference window [rmax0, rmax1) per chain (bwamem.c:648-666),
    including the strand clip and the bns_fetch_seq contig clamp."""
    N, S = seeds.rbeg.shape
    C = chains.pos.shape[1]
    it = seeds.rbeg.dtype
    dev = seeds.rbeg.device
    sc = chains.seed_chain
    in_ch = sc >= 0
    tgt = torch.where(in_ch, sc, C).to(torch.int64)

    gap_l = _cal_max_gap(seeds.qbeg, a, o_del, e_del, o_ins, e_ins, w)
    rem = l_seq[:, None] - seeds.qbeg - seeds.len
    gap_r = _cal_max_gap(rem, a, o_del, e_del, o_ins, e_ins, w)
    b = seeds.rbeg - (seeds.qbeg + gap_l).to(it)
    e = seeds.rbeg + seeds.len + (rem + gap_r).to(it)

    big = 2 * fm.l_pac
    # column C collects the seeds outside every chain and is cut off
    rmax0 = torch.full((N, C + 1), big, dtype=it, device=dev)
    rmax1 = torch.zeros((N, C + 1), dtype=it, device=dev)
    rmax0.scatter_reduce_(1, tgt, torch.where(in_ch, b, big), "amin")
    rmax1.scatter_reduce_(1, tgt, torch.where(in_ch, e, 0), "amax")
    rmax0 = rmax0[:, :C].clamp(min=0)
    rmax1 = rmax1[:, :C].clamp(max=big)
    crosses = (rmax0 < fm.l_pac) & (fm.l_pac < rmax1)
    first_fwd = chains.first_rbeg < fm.l_pac
    rmax1 = torch.where(crosses & first_fwd, fm.l_pac, rmax1)
    rmax0 = torch.where(crosses & ~first_fwd, fm.l_pac, rmax0)

    # bns_fetch_seq clamp to the contig holding the first seed (bntseq.c:426)
    pos_f, is_rev = fmops.depos(fm.l_pac, chains.first_rbeg)
    rid = chains.rid.clamp(min=0).to(torch.int64)
    n_ctg = ctg_offsets.shape[0]
    far_beg = ctg_offsets[rid.clamp(max=n_ctg - 1)].to(it)
    # contig end from the next offset (or l_pac for the last contig)
    nxt = torch.where(rid + 1 < n_ctg,
                      ctg_offsets[(rid + 1).clamp(max=n_ctg - 1)].to(it),
                      fm.l_pac)
    fb = torch.where(is_rev, 2 * fm.l_pac - nxt, far_beg)
    fe = torch.where(is_rev, 2 * fm.l_pac - far_beg, nxt)
    return torch.maximum(rmax0, fb), torch.minimum(rmax1, fe)


class WorkList(NamedTuple):
    seed_slot: torch.Tensor   # [N, S] slot of w-th work item
    chain: torch.Tensor       # [N, S] chain of w-th item (-1 invalid)
    n: torch.Tensor           # [N]


def build_worklist(seeds: Seeds, chains: Chains,
                   fl: FilteredChains) -> WorkList:
    """Processing order: chains by filter order (kept only), seeds within a
    chain by (len desc, slot desc) — the reverse of the reference's
    ks_introsort_64 ascending (score<<32|i) walk (bwamem.c:669-674).

    The sort key packs (filter position << 24) | ((512 - len) << 12) |
    (S - slot) in int64.  For a seed longer than 512 bp the middle field is
    negative and its sign bits run over the position field; the key is kept
    bit for bit as the JAX package computes it (its output is the
    reference here), and the host tie-order and re-scoring passes
    (pipeline/chainflt_host) rebuild the rows where it matters."""
    N, S = seeds.rbeg.shape
    C = chains.pos.shape[1]
    dev = seeds.rbeg.device
    i32, i64 = torch.int32, torch.int64
    order_c = fl.order.to(i64)
    # position of each chain in the filtered order, and its kept mark
    ord_pos = torch.zeros((N, C), dtype=i32, device=dev).scatter_(
        1, order_c, torch.arange(C, dtype=i32, device=dev)[None, :].expand(
            N, C))
    kept_of_chain = torch.zeros((N, C), dtype=i32, device=dev).scatter_(
        1, order_c, fl.kept.to(i32))
    sc = chains.seed_chain
    scc = sc.clamp(0, C - 1).to(i64)
    in_kept = ((sc >= 0) & (torch.gather(kept_of_chain, 1, scc) > 0)
               & seeds.valid)
    p = torch.gather(ord_pos, 1, scc)
    slots = torch.arange(S, dtype=i64, device=dev)[None, :]
    key = (p.to(i64) << 24 | (512 - seeds.len.to(i64)) << 12
           | (S - slots))
    key = torch.where(in_kept, key, 1 << 40)
    order = torch.sort(key, dim=1, stable=True).indices
    w_chain = torch.gather(torch.where(in_kept, sc, -1), 1, order)
    return WorkList(order.to(i32), w_chain, in_kept.sum(dim=1).to(i32))
