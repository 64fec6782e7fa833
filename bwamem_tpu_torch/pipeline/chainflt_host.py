"""Exact-order chain filtering for weight-tied reads.

The tensor filter (ops/chain.filter_chains) orders chains with a STABLE
weight-descending sort over the B-tree traversal order.  The reference
instead runs klib's `ks_introsort(mem_flt, ...)` (ksort.h), whose quicksort
partition passes permute EQUAL-weight chains in a deterministic but
non-stable way — and mem_chain_flt's shadow bookkeeping (`a[j].first`, the
kept=1 resurrection, bwamem.c:364,375-377) makes the KEPT SET depend on
that tie order.  With all chain weights distinct the two orders coincide,
so only reads whose (heavy) chains contain duplicate weights can diverge;
for exactly those reads this module replays ks_introsort + mem_chain_flt +
the mem_chain2aln work order bug-for-bug on the host and patches the
read's worklist rows.  Pure numpy and Python apart from the batched seed
re-scoring, which goes to the aligner's device (Aligner._device_ksw).
"""
from __future__ import annotations

import math

import numpy as np


def ks_introsort_mem_flt_perm(w) -> list[int]:
    """Permutation produced by ks_introsort(mem_flt) (ksort.h:141-190) on
    weights `w`; comparator flt_lt(a,b) = a.w > b.w (bwamem.c:331).
    Returns `perm` s.t. sorted[i] = input[perm[i]]."""
    n = len(w)
    a = [(int(w[i]), i) for i in range(n)]

    def lt(x, y):
        return x[0] > y[0]

    def insertsort(s, t):
        # __ks_insertsort over a[s:t)
        for i in range(s + 1, t):
            j = i
            while j > s and lt(a[j], a[j - 1]):
                a[j], a[j - 1] = a[j - 1], a[j]
                j -= 1

    def combsort(off, cnt):
        # ks_combsort(n, a + off)
        shrink = 1.2473309501039786540366528676643
        gap = cnt
        while True:
            if gap > 2:
                gap = int(gap / shrink)
                if gap in (9, 10):
                    gap = 11
            do_swap = False
            for i in range(off, off + cnt - gap):
                j = i + gap
                if lt(a[j], a[i]):
                    a[i], a[j] = a[j], a[i]
                    do_swap = True
            if not (do_swap or gap > 2):
                break
        if gap != 1:
            insertsort(off, off + cnt)

    if n < 1:
        return []
    if n == 1:
        return [0]
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return [p[1] for p in a]
    if n >= 3:
        d = 2
        while (1 << d) < n:
            d += 1
        stack = []
        s, t = 0, n - 1
        d <<= 1
        while True:
            if s < t:
                d -= 1
                if d == 0:
                    combsort(s, t - s + 1)
                    t = s
                    continue
                i, j = s, t
                k = i + ((j - i) >> 1) + 1
                if lt(a[k], a[i]):
                    if lt(a[k], a[j]):
                        k = j
                else:
                    k = i if lt(a[j], a[i]) else j
                rp = a[k]
                if k != t:
                    a[k], a[t] = a[t], a[k]
                while True:
                    i += 1
                    while lt(a[i], rp):
                        i += 1
                    j -= 1
                    while i <= j and lt(rp, a[j]):
                        j -= 1
                    if j <= i:
                        break
                    a[i], a[j] = a[j], a[i]
                a[i], a[t] = a[t], a[i]
                if i - s > t - i:
                    if i - s > 16:
                        stack.append((s, i - 1, d))
                    s = i + 1 if t - i > 16 else t
                else:
                    if t - i > 16:
                        stack.append((i + 1, t, d))
                    t = i - 1 if i - s > 16 else s
            else:
                if not stack:
                    insertsort(0, n)
                    return [p[1] for p in a]
                s, t, d = stack.pop()


def chain_flt_exact(trav_ids, w, beg, end, alt, *, mask_level, drop_ratio,
                    min_seed_len, max_chain_gap, min_chain_weight,
                    max_chain_extend):
    """mem_chain_flt (bwamem.c:334-392) on one read's chains.

    trav_ids: chain ids in B-tree traversal order (pos asc, creation-index
    tiebreak); w/beg/end/alt indexed by chain id.  Returns the kept chain
    ids in final (sorted, compacted) order."""
    ids = [c for c in trav_ids if w[c] >= min_chain_weight]
    n = len(ids)
    if n == 0:
        return []
    perm = ks_introsort_mem_flt_perm([w[c] for c in ids])
    srt = [ids[p] for p in perm]           # chain id at each sorted index
    kept = [0] * n
    first = [-1] * n
    keep_list = [0]
    kept[0] = 3
    for i in range(1, n):
        ci = srt[i]
        large_ovlp = False
        dropped = False
        for j in keep_list:
            cj = srt[j]
            b_max = max(beg[cj], beg[ci])
            e_min = min(end[cj], end[ci])
            if e_min > b_max and (not alt[cj] or alt[ci]):
                li = end[ci] - beg[ci]
                lj = end[cj] - beg[cj]
                min_l = min(li, lj)
                if e_min - b_max >= min_l * mask_level and \
                        min_l < max_chain_gap:
                    large_ovlp = True
                    if first[j] < 0:
                        first[j] = i
                    if w[ci] < w[cj] * drop_ratio and \
                            w[cj] - w[ci] >= min_seed_len << 1:
                        dropped = True
                        break
        if not dropped:
            keep_list.append(i)
            kept[i] = 2 if large_ovlp else 3
    for j in keep_list:
        if first[j] >= 0:
            kept[first[j]] = 1
    # max_chain_extend cap (bwamem.c:380-386): the chain that hits the cap
    # is itself zeroed by the follow-on loop (it starts at the break index)
    k = 0
    i = 0
    while i < n:
        if kept[i] in (1, 2):
            k += 1
            if k >= max_chain_extend:
                break
        i += 1
    while i < n:
        if kept[i] < 3:
            kept[i] = 0
        i += 1
    return [srt[i] for i in range(n) if kept[i] > 0]


def rebuild_worklist_row(wr, gi, *, mask_level, drop_ratio, min_seed_len,
                         max_chain_gap, min_chain_weight, max_chain_extend):
    """Recompute (wl_slot, wl_chain, wl_n) for group row `gi` with the exact
    reference tie order; mutates wr's arrays in place."""
    C = wr.chain_w.shape[1]
    nch = int(wr.chain_n[gi])
    if nch == 0:
        return
    pos = wr.chain_pos[gi, :nch]
    trav = sorted(range(nch), key=lambda c: (int(pos[c]), c))
    w = wr.chain_w[gi]
    beg = wr.chain_fq[gi]
    end = wr.chain_lq[gi] + wr.chain_ll[gi]
    alt = wr.chain_alt[gi]
    kept_ids = chain_flt_exact(
        trav, w, beg, end, alt, mask_level=mask_level,
        drop_ratio=drop_ratio, min_seed_len=min_seed_len,
        max_chain_gap=max_chain_gap, min_chain_weight=min_chain_weight,
        max_chain_extend=max_chain_extend)
    # mem_chain2aln work order: kept chains in sorted order; within a chain
    # seeds by srt = score<<32|i ascending, walked DESC (bwamem.c:669-676)
    sc = wr.seed_chain[gi]
    slen = wr.seeds.len[gi]
    slots_out, chains_out = [], []
    for c in kept_ids:
        slots = np.nonzero(sc == c)[0]          # within-chain i = slot asc
        srt_order = sorted(range(slots.size),
                           key=lambda k: (int(slen[slots[k]]), k),
                           reverse=True)
        for k in srt_order:
            slots_out.append(int(slots[k]))
            chains_out.append(c)
    nw = len(slots_out)
    wr.wl_slot[gi, :nw] = slots_out
    wr.wl_chain[gi, :nw] = chains_out
    wr.wl_chain[gi, nw:] = -1
    wr.wl_n[gi] = nw


def fix_tied_rows(wr, opt):
    """Patch every group row whose heavy chains contain duplicate weights
    (the only rows where the device's stable tie order can differ from
    ks_introsort).  Returns the number of rows patched."""
    C = wr.chain_w.shape[1]
    exists = np.arange(C)[None, :] < wr.chain_n[:, None]
    heavy = exists & (wr.chain_w >= opt.min_chain_weight)
    # duplicate weight detection per row over heavy chains
    wsort = np.sort(np.where(heavy, wr.chain_w, np.int64(-1) << 40), axis=1)
    dup = ((wsort[:, 1:] == wsort[:, :-1]) &
           (wsort[:, 1:] != np.int64(-1) << 40)).any(axis=1)
    rows = np.nonzero(dup)[0]
    for gi in rows:
        rebuild_worklist_row(
            wr, gi, mask_level=opt.mask_level, drop_ratio=opt.drop_ratio,
            min_seed_len=opt.min_seed_len, max_chain_gap=opt.max_chain_gap,
            min_chain_weight=opt.min_chain_weight,
            max_chain_extend=opt.max_chain_extend)
    return rows.size


# --------------------------------------------------------------------------
# Long-read chained-seed re-scoring — mem_flt_chained_seeds (bwamem.c:607-625)
# + mem_seed_sw (bwamem.c:578-605).  Runs after chain filtering; re-scores
# short seeds of kept chains with a windowed local SW, drops weak ones, and
# switches the mem_chain2aln work order key from seed LENGTH to seed SCORE
# (srt = score<<32|i, bwamem.c:669-674).  No-op for short reads (the gate at
# bwamem.c:611 fires for l_query below ~800bp at default settings).
# --------------------------------------------------------------------------

MEM_SHORT_EXT = 50      # bwamem.c:571
MEM_SHORT_LEN = 200     # bwamem.c:572
MEM_HSP_COEF = 1.1      # bwamem.c:574 (float in C)
MEM_MINSC_COEF = 5.5    # bwamem.c:575
MEM_SEEDSW_COEF = 0.05  # bwamem.c:576


def _seed_sw_window(al, qbeg, slen, rbeg, l_query):
    """mem_seed_sw window computation incl. bns_fetch_seq contig clamping
    (bwamem.c:584-597, bntseq.c bns_fetch_seq).  Returns (qb, qe, rb, re)
    or None when the seed needs no SW (len/window too long)."""
    l_pac = al.l_pac
    if slen >= MEM_SHORT_LEN:
        return None
    qb = max(qbeg - MEM_SHORT_EXT, 0)
    qe = min(qbeg + slen + MEM_SHORT_EXT, l_query)
    rb = rbeg - MEM_SHORT_EXT
    re = rbeg + slen + MEM_SHORT_EXT
    mid = (rbeg + rbeg + slen) >> 1
    rb = max(rb, 0)
    re = min(re, 2 * l_pac)
    if rb < l_pac < re:
        if mid < l_pac:
            re = l_pac
        else:
            rb = l_pac
    if qe - qb >= MEM_SHORT_LEN or re - rb >= MEM_SHORT_LEN:
        return None
    # bns_fetch_seq: clamp to the contig of mid (on the strand of mid)
    is_rev = mid >= l_pac
    fmid = 2 * l_pac - 1 - mid if is_rev else mid
    rid = int(np.searchsorted(al.ctg_offsets_np, fmid, side="right")) - 1
    far_beg = int(al.ctg_offsets_np[rid])
    far_end = far_beg + int(al.ctg_lens_np[rid])
    if is_rev:
        far_beg, far_end = 2 * l_pac - far_end, 2 * l_pac - far_beg
    rb = max(rb, far_beg)
    re = min(re, far_end)
    return qb, qe, rb, re


def flt_chained_seeds(al, reads, wr):
    """Re-score + filter the seeds behind each read's worklist in place.

    reads[i] corresponds to wr row i.  Mutates wr.wl_slot/wl_chain/wl_n and
    wr.seed_chain (dropped seeds get chain -1 so seedcov ignores them)."""
    from bwamem_tpu_torch.pipeline import extend_host
    opt = al.opt
    gated = []
    min_hsp = {}
    for i, r in enumerate(reads):
        L = r.l_seq
        if L <= 0:
            continue
        min_l = (MEM_HSP_COEF * opt.min_chain_weight
                 if opt.min_chain_weight else MEM_MINSC_COEF * math.log(L))
        if min_l > MEM_SEEDSW_COEF * L:
            continue
        gated.append(i)
        min_hsp[i] = int(opt.a * min_l + .499)
    if not gated:
        return 0

    # ---- collect SW jobs over every worklist seed of the gated reads ----
    jobs = []                    # (i, slot, qb, qe, rb, re)
    score = {}                   # (i, slot) -> raw mem_seed_sw score
    for i in gated:
        for k in range(int(wr.wl_n[i])):
            slot = int(wr.wl_slot[i, k])
            qbeg = int(wr.seeds.qbeg[i, slot])
            slen = int(wr.seeds.len[i, slot])
            rbeg = int(wr.seeds.rbeg[i, slot])
            win = _seed_sw_window(al, qbeg, slen, rbeg, reads[i].l_seq)
            if win is None:
                score[(i, slot)] = -1
            else:
                jobs.append((i, slot) + win)
    if jobs:
        B = len(jobs)
        LQ = max(j[3] - j[2] for j in jobs)
        LT = max(j[5] - j[4] for j in jobs)
        q = np.full((B, LQ), 4, np.uint8)
        t = np.full((B, LT), 4, np.uint8)
        qlen = np.zeros(B, np.int32)
        tlen = np.zeros(B, np.int32)
        for b, (i, slot, qb, qe, rb, re) in enumerate(jobs):
            q[b, : qe - qb] = reads[i].seq[qb:qe]
            t[b, : re - rb] = extend_host.ref_base_np(
                al.pac, al.l_pac, np.arange(rb, re, dtype=np.int64))
            qlen[b] = qe - qb
            tlen[b] = re - rb
        # ksw_align2 with xtra=KSW_XSTART picks the i16 kernel (stripe 8,
        # ksw.c:343-353); no XSUBO/XSTOP thresholds
        res = al._device_ksw(q, qlen, t, tlen,
                             np.full(B, 0x10000, np.int32), p=8)
        sc = np.asarray(res.score)
        for b, (i, slot, *_rest) in enumerate(jobs):
            score[(i, slot)] = int(sc[b])

    # ---- drop weak seeds + rebuild the work order on score ----
    n_drop = 0
    for i in gated:
        c = int(wr.wl_n[i])
        if c == 0:
            continue
        chain_slots = {}     # chain -> [slot asc]
        chain_order = []
        for k in range(c):
            ch = int(wr.wl_chain[i, k])
            if ch not in chain_slots:
                chain_slots[ch] = []
                chain_order.append(ch)
            chain_slots[ch].append(int(wr.wl_slot[i, k]))
        new_slots, new_chains = [], []
        for ch in chain_order:
            rem = []
            for slot in sorted(chain_slots[ch]):   # insertion (i) order
                x = score[(i, slot)]
                if 0 <= x < min_hsp[i]:
                    wr.seed_chain[i, slot] = -1    # excluded from seedcov
                    n_drop += 1
                    continue
                fin = int(wr.seeds.len[i, slot]) * opt.a if x < 0 else x
                rem.append((slot, fin))
            order = sorted(range(len(rem)),
                           key=lambda k2: (rem[k2][1], k2), reverse=True)
            for k2 in order:
                new_slots.append(rem[k2][0])
                new_chains.append(ch)
        wr.wl_slot[i, : len(new_slots)] = new_slots
        wr.wl_chain[i, : len(new_chains)] = new_chains
        wr.wl_chain[i, len(new_chains):] = -1
        wr.wl_n[i] = len(new_slots)
    return n_drop
