"""BWA-SW core: DP over the read's prefix DAG × the genome's prefix trie
(bsw2_core, bwtsw2_core.c:449-619), plus duplicate-hit resolution.

The traversal is an exact replay of the reference beam search: entry stack
order, pending-merge bookkeeping, Z-best heap thresholds, cut_tail
quickselect semantics and khash-based duplicate removal all match, because
every one of them influences which hits survive and in what order they are
saved — and the SAM output is byte-compared against the reference.

The genome occ4 lookups (the only dense work here) are batched per wave of
cells through hostfm.HostFM; everything else is pointer-chasing.
Counterpart of bwamem_tpu/bwasw/core.py."""
from __future__ import annotations

import numpy as np

from bwamem_tpu_torch.bwasw.ksort import ks_introsort

MINUS_INF = -0x3FFFFFFF
MASK_LEVEL = 0.90


class Cell:
    __slots__ = ("qk", "ql", "I", "D", "G", "pj", "qlen", "tlen",
                 "ppos", "upos", "cpos", "ok", "ol")

    def __init__(self):
        self.qk = 0
        self.ql = 0
        self.I = MINUS_INF
        self.D = MINUS_INF
        self.G = MINUS_INF
        self.pj = 0
        self.qlen = 0
        self.tlen = 0
        self.ppos = -1
        self.upos = -1
        self.cpos = [-1, -1, -1, -1]
        self.ok = None           # cached genome occ4(qk-1)
        self.ol = None           # cached genome occ4(ql)


class Entry:
    __slots__ = ("tk", "tl", "cells")

    def __init__(self, tk=0, tl=0):
        self.tk = tk
        self.tl = tl
        self.cells: list[Cell] = []


class Hit:
    """bsw2hit_t."""
    __slots__ = ("k", "l", "flag", "n_seeds", "is_rev", "len", "G", "G2",
                 "beg", "end")

    def __init__(self):
        self.k = 0
        self.l = 0
        self.flag = 0
        self.n_seeds = 0
        self.is_rev = 0
        self.len = 0
        self.G = 0
        self.G2 = 0
        self.beg = 0
        self.end = 0

    def copy(self) -> "Hit":
        h = Hit()
        for f in Hit.__slots__:
            setattr(h, f, getattr(self, f))
        return h


def hitG_lt(a: Hit, b: Hit) -> bool:
    # __hitG_lt (bwtsw2_core.c:42)
    return (a.G + (a.n_seeds << 2)) > (b.G + (b.n_seeds << 2))


# ------------------------------------------------------------ connectivity

def connectivity(bwtl) -> dict:
    """In-degree of every reachable node of the read DAG
    (bsw2_connectivity, bwtsw2_core.c:99-132).  Returns {(k,l): [pos, cnt]}
    where pos is the 1-based pending index (0 = none)."""
    h: dict[tuple[int, int], list[int]] = {}
    stack = [(0, bwtl.seq_len)]
    while stack:
        k, l = stack.pop()
        cntk, cntl = bwtl.occ4_pair(k - 1, l)
        for j in range(4):
            kj = int(bwtl.L2[j] + cntk[j] + 1)
            lj = int(bwtl.L2[j] + cntl[j])
            if kj > lj:
                continue
            v = h.get((kj, lj))
            if v is None:
                h[(kj, lj)] = [0, 1]
                stack.append((kj, lj))
            else:
                v[1] += 1
    return h


# ------------------------------------------------------------- utilities

def cut_tail(u: Entry, T: int) -> None:
    """Keep the top-T scores at a node (bwtsw2_core.c:134-157)."""
    cells = u.cells
    if len(cells) <= T:
        return
    a = [-p.G for p in cells if p.ql and p.G > 0]
    if len(a) <= T:
        return
    x = -int(np.partition(np.asarray(a, np.int64), T)[T])
    n = 0
    for p in cells:
        if p.G == x:
            n += 1
        if p.G < x or (p.G == x and n >= T):
            p.qk = p.ql = 0
            p.G = 0
            if p.ppos >= 0:
                cells[p.ppos].cpos[p.pj] = -1


def remove_duplicate(u: Entry) -> None:
    """Drop cells with duplicate genome intervals, keep the higher G
    (bwtsw2_core.c:159-184; khash value = idx<<32|G, ties keep stored)."""
    seen: dict[tuple[int, int], list[int]] = {}
    cells = u.cells
    for i, p in enumerate(cells):
        if p.ql == 0:
            continue
        key = (p.qk, p.ql)
        v = seen.get(key)
        j = -1
        if v is not None:
            # (uint32_t)stored_G >= p->G — both G > 0 here, plain compare
            if v[1] >= p.G:
                j = i
            else:
                j = v[0]
                seen[key] = [i, p.G]
        else:
            seen[key] = [i, p.G]
        if j >= 0:
            q = cells[j]
            q.qk = q.ql = 0
            q.G = 0
            if q.ppos >= 0:
                cells[q.ppos].cpos[q.pj] = -3


def merge_entry(u: Entry, v: Entry) -> None:
    """Append v's cells to u, fixing intra-entry links
    (bwtsw2_core.c:186-203)."""
    off = len(u.cells)
    for p in v.cells:
        if p.ppos >= 0:
            p.ppos += off
        cp = p.cpos
        for j in range(4):
            if cp[j] >= 0:
                cp[j] += off
    u.cells.extend(v.cells)
    v.cells = []


def save_hits(bwtl, thres: int, hits: list[Hit], u: Entry) -> None:
    """Top-2-per-read-position slot table (bwtsw2_core.c:223-245)."""
    sa = bwtl.sa
    for p in u.cells:
        if p.G < thres:
            continue
        for k in range(u.tk, u.tl + 1):
            beg = int(sa[k])
            end = beg + p.tlen
            q = None
            if p.G > hits[beg * 2].G:
                hits[beg * 2 + 1] = hits[beg * 2]
                q = hits[beg * 2] = Hit()
            elif p.G > hits[beg * 2 + 1].G:
                q = hits[beg * 2 + 1] = Hit()
            if q is not None:
                q.k = p.qk
                q.l = p.ql
                q.len = p.qlen
                q.G = p.G
                q.beg = beg
                q.end = end
                q.G2 = 0 if q.k == q.l else q.G
                q.flag = q.n_seeds = 0


def save_narrow_hits(bwtl, u: Entry, b1: list[Hit], t: int, IS: int) -> None:
    """High-score, low-occurrence node hits (bwtsw2_core.c:248-270)."""
    for p in u.cells:
        if p.G >= t and p.ql - p.qk + 1 <= IS:
            q = Hit()
            q.k = p.qk
            q.l = p.ql
            q.len = p.qlen
            q.G = p.G
            q.G2 = 0
            q.beg = int(bwtl.sa[u.tk])
            q.end = q.beg + p.tlen
            q.flag = 0
            b1.append(q)
            p.qk = p.ql = 0
            p.G = 0
            if p.ppos >= 0:
                u.cells[p.ppos].cpos[p.pj] = -3


# ---------------------------------------------------------- hit resolution

def resolve_duphits(hfm, sa_lookup, b: list[Hit], IS: int) -> list[Hit]:
    """bsw2_resolve_duphits (bwtsw2_core.c:273-347).  When hfm is given,
    narrow SA intervals are expanded into chromosomal coordinates via the
    batched device rank→position kernel (`sa_lookup`)."""
    if not b:
        return b
    if hfm is not None:
        ranks = []
        for p in b:
            if p.l - p.k + 1 <= IS:
                if p.G == 0 and p.k == 0 and p.l == 0 and p.len == 0:
                    continue
                ranks.extend(range(p.k, p.l + 1))
            elif p.G > 0:
                ranks.append(p.k)
        pos_all = sa_lookup(np.asarray(ranks, np.int64)) if ranks else []
        out: list[Hit] = []
        ri = 0
        for p in b:
            if p.l - p.k + 1 <= IS:
                if p.G == 0 and p.k == 0 and p.l == 0 and p.len == 0:
                    continue
                for _ in range(p.k, p.l + 1):
                    q = p.copy()
                    pos, is_rev = hfm.depos(int(pos_all[ri]))
                    ri += 1
                    q.k = pos
                    q.l = 0
                    q.is_rev = int(is_rev)
                    if is_rev:
                        q.k -= p.len - 1
                    out.append(q)
            elif p.G > 0:
                q = p.copy()
                pos, is_rev = hfm.depos(int(pos_all[ri]))
                ri += 1
                q.k = pos
                q.l = 0
                q.flag |= 1
                q.is_rev = int(is_rev)
                if is_rev:
                    q.k -= p.len - 1
                out.append(q)
        b = out
    b = [p for p in b if p.G]
    ks_introsort(b, hitG_lt)
    for i in range(1, len(b)):
        p = b[i]
        for j in range(i):
            q = b[j]
            compatible = True
            if p.is_rev != q.is_rev:
                continue
            if p.l == 0 and q.l == 0:
                qol = min(p.end, q.end) - max(p.beg, q.beg)
                if qol < 0:
                    qol = 0
                if qol / (p.end - p.beg) > MASK_LEVEL or \
                        qol / (q.end - q.beg) > MASK_LEVEL:
                    tol = (min(p.k + p.len, q.k + q.len)
                           - max(p.k, q.k))
                    if tol / p.len > MASK_LEVEL or \
                            tol / q.len > MASK_LEVEL:
                        compatible = False
            if not compatible:
                p.G = 0
                if q.G2 < p.G2:
                    q.G2 = p.G2
                break
    return [p for p in b if p.G]


def resolve_query_overlaps(b: list[Hit], mask_level: float, rng) -> list[Hit]:
    """bsw2_resolve_query_overlaps (bwtsw2_core.c:349-398)."""
    if not b:
        return b
    ks_introsort(b, hitG_lt)
    # choose a random top hit among ties (drand48 draw, :354-363)
    G0 = b[0].G
    i = 1
    while i < len(b) and b[i].G == G0:
        i += 1
    j = int(i * rng.drand())
    if j:
        b[0], b[j] = b[j], b[0]
    n = len(b)
    for i in range(1, len(b)):
        p = b[i]
        if p.G == 0:
            n = i
            break
        all_compatible = True
        for j in range(i):
            q = b[j]
            if q.G == 0:
                continue
            tol = 0
            qol = min(p.end, q.end) - max(p.beg, q.beg)
            if qol < 0:
                qol = 0
            if p.l == 0 and q.l == 0:
                tol = (min(p.k + p.len, q.k + q.len)
                       - max(p.k, q.k))
                if tol < 0:
                    tol = 0
            fol = qol / min(p.end - p.beg, q.end - q.beg)
            compatible = fol < mask_level or (
                tol > 0 and qol < p.end - p.beg and qol < q.end - q.beg)
            if not compatible:
                if q.G2 < p.G:
                    q.G2 = p.G
                all_compatible = False
        if not all_compatible:
            p.G = 0
    return [p for p in b[:n] if p.G]


# --------------------------------------------------------------- the core

def fill_cell(opt, match_score: int, x: Cell, cI: Cell | None,
              cD: Cell | None, cG: Cell | None) -> int:
    """bwtsw2_core.c:421-433."""
    G = cG.G + match_score if cG is not None else MINUS_INF
    if cI is not None:
        x.I = cI.I - opt.r if cI.I > cI.G - opt.q else cI.G - opt.qr
        if x.I > G:
            G = x.I
    else:
        x.I = MINUS_INF
    if cD is not None:
        x.D = cD.D - opt.r if cD.D > cD.G - opt.q else cD.G - opt.qr
        if x.D > G:
            G = x.D
    else:
        x.D = MINUS_INF
    x.G = G
    return G


def _fill_occ(hfm, cells: list[Cell]) -> None:
    """Batch genome occ4(qk-1)/occ4(ql) for cells lacking the cache."""
    need = [p for p in cells if p.ok is None and p.ql != 0]
    if not need:
        return
    km1 = np.fromiter((p.qk - 1 for p in need), np.int64, len(need))
    l = np.fromiter((p.ql for p in need), np.int64, len(need))
    ok, ol = hfm.occ4_pair(km1, l)
    for i, p in enumerate(need):
        p.ok = ok[i]
        p.ol = ol[i]


def bsw2_core(hfm, sa_lookup, opt, bwtl) -> tuple[list[Hit], list[Hit]]:
    """Full DAG traversal for one read.  Returns (all-hits, narrow-hits),
    both already resolved into chromosomal coordinates."""
    chash = connectivity(bwtl)
    L2g = hfm.L2

    stack0: list[Entry] = []
    pending: list[Entry | None] = []
    n_pending = 0

    # init (bwtsw2_core.c:435-447)
    u0 = Entry(0, bwtl.seq_len)
    x0 = Cell()
    x0.G = 0
    x0.qk = 0
    x0.ql = hfm.seq_len
    u0.cells.append(x0)
    stack0.append(u0)

    z = opt.z
    slot_hits: list[Hit] = [Hit() for _ in range(bwtl.seq_len * 2)]
    b1: list[Hit] = []

    while stack0 or n_pending:
        v = stack0.pop()
        old_n = len(v.cells)

        for p in v.cells:  # band test (:488-495)
            if p.ql == 0:
                continue
            if p.tlen - p.qlen > opt.bw or p.qlen - p.tlen > opt.bw:
                p.qk = p.ql = 0
                if p.ppos >= 0:
                    v.cells[p.ppos].cpos[p.pj] = -5

        tcntk, tcntl = bwtl.occ4_pair(v.tk - 1, v.tl)
        _fill_occ(hfm, v.cells)
        for tj in range(4):
            k = int(bwtl.L2[tj] + tcntk[tj] + 1)
            l = int(bwtl.L2[tj] + tcntl[tj])
            if k > l:
                continue
            hv = chash[(k, l)]
            hv[1] -= 1
            u = Entry(k, l)
            top = [0] * z               # z-best heap of G (:514)
            match_a, mismatch_b = opt.a, -opt.b

            i = 0
            cells = v.cells
            while i < len(cells):
                p = cells[i]
                if p.ql == 0:
                    i += 1
                    continue
                x = Cell()
                is_added = False
                p.upos = -1
                if p.ppos >= 0:
                    par = cells[p.ppos]
                    cI = u.cells[par.upos] if par.upos >= 0 else None
                    ms = match_a if tj == p.pj else mismatch_b
                    if fill_cell(opt, ms, x, cI, p, par) > 0:
                        x.ppos = par.upos
                        p.upos = len(u.cells)
                        if x.ppos >= 0:
                            u.cells[x.ppos].cpos[p.pj] = p.upos
                        u.cells.append(x)
                        is_added = True
                else:
                    x.D = p.D - opt.r if p.D > p.G - opt.q else p.G - opt.qr
                    if x.D > 0:
                        x.G = x.D
                        x.I = MINUS_INF
                        x.ppos = -1
                        p.upos = len(u.cells)
                        u.cells.append(x)
                        is_added = True
                if is_added:
                    x.cpos = [-1, -1, -1, -1]
                    x.pj = p.pj
                    x.qk = p.qk
                    x.ql = p.ql
                    x.qlen = p.qlen
                    x.tlen = p.tlen + 1
                    m = min(top)
                    if x.G > m:
                        top[top.index(m)] = x.G
                if (x.G > opt.qr and x.G >= min(top)) or i < old_n:
                    cp = p.cpos
                    if -1 in cp:
                        if p.ok is None:
                            _fill_occ(hfm, cells[i:])
                        qcntk, qcntl = p.ok, p.ol
                        for qj in range(4):
                            if cp[qj] != -1:
                                continue
                            kq = int(L2g[qj] + qcntk[qj] + 1)
                            lq = int(L2g[qj] + qcntl[qj])
                            if kq > lq:
                                cp[qj] = -2
                                continue
                            y = Cell()
                            y.qk = kq
                            y.ql = lq
                            y.pj = qj
                            y.qlen = p.qlen + 1
                            y.ppos = i
                            y.tlen = p.tlen
                            cp[qj] = len(cells)
                            cells.append(y)
                i += 1
            if u.cells:
                save_hits(bwtl, opt.t, slot_hits, u)
            # push u (or merge into pending), :568-601
            pos, cnt = hv
            if pos:
                w = pending[pos - 1]
                if u.cells:
                    if len(w.cells) < len(u.cells):
                        w, u = u, w
                        pending[pos - 1] = w
                    merge_entry(w, u)
                if cnt == 0:
                    remove_duplicate(w)
                    save_narrow_hits(bwtl, w, b1, opt.t, opt.is_)
                    cut_tail(w, z)
                    stack0.append(w)
                    pending[pos - 1] = None
                    n_pending -= 1
            elif cnt:
                if u.cells:
                    n_pending += 1
                    pending.append(u)
                    hv[0] = len(pending)
            else:
                save_narrow_hits(bwtl, u, b1, opt.t, opt.is_)
                cut_tail(u, z)
                stack0.append(u)

    for h in slot_hits:
        h.n_seeds = 0
    for h in b1:
        h.n_seeds = 0
    b0 = resolve_duphits(hfm, sa_lookup, slot_hits, opt.is_)
    b1 = resolve_duphits(hfm, sa_lookup, b1, opt.is_)
    return b0, b1
