"""Seed grids for CHAIN (ops/chain.chain_seeds) and the sequential
mem_chain they are held against, in NumPy alone.

`seq_chain` is mem_chain's seed loop with test_and_merge
(bwamem.c:197-307) written straight from the C in Python integers, read
by read, with the port's fixed-width conventions: at most C chains a read
(a seed that would open one more sets the read's overflow flag), the
lookup's tie to the later-created chain, is_alt from the contig table at
max(rid, 0), unused chain slots filled as the lockstep loop fills them.

`CASES` are crafted grids, one behaviour each (`EXPECT` the seed_chain
rows they are built to give); `case(name, itype)` makes one for an index
type.  `heavy_grid` is a random grid at the main path's shapes with a
heavy-tailed seed count a row.  tests/test_torch_chain_seq.py and
chip_smoke.py's phase_chain use them.  Imports neither package.
"""
from __future__ import annotations

import numpy as np

FIELDS = ("pos", "rid", "is_alt", "first_qbeg", "first_rbeg", "last_qbeg",
          "last_rbeg", "last_len", "n_seeds", "n", "seed_chain", "overflow")
W, GAP, L_PAC = 100, 10_000, 1_000_000
# added to every position and to l_pac for the int64 index: the positions
# pass 32 bits there
HI = 1 << 33


# ---------------------------------------------------------------- the C

def _test_and_merge(c, rb, qb, ln, rid, l_pac, w, gap):
    """test_and_merge (bwamem.c:52-73): 0 no merge (a new chain is
    requested), 1 contained (merged, nothing appended), 2 appended."""
    first, last = c["seeds"][0], c["seeds"][-1]
    qend = last[1] + last[2]
    rend = last[0] + last[2]
    if rid != c["rid"]:
        return 0
    if (qb >= first[1] and qb + ln <= qend and rb >= first[0]
            and rb + ln <= rend):
        return 1
    if (last[0] < l_pac or first[0] < l_pac) and rb >= l_pac:
        return 0
    x = qb - last[1]
    y = rb - last[0]
    if (y >= 0 and x - y <= w and y - x <= w and x - last[2] < gap
            and y - last[2] < gap):
        c["seeds"].append((rb, qb, ln))
        return 2
    return 0


def seq_chain(rbeg, qbeg, slen, rid, valid, alt_of, *, l_pac, w, gap, C,
              it):
    """mem_chain's loop (bwamem.c:280-307) over each read's valid seeds
    in slot order; returns the Chains fields as NumPy arrays."""
    N, S = rbeg.shape
    out = dict(pos=np.full((N, C), np.iinfo(it).max, it),
               rid=np.full((N, C), -1, np.int32),
               is_alt=np.zeros((N, C), bool),
               first_qbeg=np.zeros((N, C), np.int32),
               first_rbeg=np.zeros((N, C), it),
               last_qbeg=np.zeros((N, C), np.int32),
               last_rbeg=np.zeros((N, C), it),
               last_len=np.zeros((N, C), np.int32),
               n_seeds=np.zeros((N, C), np.int32),
               n=np.zeros(N, np.int32),
               seed_chain=np.full((N, S), -1, np.int32),
               overflow=np.zeros(N, bool))
    for i in range(N):
        chains = []
        for s in range(S):
            if not valid[i, s]:
                continue
            rb, qb, ln, r = (int(rbeg[i, s]), int(qbeg[i, s]),
                             int(slen[i, s]), int(rid[i, s]))
            # kb_intervalp's lower: the largest pos <= rb, the later chain
            # on equal keys
            lower = None
            for j, c in enumerate(chains):
                if c["pos"] <= rb and (lower is None
                                       or c["pos"] >= chains[lower]["pos"]):
                    lower = j
            m = 0 if lower is None else _test_and_merge(
                chains[lower], rb, qb, ln, r, l_pac, w, gap)
            if m == 2:
                out["seed_chain"][i, s] = lower
            elif m == 0:
                if len(chains) < C:
                    out["seed_chain"][i, s] = len(chains)
                    chains.append(dict(pos=rb, rid=r, seeds=[(rb, qb, ln)],
                                       alt=bool(alt_of[max(r, 0)] > 0)))
                else:
                    out["overflow"][i] = True
        out["n"][i] = len(chains)
        for j, c in enumerate(chains):
            (fr, fq, _), (lr, lq, ll) = c["seeds"][0], c["seeds"][-1]
            for k, v in (("pos", c["pos"]), ("rid", c["rid"]),
                         ("is_alt", c["alt"]), ("first_qbeg", fq),
                         ("first_rbeg", fr), ("last_qbeg", lq),
                         ("last_rbeg", lr), ("last_len", ll),
                         ("n_seeds", len(c["seeds"]))):
                out[k][i, j] = v
    return out


# ---------------------------------------------------------------- cases

def _row(*seeds):
    return list(seeds)


def _grid(rows, S=None, seed=0):
    """[N, S] grids from rows of (rbeg, qbeg, len, rid) seeds, None an
    invalid slot holding random values (a rid inside every case's contig
    table: the plain loop looks the table up on every slot)."""
    rng = np.random.default_rng(seed)
    S = S or max(1, max(len(r) for r in rows))
    N = len(rows)
    rbeg = rng.integers(-5, 1 << 30, (N, S)).astype(np.int64)
    qbeg = rng.integers(-5, 1 << 20, (N, S)).astype(np.int32)
    slen = rng.integers(-5, 1 << 10, (N, S)).astype(np.int32)
    rid = rng.integers(-2, 2, (N, S)).astype(np.int32)
    valid = np.zeros((N, S), bool)
    for i, row in enumerate(rows):
        for s, sd in enumerate(row):
            if sd is not None:
                rbeg[i, s], qbeg[i, s], slen[i, s], rid[i, s] = sd
                valid[i, s] = True
    return rbeg, qbeg, slen, rid, valid


def _random(n_rows, S, *, seed, heavy):
    """Rows of seeds along a few diagonals (so seeds merge, contain one
    another and open chains), a heavy-tailed count a row, invalid slots
    between them and some rid -1 seeds."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_rows):
        k = int(min(S, rng.pareto(1.2) * 4)) if heavy else rng.integers(
            0, S + 1)
        row = [None] * S
        slots = np.sort(rng.choice(S, k, replace=False))
        diags = rng.integers(0, 40_000, rng.integers(1, 6))
        q = 0
        for s in slots:
            d = int(rng.choice(diags)) + int(rng.integers(-3, 4)) * 40
            q = (q + int(rng.integers(-10, 30))) % 150
            ln = int(rng.integers(10, 40))
            rb = d + q + (L_PAC - 20_000 if rng.random() < 0.05 else 0)
            r = int(rng.choice([0, 0, 0, 1, 2, -1]))
            row[s] = (rb, q, ln, r)
        rows.append(row)
    return rows


def _cases():
    """name -> (rows, S or None, C, dict of w, gap, alt_of)."""
    alt = [0, 1, 0]
    c = {}
    # equal pos: the later-created chain is the lower one
    c["ties"] = ([
        _row((1000, 0, 20, 0), (1000, 0, 20, 1), (1030, 30, 20, 1)),
        _row((1000, 0, 20, 1), (1000, 5, 20, 0), (1000, 9, 20, 2),
             (1025, 30, 20, 2), (1025, 31, 20, 0)),
    ], None, 8, {})
    # contained seeds merge and append nothing
    c["contained"] = ([
        _row((1000, 10, 30, 0), (1005, 15, 10, 0), (1040, 50, 20, 0),
             (1000, 10, 30, 0), (1045, 55, 15, 0)),
    ], None, 8, {})
    # a seed that crosses l_pac after a forward-strand chain, then one that
    # grows the reverse-strand chain
    c["strand"] = ([
        _row((L_PAC - 20, 0, 15, 0), (L_PAC, 20, 15, 0),
             (L_PAC + 30, 50, 15, 0)),
        _row((L_PAC + 10, 0, 15, 0), (L_PAC + 40, 30, 15, 0)),
    ], None, 8, {})
    # x - y and y - x at w and one past it; y = -1
    c["w_edge"] = ([
        _row((1000, 0, 10, 0), (1020, 25, 10, 0)),
        _row((1000, 0, 10, 0), (1020, 26, 10, 0)),
        _row((1000, 0, 10, 0), (1025, 20, 10, 0)),
        _row((1000, 0, 10, 0), (1026, 20, 10, 0)),
        _row((1000, 0, 10, 0), (1040, 40, 10, 0), (1039, 60, 10, 0)),
    ], None, 8, dict(w=5))
    # x - len and y - len at max_chain_gap - 1 and at it
    c["gap_edge"] = ([
        _row((1000, 0, 10, 0), (1039, 39, 10, 0)),
        _row((1000, 0, 10, 0), (1040, 40, 10, 0)),
        _row((1000, 0, 10, 0), (1039, 40, 10, 0)),
    ], None, 8, dict(gap=30, w=100))
    # the table full at n == C: overflow, merges into full tables go on
    c["overflow"] = ([
        _row((1000, 0, 20, 0), (5000, 0, 20, 0), (9000, 0, 20, 0),
             (1030, 30, 20, 0), (20_000, 0, 20, 0), (5030, 30, 20, 0)),
        _row((1000, 0, 20, 0), (5000, 0, 20, 0)),
    ], None, 2, {})
    # invalid slots between valid ones, across the 32-slot chunks
    gaps = [None] * 70
    for s, sd in ((0, (1000, 0, 20, 0)), (31, (1030, 30, 20, 0)),
                  (32, (9000, 0, 20, 0)), (33, (1060, 60, 20, 0)),
                  (50, (9025, 25, 20, 0)), (69, (1090, 90, 20, 0))):
        gaps[s] = sd
    c["gaps"] = ([gaps, [None] * 70, [None] * 69 + [(500, 0, 30, 1)]],
                 70, 8, {})
    # alt contigs
    c["alt"] = ([
        _row((1000, 0, 20, 1), (1030, 30, 20, 1), (3000, 0, 20, 2),
             (5000, 0, 20, 0)),
    ], None, 8, dict(alt_of=alt))
    # rid -1 seeds: their own chains, is_alt from the table's first entry
    c["rid_neg"] = ([
        _row((1000, 0, 20, -1), (1030, 30, 20, -1), (1060, 60, 20, 0),
             (1090, 90, 20, -1)),
    ], None, 8, dict(alt_of=[1, 0]))
    # over 32 chains in a row (the lookup's lanes each hold several):
    # chains 60 and 61 share their keys with chains 28 and 29, in the same
    # lanes, and the next two seeds must join 60 and 61
    rng = np.random.default_rng(7)
    pos = [100_000 + 500 * int(k) for k in rng.permutation(60)]
    many = [(p, 0, 20, 0) for p in pos]
    many += [(pos[28], 3, 20, 1), (pos[29], 3, 20, 2),
             (pos[28] + 30, 33, 20, 1), (pos[29] + 30, 33, 20, 2)]
    many += [(100_000 + 500 * int(k) + 30, 30, 20, int(r))
             for k, r in zip(rng.integers(0, 60, 40),
                             rng.integers(0, 3, 40))]
    c["many_chains"] = ([many, many[::-1]], None, 80, {})
    c["empty"] = ([[None] * 5, [None] * 5], 5, 4, {})
    c["random"] = (_random(48, 64, seed=11, heavy=False), 64, 64, {})
    c["random_heavy"] = (_random(64, 96, seed=12, heavy=True), 96, 24, {})
    return c


CASES = _cases()
# the seed_chain rows the crafted cases are built to give
EXPECT = {"ties": [[0, 1, 1], [0, 1, 2, 2, 3]],
          "contained": [[0, -1, 0, -1, -1]],
          "strand": [[0, 1, 1], [0, 0]],
          "w_edge": [[0, 0], [0, 1], [0, 0], [0, 1], [0, 0, 1]],
          "gap_edge": [[0, 0], [0, 1], [0, 1]],
          "overflow": [[0, 1, -1, 0, -1, 1], [0, 1]],
          "rid_neg": [[0, 0, 1, 2]],
          "many_chains": [list(range(60)) + [60, 61, 60, 61]]}
ITYPES = {"int32": np.int32, "int64": np.int64}


def case(name, itype):
    rows, S, C, kw = CASES[name]
    it = ITYPES[itype]
    rbeg, qbeg, slen, rid, valid = _grid(rows, S)
    hi = HI if it == np.int64 else 0
    rbeg = np.where(valid, rbeg + hi, rbeg).astype(it)
    alt_of = np.asarray(kw.get("alt_of", [0, 0, 0]), np.int32)
    p = dict(l_pac=L_PAC + hi, w=kw.get("w", W), gap=kw.get("gap", GAP),
             C=C)
    want = seq_chain(rbeg, qbeg, slen, rid, valid, alt_of, it=it, **p)
    return (rbeg, qbeg, slen, rid, valid), alt_of, p, want


def heavy_grid(N, S, *, seed, itype, l_pac, n_ctg=4):
    """[N, S] seed grids shaped like the device front's at a grown seed
    cap: half the rows empty (the padding of a batch to a power of two),
    most others 0-60 seeds along up to 8 diagonals, about 3 rows in 1000
    600-1000 seeds (S / 2 to S where S is under 1000) at scattered
    positions (a repeat read: nearly every
    seed opens a chain), 3 % of the slots below a row's count invalid.
    Returns (rbeg, qbeg, len, rid, valid) and the contig alt table."""
    rng = np.random.default_rng(seed)
    count = np.where(rng.random(N) < 0.5, 0, rng.integers(0, 61, N))
    big = rng.random(N) < 0.003
    count = np.where(big, rng.integers(min(600, S // 2), min(S, 1000) + 1,
                                       N), count)
    slots = np.arange(S)[None, :]
    valid = (slots < count[:, None]) & (rng.random((N, S)) > 0.03)
    ndiag = rng.integers(1, 9, N)[:, None]
    base = rng.integers(0, 2 * l_pac - 200_000, (N, 8))
    d = rng.integers(0, 8, (N, S)) % ndiag
    qbeg = ((slots * 5 + rng.integers(0, 20, (N, S))) % 140).astype(np.int32)
    rbeg = (np.take_along_axis(base, d, 1) + qbeg
            + rng.integers(-2, 3, (N, S)) * 40)
    scatter = rng.integers(0, 2 * l_pac - 200, (N, S))
    rbeg = np.where(big[:, None], scatter, rbeg)
    rbeg = np.where(valid, rbeg, 0).astype(itype)
    slen = np.where(valid, rng.integers(19, 41, (N, S)), 0).astype(np.int32)
    rid = np.where(valid, rng.integers(0, n_ctg, (N, S)), -1).astype(
        np.int32)
    qbeg = np.where(valid, qbeg, 0).astype(np.int32)
    alt_of = (np.arange(n_ctg) == n_ctg - 1).astype(np.int32)
    return (rbeg, qbeg, slen, rid, valid), alt_of
