"""Lanes for the extension kernels' group step (csrc/ext_kernel.cu) that
the gen_cases corpora never reach, and a scalar trace of ksw_extend2 that
shows each set reaches what it is for.

`trace` runs one lane as ksw.c:380-479 does (the eh row in a list, every
cell in order) and records what the group step has to get right: the
columns stored (how often a ring of R columns wraps), rows whose window
end grows by 2 and reads a column never stored (its first-row value),
the chunk counts a row's window takes at each G, rows with a new max
reached at two columns that one thread of a group holds (a multiple of G
apart), and why the pass stopped."""
from __future__ import annotations

import numpy as np

GROUPS = (8, 16, 32)


def clamp_w(w, qlen, eb, max_mat, o_del, e_del, o_ins, e_ins):
    """ksw.c:399-407 (ops/extend._adjust_w for one lane)."""
    max_ins = max(int((qlen * max_mat + eb - o_ins) / e_ins + 1.0), 1)
    max_del = max(int((qlen * max_mat + eb - o_del) / e_del + 1.0), 1)
    return min(w, max_ins, max_del)


def trace(q, t, h0, w, eb, mat, *, o_del, e_del, o_ins, e_ins, zdrop,
          t_max=None):
    """Events of one ksw_extend2 pass: dict with `hi` (highest column
    stored), `grow2_fresh` (rows whose end grew by 2 and read a column
    never stored), `chunks` ({G: set of chunk counts of the rows}),
    `ties` ({G: rows of a new max reached at two columns of one thread,
    in different chunks}), `tie_at_max` ({G: whether the row that set the
    final max_j was one}), `stop`
    ("m0", "zdrop" or None) and `score`, `qle`, `tle`."""
    mat = np.asarray(mat).reshape(5, 5)
    qlen = len(q)
    rows = len(t) if t_max is None else min(len(t), t_max)
    w = clamp_w(w, qlen, eb, int(mat.max()), o_del, e_del, o_ins, e_ins)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    H = [h0] + [max(h0 - oe_ins - (j - 1) * e_ins, 0)
                for j in range(1, qlen + 1)]
    E = [0] * (qlen + 1)
    hi, beg, end = 0, 0, qlen
    mx, max_i, max_j = h0, -1, -1
    ev = dict(grow2_fresh=0, chunks={g: set() for g in GROUPS},
              ties={g: 0 for g in GROUPS}, tie_at_max={}, stop=None)
    prev_end = None
    for i in range(rows):
        srow = mat[min(int(t[i]), 4)]
        beg = max(beg, i - w)
        end = min(end, i + w + 1, qlen)
        if i and prev_end is not None and end == prev_end + 2 and \
                end - 1 > hi and beg < end:
            ev["grow2_fresh"] += 1
        for g in GROUPS:
            if beg < end:
                ev["chunks"][g].add(-(-(end - beg) // g))
        h1 = max(h0 - (o_del + e_del * (i + 1)), 0) if beg == 0 else 0
        f, m, mj = 0, 0, -1
        hs = []
        for j in range(beg, end):
            M, e = H[j], E[j]
            H[j] = h1
            M = M + int(srow[min(int(q[j]), 4)]) if M else 0
            h = max(M, e, f)
            h1 = h
            hs.append(h)
            mj = mj if m > h else j
            m = max(m, h)
            E[j] = max(e - e_del, max(M - oe_del, 0))
            f = max(f - e_ins, max(M - oe_ins, 0))
        H[end] = h1
        E[end] = 0
        hi = max(hi, end)
        if m == 0:
            ev["stop"] = "m0"
            break
        if m > mx:
            at = [beg + k for k, h in enumerate(hs) if h == m]
            for g in GROUPS:
                # the thread of the last column reaching m holds an
                # earlier one too (g columns or a multiple apart)
                tie = any((at[-1] - j) % g == 0 for j in at[:-1])
                ev["ties"][g] += tie
                ev["tie_at_max"][g] = tie
            mx, max_i, max_j = m, i, mj
        elif zdrop > 0:
            di, dj = i - max_i, mj - max_j
            drop = mx - m - ((di - dj) * e_del if di > dj
                             else (dj - di) * e_ins)
            if drop > zdrop:
                ev["stop"] = "zdrop"
                break
        j = beg
        while j < end and H[j] == 0 and E[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and H[j] == 0 and E[j] == 0:
            j -= 1
        prev_end = end
        end = min(j + 2, qlen)
    ev.update(hi=hi, score=mx, qle=max_j + 1, tle=max_i + 1)
    return ev


def block(cases, pad=1):
    """[(query, target, h0, w, end_bonus)] -> (qT, tT, qlen, tlen, h0, eb,
    LQ, Tm) and the band vector, as test_torch_ext._lanes lays them out,
    with `pad` padding lanes (qlen = tlen = 0, h0 = 1, w 1) at the end."""
    B = len(cases) + pad
    LQ = max(len(c[0]) for c in cases)
    Tm = max(len(c[1]) for c in cases)
    qT = np.full((LQ, B), 4, np.int32)
    tT = np.full((Tm, B), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    h0 = np.ones(B, np.int32)
    eb = np.zeros(B, np.int32)
    w = np.ones(B, np.int32)
    for b, (q, t, h, wb, e) in enumerate(cases):
        qT[:len(q), b] = q
        tT[:len(t), b] = t
        qlen[b], tlen[b], h0[b], w[b], eb[b] = len(q), len(t), h, wb, e
    return (qT, tT, qlen, tlen, h0, eb, LQ, Tm), w


def _mutate(rng, q, sub=0.02, indels=3, max_indel=4):
    """A copy of q with substitutions and a few short indels."""
    m = q.copy()
    s = rng.random(len(m)) < sub
    m[s] = rng.integers(0, 4, int(s.sum()))
    for _ in range(indels):
        at = int(rng.integers(50, len(m) - 50))
        n = int(rng.integers(1, max_indel + 1))
        if rng.random() < 0.5:
            m = np.concatenate([m[:at], rng.integers(0, 4, n), m[at:]])
        else:
            m = np.concatenate([m[:at], m[at + n:]])
    return m


def ring_wrap_cases(seed=31, n=6):
    """Queries of 1500-3000 bases against a mutated copy at bands 5-20:
    the extension runs the whole diagonal, so the highest column stored
    passes the ring's R (32-64) dozens of times."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        q = rng.integers(0, 4, int(rng.integers(1500, 3001)))
        t = np.concatenate([_mutate(rng, q), rng.integers(0, 4, 40)])
        out.append((q, t, int(rng.integers(20, 60)), 5 + 3 * k, 5))
    return out


def grow_cases(seed=37, n=6):
    """Exact copies at a band past what h0 reaches in the first row: the
    first row's nonzero cells end near h0 - 6, the shrink pulls `end` in,
    and it then grows by 2 a row past every column stored so far."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = rng.integers(0, 4, int(rng.integers(200, 400)))
        t = q[:int(rng.integers(150, len(q)))].copy()
        out.append((q, t, int(rng.integers(25, 60)), 100, 5))
    return out


def break_cases(seed=41, n=8):
    """Lanes that stop on m == 0 (an unrelated target, a small h0) and on
    the z-drop (a match, then an unrelated tail), windows 60-300 wide, so
    a row's chunk count changes as the window grows and shrinks."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        q = rng.integers(0, 4, int(rng.integers(150, 400)))
        if k % 2 == 0:
            t = rng.integers(0, 4, int(rng.integers(100, 300)))
            h0 = int(rng.integers(3, 12))
        else:
            cut = int(rng.integers(60, len(q) - 40))
            t = np.concatenate([_mutate(rng, q[:cut], indels=0),
                                rng.integers(0, 4, 300)])
            h0 = int(rng.integers(20, 80))
        out.append((q, t, h0, int(rng.integers(30, 150)), 5))
    return out


# the tie cases' scoring: match 1, mismatch -1, gaps 0 + 1 a base, so an
# insertion of P bases costs what P / 2 mismatches do
TIE_SCORE = dict(a=1, b=1, o_del=0, e_del=1, o_ins=0, e_ins=1, zdrop=100)


def tie_cases(seed=43, n=8):
    """Lanes whose final max_j comes from a row where the max is reached at
    two columns P apart (P = 32 or 64: one thread of a group holds both at
    every G), so qle is right only if mj is the later of them.  Drawn
    from a construction and kept when the trace shows that: the target
    repeats a unit of P bases with about P / 4 defects, the query is its
    first P bases, then the whole target.  The diagonal P to the right
    pays the P-base insertion once and matches throughout; the main
    diagonal mismatches at each defect and P rows after it, and past the
    last defect the two gain 1 a row, at the same score when the costs
    balance."""
    from bwamem_tpu.config import fill_scmat
    sc = dict(TIE_SCORE)
    mat = np.asarray(fill_scmat(sc.pop("a"), sc.pop("b")), np.int8)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(400):
        P = (32, 64)[len(out) % 2]
        n_t = int(rng.integers(3 * P + 20, 3 * P + 120))
        t = np.tile(rng.integers(0, 4, P), -(-n_t // P))[:n_t]
        d = P // 4 + int(rng.integers(-1, 2))
        at = rng.choice(np.arange(P, n_t - P - 10), d, replace=False)
        t[at] = (t[at] + rng.integers(1, 4, len(at))) % 4
        q = np.concatenate([t[:P], t])
        case = (q, t, int(rng.integers(P + 10, 2 * P)), 100, 5)
        if trace(*case[:4], 5, mat, **sc)["tie_at_max"].get(32):
            out.append(case)
            if len(out) == n:
                return out
    raise AssertionError(f"only {len(out)} tie lanes found")
