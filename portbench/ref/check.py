"""The comparison that decides `correct`, from SAM text.

Every read of the window must have exactly one primary record (FLAG has
neither 0x100 nor 0x800), with its name and, for pairs, its mate bit.  A
sample of the reads, drawn from the run's seed, is then judged field by
field against the genome, with ref.sw's alignments of the read in a window
around the record's place and around the place the read came from:

- seq_off: SEQ is the read, reverse-complemented where FLAG has 0x10
  (so a strand bit flipped alone fails here).
- nm_md_off: NM and MD are those of the CIGAR at POS (SAM's definitions,
  as BWA-MEM writes MD).
- mapq_over: MAPQ lies in 0..60, is 0 on an unmapped record, and is at
  most what BWA-MEM's mem_approx_mapq_se gives from the record's own AS,
  XS and CIGAR with no sub-optimal hits and no repeat share (those two
  only lower it): the bound holds for every single-end record and for a
  mate without the proper-pair bit (bwa's unpaired path); a properly
  paired mate may gain up to 40 from the pair, so only the range is
  held there.
- as_off: AS is the best local score of SEQ in the window around the
  record (BWA-MEM's AS is its extension's best score, both ends free).
- cigar_off: the CIGAR's score is the score BWA-MEM's clipping rule keeps
  there (an end is clipped only where that gains more than pen_clip).
- misplaced: AS is below the best local score at the read's origin: a
  better place was missed (seeding, chaining, extension).
- mate_off (pairs): FLAG's pair bits, RNEXT, PNEXT and TLEN agree with the
  mate's record as BWA-MEM sets them.
- missing: reads with no record or not exactly one primary one.
Windows may hold N (scored -1 against anything, as BWA-MEM's matrix
does); the index holds random bases there, so a read aligned over an N
fails nm_md_off, as it should: no read comes from an N.  MAPQ's exact
value and XS rest on every other place of the genome: MAPQ is held to
its bound, XS enters only that bound.
"""
from __future__ import annotations

import math

import numpy as np

from portbench.ref import sw

NT4 = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    NT4[_c] = _i
LETTERS = "ACGTN"
LETTER_CODES = np.frombuffer(LETTERS.encode(), np.uint8)
WINDOW_PAD = 16
# bwa mem's mapQ_coef_len and its int mapQ_coef_fac, (int)log(50)
MAPQ_COEF_LEN = 50
MAPQ_COEF_FAC = 3


def parse(line: str) -> dict:
    f = line.split("\t")
    tags = {}
    for t in f[11:]:
        k, typ, v = t.split(":", 2)
        tags[k] = int(v) if typ == "i" else v
    return dict(qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]),
                mapq=int(f[4]), cigar=f[5], rnext=f[6], pnext=int(f[7]),
                tlen=int(f[8]), seq=f[9], tags=tags)


def cigar_ops(cigar: str) -> list[tuple[int, str]]:
    ops, n = [], 0
    for ch in cigar:
        if ch.isdigit():
            n = n * 10 + ord(ch) - 48
        else:
            ops.append((n, ch))
            n = 0
    return ops


def ref_len(ops) -> int:
    return sum(n for n, op in ops if op in "MDN=X")


def clips(ops) -> tuple[int, int]:
    left = ops[0][0] if ops and ops[0][1] in "SH" else 0
    right = ops[-1][0] if len(ops) > 1 and ops[-1][1] in "SH" else 0
    return left, right


def walk(ops, q: np.ndarray, g: np.ndarray, sc: dict):
    """(NM, MD, score) of the alignment `ops` of q against g, which starts
    at the alignment's first reference base."""
    qi = ri = nm = score = 0
    md, run = [], 0
    a, b = int(sc["a"]), int(sc["b"])
    for n, op in ops:
        if op in "SH":
            qi += n if op == "S" else 0
        elif op in "M=X":
            qs, gs = q[qi:qi + n], g[ri:ri + n]
            same = (qs == gs) & (qs < 4)
            amb = (qs == 4) | (gs == 4)
            score += int(a * same.sum() - b * (~same & ~amb).sum()
                         - amb.sum())
            prev = 0
            for k in np.flatnonzero(~same):
                run += int(k) - prev
                md.append(f"{run}{LETTERS[gs[k]]}")
                run, prev = 0, int(k) + 1
            run += n - prev
            nm += int((~same).sum())
            qi += n
            ri += n
        elif op == "I":
            score -= int(sc["o_ins"]) + n * int(sc["e_ins"])
            nm += n
            qi += n
        elif op == "D":
            score -= int(sc["o_del"]) + n * int(sc["e_del"])
            md.append(f"{run}^" + "".join(LETTERS[x] for x in g[ri:ri + n]))
            run = 0
            nm += n
            ri += n
    md.append(str(run))
    return nm, "".join(md), score


def mapq_bound(score: int, xs: int, ops, sc: dict) -> int:
    """bwa's mem_approx_mapq_se at sub_n = 0 and frac_rep = 0, from AS,
    XS (max of sub and csub) and the CIGAR's query and reference spans."""
    a, b = int(sc["a"]), int(sc["b"])
    sub = max(xs, int(sc["min_seed_len"]) * a)
    if sub >= score:
        return 0
    span = max(sum(n for n, op in ops if op in "MI=X"), ref_len(ops))
    identity = 1. - (span * a - score) / (a + b) / span
    tmp = 1. if span < MAPQ_COEF_LEN else MAPQ_COEF_FAC / math.log(span)
    tmp *= identity * identity
    mapq = int(6.02 * (score - sub) / a * tmp * tmp + .499)
    return min(max(mapq, 0), 60)


def mapq_ok(r: dict, sc: dict, paired: bool) -> bool:
    q = r["mapq"]
    if r["flag"] & 4:
        return q == 0
    if not 0 <= q <= 60:
        return False
    if paired and r["flag"] & 2:
        return True
    score = r["tags"].get("AS")
    if score is None:
        return False
    return q <= mapq_bound(int(score), int(r["tags"].get("XS", 0)),
                           cigar_ops(r["cigar"]), sc)


def _primaries(text: str) -> list[dict]:
    return [parse(ln) for ln in text.split("\n")
            if ln and not int(ln.split("\t", 2)[1]) & 0x900]


def presence(sams: list[list[str]], names: list[list[str]],
             paired: bool) -> tuple[int, list[list[dict | None]]]:
    """(reads failing, primary record of every read or None)."""
    bad = 0
    prim = []
    for texts, nms in zip(sams, names):
        got = []
        if len(texts) != len(nms):
            bad += len(nms)
            prim.append([None] * len(nms))
            continue
        for i, (t, nm) in enumerate(zip(texts, nms)):
            try:
                ps = _primaries(t)
            except (ValueError, IndexError):
                ps = []
            ok = (len(ps) == 1 and ps[0]["qname"] == nm
                  and (not paired or ps[0]["flag"] & (0x40 << (i & 1))))
            bad += not ok
            got.append(ps[0] if ok else None)
        prim.append(got)
    return bad, prim


def _window(genome, ctg: int, start: int, end: int, width: int):
    """Codes of [start, end) of contig ctg, clipped to it, padded with
    sw.PAD to `width`."""
    s = max(0, start)
    e = min(int(genome.lens[ctg]), end)
    off = int(genome.offsets[ctg])
    w = np.full(width, sw.PAD, np.uint8)
    seg = genome.codes[off + s: off + e][:width]
    w[:len(seg)] = seg
    return w


def mate_ok(r: dict, m: dict) -> bool:
    """BWA-MEM's pair fields of r against its mate's record m."""
    f, g = r["flag"], m["flag"]
    if not (f & 1 and g & 1) or bool(f & 2) != bool(g & 2):
        return False
    if bool(f & 0x20) != bool(g & 0x10) or bool(f & 8) != bool(g & 4):
        return False
    rnext = m["rname"] if (m["rname"] != r["rname"] or r["rname"] == "*") \
        else "="
    if r["rnext"] != rnext or r["pnext"] != m["pos"]:
        return False
    if f & 4 or g & 4 or r["rname"] != m["rname"] or r["rname"] == "*":
        return r["tlen"] == 0

    def end5(x):
        ln = ref_len(cigar_ops(x["cigar"]))
        return x["pos"] - 1 + (ln - 1 if x["flag"] & 0x10 else 0)
    p0, p1 = end5(r), end5(m)
    return r["tlen"] == -(p0 - p1 + (p0 > p1) - (p0 < p1))


def judge(sams, batches, names, genome, sc: dict, paired: bool,
          sample: np.ndarray, control: str | None = None) -> dict:
    """The numbers compared, from the window's SAM (`sams`: per batch, one
    text a read), its batches (origins) and the sample (global read
    indices; both mates of a pair are in it).  `control`: "local" or
    "int8" puts the reference's own score, without the clipping rule or
    in int8 cells, in AS (the control); None judges the program."""
    missing, prim = presence(sams, names, paired)
    flat = [r for b in prim for r in b]
    firsts = np.array([b.first for b in batches] + [len(flat)])
    ctg_of = {n: i for i, n in enumerate(genome.names)}
    L = batches[0].seqs.shape[1]
    width = L + 2 * WINDOW_PAD + 64
    q, t, got, cig, mapped, lane_o, lane_p = [], [], [], [], [], [], []
    nm_md = checked = home = seq_bad = mapq_bad = 0
    mate_bad = pairs = 0
    for gi in sample:
        r = flat[gi]
        bi = int(np.searchsorted(firsts, gi, side="right") - 1)
        b = batches[bi]
        k = gi - b.first
        if r is None:
            continue
        if paired and k % 2 == 0:
            m = flat[gi + 1]
            if m is not None:
                pairs += 2
                mate_bad += (not mate_ok(r, m)) + (not mate_ok(m, r))
        # the read in the genome's orientation, at its origin
        read = b.seqs[k]
        fwd = (3 - read[::-1]) if b.strand[k] else read
        as_read = (3 - read[::-1]) if r["flag"] & 0x10 else read
        seq_bad += r["seq"] != LETTER_CODES[as_read].tobytes().decode()
        mapq_bad += not mapq_ok(r, sc, paired)
        o_c, o_p = int(b.ctg[k]), int(b.pos[k])
        o_lo, o_hi = o_p - WINDOW_PAD - 8, o_p + L + WINDOW_PAD + 8
        if r["flag"] & 4:
            ow = _window(genome, o_c, o_lo, o_hi, width)
            lane_o.append(len(q))
            lane_p.append(len(q))
            q.append(fwd)
            t.append(ow)
            got.append(0)
            cig.append(0)
            mapped.append(False)
            checked += 1
            continue
        ops = cigar_ops(r["cigar"])
        c = ctg_of.get(r["rname"])
        if c is None or len(r["seq"]) != L:
            # a record that does not describe the read: it fails as a
            # whole (lanes at the origin keep the arrays aligned)
            nm_md += 1
            lane_o.append(len(q))
            lane_p.append(len(q))
            q.append(fwd)
            t.append(_window(genome, o_c, o_lo, o_hi, width))
            got.append(-1)
            cig.append(-1)
            mapped.append(True)
            checked += 1
            continue
        p0 = r["pos"] - 1
        rl = ref_len(ops)
        lc, rc = clips(ops)
        seq = NT4[np.frombuffer(r["seq"].encode(), np.uint8)]
        p_lo, p_hi = p0 - lc - WINDOW_PAD, p0 + rl + rc + WINDOW_PAD
        if c == o_c and o_lo - 16 <= p_lo and p_hi <= o_hi + 16:
            # at its origin: one window holds both
            lanes = [(fwd, _window(genome, c, min(o_lo, p_lo),
                                   max(o_hi, p_hi), width))]
        else:
            lanes = [(fwd, _window(genome, o_c, o_lo, o_hi, width)),
                     (seq, _window(genome, c, p_lo, p_hi, width))]
        off = int(genome.offsets[c])
        home += len(lanes) == 1
        nm, md, score = walk(ops, seq, genome.codes[off + p0: off + p0 + rl],
                             sc)
        nm_md += nm != r["tags"].get("NM") or md != r["tags"].get("MD")
        lane_o.append(len(q))
        lane_p.append(len(q) + len(lanes) - 1)
        for x, y in lanes:
            q.append(x)
            t.append(y)
        got.append(int(r["tags"].get("AS", -1)))
        cig.append(score)
        mapped.append(True)
        checked += 1
    out = dict(missing=missing, checked=checked,
               at_origin=home / max(checked, 1),
               seq_off=seq_bad / max(checked, 1),
               mapq_over=mapq_bad / max(checked, 1))
    if paired:
        out["mate_off"] = mate_bad / max(pairs, 1)
    if not checked:
        return dict(out, nm_md_off=0.0, as_off=0.0, cigar_off=0.0,
                    misplaced=0.0)
    c5, c3 = int(sc["pen_clip5"]), int(sc["pen_clip3"])
    raw = sw.best_scores(np.stack(q), np.stack(t), sc)
    best, keep = sw.local_only(raw), sw.choice(raw, c5, c3)
    got, cig, mapped = np.array(got), np.array(cig), np.array(mapped)
    pl = np.array(lane_p)
    if control == "int8":
        craw = sw.best_scores(np.stack(q)[pl], np.stack(t)[pl], sc, bits=8)
        got = np.where(mapped, sw.local_only(craw), got)
        cig = np.where(mapped, sw.choice(craw, c5, c3), cig)
    elif control == "local":
        cig = np.where(mapped, best[pl], cig)
    elif control is not None:
        raise ValueError(f"unknown control {control!r}")
    out.update(
        nm_md_off=nm_md / checked,
        as_off=float((mapped & (got != best[pl])).sum()) / checked,
        cigar_off=float((mapped & (cig != keep[pl])).sum()) / checked,
        misplaced=float((got < best[lane_o]).sum()) / checked)
    return out
