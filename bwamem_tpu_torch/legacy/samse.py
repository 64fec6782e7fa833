"""`samse` — single-end SAM from .sai hits.

Behavior spec: bwa_sai2sam_se_core (bwase.c:510-580) and its helpers:
hit selection with the seeded drand48 stream (bwa_aln2seq_core,
bwase.c:22-96), SA-to-position conversion (bwa_cal_pac_pos, :144-165),
gapped-CIGAR refinement (bwa_refine_gapped, :287-344), MD/NM
(bwa_cal_md1, :203-249), trim correction (:251-285) and SAM rendering
(bwa_print_sam1, :386-506).  Output is byte-identical.

The two device-shaped steps batch — SA lookups of all selected hits (main
+ multi) run as one ops.fm.sa_lookup on the FM's device, and every gapped
hit's banded global alignment runs in one ops.global_sw.global_align_batch
on the same device — while the branchy per-read selection and rendering
stay on the host.  Counterpart of bwamem_tpu/legacy/samse.py.

timers: sa_lookup, global_sw (each with its transfers).
"""
from __future__ import annotations

import dataclasses
import math
import struct
from typing import Optional

import numpy as np
import torch

from bwamem_tpu_torch.config import fill_scmat
from bwamem_tpu_torch.legacy.aln import (
    GapOptions, GAP_OPT_FMT, SAI_MAGIC, BWA_MODE_COMPREAD, cal_maxdiff,
    unpack_aln1, prep_read)
from bwamem_tpu_torch.legacy.rng import Drand48
from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.ops import global_sw
from bwamem_tpu_torch.utils import timers

BWA_TYPE_NO_MATCH = 0
BWA_TYPE_UNIQUE = 1
BWA_TYPE_REPEAT = 2
BWA_TYPE_MATESW = 3

SAM_FSU, SAM_FSR = 4, 16
SAM_FMU, SAM_FMR = 8, 32

SW_BW = 50

G_LOG_N = [0] + [int(4.343 * math.log(i) + 0.5) for i in range(1, 256)]


@dataclasses.dataclass
class Multi:
    """bwt_multi1_t (bwtaln.h:59-64)."""
    pos: int = 0
    gap: int = 0
    mm: int = 0
    strand: int = 0
    ref_shift: int = 0
    cigar: Optional[list] = None     # [(op, len)] ops 0M 1I 2D 3S


@dataclasses.dataclass
class SeqSE:
    """bwa_seq_t subset used by samse/sampe (bwtaln.h:66-92)."""
    name: str
    seq: np.ndarray                  # nt4, ORIGINAL order, full_len
    qual: Optional[str]
    full_len: int
    len: int                         # post-trim
    clip_len: int
    extra_flag: int = 0
    n_mm: int = 0
    n_gapo: int = 0
    n_gape: int = 0
    ref_shift: int = 0
    score: int = 0
    sa: int = 0
    c1: int = 0
    c2: int = 0
    type: int = BWA_TYPE_NO_MATCH
    mapQ: int = 0
    seQ: int = 0
    pos: int = -1
    strand: int = 0
    n_multi: int = 0
    multi: list = dataclasses.field(default_factory=list)
    cigar: Optional[list] = None
    nm: int = 0
    md: Optional[str] = None
    bc: str = ""


def approx_mapQ(p: SeqSE, mm: int) -> int:
    """bwa_approx_mapQ (bwase.c:101-110)."""
    if p.c1 == 0:
        return 23
    if p.c1 > 1:
        return 0
    if p.n_mm == mm:
        return 25
    if p.c2 == 0:
        return 37
    n = 255 if p.c2 >= 255 else p.c2
    return 0 if 23 < G_LOG_N[n] else 23 - G_LOG_N[n]


def aln2seq_core(alns: list[tuple], s: SeqSE, set_main: bool, n_multi: int,
                 rng: Drand48) -> None:
    """bwa_aln2seq_core (bwase.c:22-96).  alns entries:
    (n_mm, n_gapo, n_gape, n_ins, n_del, k, l, score)."""
    if not alns:
        s.type = BWA_TYPE_NO_MATCH
        s.c1 = s.c2 = 0
        return
    if set_main:
        best = alns[0][7]
        cnt = 0
        i = 0
        while i < len(alns):
            p = alns[i]
            if p[7] > best:
                break
            if rng.drand() * (p[6] - p[5] + 1 + cnt) > float(cnt):
                s.n_mm, s.n_gapo, s.n_gape = p[0], p[1], p[2]
                s.ref_shift = p[4] - p[3]
                s.score = p[7]
                s.sa = p[5] + int((p[6] - p[5] + 1) * rng.drand())
            cnt += p[6] - p[5] + 1
            i += 1
        s.c1 = cnt
        while i < len(alns):
            cnt += alns[i][6] - alns[i][5] + 1
            i += 1
        s.c2 = cnt - s.c1
        s.type = BWA_TYPE_REPEAT if s.c1 > 1 else BWA_TYPE_UNIQUE
    if n_multi:
        n_occ = sum(q[6] - q[5] + 1 for q in alns)
        s.multi = []
        s.n_multi = 0
        if n_occ > n_multi + 1:      # too many hits: generate none
            return
        rest = n_occ
        for q in alns:
            sz = q[6] - q[5] + 1
            if sz <= rest:
                for l in range(q[5], q[6] + 1):
                    s.multi.append(Multi(pos=l, gap=q[1] + q[2],
                                         ref_shift=q[4] - q[3], mm=q[0]))
                rest -= sz
            else:                    # random sampling; "we never come here"
                j = rest
                i2 = sz
                while j > 0:
                    p_ = 1.0
                    x = rng.drand()
                    while x < p_:
                        p_ -= p_ * j / i2
                        i2 -= 1
                    s.multi.append(Multi(pos=q[6] - i2, gap=q[1] + q[2],
                                         ref_shift=q[4] - q[3], mm=q[0]))
                    j -= 1
                break
        s.n_multi = len(s.multi)


def sa2pos(l_pac: int, sa_pos: int, ref_len: int) -> tuple[int, int]:
    """bwa_sa2pos tail (bwase.c:113-127) AFTER the bwt_sa lookup; sa_pos is
    already the forward-reverse coordinate.  Returns (pos, strand) with
    pos == -1 for boundary-bridging hits."""
    if sa_pos < l_pac < sa_pos + ref_len:
        return -1, 0
    is_rev = sa_pos >= l_pac
    pos_f = (l_pac << 1) - 1 - sa_pos if is_rev else sa_pos
    strand = 0 if is_rev else 1
    if is_rev:
        pos_f = 0 if pos_f + 1 < ref_len else pos_f - ref_len + 1
    return pos_f, strand


def sa_lookup_host(fm, ranks) -> np.ndarray:
    """SA values of a list of ranks: one copy to fm's device, one batched
    ops.fm.sa_lookup walk, one copy back (int64)."""
    it = torch.int64 if fm.itype == torch.int64 else torch.int32
    with timers.section("sa_lookup"):
        r = torch.tensor(np.asarray(ranks, np.int64), dtype=it)
        return fmops.sa_lookup(fm, r.to(fm.device)).cpu().numpy().astype(
            np.int64)


def cal_pac_pos_batch(fm, l_pac: int, seqs: list[SeqSE], max_mm: int,
                      fnr: float) -> None:
    """bwa_cal_pac_pos (bwase.c:144-165): ONE batched SA walk for every
    main + multi hit, then host post-processing."""
    ranks, owners = [], []
    for s in seqs:
        if s.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
            ranks.append(s.sa)
            owners.append((s, -1))
        for j, q in enumerate(s.multi):
            ranks.append(q.pos)
            owners.append((s, j))
    if ranks:
        pos_fr = sa_lookup_host(fm, ranks)
    k = 0
    for s in seqs:
        if s.type in (BWA_TYPE_UNIQUE, BWA_TYPE_REPEAT):
            max_diff = cal_maxdiff(s.len, thres=fnr) if fnr > 0.0 else max_mm
            s.seQ = s.mapQ = approx_mapQ(s, max_diff)
            s.pos, s.strand = sa2pos(l_pac, int(pos_fr[k]),
                                     s.len + s.ref_shift)
            k += 1
            if s.pos == -1:
                s.type = BWA_TYPE_NO_MATCH
        kept = []
        for q in s.multi:
            q.pos, q.strand = sa2pos(l_pac, int(pos_fr[k]),
                                     s.len + q.ref_shift)
            k += 1
            if q.pos != s.pos and q.pos != -1:
                kept.append(q)
        s.multi = kept
        s.n_multi = len(kept)


# ------------------------------------------------------- gapped refinement

def _pac_fetch(pac: np.ndarray, rb: int, re: int) -> np.ndarray:
    pos = np.arange(rb, re, dtype=np.int64)
    return ((pac[pos >> 2] >> (((~pos) & 3) << 1).astype(np.uint8)) & 3) \
        .astype(np.uint8)


def global_cigars(q, qlen, t, tlen, w, mat, w_max: int, device):
    """global_align_batch of host arrays on `device` (scoring 1/3, gaps
    5/1), retried with twice the cigar capacity while any lane overflows
    (from 32 runs); returns (ops, lens, n_cigar, score) as numpy."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    mc = 32
    with timers.section("global_sw"):
        args = [dev(a) for a in (q, qlen, t, tlen, w)]
        while True:
            res = global_sw.global_align_batch(
                *args, mat, o_del=5, e_del=1, o_ins=5, e_ins=1,
                w_max=w_max, max_cigar=mc)
            if not bool(res.overflow.any()):
                break
            mc *= 2
        return tuple(x.cpu().numpy() for x in
                     (res.ops, res.lens, res.n_cigar, res.score))


def refine_gapped_batch(pac: np.ndarray, l_pac: int, seqs: list[SeqSE],
                        device) -> None:
    """bwa_refine_gapped (bwase.c:287-344): batch every gapped hit's banded
    ksw_global into one call on `device`; post-process CIGARs exactly
    (bwa_refine_gapped_core, :169-201)."""
    jobs = []                      # (query nt4, rb, re, w, apply_fn)
    for s in seqs:
        for j, q in enumerate(s.multi):
            if q.gap:
                query = _aligned_query(s, q.strand)
                jobs.append((query, q.pos, q.pos + s.len + q.ref_shift,
                             ("multi", s, j)))
        if s.type in (BWA_TYPE_NO_MATCH, BWA_TYPE_MATESW) or s.n_gapo == 0:
            continue
        query = _aligned_query(s, s.strand)
        jobs.append((query, s.pos, s.pos + s.len + s.ref_shift,
                     ("main", s, -1)))

    results = {}
    if jobs:
        mat = fill_scmat(1, 3)
        B = len(jobs)
        LQ = max(len(j[0]) for j in jobs)
        LT = max(int(j[2] - j[1]) for j in jobs)
        ws = []
        q = np.full((B, LQ), 4, np.uint8)
        t = np.full((B, LT), 4, np.uint8)
        qlen = np.zeros(B, np.int32)
        tlen = np.zeros(B, np.int32)
        for b, (query, rb, re, _tag) in enumerate(jobs):
            assert re <= l_pac
            rseq = _pac_fetch(pac, rb, re)
            q[b, :len(query)] = query
            t[b, :len(rseq)] = rseq
            qlen[b], tlen[b] = len(query), len(rseq)
            w = int(abs(int(re - rb) - len(query)) * 1.5)
            ws.append(max(SW_BW, w))
        ops, lens, ncig, _ = global_cigars(
            q, qlen, t, tlen, np.asarray(ws, np.int32), mat, max(ws), device)
        for b, (query, rb, re, tag) in enumerate(jobs):
            cigar = [(int(ops[b, x]), int(lens[b, x]))
                     for x in range(int(ncig[b]))]
            # ends: I->S, strip end D, strip lead D shifting pos
            # (bwa_refine_gapped_core, bwase.c:184-192)
            new_rb = rb
            if cigar and cigar[-1][0] == 1:
                cigar[-1] = (3, cigar[-1][1])
            if cigar and cigar[0][0] == 1:
                cigar[0] = (3, cigar[0][1])
            if cigar and cigar[-1][0] == 2:
                cigar = cigar[:-1]
            if cigar and cigar[0][0] == 2:
                new_rb += cigar[0][1]
                cigar = cigar[1:]
            results[b] = (cigar, new_rb)

    for b, (_q, rb, _re, tag) in enumerate(jobs):
        kind, s, j = tag
        cigar, new_rb = results[b]
        if kind == "multi":
            s.multi[j].cigar = cigar
            s.multi[j].pos = new_rb
        else:
            s.cigar = cigar
            s.pos = new_rb
            if not cigar:
                s.type = BWA_TYPE_NO_MATCH
    for s in seqs:
        s.multi = [q for q in s.multi if not (q.gap and q.cigar is None)]
        s.n_multi = len(s.multi)


def _aligned_query(s: SeqSE, strand: int) -> np.ndarray:
    """strand? s->rseq : s->seq over the trimmed length (bwase.c:305,320):
    rseq = revcomp of the TRIMMED prefix."""
    seq = s.seq[: s.len]
    if strand:
        r = seq[::-1].astype(np.int32)
        return np.where(r < 4, 3 - r, 4).astype(np.uint8)
    return seq


def cal_md1(s: SeqSE, pac: np.ndarray, l_pac: int) -> None:
    """bwa_cal_md1 (bwase.c:203-249)."""
    x = s.pos
    y = 0
    nm = 0
    md = []
    seq = _aligned_query(s, s.strand)
    cigar = s.cigar if s.cigar else [(0, s.len)]
    u = 0
    for op, ln in cigar:
        if op == 0:
            span = min(ln, max(l_pac - x, 0))
            ref = _pac_fetch(pac, x, x + span)
            for z in range(span):
                c = int(ref[z])
                if c > 3 or seq[y + z] > 3 or c != seq[y + z]:
                    md.append(str(u))
                    md.append("ACGTN"[c])
                    nm += 1
                    u = 0
                else:
                    u += 1
            x += ln
            y += ln
        elif op in (1, 3):
            y += ln
            if op == 1:
                nm += ln
        elif op == 2:
            md.append(str(u))
            md.append("^")
            span = min(ln, max(l_pac - x, 0))
            md.extend("ACGT"[int(c)] for c in _pac_fetch(pac, x, x + span))
            u = 0
            x += ln
            nm += ln
    md.append(str(u))
    s.md = "".join(md)
    s.nm = nm


def correct_trimmed(s: SeqSE) -> None:
    """bwa_correct_trimmed (bwase.c:251-285)."""
    if s.len == s.full_len:
        return
    clip = s.full_len - s.len
    if s.strand == 0:
        if s.cigar and s.cigar[-1][0] == 3:
            s.cigar[-1] = (3, s.cigar[-1][1] + clip)
        else:
            if s.cigar is None:
                s.cigar = [(0, s.len)]
            s.cigar = s.cigar + [(3, clip)]
    else:
        if s.cigar and s.cigar[0][0] == 3:
            s.cigar[0] = (3, s.cigar[0][1] + clip)
        else:
            if s.cigar is None:
                s.cigar = [(0, s.len)]
            s.cigar = [(3, clip)] + s.cigar
    s.len = s.full_len


# ------------------------------------------------------------- SAM render

def pos_end(s: SeqSE) -> int:
    if s.cigar:
        return s.pos + sum(ln for op, ln in s.cigar if op in (0, 2))
    return s.pos + s.len


def pos_end_multi(q: Multi, length: int) -> int:
    if q.cigar:
        return q.pos + sum(ln for op, ln in q.cigar if op in (0, 2))
    return q.pos + length


def _pos5(p: SeqSE) -> int:
    if p.type != BWA_TYPE_NO_MATCH:
        return pos_end(p) if p.strand else p.pos
    return -1


def cnt_ambi(ambs: list, pos_f: int, length: int) -> int:
    """bns_cnt_ambi (bntseq.c): first-overlap binary search."""
    left, right = 0, len(ambs)
    nn = 0
    while left < right:
        mid = (left + right) >> 1
        a = ambs[mid]
        if pos_f >= a.offset + a.len:
            left = mid + 1
        elif pos_f + length <= a.offset:
            right = mid
        else:
            if pos_f >= a.offset:
                nn = a.offset + a.len - pos_f \
                    if a.offset + a.len < pos_f + length else length
            else:
                nn = a.len if a.offset + a.len < pos_f + length \
                    else length - (a.offset - pos_f)
            break
    return nn


def _print_seq(s: SeqSE) -> str:
    if s.strand == 0:
        return "".join("ACGTN"[b] for b in s.seq[: s.full_len])
    return "".join("TGCAN"[b] for b in s.seq[s.full_len - 1:: -1])


def _print_qual(s: SeqSE) -> str:
    if not s.qual:
        return "*"
    if s.strand:
        # seq_reverse(p->len, qual): only the first len chars reverse
        q = s.qual
        return q[: s.len][::-1] + q[s.len:]
    return s.qual


def print_sam1(bns, s: SeqSE, mate: Optional[SeqSE], mode: int,
               max_top2: int, rg_id: str, out) -> None:
    """bwa_print_sam1 (bwase.c:386-506).  bns: object with contigs
    (offset/len/name/is_alt), ambs, l_pac."""
    offs = bns["offsets"]
    names = bns["names"]
    lens = bns["lens"]
    ambs = bns["ambs"]
    if s.type != BWA_TYPE_NO_MATCH or \
            (mate is not None and mate.type != BWA_TYPE_NO_MATCH):
        flag = s.extra_flag
        if s.type == BWA_TYPE_NO_MATCH:
            s.pos = mate.pos
            s.strand = mate.strand
            flag |= SAM_FSU
            j = 1
        else:
            j = pos_end(s) - s.pos
        seqid = int(np.searchsorted(offs, s.pos, side="right") - 1)
        nn = cnt_ambi(ambs, s.pos, j)
        if s.type != BWA_TYPE_NO_MATCH and \
                s.pos + j - offs[seqid] > lens[seqid]:
            flag |= SAM_FSU
        if s.strand:
            flag |= SAM_FSR
        if mate is not None:
            if mate.type != BWA_TYPE_NO_MATCH:
                if mate.strand:
                    flag |= SAM_FMR
            else:
                flag |= SAM_FMU
        o = [f"{s.name}\t{flag}\t{names[seqid]}\t"
             f"{s.pos - offs[seqid] + 1}\t{s.mapQ}\t"]
        if s.cigar:
            o.append("".join(f"{ln}{'MIDS'[op]}" for op, ln in s.cigar))
        elif s.type == BWA_TYPE_NO_MATCH:
            o.append("*")
        else:
            o.append(f"{s.len}M")
        am = 0
        if mate is not None and mate.type != BWA_TYPE_NO_MATCH:
            am = min(mate.seQ, s.seQ)
            m_seqid = int(np.searchsorted(offs, mate.pos, side="right") - 1)
            o.append("\t=" if seqid == m_seqid else f"\t{names[m_seqid]}")
            isize = _pos5(mate) - _pos5(s) if seqid == m_seqid else 0
            if s.type == BWA_TYPE_NO_MATCH:
                isize = 0
            o.append(f"\t{mate.pos - offs[m_seqid] + 1}\t{isize}\t")
        elif mate is not None:
            o.append(f"\t=\t{s.pos - offs[seqid] + 1}\t0\t")
        else:
            o.append("\t*\t0\t0\t")
        o.append(_print_seq(s))
        o.append("\t")
        o.append(_print_qual(s))
        if rg_id:
            o.append(f"\tRG:Z:{rg_id}")
        if s.bc:
            o.append(f"\tBC:Z:{s.bc}")
        if s.clip_len < s.full_len:
            o.append(f"\tXC:i:{s.clip_len}")
        if s.type != BWA_TYPE_NO_MATCH:
            xt = "NURM"[s.type]
            if nn > 10:
                xt = "N"
            tag = "NM" if mode & BWA_MODE_COMPREAD else "CM"
            o.append(f"\tXT:A:{xt}\t{tag}:i:{s.nm}")
            if nn:
                o.append(f"\tXN:i:{nn}")
            if mate is not None:
                o.append(f"\tSM:i:{s.seQ}\tAM:i:{am}")
            if s.type != BWA_TYPE_MATESW:
                o.append(f"\tX0:i:{s.c1}")
                if s.c1 <= max_top2:
                    o.append(f"\tX1:i:{s.c2}")
            o.append(f"\tXM:i:{s.n_mm}\tXO:i:{s.n_gapo}"
                     f"\tXG:i:{s.n_gapo + s.n_gape}")
            if s.md is not None:
                o.append(f"\tMD:Z:{s.md}")
            if s.n_multi:
                o.append("\tXA:Z:")
                for q in s.multi:
                    jq = pos_end_multi(q, s.len) - q.pos
                    qid = int(np.searchsorted(offs, q.pos,
                                              side="right") - 1)
                    o.append(f"{names[qid]},{'-' if q.strand else '+'}"
                             f"{q.pos - offs[qid] + 1},")
                    if q.cigar:
                        o.append("".join(f"{ln}{'MIDS'[op]}"
                                         for op, ln in q.cigar))
                    else:
                        o.append(f"{s.len}M")
                    o.append(f",{q.gap + q.mm};")
        o.append("\n")
        out.write("".join(o))
    else:
        flag = s.extra_flag | SAM_FSU
        if mate is not None and mate.type == BWA_TYPE_NO_MATCH:
            flag |= SAM_FMU
        o = [f"{s.name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t",
             _print_seq(s), "\t", _print_qual(s)]
        if rg_id:
            o.append(f"\tRG:Z:{rg_id}")
        if s.bc:
            o.append(f"\tBC:Z:{s.bc}")
        if s.clip_len < s.full_len:
            o.append(f"\tXC:i:{s.clip_len}")
        o.append("\n")
        out.write("".join(o))


def sam_hdr(bns, rg_line: Optional[str], pg_line: Optional[str]) -> str:
    """bwa_print_sam_hdr (bwa.c:520-541)."""
    o = []
    for name, ln, is_alt in zip(bns["names"], bns["lens"], bns["is_alt"]):
        o.append(f"@SQ\tSN:{name}\tLN:{ln}" + ("\tAH:*" if is_alt else ""))
    if rg_line:
        o.append(rg_line)
    if pg_line:
        o.append(pg_line)
    return "".join(x + "\n" for x in o)


# ---------------------------------------------------------------- entry points

def make_bns(idx) -> dict:
    return dict(
        offsets=idx.contig_offsets(),
        lens=[c.len for c in idx.contigs],
        names=[c.name for c in idx.contigs],
        is_alt=[c.is_alt for c in idx.contigs],
        ambs=idx.ambs,
        l_pac=int(idx.l_pac),
    )


def read_sai(path: str):
    """SAI stream: magic, gap_opt_t, then per read (n_aln, records).
    Returns (options, a generator of each read's records); the file
    closes when the generator ends or is closed.  Raises ValueError on a
    file without the magic."""
    f = open(path, "rb")
    try:
        if f.read(4) != SAI_MAGIC:
            raise ValueError(f"{path}: unmatched SAI magic")
        opt = GapOptions.unpack(f.read(struct.calcsize(GAP_OPT_FMT)))
    except BaseException:
        f.close()
        raise

    def recs():
        with f:
            while True:
                raw = f.read(4)
                if len(raw) < 4:
                    return
                n, = struct.unpack("<i", raw)
                yield [unpack_aln1(f.read(24)) for _ in range(n)]
    return opt, recs()


def load_seqs(fq_path: str, opt: GapOptions):
    """Read prep identical to bwa_read_seq for the samse side: the ORIGINAL
    order nt4 is kept (bwa_refine_gapped reverses p->seq back immediately,
    bwase.c:303)."""
    from bwamem_tpu_torch.io.fastq import read_fastx
    for r in read_fastx(fq_path):
        name = r.name
        if len(name) > 2 and name[-2] == "/" and name[-1] in "12":
            name = name[:-2]
        _rev, keep = prep_read(r.seq, r.qual, opt)
        yield SeqSE(name=name, seq=np.asarray(r.seq), qual=r.qual,
                    full_len=len(r.seq), len=keep, clip_len=keep)


def ann_seed(prefix: str) -> int:
    """bns->seed from the .ann header (bntseq.c:109); 11 when absent."""
    try:
        with open(prefix + ".ann") as f:
            parts = f.readline().split()
            return int(parts[2]) if len(parts) >= 3 else 11
    except OSError:
        return 11


def samse_core(idx, sai_path: str, fq_path: str, n_occ: int,
               rg_line: Optional[str], rg_id: Optional[str], out, device,
               pg_line: Optional[str] = None, seed: int = 11,
               batch: int = 0x40000) -> None:
    """bwa_sai2sam_se_core (bwase.c:510-580); the SA walks and the global
    SWs run on `device`."""
    fm = fmops.fm_from_index(idx, device)
    bns = make_bns(idx)
    rng = Drand48(seed)
    opt, rec_iter = read_sai(sai_path)
    out.write(sam_hdr(bns, rg_line, pg_line))
    seqs_it = load_seqs(fq_path, opt)
    while True:
        seqs = []
        for s in seqs_it:
            seqs.append(s)
            if len(seqs) >= batch:
                break
        if not seqs:
            break
        for s in seqs:
            alns = next(rec_iter)
            aln2seq_core(alns, s, True, n_occ, rng)
        cal_pac_pos_batch(fm, bns["l_pac"], seqs, opt.max_diff, opt.fnr)
        refine_gapped_batch(idx.pac, bns["l_pac"], seqs, device)
        for s in seqs:
            if s.type != BWA_TYPE_NO_MATCH:
                cal_md1(s, idx.pac, bns["l_pac"])
            correct_trimmed(s)
        for s in seqs:
            print_sam1(bns, s, None, opt.mode, opt.max_top2, rg_id or "",
                       out)
        if len(seqs) < batch:
            break
