"""BWA-SW's top level: per-read alignment, hit extension, CIGAR/SAM output
(bwtsw2_aux.c) with the dense SW work batched onto the device.

Every device call gets exact lane counts and lengths (no power-of-two
padding).  On a CUDA device each extension batch launches the one-pass
extension kernel (ops/ext_kernel.extend_batch_pl, csrc/ext_kernel.cu); on
the CPU the same call runs its plain version, one ops/extend.extend_batch.
The global alignments of a whole chunk's hits run as one
ops/global_sw.global_align_batch, and the SA walks as ops/fm.sa_lookup.
Counterpart of bwamem_tpu/bwasw/aux.py; the SAM bytes are its.

timers: bwasw.traversal (the prefix-DAG traversal of bsw2_core, its
bwasw.sa_lookup included), bwasw.sa_lookup, bwasw.ext_left,
bwasw.ext_rght, bwasw.global_sw, bwasw.pair_sw, bwasw.sam; counts
bwasw.ext_left.calls and bwasw.ext_rght.calls (extension dispatches) and
bwasw.ext_plain.calls (those that ran the plain version).
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from bwamem_tpu_torch.bwasw import chain as bchain
from bwamem_tpu_torch.bwasw import core
from bwamem_tpu_torch.bwasw.bwtl import BwtLite
from bwamem_tpu_torch.bwasw.hostfm import HostFM
from bwamem_tpu_torch.bwasw.ksort import ks_introsort
from bwamem_tpu_torch.legacy.rng import Drand48
from bwamem_tpu_torch.ops import ext_kernel
from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.ops import global_sw as gsw
from bwamem_tpu_torch.utils import timers

BSW2_FLAG_MATESW = 0x100
BSW2_FLAG_TANDEM = 0x200
BSW2_FLAG_MOVED = 0x400
BSW2_FLAG_RESCUED = 0x800

# nt_comp_table (bwtsw2_aux.c:32-49), transcribed row by row
_COMP = bytearray(b"N" * 256)
_COMP[64:80] = b"NTVGHNNCDNNMNKNN"
_COMP[80:96] = b"NNYSANBWXRNNNNNN"
_COMP[96:112] = b"ntvghnncdnnmnknn"
_COMP[112:123] = b"nnysanbwxyr"[:11]
_COMP = bytes(_COMP)
NT_COMP = {i: _COMP[i:i + 1].decode() for i in range(256)}


class Bsw2Options:
    """bsw2opt_t (bwtsw2.h:14-20) with bsw2_init_opt defaults."""

    def __init__(self):
        self.skip_sw = 0
        self.cpy_cmt = 0
        self.hard_clip = 0
        self.a = 1
        self.b = 3
        self.q = 5
        self.r = 2
        self.t = 30
        self.bw = 50
        self.max_ins = 20000
        self.max_chain_gap = 10000
        self.z = 1
        self.is_ = 3
        self.t_seeds = 5
        self.multi_2nd = 0
        self.mask_level = 0.50
        self.coef = 5.5
        self.n_threads = 1
        self.chunk_size = 10000000
        self.qr = self.q + self.r

    def copy(self) -> "Bsw2Options":
        o = Bsw2Options.__new__(Bsw2Options)
        o.__dict__.update(self.__dict__)
        return o


def update_opt(src: Bsw2Options, qlen: int) -> Bsw2Options:
    """Per-read threshold / band adaptation (bwtsw2_aux.c:545-557)."""
    dst = src.copy()
    ll = math.log(qlen)
    if dst.t < ll * dst.coef:
        dst.t = int(ll * dst.coef + .499)
    k = int((qlen * dst.a - 2 * dst.q) / (2 * dst.r + dst.a))
    i = int((qlen * dst.a - dst.a - dst.t) / dst.r)
    if k > i:
        k = i
    if k < 1:
        k = 1
    dst.bw = src.bw if src.bw < k else k
    return dst


def fill_scmat(a: int, b: int) -> np.ndarray:
    """bwa_fill_scmat (bwa.c:61-71)."""
    mat = np.full((5, 5), -1, np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = a if i == j else -b
    mat[4, :] = -1
    mat[:, 4] = -1
    return mat


# ----------------------------------------------------- device SW adapters

def _dev(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def ksw_extend_jobs(jobs, mat, q, r, bw, dev, side):
    """Batch of ksw_extend calls on `dev`: jobs = [(query nt4[], target
    nt4[], h0)]; returns [(score, qle, tle)].  zdrop is disabled and
    end_bonus 0, as in the bwasw call sites (bwtsw2_aux.c:133,161).  Jobs
    with an empty query or target are not run (0, 0, 0).  `side` names the
    timer and the count (ext_left, ext_rght)."""
    out = [(0, 0, 0)] * len(jobs)
    live = [(i, j) for i, j in enumerate(jobs) if len(j[0]) and len(j[1])]
    if not live:
        return out
    B = len(live)
    LQ = max(len(j[0]) for _, j in live)
    T = max(len(j[1]) for _, j in live)
    queryT = np.full((LQ, B), 4, np.int32)
    targetT = np.full((T, B), 4, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    h0 = np.ones(B, np.int32)
    for b_, (_, (qs, ts, h)) in enumerate(live):
        queryT[:len(qs), b_] = qs
        targetT[:len(ts), b_] = ts
        qlen[b_], tlen[b_], h0[b_] = len(qs), len(ts), h
    timers.count(f"bwasw.{side}.calls")
    if dev.type != "cuda":
        timers.count("bwasw.ext_plain.calls")
    with timers.section(f"bwasw.{side}"):
        res = ext_kernel.extend_batch_pl(
            *(_dev(a, dev) for a in (queryT, qlen, targetT, tlen, h0)),
            torch.full((B,), bw, dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            lq_max=LQ, t_max=T, mat_bytes=mat.tobytes(), o_del=q, e_del=r,
            o_ins=q, e_ins=r, zdrop=-1)
        score, qle, tle = (x.cpu().numpy()
                           for x in (res.score, res.qle, res.tle))
    for b_, (i, _) in enumerate(live):
        out[i] = (int(score[b_]), int(qle[b_]), int(tle[b_]))
    return out


def ksw_global_jobs(jobs, mat, q, r, dev):
    """Batch of ksw_global2 calls on `dev`: jobs = [(query, target, w)],
    each query and target nonempty; returns [cigar list of (op, len)] (op
    0 M, 1 I, 2 D).  The CIGAR capacity starts at a quarter of the longest
    query (64 at least) and doubles while any lane overflows."""
    if not jobs:
        return []
    B = len(jobs)
    LQ = max(len(j[0]) for j in jobs)
    T = max(len(j[1]) for j in jobs)
    w_max = max(j[2] for j in jobs)
    query = np.full((B, LQ), 4, np.uint8)
    tgt = np.full((B, T), 4, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    w = np.zeros(B, np.int32)
    for b_, (qs, ts, ww) in enumerate(jobs):
        query[b_, :len(qs)] = qs
        tgt[b_, :len(ts)] = ts
        qlen[b_], tlen[b_], w[b_] = len(qs), len(ts), ww
    mc = max(64, LQ // 4)
    with timers.section("bwasw.global_sw"):
        args = [_dev(a, dev) for a in (query, qlen, tgt, tlen, w)]
        while True:
            res = gsw.global_align_batch(
                *args, mat, o_del=q, e_del=r, o_ins=q, e_ins=r,
                w_max=w_max, max_cigar=mc)
            if not bool(res.overflow.any()):
                break
            mc <<= 1
        ops, lens, ncig = (x.cpu().numpy()
                           for x in (res.ops, res.lens, res.n_cigar))
    return [[(int(ops[b_, k]), int(lens[b_, k])) for k in range(ncig[b_])]
            for b_ in range(B)]


# --------------------------------------------------------- hit extensions

def extend_left(opt, hits, seq, lq, hfm, dev):
    """bsw2_extend_left (bwtsw2_aux.c:100-142).  Sequential per hit: the
    containment skip consults previously EXTENDED hits, so each hit that
    no earlier one contains is one extension dispatch of its own."""
    mat = fill_scmat(opt.a, opt.b)
    ks_introsort(hits, lambda x, y: x.end > y.end)
    query_rev = np.ascontiguousarray(seq[::-1])
    for i, p in enumerate(hits):
        p.n_seeds = 1
        if p.l or p.k == 0:
            continue
        lt = ((p.beg + 1) // 2 * opt.a + opt.r) // opt.r + lq
        score = 0
        for j in range(i):
            qh = hits[j]
            if qh.beg <= p.beg and qh.k <= p.k and \
                    qh.k + qh.len >= p.k + p.len:
                if qh.n_seeds < (1 << 13) - 2:
                    qh.n_seeds += 1
                score += 1
        if score:
            continue
        if lt > p.k:
            lt = p.k
        # bases p.k-1 down to max(p.k-lt, 1): k==0 never read (FIXME in C)
        lo = max(p.k - lt, 1)
        target = hfm.get_seq(lo, p.k)[::-1]
        (s, qle, tle), = ksw_extend_jobs(
            [(query_rev[lq - p.beg:], target, p.G)], mat, opt.q, opt.r,
            opt.bw, dev, "ext_left")
        if s > p.G:
            p.G = s
            p.k -= tle
            p.len += tle
            p.beg -= qle


def extend_rght(opt, hits, seq, lq, hfm, dev):
    """bsw2_extend_rght (bwtsw2_aux.c:144-170), batched (no inter-hit
    dependency): one extension dispatch."""
    mat = fill_scmat(opt.a, opt.b)
    jobs = []
    idx = []
    for i, p in enumerate(hits):
        if p.l:
            continue
        lt = ((lq - p.beg + 1) // 2 * opt.a + opt.r) // opt.r + lq
        hi = min(p.k + lt, hfm.l_pac)
        jobs.append((seq[p.beg:], hfm.get_seq(p.k, hi), 1))
        idx.append(i)
    for (s, qle, tle), i in zip(
            ksw_extend_jobs(jobs, mat, opt.q, opt.r, opt.bw, dev,
                            "ext_rght"), idx):
        p = hits[i]
        score = s - 1
        if score >= p.G:
            p.G = score
            p.len = tle
            p.end = p.beg + qle


def merge_hits(dst, src, length, is_reverse):
    """bwtsw2_aux.c:226-246."""
    for p in src:
        if is_reverse:
            p.beg, p.end = length - p.end, length - p.beg
            p.flag |= 0x10
        dst.append(p)
    return dst


# ------------------------------------------------------------ CIGAR + aux

class Aux:
    """bsw2aux_t."""
    __slots__ = ("flag", "nn", "chr", "pos", "qual", "mchr", "mpos",
                 "pqual", "isize", "nm", "cigar")

    def __init__(self):
        self.flag = 0
        self.nn = 0
        self.chr = -1
        self.pos = -1
        self.qual = 0
        self.mchr = -1
        self.mpos = -1
        self.pqual = 0
        self.isize = 0
        self.nm = -1
        self.cigar = None  # list of (op, len); None = no alignment


def _cigar_job(opt, lq, seq01, hfm, p):
    """(query segment, reference segment, band, beg, end) of one hit's
    global alignment (bwtsw2_aux.c:173-198, band of bwa.c:292-300), or
    None when the hit gets no CIGAR (bwa.c:362)."""
    beg = lq - p.end if p.flag & 0x10 else p.beg
    end = lq - p.beg if p.flag & 0x10 else p.end
    qseg = seq01[1 if p.flag & 0x10 else 0][beg:end]
    rb, re = p.k, p.k + p.len
    if end - beg <= 0 or rb >= re or rb < 0 or re > hfm.l_pac:
        return None
    rseq = hfm.get_seq(rb, re)
    lquery, rlen = end - beg, re - rb
    max_ins = int((((lquery + 1) >> 1) * opt.a - opt.q) / opt.r + 1.)
    max_del = max_ins
    max_gap = max(max(max_ins, max_del), 1)
    w = (max_gap + abs(rlen - lquery) + 1) >> 1
    w = min(w, opt.bw)
    w = max(w, abs(rlen - lquery) + 3)
    return qseg, rseq, w, beg, end


def gen_cigars(reads, hfm, dev):
    """gen_cigar (bwtsw2_aux.c:173-212) for every hit of a chunk, in one
    batched global-SW call; reads = [(opt, lq, seq01, hits, auxs)], each
    read with its own update_opt band.  Sets each aux's cigar (None = no
    alignment) and NM over the aligned segment exactly like bwa_gen_cigar2
    (deletion runs at either CIGAR end excluded)."""
    jobs, meta = [], []
    for opt, lq, seq01, hits, auxs in reads:
        for p, q in zip(hits, auxs):
            if p.l:
                continue
            job = _cigar_job(opt, lq, seq01, hfm, p)
            if job is not None:
                jobs.append(job[:3])
                meta.append((q, lq, *job))
    if not jobs:
        return
    opt = reads[0][0]              # scoring is the same for every read
    cigars = ksw_global_jobs(jobs, fill_scmat(opt.a, opt.b), opt.q, opt.r,
                             dev)
    for cig, (q, lq, qseg, rseq, _w, beg, end) in zip(cigars, meta):
        # NM (bwa.c:311-341)
        n_mm = n_gap = 0
        x = y = 0
        for k, (op, ln) in enumerate(cig):
            if op == 0:
                n_mm += int((qseg[x:x + ln] != rseq[y:y + ln]).sum())
                x += ln
                y += ln
            elif op == 2:
                if 0 < k < len(cig) - 1:
                    n_gap += ln
                y += ln
            elif op == 1:
                x += ln
                n_gap += ln
        q.nm = n_mm + n_gap
        cig = list(cig)
        if cig and (beg != 0 or end < lq):  # soft clips (bwa_aux:199-210)
            if beg != 0:
                cig.insert(0, (4, beg))
            if end < lq:
                cig.append((4, lq - end))
        q.cigar = cig


def fix_cigar(hfm, p, cigar):
    """Split an alignment crossing a contig boundary (bwtsw2_aux.c:326-397);
    returns the fixed cigar list, mutating p.k/p.len."""
    _, seqid = hfm.cnt_ambi(p.k, p.len)
    coor = p.k - int(hfm.ctg_off[seqid])
    refl = int(hfm.ctg_len[seqid])
    x, y = coor, 0
    for op, ln in cigar:
        if op in (1, 4, 5):
            y += ln
        elif op == 2:
            x += ln
        else:
            x += ln
            y += ln
    lq = y
    if x <= refl:
        return cigar
    # crosses the boundary: split into two candidate alignments
    nc = 0
    mq = [0, 0]
    nlen = [0, 0]
    cn = []
    kk = 0
    x, y = coor, 0
    for op, ln in cigar:
        if op in (1, 4, 5):
            y += ln
            cn.append((op, ln))
        elif op == 2:
            if x + ln >= refl and nc == 0:
                cn.append((4, lq - y))
                nc = len(cn)
                cn.append((4, y))
                kk = p.k + (x + ln - refl)
                nlen[0] = x - coor
                nlen[1] = p.len - nlen[0] - ln
            else:
                cn.append((op, ln))
            x += ln
        elif op == 0:
            if x + ln >= refl and nc == 0:
                cn.append((0, refl - x))
                cn.append((4, lq - y - (refl - x)))
                nc = len(cn)
                mq[0] += refl - x
                cn.append((4, y + (refl - x)))
                if x + ln - refl:
                    cn.append((0, x + ln - refl))
                mq[1] += x + ln - refl
                kk = int(hfm.ctg_off[seqid]) + refl
                nlen[0] = refl - coor
                nlen[1] = p.len - nlen[0]
            else:
                cn.append((op, ln))
                mq[1 if nc else 0] += ln
            x += ln
            y += ln
    if mq[0] > mq[1]:
        p.len = nlen[0]
        return cn[:nc]
    p.k = kk
    p.len = nlen[1]
    return cn[nc:]


def write_aux(opt, hfm, b_hits, auxs):
    """mapQ + chromosomal position (bwtsw2_aux.c:399-436), after
    gen_cigars has set the CIGARs."""
    for p, q in zip(b_hits, auxs):
        q.flag = p.flag & 0xFE
        q.isize = 0
        if p.l == 0:
            # the reference runs fix_cigar even with a NULL cigar, which
            # can zero p.k/p.len for out-of-range hits (bwtsw2_aux.c:421)
            fixed = fix_cigar(hfm, p, q.cigar if q.cigar else [])
            if q.cigar is not None:
                q.cigar = fixed
            c = 1.0
            subo = p.G2 if p.G2 > opt.t else opt.t
            if p.flag >> 16 in (1, 2):
                c *= .5
            if p.n_seeds < 2:
                c *= .2
            qual = int(c * (p.G - subo) * (250.0 / p.G + 0.03 / opt.a)
                       + .499)
            q.qual = max(0, min(qual, 250))
            if p.flag & 1:
                q.qual = 0  # random repetitive hit
            q.pqual = q.qual
            q.nn, q.chr = hfm.cnt_ambi(p.k, p.len)
            q.pos = p.k - int(hfm.ctg_off[q.chr])
        else:
            q.qual = 0
            q.chr = q.pos = -1
            q.nn = 0
            q.cigar = None


def update_mate_aux(b, m):
    """Mate flags / coordinates / pqual coupling (bwtsw2_aux.c:438-473).
    b/m = (hits, auxs) tuples."""
    if m is None:
        return
    bh, ba = b
    mh, ma = m
    for q in ba:
        q.flag |= 1
        if len(mh) == 0:
            q.flag |= 8
        if len(mh) == 1:
            q.mchr = ma[0].chr
            q.mpos = ma[0].pos
            if ma[0].flag & 0x10:
                q.flag |= 0x20
            if q.chr == q.mchr:
                if q.mpos + mh[0].len > q.pos:
                    q.isize = q.mpos + mh[0].len - q.pos
                else:
                    q.isize = q.mpos - q.pos - bh[0].len
            else:
                q.isize = 0
        else:
            q.mchr = q.mpos = -1
    if len(bh) == 1 and len(mh) == 1:
        p = bh[0]
        if p.flag & BSW2_FLAG_MATESW:
            if not (p.flag & BSW2_FLAG_TANDEM) and ba[0].pqual < 20:
                ba[0].pqual = 20
            if ba[0].pqual >= ma[0].qual:
                ba[0].pqual = ma[0].qual
        elif (p.flag & 2) and not (mh[0].flag & BSW2_FLAG_MATESW):
            if not (p.flag & BSW2_FLAG_TANDEM):
                ba[0].pqual += 20
                if ba[0].pqual > ma[0].qual:
                    ba[0].pqual = ma[0].qual
                if ba[0].pqual < ba[0].qual:
                    ba[0].pqual = ba[0].qual


# ------------------------------------------------------------- SAM output

def print_hits(hfm, opt, read, hits, auxs, is_pe, out):
    """bwtsw2_aux.c:477-543."""
    names = [c.name for c in hfm.idx.contigs]
    raw = read.raw if read.raw is not None else \
        "".join("ACGTN"[c] for c in read.seq)
    l = len(raw)
    if not hits:
        out.write(f"{read.name}\t4\t*\t0\t0\t*\t*\t0\t0\t{raw}\t"
                  f"{read.qual if read.qual else '*'}\n")
    for i, (p, q) in enumerate(zip(hits, auxs)):
        if q.cigar is None:
            q.flag |= 0x4
        flag = q.flag | (0x100 if opt.multi_2nd and i else 0)
        o = [f"{read.name}\t{flag}",
             f"\t{names[q.chr] if q.chr >= 0 else '*'}\t{q.pos + 1}"]
        if p.l == 0 and q.cigar is not None:
            o.append(f"\t{q.pqual}\t")
            letters = "MIDNHHP" if opt.hard_clip else "MIDNSHP"
            o.extend(f"{ln}{letters[op]}" for op, ln in q.cigar)
        else:
            o.append("\t0\t*")
        if not is_pe:
            o.append("\t*\t0\t0\t")
        else:
            mref = "=" if q.mchr == q.chr else (
                "*" if q.mchr < 0 else names[q.mchr])
            o.append(f"\t{mref}\t{q.mpos + 1}\t{q.isize}\t")
        beg, end = 0, l
        if opt.hard_clip and q.cigar:
            if q.cigar[0][0] == 4:
                beg += q.cigar[0][1]
            if q.cigar[-1][0] == 4:
                end -= q.cigar[-1][1]
        if p.flag & 0x10:
            o.append("".join(NT_COMP[ord(raw[l - 1 - j])]
                             for j in range(beg, end)))
        else:
            o.append(raw[beg:end])
        if read.qual:
            if p.flag & 0x10:
                o.append("\t" + "".join(read.qual[l - 1 - j]
                                        for j in range(beg, end)))
            else:
                o.append("\t" + read.qual[beg:end])
        else:
            o.append("\t*")
        o.append(f"\tAS:i:{p.G}\tXS:i:{p.G2}\tXF:i:{p.flag >> 16}"
                 f"\tXE:i:{p.n_seeds}\tNM:i:{q.nm}")
        if q.nn:
            o.append(f"\tXN:i:{q.nn}")
        if p.l:
            o.append(f"\tXI:i:{p.l - p.k + 1}")
        xt = (1 if p.flag & BSW2_FLAG_MATESW else 0) | \
             (2 if p.flag & BSW2_FLAG_TANDEM else 0)
        if xt:
            o.append(f"\tXT:i:{xt}")
        if opt.cpy_cmt and read.comment:
            cmt = read.comment
            if len(cmt) >= 6 and cmt[2] == ":" and cmt[4] == ":":
                o.append("\t" + cmt)
        out.write("".join(o) + "\n")


# ---------------------------------------------------------- per-read loop

def flag_fr(b0, b1):
    """bwtsw2_aux.c:298-319."""
    for p in b0:
        p.flag |= 0x10000
    for p in b1:
        p.flag |= 0x20000
    for p in b0:
        for q in b1:
            if q.beg == p.beg and q.end == p.end and q.k == p.k and \
                    q.len == p.len and q.G == p.G:
                q.flag |= 0x30000
                p.flag |= 0x30000
                break


def aln1_core(opt, hfm, sa_lookup, l, seq01, rng, dev):
    """bsw2_aln1_core (bwtsw2_aux.c:248-295)."""
    bwtl = BwtLite(seq01[0])
    with timers.section("bwasw.traversal"):
        b_all, b_narrow = core.bsw2_core(hfm, sa_lookup, opt, bwtl)
    bb = [[[], []], [[], []]]
    for k, lst in enumerate((b_all, b_narrow)):
        for h in lst:
            if h.is_rev:
                h.beg, h.end = l - h.end, l - h.beg
            bb[h.is_rev][k].append(h)
    bb[0][1], bb[1][1] = bchain.chain_filter(opt, l, bb[0][1], bb[1][1])
    b = [None, None]
    for k in range(2):
        extend_left(opt, bb[k][1], seq01[k], l, hfm, dev)
        bb[k][0] = merge_hits(bb[k][0], bb[k][1], l, 0)
        bb[k][0] = core.resolve_duphits(None, None, bb[k][0], 0)
        extend_rght(opt, bb[k][0], seq01[k], l, hfm, dev)
        bb[k][0] = core.resolve_duphits(None, None, bb[k][0], 0)
        b[k] = bb[k][0]
    b0 = merge_hits(b[0], b[1], l, 1)
    return core.resolve_query_overlaps(b0, opt.mask_level, rng)


def seqs_nt4(read, l, rng):
    """2-bit conversion with drand48 N randomization
    (bwtsw2_aux.c:585-592); returns (seq[2], n_ambiguous)."""
    fwd = np.empty(l, np.uint8)
    n_amb = 0
    for i, c in enumerate(read.seq):
        if c >= 4:
            c = int(rng.drand() * 4)
            n_amb += 1
        fwd[i] = c
    rc = (3 - fwd)[::-1].copy()
    return [fwd, rc], n_amb


def aln_core(opt0, hfm, sa_lookup, reads, is_pe, rng, out, err, dev):
    """bsw2_aln_core (bwtsw2_aux.c:561-644) for one chunk, single thread.
    The reference converts each read a second time (drawing its Ns from
    the stream again) right before its CIGARs; every conversion is made
    here in the same order, and the CIGARs of the whole chunk then go to
    the device as one batch."""
    from bwamem_tpu_torch.bwasw import pair as bpair
    buf = []
    opt = opt0
    for read in reads:
        l = read.l_seq
        opt = update_opt(opt0, l)
        seq01, n_amb = seqs_nt4(read, l, rng)
        if l - n_amb < opt.t:
            buf.append([])
            continue
        b0 = aln1_core(opt, hfm, sa_lookup, l, seq01, rng, dev)
        if any(h.n_seeds < opt.t_seeds for h in b0):
            rseq01 = [seq01[1], seq01[0]]
            b1 = aln1_core(opt, hfm, sa_lookup, l, rseq01, rng, dev)
            for p in b1:
                p.flag ^= 0x10
                p.is_rev ^= 1
                p.beg, p.end = l - p.end, l - p.beg
            flag_fr(b0, b1)
            b0 = merge_hits(b0, b1, l, 0)
            b0 = core.resolve_duphits(None, None, b0, 0)
            b0 = core.resolve_query_overlaps(b0, opt.mask_level, rng)
        buf.append([h.copy() for h in b0])
    if is_pe:
        with timers.section("bwasw.pair_sw"):
            bpair.bsw2_pair(opt, hfm, reads, buf, err, dev)
    per_read = []
    for read, hits in zip(reads, buf):
        opt = update_opt(opt0, read.l_seq)
        seq01, _ = seqs_nt4(read, read.l_seq, rng)
        per_read.append((opt, read.l_seq, seq01, hits,
                         [Aux() for _ in hits]))
    gen_cigars(per_read, hfm, dev)
    with timers.section("bwasw.sam"):
        for ropt, _, _, hits, auxs in per_read:
            write_aux(ropt, hfm, hits, auxs)
        for x, read in enumerate(reads):
            bx, ax = per_read[x][3], per_read[x][4]
            if is_pe:
                update_mate_aux((bx, ax), (per_read[x ^ 1][3],
                                           per_read[x ^ 1][4]))
            print_hits(hfm, opt, read, bx, ax, is_pe, out)


def bsw2_aln(opt, idx, fn1, fn2=None, out=None, err=None, device=None):
    """bsw2_aln (bwtsw2_aux.c:727-776): stream chunks, align, emit SAM to
    `out` and the messages to `err` (sys.stdout and sys.stderr as they are
    at the call when None).  The device work runs on `device` ("cuda" when
    None; raises without a GPU)."""
    from bwamem_tpu_torch.io.fastq import read_fastx, interleave
    from bwamem_tpu_torch.pipeline.align import resolve_device

    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    dev = resolve_device(device)
    hfm = HostFM(idx)
    fm = fmops.fm_from_index(idx, dev)
    it = torch.int64 if fm.itype == torch.int64 else torch.int32

    def sa_lookup(ranks: np.ndarray) -> np.ndarray:
        with timers.section("bwasw.sa_lookup"):
            rk = torch.from_numpy(np.asarray(ranks, np.int64)).to(it)
            return fmops.sa_lookup(fm, rk.to(dev)).cpu().numpy()

    for c in idx.contigs:
        out.write(f"@SQ\tSN:{c.name}\tLN:{c.len}\n")
    rng = Drand48(11)  # srand48(11), bwtsw2_main.c:18

    def reader():
        it1 = read_fastx(fn1, keep_raw=True)
        if fn2:
            src = interleave(it1, read_fastx(fn2, keep_raw=True))
        else:
            src = it1

            def trim(r):
                if len(r.name) > 2 and r.name[-2] == "/" and \
                        r.name[-1].isdigit():
                    r.name = r.name[:-2]
                return r
            src = (trim(r) for r in src)
        return src

    src = reader()
    is_pe = fn2 is not None
    step = 2 if is_pe else 1
    chunk_cap = opt.chunk_size * opt.n_threads
    chunk = []
    size = 0

    def flush():
        nonlocal chunk, size
        if not chunk:
            return
        err.write(f"[bsw2_aln] read {len(chunk)} sequences/pairs "
                  f"({size} bp) ...\n")
        aln_core(opt, hfm, sa_lookup, chunk, is_pe, rng, out, err, dev)
        chunk = []
        size = 0

    pending = []
    for r in src:
        pending.append(r)
        if len(pending) == step:
            chunk.extend(pending)
            size += sum(p.l_seq for p in pending)
            pending = []
            if size >= chunk_cap:
                flush()
    if pending:
        chunk.extend(pending)
        size += sum(p.l_seq for p in pending)
    flush()
