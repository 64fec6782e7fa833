"""SAM text rendering on host from numeric alignment records.

Byte-equivalent of mem_aln2sam (reference bwamem.c:832-956) and
bwa_print_sam_hdr (bwa.c:520-541).  The reference GPU renders SAM text in
kernels with a device kstring (SAMGEN_aln2sam_finegrain_kernel,
cuda/bwamem_GPU.cu:3323-3402, which omits all optional tags); we instead
keep alignment output numeric on the device and do the (cheap, branchy)
text on host with the FULL tag set of the CPU path: NM MD MC AS XS RG SA pa XA
XR — the part the reference left unfinished.
"""
from __future__ import annotations

import copy
from typing import Optional

from bwamem_tpu_torch.config import (MemOptions, MEM_F_SOFTCLIP, MEM_F_REF_HDR)
from bwamem_tpu_torch.finalize import Aln
from bwamem_tpu_torch.io.fastq import Read

CIGAR_CHARS = "MIDSH"
COMP = "TGCAN"
FWD = "ACGTN"
# nt4 code (0-4) → base byte, for C-speed bytes.translate rendering
_FWD_TB = bytes.maketrans(bytes(range(5)), b"ACGTN")
_COMP_TB = bytes.maketrans(bytes(range(5)), b"TGCAN")


def sam_header(contigs, rg_line: Optional[str] = None,
               pg_line: Optional[str] = None,
               hdr_line: Optional[str] = None) -> str:
    out = []
    if not (hdr_line and "@SQ\t" in hdr_line):
        for c in contigs:
            ah = "\tAH:*" if c.is_alt else ""
            out.append(f"@SQ\tSN:{c.name}\tLN:{c.len}{ah}")
    if hdr_line:
        out.append(hdr_line)
    if rg_line:
        out.append(rg_line)
    if pg_line:
        out.append(pg_line)
    return "".join(s + "\n" for s in out)


def _cigar_text(opt: MemOptions, p: Aln, which: int) -> str:
    """add_cigar (bwamem.c:819-830): hard clips for supplementary."""
    if not p.cigar:
        return "*"
    out = []
    for op, ln in p.cigar:
        c = op
        if not (opt.flag & MEM_F_SOFTCLIP) and not p.is_alt and c in (3, 4):
            c = 4 if which else 3
        out.append(f"{ln}{CIGAR_CHARS[c]}")
    return "".join(out)


def _rlen(p: Aln) -> int:
    return sum(ln for op, ln in p.cigar if op in (0, 2))


class SamBatch:
    """Batch SAM renderer: collect (read, alns, which, mate) line specs,
    render them all at once through the native line builder
    (hostops.c:sam_batch) — one ~1 us C pass per line instead of ~20 us of
    Python string assembly.  aln2sam renders the same bytes one line at a
    time."""

    def __init__(self, opt: MemOptions, ctg_names: list[str],
                 rg_id: Optional[str] = None,
                 ctg_annos: Optional[list[str]] = None):
        self.opt = opt
        self.ctg_names = ctg_names
        self.rg_id = rg_id
        self.ctg_annos = ctg_annos
        self.specs: list[tuple] = []

    def add(self, read: Read, n: int, alns: list[Aln], which: int,
            m: Optional[Aln] = None) -> int:
        self.specs.append((read, n, alns, which, m))
        return len(self.specs) - 1

    def render(self) -> list[str]:
        from bwamem_tpu_torch import native
        if not self.specs:
            return []
        import numpy as np
        opt = self.opt
        soft_all = 1 if (opt.flag & MEM_F_SOFTCLIP) else 0
        nl = len(self.specs)
        fields = np.zeros((nl, 20), np.int32)
        names, cigars, seqs, quals, mds, mcs, sas, xas, tails = \
            ([] for _ in range(9))
        empty = np.zeros(0, np.uint32)
        empty_seq = np.zeros(0, np.uint8)
        for b, (read, n, alns, which, m) in enumerate(self.specs):
            p = alns[which]
            flag = p.flag
            prid, ppos, prev_, pcig = p.rid, p.pos, p.is_rev, p.cigar
            if m is not None:
                flag |= 0x1
                mrid, mpos, mrev, mcig = m.rid, m.pos, m.is_rev, m.cigar
            flag |= 0x4 if prid < 0 else 0
            flag |= 0x8 if (m is not None and m.rid < 0) else 0
            if prid < 0 and m is not None and mrid >= 0:
                prid, ppos, prev_, pcig = mrid, mpos, mrev, []
            if m is not None and mrid < 0 and prid >= 0:
                mrid, mpos, mrev, mcig = prid, ppos, prev_, []
            flag |= 0x10 if prev_ else 0
            flag |= 0x20 if (m is not None and mrev) else 0
            f = fields[b]
            f[0] = flag
            f[1] = prid
            f[2] = ppos
            f[3] = p.mapq
            f[4] = which
            f[5] = p.is_alt
            f[6] = 1 if prev_ else 0
            f[7] = read.l_seq
            f[8] = p.NM
            f[9] = p.score
            f[10] = p.sub
            f[11] = p.alt_sc
            f[19] = soft_all
            names.append(read.name.encode())
            if pcig:
                cigars.append(np.asarray(
                    [(ln << 4) | op for op, ln in pcig], np.uint32))
                mds.append(p.MD.encode())
            else:
                cigars.append(empty)
                mds.append(b"")
            if flag & 0x100:
                seqs.append(empty_seq)
                quals.append(b"")
            else:
                seqs.append(read.seq)
                quals.append(read.qual.encode() if read.qual else b"")
            if m is not None:
                f[12] = 1
                f[13] = mrid
                f[14] = mpos
                f[15] = 1 if mrev else 0
                f[16] = _rlen_list(mcig)
                f[17] = 1 if mcig else 0
                mcs.append(_cigar_text_list(opt, mcig, m.is_alt,
                                            which).encode()
                           if mcig else b"")
            else:
                f[13] = -1
                mcs.append(b"")
            # SA payload (supplementary list, non-secondary lines only)
            sa = b""
            if not (flag & 0x100):
                parts = []
                for i2 in range(n):
                    r2 = alns[i2]
                    if i2 == which or (r2.flag & 0x100):
                        continue
                    cig = "".join(f"{ln}{CIGAR_CHARS[op]}"
                                  for op, ln in r2.cigar)
                    parts.append(
                        f"{self.ctg_names[r2.rid]},{r2.pos + 1},"
                        f"{'+-'[r2.is_rev]},{cig},{r2.mapq},{r2.NM};")
                sa = "".join(parts).encode()
            sas.append(sa)
            xas.append(p.XA.encode() if p.XA else b"")
            tail = ""
            if read.comment:
                tail += "\t" + read.comment
            if (opt.flag & MEM_F_REF_HDR) and prid >= 0 and \
                    self.ctg_annos and self.ctg_annos[prid]:
                tail += "\tXR:Z:" + self.ctg_annos[prid].replace("\t", " ")
            tails.append(tail.encode())
        ctg_blob = b""
        ctg_off = np.zeros(len(self.ctg_names) + 1, np.int64)
        bl = []
        pos = 0
        for i2, nm in enumerate(self.ctg_names):
            e = nm.encode()
            bl.append(e)
            pos += len(e)
            ctg_off[i2 + 1] = pos
        ctg_blob = b"".join(bl)
        rg = (self.rg_id or "").encode()
        return native.sam_render_batch(
            fields, names, cigars, seqs, quals, mds, mcs, sas, xas, tails,
            ctg_blob, ctg_off, rg, 1 if (opt.flag & 0x2000) else 0)


def _rlen_list(cigar) -> int:
    return sum(ln for op, ln in cigar if op in (0, 2))


def _cigar_text_list(opt: MemOptions, cigar, is_alt: int, which: int) -> str:
    if not cigar:
        return "*"
    out = []
    for op, ln in cigar:
        c = op
        if not (opt.flag & MEM_F_SOFTCLIP) and not is_alt and c in (3, 4):
            c = 4 if which else 3
        out.append(f"{ln}{CIGAR_CHARS[c]}")
    return "".join(out)


def aln2sam(opt: MemOptions, ctg_names: list[str], read: Read, n: int,
            alns: list[Aln], which: int, m: Optional[Aln] = None,
            rg_id: Optional[str] = None,
            ctg_annos: Optional[list[str]] = None) -> str:
    """One SAM line (mem_aln2sam, bwamem.c:832-956).  `m` = mate record for
    the PE path; None for single-end."""
    p = copy.copy(alns[which])
    if m is not None:
        m = copy.copy(m)
    p.flag |= 0x1 if m is not None else 0
    p.flag |= 0x4 if p.rid < 0 else 0
    p.flag |= 0x8 if (m is not None and m.rid < 0) else 0
    if p.rid < 0 and m is not None and m.rid >= 0:
        p.rid, p.pos, p.is_rev, p.cigar = m.rid, m.pos, m.is_rev, []
    if m is not None and m.rid < 0 and p.rid >= 0:
        m.rid, m.pos, m.is_rev, m.cigar = p.rid, p.pos, p.is_rev, []
    p.flag |= 0x10 if p.is_rev else 0
    p.flag |= 0x20 if (m is not None and m.is_rev) else 0

    s = [read.name, "\t",
         str((p.flag & 0xFFFF) | (0x100 if p.flag & 0x10000 else 0)), "\t"]
    if p.rid >= 0:
        s += [ctg_names[p.rid], "\t", str(p.pos + 1), "\t", str(p.mapq),
              "\t", _cigar_text(opt, p, which)]
    else:
        s.append("*\t0\t0\t*")
    s.append("\t")

    if m is not None and m.rid >= 0:
        s.append("=" if p.rid == m.rid else ctg_names[m.rid])
        s += ["\t", str(m.pos + 1), "\t"]
        if p.rid == m.rid:
            p0 = p.pos + (_rlen(p) - 1 if p.is_rev else 0)
            p1 = m.pos + (_rlen(m) - 1 if m.is_rev else 0)
            if not m.cigar or not p.cigar:
                s.append("0")
            else:
                s.append(str(-(p0 - p1 + (1 if p0 > p1 else
                                          -1 if p0 < p1 else 0))))
        else:
            s.append("0")
    else:
        s.append("*\t0\t0")
    s.append("\t")

    # SEQ / QUAL
    if p.flag & 0x100:
        s.append("*\t*")
    else:
        qb, qe = 0, read.l_seq
        if p.cigar and which and not (opt.flag & MEM_F_SOFTCLIP) \
                and not p.is_alt:
            c0, cl = p.cigar[0]
            cn, cnl = p.cigar[-1]
            if not p.is_rev:
                if c0 in (3, 4):
                    qb += cl
                if cn in (3, 4):
                    qe -= cnl
            else:
                if c0 in (3, 4):
                    qe -= cl
                if cn in (3, 4):
                    qb += cnl
        if not p.is_rev:
            s.append(bytes(read.seq[qb:qe]).translate(_FWD_TB).decode())
            s.append("\t")
            s.append(read.qual[qb:qe] if read.qual else "*")
        else:
            s.append(bytes(read.seq[qe - 1:None if qb == 0 else qb - 1:-1])
                     .translate(_COMP_TB).decode())
            s.append("\t")
            s.append(read.qual[qe - 1:None if qb == 0 else qb - 1:-1]
                     if read.qual else "*")

    # optional tags
    if p.cigar:
        s += ["\tNM:i:", str(p.NM), "\tMD:Z:", p.MD]
    if m is not None and m.cigar:
        s += ["\tMC:Z:", _cigar_text(opt, m, which)]
    if p.score >= 0:
        s += ["\tAS:i:", str(p.score)]
    if p.sub >= 0:
        s += ["\tXS:i:", str(p.sub)]
    if rg_id:
        s += ["\tRG:Z:", rg_id]
    if not (p.flag & 0x100):
        others = [i for i in range(n)
                  if i != which and not (alns[i].flag & 0x100)]
        if others:
            s.append("\tSA:Z:")
            for i in range(n):
                r = alns[i]
                if i == which or (r.flag & 0x100):
                    continue
                cig = "".join(f"{ln}{CIGAR_CHARS[op]}" for op, ln in r.cigar)
                s.append(f"{ctg_names[r.rid]},{r.pos + 1},"
                         f"{'+-'[r.is_rev]},{cig},{r.mapq},{r.NM};")
        if p.alt_sc > 0:
            s.append("\tpa:f:%.3f" % (p.score / p.alt_sc))
    if p.XA:
        s += ["\tXB:Z:" if opt.flag & 0x2000 else "\tXA:Z:", p.XA]
    if read.comment:
        s += ["\t", read.comment]
    if (opt.flag & MEM_F_REF_HDR) and p.rid >= 0 and ctg_annos \
            and ctg_annos[p.rid]:
        s += ["\tXR:Z:", ctg_annos[p.rid].replace("\t", " ")]
    s.append("\n")
    return "".join(s)
