"""Command-line interface: `mem`, single-end and paired-end.

`python -m bwamem_tpu_torch.cli mem [options] <idxbase> <in1.fq> [in2.fq]`
mirrors main_mem's getopt (reference fastmap.c:77-238), mode presets
(:240-268), update_a rescaling (:43-57) and the header/ordering behavior of
main() (main.c:57-137).  Two FASTQs, or -p on one interleaved file, align as
pairs; -I fixes the insert-size distribution.  The command runs on the card
unless the caller passes another device to main().
"""
from __future__ import annotations

import getopt as getopt_mod
import sys

from bwamem_tpu_torch.config import (MemOptions, preset, MEM_F_ALL,
                                     MEM_F_PE, MEM_F_NOPAIRING,
                                     MEM_F_NO_MULTI, MEM_F_NO_RESCUE,
                                     MEM_F_SOFTCLIP, MEM_F_REF_HDR,
                                     MEM_F_PRIMARY5, MEM_F_KEEP_SUPP_MAPQ,
                                     MEM_F_XB, MEM_F_SMARTPE)

MEM_GETOPT = "51qpaMCSPVYjuk:c:v:s:r:t:R:A:B:O:E:U:w:L:d:T:Q:D:m:I:N:o:f:W:x:G:h:y:K:X:H:"


def _pair(val: str) -> tuple[int, int | None]:
    for sep in ",;:/":
        if sep in val:
            a, b = val.split(sep, 1)
            return int(a), int(b)
    return int(val), None


def _update_a(opt: MemOptions, touched: set) -> None:
    """-A rescaling of dependent penalties (update_a, fastmap.c:43-57)."""
    if "a" not in touched:
        return
    for f in ("b", "T", "o_del", "e_del", "o_ins", "e_ins", "zdrop",
              "pen_clip5", "pen_clip3", "pen_unpaired"):
        if f not in touched:
            setattr(opt, f, getattr(opt, f) * opt.a)


def parse_mem_args(argv: list[str]):
    """Returns (opt, touched, extras dict, positional args)."""
    opt = MemOptions()
    touched: set[str] = set()
    x = dict(mode=None, rg_line=None, hdr_line=None, out=None,
             ignore_alt=False, fixed_chunk=-1, copy_comment=False,
             verbose=3, pes=None)
    try:
        opts, args = getopt_mod.getopt(argv, MEM_GETOPT)
    except getopt_mod.GetoptError as e:
        raise SystemExit(f"[E::mem] {e}")

    def seti(field, val):
        setattr(opt, field, val)
        touched.add(field)

    for c, v in opts:
        c = c[1:]
        if c == "k":
            seti("min_seed_len", int(v))
        elif c == "1":
            pass                       # no_mt_io: IO overlap toggle, no-op
        elif c == "x":
            x["mode"] = v
        elif c == "w":
            seti("w", int(v))
        elif c == "A":
            seti("a", int(v))
        elif c == "B":
            seti("b", int(v))
        elif c == "T":
            seti("T", int(v))
        elif c == "U":
            seti("pen_unpaired", int(v))
        elif c == "t":
            opt.n_threads = max(int(v), 1)
        elif c == "P":
            opt.flag |= MEM_F_NOPAIRING
        elif c == "a":
            opt.flag |= MEM_F_ALL
        elif c == "p":
            opt.flag |= MEM_F_PE | MEM_F_SMARTPE
        elif c == "M":
            opt.flag |= MEM_F_NO_MULTI
        elif c == "S":
            opt.flag |= MEM_F_NO_RESCUE
        elif c == "Y":
            opt.flag |= MEM_F_SOFTCLIP
        elif c == "V":
            opt.flag |= MEM_F_REF_HDR
        elif c == "5":
            opt.flag |= MEM_F_PRIMARY5 | MEM_F_KEEP_SUPP_MAPQ
        elif c == "q":
            opt.flag |= MEM_F_KEEP_SUPP_MAPQ
        elif c == "u":
            opt.flag |= MEM_F_XB
        elif c == "c":
            seti("max_occ", int(v))
        elif c == "d":
            seti("zdrop", int(v))
        elif c == "v":
            x["verbose"] = int(v)
        elif c == "j":
            x["ignore_alt"] = True
        elif c == "r":
            seti("split_factor", float(v))
        elif c == "D":
            seti("drop_ratio", float(v))
        elif c == "m":
            seti("max_matesw", int(v))
        elif c == "s":
            seti("split_width", int(v))
        elif c == "G":
            seti("max_chain_gap", int(v))
        elif c == "N":
            seti("max_chain_extend", int(v))
        elif c in ("o", "f"):
            x["out"] = v
        elif c == "W":
            seti("min_chain_weight", int(v))
        elif c == "y":
            seti("max_mem_intv", int(v))
        elif c == "C":
            x["copy_comment"] = True
        elif c == "K":
            x["fixed_chunk"] = int(v)
        elif c == "X":
            opt.mask_level = float(v)
        elif c == "h":
            a, b = _pair(v)
            opt.max_XA_hits = a
            opt.max_XA_hits_alt = b if b is not None else a
            touched |= {"max_XA_hits", "max_XA_hits_alt"}
        elif c == "Q":
            import math
            opt.mapQ_coef_len = int(v)
            opt.mapQ_coef_fac = (int(math.log(opt.mapQ_coef_len))
                                 if opt.mapQ_coef_len > 0 else 0)
            touched.add("mapQ_coef_len")
        elif c == "O":
            a, b = _pair(v)
            opt.o_del = a
            opt.o_ins = b if b is not None else a
            touched |= {"o_del", "o_ins"}
        elif c == "E":
            a, b = _pair(v)
            opt.e_del = a
            opt.e_ins = b if b is not None else a
            touched |= {"e_del", "e_ins"}
        elif c == "L":
            a, b = _pair(v)
            opt.pen_clip5 = a
            opt.pen_clip3 = b if b is not None else a
            touched |= {"pen_clip5", "pen_clip3"}
        elif c == "R":
            x["rg_line"] = v.replace("\\t", "\t")
        elif c == "H":
            if v.startswith("@"):
                prev = x["hdr_line"] or ""
                x["hdr_line"] = (prev + "\n" if prev else "") + v
            else:
                with open(v) as f:
                    lines = [l.rstrip("\n") for l in f if l.strip()]
                prev = x["hdr_line"] or ""
                x["hdr_line"] = "\n".join(([prev] if prev else []) + lines)
        elif c == "I":
            parts = [float(p) for p in v.replace(",", " ").split()]
            avg = parts[0]
            std = parts[1] if len(parts) > 1 else avg * .1
            high = int(parts[2] + .499) if len(parts) > 2 else \
                int(avg + 4. * std + .499)
            low = int(parts[3] + .499) if len(parts) > 3 else \
                max(int(avg - 4. * std + .499), 1)
            x["pes"] = dict(avg=avg, std=std, high=high, low=low)

    if x["mode"]:
        opt = preset(x["mode"], opt, touched)
    else:
        _update_a(opt, touched)
    return opt, touched, x, args


def _rg_id(rg_line: str | None):
    if not rg_line:
        return None
    for f in rg_line.split("\t"):
        if f.startswith("ID:"):
            return f[3:]
    return None


def cmd_mem(argv: list[str], device=None) -> int:
    opt, touched, x, args = parse_mem_args(argv)
    if len(args) < 2 or len(args) > 3:
        sys.stderr.write(
            "Usage: bwamem_tpu mem [options] <idxbase> <in1.fq> [in2.fq]\n")
        return 1
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io import sam as samio
    from bwamem_tpu_torch.io.fastq import read_fastx, interleave
    from bwamem_tpu_torch.pipeline.align import Aligner, align_stream

    idx = load_index(args[0])
    if x["ignore_alt"]:
        for c in idx.contigs:
            c.is_alt = 0
    rdr = read_fastx(args[1])
    pe = bool(opt.flag & MEM_F_PE)
    if len(args) == 3:
        if opt.flag & MEM_F_SMARTPE:
            sys.stderr.write("[W::mem] when '-p' is in use, the second "
                             "query file is ignored.\n")
        else:
            rdr = interleave(rdr, read_fastx(args[2]))
            opt.flag |= MEM_F_PE
            pe = True
    al = Aligner(idx, opt, device=device)
    out = open(x["out"], "w") if x["out"] else sys.stdout
    pg = ("@PG\tID:bwamem_tpu\tPN:bwamem_tpu\tVN:0.1.0\tCL:" +
          " ".join(["bwamem_tpu", "mem"] + argv))
    hdr = [x["hdr_line"]] if x["hdr_line"] else []
    if x["rg_line"]:
        hdr.append(x["rg_line"])
    out.write(samio.sam_header(idx.contigs, pg_line=pg,
                               hdr_line="\n".join(hdr) if hdr else None))
    rg = _rg_id(x["rg_line"])
    n_processed = 0
    chunk = x["fixed_chunk"] if x["fixed_chunk"] > 0 else \
        opt.chunk_size * opt.n_threads
    # reads per batch ~ chunk bases (bseq_read semantics, bwa.c:195-210)
    for n, sams in align_stream(al, _batches_by_bases(rdr, chunk, pe),
                                pe=pe, rg_id=rg, pes0=x["pes"]):
        for s in sams:
            out.write(s)
        n_processed += n
        sys.stderr.write(f"[M::mem] processed {n_processed} reads\n")
    if x["out"]:
        out.close()
    return 0


def _batches_by_bases(reads, max_bases: int, pe: bool):
    """bseq_read chunking: stop after >= max_bases, keeping pairs together
    (bwa.c:195-210)."""
    buf, nb = [], 0
    for r in reads:
        buf.append(r)
        nb += r.l_seq
        if nb >= max_bases and (not pe or len(buf) % 2 == 0):
            yield buf
            buf, nb = [], 0
    if buf:
        yield buf


def main(argv: list[str] | None = None, device=None) -> int:
    """`mem` on `device` ("cuda" when None; raises without a GPU)."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "mem":
        sys.stderr.write("Usage: bwamem_tpu_torch mem [options] <idxbase> "
                         "<in1.fq> [in2.fq]\n")
        return 1
    return cmd_mem(argv[1:], device=device)


if __name__ == "__main__":
    raise SystemExit(main())
