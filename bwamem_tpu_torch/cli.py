"""Command-line interface — the reference CLI surface, as far as ported.

`python -m bwamem_tpu_torch.cli mem [options] <idxbase> <in1.fq> [in2.fq]`
mirrors main_mem's getopt (reference fastmap.c:77-238), mode presets
(:240-268), update_a rescaling (:43-57) and the header/ordering behavior of
main() (main.c:57-137).  Two FASTQs, or -p on one interleaved file, align as
pairs; -I fixes the insert-size distribution.

The index tools (`index`, `fa2pac`, `pac2bwt`, `pac2bwtgen`, `bwtupdate`,
`bwt2sa`, `shm`) run on the host; `fastmap`, `maxk` and `pemerge` run their
scans or SW on the card, and the legacy `aln`, `samse` and `sampe` their
FM lookups, SA walks and SWs, and the long-read `bwasw` its extensions,
global alignments, SA walks and mate SWs.  Flags, messages and exit codes
are the JAX package's (bwamem_tpu/cli.py).  Every device command runs on
the card unless the caller passes another device to main().
"""
from __future__ import annotations

import getopt as getopt_mod
import os
import sys
import time

from bwamem_tpu_torch.config import (MemOptions, preset, MEM_F_ALL,
                                     MEM_F_PE, MEM_F_NOPAIRING,
                                     MEM_F_NO_MULTI, MEM_F_NO_RESCUE,
                                     MEM_F_SOFTCLIP, MEM_F_REF_HDR,
                                     MEM_F_PRIMARY5, MEM_F_KEEP_SUPP_MAPQ,
                                     MEM_F_XB, MEM_F_SMARTPE)
from bwamem_tpu_torch.utils import timers

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


def cmd_mem(argv: list[str], device=None, mesh=None) -> int:
    """`mem` on `device` (default "cuda"), or data-parallel over `mesh`
    (parallel.make_mesh); with neither, over the local cards when
    BWAMEM_TPU_DEVICES allows two or more (_local_mesh).  Under
    BWAMEM_COORDINATOR / BWAMEM_NUM_PROCESSES / BWAMEM_PROCESS_ID it is one
    rank of a multi-process run (parallel/multihost): it aligns its share
    of the -K chunks into <out or bwamem_out.sam>.shard<rank>, and rank 0
    merges the shards into the output after a barrier.  With
    BWAMEM_TPU_TIMERS=1 a one-process run ends by writing timers.report()
    (utils/timers) to stderr."""
    opt, touched, x, args = parse_mem_args(argv)
    if len(args) < 2 or len(args) > 3:
        sys.stderr.write(
            "Usage: bwamem_tpu mem [options] <idxbase> <in1.fq> [in2.fq]\n")
        return 1
    from bwamem_tpu_torch.parallel import multihost
    pid, nproc = multihost.init_from_env()
    try:
        return _mem(argv, opt, x, args, device, mesh, pid, nproc)
    finally:
        multihost.finalize()


def _mem(argv, opt, x, args, device, mesh, pid: int, nproc: int) -> int:
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io import sam as samio
    from bwamem_tpu_torch.io.fastq import read_fastx, interleave
    from bwamem_tpu_torch.parallel import multihost
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
    if mesh is None and device is None:
        mesh = _local_mesh()
    al = Aligner(idx, opt, device=device, mesh=mesh)
    # multi-process: only rank 0 owns the output stream (header + merge)
    out = None
    if pid == 0:
        out = open(x["out"], "w") if x["out"] else sys.stdout
        pg = ("@PG\tID:bwamem_tpu\tPN:bwamem_tpu\tVN:0.1.0\tCL:" +
              " ".join(["bwamem_tpu", "mem"] + argv))
        hdr = [x["hdr_line"]] if x["hdr_line"] else []
        if x["rg_line"]:
            hdr.append(x["rg_line"])
        out.write(samio.sam_header(idx.contigs, pg_line=pg,
                                   hdr_line="\n".join(hdr) if hdr
                                   else None))
    rg = _rg_id(x["rg_line"])
    n_processed = 0
    chunk = x["fixed_chunk"] if x["fixed_chunk"] > 0 else \
        opt.chunk_size * opt.n_threads
    if nproc > 1:
        # this rank aligns chunks pid, pid + nproc, ... into a shard; rank
        # 0 merges them in chunk order after the barrier (chunk-local
        # pestat makes this byte-identical to one process).  As in the
        # reference, -I does not reach the chunks here: each infers its
        # own insert-size distribution.
        base = x["out"] or "bwamem_out.sam"
        shard = f"{base}.shard{pid}"
        sys.stderr.write(f"[M::mem] multi-host rank {pid}/{nproc}; "
                         f"shard -> {shard}\n")
        t0 = time.perf_counter()
        done = multihost.align_shard(
            al, _batches_by_bases(rdr, chunk, pe), process_id=pid,
            num_processes=nproc, shard_path=shard, pe=pe, rg_id=rg)
        sys.stderr.write(f"[M::mem] rank {pid} aligned {done} reads\n")
        _rank_report(pid, done, time.perf_counter() - t0)
        # raises on a rank that is gone, or at the group's timeout
        import torch.distributed as dist
        dist.barrier()
        if pid == 0:
            t0 = time.perf_counter()
            out.flush()
            shards = [f"{base}.shard{r}" for r in range(nproc)]
            n = multihost.merge_shards(shards, out.buffer
                                       if hasattr(out, "buffer") else out)
            if timers.enabled():
                sys.stderr.write(f"[M::mem] merged {n} chunks of {nproc} "
                                 f"shards in "
                                 f"{time.perf_counter() - t0:.3f} s\n")
            if x["out"]:
                out.close()
        return 0
    # reads per batch ~ chunk bases (bseq_read semantics, bwa.c:195-210)
    for n, sams in align_stream(al, _batches_by_bases(rdr, chunk, pe),
                                pe=pe, rg_id=rg, pes0=x["pes"]):
        for s in sams:
            out.write(s)
        n_processed += n
        sys.stderr.write(f"[M::mem] processed {n_processed} reads\n")
    if x["out"]:
        out.close()
    if timers.enabled():
        # BWAMEM_TPU_TIMERS=1: the stage, device and counter table
        sys.stderr.write(timers.report() + "\n")
    return 0


def _rank_report(pid: int, done: int, secs: float) -> None:
    """With the stage timers on (BWAMEM_TPU_TIMERS=1): one stderr line of
    this rank's wall time, its extension kernel launches and its rows
    through the host-compacted front."""
    if not timers.enabled():
        return
    from bwamem_tpu_torch.ops import ext_kernel
    snap = timers.snapshot()
    sys.stderr.write(
        f"[M::mem] rank {pid}: {done} reads in {secs:.3f} s; "
        f"ext_pl2_kernel launches {ext_kernel.launches}, ext_pl_kernel "
        f"launches {ext_kernel.launches_pl}, fallback rows "
        f"{snap.get('front.fallback_rows.count', 0)}, fetch timeouts "
        f"{snap.get('front.fetch_timeouts.count', 0)}\n")


def _local_mesh():
    """Data-parallel mesh over the local cards when more than one is
    visible.  BWAMEM_TPU_DEVICES=N caps the count (1 turns it off); the
    mesh takes the largest power of two of them.  None under two."""
    import torch
    from bwamem_tpu_torch.parallel import make_mesh
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = min(int(os.environ.get("BWAMEM_TPU_DEVICES", have)), have)
    if want < 2:
        return None
    n = 1 << (want.bit_length() - 1)   # largest power-of-two prefix
    sys.stderr.write(f"[M::mem] data-parallel mesh over {n} devices\n")
    return make_mesh([f"cuda:{i}" for i in range(n)])


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


def cmd_index(argv: list[str]) -> int:
    if len(argv) < 1:
        sys.stderr.write("Usage: bwamem_tpu index <in.fa> [prefix]\n")
        return 1
    fa = argv[0]
    prefix = argv[1] if len(argv) > 1 else fa
    from bwamem_tpu_torch.index import build_index
    idx = build_index(fa, with_kmer_table=True)
    idx.save(prefix)                   # native arrays (<prefix>.bt.npz …)
    idx.save_reference_format(prefix)  # bit-identical .pac/.ann/.amb/.bwt/.sa
    return 0


def _smem_reads(argv_idx: str, reads_path: str, min_intv: int, device):
    """(index, FM, per-batch (reads, SmemBatch)) of fastmap and maxk:
    batches of 4096 reads, the SMEM scans of pipeline/seeding_host on
    `device`.  timers: index.load (the index and its FM on the device)."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.io.fastq import batches, read_fastx
    from bwamem_tpu_torch.ops import fm as fmops
    from bwamem_tpu_torch.pipeline import seeding_host as sh
    from bwamem_tpu_torch.pipeline.align import resolve_device
    from bwamem_tpu_torch.utils import timers
    dev = resolve_device(device)
    with timers.section("index.load"):
        idx = load_index(argv_idx)
        fm = fmops.fm_from_index(idx, dev)

    def gen():
        for batch in batches(read_fastx(reads_path), 4096):
            yield batch, sh.smem_batch(fm, batch, min_intv)
    return idx, fm, gen()


def cmd_fastmap(argv: list[str], device=None) -> int:
    """SMEM dump — output format of `bwa fastmap` (fastmap.c:324-399):
    SQ/EM lines, per-pivot SMEMs sorted by start, reference coordinates for
    intervals of size <= -w."""
    import numpy as np
    import torch
    min_iwidth, min_len, min_intv, print_seq = 20, 17, 1, False
    try:
        opts, args = getopt_mod.getopt(argv, "w:l:pi:I:L:")
    except getopt_mod.GetoptError as e:
        raise SystemExit(f"[E::fastmap] {e}")
    for c, v in opts:
        if c == "-w":
            min_iwidth = int(v)
        elif c == "-l":
            min_len = int(v)
        elif c == "-p":
            print_seq = True
        elif c == "-i":
            min_intv = int(v)
        elif c in ("-I", "-L"):
            sys.stderr.write(f"[W::fastmap] {c} not supported yet\n")
    if len(args) < 2:
        sys.stderr.write("Usage: bwamem_tpu fastmap [options] "
                         "<idxbase> <in.fq>\n")
        return 1
    from bwamem_tpu_torch.ops import fm as fmops
    from bwamem_tpu_torch.pipeline import seeding_host as sh
    idx, fm, smems = _smem_reads(args[0], args[1], min_intv, device)
    it = sh._np_itype(fm)
    offs = idx.contig_offsets()
    names = [c.name for c in idx.contigs]
    l_pac = int(idx.l_pac)

    for batch, sm in smems:
        n = len(batch)
        cnt, s, end, x0a, x2a = sm.cnt, sm.s, sm.end, sm.x0, sm.x2
        emit = sm.emit & ((end - s) >= min_len)
        # SA positions for hits of small intervals
        er, ec = np.nonzero(emit & (x2a <= min_iwidth) & (x2a > 0))
        hit_ranks, hit_owner = [], []
        for hi in range(er.size):
            x0v, x2v = int(x0a[er[hi], ec[hi]]), int(x2a[er[hi], ec[hi]])
            hit_ranks.extend(range(x0v, x0v + x2v))
            hit_owner.extend([hi] * x2v)
        pos_of = {}
        if hit_ranks:
            H = len(hit_ranks)
            rk = np.zeros(sh.pow2_bucket(H, lo=256), it)
            rk[:H] = hit_ranks
            sa = sh._fetch(fmops.sa_lookup(
                fm, torch.from_numpy(rk).to(fm.device)))[:H]
            for hi, p in zip(hit_owner, sa):
                pos_of.setdefault(hi, []).append(int(p))
        hit_idx = {(int(er[i]), int(ec[i])): i for i in range(er.size)}
        for i in range(n):
            r = batch[i]
            sq = "".join("ACGTN"[b] for b in r.seq)
            extra = f"\t{sq}" if print_seq else ""
            sys.stdout.write(f"SQ\t{r.name}\t{r.l_seq}{extra}\n")
            # per-pivot groups; emitted slots are already start-ascending
            # (back-extension start is non-decreasing in forward end), which
            # is the reference's order after bwt_reverse_intvs (bwt.c:346)
            k = 0
            while k < cnt[i]:
                j = k
                while j < cnt[i] and sm.pivot[i, j] == sm.pivot[i, k]:
                    j += 1
                for slot in range(k, j):
                    if not emit[i, slot]:
                        continue
                    st, en = int(s[i, slot]), int(end[i, slot])
                    x2v = int(x2a[i, slot])
                    line = [f"EM\t{st}\t{en}\t{x2v}"]
                    if (i, slot) in hit_idx and x2v <= min_iwidth:
                        ln = en - st
                        for p in pos_of.get(hit_idx[(i, slot)], []):
                            is_rev = p >= l_pac
                            pf = 2 * l_pac - 1 - p if is_rev else p
                            if is_rev:
                                pf -= ln - 1
                            rid = int(np.searchsorted(offs, pf,
                                                      side="right") - 1)
                            line.append(f"\t{names[rid]}:"
                                        f"{'+-'[is_rev]}"
                                        f"{pf - offs[rid] + 1}")
                    else:
                        line.append("\t*")
                    sys.stdout.write("".join(line) + "\n")
                k = j
            sys.stdout.write("//\n")
    return 0


def cmd_maxk(argv: list[str], device=None) -> int:
    """Max exact-match length histogram (main_maxk, maxk.c:12-67): for every
    base of the input, the length of the longest SMEM covering it (clamped
    to 255); prints the 256-bin histogram."""
    import numpy as np
    self_mode = False
    try:
        opts, args = getopt_mod.getopt(argv, "s")
    except getopt_mod.GetoptError as e:
        raise SystemExit(f"[E::maxk] {e}")
    for c, _ in opts:
        if c == "-s":
            self_mode = True
    if len(args) < 2:
        sys.stderr.write("Usage: bwamem_tpu maxk [-s] <index.prefix> "
                         "<seq.fa>\n")
        return 1
    min_intv = 2 if self_mode else 1   # smem_config(itr,2,INT_MAX,0)
    # the reference passes its first arg straight to bwt_restore_bwt
    # (maxk.c:31), i.e. it is the .bwt FILE; accept that or a bare prefix
    if args[0].endswith(".bwt"):
        args[0] = args[0][: -len(".bwt")]
    _, _, smems = _smem_reads(args[0], args[1], min_intv, device)
    hist = np.zeros(256, np.int64)
    for batch, sm in smems:
        for i in range(len(batch)):
            ln = int(sm.l_seq[i])
            cov = np.zeros(ln, np.uint8)
            for slot in np.nonzero(sm.emit[i])[0]:
                st, en = int(sm.s[i, slot]), int(sm.end[i, slot])
                l = min(en - st, 255)
                np.maximum(cov[st:en], l, out=cov[st:en])
            hist += np.bincount(cov, minlength=256)
    for i in range(256):
        sys.stdout.write(f"{i}\t{int(hist[i])}\n")
    return 0


def cmd_pemerge(argv: list[str], device=None) -> int:
    """Overlap-merge read pairs (main_pemerge, pemerge.c:217-291)."""
    from bwamem_tpu_torch import pemerge as pm
    from bwamem_tpu_torch.io.fastq import read_fastx, interleave
    opt = pm.PemOptions()
    flag, min_ovlp = 0, 10
    try:
        opts, args = getopt_mod.getopt(argv, "muQ:t:T:")
    except getopt_mod.GetoptError as e:
        raise SystemExit(f"[E::pemerge] {e}")
    for c, v in opts:
        if c == "-m":
            flag |= 1
        elif c == "-u":
            flag |= 2
        elif c == "-Q":
            opt.q_thres = int(v)
        elif c == "-t":
            opt.n_threads = int(v)
        elif c == "-T":
            min_ovlp = int(v)
    opt.flag = flag if flag else 3
    opt.T = opt.a * min_ovlp
    if not args:
        sys.stderr.write(
            "\nUsage:   bwamem_tpu pemerge [-mu] <read1.fq> [read2.fq]\n\n"
            "Options: -m       output merged reads only\n"
            "         -u       output unmerged reads only\n"
            f"         -t INT   number of threads [{opt.n_threads}]\n"
            f"         -T INT   minimum end overlap [{min_ovlp}]\n"
            f"         -Q INT   max sum of errors [{opt.q_thres}]\n\n")
        return 1
    if len(args) >= 2:
        it = interleave(read_fastx(args[0]), read_fastx(args[1]))
        trim = False                     # interleave already trimmed
    else:
        it = read_fastx(args[0])
        trim = True

    def pair_iter():
        prev = None
        for r in it:
            # trim_readno (bwa.c:73-77) also applies to single-file input
            if trim and len(r.name) > 2 and r.name[-2] == "/" and \
                    r.name[-1].isdigit():
                r.name = r.name[:-2]
            if prev is None:
                prev = r
            else:
                yield prev, r
                prev = None

    pm.run_pemerge(opt, pair_iter(), device=device)
    return 0


def cmd_shm(argv: list[str]) -> int:
    """Stage/list/drop shared-memory index copies (main_shm,
    bwashm.c:179-213)."""
    import os
    from bwamem_tpu_torch.index import shm
    to_list = to_drop = force = False
    try:
        opts, args = getopt_mod.getopt(argv, "ldf")
    except getopt_mod.GetoptError as e:
        raise SystemExit(f"[E::shm] {e}")
    for c, _ in opts:
        if c == "-l":
            to_list = True
        elif c == "-d":
            to_drop = True
        elif c == "-f":
            force = True
    if to_list:
        for p in shm.list_staged():
            sys.stdout.write(p + "\n")
        return 0
    if to_drop:
        n = shm.destroy(args[0] if args else None)
        sys.stderr.write(f"[M::shm] dropped {n} staged index(es)\n")
        return 0
    if not args:
        sys.stderr.write(
            "Usage: bwamem_tpu shm [-d|-l|-f] [idxbase]\n"
            "  stage <idxbase> into shared memory; -l list; -d drop\n")
        return 1
    if shm.test(args[0]) and not force:
        sys.stderr.write(f"[M::shm] index '{args[0]}' is already in "
                         "shared memory\n")
        return 0
    path = shm.stage(args[0], force=force)
    sz = os.path.getsize(path)
    sys.stderr.write(f"[M::shm] staged '{args[0]}' "
                     f"({sz / 1e6:.1f} MB) at {path}\n")
    return 0


def cmd_aln(argv: list[str], device=None) -> int:
    """Legacy bounded-diff aligner (bwa_aln, bwtaln.c:230-321)."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.legacy import aln as la
    from bwamem_tpu_torch.pipeline.align import resolve_device
    opt = la.GapOptions()
    opte = -1
    out_path = None
    try:
        opts, args = getopt_mod.getopt(argv, "n:o:e:i:d:l:k:LR:m:t:NM:O:E:"
                                             "q:f:b012IYB:")
    except getopt_mod.GetoptError as e:
        raise SystemExit(f"[E::aln] {e}")
    for c, v in opts:
        c = c[1:]
        if c == "n":
            if "." in v:
                opt.fnr, opt.max_diff = float(v), -1
            else:
                opt.max_diff, opt.fnr = int(v), -1.0
        elif c == "o":
            opt.max_gapo = int(v)
        elif c == "e":
            opte = int(v)
        elif c == "M":
            opt.s_mm = int(v)
        elif c == "O":
            opt.s_gapo = int(v)
        elif c == "E":
            opt.s_gape = int(v)
        elif c == "d":
            opt.max_del_occ = int(v)
        elif c == "i":
            opt.indel_end_skip = int(v)
        elif c == "l":
            opt.seed_len = int(v)
        elif c == "k":
            opt.max_seed_diff = int(v)
        elif c == "m":
            opt.max_entries = int(v)
        elif c == "t":
            opt.n_threads = int(v)
        elif c == "L":
            opt.mode |= la.BWA_MODE_LOGGAP
        elif c == "R":
            opt.max_top2 = int(v)
        elif c == "q":
            opt.trim_qual = int(v)
        elif c == "N":
            opt.mode |= la.BWA_MODE_NONSTOP
            opt.max_top2 = 0x7fffffff
        elif c == "f":
            out_path = v
        elif c in ("b", "0", "1", "2", "I", "Y", "B"):
            sys.stderr.write(f"[W::aln] -{c} not supported\n")
            return 1
    if opte > 0:
        opt.max_gape = opte
        opt.mode &= ~la.BWA_MODE_GAPE
    if len(args) < 2:
        sys.stderr.write("Usage: bwamem_tpu aln [options] <prefix> "
                         "<in.fq>\n")
        return 1
    if opt.fnr > 0.0:
        k = 0
        for i in range(17, 251):
            l = la.cal_maxdiff(i, la.BWA_AVG_ERR, opt.fnr)
            if l != k:
                sys.stderr.write(f"[bwa_aln] {i}bp reads: max_diff = {l}\n")
            k = l
    dev = resolve_device(device)
    idx = load_index(args[0])
    out = open(out_path, "wb") if out_path else sys.stdout.buffer
    try:
        la.aln_core(idx, args[1], opt, out, dev)
    finally:
        if out_path:
            out.close()
    return 0


def cmd_samse(argv: list[str], device=None) -> int:
    """bwa_sai2sam_se (bwase.c:585-611)."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.legacy import samse as ls
    from bwamem_tpu_torch.pipeline.align import resolve_device
    n_occ = 3
    rg_line = rg_id = out_path = None
    try:
        opts, args = getopt_mod.getopt(argv, "hn:f:r:")
    except getopt_mod.GetoptError as e:
        raise SystemExit(f"[E::samse] {e}")
    for c, v in opts:
        if c == "-n":
            n_occ = int(v)
        elif c == "-f":
            out_path = v
        elif c == "-r":
            rg_line = v.replace("\\t", "\t")
            for f_ in rg_line.split("\t"):
                if f_.startswith("ID:"):
                    rg_id = f_[3:]
    if len(args) < 3:
        sys.stderr.write("Usage: bwamem_tpu samse [-n max_occ] [-f out.sam]"
                         " [-r RG_line] <prefix> <in.sai> <in.fq>\n")
        return 1
    dev = resolve_device(device)
    idx = load_index(args[0])
    seed = ls.ann_seed(args[0])
    out = open(out_path, "w") if out_path else sys.stdout
    try:
        ls.samse_core(idx, args[1], args[2], n_occ, rg_line, rg_id, out,
                      dev, seed=seed)
    finally:
        if out_path:
            out.close()
    return 0


def cmd_sampe(argv: list[str], device=None) -> int:
    """bwa_sai2sam_pe (bwape.c:733-784)."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.legacy import samse as ls
    from bwamem_tpu_torch.legacy import sampe as lp
    from bwamem_tpu_torch.pipeline.align import resolve_device
    popt = lp.PeOptions()
    rg_line = rg_id = out_path = None
    try:
        opts, args = getopt_mod.getopt(argv, "a:o:sPn:N:c:f:Ar:")
    except getopt_mod.GetoptError as e:
        raise SystemExit(f"[E::sampe] {e}")
    for c, v in opts:
        if c == "-a":
            popt.max_isize = int(v)
        elif c == "-o":
            popt.max_occ = int(v)
        elif c == "-s":
            popt.is_sw = 0
        elif c == "-n":
            popt.n_multi = int(v)
        elif c == "-N":
            popt.N_multi = int(v)
        elif c == "-c":
            popt.ap_prior = float(v)
        elif c == "-f":
            out_path = v
        elif c == "-A":
            popt.force_isize = 1
        elif c == "-r":
            rg_line = v.replace("\\t", "\t")
            for f_ in rg_line.split("\t"):
                if f_.startswith("ID:"):
                    rg_id = f_[3:]
    if len(args) < 5:
        sys.stderr.write("Usage: bwamem_tpu sampe [options] <prefix> "
                         "<in1.sai> <in2.sai> <in1.fq> <in2.fq>\n")
        return 1
    dev = resolve_device(device)
    idx = load_index(args[0])
    seed = ls.ann_seed(args[0])
    out = open(out_path, "w") if out_path else sys.stdout
    try:
        lp.sampe_core(idx, args[1], args[2], args[3], args[4], popt,
                      rg_line, rg_id, out, sys.stderr, dev, seed=seed)
    finally:
        if out_path:
            out.close()
    return 0


def cmd_bwasw(argv: list[str], device=None) -> int:
    """BWA-SW long-read aligner (bwa_bwtsw2, bwtsw2_main.c:11-89)."""
    from bwamem_tpu_torch.index import load_index
    from bwamem_tpu_torch.bwasw import Bsw2Options, bsw2_aln
    from bwamem_tpu_torch.pipeline.align import resolve_device
    opt = Bsw2Options()
    out_path = None
    try:
        opts, args = getopt_mod.getopt(argv,
                                       "q:r:a:b:t:T:w:d:z:m:s:c:N:Hf:MI:SG:C")
    except getopt_mod.GetoptError as e:
        raise SystemExit(f"[E::bwasw] {e}")
    for c, v in opts:
        c = c[1:]
        if c == "q":
            opt.q = int(v)
        elif c == "r":
            opt.r = int(v)
        elif c == "a":
            opt.a = int(v)
        elif c == "b":
            opt.b = int(v)
        elif c == "w":
            opt.bw = int(v)
        elif c == "T":
            opt.t = int(v)
        elif c == "t":
            opt.n_threads = int(v)
        elif c == "z":
            opt.z = int(v)
        elif c == "s":
            opt.is_ = int(v)
        elif c == "m":
            opt.mask_level = float(v)
        elif c == "c":
            opt.coef = float(v)
        elif c == "N":
            opt.t_seeds = int(v)
        elif c == "M":
            opt.multi_2nd = 1
        elif c == "H":
            opt.hard_clip = 1
        elif c == "f":
            out_path = v
        elif c == "I":
            opt.max_ins = int(v)
        elif c == "S":
            opt.skip_sw = 1
        elif c == "C":
            opt.cpy_cmt = 1
        elif c == "G":
            opt.max_chain_gap = int(v)
    opt.qr = opt.q + opt.r
    if len(args) < 2:
        sys.stderr.write("Usage: bwamem_tpu bwasw [options] <target.prefix>"
                         " <query.fa> [query2.fa]\n")
        return 1
    # adjust for -a (bwtsw2_main.c:80-81)
    opt.t *= opt.a
    opt.coef *= opt.a
    dev = resolve_device(device)
    idx = load_index(args[0])
    out = open(out_path, "w") if out_path else sys.stdout
    try:
        bsw2_aln(opt, idx, args[1], args[2] if len(args) > 2 else None,
                 out=out, device=dev)
    finally:
        if out_path:
            out.close()
    return 0


def cmd_index_micro(cmd: str, argv: list[str]) -> int:
    """Low-level index steps (reference main.c:105-109): fa2pac, pac2bwt,
    pac2bwtgen, bwtupdate, bwt2sa — file-identical to the reference."""
    from bwamem_tpu_torch.index import microcmd
    args = list(argv)
    if cmd == "fa2pac":
        for_only = "-f" in args
        args = [a for a in args if a != "-f"]
        if not args:
            sys.stderr.write(
                "Usage: bwamem_tpu fa2pac [-f] <in.fasta> [<out.prefix>]\n")
            return 1
        microcmd.fa2pac(args[0], args[1] if len(args) > 1 else args[0],
                        for_only=for_only)
        return 0
    if cmd in ("pac2bwt", "pac2bwtgen"):
        # -d (ropebwt) / -b (block size) select reference-internal
        # construction algorithms; the BWT is unique, we always use SA-IS
        flt = []
        skip = False
        for a in args:
            if skip:
                skip = False
                continue
            if a == "-d":
                continue
            if a == "-b":
                skip = True
                continue
            flt.append(a)
        if len(flt) < 2:
            sys.stderr.write(
                f"Usage: bwamem_tpu {cmd} [-d] <in.pac> <out.bwt>\n")
            return 1
        microcmd.pac2bwt(flt[0], flt[1])
        return 0
    if cmd == "bwtupdate":
        if len(args) != 1:
            sys.stderr.write("Usage: bwamem_tpu bwtupdate <the.bwt>\n")
            return 1
        microcmd.bwtupdate(args[0])
        return 0
    # bwt2sa
    sa_intv = 32
    flt = []
    i = 0
    while i < len(args):
        if args[i] == "-i":
            sa_intv = int(args[i + 1])
            i += 2
            continue
        flt.append(args[i])
        i += 1
    if len(flt) < 2:
        sys.stderr.write(
            "Usage: bwamem_tpu bwt2sa [-i 32] <in.bwt> <out.sa>\n")
        return 1
    microcmd.bwt2sa(flt[0], flt[1], sa_intv)
    return 0


def main(argv: list[str] | None = None, device=None, mesh=None) -> int:
    """Dispatch a command; the device commands (mem, aln, samse, sampe,
    bwasw, fastmap, maxk, pemerge) run on `device` ("cuda" when None;
    raises without a GPU); `mem` runs over `mesh` when one is given."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        sys.stderr.write(
            "Usage: bwamem_tpu <mem|aln|samse|sampe|bwasw|index|fastmap"
            "|maxk|pemerge|shm> [options]\n")
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "mem":
        return cmd_mem(rest, device=device, mesh=mesh)
    if cmd == "index":
        return cmd_index(rest)
    if cmd == "fastmap":
        return cmd_fastmap(rest, device=device)
    if cmd == "maxk":
        return cmd_maxk(rest, device=device)
    if cmd == "pemerge":
        return cmd_pemerge(rest, device=device)
    if cmd == "shm":
        return cmd_shm(rest)
    if cmd == "aln":
        return cmd_aln(rest, device=device)
    if cmd == "samse":
        return cmd_samse(rest, device=device)
    if cmd == "sampe":
        return cmd_sampe(rest, device=device)
    if cmd == "bwasw":
        return cmd_bwasw(rest, device=device)
    if cmd in ("fa2pac", "pac2bwt", "pac2bwtgen", "bwtupdate", "bwt2sa"):
        return cmd_index_micro(cmd, rest)
    sys.stderr.write(f"[E::main] unknown command '{cmd}'\n")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
