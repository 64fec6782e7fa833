"""End-to-end single-end alignment driver: reads -> SAM records.

Maps the reference's per-batch flow (mem_process_seqs, bwamem.c:1215-1244)
onto the device/host split:

  device (pipeline.device_front): nt4 batch -> 3-pass SMEM collection ->
      SA walk -> chaining -> speculative banded extension, one fetch
  host   (device_front._replay, finalize.py): exact chain filter and
      accept/skip walk -> dedup/patch -> primary marking -> record
      selection & XA phase A -> native banded global alignment (CIGAR)
  host   (io.sam): NM/MD, clips, flags, SAM text

Entry points run on the card: Aligner(device=None) uses "cuda" and raises
when no GPU is present; pass device="cpu" to run on the CPU.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from bwamem_tpu_torch import finalize as fin
from bwamem_tpu_torch.config import (MemOptions, MEM_F_ALL, MEM_F_NO_MULTI,
                                     MEM_F_KEEP_SUPP_MAPQ, MEM_F_PRIMARY5)
from bwamem_tpu_torch.io import sam as samio
from bwamem_tpu_torch.io.fastq import Read, pack_batch
from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.utils import timers


def _bucket(x: int, lo: int = 32) -> int:
    n = lo
    while n < x:
        n <<= 1
    return n


def _lbucket(x: int) -> int:
    """Read-length pad: next multiple of 32 (the seeding scans' trip counts
    grow with the padded L)."""
    return max(32, -(-x // 32) * 32)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names
    another.  Raises when CUDA is asked for and no GPU is present — there
    is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev


class FallbackRowsError(NotImplementedError):
    """Rows that need the host-compacted front, which this package does not
    have yet (seed-cap overflows, long reads entering
    mem_flt_chained_seeds, reads the final two-round walk demotes)."""

    def __init__(self, rows):
        self.rows = list(rows)
        super().__init__(
            f"{len(self.rows)} read(s) need the host-compacted front, which "
            f"is not ported yet (first rows: {self.rows[:8]})")


class Aligner:
    """Holds the device-resident index and the arena-size history."""

    def __init__(self, idx, opt: MemOptions | None = None, device=None):
        self.device = resolve_device(device)
        self.idx = idx
        self.opt = opt or MemOptions()
        self.fm = fmops.fm_from_index(idx, self.device)
        it = self.fm.itype
        self.ctg_offsets = torch.from_numpy(
            idx.contig_offsets().astype(np.int64)).to(self.device, it)
        self.ctg_is_alt = torch.from_numpy(
            np.asarray(idx.is_alt_flags())).to(self.device)
        self.ctg_offsets_np = idx.contig_offsets()
        self.ctg_is_alt_np = idx.is_alt_flags()
        self.ctg_names = [c.name for c in idx.contigs]
        self.ctg_annos = [c.anno for c in idx.contigs]
        self.pac = idx.pac
        self.l_pac = int(idx.l_pac)
        self._front_hist: dict = {}
        from bwamem_tpu_torch import native
        native.load()

    # ------------------------------------------------ shared host phases

    def begin_batch(self, reads: list[Read]) -> dict:
        """Pack a batch and DISPATCH its device front without fetching.
        The returned token feeds align_batch_se's `_front` parameter;
        align_stream calls this for batch k+1 before batch k's host tail so
        the device computes ahead."""
        from bwamem_tpu_torch.pipeline import device_front
        n = len(reads)
        N = _bucket(n, lo=8)
        L = _lbucket(max(r.l_seq for r in reads))
        seq, l_seq = pack_batch(reads, N, L)
        if not device_front.supported(self, reads):
            raise FallbackRowsError(range(n))
        return dict(tok=device_front.front_start(self, reads, seq, l_seq))

    def _regs_from_device(self, reads: list[Read],
                          front: dict | None = None, _prefetch=None
                          ) -> list[list[fin.AlnReg]]:
        """Device front half + the tail of mem_align1_core (dedup + is_alt,
        bwamem.c:1083-1095).  Returns per-read reg lists, pre-mark_primary.
        Raises FallbackRowsError when rows need the host-compacted front."""
        from bwamem_tpu_torch.pipeline import device_front
        n = len(reads)
        if front is None:
            front = self.begin_batch(reads)
        out, fb_rows = device_front.front_finish(self, front["tok"])
        timers.count("front.fallback_rows", len(fb_rows))
        if fb_rows:
            raise FallbackRowsError(fb_rows)
        if _prefetch is not None:
            # the device is idle for this batch from here on — enqueue the
            # NEXT batch's front now so the host tail overlaps it
            _prefetch()
        with timers.section("dedup.batch"):
            for i in range(n):
                ri = fin.sort_dedup_patch(self.opt, self.pac, self.l_pac,
                                          reads[i].seq, out[i])
                for r in ri:
                    if r.rid >= 0 and self.ctg_is_alt_np[r.rid]:
                        r.is_alt = 1
                out[i] = ri
        return out

    def _phaseA_batch(self, all_regs, reads, jobs):
        """Vectorized phase-A selection over the whole batch: the
        mem_gen_alt XA accounting (bwamem_extra.c:117-141) and the
        mem_reg2sam pick conditions (bwamem.c:1025-1041) evaluated as flat
        numpy over the batch reg table; only the CigarJob materialization
        of the survivors stays per-job Python.  Returns (xa_jobs, sel) with
        per-read job ordering: XA jobs in reg order, then picks in reg
        order."""
        opt = self.opt
        n_reads = len(all_regs)
        empty = [[] for _ in range(n_reads)]
        counts = np.fromiter((len(r) for r in all_regs), np.int64, n_reads)
        off = np.zeros(n_reads + 1, np.int64)
        np.cumsum(counts, out=off[1:])
        total = int(off[-1])
        if total == 0:
            return empty, [[] for _ in range(n_reads)]
        score = np.fromiter((r.score for rs in all_regs for r in rs),
                            np.int64, total)
        sec = np.fromiter((r.secondary for rs in all_regs for r in rs),
                          np.int64, total)
        sec_all = np.fromiter(
            (r.secondary_all for rs in all_regs for r in rs), np.int64,
            total)
        alt = np.fromiter((bool(r.is_alt) for rs in all_regs for r in rs),
                          bool, total)
        read_of = np.repeat(np.arange(n_reads, dtype=np.int64), counts)
        k_local = np.arange(total, dtype=np.int64) - off[read_of]
        nloc = counts[read_of]

        # ---- mem_gen_alt XA candidates ----
        if opt.flag & MEM_F_ALL:
            xa_keep = np.zeros(total, bool)
            pri = np.full(total, -1, np.int64)
        else:
            r_ok = (sec_all >= 0) & (sec_all < nloc)
            gpri = np.where(r_ok, off[read_of] + np.clip(sec_all, 0, None),
                            0)
            ok = r_ok & (score >= score[gpri] * opt.XA_drop_ratio)
            cnt = np.bincount(gpri[ok], minlength=total)
            has_alt = np.bincount(gpri[ok & alt],
                                  minlength=total).astype(bool)
            xa_keep = ok & ~((cnt[gpri] > opt.max_XA_hits_alt)
                             | (~has_alt[gpri]
                                & (cnt[gpri] > opt.max_XA_hits)))
            pri = np.where(ok, sec_all, -1)

        # ---- mem_reg2sam picks ----
        all_f = bool(opt.flag & MEM_F_ALL)
        pick = score >= opt.T
        pick &= ~((sec >= 0) & (alt | (not all_f)))
        s_ok = (sec >= 0) & (sec < nloc)
        gsec = np.where(s_ok, off[read_of] + np.clip(sec, 0, None), 0)
        pick &= ~(s_ok & (sec < fin.INT_MAX)
                  & (score < score[gsec] * opt.drop_ratio))

        # ---- materialize jobs in the per-read [XA..., picks...] order ----
        xa_idx = np.nonzero(xa_keep)[0]
        pick_idx = np.nonzero(pick)[0]
        flat = np.concatenate([xa_idx, pick_idx])
        stream = np.concatenate([np.zeros(xa_idx.size, np.int8),
                                 np.ones(pick_idx.size, np.int8)])
        order = np.lexsort((flat, stream, read_of[flat]))
        xa_jobs = empty
        sel = [[] for _ in range(n_reads)]
        fl = flat.tolist()
        st = stream.tolist()
        ro = read_of.tolist()
        kl = k_local.tolist()
        pr = pri.tolist()
        for t in order.tolist():
            g = fl[t]
            i = ro[g]
            rd = reads[i]
            jobs.append(fin.CigarJob(reg=all_regs[i][kl[g]], query=rd.seq,
                                     l_query=rd.l_seq))
            if st[t] == 0:
                xa_jobs[i].append((kl[g], pr[g], len(jobs) - 1))
            else:
                sel[i].append((kl[g], len(jobs) - 1))
        return xa_jobs, sel

    def _xa_strings(self, xas, fins):
        """mem_gen_alt rendering (bwamem_extra.c:142-160).  `fins` is the
        batched finish_jobs output, aligned with the job list."""
        xa_by_pri: dict[int, list[str]] = {}
        for k, r, jidx in xas:
            t = fins[jidx]
            cig = "".join(f"{ln}{'MIDSHN'[op]}" for op, ln in t.cigar)
            entry = (f"{self.ctg_names[t.rid]},{'+-'[t.is_rev]}"
                     f"{t.pos + 1},{cig},{t.NM}")
            if self.opt.flag & 0x2000:  # MEM_F_XB
                entry += f",{t.score}"
            xa_by_pri.setdefault(r, []).append(entry + ";")
        return xa_by_pri

    def _phaseC_reg2sam(self, read, regs, picks, xa_by_pri, fins,
                        extra_flag, mate, sb):
        """mem_reg2sam phase C (bwamem.c:1025-1056).  Lines are enqueued on
        the SamBatch; returns the line indices for this read."""
        opt = self.opt
        alns: list[fin.Aln] = []
        for k, jidx in picks:
            p = regs[k]
            q = copy.copy(fins[jidx])  # never mutate the shared job result
            assert q.rid >= 0
            if k in xa_by_pri:
                q.XA = "".join(xa_by_pri[k])
            q.flag |= extra_flag
            if p.secondary >= 0:
                q.sub = -1
            if alns and p.secondary < 0:
                q.flag |= 0x10000 if opt.flag & MEM_F_NO_MULTI else 0x800
            if not (opt.flag & MEM_F_KEEP_SUPP_MAPQ) and alns and \
                    not p.is_alt and q.mapq > alns[0].mapq:
                q.mapq = alns[0].mapq
            alns.append(q)
        if not alns:
            t = fin.unmapped_aln()
            t.flag |= extra_flag
            return [sb.add(read, 1, [t], 0, m=mate)]
        return [sb.add(read, len(alns), alns, w, m=mate)
                for w in range(len(alns))]

    # ------------------------------------------------------------ SE batch

    def align_batch_se(self, reads: list[Read], n_processed: int = 0,
                       rg_id: str | None = None, *, _front: dict = None,
                       _prefetch=None) -> list[str]:
        """Returns one SAM string (possibly multi-line) per read.

        `_front`: a begin_batch token for THIS batch (already dispatched);
        `_prefetch`: a callable invoked right after this batch's last
        device work — align_stream uses it to enqueue the NEXT batch's
        front so the device never idles behind the host tail."""
        opt = self.opt
        if not reads:
            return []
        all_regs = self._regs_from_device(reads, _front, _prefetch=_prefetch)
        jobs: list[fin.CigarJob] = []
        with timers.section("mark.batch"):
            fin.mark_primary_many(
                opt, all_regs, [n_processed + i for i in range(len(reads))])
        with timers.section("select.batch"):
            if opt.flag & MEM_F_PRIMARY5:
                for regs in all_regs:
                    fin.reorder_primary5(opt, regs)
            xa_jobs, sel = self._phaseA_batch(all_regs, reads, jobs)
        with timers.section("cigar.jobs"):
            fin.run_cigar_jobs(opt, self.pac, self.l_pac, jobs)
        sb = samio.SamBatch(opt, self.ctg_names, rg_id, self.ctg_annos)
        idxs = []
        with timers.section("phaseC.batch"):
            fins = fin.finish_jobs(opt, self.ctg_offsets_np, self.l_pac,
                                   jobs)
            for i, regs in enumerate(all_regs):
                xa = self._xa_strings(xa_jobs[i], fins)
                idxs.append(self._phaseC_reg2sam(reads[i], regs, sel[i], xa,
                                                 fins, 0, None, sb))
        with timers.section("sam.render"):
            lines = sb.render()
        return ["".join(lines[j] for j in ix) for ix in idxs]


def align_stream(al: Aligner, batch_iter, *, rg_id: str | None = None):
    """Pipelined single-end batch driver: a dispatch-ahead serial loop.
    Batch k+1's device front is ENQUEUED right after batch k's front
    results are fetched, so the device computes batch k+1's seeding,
    chaining and extension while the host runs batch k's finalization tail
    and SAM render.  CUDA launches are asynchronous, so no threads are
    needed.

    `batch_iter` yields lists of Reads; yields (n_reads, sam_list) per
    batch in input order."""
    it = iter(batch_iter)
    try:
        cur = next(it)
    except StopIteration:
        return
    n_processed = 0
    front = al.begin_batch(cur)
    while cur is not None:
        try:
            nxt = next(it)
        except StopIteration:
            nxt = None
        holder = []
        prefetch = None
        if nxt is not None:
            def prefetch(_b=nxt):
                holder.append(al.begin_batch(_b))
        sams = al.align_batch_se(cur, n_processed, rg_id=rg_id,
                                 _front=front, _prefetch=prefetch)
        yield len(cur), sams
        n_processed += len(cur)
        if nxt is None:
            front = None
        elif holder:
            front = holder[0]
        else:
            front = al.begin_batch(nxt)
        cur = nxt
