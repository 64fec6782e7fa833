"""End-to-end single-end alignment driver: reads -> SAM records.

Maps the reference's per-batch flow (mem_process_seqs, bwamem.c:1215-1244)
onto the device/host split:

  device (pipeline.device_front): nt4 batch -> 3-pass SMEM collection ->
      SA walk -> chaining -> speculative banded extension, one fetch
  device + host (pipeline.seeding_host, chainflt_host, extend_host): the
      host-compacted front for the rows and batches the device front hands
      back (long reads, seed-cap overflows, demoted rows)
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
from bwamem_tpu_torch.ops import local_sw
from bwamem_tpu_torch.pipeline import _shapes
from bwamem_tpu_torch.pipeline._shapes import pow2_bucket
from bwamem_tpu_torch.utils import timers


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
        self.ctg_lens_np = idx.contig_lens()
        self.ctg_is_alt_np = idx.is_alt_flags()
        self.ctg_names = [c.name for c in idx.contigs]
        self.ctg_annos = [c.anno for c in idx.contigs]
        self.pac = idx.pac
        self.l_pac = int(idx.l_pac)
        # arena high-water histories of the two fronts, by batch shape
        self._front_hist: dict = {}
        self._seed_arena_hist: dict = {}
        from bwamem_tpu_torch import native
        native.load()

    # ---------------------------------------------------------- device ops

    def _device_ksw(self, q, qlen, t, tlen, minsc, p):
        """Batched ksw_align2 (ops/local_sw) on the aligner's device over
        numpy lanes; returns a KswResult of numpy arrays.  p = SIMD stripe
        of the emulated ksw kernel: 16 when every lane has l_ms*a < 250
        (KSW_XBYTE, bwamem_pair.c:176), else 8; the caller groups jobs
        accordingly.  LQ is padded so phantom columns fit."""
        B = q.shape[0]
        dev = self.device
        LQ = pow2_bucket(-(-q.shape[1] // p) * p, lo=32)
        LT = pow2_bucket(t.shape[1], lo=64)
        outs = []
        for s0, c in _shapes.chunks(B, _shapes.lane_tile(dev)):
            Bp = _shapes.lanes(c, dev, fine_lo=8, coarse_lo=64)
            sl = slice(s0, s0 + c)

            def put(a, **pad):
                return torch.from_numpy(np.pad(a, **pad)).to(dev)

            timers.count("dispatch.local_sw")
            res = local_sw.ksw_align_batch(
                put(q[sl], pad_width=((0, Bp - c), (0, LQ - q.shape[1])),
                    constant_values=4),
                put(qlen[sl], pad_width=(0, Bp - c), constant_values=0),
                put(t[sl], pad_width=((0, Bp - c), (0, LT - t.shape[1])),
                    constant_values=4),
                put(tlen[sl], pad_width=(0, Bp - c), constant_values=0),
                put(minsc[sl], pad_width=(0, Bp - c), constant_values=1),
                self.opt.mat, o_del=self.opt.o_del, e_del=self.opt.e_del,
                o_ins=self.opt.o_ins, e_ins=self.opt.e_ins,
                max_mat=int(self.opt.a), p=p)
            outs.append([x.cpu().numpy()[:c] for x in res])
        return local_sw.KswResult(*(np.concatenate(xs) for xs in zip(*outs)))

    # ------------------------------------------------ shared host phases

    def begin_batch(self, reads: list[Read]) -> dict:
        """Pack a batch and (when the device front supports it) DISPATCH
        its device front without fetching.  The returned token feeds
        align_batch_se's `_front` parameter; align_stream calls this for
        batch k+1 before batch k's host tail so the device computes
        ahead."""
        from bwamem_tpu_torch.pipeline import device_front
        n = len(reads)
        N = pow2_bucket(n, lo=8)
        L = _lbucket(max(r.l_seq for r in reads))
        seq, l_seq = pack_batch(reads, N, L)
        tok = None
        if device_front.supported(self, reads):
            tok = device_front.front_start(self, reads, seq, l_seq)
        return dict(seq=seq, l_seq=l_seq, tok=tok)

    def _regs_from_device(self, reads: list[Read],
                          front: dict | None = None, _prefetch=None
                          ) -> list[list[fin.AlnReg]]:
        """Front half + the tail of mem_align1_core (dedup + is_alt,
        bwamem.c:1083-1095).  Returns per-read reg lists, pre-mark_primary.

        Primary path: pipeline.device_front (everything through extension
        on the device, one fetch).  Rows it cannot take (cap overflows,
        long reads needing mem_flt_chained_seeds, demoted rows) are re-run
        through the host-compacted front and merged by row; so are whole
        batches it does not support."""
        from bwamem_tpu_torch.pipeline import device_front
        n = len(reads)
        if front is None:
            front = self.begin_batch(reads)
        if front["tok"] is not None:
            out, fb_rows = device_front.front_finish(self, front["tok"])
            timers.count("front.fallback_rows", len(fb_rows))
            if fb_rows:
                sub_regs = self._regs_host_front([reads[i] for i in fb_rows])
                for gi, i in enumerate(fb_rows):
                    out[i] = sub_regs[gi]
        else:
            timers.count("front.fallback_rows", n)
            out = self._regs_host_front(reads, seq=front["seq"],
                                        l_seq=front["l_seq"])
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

    def _regs_host_front(self, reads: list[Read], seq=None, l_seq=None):
        """Host-compacted front half (pipeline.seeding_host +
        pipeline.extend_host) — for the rows and batches the device front
        cannot take.  Returns per-read reg lists in mem_chain2aln emission
        order (pre-dedup)."""
        from bwamem_tpu_torch.pipeline import (chainflt_host, extend_host,
                                               seeding_host)
        n = len(reads)
        if seq is None:
            N = pow2_bucket(n, lo=8)
            L = _lbucket(max(r.l_seq for r in reads))
            seq, l_seq = pack_batch(reads, N, L)
        groups = seeding_host.front_half(self, reads, seq, l_seq)
        out: list[list[fin.AlnReg]] = [[] for _ in range(n)]
        for ridx, wr in groups:
            g_reads = [reads[i] for i in ridx]
            # long-read seed re-scoring (mem_flt_chained_seeds) — no-op for
            # short reads, see the gate in chainflt_host
            with timers.section("seed.flt_chained"):
                chainflt_host.flt_chained_seeds(self, g_reads, wr)
            g_regs = extend_host.extend_regions(self, g_reads, seq[ridx],
                                                wr)
            for gi, i in enumerate(ridx):
                out[i] = g_regs[gi]
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
