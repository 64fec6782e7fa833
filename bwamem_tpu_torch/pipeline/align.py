"""End-to-end alignment, single-end and paired-end: reads -> SAM records.

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
  host   (pair.py, paired-end only): insert-size stats over the batch,
      mate rescue (native unbanded SW in lockstep rounds), pair scoring
      (native pair_batch) between primary marking and record selection
  host   (io.sam): NM/MD, clips, flags, SAM text

Entry points run on the card: Aligner(device=None) uses "cuda" and raises
when no GPU is present; pass device="cpu" to run on the CPU.  With
mesh=parallel.make_mesh(devices) every device stage runs data-parallel over
the mesh's shards, the index replicated once per distinct device.

BWAMEM_TPU_FRONT=host sends every batch to the host-compacted front.
"""
from __future__ import annotations

import copy
import os

import numpy as np
import torch

from bwamem_tpu_torch import finalize as fin
from bwamem_tpu_torch import native
from bwamem_tpu_torch import pair as pairmod
from bwamem_tpu_torch.config import (MemOptions, MEM_F_ALL, MEM_F_NO_MULTI,
                                     MEM_F_KEEP_SUPP_MAPQ, MEM_F_PRIMARY5,
                                     MEM_F_NOPAIRING, MEM_F_NO_RESCUE)
from bwamem_tpu_torch.io import sam as samio
from bwamem_tpu_torch.io.fastq import Read, pack_batch
from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.ops import local_sw
from bwamem_tpu_torch.parallel import mesh as pmesh
from bwamem_tpu_torch.pipeline import _shapes
from bwamem_tpu_torch.pipeline._shapes import pow2_bucket
from bwamem_tpu_torch.utils import timers


def _lbucket(x: int) -> int:
    """Read-length pad: next multiple of 32 (the seeding scans' trip counts
    grow with the padded L)."""
    return max(32, -(-x // 32) * 32)


def raw_mapq(diff: int, a: int) -> int:
    """bwamem_pair.c:276"""
    return int(6.02 * diff / a + .499)


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

    def __init__(self, idx, opt: MemOptions | None = None, device=None,
                 mesh=None):
        """mesh: a parallel.mesh.Mesh -> every device stage runs
        shard-mapped data-parallel over it (parallel/mesh.rowmap), the
        index replicated once per distinct device; the aligner's device is
        then the mesh's first, where the shards' outputs are joined, and
        `device` may only name that one."""
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = mesh.devices[0]
            if device is not None and \
                    pmesh.make_mesh([device]).devices[0] != self.device:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {self.device}")
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
        # insert-size distribution of the last paired-end batch (pair.PeStat
        # per orientation), inferred by pestat or given by the caller
        self.last_pes = None
        # arena high-water histories of the two fronts, by batch shape
        from bwamem_tpu_torch.pipeline import device_front
        self._front_hist: dict = device_front.hist_load(self)
        self._seed_arena_hist: dict = {}
        # set when a device fetch outlasts its watchdog: every later batch
        # takes the host-compacted front (device_front.front_finish)
        self._front_disabled = False
        if mesh is not None:
            for t in (self.fm, self.fm.pac, self.ctg_offsets,
                      self.ctg_is_alt):
                pmesh.replicated(mesh, t)
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
            Bp = _shapes.lanes(c, dev, fine_lo=8, coarse_lo=64,
                               shards=pmesh.shards(self.mesh))
            sl = slice(s0, s0 + c)

            def put(a, **pad):
                return torch.from_numpy(np.pad(a, **pad)).to(dev)

            timers.count("dispatch.local_sw")
            # under a mesh: lanes sharded, the scoring matrix replicated
            res = pmesh.over(self.mesh, local_sw.ksw_align_batch, dict(
                o_del=self.opt.o_del, e_del=self.opt.e_del,
                o_ins=self.opt.o_ins, e_ins=self.opt.e_ins,
                max_mat=int(self.opt.a), p=p), (False,) * 5 + (True,))(
                put(q[sl], pad_width=((0, Bp - c), (0, LQ - q.shape[1])),
                    constant_values=4),
                put(qlen[sl], pad_width=(0, Bp - c), constant_values=0),
                put(t[sl], pad_width=((0, Bp - c), (0, LT - t.shape[1])),
                    constant_values=4),
                put(tlen[sl], pad_width=(0, Bp - c), constant_values=0),
                put(minsc[sl], pad_width=(0, Bp - c), constant_values=1),
                self.opt.mat)
            outs.append([x.cpu().numpy()[:c] for x in res])
        return local_sw.KswResult(*(np.concatenate(xs) for xs in zip(*outs)))

    def _device_worklist(self, seq: np.ndarray, l_seq: np.ndarray):
        """The single-program front half without extension
        (pipeline.seedchain.seed_chain_worklist, 256 seeds and 64 chains a
        read) on the aligner's device over a packed batch; returns a
        WorklistResult of numpy arrays."""
        from bwamem_tpu_torch.pipeline import seedchain
        wr = seedchain.seed_chain_worklist(
            self.fm, self.ctg_offsets, self.ctg_is_alt,
            torch.from_numpy(np.asarray(seq)).to(self.device),
            torch.from_numpy(np.asarray(l_seq)).to(self.device), self.opt)
        return type(wr)(type(wr.seeds)(*(x.cpu().numpy() for x in wr.seeds)),
                        *(x.cpu().numpy() for x in wr[1:]))

    # ------------------------------------------------ shared host phases

    def begin_batch(self, reads: list[Read]) -> dict:
        """Pack a batch and (when the device front supports it) DISPATCH
        its device front without fetching.  The returned token feeds
        align_batch_se's `_front` parameter; align_stream calls this for
        batch k+1 before batch k's host tail so the device computes
        ahead.  The host-compacted front takes the batch when the device
        front does not support it, after a fetch timeout turned it off, or
        when BWAMEM_TPU_FRONT=host asks for it."""
        from bwamem_tpu_torch.pipeline import device_front
        n = len(reads)
        N = pow2_bucket(n, lo=8)
        L = _lbucket(max(r.l_seq for r in reads))
        seq, l_seq = pack_batch(reads, N, L)
        tok = None
        if (device_front.supported(self, reads)
                and not self._front_disabled
                and os.environ.get("BWAMEM_TPU_FRONT") != "host"):
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
            timers.count("front.fallback.undispatched", n)
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
        order (pre-dedup).  timers: front.host, the whole of it."""
        from bwamem_tpu_torch.pipeline import (chainflt_host, extend_host,
                                               seeding_host)
        with timers.section("front.host"):
            n = len(reads)
            if seq is None:
                N = pow2_bucket(n, lo=8)
                L = _lbucket(max(r.l_seq for r in reads))
                seq, l_seq = pack_batch(reads, N, L)
            groups = seeding_host.front_half(self, reads, seq, l_seq)
            out: list[list[fin.AlnReg]] = [[] for _ in range(n)]
            for ridx, wr in groups:
                g_reads = [reads[i] for i in ridx]
                # long-read seed re-scoring (mem_flt_chained_seeds) — no-op
                # for short reads, see the gate in chainflt_host
                with timers.section("seed.flt_chained"):
                    chainflt_host.flt_chained_seeds(self, g_reads, wr)
                g_regs = extend_host.extend_regions(self, g_reads,
                                                    seq[ridx], wr)
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

    def _phaseA_gen_alt(self, regs, read, jobs):
        """mem_gen_alt accounting (bwamem_extra.c:117-141) → XA cigar jobs.
        Returns [(reg_idx, primary_idx, job_idx)]."""
        opt = self.opt
        xas = []
        if opt.flag & MEM_F_ALL:
            return xas
        cnt = [0] * len(regs)
        has_alt = [False] * len(regs)
        pri_of = []
        for k, p in enumerate(regs):
            r = p.secondary_all
            ok = r >= 0 and p.score >= regs[r].score * opt.XA_drop_ratio
            pri_of.append(r if ok else -1)
            if ok:
                cnt[r] += 1
                if p.is_alt:
                    has_alt[r] = True
        for k, p in enumerate(regs):
            r = pri_of[k]
            if r < 0:
                continue
            if cnt[r] > opt.max_XA_hits_alt or \
                    (not has_alt[r] and cnt[r] > opt.max_XA_hits):
                continue
            jobs.append(fin.CigarJob(reg=p, query=read.seq,
                                     l_query=read.l_seq))
            xas.append((k, r, len(jobs) - 1))
        return xas

    def _phaseA_reg2sam(self, regs, read, jobs):
        """mem_reg2sam selection (bwamem.c:1025-1041) → cigar jobs.
        Returns [(reg_idx, job_idx)]."""
        opt = self.opt
        picks = []
        for k, p in enumerate(regs):
            if p.score < opt.T:
                continue
            if p.secondary >= 0 and (p.is_alt or not (opt.flag & MEM_F_ALL)):
                continue
            if p.secondary >= 0 and p.secondary < fin.INT_MAX and \
                    p.score < regs[p.secondary].score * opt.drop_ratio:
                continue
            jobs.append(fin.CigarJob(reg=p, query=read.seq,
                                     l_query=read.l_seq))
            picks.append((k, len(jobs) - 1))
        return picks

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

    # ------------------------------------------------------------ PE batch

    def _matesw_rounds(self, reads, all_regs, pes, n_pairs):
        """Mate rescue (mem_sam_pe head, bwamem_pair.c:291-301): per pair a
        sequential list of mem_matesw calls; executed in lockstep rounds so
        the unbanded SW batches across pairs (native ksw_align_host)."""
        opt = self.opt
        # per-pair candidate lists b[0], b[1] (snapshot copies,
        # bwamem_pair.c:293-297)
        _t0 = timers.start("matesw.worklists")
        worklists = []
        for p in range(n_pairs):
            calls = []
            for i in range(2):
                a_i = all_regs[2 * p + i]
                if not a_i:
                    continue
                b = [r for r in a_i
                     if r.score >= a_i[0].score - opt.pen_unpaired]
                for reg in b[: opt.max_matesw]:
                    calls.append((i, copy.copy(reg)))
            worklists.append(calls)
        timers.stop("matesw.worklists", _t0)
        step = 0
        while True:
            batch_jobs = []
            owners = []
            any_left = False
            _t0 = timers.start("matesw.prepare")
            for p in range(n_pairs):
                if step >= len(worklists[p]):
                    continue
                any_left = True
                i, anchor = worklists[p][step]
                mate_read = reads[2 * p + (1 - i)]
                ma = all_regs[2 * p + (1 - i)]
                js = pairmod.prepare_matesw_call(
                    opt, self.pac, self.l_pac, self.ctg_offsets_np, pes,
                    anchor, mate_read.l_seq, mate_read.seq, ma)
                for j in js:
                    j.pair_i = p
                    j.end = 1 - i
                    owners.append(j)
                    if j.valid:
                        batch_jobs.append(j)
            timers.stop("matesw.prepare", _t0)
            if not any_left:
                break
            timers.count("matesw.rounds")
            timers.count("matesw.jobs", len(batch_jobs))
            _t0 = timers.start("matesw.sw")
            if batch_jobs:
                # group by ksw precision (XBYTE stripe 16 vs i16 stripe 8)
                for p_stripe, grp in (
                        (16, [j for j in batch_jobs
                              if j.l_ms * opt.a < 250]),
                        (8, [j for j in batch_jobs
                             if j.l_ms * opt.a >= 250])):
                    if not grp:
                        continue
                    # these are tiny branchy DPs: the native scalar loop
                    # (hostops.c ksw_align_host_batch) takes them on the
                    # host; ops/local_sw.ksw_align_batch computes the same
                    # function on the device
                    refs = [fin.get_seq_np(self.pac, self.l_pac,
                                           j.rb, j.re) for j in grp]
                    minsc = [opt.min_seed_len * opt.a] * len(grp)
                    r = native.ksw_align_host(
                        [j.seq for j in grp], refs, minsc, opt.mat,
                        opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                        int(opt.a), p_stripe)
                    for b, j in enumerate(grp):
                        j.result = (int(r["score"][b]), int(r["tb"][b]),
                                    int(r["te"][b]), int(r["qb"][b]),
                                    int(r["qe"][b]), int(r["score2"][b]))
            timers.stop("matesw.sw", _t0)
            # apply in (pair, r) order — r ascending within each call
            _t0 = timers.start("matesw.apply")
            for j in owners:
                ma = all_regs[2 * j.pair_i + j.end]
                if j.valid:
                    sc, tb, te, qb, qe, sc2 = j.result
                    pairmod.apply_matesw_result(opt, self.l_pac, j, sc, tb,
                                                te, qb, qe, sc2, ma)
            timers.stop("matesw.apply", _t0)
            step += 1

    def align_batch_pe(self, reads: list[Read], n_processed: int = 0,
                       rg_id: str | None = None,
                       pes0: dict | None = None, *, _front: dict = None,
                       _prefetch=None) -> list[str]:
        """Paired-end batch (mem_sam_pe, bwamem_pair.c:278-419); reads are
        interleaved R1,R2.  Returns one SAM string per read.
        `_front`/`_prefetch`: see align_batch_se."""
        opt = self.opt
        if not reads:
            return []
        assert len(reads) % 2 == 0, "PE batch must be interleaved pairs"
        n_pairs = len(reads) // 2
        # mate-rescue SW, CIGAR and SAM run in the native library, so the
        # device is done with this batch after the front fetch — the next
        # batch's front is prefetched there and the whole PE host tail
        # overlaps device compute (same schedule as align_batch_se)
        all_regs = self._regs_from_device(reads, _front,
                                          _prefetch=_prefetch)

        if pes0 is not None:
            pes = pairmod.pes_from_spec(pes0)
        else:
            with timers.section("pestat.batch"):
                pes = pairmod.pestat(
                    opt, self.l_pac,
                    [(all_regs[2 * p], all_regs[2 * p + 1])
                     for p in range(n_pairs)])
        self.last_pes = pes

        if not (opt.flag & MEM_F_NO_RESCUE):
            with timers.section("matesw.batch"):
                self._matesw_rounds(reads, all_regs, pes, n_pairs)

        # per-pair phase A
        jobs: list[fin.CigarJob] = []
        plans = []
        with timers.section("mark.batch"):
            ids = [(((n_processed >> 1) + (e >> 1)) << 1) | (e & 1)
                   for e in range(2 * n_pairs)]
            n_pri_all = fin.mark_primary_many(opt, all_regs, ids)

        # mem_pair over every eligible pair in ONE native pass
        # (hostops.c:pair_batch; pair.mem_pair is its plain counterpart).
        # Precomputable because nothing before the per-pair mem_pair call
        # mutates the reg tables — except -5 reordering, which keeps the
        # per-pair path.
        pair_pre = None
        if n_pairs and not (opt.flag & (MEM_F_PRIMARY5 | MEM_F_NOPAIRING)):
            with timers.section("pair.native"):
                elig = [p for p in range(n_pairs)
                        if n_pri_all[2 * p] and n_pri_all[2 * p + 1]]
                if elig:
                    n0 = np.fromiter((n_pri_all[2 * p] for p in elig),
                                     np.int64, len(elig))
                    n1 = np.fromiter((n_pri_all[2 * p + 1] for p in elig),
                                     np.int64, len(elig))
                    off0 = np.zeros(len(elig) + 1, np.int64)
                    off1 = np.zeros(len(elig) + 1, np.int64)
                    np.cumsum(n0, out=off0[1:])
                    np.cumsum(n1, out=off1[1:])

                    def flat(end, field, dt, tot):
                        return np.fromiter(
                            (getattr(r, field) for p in elig for r in
                             all_regs[2 * p + end]
                             [:n_pri_all[2 * p + end]]), dt, tot)
                    t0_, t1_ = int(off0[-1]), int(off1[-1])
                    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del,
                              opt.o_ins + opt.e_ins)
                    o_a, sub_a, nsub_a, z0_a, z1_a = native.pair_batch(
                        off0, off1,
                        flat(0, "rb", np.int64, t0_),
                        flat(0, "rid", np.int32, t0_),
                        flat(0, "score", np.int32, t0_),
                        flat(1, "rb", np.int64, t1_),
                        flat(1, "rid", np.int32, t1_),
                        flat(1, "score", np.int32, t1_),
                        [(n_processed >> 1) + p for p in elig],
                        self.ctg_offsets_np, self.l_pac, pes, opt.a, tmp)
                    pair_pre = {
                        p: (int(o_a[k]), int(sub_a[k]), int(nsub_a[k]),
                            [int(z0_a[k]), int(z1_a[k])])
                        for k, p in enumerate(elig)}
        _pair_t0 = timers.start("pair.batch")
        for p in range(n_pairs):
            pid = (n_processed >> 1) + p
            a = (all_regs[2 * p], all_regs[2 * p + 1])
            s = (reads[2 * p], reads[2 * p + 1])
            n_pri = [n_pri_all[2 * p], n_pri_all[2 * p + 1]]
            if opt.flag & MEM_F_PRIMARY5:
                fin.reorder_primary5(opt, a[0])
                fin.reorder_primary5(opt, a[1])
            plan = dict(mode="un", n_pri=n_pri, extra=1)
            paired = False
            if not (opt.flag & MEM_F_NOPAIRING) and n_pri[0] and n_pri[1]:
                if pair_pre is not None:
                    o, subo, n_sub, z = pair_pre[p]
                else:
                    o, subo, n_sub, z = pairmod.mem_pair(
                        opt, self.l_pac, self.ctg_offsets_np, pes, a, pid,
                        n_pri)
                if o > 0:
                    is_multi = False
                    for i in range(2):
                        if any(a[i][j].secondary < 0
                               and a[i][j].score >= opt.T
                               for j in range(1, n_pri[i])):
                            is_multi = True
                    if not is_multi:
                        paired = True
                        score_un = a[0][0].score + a[1][0].score - \
                            opt.pen_unpaired
                        subo = max(subo, score_un)
                        q_pe = raw_mapq(o - subo, opt.a)
                        if n_sub > 0:
                            q_pe -= int(4.343 * np.log(n_sub + 1) + .499)
                        q_pe = min(max(q_pe, 0), 60)
                        q_pe = int(q_pe * (1. - .5 * (a[0][0].frac_rep
                                                      + a[1][0].frac_rep))
                                   + .499)
                        extra = 1
                        if o > score_un:   # paired alignment preferred
                            q_se = [0, 0]
                            for i in range(2):
                                c = a[i][z[i]]
                                if c.secondary >= 0:
                                    c.sub = a[i][c.secondary].score
                                    c.secondary = -2
                                q_se[i] = fin.approx_mapq_se(opt, c)
                            for i in range(2):
                                q_se[i] = q_se[i] if q_se[i] > q_pe else \
                                    (q_pe if q_pe < q_se[i] + 40
                                     else q_se[i] + 40)
                            extra |= 2
                            for i in range(2):
                                c = a[i][z[i]]
                                cap = raw_mapq(c.score - c.csub, opt.a)
                                q_se[i] = min(q_se[i], cap)
                        else:
                            z = [0, 0]
                            q_se = [fin.approx_mapq_se(opt, a[0][0]),
                                    fin.approx_mapq_se(opt, a[1][0])]
                        # secondary/primary switcheroo (bwamem_pair.c:352)
                        for i in range(2):
                            k = a[i][z[i]].secondary_all
                            if 0 <= k < n_pri[i]:
                                for j in range(len(a[i])):
                                    if a[i][j].secondary_all == k or j == k:
                                        a[i][j].secondary_all = z[i]
                                a[i][z[i]].secondary_all = -1
                        xa = [self._phaseA_gen_alt(a[i], s[i], jobs)
                              for i in range(2)]
                        hjob = [None, None]
                        gjob = [None, None]
                        for i in range(2):
                            jobs.append(fin.CigarJob(reg=a[i][z[i]],
                                                     query=s[i].seq,
                                                     l_query=s[i].l_seq))
                            hjob[i] = len(jobs) - 1
                            if n_pri[i] < len(a[i]):
                                pp = a[i][n_pri[i]]
                                if pp.score < opt.T or pp.secondary >= 0 \
                                        or not pp.is_alt:
                                    continue
                                jobs.append(fin.CigarJob(reg=pp,
                                                         query=s[i].seq,
                                                         l_query=s[i].l_seq))
                                gjob[i] = len(jobs) - 1
                        plan = dict(mode="pair", n_pri=n_pri, z=z,
                                    q_se=q_se, extra=extra, xa=xa,
                                    hjob=hjob, gjob=gjob)
            if not paired:
                extra = 1
                which = [-1, -1]
                hjob = [None, None]
                for i in range(2):
                    if a[i]:
                        if a[i][0].score >= opt.T:
                            which[i] = 0
                        elif n_pri[i] < len(a[i]) and \
                                a[i][n_pri[i]].score >= opt.T:
                            which[i] = n_pri[i]
                    if which[i] >= 0:
                        jobs.append(fin.CigarJob(reg=a[i][which[i]],
                                                 query=s[i].seq,
                                                 l_query=s[i].l_seq))
                        hjob[i] = len(jobs) - 1
                # proper-pair flag from the selected records
                # (bwamem_pair.c:410-415)
                hrid = [a[i][which[i]].rid if which[i] >= 0 else -1
                        for i in range(2)]
                if not (opt.flag & MEM_F_NOPAIRING) and \
                        hrid[0] == hrid[1] and hrid[0] >= 0:
                    d, dist = pairmod.infer_dir(self.l_pac, a[0][0].rb,
                                                a[1][0].rb)
                    if not pes[d].failed and \
                            pes[d].low <= dist <= pes[d].high:
                        extra |= 2
                xa = [self._phaseA_gen_alt(a[i], s[i], jobs)
                      for i in range(2)]
                sel = [self._phaseA_reg2sam(a[i], s[i], jobs)
                       for i in range(2)]
                plan = dict(mode="un", n_pri=n_pri, extra=extra,
                            hjob=hjob, xa=xa, sel=sel)
            plans.append(plan)
        timers.stop("pair.batch", _pair_t0)

        with timers.section("cigar.jobs"):
            fin.run_cigar_jobs(opt, self.pac, self.l_pac, jobs)

        # phase C
        fins = fin.finish_jobs(opt, self.ctg_offsets_np, self.l_pac, jobs)
        sb = samio.SamBatch(opt, self.ctg_names, rg_id, self.ctg_annos)
        idxs: list[list[int]] = [[] for _ in range(len(reads))]
        for p in range(n_pairs):
            plan = plans[p]
            a = (all_regs[2 * p], all_regs[2 * p + 1])
            s = (reads[2 * p], reads[2 * p + 1])
            if plan["mode"] == "pair":
                z, q_se, extra = plan["z"], plan["q_se"], plan["extra"]
                h = [None, None]
                aa = [[], []]
                for i in range(2):
                    xa_by_pri = self._xa_strings(plan["xa"][i], fins)
                    hi = copy.copy(fins[plan["hjob"][i]])
                    hi.mapq = q_se[i]
                    hi.flag |= (0x40 << i) | extra
                    if z[i] in xa_by_pri:
                        hi.XA = "".join(xa_by_pri[z[i]])
                    h[i] = hi
                    aa[i].append(hi)
                    if plan["gjob"][i] is not None:
                        gi = copy.copy(fins[plan["gjob"][i]])
                        gi.flag |= 0x800 | (0x40 << i) | extra
                        npr = plan["n_pri"][i]
                        if npr in xa_by_pri:
                            gi.XA = "".join(xa_by_pri[npr])
                        aa[i].append(gi)
                for i in range(2):
                    idxs[2 * p + i] = [
                        sb.add(s[i], len(aa[i]), aa[i], w, m=h[1 - i])
                        for w in range(len(aa[i]))]
            else:
                extra = plan["extra"]
                h = [None, None]
                for i in range(2):
                    if plan["hjob"][i] is not None:
                        h[i] = fins[plan["hjob"][i]]
                    else:
                        h[i] = fin.unmapped_aln()
                for i in range(2):
                    xa_by_pri = self._xa_strings(plan["xa"][i], fins)
                    idxs[2 * p + i] = self._phaseC_reg2sam(
                        s[i], a[i], plan["sel"][i], xa_by_pri, fins,
                        (0x41 if i == 0 else 0x81) | extra, h[1 - i], sb)
        with timers.section("sam.render"):
            lines = sb.render()
        return ["".join(lines[j] for j in ix) for ix in idxs]


def align_stream(al: Aligner, batch_iter, *, pe: bool = False,
                 rg_id: str | None = None, pes0: dict | None = None):
    """Pipelined batch loop, single-end or paired-end (`pe`; batches are
    then interleaved R1,R2 and `pes0` is an optional -I spec): a
    dispatch-ahead serial loop.  Batch k+1's device front is ENQUEUED right
    after batch k's front results are fetched, so the device computes batch
    k+1's seeding, chaining and extension while the host runs batch k's
    finalization tail and SAM render.  CUDA launches are asynchronous, so
    no threads are needed.

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
        if pe:
            sams = al.align_batch_pe(cur, n_processed, rg_id=rg_id,
                                     pes0=pes0, _front=front,
                                     _prefetch=prefetch)
        else:
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
