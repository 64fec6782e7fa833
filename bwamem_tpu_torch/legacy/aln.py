"""`aln` — bounded-difference backtracking BWT search (.sai production).

Behavior spec: bwa_aln_core / bwa_cal_sa_reg_gap (bwtaln.c:83-228) and the
priority-stack search bwt_match_gap (bwtgap.c:109-264).  The search is a
best-first exploration of (mismatch, gap-open, gap-extend) edits over the
FM-index, with per-position lower-bound widths pruning the frontier.

The reference explores one read per thread, one stack entry at a time,
each step doing a bwt_2occ4.  Here every read in the batch keeps its
(tiny, branchy) priority stack ON HOST, and each lockstep round gathers the
(k-1, l) occ queries of ALL active reads into ONE batched occ4 on the
device (ops.fm.occ4, the combined-row gather the mem seeding uses): one
H2D of the round's lanes, the occ4 ops, one D2H.  Pop order, push order,
width shadowing and all stopping heuristics replicate the reference
exactly, so the emitted .sai is byte-identical.  Counterpart of
bwamem_tpu/legacy/aln.py.

timers: aln.width_scan (the per-position width scans and their D2H),
aln.match (the whole search), aln.occ (the device part of the rounds);
counts aln.rounds and aln.lanes.
"""
from __future__ import annotations

import dataclasses
import math
import struct
import sys

import numpy as np
import torch

from bwamem_tpu_torch.ops import fm as fmops
from bwamem_tpu_torch.utils import timers

BWA_AVG_ERR = 0.02
BWA_MIN_RDLEN = 35
SAI_MAGIC = b"SAI\1"

BWA_MODE_GAPE = 0x01
BWA_MODE_COMPREAD = 0x02
BWA_MODE_LOGGAP = 0x04
BWA_MODE_NONSTOP = 0x10

STATE_M, STATE_I, STATE_D = 0, 1, 2

GAP_OPT_FMT = "<7if8i"      # gap_opt_t (bwtaln.h:105-115), 64 bytes


@dataclasses.dataclass
class GapOptions:
    """gap_opt_t defaults (gap_init_opt, bwtaln.c:24-40)."""
    s_mm: int = 3
    s_gapo: int = 11
    s_gape: int = 4
    mode: int = BWA_MODE_GAPE | BWA_MODE_COMPREAD
    indel_end_skip: int = 5
    max_del_occ: int = 10
    max_entries: int = 2000000
    fnr: float = 0.04
    max_diff: int = -1
    max_gapo: int = 1
    max_gape: int = 6
    max_seed_diff: int = 2
    seed_len: int = 32
    n_threads: int = 1
    max_top2: int = 30
    trim_qual: int = 0

    def pack(self) -> bytes:
        return struct.pack(GAP_OPT_FMT, self.s_mm, self.s_gapo, self.s_gape,
                           self.mode, self.indel_end_skip, self.max_del_occ,
                           self.max_entries, self.fnr, self.max_diff,
                           self.max_gapo, self.max_gape, self.max_seed_diff,
                           self.seed_len, self.n_threads, self.max_top2,
                           self.trim_qual)

    @classmethod
    def unpack(cls, raw: bytes) -> "GapOptions":
        v = struct.unpack(GAP_OPT_FMT, raw)
        return cls(s_mm=v[0], s_gapo=v[1], s_gape=v[2], mode=v[3],
                   indel_end_skip=v[4], max_del_occ=v[5], max_entries=v[6],
                   fnr=v[7], max_diff=v[8], max_gapo=v[9], max_gape=v[10],
                   max_seed_diff=v[11], seed_len=v[12], n_threads=v[13],
                   max_top2=v[14], trim_qual=v[15])


def cal_maxdiff(length: int, err: float = BWA_AVG_ERR,
                thres: float = 0.04) -> int:
    """bwa_cal_maxdiff (bwtaln.c:42-54), exact float replay."""
    elambda = math.exp(-length * err)
    y = 1.0
    x = 1
    s = elambda
    for k in range(1, 1000):
        y *= length * err
        x *= k
        s += elambda * y / x
        if 1.0 - s < thres:
            return k
    return 2


def aln_score(m: int, o: int, e: int, opt: GapOptions) -> int:
    return m * opt.s_mm + o * opt.s_gapo + e * opt.s_gape


def int_log2(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else 0


def trim_read(trim_qual: int, seq_len: int, qual: str | None) -> int:
    """bwa_trim_read (bwaseqio.c:81-92): returns the kept length."""
    if trim_qual < 1 or not qual:
        return seq_len
    s, max_, max_l = 0, 0, seq_len
    for l in range(seq_len - 1, BWA_MIN_RDLEN - 1, -1):
        s += trim_qual - (ord(qual[l]) - 33)
        if s < 0:
            break
        if s > max_:
            max_, max_l = s, l
    return max_l


# ------------------------------------------------------- device primitives

def _width_scan_dev(fm, seq: torch.Tensor, L: int):
    """bwt_cal_width (bwtaln.c:57-81) for a read batch: a loop over L
    positions, each step ONE batched 2occ (occ4 at k-1 and at l over N
    lanes).  seq: [N, >= L] nt4 on fm's device.  Returns (w, bid) [N, L]
    on the device."""
    it = fm.itype
    N = seq.shape[0]
    k = torch.zeros((N,), dtype=it, device=fm.device)
    l = torch.full((N,), fm.seq_len, dtype=it, device=fm.device)
    bid = torch.zeros((N,), dtype=torch.int32, device=fm.device)
    L2 = fm.L2[:4]
    ws, bids = [], []
    for i in range(L):
        c = seq[:, i].to(torch.int32)
        cc = c.clamp(0, 3).to(torch.int64)
        both = fmops.occ4(fm, torch.stack([k - 1, l]))
        okc = fmops._select4(both[0], cc)
        olc = fmops._select4(both[1], cc)
        l2c = L2[cc]
        upd = c < 4
        k2 = torch.where(upd, l2c + okc + 1, k)
        l2 = torch.where(upd, l2c + olc, l)
        restart = (k2 > l2) | (c > 3)
        bid = bid + restart.to(torch.int32)
        k = torch.where(restart, 0, k2)
        l = torch.where(restart, fm.seq_len, l2)
        ws.append(l - k + 1)
        bids.append(bid)
    return torch.stack(ws, dim=1), torch.stack(bids, dim=1)


class OccBatcher:
    """One round of the lockstep search: the (k-1, l) pairs of every
    active read go to the device in one copy, through one batched occ4
    (bwt_2occ4, bwt.c:240-259 semantics), and come back in one copy."""

    def __init__(self, fm):
        self.fm = fm
        self.it = np.int64 if fm.itype == torch.int64 else np.int32

    def query(self, km1: np.ndarray, l: np.ndarray):
        B = len(km1)
        timers.count("aln.rounds")
        timers.count("aln.lanes", B)
        with timers.section("aln.occ"):
            q = np.empty((2, B), self.it)
            q[0] = km1
            q[1] = l
            both = fmops.occ4(self.fm, torch.from_numpy(q).to(
                self.fm.device)).cpu().numpy()
        return both[0].astype(np.int64), both[1].astype(np.int64)


# ------------------------------------------------------------ search engine

class _Stack:
    """gap_stack_t (bwtgap.h) with exact push/pop order."""
    __slots__ = ("n_stacks", "stacks", "best", "n_entries")

    def __init__(self, n_stacks: int):
        self.n_stacks = n_stacks
        self.stacks: list[list] = [[] for _ in range(n_stacks)]
        self.best = n_stacks
        self.n_entries = 0

    def push(self, score: int, entry) -> None:
        self.stacks[score].append(entry)
        self.n_entries += 1
        if self.best > score:
            self.best = score

    def pop(self):
        q = self.stacks[self.best]
        e = q.pop()
        self.n_entries -= 1
        if not q and self.n_entries:
            i = self.best + 1
            while i < self.n_stacks and not self.stacks[i]:
                i += 1
            self.best = i
        elif self.n_entries == 0:
            self.best = self.n_stacks
        return e


# entry tuple layout (gap_entry_t, bwtgap.h):
# (score_pushed, i, k, l, n_mm, n_gapo, n_gape, n_ins, n_del, state,
#  last_diff_pos)

class ReadSearch:
    """One read's bwt_match_gap state; device occ values arrive per round."""

    def __init__(self, seq: np.ndarray, width_w, width_bid, seed_w, seed_bid,
                 opt: GapOptions, max_diff: int, seed_len_eff: int,
                 seq_len: int, n_stacks: int, max_gapo: int):
        self.seq = seq                    # complemented reversed read, nt4
        self.len = len(seq)
        self.w = width_w                  # mutable int64 [len+1]
        self.bid = width_bid              # mutable int32 [len+1]
        self.seed_w = seed_w              # or None
        self.seed_bid = seed_bid
        self.opt = opt
        self.max_diff = max_diff
        self.seed_len = seed_len_eff
        self.seq_len = seq_len
        self.max_gapo = max_gapo
        self.stack = _Stack(n_stacks)
        self.best_score = aln_score(max_diff + 1, max_gapo + 1,
                                    opt.max_gape + 1, opt)
        self.best_diff = max_diff + 1
        self.cur_max_diff = max_diff      # mutated by top2 behaviour
        self.best_cnt = 0
        self.alns: list[tuple] = []       # (n_mm,n_gapo,n_gape,n_ins,n_del,k,l,score)
        self.done = False
        self.pending = None               # ("expand",e) | ("exact",e,i_rem,k,l)
        # too-many-N check (bwtgap.c:121-127)
        if int((seq > 3).sum()) > max_diff:
            self.done = True
        else:
            self.stack.push(0, (0, self.len, 0, seq_len, 0, 0, 0, 0, 0,
                                STATE_M, 0))

    # ---- hit recording (bwtgap.c:163-198) ----
    def _record_hit(self, e, k: int, l: int) -> None:
        opt = self.opt
        score = aln_score(e[4], e[5], e[6], opt)
        do_add = True
        if not self.alns:
            self.best_score = score
            self.best_diff = e[4] + e[5]
            if opt.mode & BWA_MODE_GAPE:
                self.best_diff += e[6]
            if not (opt.mode & BWA_MODE_NONSTOP):
                self.cur_max_diff = min(self.best_diff + 1, self.max_diff)
        if score == self.best_score:
            self.best_cnt += l - k + 1
        elif self.best_cnt > opt.max_top2:
            self.done = True
            return
        if e[5]:  # gap-open dup check
            for a in self.alns:
                if a[5] == k and a[6] == l:
                    do_add = False
                    break
        if do_add:
            self._gap_shadow(l - k + 1, e[10])
            self.alns.append((e[4], e[5], e[6], e[7], e[8], k, l, score))

    def _gap_shadow(self, x: int, last_diff_pos: int) -> None:
        """gap_shadow (bwtgap.c:86-96)."""
        j = 0
        w = self.w
        bid = self.bid
        for i in range(last_diff_pos):
            if w[i] > x:
                w[i] -= x
            elif w[i] == x:
                bid[i] = 1
                j += 1
                w[i] = self.seq_len - j

    # ---- per-round host step ----
    def want_query(self):
        """Returns (km1, l) when a device occ is needed, else None (the
        search finished).  Pops entries until an occ is required; a pending
        multi-step exact walk re-emits its next query first."""
        opt = self.opt
        if self.pending is not None:       # exact walk in progress
            return self.pending[3] - 1, self.pending[4]
        while not self.done and self.stack.n_entries:
            if self.stack.n_entries > opt.max_entries:
                self.done = True
                break
            e = self.stack.pop()
            score_pushed, i, k, l = e[0], e[1], e[2], e[3]
            if not (opt.mode & BWA_MODE_NONSTOP) and \
                    score_pushed > self.best_score + opt.s_mm:
                self.done = True
                break
            m = self.cur_max_diff - (e[4] + e[5])
            if opt.mode & BWA_MODE_GAPE:
                m -= e[6]
            if m < 0:
                continue
            if self.seed_w is not None:
                m_seed = opt.max_seed_diff - (e[4] + e[5])
                if opt.mode & BWA_MODE_GAPE:
                    m_seed -= e[6]
            else:
                m_seed = 0
            if i > 0 and m < self.bid[i - 1]:
                continue
            # hit check
            if i == 0:
                self._record_hit(e, k, l)
                continue
            if m == 0 and (e[9] == STATE_M or (opt.mode & BWA_MODE_GAPE)
                           or e[6] == opt.max_gape):
                # bwt_match_exact_alt over seq[0..i-1] (bwt.c)
                c = int(self.seq[i - 1])
                if c > 3:
                    continue           # N: no match
                self.pending = ("exact", e, i, k, l, m, m_seed)
                return k - 1, l
            self.pending = ("expand", e, i, k, l, m, m_seed)
            return k - 1, l
        self.done = True
        return None

    def apply(self, cnt_k: np.ndarray, cnt_l: np.ndarray, L2) -> None:
        """Consume one round's occ4 pair for the pending op."""
        kind = self.pending[0]
        if kind == "exact":
            _, e, i, k, l, m, m_seed = self.pending
            self.pending = None
            c = int(self.seq[i - 1])
            k2 = int(L2[c] + cnt_k[c] + 1)
            l2 = int(L2[c] + cnt_l[c])
            if k2 > l2:
                return                 # no hit, back to main loop
            if i - 1 == 0:
                self._record_hit(e, k2, l2)
                return
            c2 = int(self.seq[i - 2])
            if c2 > 3:
                return
            self.pending = ("exact", e, i - 1, k2, l2, m, m_seed)
            return
        _, e, i, k, l, m, m_seed = self.pending
        self.pending = None
        opt = self.opt
        i -= 1                          # bwtgap.c:200
        occ = l - k + 1
        allow_diff = allow_m = True
        if i > 0:
            ii = i - (self.len - self.seed_len)
            if self.bid[i - 1] > m - 1:
                allow_diff = False
            elif self.bid[i - 1] == m - 1 and self.bid[i] == m - 1 and \
                    self.w[i - 1] == self.w[i]:
                allow_m = False
            if self.seed_w is not None and ii > 0:
                if self.seed_bid[ii - 1] > m_seed - 1:
                    allow_diff = False
                elif self.seed_bid[ii - 1] == m_seed - 1 and \
                        self.seed_bid[ii] == m_seed - 1 and \
                        self.seed_w[ii - 1] == self.seed_w[ii]:
                    allow_m = False
        # indels (bwtgap.c:216-243)
        if opt.mode & BWA_MODE_LOGGAP:
            tmp = int_log2(e[6] + e[5]) // 2 + 1
        else:
            tmp = e[5] + e[6]
        if allow_diff and i >= opt.indel_end_skip + tmp and \
                self.len - i >= opt.indel_end_skip + tmp:
            if e[9] == STATE_M:
                if e[5] < self.max_gapo:
                    self._push(i, k, l, e[4], e[5] + 1, e[6], e[7] + 1,
                               e[8], STATE_I, True)
                    for j in range(4):
                        kj = int(L2[j] + cnt_k[j] + 1)
                        lj = int(L2[j] + cnt_l[j])
                        if kj <= lj:
                            self._push(i + 1, kj, lj, e[4], e[5] + 1, e[6],
                                       e[7], e[8] + 1, STATE_D, True)
            elif e[9] == STATE_I:
                if e[6] < opt.max_gape:
                    self._push(i, k, l, e[4], e[5], e[6] + 1, e[7] + 1,
                               e[8], STATE_I, True)
            elif e[9] == STATE_D:
                if e[6] < opt.max_gape:
                    if e[6] + e[5] < self.cur_max_diff or \
                            occ < opt.max_del_occ:
                        for j in range(4):
                            kj = int(L2[j] + cnt_k[j] + 1)
                            lj = int(L2[j] + cnt_l[j])
                            if kj <= lj:
                                self._push(i + 1, kj, lj, e[4], e[5],
                                           e[6] + 1, e[7], e[8] + 1,
                                           STATE_D, True)
        # mismatches (bwtgap.c:245-258)
        base = int(self.seq[i])
        if allow_diff and allow_m:
            for j in range(1, 5):
                c = (base + j) & 3
                is_mm = (j != 4 or base > 3)
                kj = int(L2[c] + cnt_k[c] + 1)
                lj = int(L2[c] + cnt_l[c])
                if kj <= lj:
                    self._push(i, kj, lj, e[4] + is_mm, e[5], e[6], e[7],
                               e[8], STATE_M, is_mm)
        elif base < 4:
            c = base & 3
            kj = int(L2[c] + cnt_k[c] + 1)
            lj = int(L2[c] + cnt_l[c])
            if kj <= lj:
                self._push(i, kj, lj, e[4], e[5], e[6], e[7], e[8],
                           STATE_M, False)

    def _push(self, i, k, l, n_mm, n_gapo, n_gape, n_ins, n_del, state,
              is_diff):
        score = aln_score(n_mm, n_gapo, n_gape, self.opt)
        self.stack.push(score, (score, i, k, l, n_mm, n_gapo, n_gape,
                                n_ins, n_del, state, i if is_diff else 0))


def match_gap_batch(fm, seqs_search: list[np.ndarray],
                    widths, seed_widths, opt: GapOptions,
                    max_diffs: list[int], max_gapo: int,
                    n_stacks: int) -> list[list[tuple]]:
    """Run bwt_match_gap for a batch of reads in lockstep rounds."""
    seq_len = int(fm.seq_len)
    L2 = fm.L2.cpu().numpy().astype(np.int64)
    batcher = OccBatcher(fm)
    searches = []
    for r, seq in enumerate(seqs_search):
        w, bid = widths[r]
        sw = seed_widths[r]
        seed_len_eff = opt.seed_len if opt.seed_len < len(seq) else 0x7fffffff
        searches.append(ReadSearch(
            seq, w, bid, sw[0] if sw else None, sw[1] if sw else None, opt,
            max_diffs[r], seed_len_eff, seq_len, n_stacks, max_gapo))
    active = [s for s in searches if not s.done]
    while active:
        km1s, ls, owners = [], [], []
        for s in active:
            q = s.want_query()
            if q is not None:
                km1s.append(q[0])
                ls.append(q[1])
                owners.append(s)
        if not owners:
            break
        ok, ol = batcher.query(np.asarray(km1s, np.int64),
                               np.asarray(ls, np.int64))
        for b, s in enumerate(owners):
            s.apply(ok[b], ol[b], L2)
        active = owners
    return [s.alns for s in searches]


# --------------------------------------------------------------- sai writer

def pack_aln1(a: tuple) -> bytes:
    """bwt_aln1_t (bwtaln.h:43-46): u64 bitfield + k + l."""
    n_mm, n_gapo, n_gape, n_ins, n_del, k, l, score = a
    word = (n_mm & 0xFF) | ((n_gapo & 0xFF) << 8) | ((n_gape & 0xFF) << 16) \
        | ((score & 0xFFFFF) << 24) | ((n_ins & 0x3FF) << 44) \
        | ((n_del & 0x3FF) << 54)
    return struct.pack("<QQQ", word, k, l)


def unpack_aln1(raw: bytes) -> tuple:
    word, k, l = struct.unpack("<QQQ", raw)
    return (word & 0xFF, (word >> 8) & 0xFF, (word >> 16) & 0xFF,
            (word >> 44) & 0x3FF, (word >> 54) & 0x3FF, k, l,
            (word >> 24) & 0xFFFFF)


# ---------------------------------------------------------------- entry points

def prep_read(seq_nt4: np.ndarray, qual: str | None, opt: GapOptions):
    """bwa_read_seq read prep (bwaseqio.c:152-218): quality trim, then the
    stored `seq` is the REVERSED read (plain reverse, no complement)."""
    full_len = len(seq_nt4)
    keep = trim_read(opt.trim_qual, full_len, qual) if opt.trim_qual >= 1 \
        and qual else full_len
    return np.ascontiguousarray(seq_nt4[:keep][::-1]), keep


def _widths(fm, rows: list[np.ndarray], L: int):
    """Width scans of equal-length-padded rows on fm's device, fetched as
    (w int64 [n, L], bid int32 [n, L])."""
    seq = np.full((len(rows), L), 4, np.uint8)
    for i, r in enumerate(rows):
        seq[i, :len(r)] = r
    w, bid = _width_scan_dev(fm, torch.from_numpy(seq).to(fm.device), L)
    return w.cpu().numpy().astype(np.int64), bid.cpu().numpy()


def cal_sa_reg_gap_batch(fm, reads, opt: GapOptions):
    """bwa_cal_sa_reg_gap (bwtaln.c:83-126) over one read batch.  `reads`
    yield (seq_rev np[len], len) from prep_read.  Returns per-read aln
    lists (bwt_aln1_t tuples)."""
    if not reads:
        return []
    max_len = max(r[1] for r in reads)
    local_max_diff = cal_maxdiff(max_len, BWA_AVG_ERR, opt.fnr) \
        if opt.fnr > 0.0 else opt.max_diff
    max_gapo = min(opt.max_gapo, local_max_diff)
    n_stacks = aln_score(local_max_diff + 1, max_gapo + 1,
                         opt.max_gape + 1, opt)

    # widths on the device: one scan over the batch, and one over the
    # seeds: the LAST seed_len entries of the reversed read
    sl = opt.seed_len
    need_seed = [i for i, (sr, ln) in enumerate(reads) if ln > sl]
    with timers.section("aln.width_scan"):
        w_np, bid_np = _widths(fm, [sr for sr, _ in reads], max(max_len, 1))
        if need_seed:
            seed_w_np, seed_bid_np = _widths(
                fm, [reads[i][0][reads[i][1] - sl: reads[i][1]]
                     for i in need_seed], sl)

    widths, seed_widths, seqs_search, max_diffs = [], [], [], []
    seed_idx = {i: gi for gi, i in enumerate(need_seed)}
    for i, (sr, ln) in enumerate(reads):
        # width[len] = (0, ++bid) (bwt_cal_width tail, bwtaln.c:78-79)
        w = np.empty(ln + 1, np.int64)
        bid = np.empty(ln + 1, np.int32)
        w[:ln] = w_np[i, :ln]
        bid[:ln] = bid_np[i, :ln]
        w[ln] = 0
        bid[ln] = (bid[ln - 1] if ln else 0) + 1
        widths.append((w, bid))
        if i in seed_idx:
            gi = seed_idx[i]
            sw = np.empty(sl + 1, np.int64)
            sbid = np.empty(sl + 1, np.int32)
            sw[:sl] = seed_w_np[gi, :sl]
            sbid[:sl] = seed_bid_np[gi, :sl]
            sw[sl] = 0
            sbid[sl] = sbid[sl - 1] + 1
            seed_widths.append((sw, sbid))
        else:
            seed_widths.append(None)
        # complement in place (bwtaln.c:116-117): search = revcomp(read)
        s = sr.astype(np.int32)
        seqs_search.append(np.where(s > 3, 4, 3 - s).astype(np.uint8))
        max_diffs.append(cal_maxdiff(ln, BWA_AVG_ERR, opt.fnr)
                         if opt.fnr > 0.0 else opt.max_diff)

    with timers.section("aln.match"):
        return match_gap_batch(fm, seqs_search, widths, seed_widths, opt,
                               max_diffs, max_gapo, n_stacks)


def aln_core(idx, fq_path: str, opt: GapOptions, out, device,
             batch_reads: int = 0x40000) -> None:
    """bwa_aln_core (bwtaln.c:159-228): stream reads, write the .sai; the
    FM lookups run on `device`."""
    from bwamem_tpu_torch.io.fastq import read_fastx, batches
    fm = fmops.fm_from_index(idx, device)
    out.write(SAI_MAGIC)
    out.write(opt.pack())
    tot = 0
    for batch in batches(read_fastx(fq_path), batch_reads):
        prepped = [prep_read(r.seq, r.qual, opt) for r in batch]
        alns = cal_sa_reg_gap_batch(fm, prepped, opt)
        for a in alns:
            out.write(struct.pack("<i", len(a)))
            for rec in a:
                out.write(pack_aln1(rec))
        tot += len(batch)
        sys.stderr.write(f"[bwa_aln_core] {tot} sequences have been "
                         "processed.\n")
