"""SMEM seeding — batched 3-pass interval collection.

Reproduces mem_collect_intv (reference bwamem.c:137-185) output exactly,
with a lockstep decomposition instead of the per-read recursive loops of
bwt_smem1a (bwt.c:289-351):

  Phase A  — a lockstep *forward scanner*: every read advances one base per
             step through pass-1 pivots, recording a "candidate" (the
             bidirectional interval before each interval-size change).
  Phase B  — *backward extension*: every candidate is an independent lane;
             all lanes left-extend in lockstep until death.  The per-
             candidate leftmost start s(cand) is monotone in candidate
             length, so bwt_smem1a's curr/prev bookkeeping reduces to a
             vectorized emission rule:
                emit(cand) <=> cand is its pivot's longest, or
                               s(cand) < s(next longer candidate).
  Pass 2   — same two phases, seeded at (start+end)/2 of each long low-occ
             pass-1 SMEM with min_intv = parent_size+1 (bwamem.c:155-165).
  Pass 3   — LAST-like forward-only scanner (bwt_seed_strategy1,
             bwt.c:358-379).

The forward scans run a fixed number of trips (`max_steps`) with per-lane
masks, so a scan costs no host synchronisation; they report `unfinished`
when a lane needed more trips (the caller grows and retries).
collect_intervals, the single-program driver, runs each scan to its end.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from bwamem_tpu_torch.ops import fm as fmops



@dataclasses.dataclass(frozen=True)
class SeedingCaps:
    """Fixed per-read buffer sizes of collect_intervals."""
    cand1: int = 64      # pass-1 candidates per read
    parents: int = 12    # pass-2 parent SMEMs per read
    cand2: int = 16      # pass-2 candidates per parent
    pass3: int = 16      # pass-3 intervals per read


KMER_K = 12      # matches index.build.KMER_K / reference KMER_K


def _i64(x):
    return x.to(torch.int64)


def kmer_pre(fm: fmops.FM, seq: torch.Tensor, l_seq: torch.Tensor):
    """Per-position k-mer-12 fast-start intervals: pre[n, x] = the
    bi-interval (x0, x1, size) after matching q[x : x+12) forward, via ONE
    table gather per position instead of 12 FM extensions.  size == -1
    marks positions where the window leaves the read or crosses an
    ambiguous base (the scans must then take the normal init path)."""
    N, L = seq.shape
    dev = seq.device
    code = torch.zeros((N, L), dtype=torch.int32, device=dev)
    bad = torch.zeros((N, L), dtype=torch.bool, device=dev)
    for j in range(KMER_K):
        b = torch.cat([seq[:, j:], torch.full((N, min(j, L)), 4,
                                              dtype=seq.dtype, device=dev)],
                      dim=1)[:, :L]
        code = code * 4 + b.to(torch.int32).clamp(0, 3)
        bad = bad | (b >= 4)
    posv = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    valid = (~bad) & (posv + KMER_K <= l_seq[:, None])
    pre = fm.kmer[_i64(torch.where(valid, code, 0))]          # [N, L, 3]
    miss = torch.tensor([0, 0, -1], dtype=pre.dtype, device=dev)
    return torch.where(valid[:, :, None], pre, miss)


def kmer_pre0(fm: fmops.FM, seq: torch.Tensor, l_seq: torch.Tensor):
    """Position-0-only variant of kmer_pre: the pass-1 multi-pivot scan
    consults the fast-start table ONLY for pivot 0 (see forward_scan).
    Returns [N, 1, 3] (slot 0 = the position-0 interval)."""
    N, L = seq.shape
    dev = seq.device
    code = torch.zeros((N,), dtype=torch.int32, device=dev)
    bad = torch.zeros((N,), dtype=torch.bool, device=dev)
    for j in range(KMER_K):
        b = seq[:, j] if j < L else torch.full((N,), 4, dtype=seq.dtype,
                                               device=dev)
        code = code * 4 + b.to(torch.int32).clamp(0, 3)
        bad = bad | (b >= 4)
    valid = (~bad) & (l_seq >= KMER_K)
    pre = fm.kmer[_i64(torch.where(valid, code, 0))]          # [N, 3]
    miss = torch.tensor([0, 0, -1], dtype=pre.dtype, device=dev)
    return torch.where(valid[:, None], pre, miss)[:, None, :]


def pack_seq(seq: torch.Tensor, l_seq: torch.Tensor | None = None):
    """[N, L] nt4 codes -> (b2, amb) packed words, both int64 holding uint32
    [N, W] with W = ceil(L/16).  Base p of row r sits at bits 2*(p&15) of
    b2[r, p>>4]; its ambiguity bit (set for base >= 4 OR p >= l_seq) at bit
    (p&15) of amb[r, p>>4]."""
    N, L = seq.shape
    dev = seq.device
    W = (L + 15) // 16
    s = torch.full((N, W * 16), 4, dtype=torch.int64, device=dev)
    s[:, :L] = seq.to(torch.int64)
    isamb = s >= 4
    if l_seq is not None:
        pos = torch.arange(W * 16, device=dev)[None, :]
        isamb = isamb | (pos >= l_seq[:, None])
    sh = torch.arange(16, dtype=torch.int64, device=dev)[None, None, :]
    b2 = (s.clamp(0, 3).reshape(N, W, 16) << (sh * 2)).sum(-1)
    amb = (isamb.to(torch.int64).reshape(N, W, 16) << sh).sum(-1)
    return b2, amb


def base_at_packed(b2: torch.Tensor, amb: torch.Tensor, pos: torch.Tensor):
    """Per-lane base at pos from packed rows (b2/amb [M, W], pos [M]).
    Out-of-range or ambiguous positions read as 4."""
    W = b2.shape[-1]
    p = _i64(pos.clamp(0, W * 16 - 1))
    w = (p >> 4)[:, None]
    word = torch.gather(b2, 1, w)[:, 0]
    aword = torch.gather(amb, 1, w)[:, 0]
    off = p & 15
    bb = ((word >> (off * 2)) & 3).to(torch.int32)
    ab = ((aword >> off) & 1) != 0
    oob = (pos < 0) | (pos >= W * 16)
    return torch.where(ab | oob, 4, bb)


class Candidates(NamedTuple):
    x0: torch.Tensor      # [N, C] interval (SA range start)
    x1: torch.Tensor      # [N, C] reverse-complement range start
    x2: torch.Tensor      # [N, C] size
    end: torch.Tensor     # [N, C] match end position (exclusive), int32
    pivot: torch.Tensor   # [N, C] pivot the candidate came from, int32
    n: torch.Tensor       # [N] number written
    overflow: torch.Tensor  # [N] bool
    steps: torch.Tensor   # [] int32 — loop iterations with work
    unfinished: torch.Tensor  # [] bool — max_steps was too small


def _journal_to_grid(rec, cap, nvals):
    """[T, N, 1+nvals] step journal (flag, values) -> per-lane grid
    [N, cap, nvals] of the flagged rows in step order, with counts and
    overflow: ONE scatter for the whole scan."""
    T, N, _ = rec.shape
    P = rec.permute(1, 0, 2)                           # [N, T, 1+nvals]
    flag = P[:, :, 0] > 0
    ord_slot = torch.cumsum(flag.to(torch.int32), 1, dtype=torch.int32) - 1
    n_out = flag.sum(1, dtype=torch.int32)
    overflow = n_out > cap
    n_out = n_out.clamp(max=cap)
    rowsT = torch.arange(N, device=rec.device)[:, None].expand(N, T)
    slot = torch.where(flag & (ord_slot < cap), ord_slot,
                       torch.full_like(ord_slot, cap))
    grid = torch.zeros((N, cap + 1, nvals), dtype=rec.dtype,
                       device=rec.device)
    grid[rowsT, _i64(slot)] = P[:, :, 1:]
    return grid[:, :cap], n_out, overflow


def forward_scan(fm: fmops.FM, seq: torch.Tensor, l_seq: torch.Tensor,
                 start: torch.Tensor, min_intv: torch.Tensor, cap: int,
                 multi_pivot: bool, *, max_steps: int,
                 lane_read: torch.Tensor | None = None,
                 pre: torch.Tensor | None = None) -> Candidates:
    """Phase A.  seq: [N, L] nt4 codes (pad with 4); start: [N] first pivot
    (or the single pivot when multi_pivot=False); min_intv: [N].

    When `lane_read` is given, the scan runs over M = start.shape[0]
    compacted lanes, each reading row lane_read[m] of seq (l_seq then must
    already be gathered per lane).

    The scan runs `max_steps` masked trips and reports `steps` (trips that
    still had active lanes) and `unfinished` (some lane needed more).

    Candidate semantics match the forward loop of bwt_smem1a (bwt.c:304-321):
    push the previous interval on every size change / ambiguous base / read
    end; stop the pivot when the extended size < min_intv; next pivot = end
    of the longest match (the value bwt_smem1a returns).
    """
    N = start.shape[0] if lane_read is not None else seq.shape[0]
    it = fm.itype
    dev = seq.device
    rows_seq = (_i64(lane_read) if lane_read is not None
                else torch.arange(N, device=dev))
    b2a, amba = pack_seq(seq, None)
    b2r, ambr = (b2a[rows_seq], amba[rows_seq]) if lane_read is not None \
        else (b2a, amba)

    def seq_at(pos):
        return torch.where((pos >= 0) & (pos < l_seq),
                           base_at_packed(b2r, ambr, pos), 4)

    zero_i = torch.zeros((N,), dtype=torch.int32, device=dev)
    zero_t = torch.zeros((N,), dtype=it, device=dev)
    phase = torch.where(start < l_seq, 0, 2).to(torch.int32)
    x = start.to(torch.int32)
    i = zero_i
    ik0, ik1, ik2, ik_end = zero_t, zero_t, zero_t, zero_i
    if pre is not None:
        # k-mer-12 fast start for the FIRST pivot when it is position 0:
        # enter the loop already matched over [0, 12) with the precomputed
        # interval.  EXACT for pivot 0: all its candidates back-extend to
        # s = 0, so the emission rule emits only the longest — the
        # candidates the jump skips (end < 12) are never emitted, and
        # interval sizes are non-increasing in end, so size >= min_intv at
        # end 12 implies no in-window termination either.
        p0 = pre[rows_seq, 0]                          # [N, 3]
        jump = ((phase == 0) & (start == 0)
                & (p0[:, 2] >= min_intv.to(it)) & (p0[:, 2] >= 0))
        phase = torch.where(jump, 1, phase).to(torch.int32)
        i = torch.where(jump, KMER_K, i).to(torch.int32)
        ik_end = torch.where(jump, KMER_K, ik_end).to(torch.int32)
        ik0 = torch.where(jump, p0[:, 0], ik0)
        ik1 = torch.where(jump, p0[:, 1], ik1)
        ik2 = torch.where(jump, p0[:, 2], ik2)

    st_min_intv = min_intv.to(it)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    rec = torch.zeros((max_steps, N, 6), dtype=it, device=dev)
    for t in range(max_steps):
        steps = steps + (phase < 2).any().to(torch.int32)
        # phases 0 and 1 are mutually exclusive per lane, so ONE seq fetch
        # serves both the pivot base q[x] (init) and the step base q[i]
        init = phase == 0
        ext = phase == 1
        x_start = x
        q_at = seq_at(torch.where(init, x, i))

        # ---- phase 0: initialize a pivot ----
        init_amb = init & (q_at >= 4)
        init_ok = init & (q_at < 4)
        s0, s1, s2 = fmops.set_intv(fm, q_at.clamp(0, 3))
        ik0 = torch.where(init_ok, s0, ik0)
        ik1 = torch.where(init_ok, s1, ik1)
        ik2 = torch.where(init_ok, s2, ik2)
        ik_end = torch.where(init_ok, x + 1, ik_end)
        i = torch.where(init_ok, x + 1, i)
        # skip ambiguous pivot: x+1 (bwt_smem1a returns x+1 when q[x]>3)
        x = torch.where(init_amb, x + 1, x)
        phase = torch.where(init_ok, 1, phase).to(torch.int32)
        phase = torch.where(init_amb & (x >= l_seq), 2, phase).to(torch.int32)

        # ---- phase 1: one forward extension step at position i ----
        at_end = ext & (i >= l_seq)
        amb = ext & (i < l_seq) & (q_at >= 4)
        do_ext = ext & (i < l_seq) & (q_at < 4)
        n0, n1, ns = fmops.extend(fm, ik0, ik1, ik2, is_back=False)
        c = (3 - q_at).clamp(0, 3)
        e0 = fmops._select4(n0, c)
        e1 = fmops._select4(n1, c)
        e2 = fmops._select4(ns, c)
        size_change = do_ext & (e2 != ik2)
        too_small = size_change & (e2 < st_min_intv)
        push = at_end | amb | size_change
        finish = at_end | amb | too_small

        rec[t] = torch.stack([push.to(it), ik0, ik1, ik2, ik_end.to(it),
                              x_start.to(it)], dim=-1)
        # ---- advance ----
        cont = do_ext & ~finish
        ik0 = torch.where(cont, e0, ik0)
        ik1 = torch.where(cont, e1, ik1)
        ik2 = torch.where(cont, e2, ik2)
        ik_end = torch.where(cont, i + 1, ik_end)
        i = torch.where(cont, i + 1, i)

        if multi_pivot:
            x = torch.where(finish, ik_end, x)
            phase = torch.where(finish, torch.where(x < l_seq, 0, 2),
                                phase).to(torch.int32)
        else:
            phase = torch.where(finish, 2, phase).to(torch.int32)

    unfinished = (phase < 2).any()
    cb, n_out, overflow = _journal_to_grid(rec, cap, 5)
    return Candidates(cb[:, :, 0], cb[:, :, 1], cb[:, :, 2],
                      cb[:, :, 3].to(torch.int32),
                      cb[:, :, 4].to(torch.int32), n_out, overflow, steps,
                      unfinished)


def back_extend(fm: fmops.FM, seq: torch.Tensor, l_seq: torch.Tensor,
                cand: Candidates, read_of_lane: torch.Tensor,
                min_intv: torch.Tensor):
    """Phase B: flatten candidates to lanes and left-extend each to its
    leftmost start s with interval size >= min_intv (the backward loop of
    bwt_smem1a, bwt.c:326-345, made embarrassingly parallel).

    Returns (s, x0, x2, valid) flattened [N*C]: the final interval of
    [s, end).  Only the written candidates run (one host read of their
    count); every other lane keeps its pivot and interval, as a lane that
    is never alive does in back_extend_flat."""
    C = cand.x0.shape[1]
    dev = seq.device
    valid = (torch.arange(C, dtype=torch.int32, device=dev)[None, :]
             < cand.n[:, None]).reshape(-1)
    s = cand.pivot.reshape(-1).clone()
    x0 = cand.x0.reshape(-1).clone()
    x2 = cand.x2.reshape(-1).clone()
    idx = torch.nonzero(valid)[:, 0]
    s[idx], x0[idx], x2[idx] = back_extend_flat(
        fm, seq, read_of_lane.reshape(-1)[idx], s[idx], x0[idx],
        cand.x1.reshape(-1)[idx], x2[idx], min_intv.reshape(-1)[idx],
        torch.ones_like(idx, dtype=torch.bool))
    return s, x0, x2, valid


def back_extend_flat(fm: fmops.FM, seq: torch.Tensor, lane_read, pivot, x0,
                     x1, x2, min_intv, valid, stage_w: tuple = (),
                     k_stage: int = 4, check_every: int = 16):
    """Compact-lane backward extension (the backward loop of bwt_smem1a,
    bwt.c:326-345, made embarrassingly parallel): lanes [M] each carrying
    (read row, pivot, interval, min size) left-extend to their leftmost
    start s with interval size >= min_intv.  Returns (s, x0, x2) — plus
    (overflow, need) when `stage_w` is given.

    `stage_w`: static tuple of shrinking arena widths.  Candidate lifetimes
    are front-loaded, so after every `k_stage` steps the alive lanes are
    compacted into the next (smaller) arena; lanes that no longer fit set
    the overflow flag (the caller grows the width ladder and retries).
    Dead lanes' results are scattered back to their original slots at each
    compaction.  The closing loop runs masked trips and looks at the alive
    mask on the host once every `check_every` trips."""
    from bwamem_tpu_torch.pipeline.seeding_host import _compact_flat
    it = fm.itype
    dev = seq.device
    i32 = torch.int32
    M = lane_read.shape[0]
    mi = min_intv.to(it)
    i = (pivot - 1).to(i32)
    alive = valid
    s = pivot.to(i32)
    b2a, amba = pack_seq(seq, None)

    def getseq(lr):
        return b2a[_i64(lr)], amba[_i64(lr)]   # ONE gather per compaction

    def step(alive, i, s, x0, x1, x2, mi, b2l, ambl):
        qi = base_at_packed(b2l, ambl, i)
        n0, n1, ns = fmops.extend(fm, x0, x1, x2, is_back=True)
        c = qi.clamp(0, 3)
        e0 = fmops._select4(n0, c)
        e1 = fmops._select4(n1, c)
        e2 = fmops._select4(ns, c)
        ok = alive & (i >= 0) & (qi < 4) & (e2 >= mi)
        die = alive & ~ok
        s = torch.where(die, i + 1, s)
        x0 = torch.where(ok, e0, x0)
        x1 = torch.where(ok, e1, x1)
        x2 = torch.where(ok, e2, x2)
        i = torch.where(ok, i - 1, i)
        return ok, i, s, x0, x1, x2

    def run_out(alive, i, s, x0, x1, x2, mi, b2l, ambl):
        # each trip moves a live lane one base left: L+1 trips retire all
        for t in range(seq.shape[1] + 1):
            if t % check_every == 0 and not bool(alive.any()):
                break
            alive, i, s, x0, x1, x2 = step(alive, i, s, x0, x1, x2, mi,
                                           b2l, ambl)
        return s, x0, x2

    if not stage_w:
        b2l, ambl = getseq(lane_read)
        return run_out(alive, i, s, x0, x1, x2, mi, b2l, ambl)

    out_s, out_x0, out_x2 = s, x0, x2
    orig = torch.arange(M, dtype=i32, device=dev)
    lr = lane_read.to(i32)
    b2l, ambl = getseq(lr)
    over = torch.zeros((), dtype=torch.bool, device=dev)
    # `need`: the smallest stage_w[0] that would have fit every stage's
    # survivors under the same halving ladder — the hwm the caller records
    need = torch.zeros((), dtype=i32, device=dev)
    for j, w in enumerate(stage_w):
        for _ in range(k_stage):
            alive, i, s, x0, x1, x2 = step(alive, i, s, x0, x1, x2, mi,
                                           b2l, ambl)
        # write back every lane's current result (final for dead lanes;
        # alive lanes get overwritten after later stages)
        out_s, out_x0, out_x2 = (_set_drop(o, orig, v, M) for o, v in
                                 ((out_s, s), (out_x0, x0), (out_x2, x2)))
        (i, s, x0, x1, x2, mi, lr, orig), n_al, o, _ = _compact_flat(
            alive, [(i, i32), (s, i32), (x0, it), (x1, it), (x2, it),
                    (mi, it), (lr, i32), (orig, i32)], w)
        over = over | o
        need = torch.maximum(need, n_al.to(i32) << j)
        alive = torch.arange(w, dtype=i32, device=dev) < n_al.clamp(max=w)
        orig = torch.where(alive, orig, M)
        b2l, ambl = getseq(lr)
    s, x0, x2 = run_out(alive, i, s, x0, x1, x2, mi, b2l, ambl)
    out_s, out_x0, out_x2 = (_set_drop(o, orig, v, M) for o, v in
                             ((out_s, s), (out_x0, x0), (out_x2, x2)))
    return out_s, out_x0, out_x2, over, need


def _set_drop(out, idx, vals, size):
    """out.at[idx].set(vals, mode="drop") for idx in [0, size] (size = the
    drop slot)."""
    buf = torch.cat([out, out[:1]])
    buf[_i64(idx)] = vals.to(out.dtype)
    return buf[:size]


def emit_mask(cand: Candidates, s: torch.Tensor) -> torch.Tensor:
    """Vectorized bwt_smem1a emission rule over per-read candidate buffers:
    a candidate is an SMEM iff it is its pivot's longest (last in slot order
    for that pivot) or its leftmost start is strictly left of the next-longer
    candidate's (bwt.c:331-337 containment check)."""
    N, C = cand.pivot.shape
    dev = s.device
    sl = s.reshape(N, C)
    slots = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    valid = slots < cand.n[:, None]
    falses = torch.zeros((N, 1), dtype=torch.bool, device=dev)
    nxt_same_pivot = torch.cat([cand.pivot[:, 1:] == cand.pivot[:, :-1],
                                falses], dim=1)
    nxt_valid = torch.cat([slots[:, 1:] < cand.n[:, None], falses], dim=1)
    s_next = torch.cat([sl[:, 1:], sl[:, :1]], dim=1)
    is_last_of_pivot = ~(nxt_same_pivot & nxt_valid)
    return valid & (is_last_of_pivot | (sl < s_next))


def pass3_scan(fm: fmops.FM, seq: torch.Tensor, l_seq: torch.Tensor,
               min_len: int, max_intv: int, cap: int, *, max_steps: int,
               pre: torch.Tensor | None = None):
    """LAST-like 3rd pass (bwt_seed_strategy1, bwt.c:358-379): forward-only;
    emit the extended interval the first time its size drops below max_intv
    at length > min_len; restart at i+1.  Runs `max_steps` masked trips.

    `pre` (from kmer_pre) fast-starts every restart 12 bases in.  EXACT
    when min_len >= 12 (caller must enforce): no emission can trigger at
    in-window lengths < min_len, ambiguous bases invalidate the window,
    and a zero-size window interval behaves like the scanned one (the
    length trigger, not the size, decides the restart position).

    Returns (x0, x2, start, end, n, overflow, steps, unfinished)."""
    N, L = seq.shape
    it = fm.itype
    dev = seq.device
    rows = torch.arange(N, device=dev)
    b2a, amba = pack_seq(seq, None)

    def seq_at(pos):
        return torch.where((pos >= 0) & (pos < l_seq),
                           base_at_packed(b2a, amba, pos), 4)

    zero_t = torch.zeros((N,), dtype=it, device=dev)
    phase = torch.where(l_seq > 0, 0, 2).to(torch.int32)
    x = torch.zeros((N,), dtype=torch.int32, device=dev)
    i = torch.zeros((N,), dtype=torch.int32, device=dev)
    ik0, ik1, ik2 = zero_t, zero_t, zero_t
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    rec = torch.zeros((max_steps, N, 5), dtype=it, device=dev)
    for t in range(max_steps):
        steps = steps + (phase < 2).any().to(torch.int32)
        init = phase == 0
        ext = phase == 1
        q_at = seq_at(torch.where(init, x, i))   # phases exclusive: 1 fetch
        init_amb = init & (q_at >= 4)
        init_ok = init & (q_at < 4)
        s0, s1, s2 = fmops.set_intv(fm, q_at.clamp(0, 3))
        if pre is not None:
            pk = pre[rows, _i64(x.clamp(0, L - 1))]          # [N, 3]
            jmp = init_ok & (pk[:, 2] >= 0)
            s0 = torch.where(jmp, pk[:, 0], s0)
            s1 = torch.where(jmp, pk[:, 1], s1)
            s2 = torch.where(jmp, pk[:, 2], s2)
            i_init = torch.where(jmp, x + KMER_K, x + 1)
        else:
            i_init = x + 1
        ik0 = torch.where(init_ok, s0, ik0)
        ik1 = torch.where(init_ok, s1, ik1)
        ik2 = torch.where(init_ok, s2, ik2)
        i = torch.where(init_ok, i_init, i)
        x = torch.where(init_amb, x + 1, x)
        phase = torch.where(init_ok, 1, phase).to(torch.int32)
        phase = torch.where((phase == 0) & (x >= l_seq), 2,
                            phase).to(torch.int32)

        at_end = ext & (i >= l_seq)            # return len, no emit
        amb = ext & (i < l_seq) & (q_at >= 4)  # return i+1, no emit
        do_ext = ext & (i < l_seq) & (q_at < 4)
        n0, n1, ns = fmops.extend(fm, ik0, ik1, ik2, is_back=False)
        c = (3 - q_at).clamp(0, 3)
        e0 = fmops._select4(n0, c)
        e1 = fmops._select4(n1, c)
        e2 = fmops._select4(ns, c)
        hit = do_ext & (e2 < max_intv) & ((i - x) >= min_len)
        emit = hit & (e2 > 0)
        rec[t] = torch.stack([emit.to(it), e0, e2, x.to(it),
                              (i + 1).to(it)], dim=-1)

        cont = do_ext & ~hit
        ik0 = torch.where(cont, e0, ik0)
        ik1 = torch.where(cont, e1, ik1)
        ik2 = torch.where(cont, e2, ik2)
        i = torch.where(cont, i + 1, i)

        finish = at_end | amb | hit
        # next pivot: i+1 on hit/amb; len (done) on at_end
        x = torch.where(amb | hit, i + 1, x)
        phase = torch.where(finish,
                            torch.where(at_end | (x >= l_seq), 2, 0),
                            phase).to(torch.int32)

    unfinished = (phase < 2).any()
    ob, n_out, overflow = _journal_to_grid(rec, cap, 4)
    return (ob[:, :, 0], ob[:, :, 1], ob[:, :, 2].to(torch.int32),
            ob[:, :, 3].to(torch.int32), n_out, overflow, steps, unfinished)


class Intervals(NamedTuple):
    """Per-read collected seed intervals, sorted by (start, end) like
    ks_introsort(mem_intv) on info = start<<32|end (bwamem.c:184)."""
    start: torch.Tensor   # [N, I] int32
    end: torch.Tensor     # [N, I] int32
    x0: torch.Tensor      # [N, I] it — SA range start
    x2: torch.Tensor      # [N, I] it — occurrence count
    valid: torch.Tensor   # [N, I] bool
    overflow: torch.Tensor  # [N] bool


def _to_end(scan, L: int):
    """Run a fixed-trip scan (forward_scan or pass3_scan as a function of
    max_steps) until no lane is unfinished, as the JAX package's
    while_loop form does: one host read a try, twice the trips on the
    next.  A lane takes at most two trips a base, so this ends."""
    trips = -(-(L + (L >> 1) + 24) // 32) * 32
    while True:
        out = scan(trips)
        if not bool(out[-1]):
            return out
        if trips > 4 * (L + 1):
            raise RuntimeError(f"scan unfinished after {trips} trips on "
                               f"reads of {L} bases")
        trips *= 2


def _scatter_rows(out_rows: int, idx: torch.Tensor, part):
    """A tensor of out_rows rows, zero but for rows idx = part."""
    out = part.new_zeros((out_rows,) + tuple(part.shape[1:]))
    out[idx] = part
    return out


def collect_intervals(fm: fmops.FM, seq: torch.Tensor, l_seq: torch.Tensor,
                      min_seed_len: int, split_len: int, split_width: int,
                      max_mem_intv: int,
                      caps: SeedingCaps = SeedingCaps()) -> Intervals:
    """Full 3-pass mem_collect_intv (bwamem.c:137-185) over a batch.

    Every scan runs to its end.  The pass-2 scan runs only the qualifying
    parents' lanes (one host read of their count): a parent slot left
    empty starts past its read's end and writes no candidate, so its
    buffers stay zero, as they are here."""
    N, L = seq.shape
    it = fm.itype
    dev = seq.device
    i32 = torch.int32
    one = torch.ones((N,), dtype=it, device=dev)
    rows = torch.arange(N, dtype=i32, device=dev)

    # ---- pass 1 ----
    start0 = torch.zeros((N,), dtype=i32, device=dev)
    cand1 = _to_end(lambda t: forward_scan(
        fm, seq, l_seq, start0, one, caps.cand1, multi_pivot=True,
        max_steps=t), L)
    C1 = caps.cand1
    s1, sx0, sx2, _ = back_extend(fm, seq, l_seq, cand1,
                                  rows[:, None].expand(N, C1),
                                  one[:, None].expand(N, C1))
    emit1 = emit_mask(cand1, s1)
    s1 = s1.reshape(N, C1)
    e1 = cand1.end
    smem1 = emit1 & ((e1 - s1) >= min_seed_len)
    sx0 = sx0.reshape(N, C1)
    sx2 = sx2.reshape(N, C1)

    # ---- pass 2: re-seed long low-occ SMEMs ----
    qual = smem1 & ((e1 - s1) >= split_len) & (sx2 <= split_width)
    # compact qualifying parents into [N, parents] slots (stable)
    P = caps.parents
    order = torch.sort((~qual).to(i32), dim=1,
                       stable=True).indices[:, :P]
    p_valid = torch.gather(qual, 1, order).reshape(-1)
    p_start = torch.gather(s1, 1, order)
    p_end = torch.gather(e1, 1, order)
    p_size = torch.gather(sx2, 1, order)
    parent_overflow = qual.sum(dim=1) > P

    NP = N * P
    C2 = caps.cand2
    lane_read2 = rows[:, None].expand(N, P).reshape(-1)
    pivot2 = ((p_start + p_end) >> 1).reshape(-1)
    min2 = (p_size + 1).reshape(-1).to(it)
    idx2 = torch.nonzero(p_valid)[:, 0]
    lr = lane_read2[idx2]
    cv = _to_end(lambda t: forward_scan(
        fm, seq, l_seq[lr.to(torch.int64)], pivot2[idx2], min2[idx2], C2,
        multi_pivot=False, max_steps=t, lane_read=lr), L)
    c2 = Candidates(*(_scatter_rows(NP, idx2, f) for f in cv[:7]),
                    cv.steps, cv.unfinished)
    s2, sx0_2, sx2_2, _ = back_extend(fm, seq, l_seq, c2,
                                      lane_read2[:, None].expand(NP, C2),
                                      min2[:, None].expand(NP, C2))
    emit2 = emit_mask(c2, s2)
    s2 = s2.reshape(NP, C2)
    e2 = c2.end
    smem2 = emit2 & ((e2 - s2) >= min_seed_len)
    sx0_2 = sx0_2.reshape(NP, C2)
    sx2_2 = sx2_2.reshape(NP, C2)

    # ---- pass 3 ----
    C3 = caps.pass3
    if max_mem_intv > 0:
        p3x0, p3x2, p3s, p3e, p3n, p3over, _, _ = _to_end(
            lambda t: pass3_scan(fm, seq, l_seq, min_seed_len, max_mem_intv,
                                 C3, max_steps=t), L)
        p3valid = (torch.arange(C3, dtype=i32, device=dev)[None, :]
                   < p3n[:, None])
    else:
        p3x0 = p3x2 = torch.zeros((N, C3), dtype=it, device=dev)
        p3s = p3e = torch.zeros((N, C3), dtype=i32, device=dev)
        p3valid = torch.zeros((N, C3), dtype=torch.bool, device=dev)
        p3over = torch.zeros((N,), dtype=torch.bool, device=dev)

    # ---- assemble + sort by (start, end) ----
    start = torch.cat([s1, s2.reshape(N, -1), p3s], dim=1)
    end = torch.cat([e1, e2.reshape(N, -1), p3e], dim=1)
    x0 = torch.cat([sx0, sx0_2.reshape(N, -1), p3x0], dim=1)
    x2 = torch.cat([sx2, sx2_2.reshape(N, -1), p3x2], dim=1)
    valid = torch.cat([smem1, smem2.reshape(N, -1), p3valid], dim=1)
    key = (start.to(torch.int64) << 32) | end.to(torch.int64)
    key = torch.where(valid, key, 2 ** 62)
    order = torch.sort(key, dim=1, stable=True).indices

    def take(a):
        return torch.gather(a, 1, order)

    overflow = (cand1.overflow | c2.overflow.reshape(N, -1).any(dim=1)
                | parent_overflow | p3over)
    return Intervals(take(start), take(end), take(x0), take(x2),
                     take(valid), overflow)
