"""Native host-side kernels (hostops.c): the exact chain-filter and
accept/skip replay of the device front, primary marking, the unbanded local
SW of mate rescue, pair scoring, banded global alignment + CIGAR, NM/MD and
SAM rendering.

hostops.c is compiled with the system C compiler into the repository's
`build/` directory on first use.  The port has no Python fallback for these
kernels: a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from bwamem_tpu_torch._build import shared_lib

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hostops.c")
_lock = threading.Lock()
_lib = None

_i8p = ctypes.POINTER(ctypes.c_int8)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(shared_lib(
            _SRC, "libhostops.so", ["cc", "-O3", "-shared", "-fPIC"],
            libs=("-lm",)))
        lib.ksw_global_batch.restype = ctypes.c_int
        lib.ksw_global_batch.argtypes = [
            ctypes.c_int64, _u8p, _i64p, _u8p, _i64p, _i32p, _i8p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, _i32p, _i32p, _u32p, ctypes.c_int64]
        lib.nm_md_batch.restype = ctypes.c_int64
        lib.nm_md_batch.argtypes = [
            ctypes.c_int64, _u32p, _i64p, _u8p, _i64p, _u8p, _i64p,
            _u8p, _i32p, ctypes.c_char_p, ctypes.c_int64, _i64p]
        lib.mark_primary_batch.restype = ctypes.c_int
        lib.mark_primary_batch.argtypes = [
            ctypes.c_int64, _i64p, _i64p, _i32p, _i32p, _i32p, _u8p,
            ctypes.c_int32, ctypes.c_float,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p]
        lib.replay_batch.restype = ctypes.c_int
        lib.replay_batch.argtypes = [
            ctypes.c_int64,
            _i64p, _i32p, _i32p, _i32p, _u8p, _i64p, _i32p,  # chains
            _i64p, _i32p, _i32p, _i32p, _i64p,               # items/seed
            _i32p, _i32p, _i64p, _i64p, _i32p,               # ext result
            _u8p, _i32p,                                     # skip, l_seq
            ctypes.c_float, ctypes.c_float, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _u8p, _i64p, _i64p,              # has_res, out_need, out_nn
            _i64p, _i64p, _i32p]
        lib.ksw_align_host_batch.restype = ctypes.c_int
        lib.ksw_align_host_batch.argtypes = [
            ctypes.c_int64, _u8p, _i64p, _u8p, _i64p, _i32p, _i8p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p]
        lib.pair_batch.restype = ctypes.c_int
        lib.pair_batch.argtypes = [
            ctypes.c_int64, _i64p, _i64p,
            _i64p, _i32p, _i32p, _i64p, _i32p, _i32p,
            _i64p, _i64p, ctypes.c_int64,
            _i32p, _i32p, _i32p, _f64p, _f64p,
            ctypes.c_int32, ctypes.c_int32,
            _i32p, _i32p, _i32p, _i32p, _i32p]
        lib.sam_batch.restype = ctypes.c_int64
        lib.sam_batch.argtypes = [
            ctypes.c_int64, _i32p,
            ctypes.c_char_p, _i64p,   # name
            _u32p, _i64p,             # cigar
            _u8p, _i64p,              # seq
            ctypes.c_char_p, _i64p,   # qual
            ctypes.c_char_p, _i64p,   # md
            ctypes.c_char_p, _i64p,   # mc
            ctypes.c_char_p, _i64p,   # sa
            ctypes.c_char_p, _i64p,   # xa
            ctypes.c_char_p, _i64p,   # tail
            ctypes.c_char_p, _i64p,   # ctg names
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int64, _i64p]
        _lib = lib
        return _lib


def load() -> None:
    """Build (at first use) and load the library; raises on failure."""
    _load()


def _cat(arrs, dtype):
    offs = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum([len(a) for a in arrs], out=offs[1:])
    flat = np.empty(int(offs[-1]), dtype)
    for a, o in zip(arrs, offs):
        flat[int(o):int(o) + len(a)] = a
    return flat, offs


def ksw_global_batch(queries, targets, wband, mat, o_del, e_del, o_ins,
                     e_ins):
    """queries/targets: lists of nt4 uint8 arrays; wband: [n] int bands.
    Returns (scores [n] i32, cigars: list of [(op, len), ...])."""
    lib = _load()
    n = len(queries)
    q, qo = _cat(queries, np.uint8)
    t, to = _cat(targets, np.uint8)
    wb = np.ascontiguousarray(wband, np.int32)
    m = np.ascontiguousarray(np.asarray(mat, np.int8).reshape(-1))
    scores = np.zeros(n, np.int32)
    ncig = np.zeros(n, np.int32)
    cap = 64
    maxlen = int(max((qo[1:] - qo[:-1]).max(initial=1),
                     (to[1:] - to[:-1]).max(initial=1)))
    while True:
        cig = np.zeros((n, cap), np.uint32)
        rc = lib.ksw_global_batch(
            n, q.ctypes.data_as(_u8p), qo.ctypes.data_as(_i64p),
            t.ctypes.data_as(_u8p), to.ctypes.data_as(_i64p),
            wb.ctypes.data_as(_i32p), m.ctypes.data_as(_i8p),
            o_del, e_del, o_ins, e_ins,
            scores.ctypes.data_as(_i32p), ncig.ctypes.data_as(_i32p),
            cig.ctypes.data_as(_u32p), cap)
        if rc == 0:
            break
        if rc == -2 or cap > 4 * maxlen + 8:
            raise MemoryError("ksw_global_batch native failure")
        cap *= 4
    cigars = [[(int(c & 0xF), int(c >> 4)) for c in cig[b, : ncig[b]]]
              for b in range(n)]
    return scores, cigars


def mark_primary_batch(off, ids, score, qb, qe, is_alt, tmp, mask_level):
    """mem_mark_primary_se over flat read-major reg arrays (reads with
    n >= 2 only).  Returns (perm, secondary, secondary_all, sub, sub_n,
    alt_sc, n_pri) — perm[k] = read-local original index of sorted slot k."""
    lib = _load()
    n_reads = len(off) - 1
    n_regs = int(off[-1])
    outs = [np.zeros(n_regs, np.int32) for _ in range(6)]
    n_pri = np.zeros(n_reads, np.int32)
    rc = lib.mark_primary_batch(
        n_reads, np.ascontiguousarray(off, np.int64).ctypes.data_as(_i64p),
        np.ascontiguousarray(ids, np.int64).ctypes.data_as(_i64p),
        np.ascontiguousarray(score, np.int32).ctypes.data_as(_i32p),
        np.ascontiguousarray(qb, np.int32).ctypes.data_as(_i32p),
        np.ascontiguousarray(qe, np.int32).ctypes.data_as(_i32p),
        np.ascontiguousarray(is_alt, np.uint8).ctypes.data_as(_u8p),
        int(tmp), float(mask_level),
        *(o.ctypes.data_as(_i32p) for o in outs),
        n_pri.ctypes.data_as(_i32p))
    if rc != 0:
        raise MemoryError("mark_primary_batch native failure")
    return (*outs, n_pri)


def ksw_align_host(queries, targets, minsc, mat, o_del, e_del, o_ins,
                   e_ins, max_mat, p):
    """Unbanded local SW, ksw_align2 semantics (the device counterpart is
    ops/local_sw.ksw_align_batch).  queries/targets: lists of nt4 uint8
    arrays; p: emulated SIMD stripe (16 = ksw_u8, 8 = ksw_i16).  Returns a
    dict of int32 arrays score/te/qe/score2/te2/tb/qb."""
    lib = _load()
    n = len(queries)
    q, qo = _cat(queries, np.uint8)
    t, to = _cat(targets, np.uint8)
    m = np.ascontiguousarray(np.asarray(mat, np.int8).reshape(-1))
    ms = np.ascontiguousarray(minsc, np.int32)
    keys = ("score", "te", "qe", "score2", "te2", "tb", "qb")
    outs = {k: np.zeros(n, np.int32) for k in keys}
    rc = lib.ksw_align_host_batch(
        n, q.ctypes.data_as(_u8p), qo.ctypes.data_as(_i64p),
        t.ctypes.data_as(_u8p), to.ctypes.data_as(_i64p),
        ms.ctypes.data_as(_i32p), m.ctypes.data_as(_i8p),
        int(o_del), int(e_del), int(o_ins), int(e_ins), int(max_mat),
        int(p), *(outs[k].ctypes.data_as(_i32p) for k in keys))
    if rc != 0:
        raise MemoryError("ksw_align_host_batch native failure")
    return outs


def pair_batch(off0, off1, rb0, rid0, sc0, rb1, rid1, sc1, ids, ctg_off,
               l_pac, pes, a_sc, tmp):
    """mem_pair over all eligible pairs at once (bwamem_pair.c:208-269;
    plain counterpart: pair.mem_pair).  off0/off1 [n+1] index the flat
    per-end reg arrays (first n_pri regs per read).  pes: list of 4 PeStat.
    Returns (o, sub, n_sub, z0, z1) int32 arrays [n]."""
    lib = _load()
    n = len(off0) - 1
    c = np.ascontiguousarray
    outs = [np.zeros(n, np.int32) for _ in range(5)]
    rc = lib.pair_batch(
        n, c(off0, np.int64).ctypes.data_as(_i64p),
        c(off1, np.int64).ctypes.data_as(_i64p),
        c(rb0, np.int64).ctypes.data_as(_i64p),
        c(rid0, np.int32).ctypes.data_as(_i32p),
        c(sc0, np.int32).ctypes.data_as(_i32p),
        c(rb1, np.int64).ctypes.data_as(_i64p),
        c(rid1, np.int32).ctypes.data_as(_i32p),
        c(sc1, np.int32).ctypes.data_as(_i32p),
        c(ids, np.int64).ctypes.data_as(_i64p),
        c(ctg_off, np.int64).ctypes.data_as(_i64p), int(l_pac),
        c([p.failed for p in pes], np.int32).ctypes.data_as(_i32p),
        c([p.low for p in pes], np.int32).ctypes.data_as(_i32p),
        c([p.high for p in pes], np.int32).ctypes.data_as(_i32p),
        c([p.avg for p in pes], np.float64).ctypes.data_as(_f64p),
        c([p.std for p in pes], np.float64).ctypes.data_as(_f64p),
        int(a_sc), int(tmp),
        *(o.ctypes.data_as(_i32p) for o in outs))
    if rc != 0:
        raise MemoryError("pair_batch native failure")
    return tuple(outs)


def replay_batch(ch_base, c_w, c_beg, c_end, c_alt, c_pos, c_rid,
                 it_base, i_chain, i_qbeg, i_len, i_rbeg,
                 n_qb, n_qe, n_rb, n_re, n_w, skip, l_seq, opt,
                 has_res=None):
    """mem_chain_flt + mem_chain2aln accept/skip replay over read-major
    flat arenas (spec: pipeline/device_front._replay).  Returns
    (out_base [n+1] i64, out_m [emitted] i64 global item indices,
    out_rid [emitted] i32, needed [k] i64) in emission order.  `needed`
    is empty unless `has_res` (per-item u8 result mask) is given; then it
    lists items the walk would emit that lack extension results (the
    two-round driver's prepass / final-pass contract, hostops.c)."""
    lib = _load()
    n_reads = len(ch_base) - 1
    n_it = int(it_base[-1])
    out_base = np.zeros(n_reads + 1, np.int64)
    out_m = np.zeros(max(n_it, 1), np.int64)
    out_rid = np.zeros(max(n_it, 1), np.int32)
    out_need = np.zeros(max(n_it, 1), np.int64)
    out_nn = np.zeros(1, np.int64)
    c = np.ascontiguousarray
    hr = (None if has_res is None
          else c(has_res, np.uint8).ctypes.data_as(_u8p))
    rc = lib.replay_batch(
        n_reads,
        c(ch_base, np.int64).ctypes.data_as(_i64p),
        c(c_w, np.int32).ctypes.data_as(_i32p),
        c(c_beg, np.int32).ctypes.data_as(_i32p),
        c(c_end, np.int32).ctypes.data_as(_i32p),
        c(c_alt, np.uint8).ctypes.data_as(_u8p),
        c(c_pos, np.int64).ctypes.data_as(_i64p),
        c(c_rid, np.int32).ctypes.data_as(_i32p),
        c(it_base, np.int64).ctypes.data_as(_i64p),
        c(i_chain, np.int32).ctypes.data_as(_i32p),
        c(i_qbeg, np.int32).ctypes.data_as(_i32p),
        c(i_len, np.int32).ctypes.data_as(_i32p),
        c(i_rbeg, np.int64).ctypes.data_as(_i64p),
        c(n_qb, np.int32).ctypes.data_as(_i32p),
        c(n_qe, np.int32).ctypes.data_as(_i32p),
        c(n_rb, np.int64).ctypes.data_as(_i64p),
        c(n_re, np.int64).ctypes.data_as(_i64p),
        c(n_w, np.int32).ctypes.data_as(_i32p),
        c(skip, np.uint8).ctypes.data_as(_u8p),
        c(l_seq, np.int32).ctypes.data_as(_i32p),
        float(opt.mask_level), float(opt.drop_ratio),
        int(opt.min_seed_len), int(opt.max_chain_gap),
        int(opt.min_chain_weight), int(opt.max_chain_extend),
        int(opt.a), int(opt.o_del), int(opt.e_del),
        int(opt.o_ins), int(opt.e_ins), int(opt.w),
        hr, out_need.ctypes.data_as(_i64p), out_nn.ctypes.data_as(_i64p),
        out_base.ctypes.data_as(_i64p), out_m.ctypes.data_as(_i64p),
        out_rid.ctypes.data_as(_i32p))
    if rc != 0:
        raise MemoryError("replay_batch native failure")
    n_out = int(out_base[-1])
    return out_base, out_m[:n_out], out_rid[:n_out], out_need[:int(out_nn[0])]


def sam_render_batch(fields, names, cigars, seqs, quals, mds, mcs, sas,
                     xas, tails, ctg_blob, ctg_off, rg, xb_flag):
    """Render SAM lines (mem_aln2sam columns+tags) from numeric records.
    fields: [n, 20] int32 (see hostops.c sam_batch); blobs are lists of
    bytes/arrays per line.  Returns list[str] (each ending in newline)."""
    lib = _load()
    n = len(names)
    f = np.ascontiguousarray(fields, np.int32)
    name_b, name_o = _cat([np.frombuffer(x, np.uint8) for x in names],
                          np.uint8)
    cig_b, cig_o = _cat(cigars, np.uint32)
    seq_b, seq_o = _cat(seqs, np.uint8)
    qual_b, qual_o = _cat([np.frombuffer(x, np.uint8) for x in quals],
                          np.uint8)
    md_b, md_o = _cat([np.frombuffer(x, np.uint8) for x in mds], np.uint8)
    mc_b, mc_o = _cat([np.frombuffer(x, np.uint8) for x in mcs], np.uint8)
    sa_b, sa_o = _cat([np.frombuffer(x, np.uint8) for x in sas], np.uint8)
    xa_b, xa_o = _cat([np.frombuffer(x, np.uint8) for x in xas], np.uint8)
    tl_b, tl_o = _cat([np.frombuffer(x, np.uint8) for x in tails], np.uint8)
    line_off = np.zeros(n + 1, np.int64)
    cap = int(len(seq_b) * 2 + len(name_b) + len(md_b) + len(mc_b)
              + len(sa_b) + len(xa_b) + len(tl_b) + 256 * n + 1024)

    def cp(a):
        return a.ctypes.data_as(ctypes.c_char_p)

    while True:
        buf = ctypes.create_string_buffer(cap)
        need = lib.sam_batch(
            n, f.ctypes.data_as(_i32p),
            cp(name_b), name_o.ctypes.data_as(_i64p),
            cig_b.ctypes.data_as(_u32p), cig_o.ctypes.data_as(_i64p),
            seq_b.ctypes.data_as(_u8p), seq_o.ctypes.data_as(_i64p),
            cp(qual_b), qual_o.ctypes.data_as(_i64p),
            cp(md_b), md_o.ctypes.data_as(_i64p),
            cp(mc_b), mc_o.ctypes.data_as(_i64p),
            cp(sa_b), sa_o.ctypes.data_as(_i64p),
            cp(xa_b), xa_o.ctypes.data_as(_i64p),
            cp(tl_b), tl_o.ctypes.data_as(_i64p),
            ctg_blob, ctg_off.ctypes.data_as(_i64p),
            rg, len(rg), int(xb_flag),
            buf, cap, line_off.ctypes.data_as(_i64p))
        if need == 0:
            break
        cap = max(int(need), cap * 2)
    raw = buf.raw
    return [raw[int(line_off[b]): int(line_off[b + 1])].decode()
            for b in range(n)]


def nm_md_batch(cigars, qsegs, rseqs, is_rev):
    """cigars: list of [(op, len)], qsegs/rseqs: lists of nt4 uint8 arrays,
    is_rev: [n] bool.  Returns (nm [n] i32, md: list of str)."""
    lib = _load()
    n = len(cigars)
    cig_arrs = [np.asarray([(ln << 4) | op for op, ln in cg], np.uint32)
                for cg in cigars]
    cig, cig_off = _cat(cig_arrs, np.uint32)
    q, qo = _cat(qsegs, np.uint8)
    r, ro = _cat(rseqs, np.uint8)
    rev = np.ascontiguousarray(is_rev, np.uint8)
    nm = np.zeros(n, np.int32)
    md_off = np.zeros(n + 1, np.int64)
    cap = int(len(r) * 2 + 16 * n + 64)
    while True:
        buf = ctypes.create_string_buffer(cap)
        need = lib.nm_md_batch(
            n, cig.ctypes.data_as(_u32p), cig_off.ctypes.data_as(_i64p),
            q.ctypes.data_as(_u8p), qo.ctypes.data_as(_i64p),
            r.ctypes.data_as(_u8p), ro.ctypes.data_as(_i64p),
            rev.ctypes.data_as(_u8p), nm.ctypes.data_as(_i32p),
            buf, cap, md_off.ctypes.data_as(_i64p))
        if need == 0:
            break
        cap = max(int(need), cap * 2)
    raw = buf.raw
    md = [raw[int(md_off[b]):int(md_off[b + 1])].decode()
          for b in range(n)]
    return nm, md
