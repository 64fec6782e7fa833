"""Reads from the run's seed, with their origins.

A vectorised copy of tools/simdata.py's sim_reads: reads start at
uniform places, weighted by contig length, on either strand; each base
is deleted with `indel_rate`, has a random base inserted before it with
`indel_rate`, and is replaced by a random base (one of four) with
`sub_rate`; a read is cut or padded with random bases to its length.
Pairs take a fragment of length max(read_len + 10, N(insert_mean,
insert_sd)), read 1 from one end and read 2 from the other on the
opposite strand (FR), which end first at random (simdata's swap is a
no-op; here it swaps).  Unlike simdata, no read or fragment overlaps an N
run, so every read has a place it came from.

Origins are kept per read: contig index, leftmost 0-based position of
the bases it was read from, and strand (1 when the read is the reverse
complement of the genome there).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Genome:
    """The configuration's contigs as one nt4 array with offsets."""
    names: list[str]
    codes: np.ndarray          # uint8, every contig in order
    offsets: np.ndarray        # int64 [n_contigs]
    lens: np.ndarray           # int64 [n_contigs]
    n_starts: np.ndarray       # int64: N runs in global coordinates
    n_ends: np.ndarray

    @classmethod
    def of(cls, contigs) -> "Genome":
        names = [n for n, _ in contigs]
        lens = np.array([len(c) for _, c in contigs], np.int64)
        offsets = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        codes = (np.concatenate([c for _, c in contigs]) if len(contigs) > 1
                 else contigs[0][1])
        isn = np.flatnonzero(np.diff(np.concatenate(
            [[0], (codes == 4).view(np.int8), [0]])))
        return cls(names, codes, offsets, lens, isn[0::2].astype(np.int64),
                   isn[1::2].astype(np.int64))

    def touches_n(self, start: np.ndarray, end: np.ndarray) -> np.ndarray:
        """Whether each global [start, end) holds an N."""
        k = np.searchsorted(self.n_ends, start, side="right")
        ok = k < len(self.n_starts)
        hit = np.zeros(len(start), bool)
        hit[ok] = self.n_starts[k[ok]] < end[ok]
        return hit


@dataclasses.dataclass
class Batch:
    seqs: np.ndarray           # uint8 [n, L] in read orientation
    ctg: np.ndarray            # int32 [n]
    pos: np.ndarray            # int64 [n] leftmost, on the contig
    strand: np.ndarray         # uint8 [n]
    first: int                 # global index of the batch's first read


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """Independent stream `stream` of the run's seed (any whole number)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), int(stream)])


def _places(rng, g: Genome, n: int, span: np.ndarray) -> tuple:
    """n (contig, global start) pairs whose [start, start + span) lies in
    one contig and holds no N."""
    p = g.lens / g.lens.sum()
    ctg = np.zeros(n, np.int32)
    gpos = np.zeros(n, np.int64)
    todo = np.arange(n)
    while len(todo):
        c = rng.choice(len(g.lens), size=len(todo), p=p).astype(np.int32)
        room = np.maximum(1, g.lens[c] - span[todo])
        s = g.offsets[c] + (rng.random(len(todo)) * room).astype(np.int64)
        bad = g.touches_n(s, s + span[todo]) | (span[todo] > g.lens[c])
        ctg[todo[~bad]] = c[~bad]
        gpos[todo[~bad]] = s[~bad]
        todo = todo[bad]
    return ctg, gpos


def _errors(rng, src: np.ndarray, sub_rate: float,
            indel_rate: float) -> np.ndarray:
    """simdata's mutate over rows of src (uint8 [n, L]), vectorised; only
    the rows with an indel go through the token shuffle."""
    n, L = src.shape
    r = rng.random((n, L), dtype=np.float32)
    sub = rng.random((n, L), dtype=np.float32) < sub_rate
    base = np.where(sub, rng.integers(0, 4, (n, L), dtype=np.uint8), src)
    rows = np.flatnonzero((r < 2 * indel_rate).any(axis=1))
    if not len(rows):
        return base
    m = len(rows)
    rr = r[rows]
    ins = (rr >= indel_rate) & (rr < 2 * indel_rate)
    keep = rr >= indel_rate
    ins_base = rng.integers(0, 4, (m, L), dtype=np.uint8)
    valid = np.stack([ins, keep], -1).reshape(m, 2 * L)
    vals = np.stack([ins_base, base[rows]], -1).reshape(m, 2 * L)
    rank = np.cumsum(valid, axis=1) - 1
    out = rng.integers(0, 4, (m, L), dtype=np.uint8)     # the padding
    sel = valid & (rank < L)
    at = np.broadcast_to(np.arange(m)[:, None], sel.shape)
    out[at[sel], rank[sel]] = vals[sel]
    base[rows] = out
    return base


def _segments(g: Genome, gpos: np.ndarray, L: int, rev: np.ndarray):
    seg = g.codes[gpos[:, None] + np.arange(L)]
    seg[rev] = 3 - seg[rev, ::-1]
    return seg


def make_batch(g: Genome, traffic: dict, seed: int, stream: int,
               n_reads: int, first: int) -> Batch:
    """One batch of `n_reads` reads (interleaved mates for pairs) from
    stream `stream` of the seed."""
    rng = rng_for(seed, stream)
    L = int(traffic["read_len"])
    sub, ind = float(traffic["sub_rate"]), float(traffic["indel_rate"])
    if traffic["paired"]:
        n_pairs = n_reads // 2
        ins = np.maximum(L + 10, rng.normal(
            traffic["insert_mean"], traffic["insert_sd"], n_pairs).astype(
                np.int64))
        ctg, g0 = _places(rng, g, n_pairs, ins)
        swap = rng.random(n_pairs) < 0.5
        # mate at the fragment's left end reads forward, the other reads
        # the right end reverse-complemented
        left = g0
        right = g0 + ins - L
        s1 = np.where(swap, right, left)
        s2 = np.where(swap, left, right)
        gpos = np.stack([s1, s2], 1).reshape(-1)
        strand = np.stack([swap, ~swap], 1).reshape(-1).astype(np.uint8)
        ctg = np.repeat(ctg, 2)
    else:
        span = np.full(n_reads, L, np.int64)
        ctg, gpos = _places(rng, g, n_reads, span)
        strand = (rng.random(n_reads) < 0.5).astype(np.uint8)
    seqs = _errors(rng, _segments(g, gpos, L, strand.astype(bool)), sub, ind)
    return Batch(seqs, ctg, gpos - g.offsets[ctg], strand, first)


def batch_reads(traffic: dict) -> int:
    """Reads a batch holds: cut by bases as cli._batches_by_bases cuts a
    stream (stop at >= batch_bases, pairs kept whole)."""
    L = int(traffic["read_len"])
    n = -(-int(traffic["batch_bases"]) // L)
    if traffic["paired"] and n % 2:
        n += 1
    return n
