"""A configuration's genome, made from its fixed seed.

Codes are nt4 (A 0, C 1, G 2, T 3, N 4) in one uint8 array per contig.
The sequence starts uniform at random; then the repeat families of the
configuration's `repeats` list are written over it in order, then its N
runs.  Two kinds of family:

- "interspersed": copies of `families` random consensus sequences of
  `consensus` bases; each copy is the 3' end of its consensus (5'
  truncation, as L1 copies are) of a length drawn uniformly from
  `length` (a [lo, hi] range), on a random strand, with each base changed
  with the copy's divergence, drawn uniformly from `divergence`.  Copies
  are drawn until they hold `share` of the contig.
- "duplication": copies of random stretches of the contig itself
  (`length` range), written elsewhere with `divergence` as above: the
  near-exact segmental duplications.

A changed base always becomes another base.  Copies may overlap; the
shares are those written, before any overlap.
"""
from __future__ import annotations

import numpy as np

CHUNK = 4096          # copies written a step (bounds the index temporaries)


def _mutate(rng, bases: np.ndarray, rate: np.ndarray) -> np.ndarray:
    """bases with each position changed to another base with probability
    `rate` (one rate a position)."""
    hit = rng.random(bases.shape[0]) < rate
    shift = rng.integers(1, 4, size=int(hit.sum()), dtype=np.uint8)
    out = bases.copy()
    out[hit] = (out[hit] + shift) & 3
    return out


def _lengths(rng, lo: int, hi: int, total: int) -> np.ndarray:
    """Copy lengths drawn uniformly from [lo, hi] until they sum to at
    least `total` (none when total is 0)."""
    if total <= 0:
        return np.zeros(0, np.int64)
    n = int(total / ((lo + hi) / 2) * 1.2) + 8
    lens = rng.integers(lo, hi + 1, size=n)
    keep = int(np.searchsorted(np.cumsum(lens), total)) + 1
    return lens[:keep]


def _write_copies(rng, seq: np.ndarray, src_of, lens: np.ndarray,
                  div: tuple[float, float]) -> None:
    """Write len(lens) copies into seq at random places; src_of(ids,
    within, lens_rep) gives the copies' bases before divergence."""
    n = len(lens)
    dst = rng.integers(0, max(1, len(seq) - int(lens.max(initial=1))),
                       size=n)
    rate = rng.uniform(div[0], div[1], size=n)
    rev = rng.random(n) < 0.5
    for c0 in range(0, n, CHUNK):
        ids = np.arange(c0, min(n, c0 + CHUNK))
        ln = lens[ids]
        rep = np.repeat(ids, ln)
        within = np.arange(len(rep)) - np.repeat(np.cumsum(ln) - ln, ln)
        base = src_of(rep, within, lens[rep])
        # reverse strand: the copy is the reverse complement
        r = rev[rep]
        if r.any():
            flip = src_of(rep[r], lens[rep[r]] - 1 - within[r],
                          lens[rep[r]])
            base[r] = 3 - flip
        seq[dst[rep] + within] = _mutate(rng, base, rate[rep])


def make_contig(rng, length: int, repeats: list[dict],
                n_runs: list[list[int]]) -> np.ndarray:
    seq = rng.integers(0, 4, size=length, dtype=np.uint8)
    for fam in repeats:
        total = int(fam["share"] * length)
        lo, hi = fam["length"]
        lens = _lengths(rng, lo, min(hi, length // 2), total)
        if not len(lens):
            continue
        if fam["kind"] == "interspersed":
            cons = rng.integers(0, 4, size=(fam["families"],
                                            fam["consensus"]), dtype=np.uint8)
            which = rng.integers(0, fam["families"], size=len(lens))
            clen = fam["consensus"]

            def src_of(rep, within, ln, cons=cons, which=which, clen=clen):
                # the 3' end of the consensus: 5' truncation
                return cons[which[rep], clen - ln + within]
        elif fam["kind"] == "duplication":
            src = rng.integers(0, length - int(lens.max()), size=len(lens))
            snap = seq

            def src_of(rep, within, ln, src=src, snap=snap):
                return snap[src[rep] + within]
        else:
            raise ValueError(f"unknown repeat kind {fam['kind']!r}")
        _write_copies(rng, seq, src_of, lens, tuple(fam["divergence"]))
    for start, ln in n_runs:
        seq[start:start + ln] = 4
    return seq


def n_runs_of(rng, length: int, spec: dict) -> list[list[int]]:
    """The contig's N runs: the fixed ones (`fixed`: [start, length]),
    then `scattered` runs of random lengths summing to `scattered_bases`,
    at random places."""
    runs = [list(map(int, r)) for r in spec.get("fixed", [])]
    k = int(spec.get("scattered", 0))
    if k:
        cuts = np.sort(rng.integers(1, int(spec["scattered_bases"]),
                                    size=k - 1))
        lens = np.diff(np.concatenate([[0], cuts,
                                       [int(spec["scattered_bases"])]]))
        starts = rng.integers(0, length - int(lens.max()), size=k)
        runs += [[int(s), int(ln)] for s, ln in zip(starts, lens) if ln > 0]
    return runs


def make_genome(cfg: dict) -> list[tuple[str, np.ndarray]]:
    """[(name, nt4 codes)] of every contig of the configuration, from its
    `genome_seed`; the same configuration gives the same bytes."""
    rng = np.random.default_rng(int(cfg["genome_seed"]))
    out = []
    for ctg in cfg["contigs"]:
        length = int(ctg["length"])
        runs = n_runs_of(rng, length, ctg.get("n_runs", {}))
        reps = cfg["repeats"] if ctg.get("repeat_model", True) else []
        out.append((ctg["name"], make_contig(rng, length, reps, runs)))
    return out


def write_fasta(contigs, path: str, width: int = 60) -> None:
    """FASTA of nt4 contigs, `width` bases a line."""
    letters = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for name, codes in contigs:
            f.write(f">{name}\n".encode())
            txt = letters[codes]
            n = len(txt)
            full = n // width * width
            if full:
                body = np.concatenate([txt[:full].reshape(-1, width),
                                       np.full((full // width, 1), 10,
                                               np.uint8)], axis=1)
                f.write(body.tobytes())
            if n > full:
                f.write(txt[full:].tobytes() + b"\n")
