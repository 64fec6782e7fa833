"""FASTQ/FASTA ingest into fixed-shape nt4 batches.

Equivalent of the reference's kseq-based bseq_read2 (bwa.c:89-224): reads
are converted to 0-4 nt4 codes at read time, names/comments/quals kept as
Python strings.  Batches are padded to a static (N, L) shape so the device
programs see few distinct shapes (bucketing by length class happens in the
pipeline driver, mirroring batch_config.h's fixed SEQ_MAXLEN).
"""
from __future__ import annotations

import dataclasses
import gzip
from typing import Iterator, Optional

import numpy as np

NT4_TABLE = np.full(256, 4, np.uint8)
for _i, _c in enumerate("ACGT"):
    NT4_TABLE[ord(_c)] = _i
    NT4_TABLE[ord(_c.lower())] = _i


@dataclasses.dataclass
class Read:
    """bseq1_t equivalent (reference bwa.h:178-186)."""
    name: str
    seq: np.ndarray          # nt4 uint8
    qual: Optional[str] = None
    comment: Optional[str] = None
    raw: Optional[str] = None  # original characters (kept on request only:
    # bwasw echoes the input bytes — case, IUPAC codes — into SAM SEQ)

    @property
    def l_seq(self) -> int:
        return len(self.seq)


def _open(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "rt")


def read_fastx(path: str, keep_raw: bool = False) -> Iterator[Read]:
    """Minimal kseq: handles FASTQ and FASTA, multi-line sequences."""
    with _open(path) as f:
        name = comment = None
        seq_parts: list[str] = []
        is_fq = False
        line = f.readline()
        while line:
            line = line.rstrip("\n")
            if not line:
                line = f.readline()
                continue
            if line[0] in "@>":
                is_fq = line[0] == "@"
                fields = line[1:].split(None, 1)
                name = fields[0]
                comment = fields[1] if len(fields) > 1 else None
                seq_parts = []
                line = f.readline()
                while line and line[0] not in "@>+":
                    seq_parts.append(line.rstrip("\n"))
                    line = f.readline()
                seq = "".join(seq_parts)
                qual = None
                if is_fq and line and line[0] == "+":
                    qparts: list[str] = []
                    got = 0
                    line = f.readline()
                    while line and got < len(seq):
                        s = line.rstrip("\n")
                        qparts.append(s)
                        got += len(s)
                        line = f.readline()
                    qual = "".join(qparts)
                yield Read(name=name,
                           seq=NT4_TABLE[np.frombuffer(
                               seq.encode(), np.uint8)].copy(),
                           qual=qual, comment=comment,
                           raw=seq if keep_raw else None)
            else:
                line = f.readline()


def interleave(r1: Iterator[Read], r2: Iterator[Read]) -> Iterator[Read]:
    """PE interleaving with /1 /2 suffix trim (bwa.c:150-171)."""
    for a, b in zip(r1, r2):
        for r in (a, b):
            if len(r.name) > 2 and r.name[-2] == "/" and r.name[-1] in "12":
                r.name = r.name[:-2]
        yield a
        yield b


def batches(reads: Iterator[Read], n_batch: int) -> Iterator[list[Read]]:
    buf: list[Read] = []
    for r in reads:
        buf.append(r)
        if len(buf) == n_batch:
            yield buf
            buf = []
    if buf:
        yield buf


def pack_batch(reads: list[Read], n_pad: int, l_pad: int):
    """Reads → (seq [n_pad, l_pad] uint8 nt4 with 4-padding, l_seq [n_pad])."""
    seq = np.full((n_pad, l_pad), 4, np.uint8)
    l_seq = np.zeros(n_pad, np.int32)
    for i, r in enumerate(reads):
        n = min(len(r.seq), l_pad)
        seq[i, :n] = r.seq[:n]
        l_seq[i] = n
    return seq, l_seq
