"""BwaIndex — the runtime FM-index container + (de)serialization.

Host representation is NumPy; ops.fm.fm_from_index turns it into the
tensors the device pipeline consumes.

Two on-disk formats:
  * our native .npz (everything in the de-interleaved device layout);
  * the reference's .pac/.ann/.amb/.bwt/.sa family (bwt.c:385-407,
    bntseq.c:65-95), readable and writable bit-for-bit so indexes can be
    cross-validated and exchanged with stock bwa.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

OCC_INTERVAL = 128


@dataclasses.dataclass
class Contig:
    name: str
    anno: str
    offset: int
    len: int
    n_ambs: int
    is_alt: bool = False
    gi: int = 0


@dataclasses.dataclass
class AmbRun:
    offset: int
    len: int
    amb: str


@dataclasses.dataclass
class BwaIndex:
    l_pac: int                 # forward-strand length
    seq_len: int               # 2 * l_pac (both strands)
    primary: int               # S^{-1}(0)
    L2: np.ndarray             # [5] cumulative symbol counts
    bwt_words: np.ndarray      # uint32 [ceil(seq_len/16)] packed BWT
    occ: np.ndarray            # [n_blocks+1, 4] checkpoint counts
    sa_samples: np.ndarray     # SA_full[r] for r % sa_intv == 0
    sa_intv: int
    pac: np.ndarray            # uint8 forward-strand 2-bit packed
    contigs: list[Contig]
    ambs: list[AmbRun]
    kmer_table: tuple | None = None  # (x0, x1, size) arrays of len 4^K

    # ---------- derived ----------
    @property
    def itype(self):
        """Narrowest integer dtype for BWT ranks/positions on device."""
        return np.int32 if self.seq_len + 1 < 2**31 else np.int64

    @property
    def n_seqs(self) -> int:
        return len(self.contigs)

    def contig_offsets(self) -> np.ndarray:
        return np.array([c.offset for c in self.contigs], dtype=np.int64)

    def contig_lens(self) -> np.ndarray:
        return np.array([c.len for c in self.contigs], dtype=np.int64)

    def is_alt_flags(self) -> np.ndarray:
        return np.array([c.is_alt for c in self.contigs], dtype=np.int32)

    # ---------- native npz ----------
    def save(self, prefix: str) -> None:
        meta = dict(
            l_pac=self.l_pac, seq_len=self.seq_len, primary=self.primary,
            sa_intv=self.sa_intv,
            contig_names=[c.name for c in self.contigs],
            contig_annos=[c.anno for c in self.contigs],
            contig_offsets=[c.offset for c in self.contigs],
            contig_lens=[c.len for c in self.contigs],
            contig_n_ambs=[c.n_ambs for c in self.contigs],
            contig_is_alt=[c.is_alt for c in self.contigs],
            amb_offsets=[a.offset for a in self.ambs],
            amb_lens=[a.len for a in self.ambs],
            amb_chars=[a.amb for a in self.ambs],
        )
        import json
        arrays = dict(L2=self.L2, bwt_words=self.bwt_words, occ=self.occ,
                      sa_samples=self.sa_samples, pac=self.pac)
        savez = np.savez
        if self.kmer_table is not None:
            it = self.itype
            arrays.update(kmer_x0=self.kmer_table[0].astype(it),
                          kmer_x1=self.kmer_table[1].astype(it),
                          kmer_size=self.kmer_table[2].astype(it))
            savez = np.savez_compressed   # 3 x 4^12 mostly-sparse entries
        savez(prefix + ".bt.npz", meta=np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8), **arrays)

    @classmethod
    def load(cls, prefix: str) -> "BwaIndex":
        import json
        z = np.load(prefix + ".bt.npz")
        meta = json.loads(bytes(z["meta"]).decode())
        contigs = [Contig(name=n, anno=a, offset=o, len=l, n_ambs=na,
                          is_alt=al)
                   for n, a, o, l, na, al in zip(
                       meta["contig_names"], meta["contig_annos"],
                       meta["contig_offsets"], meta["contig_lens"],
                       meta["contig_n_ambs"], meta["contig_is_alt"])]
        ambs = [AmbRun(offset=o, len=l, amb=c) for o, l, c in zip(
            meta["amb_offsets"], meta["amb_lens"], meta["amb_chars"])]
        kmer = None
        if "kmer_x0" in z:
            kmer = (z["kmer_x0"], z["kmer_x1"], z["kmer_size"])
        return cls(l_pac=meta["l_pac"], seq_len=meta["seq_len"],
                   primary=meta["primary"], L2=z["L2"],
                   bwt_words=z["bwt_words"], occ=z["occ"],
                   sa_samples=z["sa_samples"], sa_intv=meta["sa_intv"],
                   pac=z["pac"], contigs=contigs, ambs=ambs, kmer_table=kmer)

    # ---------- reference bwa file formats ----------
    @classmethod
    def load_reference_format(cls, prefix: str) -> "BwaIndex":
        # .ann
        contigs: list[Contig] = []
        with open(prefix + ".ann") as f:
            l_pac, n_seqs, _seed = (int(x) for x in f.readline().split())
            for _ in range(n_seqs):
                parts = f.readline().rstrip("\n").split(" ", 2)
                gi, name = int(parts[0]), parts[1]
                anno = parts[2] if len(parts) > 2 else ""
                if anno == "(null)":
                    anno = ""
                off, ln, na = (int(x) for x in f.readline().split())
                contigs.append(Contig(name=name, anno=anno, offset=off,
                                      len=ln, n_ambs=na, gi=gi))
        ambs: list[AmbRun] = []
        with open(prefix + ".amb") as f:
            _, _, n_holes = (int(x) for x in f.readline().split())
            for _ in range(n_holes):
                o, l, c = f.readline().split()
                ambs.append(AmbRun(offset=int(o), len=int(l), amb=c))
        if os.path.exists(prefix + ".alt"):
            alt_names = set()
            with open(prefix + ".alt") as f:
                for line in f:
                    if line and not line.startswith("@"):
                        alt_names.add(line.split("\t")[0].strip())
            for c in contigs:
                c.is_alt = c.name in alt_names
        # .pac
        raw = np.fromfile(prefix + ".pac", dtype=np.uint8)
        pac = raw[: (l_pac + 3) // 4].copy()
        # .bwt
        with open(prefix + ".bwt", "rb") as f:
            primary = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
            l2_tail = np.fromfile(f, dtype=np.uint64, count=4).astype(np.int64)
            inter = np.fromfile(f, dtype=np.uint32)
        L2 = np.zeros(5, dtype=np.int64)
        L2[1:] = l2_tail
        seq_len = int(L2[4])
        # de-interleave
        n_words = (seq_len + 15) >> 4
        nb = (seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
        bwt_words = np.zeros(n_words, dtype=np.uint32)
        occ = np.zeros((nb + 1, 4), dtype=np.int64)
        k = 0
        w = 0
        for b in range(nb):
            occ[b] = inter[k:k + 8].view(np.uint64).astype(np.int64)
            k += 8
            w_end = min(w + 8, n_words)
            bwt_words[w:w_end] = inter[k:k + (w_end - w)]
            k += w_end - w
            w = w_end
        occ[nb] = inter[k:k + 8].view(np.uint64).astype(np.int64)
        # .sa
        with open(prefix + ".sa", "rb") as f:
            p2 = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
            assert p2 == primary, "SA-BWT inconsistency"
            np.fromfile(f, dtype=np.uint64, count=4)
            sa_intv = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
            sl = int(np.fromfile(f, dtype=np.uint64, count=1)[0])
            assert sl == seq_len
            n_sa = (seq_len + sa_intv) // sa_intv
            rest = np.fromfile(f, dtype=np.uint64, count=n_sa - 1)
        sa_samples = np.empty(n_sa, dtype=np.int64)
        sa_samples[0] = seq_len  # stored as -1 in the file; we keep seq_len
        sa_samples[1:] = rest.astype(np.int64)
        return cls(l_pac=l_pac, seq_len=seq_len, primary=primary, L2=L2,
                   bwt_words=bwt_words, occ=occ, sa_samples=sa_samples,
                   sa_intv=sa_intv, pac=pac, contigs=contigs, ambs=ambs)

    def _interleaved_bwt(self) -> np.ndarray:
        """Rebuild the reference's occ-interleaved .bwt array
        (bwtindex.c:150-172): per 128-base block, 8 u32 words of checkpoint
        counts (4 little-endian u64) then up to 8 u32 words of packed BWT;
        a final checkpoint trails the last (possibly partial) block."""
        n = self.seq_len
        n_words = (n + 15) >> 4
        n_ckpt = (n + OCC_INTERVAL - 1) // OCC_INTERVAL + 1
        out = np.zeros(n_words + n_ckpt * 8, dtype=np.uint32)
        occ64 = self.occ.astype(np.uint64)
        k = 0
        w = 0
        nb = n_ckpt - 1
        for b in range(nb):
            ck = occ64[b].view(np.uint32)  # LE: lo word first
            out[k:k + 8] = ck
            k += 8
            w_end = min(w + 8, n_words)
            out[k:k + (w_end - w)] = self.bwt_words[w:w_end]
            k += w_end - w
            w = w_end
        out[k:k + 8] = occ64[nb].view(np.uint32)
        return out

    def save_reference_format(self, prefix: str) -> None:
        # .pac (bntseq.c:314-327)
        with open(prefix + ".pac", "wb") as f:
            f.write(self.pac.tobytes())
            if self.l_pac % 4 == 0:
                f.write(b"\0")
            f.write(bytes([self.l_pac % 4]))
        # .ann / .amb (bntseq.c:65-95)
        with open(prefix + ".ann", "w") as f:
            f.write(f"{self.l_pac} {self.n_seqs} 11\n")
            for c in self.contigs:
                anno = c.anno if c.anno else "(null)"
                f.write(f"{c.gi} {c.name} {anno}\n")
                f.write(f"{c.offset} {c.len} {c.n_ambs}\n")
        with open(prefix + ".amb", "w") as f:
            f.write(f"{self.l_pac} {self.n_seqs} {len(self.ambs)}\n")
            for a in self.ambs:
                f.write(f"{a.offset} {a.len} {a.amb}\n")
        # .bwt (bwt.c:385-394): primary, L2[1..4], interleaved array
        with open(prefix + ".bwt", "wb") as f:
            np.array([self.primary], dtype=np.uint64).tofile(f)
            self.L2[1:5].astype(np.uint64).tofile(f)
            self._interleaved_bwt().tofile(f)
        # .sa (bwt.c:396-407): primary, L2[1..4], sa_intv, seq_len, sa[1:].
        # Our runtime stride may be denser than the reference's 32
        # (build.runtime_sa_interval); the FILE is always written at stride
        # 32 so it stays bit-identical to `bwa index` output.
        file_intv, samples = self.sa_intv, self.sa_samples
        if file_intv < 32 and 32 % file_intv == 0:
            samples = samples[:: 32 // file_intv]
            file_intv = 32
        with open(prefix + ".sa", "wb") as f:
            np.array([self.primary], dtype=np.uint64).tofile(f)
            self.L2[1:5].astype(np.uint64).tofile(f)
            np.array([file_intv, self.seq_len], dtype=np.uint64).tofile(f)
            sa = samples.astype(np.uint64).copy()
            sa[1:].tofile(f)
