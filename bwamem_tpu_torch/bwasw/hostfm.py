"""Host-side (NumPy) FM-index lookups on the genome index.

The BWA-SW beam traversal interleaves tiny, data-dependent occ lookups with
host control flow; a launch and a copy back for each would cost far more
than the lookup, so the genome occ4 runs here, vectorized over the wave of
cells being processed (bwt_occ4/bwt_2occ4, bwt.c:134-185 semantics).
Rank→position lookups batch through the device walk instead
(ops.fm.sa_lookup).  Counterpart of bwamem_tpu/bwasw/hostfm.py."""
from __future__ import annotations

import bisect

import numpy as np

OCC_INTERVAL = 128


class HostFM:
    """Genome FM arrays in host memory + bns annotations."""

    def __init__(self, idx):
        self.idx = idx
        self.seq_len = int(idx.seq_len)
        self.primary = int(idx.primary)
        self.l_pac = int(idx.l_pac)
        self.L2 = np.asarray(idx.L2, np.int64)
        self.occ = np.asarray(idx.occ, np.int64)          # [nb+1, 4]
        # bwt words padded to whole 8-word (128-base) blocks
        n_words = (self.seq_len + 15) >> 4
        nb = (self.seq_len + OCC_INTERVAL - 1) // OCC_INTERVAL
        w = np.zeros(nb * 8, np.uint32)
        w[:n_words] = idx.bwt_words[:n_words]
        # pre-split into per-position 2-bit codes for vectorized counting:
        # [nb, 128] uint8 (≤ seq_len bytes; the index itself is 4x smaller
        # but the traversal is lookup-bound, trade memory for speed)
        shifts = ((15 - np.arange(16)) * 2).astype(np.uint32)
        codes = (w[:, None] >> shifts[None, :]) & 3
        self.codes = codes.reshape(nb, 128).astype(np.uint8)
        self.pac = np.asarray(idx.pac, np.uint8)
        self.ctg_off = idx.contig_offsets()
        self.ctg_len = idx.contig_lens()
        self.amb_off = np.array([a.offset for a in idx.ambs], np.int64)
        self.amb_len = np.array([a.len for a in idx.ambs], np.int64)

    # ---- occ ----
    def occ4(self, k: np.ndarray) -> np.ndarray:
        """Counts of each base in BWT[0..k] inclusive, [n, 4] (bwt_occ4).
        k == -1 rows return 0; k may equal seq_len."""
        k = np.asarray(k, np.int64)
        neg = k == -1
        kk = np.where(neg, 0, k)
        kk = np.where(kk >= self.primary, kk - 1, kk)   # $ not in bwt
        blk = kk >> 7
        off = (kk & 127).astype(np.int64)
        rows = self.codes[blk]                          # [n, 128]
        mask = np.arange(128)[None, :] <= off[:, None]
        cnt = np.empty((len(kk), 4), np.int64)
        for c in range(4):
            cnt[:, c] = ((rows == c) & mask).sum(axis=1)
        cnt += self.occ[blk]
        cnt[neg] = 0
        return cnt

    def occ4_pair(self, km1: np.ndarray, l: np.ndarray):
        """bwt_2occ4: occ4 at k-1 and l in one padded batch."""
        both = self.occ4(np.concatenate([km1, l]))
        n = len(km1)
        return both[:n], both[n:]

    # ---- reference bases ----
    def get_seq(self, beg: int, end: int) -> np.ndarray:
        """Forward-pac slice [beg, end) as nt4 codes (bns_get_seq for
        beg < end <= l_pac; callers handle the reverse strand)."""
        ks = np.arange(beg, end, dtype=np.int64)
        return (self.pac[ks >> 2] >> ((~ks & 3) << 1)).astype(np.uint8) & 3

    # ---- bns ----
    def pos2rid(self, pos_f: int) -> int:
        return bisect.bisect_right(self.ctg_off, pos_f) - 1

    def cnt_ambi(self, pos_f: int, length: int) -> tuple[int, int]:
        """(n_ambiguous_bases, rid) over [pos_f, pos_f+length)
        (bns_cnt_ambi, bntseq.c:334-357: binary search, first overlap)."""
        rid = self.pos2rid(pos_f)
        left, right, nn = 0, len(self.amb_off), 0
        while left < right:
            mid = (left + right) >> 1
            o, ln = int(self.amb_off[mid]), int(self.amb_len[mid])
            if pos_f >= o + ln:
                left = mid + 1
            elif pos_f + length <= o:
                right = mid
            else:
                if pos_f >= o:
                    nn = o + ln - pos_f if o + ln < pos_f + length else length
                else:
                    nn = ln if o + ln < pos_f + length \
                        else length - (o - pos_f)
                break
        return nn, rid

    def depos(self, pos: int) -> tuple[int, bool]:
        """bns_depos: map both-strand coordinate to forward + strand."""
        is_rev = pos >= self.l_pac
        return ((self.l_pac << 1) - 1 - pos) if is_rev else pos, is_rev
