"""Per-read BWT ("bwt_lite", bwt_lite.c): the read's suffix array, BWT and
16-base occ checkpoints, queried during the prefix-DAG traversal.
Counterpart of bwamem_tpu/bwasw/bwtl.py."""
from __future__ import annotations

import numpy as np

from bwamem_tpu_torch.index.build import suffix_array


class BwtLite:
    __slots__ = ("seq_len", "primary", "sa", "L2", "codes", "ckpt")

    def __init__(self, seq: np.ndarray):
        """seq: nt4 codes 0..3 (ambiguous bases already randomized by the
        caller, bwtsw2_aux.c:587)."""
        n = int(len(seq))
        self.seq_len = n
        # SA including the sentinel suffix at rank 0 (is_sa, bwt_lite.c:23)
        sa = np.empty(n + 1, np.int64)
        sa[0] = n
        sa[1:] = suffix_array(np.asarray(seq, np.uint8))
        self.sa = sa
        # BWT with $ squeezed out (bwt_lite.c:25-29)
        s = np.zeros(n + 1, np.uint8)
        nz = sa != 0
        s[nz] = seq[sa[nz] - 1]
        self.primary = int(np.nonzero(~nz)[0][0])
        bwt = np.concatenate([s[: self.primary], s[self.primary + 1:]])
        self.codes = bwt                                  # [n] 2-bit codes
        # occ checkpoints every 16 bases (bwt_lite.c:36-48)
        nb = (n + 15) // 16
        onehot = np.zeros((n, 4), np.int64)
        if n:
            onehot[np.arange(n), bwt] = 1
        csum = np.zeros((n + 1, 4), np.int64)
        np.cumsum(onehot, axis=0, out=csum[1:])
        self.ckpt = csum[np.arange(nb) * 16]              # counts before blk
        L2 = np.zeros(5, np.int64)
        L2[1:] = np.cumsum(csum[n])
        self.L2 = L2

    # occ4(k): counts in bwt[0..k] inclusive (bwtl_occ4, bwt_lite.c:72-86)
    def occ4(self, k: int) -> np.ndarray:
        if k == -1:
            return np.zeros(4, np.int64)
        if k >= self.primary:
            k -= 1
        blk = k >> 4
        cnt = self.ckpt[blk].copy()
        seg = self.codes[blk * 16: k + 1]
        cnt += np.bincount(seg, minlength=4)
        return cnt

    def occ4_pair(self, km1: int, l: int):
        return self.occ4(km1), self.occ4(l)
