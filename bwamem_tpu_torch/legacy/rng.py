"""drand48 — exact replica of the POSIX 48-bit LCG.

bwa seeds it with the .ann header seed (srand48(bns->seed),
bwase.c:517 / bwape.c:703) and draws from it during alignment selection
(bwa_aln2seq_core, bwase.c:35-41); byte-identical SAM requires replaying
the identical stream.  X < 2^48 is exactly representable in an IEEE
double and the division by 2^48 is exact, so Python floats reproduce the
C doubles bit-for-bit.
"""

_A = 0x5DEECE66D
_C = 0xB
_M = 1 << 48


class Drand48:
    def __init__(self, seed: int):
        self.x = ((seed & 0xFFFFFFFF) << 16) | 0x330E

    def drand(self) -> float:
        self.x = (_A * self.x + _C) % _M
        return self.x / _M
