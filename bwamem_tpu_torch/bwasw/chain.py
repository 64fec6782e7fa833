"""BWA-SW seed chaining filter (bsw2_chain_filter, bwtsw2_chain.c).
Counterpart of bwamem_tpu/bwasw/chain.py."""
from __future__ import annotations

from bwamem_tpu_torch.bwasw.ksort import ks_introsort


class _Z:
    __slots__ = ("tbeg", "tend", "qbeg", "qend", "flag", "idx", "chain")

    def __init__(self, tbeg=0, tend=0, qbeg=0, qend=0, flag=0, idx=0,
                 chain=-1):
        self.tbeg = tbeg
        self.tend = tend
        self.qbeg = qbeg
        self.qend = qend
        self.flag = flag
        self.idx = idx
        self.chain = chain


def _hsaip_lt(a: _Z, b: _Z) -> bool:
    return a.qbeg < b.qbeg


def _chaining(opt, shift: int, z: list[_Z]) -> list[_Z]:
    """bwtsw2_chain.c:20-46."""
    chain: list[_Z] = []
    ks_introsort(z, _hsaip_lt)
    for p in z:
        k = len(chain) - 1
        while k >= 0:
            q = chain[k]
            x = p.qbeg - q.qbeg  # always positive after the sort
            y = p.tbeg - q.tbeg
            if 0 < y < opt.max_chain_gap and x < opt.max_chain_gap and \
                    -opt.bw <= x - y <= opt.bw:
                if p.qend > q.qend:
                    q.qend = p.qend
                if p.tend > q.tend:
                    q.tend = p.tend
                q.chain += 1
                p.chain = shift + k
                break
            elif q.chain > opt.t_seeds * 2:
                k = 0
            k -= 1
        if k < 0:
            c = _Z(p.tbeg, p.tend, p.qbeg, p.qend, p.flag, 0, 1)
            c.idx = shift + len(chain)
            p.chain = shift + len(chain)
            chain.append(c)
    return chain


def chain_filter(opt, length: int, b0: list, b1: list) -> tuple[list, list]:
    """Zero out hits whose chain is weak next to an overlapping strong
    chain (bwtsw2_chain.c:48-112); returns the two squeezed hit lists."""
    thres = opt.t_seeds * 2
    z = [[], []]
    for k, hits in enumerate((b0, b1)):
        for i, p in enumerate(hits):
            z[k].append(_Z(tbeg=p.k, tend=p.k + p.len, qbeg=p.beg,
                           qend=p.end, flag=k, idx=i))
    chain0 = _chaining(opt, 0, z[0])
    chain1 = _chaining(opt, len(chain0), z[1])
    # reverse-strand chains to forward query coordinates (:72-77)
    for p in chain1:
        p.qbeg, p.qend = length - p.qend, length - p.qbeg
    chains = chain0 + chain1
    flag = [0] * len(chains)
    ks_introsort(chains, _hsaip_lt)
    for k in range(1, len(chains)):
        p = chains[k]
        for q in chains[:k]:
            if flag[q.idx]:
                continue
            if q.qend >= p.qend and q.chain > p.chain * thres and \
                    p.chain < thres:
                flag[p.idx] = 1
                break
    for zz in z[0] + z[1]:
        if flag[zz.chain]:
            (b0, b1)[zz.flag][zz.idx].G = 0
    return [p for p in b0 if p.G], [p for p in b1 if p.G]
