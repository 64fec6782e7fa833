"""Exact klib ks_introsort replay with an arbitrary comparator.

klib's introsort (ksort.h:141-190) is not stable, and BWA-SW sorts carry
ties whose final order feeds directly into hit filtering and SAM output, so
byte-identical results require replaying the exact pivot/partition/combsort
sequence (same approach as pipeline/chainflt_host.ks_introsort_mem_flt_perm,
generalized over `lt`).  Counterpart of bwamem_tpu/bwasw/ksort.py."""
from __future__ import annotations


def ks_introsort(a: list, lt) -> None:
    """Sort list `a` in place exactly as ks_introsort(name) with __sort_lt
    = lt would."""
    n = len(a)

    def insertsort(s, t):
        for i in range(s + 1, t):
            j = i
            while j > s and lt(a[j], a[j - 1]):
                a[j], a[j - 1] = a[j - 1], a[j]
                j -= 1

    def combsort(off, cnt):
        shrink = 1.2473309501039786540366528676643
        gap = cnt
        while True:
            if gap > 2:
                gap = int(gap / shrink)
                if gap in (9, 10):
                    gap = 11
            do_swap = False
            for i in range(off, off + cnt - gap):
                j = i + gap
                if lt(a[j], a[i]):
                    a[i], a[j] = a[j], a[i]
                    do_swap = True
            if not (do_swap or gap > 2):
                break
        if gap != 1:
            insertsort(off, off + cnt)

    if n < 2:
        return
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return
    d = 2
    while (1 << d) < n:
        d += 1
    stack = []
    s, t = 0, n - 1
    d <<= 1
    while True:
        if s < t:
            d -= 1
            if d == 0:
                combsort(s, t - s + 1)
                t = s
                continue
            i, j = s, t
            k = i + ((j - i) >> 1) + 1
            if lt(a[k], a[i]):
                if lt(a[k], a[j]):
                    k = j
            else:
                k = i if lt(a[j], a[i]) else j
            rp = a[k]
            if k != t:
                a[k], a[t] = a[t], a[k]
            while True:
                i += 1
                while lt(a[i], rp):
                    i += 1
                j -= 1
                while i <= j and lt(rp, a[j]):
                    j -= 1
                if j <= i:
                    break
                a[i], a[j] = a[j], a[i]
            a[i], a[t] = a[t], a[i]
            if i - s > t - i:
                if i - s > 16:
                    stack.append((s, i - 1, d))
                s = i + 1 if t - i > 16 else t
            else:
                if t - i > 16:
                    stack.append((i + 1, t, d))
                t = i - 1 if i - s > 16 else s
        else:
            if not stack:
                insertsort(0, n)
                return
            s, t, d = stack.pop()
