"""Alignment options — parity with the reference mem_opt_t.

Field-for-field equivalent of mem_opt_t (reference bwa.h:86-118) with the
exact defaults of mem_opt_init (reference bwamem.c:74-110).  The default
values are part of SAM parity: they feed seed filtering, chain shadowing,
DP band widths and mapQ.

Read-type presets mirror fastmap.c:240-269 and match-score rescaling mirrors
update_a (fastmap.c:43-57): presets only touch fields the user did not set.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

# MEM_F_* flag bits (reference bwa.h:74-84)
MEM_F_PE = 0x2
MEM_F_NOPAIRING = 0x4
MEM_F_ALL = 0x8
MEM_F_NO_MULTI = 0x10
MEM_F_NO_RESCUE = 0x20
MEM_F_REF_HDR = 0x100
MEM_F_SOFTCLIP = 0x200
MEM_F_SMARTPE = 0x400
MEM_F_PRIMARY5 = 0x800
MEM_F_KEEP_SUPP_MAPQ = 0x1000
MEM_F_XB = 0x2000


def fill_scmat(a: int, b: int) -> np.ndarray:
    """5x5 scoring matrix, identical to bwa_fill_scmat (reference bwa.c:249):
    match=a, mismatch=-b, anything vs N = -1."""
    mat = np.full((5, 5), -1, dtype=np.int8)
    for i in range(4):
        for j in range(4):
            mat[i, j] = a if i == j else -b
    return mat


@dataclasses.dataclass
class MemOptions:
    # scoring (bwamem.c:79-87)
    a: int = 1                  # match score
    b: int = 4                  # mismatch penalty
    o_del: int = 6
    e_del: int = 1
    o_ins: int = 6
    e_ins: int = 1
    pen_unpaired: int = 17
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100                # band width
    zdrop: int = 100
    T: int = 30                 # output score threshold

    # seeding (bwamem.c:88-94)
    max_mem_intv: int = 20
    min_seed_len: int = 19
    # implementation knob (not a reference flag): consult the k-mer-12
    # fast-start table when the index carries one.  Only applied where the
    # skip is provably output-exact (ops.smem.kmer_pre); set False to force
    # the plain scans (e.g. for oracle A/B debugging).
    use_kmer_table: bool = True
    split_width: int = 10
    max_occ: int = 500
    max_chain_gap: int = 10000
    split_factor: float = 1.5

    # chaining / filtering (bwamem.c:95-106)
    max_ins: int = 10000
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    XA_drop_ratio: float = 0.80
    chunk_size: int = 30000000
    n_threads: int = 1
    max_XA_hits: int = 5
    max_XA_hits_alt: int = 200
    max_matesw: int = 50
    mask_level_redun: float = 0.95
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30

    # mapq (bwamem.c:107); mapQ_coef_fac is an INT in the reference
    # (bwa.h:113), so log(50) truncates to 3 — this truncation is part of
    # MAPQ parity.
    mapQ_coef_len: float = 50.0
    mapQ_coef_fac: int = int(math.log(50.0))

    flag: int = 0

    # ----- derived -----
    @property
    def mat(self) -> np.ndarray:
        # memoized on (a, b): this property is consulted per record in the
        # host finalization loops, and rebuilding 25 cells per call showed
        # up in the batch profile
        key = (self.a, self.b)
        cached = self.__dict__.get("_mat_cache")
        if cached is None or cached[0] != key:
            self.__dict__["_mat_cache"] = (key, fill_scmat(self.a, self.b))
        return self.__dict__["_mat_cache"][1]

    @property
    def split_len(self) -> int:
        """(int)(min_seed_len * split_factor + .499), bwamem.c:141"""
        return int(self.min_seed_len * self.split_factor + 0.499)

    def rescale(self, a: int, touched: set[str] | None = None) -> "MemOptions":
        """-A rescaling of dependent penalties, mirroring update_a
        (fastmap.c:43-57): scale untouched penalty fields by a."""
        touched = touched or set()
        o = dataclasses.replace(self, a=a)
        for f in ("b", "T", "o_del", "e_del", "o_ins", "e_ins", "zdrop",
                  "pen_clip5", "pen_clip3", "pen_unpaired"):
            if f not in touched:
                setattr(o, f, getattr(self, f) * a)
        return o


def preset(name: str, base: MemOptions | None = None,
           touched: set[str] | None = None) -> MemOptions:
    """Read-type presets -x pacbio|pbref|ont2d|intractg (fastmap.c:240-268).

    `touched` lists fields the user set explicitly (the opt0 "was-set"
    shadow struct in main_mem); presets only overwrite unset fields.
    """
    o = base or MemOptions()
    touched = touched or set()

    def maybe(field: str, val):
        if field not in touched:
            setattr(o, field, val)

    o = dataclasses.replace(o)  # copy
    if name == "intractg":
        maybe("o_del", 16); maybe("o_ins", 16); maybe("b", 9)
        maybe("pen_clip5", 5); maybe("pen_clip3", 5)
    elif name in ("pacbio", "pbref", "ont2d"):
        maybe("o_del", 1); maybe("e_del", 1); maybe("o_ins", 1)
        maybe("e_ins", 1); maybe("b", 1)
        if "split_factor" not in touched:
            o.split_factor = 10.0
        if name == "ont2d":
            maybe("min_chain_weight", 20); maybe("min_seed_len", 14)
        else:
            maybe("min_chain_weight", 40); maybe("min_seed_len", 17)
        maybe("pen_clip5", 0); maybe("pen_clip3", 0)
    else:
        raise ValueError(f"unknown preset {name!r}")
    return o


def options_from(fields: dict) -> MemOptions:
    """MemOptions from another options object's fields, carried across field
    by field (e.g. `dataclasses.asdict` of the reference package's
    MemOptions).  Unknown fields raise TypeError."""
    return MemOptions(**{k: v for k, v in fields.items()
                         if not k.startswith("_")})
