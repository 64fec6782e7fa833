#!/usr/bin/env python3
"""Times the extension kernels' group step (bwamem_tpu_torch/csrc/
ext_kernel.cu) against variants of it, on one NVIDIA GPU, in one process.

    python3 tools/torch_ext_variants.py

Each variant is a textual patch of the shipped source, built with the same
nvcc flags into its own library under build/:
  shipped    csrc/ext_kernel.cu as it is;
  prefetch   each chunk's cells loaded before the scan of the chunk before;
  early_red  the row's four reductions taken ahead of its breaks (the
             shipped step reduces fnz and lnz only when the row goes on);
  both       the two together.
The lanes are chip_smoke.py's phase-2 lanes: 16384 EXT-shaped lanes
through ext_pl2 (128 query x 256 target rows, w_opt 100), 1024 long lanes
through ext_pl (4095 x 4608, bands 100 and 200) and 1024 ring-wrap lanes
through ext_pl (3000 x 3064, band 10), at G = 32 (ops/ext_kernel.GROUP).
Each shape runs the variants in the order shipped, prefetch, early_red,
both, both, early_red, prefetch, shipped, each a median of 7 calls timed
with CUDA events; every variant's outputs must equal the shipped kernel's
(exit 1 otherwise).  Prints the card's name and power limit, then one line
per shape with each variant's two times in ms."""
from __future__ import annotations

import os
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

PREFETCH = ('''    for (int c0 = beg; c0 < end; c0 += G) {
      const int j = c0 + t;
      int M = 0, e = 0;
      if (j < end) cell_in(eh, Q, j, hi, R, h0, srow, P, M, e);
''', '''    int nM = 0, ne = 0;
    if (beg + t < end) cell_in(eh, Q, beg + t, hi, R, h0, srow, P, nM, ne);
    for (int c0 = beg; c0 < end; c0 += G) {
      const int j = c0 + t;
      const int M = nM, e = ne;
      nM = ne = 0;
      if (j + G < end) cell_in(eh, Q, j + G, hi, R, h0, srow, P, nM, ne);
''')
EARLY_RED = ('''    const int m = __reduce_max_sync(mask, k.m);
    const int mj = __reduce_max_sync(mask, k.m == m ? k.mj : -1);
    if (row_close(i, imax(beg, end), h1, m, mj, qlen, P, r)) break;
    const int fnz = __reduce_min_sync(mask, k.fnz);
    const int lnz = h1 != 0 ? end : __reduce_max_sync(mask, k.lnz);
    row_shrink(fnz, lnz, qlen, beg, end);
''', '''    const int m = __reduce_max_sync(mask, k.m);
    const int fnz = __reduce_min_sync(mask, k.fnz);
    const int lnz = __reduce_max_sync(mask, k.lnz);
    const int mj = __reduce_max_sync(mask, k.m == m ? k.mj : -1);
    if (row_close(i, imax(beg, end), h1, m, mj, qlen, P, r)) break;
    row_shrink(fnz, h1 != 0 ? end : lnz, qlen, beg, end);
''')
VARIANTS = {"shipped": (), "prefetch": (PREFETCH,),
            "early_red": (EARLY_RED,), "both": (PREFETCH, EARLY_RED)}


def libraries():
    """{variant: ops.launch.Library} over the patched sources, built
    together; raises if a patch no longer applies."""
    from bwamem_tpu_torch._build import BUILD_DIR
    from bwamem_tpu_torch.ops import ext_kernel
    from bwamem_tpu_torch.ops.launch import Library
    src = open(ext_kernel.SRC).read()
    libs = {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name, patches in VARIANTS.items():
        text = src
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the patch does not "
                                   f"apply to csrc/ext_kernel.cu")
            text = text.replace(old, new)
        path = os.path.join(BUILD_DIR, f"ext_variant_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = Library("ext_kernel.cu", ext_kernel.LIB.entries)
        lib.src, lib.so_name = path, f"libext_variant_{name}.so"
        libs[name] = lib
    errors = []

    def build(lib):
        try:
            lib.load()
        except RuntimeError as e:
            errors.append(str(e))
    jobs = [threading.Thread(target=build, args=(lib,))
            for lib in libs.values()]
    for j in jobs:
        j.start()
    for j in jobs:
        j.join()
    if errors:
        raise RuntimeError("; ".join(errors))
    return libs


def shapes(dev):
    """(label, launch function, its lane arguments, its keywords, widest
    band) for each of the three shapes."""
    import numpy as np
    import torch
    import chip_smoke as cs
    from bwamem_tpu_torch.config import MemOptions
    from bwamem_tpu_torch.ops import ext_kernel
    opt = MemOptions()
    score = dict(mat_bytes=np.asarray(opt.mat, np.int8).tobytes(),
                 o_del=opt.o_del, e_del=opt.e_del, o_ins=opt.o_ins,
                 e_ins=opt.e_ins, zdrop=opt.zdrop)
    qT, tT, ql, tl, h0, eb = (torch.from_numpy(a).to(dev)
                              for a in cs.ext_lanes())
    out = [("ext_pl2, 16384 EXT-shaped lanes", ext_kernel.launch_pl2,
            (qT, ql, tT, tl, h0, eb),
            dict(lq_max=cs.LQ, t_max=cs.T_MAX, w_opt=opt.w, **score),
            2 * opt.w)]
    qT, tT, ql, tl, h0, eb = (torch.from_numpy(a).to(dev)
                              for a in cs.ext_lanes_long())
    w = torch.where(torch.arange(cs.LONG_LANES, device=dev) % 2 == 0,
                    opt.w, 2 * opt.w).to(torch.int32)
    out.append(("ext_pl, 1024 long lanes", ext_kernel.launch_pl,
                (qT, ql, tT, tl, h0, w, eb),
                dict(lq_max=cs.LONG_LQ, t_max=cs.LONG_T_MAX, **score),
                2 * opt.w))
    qT, tT, ql, tl, h0, eb = (torch.from_numpy(a).to(dev)
                              for a in cs.ext_lanes_ring())
    out.append(("ext_pl, 1024 ring-wrap lanes, band 10",
                ext_kernel.launch_pl,
                (qT, ql, tT, tl, h0, torch.full_like(ql, 10), eb),
                dict(lq_max=cs.RING_LQ, t_max=cs.RING_LQ + 64, **score), 10))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_ext_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from bwamem_tpu_torch.ops import ext_kernel
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    libs = libraries()
    shipped = ext_kernel.LIB
    order = ["shipped", "prefetch", "early_red", "both"]
    try:
        for label, launch, args, kw, w_max in shapes(torch.device("cuda")):
            p = ext_kernel.plan(kw["lq_max"], w_max)
            times, outs = {}, {}
            for name in order + order[::-1]:
                ext_kernel.LIB = libs[name]
                r = launch(*args, p, **kw)
                outs[name] = torch.stack(
                    list(r[0]) + [r[1]] if isinstance(r[0], tuple)
                    else list(r))
                times.setdefault(name, []).append(
                    cs.median_ms(lambda: launch(*args, p, **kw), reps=7))
            if not all(torch.equal(outs["shipped"], o)
                       for o in outs.values()):
                print(f"{label}: a variant's outputs differ",
                      file=sys.stderr)
                return 1
            print(f"{label} (G {p.group}, outputs equal): " + ", ".join(
                f"{n} {t[0]:.4f} / {t[1]:.4f} ms" for n, t in times.items()),
                flush=True)
    finally:
        ext_kernel.LIB = shipped
    return 0


if __name__ == "__main__":
    sys.exit(main())
