#!/usr/bin/env python3
"""Times the designs of kernels #4 (plp_row, bwamem_tpu_torch/csrc/
pl_probe_kernel.cu) and #8 (dp_eh, csrc/dispatch_probe_kernel.cu over
csrc/rows.cuh) against each other and against the designs they
replaced, on one NVIDIA GPU, in one process.

    python3 tools/torch_row_variants.py [--json PATH]

The calls, each built from the source text with the shipped nvcc flags:
  plp_row (B 2048, LQ 128: L1p 136, ROWS 128, the TPU script's defaults,
  on its input and on the "match" input of tools/torch_pl_probe.draw):
    noscan, noreduce, full  G in (8, 16, 32), the chunk in registers or in
                            shared memory (ops/pl_probe.plan), each with
                            DPX and without (the source patched, NO_DPX);
    roll                    a warp a lane with its rows in registers, or a
                            block with them in shared memory, with and
                            without DPX;
    eh_only                 rows a thread (1, 2, 4, 8, 16) x lanes a thread
                            (1, 4) x TILES (threads a block, lane groups a
                            block);
  dp_eh (qT [136, 2048], ROWS 8, 128, 512 and 2048, the inputs of
  tools/torch_dispatch_probe.make_inputs):
                            rows a thread x lanes a thread x 32 or 16x2
                            bits x threads a block x lane groups a block,
                            and some 32-bit plans with __viaddmax_s32
                            (the source patched, DP_DPX) and with 8
                            target rows loaded ahead (AHEAD);
  replaced                  the designs they replaced, kept here only as
                            source text (REPLACED_PL, REPLACED_DP): plp_row a
                            thread a lane with its state in shared memory
                            (roll a warp a lane), dp_eh a thread a cell.
Every call's output (plp_row's aux too) must equal the plain version
first (exit 1 otherwise), also on the match inputs at CHECK_SHAPES.
Then each input runs its calls in turns, in order and then in reverse,
ROUNDS rounds, each call timed on the device alone
(torch_pl_gather_probe2.device_ms: behind a 1 ms spin, the median of
REPS launches), and each number is the median of its rounds.  Prints the
card's name and power limit, ptxas's registers and spills for every
kernel of the built libraries (spilling kernels by name), the SASS
mnemonics of the shipped kernels (cuobjdump, where the toolkit has it),
then one line per call, fastest first within each kernel and input;
--json writes every number to PATH.  chip_smoke.py times only the
shipped plans.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

ROUNDS, REPS = 3, 3
PL_SHAPE = (2048, 128, 128)         # B, LQ, ROWS
# (threads a block, lane groups a block): a run of lanes each thread
# loading its own tT, or a tile of lanes by row groups staging tT in
# shared memory (csrc/rows.cuh)
TILES = ((128, 128), (256, 256), (128, 16), (256, 32), (512, 32), (512, 16))
# text patches of the shipped sources, each (old, new) or (file, old, new):
# 8 target rows loaded ahead; dp_eh's add-max as __viaddmax_s32; plp_row's
# add-maxes as plain max
AHEAD = ("#define ROWS_AHEAD 4 ", "#define ROWS_AHEAD 8 ")
# (L1p, B, ROWS) where every design is checked once more on the match
# inputs, besides the timed shapes: a tile of lanes cut short, B no
# multiple of 4, and L1p 21
CHECK_SHAPES = ((136, 2048, 2048), (104, 1000, 96), (104, 1001, 96),
                (21, 1000, 40))
DP_DPX = ("eh[k][l] = eh[k][l] + s > 0 ? eh[k][l] + s : 0;",
          "eh[k][l] = dpx_addmax(eh[k][l], s, 0);")
NO_DPX = [("pl_probe_kernel.cu", "return dpx_addmax(a, b, c);",
           "return imax(a + b, c);"),
          ("pl_probe_kernel.cu", "return dpx_addmax_relu(a, b, c);",
           "return imax(imax(a + b, c), 0);")]
# the shipped kernels at the probes' shapes, whose SASS mnemonics are
# printed (parts of their mangled names)
SHIPPED_SASS = ("plp_group_kernelILi32ELi5E", "plp_roll_warp_kernelILi5E",
                "rows_tile_kernelILi4ELi1E", "rows_kernelILi1ELi4ELi0E")
# the replaced designs, as they were (their host builds left out)
REPLACED_PL = r'''#include <limits.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PLP_HD __device__ __forceinline__
#define PLP_LDG(p) __ldg(p)
#else
#include <stdlib.h>
#define PLP_HD inline
#define PLP_LDG(p) (*(p))
#endif

#define PLP_NEG (-0x40000000)  // the TPU kernel's NEGc
enum { V_EH_ONLY = 0, V_NOSCAN = 1, V_NOREDUCE = 2, V_FULL = 3, V_ROLL = 4 };

struct Red {  // the reductions of one step
  int mj, h1, lst;
};

static PLP_HD int imax(int a, int b) { return a > b ? a : b; }

static PLP_HD int mq_of(int M, int q, int t) {
  return M != 0 ? M + (q == t ? 1 : -4) : 0;
}

static PLP_HD int enc(int h, int r) {
  return (int)(((uint32_t)h << 12) | (uint32_t)r);
}

struct Run {
  int G, prev, mj, h1, lst;
};

template <int V>
static PLP_HD void lane_row(int r, int qv, int M, int ev0, int t, int LQ,
                            int* hr, int* er, Run& run) {
  const int Mq = mq_of(M, qv, t);
  if (V == V_EH_ONLY) {
    *hr = Mq;
    return;
  }
  const int A = imax(Mq - 7, 0) + r;
  int F;
  if (V == V_NOSCAN) {
    F = A;
  } else {
    F = imax(run.G - r, 0);
    run.G = imax(run.G, A);
  }
  const int hv = imax(Mq, F);
  const int ev = imax(ev0 - 1, imax(Mq - 8, 0));
  *er = ev;
  if (V == V_FULL) {
    run.mj = imax(run.mj, enc(hv, r));
    run.h1 = r == LQ - 1 ? hv : run.h1;
    run.lst = hv != 0 || ev != 0 ? r : run.lst;
  }
  *hr = r == 0 ? hv : run.prev;
  run.prev = hv;
}

#define PLP_TILE 8

static PLP_HD void load_tile(const int* q, long long qs, const int* h,
                             const int* e, int s, int r0, int* qv, int* hv,
                             int* ev) {
#pragma unroll
  for (int k = 0; k < PLP_TILE; ++k) {
    qv[k] = PLP_LDG(q + (r0 + k) * qs);
    hv[k] = h[(r0 + k) * s];
    ev[k] = e[(r0 + k) * s];
  }
}

template <int V>
static PLP_HD void lane_step(const int* __restrict__ q, long long qs,
                             int* __restrict__ h, int* __restrict__ e, int s,
                             int L1p, int LQ, int t, Red* red) {
  Run run = {PLP_NEG, 0, INT_MIN, PLP_NEG, -1};
  const int whole = L1p / PLP_TILE * PLP_TILE;
  int qn[PLP_TILE], hn[PLP_TILE], en[PLP_TILE];
  if (whole > 0) load_tile(q, qs, h, e, s, 0, qn, hn, en);
  for (int r0 = 0; r0 < whole; r0 += PLP_TILE) {
    int qc[PLP_TILE], hc[PLP_TILE], ec[PLP_TILE];
#pragma unroll
    for (int k = 0; k < PLP_TILE; ++k) {
      qc[k] = qn[k];
      hc[k] = hn[k];
      ec[k] = en[k];
    }
    if (r0 + PLP_TILE < whole)
      load_tile(q, qs, h, e, s, r0 + PLP_TILE, qn, hn, en);
#pragma unroll
    for (int k = 0; k < PLP_TILE; ++k)
      lane_row<V>(r0 + k, qc[k], hc[k], ec[k], t, LQ, h + (r0 + k) * s,
                  e + (r0 + k) * s, run);
  }
  for (int r = whole; r < L1p; ++r)
    lane_row<V>(r, PLP_LDG(q + r * qs), h[r * s], e[r * s], t, LQ, h + r * s,
                e + r * s, run);
  if (V == V_FULL) *red = Red{run.mj, run.h1, run.lst};
}

static PLP_HD int chunk_amax(const int* q, const int* h, int r0, int r1,
                             int t) {
  int m = PLP_NEG;
  for (int r = r0; r < r1; ++r)
    m = imax(m, imax(mq_of(h[r], q[r], t) - 7, 0) + r);
  return m;
}

static PLP_HD int chunk_rows(const int* q, int* h, int* e, int r0, int r1,
                             int G, int LQ, int t, int* first, Red* red) {
  int prev = 0, mj = INT_MIN, h1 = PLP_NEG, lst = -1;
  *first = 0;
  for (int r = r0; r < r1; ++r) {
    const int Mq = mq_of(h[r], q[r], t);
    const int A = imax(Mq - 7, 0) + r;
    const int F = imax(G - r, 0);
    G = imax(G, A);
    const int hv = imax(Mq, F);
    const int ev = imax(e[r] - 1, imax(Mq - 8, 0));
    e[r] = ev;
    mj = imax(mj, enc(hv, r));
    if (r == LQ - 1) h1 = hv;
    if (hv != 0 || ev != 0) lst = r;
    if (r > r0)
      h[r] = prev;
    else
      *first = hv;
    prev = hv;
  }
  *red = Red{mj, h1, lst};
  return prev;
}

#ifdef __CUDACC__

template <int V>
__global__ void __launch_bounds__(32)
plp_lane_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
                int* __restrict__ out, int* __restrict__ aux, int L1p,
                int rows, int B, int LQ) {
  extern __shared__ int sm[];
  const int n = blockDim.x, l = threadIdx.x, b = blockIdx.x * n + l;
  if (b >= B) return;
  int* h = sm + l;                     // [row][lane]
  int* e = sm + (long long)L1p * n + l;
  for (int r = 0; r < L1p; ++r) {
    h[r * n] = r * 3 % 17;
    e[r * n] = 0;
  }
  Red red = {0, 0, 0};
  for (int i = 0; i < rows; ++i)
    lane_step<V>(qT + b, B, h, e, n, L1p, LQ,
                 __ldg(tT + (long long)i * B + b), &red);
  for (int r = 0; r < L1p; ++r) out[(long long)r * B + b] = h[r * n];
  aux[b] = red.mj;
  aux[B + b] = red.h1;
  aux[2 * B + b] = red.lst;
}

__global__ void __launch_bounds__(128)
plp_warp_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
                int* __restrict__ out, int* __restrict__ aux, int L1p,
                int rows, int B, int LQ) {
  extern __shared__ int sm[];
  const unsigned FULL = 0xffffffffu;
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;                  // the whole warp
  int* q = sm + (long long)w * 3 * L1p;
  int* h = q + L1p;
  int* e = h + L1p;
  for (int r = t; r < L1p; r += 32) {
    q[r] = qT[(long long)r * B + b];
    h[r] = r * 3 % 17;
    e[r] = 0;
  }
  __syncwarp();
  const int ch = (L1p + 31) / 32;
  const int r0 = t * ch < L1p ? t * ch : L1p;
  const int r1 = r0 + ch < L1p ? r0 + ch : L1p;
  Red red = {INT_MIN, PLP_NEG, -1};
  for (int i = 0; i < rows; ++i) {
    const int tb = __ldg(tT + (long long)i * B + b);
    int m = chunk_amax(q, h, r0, r1, tb);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, m, off);
      if (t >= off) m = imax(m, v);
    }
    int G = __shfl_up_sync(FULL, m, 1);
    if (t == 0) G = PLP_NEG;
    int first;
    Red pr;
    const int last = chunk_rows(q, h, e, r0, r1, G, LQ, tb, &first, &pr);
    const int up = __shfl_up_sync(FULL, last, 1);
    if (r0 < r1) h[r0] = t == 0 ? first : up;
    red.mj = __reduce_max_sync(FULL, pr.mj);
    red.h1 = __reduce_max_sync(FULL, pr.h1);
    red.lst = __reduce_max_sync(FULL, pr.lst);
  }
  __syncwarp();
  for (int r = t; r < L1p; r += 32) out[(long long)r * B + b] = h[r];
  if (t == 0) {
    aux[b] = red.mj;
    aux[B + b] = red.h1;
    aux[2 * B + b] = red.lst;
  }
}

static int smem_opt_in(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int V>
static int launch_lane(const int* qT, const int* tT, int* out, int* aux,
                       int L1p, int rows, int B, int LQ, int n, int smem,
                       cudaStream_t st) {
  const int rc = smem_opt_in((const void*)plp_lane_kernel<V>, smem);
  if (rc) return rc;
  plp_lane_kernel<V><<<(B + n - 1) / n, n, smem, st>>>(qT, tT, out, aux, L1p,
                                                       rows, B, LQ);
  return 0;
}

extern "C" int plp_row(const int* qT, const int* tT, int* out, int* aux,
                       int L1p, int rows, int B, int LQ, int variant, int n,
                       int smem, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (L1p <= 0 || B <= 0 || n <= 0) return (int)cudaGetLastError();
  int rc = 0;
  switch (variant) {
    case V_EH_ONLY:
      rc = launch_lane<V_EH_ONLY>(qT, tT, out, aux, L1p, rows, B, LQ, n, smem,
                                  st);
      break;
    case V_NOSCAN:
      rc = launch_lane<V_NOSCAN>(qT, tT, out, aux, L1p, rows, B, LQ, n, smem,
                                 st);
      break;
    case V_NOREDUCE:
      rc = launch_lane<V_NOREDUCE>(qT, tT, out, aux, L1p, rows, B, LQ, n,
                                   smem, st);
      break;
    case V_FULL:
      rc = launch_lane<V_FULL>(qT, tT, out, aux, L1p, rows, B, LQ, n, smem,
                               st);
      break;
    case V_ROLL:
      rc = smem_opt_in((const void*)plp_warp_kernel, smem);
      if (!rc)
        plp_warp_kernel<<<(B + n - 1) / n, 32 * n, smem, st>>>(
            qT, tT, out, aux, L1p, rows, B, LQ);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

#endif
'''
REPLACED_DP = r'''#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DP_HD __device__ __forceinline__
#define DP_LDG(p) __ldg(p)
#else
#define DP_HD inline
#define DP_LDG(p) (*(p))
#endif

static DP_HD int dp_cell(int q, const int* __restrict__ t, int B, int rows,
                         int eh) {
#ifdef __CUDACC__
#pragma unroll 4
#endif
  for (int i = 0; i < rows; ++i) {
    const int v = eh + (q == DP_LDG(t + (long long)i * B) ? 1 : -4);
    eh = v > 0 ? v : 0;
  }
  return eh;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(512)
dp_eh_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
             int* __restrict__ out, int L1p, int rows, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (b >= B || r >= L1p) return;
  const long long e = (long long)r * B + b;
  out[e] = dp_cell(__ldg(qT + e), tT + b, B, rows, r * 3 % 17);
}

extern "C" int dp_eh(const int* qT, const int* tT, int* out, int L1p,
                     int rows, int B, void* stream) {
  const dim3 block(128, 4);
  const dim3 grid((B + 127) / 128, (L1p + 3) / 4);
  if (L1p > 0 && B > 0)
    dp_eh_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(qT, tT, out, L1p,
                                                           rows, B);
  return (int)cudaGetLastError();
}

#endif
'''


def libraries() -> dict:
    """{name: ops.launch.Library}: the shipped libraries, plp_row's built
    again without DPX and dp_eh's with DPX and with 8 rows loaded ahead
    (the sources patched), and the replaced designs, the sources of the
    patched and the replaced ones written under build/row_variants/;
    built together, raises if a build fails or a patch no longer
    applies."""
    import ctypes
    from bwamem_tpu_torch._build import BUILD_DIR
    from bwamem_tpu_torch.ops import dispatch_probe as dp
    from bwamem_tpu_torch.ops import pl_probe as plp
    from bwamem_tpu_torch.ops.launch import CSRC, Library
    d = os.path.join(BUILD_DIR, "row_variants")
    os.makedirs(d, exist_ok=True)

    def write(path, text):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if not os.path.exists(path) or open(path).read() != text:
            with open(path, "w") as f:
                f.write(text)

    def replaced(name, text, entries):
        path = os.path.join(d, name)
        write(path, text)
        lib = Library(name, entries, ["-Xptxas", "-v"])
        lib.src = path
        lib.so_name = "librow_variants_" + name.replace(".cu", ".so")
        return lib

    def patched(name, lib, patches):
        """lib built from a copy of csrc/ under d/name with each (file,
        old, new) of patches applied; raises if an old text is not in
        its file once."""
        texts = {f: open(os.path.join(CSRC, f)).read() for f in
                 ("rows.cuh", "dpx.cuh", os.path.basename(lib.src))}
        for f, old, new in patches:
            if texts[f].count(old) != 1:
                raise RuntimeError(f"the {name} patch no longer applies to "
                                   f"csrc/{f}")
            texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            write(os.path.join(d, name, f), text)
        v = Library(os.path.basename(lib.src), lib.entries, lib.flags)
        v.src = os.path.join(d, name, os.path.basename(lib.src))
        v.so_name = f"librow_variants_{name}.so"
        return v
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = {
        "plp": plp.LIB, "dp": dp.LIB,
        "plp_nodpx": patched("plp_nodpx", plp.LIB, NO_DPX),
        "dp_dpx": patched("dp_dpx", dp.LIB, [("rows.cuh", *DP_DPX)]),
        "dp_ahead8": patched("dp_ahead8", dp.LIB, [("rows.cuh", *AHEAD)]),
        "plp_replaced": replaced("pl_probe_pr7.cu", REPLACED_PL,
                                 {"plp_row": [vp] * 4 + [ci] * 7}),
        "dp_replaced": replaced("dispatch_probe_pr7.cu", REPLACED_DP,
                                {"dp_eh": [vp] * 3 + [ci] * 3})}
    errors = []

    def build(lib):
        try:
            lib.load()
        except BaseException as e:          # reported after the join
            errors.append(str(e))
    threads = [threading.Thread(target=build, args=(lib,))
               for lib in libs.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def ptxas(lib) -> list:
    """[(kernel, registers, spill store bytes, spill load bytes)] from the
    library's nvcc -Xptxas -v log."""
    from bwamem_tpu_torch._build import BUILD_DIR
    rows, name, spill = [], None, (0, 0)
    for line in open(os.path.join(BUILD_DIR, lib.so_name + ".log")):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *spill))
            name, spill = None, (0, 0)
    return rows


def replaced_plan(variant: str, L1p: int) -> tuple:
    """The replaced wrapper's (n, shared bytes): lanes a block (a thread a
    lane, eh_h and eh_e in shared memory) or, for roll, warps a block (qT,
    eh_h and eh_e)."""
    from bwamem_tpu_torch.ops import pl_probe as plp
    words, top = (3, 4) if variant == "roll" else (2, 32)
    per = words * L1p * 4
    n = min(top, plp.SMEM_MAX // per)
    return n, n * per


def plp_call(lib, qT, tT, variant, LQ, p=None):
    """One launch of lib's plp_row at plan p (ops/pl_probe.Plan), or, p
    None, at the replaced wrapper's plan; returns (out, aux)."""
    import torch
    from bwamem_tpu_torch.ops import pl_probe as plp
    L1p, B = qT.shape
    out = torch.empty_like(qT)
    aux = torch.empty((3, B), dtype=torch.int32, device=qT.device)
    tail = tuple(p) if p is not None else replaced_plan(variant, L1p)
    lib.launch("plp_row", qT.get_device(),
               (qT.data_ptr(), tT.data_ptr(), out.data_ptr(), aux.data_ptr(),
                L1p, tT.shape[0], B, LQ, plp.VARIANTS.index(variant), *tail))
    return out, aux


def dp_call(lib, qT, tT, p=None):
    """One launch of lib's dp_eh at plan p (ops/dispatch_probe.Plan), or, p
    None, the replaced entry; returns out."""
    import torch
    out = torch.empty_like(qT)
    tail = tuple(p) if p is not None else ()
    lib.launch("dp_eh", qT.get_device(),
               (qT.data_ptr(), tT.data_ptr(), out.data_ptr(), qT.shape[0],
                tT.shape[0], qT.shape[1], *tail))
    return out


def plp_calls(libs, qT, tT, LQ) -> dict:
    """{(variant, design): a call} of every plp_row design at this shape."""
    from bwamem_tpu_torch.ops import pl_probe as plp
    L1p, B = qT.shape
    calls = {}
    for v in plp.VARIANTS:
        calls[(v, "replaced")] = (
            lambda v=v: plp_call(libs["plp_replaced"], qT, tT, v, LQ))
        if v == "eh_only":
            for rpt in (1, 2, 4, 8, 16):
                for lpt in (1, 4):
                    for th, lgb in TILES:
                        p = plp.Plan(rpt, lpt, th, lgb)
                        try:
                            plp.check_plan(v, p, L1p, B)
                        except ValueError:  # a tile too wide to stage,
                            continue        # or B % lpt != 0
                        calls[(v, f"rpt {rpt} lpt {lpt} threads {th} lgb "
                                  f"{lgb}")] = (
                            lambda p=p: plp_call(libs["plp"], qT, tT,
                                                 "eh_only", LQ, p))
            continue
        for G in ((None,) if v == "roll" else plp.GROUPS):
            for st in plp.STORAGE:
                try:
                    p = plp.plan(v, L1p, B, G=G, storage=st)
                except ValueError:
                    continue
                for lib, dpx in (("plp", "dpx"), ("plp_nodpx", "no dpx")):
                    label = (f"{st} {dpx}" if G is None
                             else f"G {G} {st} {dpx}")
                    calls[(v, label)] = (lambda lib=lib, v=v, p=p: plp_call(
                        libs[lib], qT, tT, v, LQ, p))
    return calls


def dp_calls(libs, qT, tT) -> dict:
    """{design: a call} of every dp_eh design on one input."""
    from bwamem_tpu_torch.ops import dispatch_probe as dp
    calls = {"replaced": lambda: dp_call(libs["dp_replaced"], qT, tT)}

    def add(name, p, tag=""):
        try:
            dp.check_plan(p, tT.shape[0], qT.shape[1])
        except ValueError:          # a tile too wide for its staging
            return
        label = (f"rpt {p.rpt} lpt {p.lpt} bits {p.bits} threads "
                 f"{p.threads} lgb {p.lgb}{tag}")
        calls[label] = lambda: dp_call(libs[name], qT, tT, p)
    for bits in dp.BITS:
        for rpt in dp.RPTS:
            if bits == 16 and rpt < 2:
                continue
            for lpt in dp.LPTS:
                for th, lgb in TILES:
                    if bits == 32 or (th, lgb) in ((128, 128), (256, 32)):
                        add("dp", dp.Plan(rpt, lpt, bits, th, lgb))
    for rpt in (2, 4, 8):
        for lpt in dp.LPTS:
            add("dp_dpx", dp.Plan(rpt, lpt, 32, 128, 128), " dpx")
            add("dp_dpx", dp.Plan(rpt, lpt, 32, 256, 32), " dpx")
            add("dp_ahead8", dp.Plan(rpt, lpt, 32, 128, 128), " ahead 8")
    return calls


def check(calls: dict, want, what: str) -> None:
    """RuntimeError unless every call's output equals want."""
    import torch
    for key, fn in calls.items():
        got = fn()
        torch.cuda.synchronize()
        gots = got if isinstance(got, tuple) else (got,)
        wants = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(g, w) for g, w in zip(gots, wants)):
            raise RuntimeError(f"{what} {key}: differs from the plain "
                               f"version")


def in_turns(calls: dict, rounds: int = ROUNDS) -> dict:
    """{key: device_ms, the median of `rounds` rounds taken in turns}."""
    from torch_pl_gather_probe2 import device_ms
    runs = {k: [] for k in calls}
    order = list(calls)
    for i in range(rounds):
        for k in (order if i % 2 == 0 else order[::-1]):
            runs[k].append(device_ms(calls[k], REPS))
    return {k: sorted(v)[len(v) // 2] for k, v in runs.items()}


def sweep(libs: dict, log=print) -> dict:
    """Checks and times every call as the module says; returns {"plp":
    {input: {variant: {design: device_ms}}}, "dp": {ROWS: {design:
    device_ms}}}."""
    import torch
    import torch_dispatch_probe as dprobe
    import torch_pl_probe as pprobe
    from bwamem_tpu_torch.ops import dispatch_probe as dp
    from bwamem_tpu_torch.ops import pl_probe as plp
    dev = torch.device("cuda")
    B, LQ, R = PL_SHAPE
    res = {"plp": {}, "dp": {}}
    for kind in ("probe", "match"):
        qT, tT = pprobe.make_inputs(0, B, LQ, R, dev, kind)
        calls = plp_calls(libs, qT, tT, LQ)
        for v in plp.VARIANTS:
            check({k: c for k, c in calls.items() if k[0] == v},
                  plp.plp_plain(qT, tT, v, LQ), f"plp_row {kind}")
        log(f"row variants: {len(calls)} plp_row calls on the {kind} input "
            f"equal their plain versions, out and aux")
        times = in_turns(calls)
        res["plp"][kind] = {}
        for v in plp.VARIANTS:
            mine = {k[1]: t for k, t in times.items() if k[0] == v}
            res["plp"][kind][v] = mine
            for d, t in sorted(mine.items(), key=lambda x: x[1]):
                log(f"plp_row {kind} {v:9s} {d:32s} device {t:.5f} ms")
    # every design also on inputs where states climb (dp_eh) or grow
    # (plp_row), so that out depends on every target row, at shapes whose
    # lanes fill no whole tile or are no multiple of 4
    for i, (L1p, b, rows) in enumerate(CHECK_SHAPES):
        qm, tm = (torch.from_numpy(a).to(dev) for a in dprobe.draw(
            i, L1p, b, rows, "match"))
        calls = dp_calls(libs, qm, tm)
        check(calls, dp.dp_eh_plain(qm, tm), f"dp_eh match {L1p}x{b}x{rows}")
        qm, tm = (torch.from_numpy(a).to(dev) for a in pprobe.draw(
            i, L1p, b, rows, "match"))
        LQ = L1p - 3
        calls_pl = plp_calls(libs, qm, tm, LQ)
        for v in plp.VARIANTS:
            check({k: c for k, c in calls_pl.items() if k[0] == v},
                  plp.plp_plain(qm, tm, v, LQ),
                  f"plp_row match {L1p}x{b}x{rows}")
        log(f"row variants: {len(calls)} dp_eh and {len(calls_pl)} plp_row "
            f"calls on the match inputs at (L1p, B, ROWS) ({L1p}, {b}, "
            f"{rows}) equal their plain versions")
    for rows, (qT, tT) in dprobe.make_inputs(0, dev)["rows"].items():
        calls = dp_calls(libs, qT, tT)
        check(calls, dp.dp_eh_plain(qT, tT), f"dp_eh ROWS {rows}")
        log(f"row variants: {len(calls)} dp_eh calls at ROWS {rows} equal "
            f"the plain version")
        times = in_turns(calls)
        res["dp"][rows] = times
        for d, t in sorted(times.items(), key=lambda x: x[1]):
            log(f"dp_eh ROWS {rows:5d} {d:40s} device {t:.5f} ms")
    return res


def main() -> int:
    import torch
    from bwamem_tpu_torch._build import BUILD_DIR
    if not torch.cuda.is_available():
        print("torch_row_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    libs = libraries()
    regs = {}
    for name, lib in libs.items():
        rows = ptxas(lib)
        regs[name] = rows
        spills = [r for r in rows if r[2] or r[3]]
        print(f"ptxas {name}: {len(rows)} kernels, registers "
              f"{min(r[1] for r in rows)}-{max(r[1] for r in rows)}, "
              f"{len(spills)} spill", flush=True)
        for r in spills:
            print(f"ptxas {name} spills: {r[0]} {r[1]} registers, {r[2]} "
                  f"bytes spill stores, {r[3]} loads", flush=True)
    from torch_int_rate import sass_counts
    sass = {}
    for name in ("plp", "dp"):
        for fn, counts in sass_counts(os.path.join(
                BUILD_DIR, libs[name].so_name)).items():
            if any(k in fn for k in SHIPPED_SASS):
                sass[fn] = dict(counts)
                print(f"sass {fn}: {sum(counts.values())} instructions; "
                      + ", ".join(f"{k} {v}" for k, v in
                                  counts.most_common(14)), flush=True)
    try:
        res = sweep(libs, lambda m: print(m, flush=True))
    except RuntimeError as e:
        print(f"torch_row_variants: {e}", file=sys.stderr)
        return 1
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(card=card, ptxas=regs, sass=sass, times=res), f,
                      indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
