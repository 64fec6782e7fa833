#!/usr/bin/env python3
"""Times the designs of kernel 7B (gp3_ct, bwamem_tpu_torch/csrc/
gather_probe3_kernel.cu: 512 steps of kk[i, j] <- clip(m + tab[m, kk[m, i]],
0, N - 1), m = kk[i, j], on [128, 128]) against each other, against the
design they replaced and against the chain issued from PyTorch, on one
NVIDIA GPU, in one process.

    python3 tools/torch_ct_variants.py [--json PATH]

Inputs at N = 128 from ops/gather_probe3.ct_inputs (seeds SEEDS):
"probe", a table drawn as the TPU script draws it, on which every chain
sits at 127 after one step, and "spread", on which chains keep moving
(the gathers then spread over the banks), both timed; "wrap", where
every add wraps in int32, checked only.  Every design keeps the state in
registers and takes T = clip(m + tab[m, c], 0, N - 1) once a launch.
The calls:
  shipped       ops/gather_probe3.gp3_ct, at N = 128 the cluster of 16
                blocks of 512 threads, each its rows and its own T,
                reading kk[m, i] from the owner of row m by
                ld.shared::cluster, a step ended by a block barrier, one
                fence.acq_rel.cluster a block (warp 0's) and the cluster
                barrier with a relaxed arrive;
  block         the one block of 1024 threads the wrapper takes at any
                other N (N at run time), here at N = 128;
  block_n128    the same with N at compile time (N128, a patch);
  cluster       the shipped cluster kernel at every (blocks, threads) of
                CLUSTER_PLANS;
  rel0          the same, warp 0's arrive a release in place of its fence
                (REL0, a patch);
  release       the same, each step ended by the cluster barrier with a
                release on every warp's arrive (RELEASE, a patch);
  relaxed       the same with the fence taken out, a relaxed arrive after
                the block barrier and nothing else (RELAXED, a patch): the
                PTX memory model then orders no block's shared stores
                before another block's loads, so it is timed, and checked,
                but not shipped;
  mbar          the same rows, each step ended by an exchange of mbarrier
                arrivals (EXTRAS: ct_mbar_kernel);
  push          each new state stored to the block whose gathers read it
                (st.async counted on that block's mbarrier; three buffers)
                (EXTRAS: ct_push_kernel);
  copy          a 16-bit replica of the state in every block, each block's
                rows sent to every other by one bulk copy a step (three
                buffers) (EXTRAS: ct_copy_kernel);
  no_table      the clip taken each step (T holds tab) at NO_TABLE_CALLS
                (NO_TABLE, a patch);
  empty         every one of these with the step's work taken out and its
                synchronisation kept (EMPTY, patches): for block and the
                pulls the body (its barriers alone: the floor of its
                synchronisation); for push and copy the gathers, so that
                each step sends the unchanged state (their stores and
                copies are how they synchronise);
  replaced      the design the shipped one replaced (REPLACED: one block of
                1024 threads, tab and two states in shared memory, each
                thread a column of 16 elements in a loop over the runtime
                N, three dependent shared loads an element), through the
                wrapper's checks and an allocation; and its empty step;
  library       the 512-step chain of torch.gather, .t(), add and clamp
                issued from PyTorch (tools/torch_pl_gather_probe3.torch_ct).
Each library is EXTRAS (which includes the shipped source) over a copy of
csrc/ with that library's patches, built with the shipped nvcc flags and
-Xptxas -v into build/ct_variants/, all builds started together.  Every
call's output must equal the plain version first
(ops/gather_probe3.ct_plain; an empty step's output, its input) on the
probe, spread and wrap inputs, and the shipped call at N = 1, 33 and 139
(the one block) after 0, 1 and 512 steps (exit 1 otherwise).  Then each input
runs the calls in turns, in order and then in reverse, ROUNDS rounds,
each call timed on the device alone (behind a spin of the card longer
than its issue: `device_ms`, the median of REPS) and between two events
(`ms`), and each number is the median of its rounds.  Prints the card's
name and power limit, ptxas's registers and spills for every gp3_ct
kernel built, then one line per call and input, fastest first; --json
writes every number to PATH.  chip_smoke.py times only the shipped call
and the replaced design (compare with the libraries of ("replaced",)).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

N, STEPS = 128, 512
SEEDS = {"probe": 0, "spread": 9, "wrap": 11}
ROUNDS, REPS = 6, 3
SPIN_CYCLES = 2_000_000         # about 1 ms of the card's clock
LIB_SPIN_CYCLES = 120_000_000   # about 60 ms: longer than the chain's issue
CHECK_N = (1, 33, 139)          # the shipped call also at these N
# (blocks, threads) of the cluster designs: EXTRAS' CT_CLUSTER_PLANS
CLUSTER_PLANS = ((2, 512), (2, 1024), (4, 128), (4, 256), (4, 512),
                 (4, 1024), (8, 128), (8, 256), (8, 512), (8, 1024),
                 (16, 128), (16, 256), (16, 512), (16, 1024))
# ct_variant's designs
DESIGNS = {"block": 0, "cluster": 1, "mbar": 2, "push": 3, "copy": 4}
NO_TABLE_CALLS = (("block", 1, 1024), ("cluster", 16, 512),
                  ("push", 16, 512), ("copy", 16, 256))
SHIPPED = "gather_probe3_kernel.cu"
EXTRAS_NAME = "ct_variants.cu"
# text patches, each (file, old, new) or (file, old, new, count): old once
# (or count times) in its file
BLOCK_STEP = "int (&v)[K], const int (&at)[K], int N) {\n"
CLUSTER_STEP = "    int (&v)[K], const int (&at)[K]) {\n"
PUSH_STEP = ("      v[k] = xt_apply(v[k], t[v[k] * N + c[k]]);\n"
             "      if (mine[k])\n")
COPY_STEP = ("      v[k] = xt_apply(v[k], t[v[k] * N + c[k]]);\n"
             "      nxt[at[k] & 0xffff] = (unsigned short)v[k];\n")
EMPTY = [(SHIPPED, BLOCK_STEP, BLOCK_STEP + "  return;\n"),
         (SHIPPED, CLUSTER_STEP, CLUSTER_STEP + "  return;\n"),
         (EXTRAS_NAME, PUSH_STEP, "      if (mine[k])\n"),
         (EXTRAS_NAME, COPY_STEP,
          "      nxt[at[k] & 0xffff] = (unsigned short)v[k];\n")]
FENCE = ('  if (threadIdx.x < 32) asm volatile("fence.acq_rel.cluster;" ::: '
         '"memory");\n')
RELAXED_ARRIVE = ('  asm volatile(\n'
                  '      "barrier.cluster.arrive.relaxed.aligned;\\n\\t"\n')
RELAXED = [(SHIPPED, FENCE, "")]
REL0 = [(SHIPPED, FENCE + RELAXED_ARRIVE,
         '  if (threadIdx.x < 32)\n'
         '    asm volatile("barrier.cluster.arrive.release.aligned;" ::: '
         '"memory");\n'
         '  else\n'
         '    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: '
         '"memory");\n'
         '  asm volatile(\n')]
RELEASE = [(SHIPPED, "    cluster_sync_shared();\n  }\n",
            "    cluster_sync();\n  }\n")]
N128 = [(SHIPPED, "K = (CT_N_MAX * CT_N_MAX + P - 1) / P;",
         "K = CT_N * CT_N / P;"),
        (SHIPPED, "const int N = n_rt, n2", "const int N = CT_N, n2")]
NO_TABLE = [(SHIPPED, "    t[e] = clip_step(e / N, __ldg(tab + e), N);\n",
             "    t[e] = __ldg(tab + e);\n", 2),
            (SHIPPED, "        v[k0 + k] = t[v[k0 + k] * N + c[k]];\n",
             "        v[k0 + k] = clip_step(v[k0 + k], t[v[k0 + k] * N + "
             "c[k]], N);\n"),
            (SHIPPED, "    v[k] = t[v[k] * N + c[k]];\n",
             "    v[k] = clip_step(v[k], t[v[k] * N + c[k]], N);\n"),
            (EXTRAS_NAME, "  return clip_step(m, g, CT_N);\n",
             "  return g;\n"),
            (EXTRAS_NAME, "{ return w; }",
             "{ return clip_step(m, w, CT_N); }")]
# the libraries over EXTRAS and their patches
PATCHED = {"variants": [], "no_table": NO_TABLE, "empty": EMPTY,
           "n128": N128, "n128_empty": N128 + EMPTY,
           "rel0": REL0, "rel0_empty": REL0 + EMPTY,
           "release": RELEASE, "release_empty": RELEASE + EMPTY,
           "relaxed": RELAXED, "relaxed_empty": RELAXED + EMPTY}
# the design each patched library times at N = 128 ("" every design), and
# its label
LIB_DESIGNS = {"n128": ("block", "block_n128"),
               "rel0": ("cluster", "rel0"), "release": ("cluster", "release"),
               "relaxed": ("cluster", "relaxed")}
# gp3_ct's other designs, over the shipped source (included)
EXTRAS = r'''
// gp3_ct's designs weighed beside the shipped ones, which the included
// source holds (ct_block_kernel, ct_cluster_kernel): design 0 the block
// at N = 128, 1 the shipped cluster at other sizes, 2 its pull ended by
// an mbarrier exchange, 3 the push (each new state stored to the block
// that reads it, st.async counted on its mbarrier), 4 the copy (a 16-bit
// replica a block, rows sent by bulk copies).
#include "gather_probe3_kernel.cu"

// these designs' T word for row m and tab's word g, and the next state
// of an element in state m whose gather read T's word w (the no_table
// patch moves the clip from the one to the other)
static __device__ __forceinline__ int xt_entry(int m, int g) {
  return clip_step(m, g, CT_N);
}
static __device__ __forceinline__ int xt_apply(int m, int w) { return w; }

static __device__ __forceinline__ unsigned mapa(unsigned addr,
                                                unsigned rank) {
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}

static __device__ __forceinline__ void mbar_init(unsigned bar,
                                                 unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}

// one arrival on the mbarrier at bar, which then waits for `bytes` more
static __device__ __forceinline__ void mbar_expect(unsigned bar,
                                                   unsigned bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;"
               : "=l"(state) : "r"(bar), "r"(bytes) : "memory");
}

// waits for the phase of parity `parity` of the mbarrier at bar to
// complete, acquiring what the cluster's stores released into it; traps
// (a launch failure, not a hang) past about a second
static __device__ __forceinline__ void mbar_wait(unsigned bar,
                                                 unsigned parity) {
  for (unsigned n = 0;; ++n) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n > (1u << 22)) __trap();
  }
}

// one arrival, releasing this thread's (and, through a block barrier
// before it, its block's) stores at cluster scope, on the mbarrier at the
// cluster address bar
static __device__ __forceinline__ void mbar_arrive_cluster(unsigned bar) {
  asm volatile(
      "fence.acq_rel.cluster;\n\t"
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
      :: "r"(bar) : "memory");
}

// A cluster as ct_cluster_kernel, a step ended by an exchange of
// mbarrier arrivals in place of the cluster barrier: a block barrier, one
// arrival of each block on each block's mbarrier of the step's parity
// (threads 0..CS-1 each arrive on one block's, with a cluster-scope
// release) and a wait on this block's.  Two mbarriers alternate, so a
// block a step ahead never arrives in the phase another still waits on.
template <int CS, int P>
__global__ void __launch_bounds__(P)
ct_mbar_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
               int* __restrict__ out, int steps) {
  constexpr int N = CT_N, RB = N / CS, K = RB * N / P;
  __shared__ unsigned long long bars[2];
  extern __shared__ int sm[];
  int* t = sm;
  int* buf0 = t + N * N;
  int* buf1 = buf0 + RB * N;
  const int row0 = (int)cluster_rank() * RB;
  for (int e = threadIdx.x; e < N * N; e += P)
    t[e] = xt_entry(e / N, __ldg(tab + e));
  for (int e = threadIdx.x; e < RB * N; e += P)
    buf0[e] = __ldg(kk0 + row0 * N + e);
  int v[K], at[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int i, j;
    ct_place(threadIdx.x + k * P, row0, RB, N, i, j);
    at[k] = i << 16 | ((i - row0) * N + j);
    v[k] = __ldg(kk0 + i * N + j);
  }
  const unsigned bar0 = (unsigned)__cvta_generic_to_shared(bars);
  if (threadIdx.x == 0) {
    mbar_init(bar0, CS);
    mbar_init(bar0 + 8, CS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const unsigned peer = threadIdx.x < CS ? mapa(bar0, threadIdx.x) : 0u;
  cluster_sync();
  const unsigned a0 = (unsigned)__cvta_generic_to_shared(buf0);
  const unsigned a1 = (unsigned)__cvta_generic_to_shared(buf1);
  for (int s = 0; s < steps; ++s) {
    if (s & 1)
      ct_cluster_step<RB, K>(t, a1, buf0, v, at);
    else
      ct_cluster_step<RB, K>(t, a0, buf1, v, at);
    __syncthreads();
    if (threadIdx.x < CS) mbar_arrive_cluster(peer + 8u * (s & 1));
    mbar_wait(bar0 + 8u * (s & 1), (unsigned)(s >> 1) & 1u);
  }
  cluster_sync();
#pragma unroll
  for (int k = 0; k < K; ++k) out[row0 * N + (at[k] & 0xffff)] = v[k];
}

// v stored at the cluster shared-memory address addr, its 4 bytes
// counted on the mbarrier at cluster address bar (the same block's)
static __device__ __forceinline__ void st_async(unsigned addr, int v,
                                                unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" :: "r"(addr), "r"(v), "r"(bar) : "memory");
}

// A cluster of CS blocks of P threads at N = CT_N that pushes: block r
// computes the RB = N / CS rows from r * RB, as ct_cluster_kernel, and
// keeps columns r * RB.. of the state (what its gathers kk[m, i] read) in
// three buffers, kk[m, row0 + c] at m * RB + c.  An element's new state
// goes to the block that owns its column: st.async into that block's
// buffer of the step, counted on that block's mbarrier of the buffer (a
// plain store where that block is this one).  A step: the gathers from
// the buffer of the step before, the stores, a block barrier (so no
// thread runs a step ahead of its block, which three buffers need), and a
// wait on this step's mbarrier for the (N - RB) * RB words of the others.
template <int CS, int P>
__global__ void __launch_bounds__(P)
ct_push_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
               int* __restrict__ out, int steps) {
  constexpr int N = CT_N, RB = N / CS, K = RB * N / P, COLS = N * RB;
  constexpr unsigned BYTES = (N - RB) * RB * 4;
  __shared__ unsigned long long bars[3];
  extern __shared__ int sm[];
  int* t = sm;
  int* col = t + N * N;
  const unsigned rank = cluster_rank();
  const int row0 = (int)rank * RB;
  for (int e = threadIdx.x; e < N * N; e += P)
    t[e] = xt_entry(e / N, __ldg(tab + e));
  for (int e = threadIdx.x; e < COLS; e += P)
    col[e] = __ldg(kk0 + (e / RB) * N + row0 + e % RB);
  const unsigned bar0 = (unsigned)__cvta_generic_to_shared(bars);
  const unsigned col0 = (unsigned)__cvta_generic_to_shared(col);
  if (threadIdx.x == 0) {
    for (int x = 0; x < 3; ++x) mbar_init(bar0 + 8 * x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 1; s <= 3 && s <= steps; ++s)
      mbar_expect(bar0 + 8 * (s % 3), BYTES);
  }
  // v: the state; at: the gather's column (i - row0) << 16 | i * N + j;
  // mine: the column is this block's; dst: the element's word in the
  // owner's buffer 0 (a cluster address, or an index where mine), dbar:
  // the owner's mbarrier 0
  int v[K], at[K];
  bool mine[K];
  unsigned dst[K], dbar[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int i, j;
    ct_place(threadIdx.x + k * P, row0, RB, N, i, j);
    v[k] = __ldg(kk0 + i * N + j);
    at[k] = (i - row0) << 16 | (i * N + j);
    const unsigned owner = j / RB, w = i * RB + j % RB;
    mine[k] = owner == rank;
    dst[k] = mine[k] ? w : mapa(col0 + 4u * w, owner);
    dbar[k] = mapa(bar0, owner);
  }
  cluster_sync();            // every block's buffers and mbarriers ready
  for (int s = 1; s <= steps; ++s) {
    const int x = s % 3;
    const int* cur = col + (s + 2) % 3 * COLS;
    int c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = cur[v[k] * RB + (at[k] >> 16)];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = xt_apply(v[k], t[v[k] * N + c[k]]);
      if (mine[k])
        col[dst[k] + x * COLS] = v[k];
      else
        st_async(dst[k] + 4u * x * COLS, v[k], dbar[k] + 8u * x);
    }
    __syncthreads();
    mbar_wait(bar0 + 8 * x, (unsigned)((s - 1) / 3) & 1u);
    if (threadIdx.x == 0 && s + 3 <= steps) mbar_expect(bar0 + 8 * x, BYTES);
  }
  cluster_sync();            // no block leaves while stores into it fly
#pragma unroll
  for (int k = 0; k < K; ++k) out[at[k] & 0xffff] = v[k];
}

// bytes from this block's shared memory at src to the cluster address
// dst (both 16-byte aligned, bytes a multiple of 16), counted on the
// mbarrier at cluster address bar, by the copy engine
static __device__ __forceinline__ void bulk_to_cluster(unsigned dst,
                                                       unsigned src,
                                                       unsigned bytes,
                                                       unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}

// A cluster of CS blocks of P threads at N = CT_N in which every block
// keeps the whole state, in 16 bits, in three buffers: block r computes
// the RB = N / CS rows from r * RB (its gathers all local), writes them
// into its own buffer of the step, and one bulk copy a peer sends those
// rows into the peer's buffer of the step, counted on the peer's
// mbarrier of that buffer.  A step: the gathers, the stores, a proxy
// fence and a block barrier, the copies, a wait for the (N - RB) rows of
// the others.
template <int CS, int P>
__global__ void __launch_bounds__(P)
ct_copy_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
               int* __restrict__ out, int steps) {
  constexpr int N = CT_N, RB = N / CS, K = RB * N / P, N2 = N * N;
  constexpr unsigned SLICE = RB * N * 2, BYTES = (N - RB) * N * 2;
  __shared__ unsigned long long bars[3];
  extern __shared__ __align__(16) int sm[];
  int* t = sm;
  unsigned short* rep = reinterpret_cast<unsigned short*>(t + N2);
  const unsigned rank = cluster_rank();
  const int row0 = (int)rank * RB;
  for (int e = threadIdx.x; e < N2; e += P) {
    t[e] = xt_entry(e / N, __ldg(tab + e));
    rep[e] = (unsigned short)__ldg(kk0 + e);
  }
  const unsigned bar0 = (unsigned)__cvta_generic_to_shared(bars);
  const unsigned rep0 = (unsigned)__cvta_generic_to_shared(rep);
  if (threadIdx.x == 0) {
    for (int x = 0; x < 3; ++x) mbar_init(bar0 + 8 * x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int s = 1; s <= 3 && s <= steps; ++s)
      mbar_expect(bar0 + 8 * (s % 3), BYTES);
  }
  const bool sender = threadIdx.x < CS && threadIdx.x != rank;
  const unsigned slice = rep0 + 2u * row0 * N;
  const unsigned pdst = sender ? mapa(slice, threadIdx.x) : 0u;
  const unsigned pbar = sender ? mapa(bar0, threadIdx.x) : 0u;
  int v[K], at[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int i, j;
    ct_place(threadIdx.x + k * P, row0, RB, N, i, j);
    at[k] = i << 16 | (i * N + j);
    v[k] = __ldg(kk0 + i * N + j);
  }
  cluster_sync();            // every block's buffers and mbarriers ready
  for (int s = 1; s <= steps; ++s) {
    const int x = s % 3;
    const unsigned short* cur = rep + (s + 2) % 3 * N2;
    unsigned short* nxt = rep + x * N2;
    int c[K];
#pragma unroll
    for (int k = 0; k < K; ++k) c[k] = cur[v[k] * N + (at[k] >> 16)];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = xt_apply(v[k], t[v[k] * N + c[k]]);
      nxt[at[k] & 0xffff] = (unsigned short)v[k];
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (sender)
      bulk_to_cluster(pdst + 2u * x * N2, slice + 2u * x * N2, SLICE,
                      pbar + 8u * x);
    mbar_wait(bar0 + 8 * x, (unsigned)((s - 1) / 3) & 1u);
    if (threadIdx.x == 0 && s + 3 <= steps) mbar_expect(bar0 + 8 * x, BYTES);
  }
  cluster_sync();            // no block leaves while copies into it fly
#pragma unroll
  for (int k = 0; k < K; ++k) out[at[k] & 0xffff] = v[k];
}

// the (blocks, threads) the cluster designs are timed at
#define CT_CLUSTER_PLANS(X)                                              \
  X(2, 512) X(2, 1024) X(4, 128) X(4, 256) X(4, 512) X(4, 1024) X(8, 128) \
  X(8, 256) X(8, 512) X(8, 1024) X(16, 128) X(16, 256) X(16, 512)        \
  X(16, 1024)

template <int CS, int P>
static int ct_variant_cluster(int design, const int* tab, const int* kk0,
                              int* out, int steps, cudaStream_t st) {
  const size_t n2 = (size_t)CT_N * CT_N;
  switch (design) {
    case 1:
      return ct_cluster_launch(ct_cluster_kernel<CS, P>, CS, P,
                               ct_cluster_smem(CS), tab, kk0, out, steps,
                               st);
    case 2:
      return ct_cluster_launch(ct_mbar_kernel<CS, P>, CS, P,
                               ct_cluster_smem(CS), tab, kk0, out, steps,
                               st);
    case 3:
      return ct_cluster_launch(ct_push_kernel<CS, P>, CS, P,
                               (n2 + 3 * n2 / CS) * sizeof(int), tab, kk0,
                               out, steps, st);
    case 4:
      return ct_cluster_launch(ct_copy_kernel<CS, P>, CS, P,
                               n2 * sizeof(int) + 3 * n2 * 2, tab, kk0, out,
                               steps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// at N = CT_N: design 0, the shipped one block of 1024 threads; 1, the
// shipped cluster kernel; 2, ct_mbar_kernel; 3, ct_push_kernel; 4,
// ct_copy_kernel, each at the plans of CT_CLUSTER_PLANS
extern "C" int ct_variant(const int* tab, const int* kk0, int* out, int N,
                          int steps, int design, int blocks, int threads,
                          void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N != CT_N) return (int)cudaErrorInvalidValue;
  if (design == 0 && blocks == 1 && threads == 1024)
    return ct_block_launch(tab, kk0, out, N, steps, st);
  switch (blocks * 10000 + threads) {
#define CT_CASE(CS, P) \
  case CS * 10000 + P: \
    return ct_variant_cluster<CS, P>(design, tab, kk0, out, steps, st);
    CT_CLUSTER_PLANS(CT_CASE)
#undef CT_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
'''
# the kernel and C entry the shipped design replaced (gp3_ct_kernel), as
# it was
REPLACED = r'''#include <cuda_runtime.h>
#include <stdint.h>

static __device__ inline int clip_step(int k, int g, int hi) {
  const int v = (int)((uint32_t)k + (uint32_t)g);
  return v < 0 ? 0 : (v > hi - 1 ? hi - 1 : v);
}

static __device__ inline int ct_next(const int* tab, const int* kk, int i,
                                     int j, int N) {
  const int m = kk[i * N + j];
  return clip_step(m, tab[m * N + kk[m * N + i]], N);
}

__global__ void __launch_bounds__(1024)
gp3_ct_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
              int* __restrict__ out, int N, int steps) {
  extern __shared__ int sm[];
  const int n2 = N * N;
  int* t = sm;
  int* cur = sm + n2;
  int* nxt = sm + 2 * n2;
  for (int e = threadIdx.x; e < n2; e += blockDim.x) {
    t[e] = tab[e];
    cur[e] = kk0[e];
  }
  __syncthreads();
  const int j = threadIdx.x % N, i0 = threadIdx.x / N, di = blockDim.x / N;
  for (int s = 0; s < steps; ++s) {
    if (i0 < di)
      for (int i = i0; i < N; i += di)
        nxt[i * N + j] = ct_next(t, cur, i, j, N);
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int e = threadIdx.x; e < n2; e += blockDim.x) out[e] = cur[e];
}

extern "C" int gp3_ct(const int* tab, const int* kk0, int* out, int N,
                      int steps, void* stream) {
  const size_t smem = (size_t)3 * N * N * sizeof(int);
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        (const void*)gp3_ct_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
  }
  if (N > 0)
    gp3_ct_kernel<<<1, 1024, smem, (cudaStream_t)stream>>>(tab, kk0, out, N,
                                                           steps);
  return (int)cudaGetLastError();
}
'''
REPLACED_EMPTY = ("        nxt[i * N + j] = ct_next(t, cur, i, j, N);\n",
                  "        ;\n")
# every library the tool builds
VARIANTS = (*PATCHED, "replaced", "replaced_empty")


def sources(names=VARIANTS) -> dict:
    """{variant: {file: CUDA source text}}, the patches applied (the
    first file the one built); raises if a patch no longer applies."""
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    from bwamem_tpu_torch.ops.launch import CSRC
    base = {EXTRAS_NAME: EXTRAS, SHIPPED: open(gp3.SRC).read(),
            **{h: open(os.path.join(CSRC, h)).read()
               for h in ("col0.cuh", "line_pow.cuh", "smem.cuh")}}
    out = {}
    for name in names:
        if name.startswith("replaced"):
            text = REPLACED
            if name == "replaced_empty":
                if text.count(REPLACED_EMPTY[0]) != 1:
                    raise RuntimeError("the replaced_empty patch no longer "
                                       "applies")
                text = text.replace(*REPLACED_EMPTY)
            out[name] = {SHIPPED: text}
            continue
        files = dict(base)
        for f, old, new, *count in PATCHED[name]:
            if files[f].count(old) != (count or [1])[0]:
                raise RuntimeError(f"variant {name}: the patch of {old!r} "
                                   f"no longer applies to {f}")
            files[f] = files[f].replace(old, new)
        out[name] = files
    return out


def libraries(names=VARIANTS) -> dict:
    """{variant: ops.launch.Library} for `names` (of VARIANTS), each
    variant's files (sources()) written under build/ct_variants/<variant>/
    and built with -Xptxas -v into build/ct_variants/, all together;
    raises if a patch no longer applies or a build fails."""
    import ctypes
    from bwamem_tpu_torch._build import BUILD_DIR
    from bwamem_tpu_torch.ops.launch import Library
    vp, ci = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, files in sources(names).items():
        d = os.path.join(BUILD_DIR, "ct_variants", name)
        os.makedirs(d, exist_ok=True)
        for fname, body in files.items():
            path = os.path.join(d, fname)
            if not os.path.exists(path) or open(path).read() != body:
                with open(path, "w") as f:
                    f.write(body)
        if name.startswith("replaced"):
            lib = Library(SHIPPED, {"gp3_ct": [vp] * 3 + [ci] * 2},
                          ["-Xptxas", "-v"])
        else:
            lib = Library(EXTRAS_NAME, {"ct_variant": [vp] * 3 + [ci] * 5},
                          ["-Xptxas", "-v"])
        lib.src = os.path.join(d, next(iter(files)))
        lib.so_name = os.path.join("ct_variants", f"libct_{name}.so")
        libs[name] = lib
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


def ct_ptxas(lib) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    library's -Xptxas -v log (torch_row_variants.ptxas), for the gp3_ct
    kernels."""
    from torch_row_variants import ptxas
    return {name: tuple(r) for name, *r in ptxas(lib) if "ct_" in name}


def lib_call(lib, tab, kk, plan, steps=STEPS):
    """One launch of lib's ct_variant at plan (design of DESIGNS, blocks,
    threads), after the wrapper's checks (gather_probe3.check_ct)."""
    import torch
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    n = gp3.check_ct(tab, kk, steps)
    out = torch.empty_like(kk)
    lib.launch("ct_variant", out.get_device(),
               (tab.data_ptr(), kk.data_ptr(), out.data_ptr(), n,
                int(steps), *plan))
    return out


def replaced_call(lib, tab, kk, steps=STEPS):
    """The call path the shipped design replaced: the wrapper's checks,
    torch.empty_like and a launch of that design's entry."""
    import torch
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    n = gp3.check_ct(tab, kk, steps)
    out = torch.empty_like(kk)
    lib.launch("gp3_ct", out.get_device(), (tab.data_ptr(), kk.data_ptr(),
                                            out.data_ptr(), n, int(steps)))
    return out


def calls(libs: dict, tab, kk) -> dict:
    """{label: (call, want)} on one input, for the libraries in `libs`:
    want "plain" (the call equals ct_plain) or "input" (an empty step:
    it returns kk)."""
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    from torch_pl_gather_probe3 import torch_ct
    out = {"shipped": (lambda: gp3.gp3_ct(tab, kk, STEPS), "plain")}
    every = [("block", 1, 1024),
             *((d, c, p) for d in ("cluster", "mbar", "push", "copy")
               for c, p in CLUSTER_PLANS)]
    for name, lib in libs.items():
        if name.startswith("replaced"):
            continue
        empty = name.endswith("empty")
        want = "input" if empty else "plain"
        base = name.removesuffix("_empty").removesuffix("empty")
        design, label = LIB_DESIGNS.get(base, ("", ""))
        pre = "empty " if empty else ("no_table " if base == "no_table"
                                      else "")
        for d, c, p in every:
            if design and d != design or base == "no_table" and \
                    (d, c, p) not in NO_TABLE_CALLS:
                continue
            out[f"{pre}{label or d} {c:2d} x {p:4d}"] = (
                lambda plan=(DESIGNS[d], c, p), lib=lib:
                lib_call(lib, tab, kk, plan), want)
    if "replaced" in libs:
        out["replaced"] = (lambda: replaced_call(libs["replaced"], tab, kk),
                           "plain")
    if "replaced_empty" in libs:
        out["empty replaced"] = (
            lambda: replaced_call(libs["replaced_empty"], tab, kk), "input")
    out["library"] = (lambda: torch_ct(tab, kk, STEPS), "plain")
    return out


def check(libs: dict, x: dict, log=print) -> dict:
    """Every call of calls() against its want on each input of x (kinds:
    (tab, kk)), and the shipped call at CHECK_N on each kind
    after 0, 1 and STEPS steps; returns {label: max_abs_err over the
    inputs}; raises on a difference."""
    import torch
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    errs = {}
    for kind, (tab, kk) in x.items():
        plain = gp3.ct_plain(tab, kk, STEPS).to(torch.int64)
        for label, (fn, want) in calls(libs, tab, kk).items():
            ref = plain if want == "plain" else kk.to(torch.int64)
            got = fn().to(torch.int64)
            torch.cuda.synchronize()
            err = int((got - ref).abs().max().item())
            errs[label] = max(errs.get(label, 0), err)
            if err:
                raise RuntimeError(f"{label} on the {kind} input: "
                                   f"{int((got != ref).sum())} outputs "
                                   f"differ from its {want}")
    dev = x["probe"][1].device
    for n in CHECK_N:
        for kind in gp3.CT_KINDS:
            tab, kk = gp3.ct_inputs(kind, n, SEEDS[kind], dev)
            for steps in (0, 1, STEPS):
                got = gp3.gp3_ct(tab, kk, steps)
                want = gp3.ct_plain(tab, kk, steps)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"gp3_ct at N {n}, {kind}, {steps} "
                                       f"steps differs")
    log(f"ct variants: {len(errs)} calls equal their plain version (or "
        f"their input) on the {', '.join(x)} inputs; the shipped call "
        f"also at N {CHECK_N}")
    return errs


def device_ms(fn, reps: int = REPS, spin: int = SPIN_CYCLES) -> float:
    """Median time of fn() on the device alone: the events and fn's
    launches queued behind a spin of `spin` cycles, which must outlast
    fn's issue."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def in_turns(fns: dict, rounds: int = ROUNDS) -> dict:
    """{label: dict(device_ms, ms, device_lo, device_hi)}: device_ms and
    ms the medians of `rounds` rounds taken in turns (A..Z, Z..A, ...),
    device_lo and device_hi the fastest and the slowest round on the
    device alone (the rounds' spread)."""
    from torch_pl_gather_probe2 import median_ms
    runs = {k: [] for k in fns}
    order = list(fns)
    for i in range(rounds):
        for k in (order if i % 2 == 0 else order[::-1]):
            spin = LIB_SPIN_CYCLES if k == "library" else SPIN_CYCLES
            runs[k].append((device_ms(fns[k], REPS, spin),
                            median_ms(fns[k], REPS)))
    return {k: dict(device_ms=sorted(r[0] for r in v)[len(v) // 2],
                    ms=sorted(r[1] for r in v)[len(v) // 2],
                    device_lo=min(r[0] for r in v),
                    device_hi=max(r[0] for r in v))
            for k, v in runs.items()}


def make_inputs(device) -> dict:
    """{kind: (tab, kk)} at N for the kinds of SEEDS."""
    from bwamem_tpu_torch.ops import gather_probe3 as gp3
    return {kind: gp3.ct_inputs(kind, N, seed, device)
            for kind, seed in SEEDS.items()}


def compare(libs: dict, x: dict, log=print, kinds=("probe", "spread")):
    """Checks every call (check), then times them in turns on each of
    `kinds`; returns {"max_abs_err": {label: err}, "times": {kind: {label:
    dict(device_ms, ms)}}}."""
    errs = check(libs, x, log)
    times = {}
    for kind in kinds:
        tab, kk = x[kind]
        t = in_turns({k: fn for k, (fn, _) in calls(libs, tab, kk).items()})
        times[kind] = t
        for label, r in sorted(t.items(), key=lambda kv: kv[1]["device_ms"]):
            log(f"ct {kind:6s} {label:30s} device {r['device_ms']:.5f} ms "
                f"({r['device_ms'] / STEPS * 1e3:.4f} us a step), between "
                f"events {r['ms']:.5f} ms (medians of {ROUNDS} rounds in "
                f"turns)")
    return dict(max_abs_err=errs, times=times)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_ct_variants: no CUDA device", file=sys.stderr)
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
        regs[name] = ct_ptxas(lib)
        for kern, (r, ss, sl) in sorted(regs[name].items()):
            print(f"ptxas {name:14s} {kern:40s} {r:3d} registers, {ss} "
                  f"bytes spill stores, {sl} loads", flush=True)
    x = make_inputs(torch.device("cuda"))
    try:
        res = compare(libs, x, lambda m: print(m, flush=True))
    except RuntimeError as e:
        print(f"torch_ct_variants: {e}", file=sys.stderr)
        return 1
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(card=card, ptxas=regs, **res), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
