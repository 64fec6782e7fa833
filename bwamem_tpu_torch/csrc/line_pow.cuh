// A chain of a fixed step map along one axis of an int32 [S, L] table,
// for three TPU probe kernels:
//
//   kernel in probe_b,  tools/pl_gather_probe2.py:75 (pallas_call :83):
//                       kk = (kk + tab[kk, j]) mod S along axis 0, 32
//                       steps on [512, 128]; C entry gp2_take_ax0
//   kernel in probe_c,  :98 (pallas_call :106): kk = (kk + tab[i, kk])
//                       mod L along axis 1, 32 steps on [128, 128] and
//                       [8, 128]; C entry gp2_take_ax1
//   kernel in dg_probe, tools/pl_gather_probe3.py:56 (pallas_call :64):
//                       kk = clip(kk + take_along_axis(tab, kk, axis), 0,
//                       hi - 1), 512 steps; C entry gp3_dg
//
// In each, element r of line x (the column x at axis 0, the row x at axis
// 1; hi the gathered axis's size) reads only its line, and its step is a
// fixed map of its own state within that line, T_x(k) = Step::at(k,
// line[k], hi): the int32 wrap of the add and the remainder or the clip
// live inside the map, which a launch takes once.  A fixed map composes,
// so the kernels compute the same function in fewer dependent steps: the
// powers T^(2^b) by squaring (T^2(r) = T(T(r))), the state taking
// T^(2^b) for each set bit b of `steps`, lowest first (the powers of one
// map commute); 32 steps are five squarings and one lookup, 512 nine and
// one.  Three designs, by hi:
//   hi <= 32       a segment of a warp a line, a lane a row, T and the
//                  state in registers, a lookup one shuffle within the
//                  segment (pow_warp_kernel: 32 / hi lines a warp rounded
//                  up to a power of two; no shared memory, no barrier);
//   hi = 128       a warp a line, a lane 4 rows, their entries of T and
//                  their states in registers, a lookup four shuffles and a
//                  select (pow_row_kernel; no shared memory, no barrier);
//   other hi > 32  a block a line, the powers 16-bit in two shared-memory
//                  buffers in turns, a block barrier a round (4 x hi
//                  bytes: hi up to 58112, the wrappers' limit, fits
//                  227 KB) (pow_block_kernel).
// `steps` = 0 leaves every state at kk0.
//
// The step is a compile-time parameter: a struct with a static
// `int at(int k, int g, int hi)` that the including source defines for
// the card and the host (ModStep in gather_probe2_kernel.cu, ClipStep in
// gather_probe3_kernel.cu).
//
// What bounds them on an H100: not bytes (kk in, kk out and the table
// words, under 800 KB, a fraction of a microsecond at 3.35 TB/s) but one
// launch's latency and what a block does after it: reading its line (a
// column at axis 0 is a word from each of hi rows), the map's one
// remainder or clip, then the dependent lookups.  So each kernel issues
// its loads before it takes the step: a load under a condition with a
// run-time remainder after it compiled to a branch each, and four loads
// went to memory one after another (0.7 us on gp2_take_ax1, an H100 80GB
// HBM3 at 700 W; tools/torch_take2_variants.py).
//
// Compiled as host C++ (no __CUDACC__), line_pow_host runs the same
// algorithm in the card's order instead of the kernels.
#pragma once
#include <stdint.h>
#include <stdlib.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include "smem.cuh"
#define LP_HD __device__
#else
#define LP_HD
#endif

// element r of line x of [S, L] along `axis`: its flat index
static LP_HD inline long long line_elem(int axis, int x, int r, int L) {
  return axis == 0 ? (long long)r * L + x : (long long)x * L + r;
}

#ifdef __CUDACC__

// hi <= 32: a lane a row of a line, a segment of W lanes (a power of two
// >= hi) a line, 32 / W lines a warp; lanes past hi or past the last line
// take part in every shuffle and store nothing
template <class Step, int AX>
__global__ void __launch_bounds__(128)
pow_warp_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                int* __restrict__ out, int S, int L, int steps, int W) {
  const int hi = AX == 0 ? S : L, lines = AX == 0 ? L : S;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int x = warp * (32 / W) + lane / W, r = lane & (W - 1);
  const bool on = x < lines && r < hi;
  const long long e = on ? line_elem(AX, x, r, L) : 0;
  const int g = on ? __ldg(tab + e) : 0;  // both loads before the step
  int k = on ? __ldg(kk0 + e) : 0;
  int p = Step::at(r, g, hi);
  for (int s = steps; s; s >>= 1) {
    if (s & 1) k = __shfl_sync(0xffffffffu, p, k, W);
    if (s >> 1) p = __shfl_sync(0xffffffffu, p, p, W);
  }
  if (on) out[e] = k;
}

// a line's map held as p[c] = T[lane + 32 c] across a warp: T[k] by four
// shuffles from lane k % 32 and a select by k / 32
static __device__ __forceinline__ int lp_row_lookup(const int (&p)[4],
                                                    int k) {
  const int v0 = __shfl_sync(0xffffffffu, p[0], k & 31);
  const int v1 = __shfl_sync(0xffffffffu, p[1], k & 31);
  const int v2 = __shfl_sync(0xffffffffu, p[2], k & 31);
  const int v3 = __shfl_sync(0xffffffffu, p[3], k & 31);
  const int h = k >> 5;
  return h == 0 ? v0 : (h == 1 ? v1 : (h == 2 ? v2 : v3));
}

// hi = 128: a warp a line, lane l its rows l + 32 c (c < 4), their
// entries of T and their states in registers; hi known at compile time,
// so a step's remainder by hi is a mask
template <class Step, int AX>
__global__ void __launch_bounds__(128)
pow_row_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
               int* __restrict__ out, int S, int L, int steps) {
  const int lines = AX == 0 ? L : S;
  const int x = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (x >= lines) return;                // the whole warp
  const int lane = threadIdx.x & 31;
  int p[4], k[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long e = line_elem(AX, x, lane + 32 * c, L);
    p[c] = __ldg(tab + e);
    k[c] = __ldg(kk0 + e);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) p[c] = Step::at(lane + 32 * c, p[c], 128);
  for (int s = steps; s; s >>= 1) {
    if (s & 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) k[c] = lp_row_lookup(p, k[c]);
    }
    if (s >> 1) {
      int q[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) q[c] = lp_row_lookup(p, p[c]);
#pragma unroll
      for (int c = 0; c < 4; ++c) p[c] = q[c];
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out[line_elem(AX, x, lane + 32 * c, L)] = k[c];
}

// a block a line (line_pow_launch's at hi > 32 but not 128); the power in
// use and the next one 16-bit in shared memory (2 x hi entries), a
// barrier a round, the states in out (each touched only by its thread,
// once a set bit)
template <class Step, int AX>
__global__ void __launch_bounds__(1024)
pow_block_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                 int* __restrict__ out, int S, int L, int steps) {
  extern __shared__ uint16_t lp_sm[];
  const int hi = AX == 0 ? S : L;
  const int x = blockIdx.x;
  uint16_t* cur = lp_sm;
  uint16_t* nxt = lp_sm + hi;
  for (int r = threadIdx.x; r < hi; r += blockDim.x)
    cur[r] = (uint16_t)Step::at(r, __ldg(tab + line_elem(AX, x, r, L)), hi);
  __syncthreads();
  bool first = true;                     // the states are still kk0's
  for (int s = steps; s; s >>= 1) {
    for (int r = threadIdx.x; r < hi; r += blockDim.x) {
      if (s & 1) {
        const long long e = line_elem(AX, x, r, L);
        out[e] = cur[first ? __ldg(kk0 + e) : out[e]];
      }
      if (s >> 1) nxt[r] = cur[cur[r]];
    }
    first = first && !(s & 1);
    __syncthreads();
    uint16_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (first)
    for (int r = threadIdx.x; r < hi; r += blockDim.x) {
      const long long e = line_elem(AX, x, r, L);
      out[e] = __ldg(kk0 + e);
    }
}

// The chain along `axis` on the stream: hi up to 32 the warp-segment
// design, hi = 128 a warp a line (both in blocks of 4 warps), else a
// block a line with two 16-bit maps of hi entries in shared memory
// (opted into past 48 KB).  Returns the CUDA error code.
template <class Step>
static int line_pow_launch(const int* tab, const int* kk0, int* out, int S,
                           int L, int steps, int axis, cudaStream_t st) {
  const int hi = axis == 0 ? S : L, lines = axis == 0 ? L : S;
  if (lines < 1 || hi < 1) return (int)cudaGetLastError();
  if (hi <= 32) {
    int W = 1;
    while (W < hi) W *= 2;
    const int warps = (lines + 32 / W - 1) / (32 / W);
    const int blocks = (warps + 3) / 4;
    if (axis == 0)
      pow_warp_kernel<Step, 0><<<blocks, 128, 0, st>>>(tab, kk0, out, S, L,
                                                       steps, W);
    else
      pow_warp_kernel<Step, 1><<<blocks, 128, 0, st>>>(tab, kk0, out, S, L,
                                                       steps, W);
    return (int)cudaGetLastError();
  }
  if (hi == 128) {
    const int blocks = (lines + 3) / 4;
    if (axis == 0)
      pow_row_kernel<Step, 0><<<blocks, 128, 0, st>>>(tab, kk0, out, S, L,
                                                       steps);
    else
      pow_row_kernel<Step, 1><<<blocks, 128, 0, st>>>(tab, kk0, out, S, L,
                                                       steps);
    return (int)cudaGetLastError();
  }
  const size_t smem = (size_t)2 * hi * sizeof(uint16_t);
  const int threads = hi < 1024 ? (hi + 31) / 32 * 32 : 1024;
  const void* fn = axis == 0 ? (const void*)pow_block_kernel<Step, 0>
                             : (const void*)pow_block_kernel<Step, 1>;
  const int rc = smem_opt_in(fn, smem);
  if (rc) return rc;
  if (axis == 0)
    pow_block_kernel<Step, 0><<<lines, threads, smem, st>>>(tab, kk0, out, S,
                                                            L, steps);
  else
    pow_block_kernel<Step, 1><<<lines, threads, smem, st>>>(tab, kk0, out, S,
                                                            L, steps);
  return (int)cudaGetLastError();
}

#else

// The kernels' algorithm on the host, in their order: each line's map T,
// T's powers by squaring and the state taking T^(2^b) for each set bit b
// of `steps`, lowest first, as the warp designs (a shuffle at the state)
// and the block design (a 16-bit power) do.  Returns 2 when the buffers
// cannot be allocated.
template <class Step>
static int line_pow_host(const int* tab, const int* kk0, int* out, int S,
                         int L, int steps, int axis) {
  const int hi = axis == 0 ? S : L, lines = axis == 0 ? L : S;
  uint16_t* cur = (uint16_t*)malloc((size_t)2 * hi * sizeof(uint16_t));
  if (!cur) return 2;
  uint16_t* nxt = cur + hi;
  for (int x = 0; x < lines; ++x) {
    uint16_t* p = cur;
    uint16_t* q = nxt;
    for (int r = 0; r < hi; ++r) {
      const long long e = line_elem(axis, x, r, L);
      p[r] = (uint16_t)Step::at(r, tab[e], hi);
      out[e] = kk0[e];
    }
    for (int s = steps; s; s >>= 1) {
      for (int r = 0; r < hi; ++r) {
        const long long e = line_elem(axis, x, r, L);
        if (s & 1) out[e] = p[out[e]];
        if (s >> 1) q[r] = p[p[r]];
      }
      uint16_t* t = p;
      p = q;
      q = t;
    }
  }
  free(cur);
  return 0;
}

#endif
