// Round 2 of the gather probe: four more ways to look up a table word per
// lane, each the function of one TPU probe kernel of
// tools/pl_gather_probe2.py, one __global__ each:
//
//   gp2_take_ax0   (kernel in probe_b, :75)  a chained gather along axis 0:
//                  kk = (kk + tab[kk[i,j], j]) mod R, `steps` times, on
//                  tab and kk [R,128].  Element (i,j) reads only column j,
//                  so a block takes one column: it stages the column's R
//                  words in shared memory (2 KB at R = 512; the whole
//                  256 KB table would not fit in the 227 KB a block may
//                  have) and runs the R chains of that column, one thread
//                  each, every step a dependent shared-memory load.
//   gp2_take_ax1   (kernel in probe_c, :98)  the same along axis 1:
//                  kk = (kk + tab[i, kk[i,j]]) mod 128 on [S,128].  A block
//                  takes one row (512 B in shared memory) and its 128
//                  chains.  At S = 8 the launch is all there is.
//   gp2_col0       (kernel in probe_d, :122) out[q] = tab[k[q], 0] on a
//                  table of W-word rows: col0_kernel of csrc/col0.cuh,
//                  which gp3_col0 launches too.
//   gp2_onehot_f32 (kernel in probe_e, :150) out[q] = int(m1[q, k[q] & 127])
//                  with m1 = f32(onehot(k >> 7, A)) @ f32(tab), tab [A,128].
//                  Each sum of that product is exact (one term is
//                  1 x f32(v), every other term adds 0), so m1[q, c] is
//                  f32(tab[k >> 7, c]), and 0 where k >> 7 is outside
//                  [0, A): the product computes a gather, and so does this
//                  kernel.  A thread a query: k[q] read coalesced, one
//                  4-byte read-only load of tab at flat index k (row
//                  k >> 7, column k & 127) where 0 <= k >> 7 < A, the word
//                  converted int32 -> float32 (to nearest even, as the TPU
//                  kernel's astype(float32): from 2^24 on it rounds) and
//                  truncated back to int32 as astype(int32).  Precondition:
//                  |tab| <= 2^31 - 129, so that f32(v) < 2^31 converts
//                  back (the host's cast is undefined from 2^31, the
//                  card's saturates).
//
// The add of the chains wraps in 32 bits and the remainder is never
// negative (jnp's %), as next_k of fm_probe_kernel.cu.
//
// What bounds them on an H100 (3.35 TB/s at 700 W): bytes, and all four
// move under a megabyte (tab, kk in and out: 786 KB for take_ax0 at
// [512,128], 197 KB for take_ax1 at [128,128], tens of KB for col0 at 1024
// lanes; for onehot_f32 k, out and at most Q table words, about 12 KB at
// Q = 1024), well under a microsecond, so launch latency and the dependent
// steps of the chains are what one sees.  onehot_f32 does not make the TPU
// kernel's whole product (2 x Q x A x 128 FMA operations).
//
// The same source compiles as host C++ (no __CUDACC__), exposing the lane
// loops of all four as *_host entries, so the CPU tests check their
// arithmetic without a card.
#include <stdint.h>

#include "col0.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define GP_HD __device__
#define GP_LDG(p) __ldg(p)
#else
#define GP_HD
#define GP_LDG(p) (*(p))
#endif

// (k + g) mod m with the add wrapping in 32 bits and the result in [0, m):
// C's % keeps the sign of a negative left side.
static GP_HD inline int next_k(int k, int g, int m) {
  const int v = (int)((uint32_t)k + (uint32_t)g);
  const int r = v % m;
  return r < 0 ? r + m : r;
}

// one chain: kk = next_k(kk, words[kk * stride], m), `steps` times; words
// is the column (axis 0) or row (axis 1) the chain reads
static GP_HD inline int chain(const int* words, long long stride, int kk,
                              int steps, int m) {
  for (int s = 0; s < steps; ++s) kk = next_k(kk, words[kk * stride], m);
  return kk;
}

// lane of gp2_onehot_f32 for the query kq: f32(tab.flat[kq]) truncated to
// int, 0 where row kq >> 7 (an arithmetic shift) is outside [0, A); the
// flat index kq equals (kq >> 7) * 128 + (kq & 127)
static GP_HD inline int onehot_f32_lane(const int* __restrict__ tab, int kq,
                                        int A) {
  const int hi = kq >> 7;
  const int v = (0 <= hi && hi < A) ? GP_LDG(tab + kq) : 0;
  return (int)(float)v;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(512)
gp2_take_ax0_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                    int* __restrict__ out, int R, int steps) {
  extern __shared__ int col[];                   // column j, R words
  const int j = blockIdx.x;
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    col[r] = tab[(long long)r * 128 + j];
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const long long e = (long long)r * 128 + j;
    out[e] = chain(col, 1, kk0[e], steps, R);
  }
}

__global__ void __launch_bounds__(128)
gp2_take_ax1_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                    int* __restrict__ out, int steps) {
  __shared__ int row[128];
  const long long e = (long long)blockIdx.x * 128 + threadIdx.x;
  row[threadIdx.x] = tab[e];
  __syncthreads();
  out[e] = chain(row, 1, kk0[e], steps, 128);
}

__global__ void __launch_bounds__(128)
gp2_onehot_f32_kernel(const int* __restrict__ tab,
                      const int* __restrict__ k, int* __restrict__ out,
                      int N, int A) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < N) out[q] = onehot_f32_lane(tab, __ldg(k + q), A);
}

// C entries for ctypes: device pointers; each returns cudaGetLastError()
// after the launch on the caller's stream.  The wrappers in
// ops/gather_probe2.py check shapes (the 128-column tables, R words of
// shared memory at most).
extern "C" int gp2_take_ax0(const int* tab, const int* kk0, int* out, int R,
                            int steps, void* stream) {
  const size_t smem = (size_t)R * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gp2_take_ax0_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = R < 512 ? (R + 31) / 32 * 32 : 512;
  if (R > 0)
    gp2_take_ax0_kernel<<<128, threads, smem, (cudaStream_t)stream>>>(
        tab, kk0, out, R, steps);
  return (int)cudaGetLastError();
}

extern "C" int gp2_take_ax1(const int* tab, const int* kk0, int* out, int S,
                            int steps, void* stream) {
  if (S > 0)
    gp2_take_ax1_kernel<<<S, 128, 0, (cudaStream_t)stream>>>(tab, kk0, out,
                                                             steps);
  return (int)cudaGetLastError();
}

extern "C" int gp2_col0(const int* tab, const int* k, int* out, int N, int W,
                        void* stream) {
  return col0_launch(tab, k, out, N, W, (cudaStream_t)stream);
}

extern "C" int gp2_onehot_f32(const int* tab, const int* k, int* out, int N,
                              int A, void* stream) {
  if (N > 0)
    gp2_onehot_f32_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        tab, k, out, N, A);
  return (int)cudaGetLastError();
}

#else

// Host builds of the lane loops (all pointers are host memory).
extern "C" int gp2_take_ax0_host(const int* tab, const int* kk0, int* out,
                                 int R, int steps) {
  for (long long e = 0; e < (long long)R * 128; ++e)
    out[e] = chain(tab + (e & 127), 128, kk0[e], steps, R);
  return 0;
}

extern "C" int gp2_take_ax1_host(const int* tab, const int* kk0, int* out,
                                 int S, int steps) {
  for (long long e = 0; e < (long long)S * 128; ++e)
    out[e] = chain(tab + (e & ~127LL), 1, kk0[e], steps, 128);
  return 0;
}

extern "C" int gp2_col0_host(const int* tab, const int* k, int* out, int N,
                             int W) {
  return col0_host(tab, k, out, N, W);
}

extern "C" int gp2_onehot_f32_host(const int* tab, const int* k, int* out,
                                   int N, int A) {
  for (int q = 0; q < N; ++q) out[q] = onehot_f32_lane(tab, k[q], A);
  return 0;
}

#endif
