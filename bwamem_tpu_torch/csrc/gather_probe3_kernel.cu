// Round 3 of the gather probe: the gather envelope and a float32 product,
// each the function of one TPU probe kernel of tools/pl_gather_probe3.py,
// one __global__ each (gp3_dg is one template for both axes):
//
//   gp3_dg    (kernel in dg_probe, :56)  a clipped chain along one axis:
//             kk = clip(kk + take_along_axis(tab, kk, axis), 0, hi - 1),
//             `steps` times, on tab and kk [S, L], hi = the gathered
//             axis's size.  An element reads only its column (axis 0) or
//             its row (axis 1), so a block takes one such line: it stages
//             the line's hi words in shared memory (32 B for B8, 128 B for
//             B32, 2 KB a row for C512, whose whole 256 KB table would not
//             fit in the 227 KB a block may have) and runs the line's
//             chains, one thread each, every step a dependent shared-memory
//             load.
//   gp3_ct    (kernel in probe_ct, :79)  a take along axis 1, a transpose
//             and a second take at the same kk: per step g2[i, j] =
//             tab[m, kk[m, i]] with m = kk[i, j], then kk = clip(kk + g2,
//             0, N - 1), on [N, N].  Element (i, j) reads kk of row m, so
//             every lane must finish step t before any starts t + 1: one
//             block of 1024 threads holds tab and two kk buffers in shared
//             memory (3 x 64 KB at N = 128), reads one buffer and writes
//             the other, and swaps them after a __syncthreads().  With one
//             buffer a lane could read a row another lane has already moved
//             to step t + 1.
//   gp3_col0  (kernel in probe_d2, :103)  out[q] = tab[k[q], 0] for a few
//             lanes (8 in the probe) of a [R, W] table: col0_kernel of
//             csrc/col0.cuh, which gp2_col0 launches too (one warp here).
//   gp3_mm    (kernel in probe_e2, :125)  out = 64 ordered float32
//             additions acc = acc + m of m = (a @ b)[:8]: a [M, K], b
//             [K, N], out [R, N].  Only rows :R of the product reach the
//             output and they are the same in each of the 64 iterations,
//             so a thread computes its m[r, c] once, by float32 FMA on the
//             CUDA cores in k order (TF32 would round from 2^11 on), then
//             adds it 64 times, each add rounded (not 64 * m, which is
//             another number).  A block takes one row, a thread a column.
//
// The add of the chains wraps in 32 bits (jnp's int32 add), and the clip
// is jnp.clip's.
//
// What bounds them on an H100 (3.35 TB/s; 67 TFLOP/s float32 outside the
// tensor cores, at 700 W): the chains move kk in and out and the table
// words they touch (kilobytes to 260 KB), a fraction of a microsecond, so
// the launch and the dependent steps are what one sees; gp3_col0 moves
// under 100 bytes; gp3_mm's function moves a[:8], b and out (352 KB, 0.1 us)
// and does 1.4 MFLOP.  The TPU kernel computed 64 whole [1024, 640] x
// [640, 128] products (10.7 GFLOP); this one computes the function.
//
// The same source compiles as host C++ (no __CUDACC__), exposing the lane
// loops as *_host entries, so the CPU tests check their arithmetic without
// a card.
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "col0.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define GP_HD __device__
#define GP_LDG(p) __ldg(p)
#else
#define GP_HD
#define GP_LDG(p) (*(p))
#endif

// clip(k + g, 0, hi - 1), the add wrapping in 32 bits
static GP_HD inline int clip_step(int k, int g, int hi) {
  const int v = (int)((uint32_t)k + (uint32_t)g);
  return v < 0 ? 0 : (v > hi - 1 ? hi - 1 : v);
}

// one gp3_dg chain over a line of hi words (stride apart)
static GP_HD inline int dg_chain(const int* line, long long stride, int k,
                                 int steps, int hi) {
  for (int s = 0; s < steps; ++s) k = clip_step(k, line[k * stride], hi);
  return k;
}

// one gp3_ct step of element (i, j) of the N x N state kk
static GP_HD inline int ct_next(const int* tab, const int* kk, int i, int j,
                                int N) {
  const int m = kk[i * N + j];
  return clip_step(m, tab[m * N + kk[m * N + i]], N);
}

// gp3_mm's element (r, c): m by FMA in k order, then `reps` adds
static GP_HD inline float mm_elem(const float* __restrict__ a,
                                  const float* __restrict__ b, int r, int c,
                                  int K, int N, int reps) {
  float m = 0.0f;
  for (int k = 0; k < K; ++k)
    m = fmaf(GP_LDG(a + (long long)r * K + k),
             GP_LDG(b + (long long)k * N + c), m);
  float acc = 0.0f;
  for (int t = 0; t < reps; ++t) acc = acc + m;
  return acc;
}

#ifdef __CUDACC__

template <int AX>
__global__ void __launch_bounds__(512)
gp3_dg_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
              int* __restrict__ out, int S, int L, int steps) {
  extern __shared__ int line[];
  const int hi = AX == 0 ? S : L;
  const long long x = blockIdx.x;              // the column or the row
  for (int r = threadIdx.x; r < hi; r += blockDim.x)
    line[r] = AX == 0 ? tab[r * (long long)L + x] : tab[x * L + r];
  __syncthreads();
  for (int r = threadIdx.x; r < hi; r += blockDim.x) {
    const long long e = AX == 0 ? r * (long long)L + x : x * L + r;
    out[e] = dg_chain(line, 1, kk0[e], steps, hi);
  }
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
  // a thread keeps one column j and walks the rows i0, i0 + di, ... (no
  // division by the runtime N inside the steps; N <= 139, the wrapper's
  // shared-memory check, so di >= 7)
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

__global__ void __launch_bounds__(1024)
gp3_mm_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int K, int N, int reps) {
  const int r = blockIdx.x;
  for (int c = threadIdx.x; c < N; c += blockDim.x)
    out[(long long)r * N + c] = mm_elem(a, b, r, c, K, N, reps);
}

static int smem_opt_in(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// C entries for ctypes: device pointers; each returns cudaGetLastError()
// after the launch on the caller's stream.  The wrappers in
// ops/gather_probe3.py check shapes and the shared memory each needs.
extern "C" int gp3_dg(const int* tab, const int* kk0, int* out, int S, int L,
                      int steps, int axis, void* stream) {
  const int hi = axis == 0 ? S : L, lines = axis == 0 ? L : S;
  const size_t smem = (size_t)hi * sizeof(int);
  const int threads = hi < 512 ? (hi + 31) / 32 * 32 : 512;
  const void* fn = axis == 0 ? (const void*)gp3_dg_kernel<0>
                             : (const void*)gp3_dg_kernel<1>;
  const int rc = smem_opt_in(fn, smem);
  if (rc) return rc;
  if (lines > 0 && hi > 0) {
    if (axis == 0)
      gp3_dg_kernel<0><<<lines, threads, smem, (cudaStream_t)stream>>>(
          tab, kk0, out, S, L, steps);
    else
      gp3_dg_kernel<1><<<lines, threads, smem, (cudaStream_t)stream>>>(
          tab, kk0, out, S, L, steps);
  }
  return (int)cudaGetLastError();
}

extern "C" int gp3_ct(const int* tab, const int* kk0, int* out, int N,
                      int steps, void* stream) {
  const size_t smem = (size_t)3 * N * N * sizeof(int);
  const int rc = smem_opt_in((const void*)gp3_ct_kernel, smem);
  if (rc) return rc;
  if (N > 0)
    gp3_ct_kernel<<<1, 1024, smem, (cudaStream_t)stream>>>(tab, kk0, out, N,
                                                           steps);
  return (int)cudaGetLastError();
}

extern "C" int gp3_col0(const int* tab, const int* k, int* out, int N, int W,
                        void* stream) {
  return col0_launch(tab, k, out, N, W, (cudaStream_t)stream);
}

extern "C" int gp3_mm(const float* a, const float* b, float* out, int R,
                      int K, int N, int reps, void* stream) {
  const int threads = N < 1024 ? (N + 31) / 32 * 32 : 1024;
  if (R > 0 && N > 0)
    gp3_mm_kernel<<<R, threads, 0, (cudaStream_t)stream>>>(a, b, out, K, N,
                                                           reps);
  return (int)cudaGetLastError();
}

#else

// Host builds of the lane loops (all pointers are host memory).
extern "C" int gp3_dg_host(const int* tab, const int* kk0, int* out, int S,
                           int L, int steps, int axis) {
  for (long long e = 0; e < (long long)S * L; ++e) {
    const long long i = e / L, j = e % L;
    out[e] = axis == 0 ? dg_chain(tab + j, L, kk0[e], steps, S)
                       : dg_chain(tab + i * L, 1, kk0[e], steps, L);
  }
  return 0;
}

// the same two-buffer step as the block: every element of step t reads
// the state of step t - 1
extern "C" int gp3_ct_host(const int* tab, const int* kk0, int* out, int N,
                           int steps) {
  const size_t n2 = (size_t)N * N;
  int* cur = (int*)malloc(n2 * sizeof(int));
  int* nxt = (int*)malloc(n2 * sizeof(int));
  if (!cur || !nxt) {
    free(cur);
    free(nxt);
    return 1;
  }
  memcpy(cur, kk0, n2 * sizeof(int));
  for (int s = 0; s < steps; ++s) {
    for (size_t e = 0; e < n2; ++e)
      nxt[e] = ct_next(tab, cur, (int)(e / N), (int)(e % N), N);
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  memcpy(out, cur, n2 * sizeof(int));
  free(cur);
  free(nxt);
  return 0;
}

extern "C" int gp3_col0_host(const int* tab, const int* k, int* out, int N,
                             int W) {
  return col0_host(tab, k, out, N, W);
}

extern "C" int gp3_mm_host(const float* a, const float* b, float* out, int R,
                           int K, int N, int reps) {
  for (int r = 0; r < R; ++r)
    for (int c = 0; c < N; ++c)
      out[(long long)r * N + c] = mm_elem(a, b, r, c, K, N, reps);
  return 0;
}

#endif
