// Round 2 of the gather probe: four more ways to look up a table word per
// lane, each the function of one TPU probe kernel of
// tools/pl_gather_probe2.py, one __global__ each:
//
//   gp2_take_ax0   (kernel in probe_b, :75)  a chained gather along axis 0:
//                  kk = (kk + tab[kk[i,j], j]) mod R, `steps` times, on
//                  tab and kk [R,128].  Element (i,j) reads only column j,
//                  and its step is a fixed map of its own state, T_j(k) =
//                  next_k(k, tab[k, j], R) (the int32 wrap and the sign of
//                  the remainder inside the map: ModStep), so the same
//                  function takes the map once a launch and a step is one
//                  lookup.
//   gp2_take_ax1   (kernel in probe_c, :98)  the same along axis 1:
//                  kk = (kk + tab[i, kk[i,j]]) mod 128 on [S,128], the map
//                  of row i T_i(k) = next_k(k, tab[i, k], 128).
//                  Both launch csrc/line_pow.cuh's kernels, which gp3_dg
//                  launches with its clip, each taking T's powers by
//                  squaring (32 steps: five squarings and one lookup): at
//                  the probe's R = 512 a block a column with the powers
//                  16-bit in shared memory, a squaring two dependent 16-bit
//                  loads and a block barrier; at axis 1 (and R = 128) a
//                  warp a row, T_i in four registers a lane, a lookup four
//                  shuffles and a select; at R up to 32 a segment of a
//                  warp a column, a lookup one shuffle.
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
// Q = 1024), well under a microsecond, so one launch's latency is the
// floor.  For the chains, what comes after it: the design they replaced
// (a block a line, a thread a chain) took 32 dependent shared loads, each
// behind the add and a remainder by a run-time divisor; with the map taken
// once, 32 steps are five squarings and one lookup, each a round of
// dependent shared loads and a barrier (take_ax0) or of four shuffles
// (take_ax1).  take_ax0 still reads a column of tab and of kk and writes
// one of out, a word from each of 512 rows: at 0 steps that alone is
// about 2 us past the launch, as in every design weighed
// (tools/torch_take2_variants.py).  onehot_f32 does not make the TPU
// kernel's whole product (2 x Q x A x 128 FMA operations).
//
// The same source compiles as host C++ (no __CUDACC__), exposing the lane
// loops of all four as *_host entries, so the CPU tests check their
// arithmetic without a card.
#include <stdint.h>

#include "col0.cuh"
#include "line_pow.cuh"

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

// the chains' step as line_pow.cuh takes it
struct ModStep {
  static GP_HD inline int at(int k, int g, int m) { return next_k(k, g, m); }
};

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
// the chains: line_pow.cuh's kernels with the remainder as the step (R x 4
// bytes of shared memory at most, which the wrapper checks)
extern "C" int gp2_take_ax0(const int* tab, const int* kk0, int* out, int R,
                            int steps, void* stream) {
  return line_pow_launch<ModStep>(tab, kk0, out, R, 128, steps, 0,
                                  (cudaStream_t)stream);
}

extern "C" int gp2_take_ax1(const int* tab, const int* kk0, int* out, int S,
                            int steps, void* stream) {
  return line_pow_launch<ModStep>(tab, kk0, out, S, 128, steps, 1,
                                  (cudaStream_t)stream);
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

// Host builds of the lane loops (all pointers are host memory); the
// chains run line_pow.cuh's algorithm in the card's order.
extern "C" int gp2_take_ax0_host(const int* tab, const int* kk0, int* out,
                                 int R, int steps) {
  return line_pow_host<ModStep>(tab, kk0, out, R, 128, steps, 0);
}

extern "C" int gp2_take_ax1_host(const int* tab, const int* kk0, int* out,
                                 int S, int steps) {
  return line_pow_host<ModStep>(tab, kk0, out, S, 128, steps, 1);
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
