// The gather-strategy probe: four ways for an in-kernel FM scan to look up
// a table row per lane, each priced on its own.  They replace the four TPU
// probe kernels of tools/pl_gather_probe.py, one __global__ each:
//
//   gp_scalar    (kernel_scalar, :65)   out[i,j] = tab[k[i,j], j]; tab
//                [R,128], k and out [N/128,128].  The TPU kernel rewrites
//                the same output `STEPS` times to price a pass (its script
//                divides by STEPS); the output does not depend on it, so
//                this kernel makes one pass: a thread a lane, k read
//                coalesced, one 4-byte read-only load of the table a lane
//                (uncoalesced: each lane its own row), a coalesced store.
//   gp_scalar2   (kernel_scalarw, :93)  out = tab[k,0] + tab[k,1], the add
//                wrapping in 32 bits; tab [R,W], W >= 2.  The TPU kernel,
//                too, repeats its pass `STEPS` times only to price one, so
//                this kernel makes one pass, as gp_scalar does: a thread a
//                lane, k read coalesced, the row's two words in one 8-byte
//                read-only load where the row start is 8-byte aligned (W
//                even, tab 8-byte aligned) and in two 4-byte ones
//                otherwise, a coalesced store.
//   gp_onehot    (kernel_mm, :120)      out = int(bf16(tab3[k>>7, k&127])),
//                0 where k>>7 is outside [0, A); tab3 [A,128].  The TPU
//                kernel prices its matrix unit: a one-hot [N, A] times the
//                bf16 table, then column k&127 picked per query.  That
//                product computes a gather, and so does this kernel: one
//                thread a lane, k[q] read coalesced, one 4-byte load of
//                tab3 at flat index k when 0 <= k < A*128, the word
//                converted int32 -> float (exact for |v| < 2^24, the
//                documented precondition), rounded to bf16 to nearest
//                even as XLA's astype(bfloat16) does, and truncated back to
//                int32 as astype(int32) does.  The rounding is integer bit
//                arithmetic on the float's bits (not __float2bfloat16_rn),
//                so the lane builds for the host too.
//   gp_take_ax0  (kernel_dg, :151)      a chained take_along_axis along axis
//                0 over the whole table: kk = (kk + tab[kk, j]) mod R,
//                `steps` times, on [R,128] (the probe seeds the first N/128
//                rows with k and the rest with 0).  One thread per element,
//                j the fast index, so a warp's first loads read 32 adjacent
//                words of a row; the add wraps in 32 bits and the remainder
//                is never negative (jnp's %).
//
// What bounds them on an H100 (3.35 TB/s at 700 W): bytes.  gp_scalar and
// gp_scalar2 move ~100 KB (k, the touched words, out), a fraction of a
// microsecond, and gp_onehot ~97 KB at N = 8192 (k, out and the touched
// words: 0.000029 ms), so a launch's own latency is all one sees;
// gp_take_ax0 moves 120 MB (table, kk in, kk out), ~0.036 ms.
//
// gp_scalar and gp_scalar2 load through the read-only path (__ldg).
//
// The same source compiles as host C++ (no __CUDACC__), exposing the lane
// loops of all four as *_host entries, so the CPU tests check their
// arithmetic without a card.
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define GP_HD __device__
#define GP_LDG(p) __ldg(p)
#define GP_F2U(f) __float_as_uint(f)
#define GP_U2F(u) __uint_as_float(u)

// words 0 and 1 at p, 8-byte aligned: one 8-byte read-only load
static __device__ __forceinline__ void ldg_pair(const int* p, int& a,
                                                int& b) {
  const int2 v = __ldg(reinterpret_cast<const int2*>(p));
  a = v.x;
  b = v.y;
}
#else
#define GP_HD
#define GP_LDG(p) (*(p))

static inline uint32_t GP_F2U(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}

static inline float GP_U2F(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

static inline void ldg_pair(const int* p, int& a, int& b) {
  a = p[0];
  b = p[1];
}
#endif

// lane q of gp_scalar: row k[q], column q & 127 of the 128-column table
static GP_HD inline int scalar_lane(const int* __restrict__ tab,
                                    const int* __restrict__ k, int q) {
  return GP_LDG(tab + (long long)GP_LDG(k + q) * 128 + (q & 127));
}

// lane q of gp_scalar2: words 0 and 1 of row k[q] of the W-word table,
// added with the 32-bit wrap; PAIR: the row start is 8-byte aligned, so
// one 8-byte load reads both
template <bool PAIR>
static GP_HD inline int scalar2_lane(const int* __restrict__ tab,
                                     const int* __restrict__ k, int q,
                                     int W) {
  const int* row = tab + (long long)GP_LDG(k + q) * W;
  int a, b;
  if (PAIR) {
    ldg_pair(row, a, b);
  } else {
    a = GP_LDG(row);
    b = GP_LDG(row + 1);
  }
  return (int)((uint32_t)a + (uint32_t)b);
}

// (k + g) mod R with the add wrapping in 32 bits and the result in [0, R):
// C's % keeps the sign of a negative left side.
static GP_HD inline int next_k(int k, int g, int R) {
  const int v = (int)((uint32_t)k + (uint32_t)g);
  const int r = v % R;
  return r < 0 ? r + R : r;
}

// element e = r * 128 + j of gp_take_ax0
static GP_HD inline int take_lane(const int* __restrict__ tab, int kk, int j,
                                  int steps, int R) {
  for (int s = 0; s < steps; ++s)
    kk = next_k(kk, GP_LDG(tab + (long long)kk * 128 + j), R);
  return kk;
}

// f rounded to bfloat16, to nearest even, returned as a float: add 0x7fff,
// one more when the kept part is odd (a tie then rounds up to even), and
// drop the low 16 bits.  Inf passes unchanged (the add cannot carry out of
// a zero mantissa); a NaN could carry into Inf, so it keeps its sign and
// top mantissa bits with the quiet bit set.  The int inputs of gp_onehot
// (|v| < 2^24) never reach the NaN branch.
static GP_HD inline float bf16_round(float f) {
  uint32_t u = GP_F2U(f);
  if ((u & 0x7fffffffu) > 0x7f800000u)
    return GP_U2F((u | 0x00400000u) & 0xffff0000u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return GP_U2F(u & 0xffff0000u);
}

// lane q of gp_onehot: the bf16 value of tab3's word at flat index kq (row
// kq >> 7, column kq & 127) truncated to int, 0 where kq is outside
// [0, n_words)
static GP_HD inline int onehot_lane(const int* __restrict__ tab3, int kq,
                                    long long n_words) {
  if (kq < 0 || kq >= n_words) return 0;
  return (int)bf16_round((float)GP_LDG(tab3 + kq));
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(128)
gp_scalar_kernel(const int* __restrict__ tab, const int* __restrict__ k,
                 int* __restrict__ out, int N) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < N) out[q] = scalar_lane(tab, k, q);
}

template <bool PAIR>
__global__ void __launch_bounds__(128)
gp_scalar2_kernel(const int* __restrict__ tab, const int* __restrict__ k,
                  int* __restrict__ out, int N, int W) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < N) out[q] = scalar2_lane<PAIR>(tab, k, q, W);
}

__global__ void __launch_bounds__(128)
gp_take_ax0_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                   int* __restrict__ out, long long n, int steps, int R) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = take_lane(tab, kk0[e], (int)(e & 127), steps, R);
}

__global__ void __launch_bounds__(128)
gp_onehot_kernel(const int* __restrict__ tab3, const int* __restrict__ k,
                 int* __restrict__ out, int N, long long n_words) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < N) out[q] = onehot_lane(tab3, k[q], n_words);
}

// C entries for ctypes: device pointers; each returns cudaGetLastError()
// after the launch on the caller's stream.  The wrappers in
// ops/gather_probe.py check shapes (N a multiple of 128).
extern "C" int gp_scalar(const int* tab, const int* k, int* out, int N,
                         void* stream) {
  if (N > 0)
    gp_scalar_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        tab, k, out, N);
  return (int)cudaGetLastError();
}

extern "C" int gp_scalar2(const int* tab, const int* k, int* out, int N,
                          int W, void* stream) {
  const dim3 grid((N + 127) / 128);
  const cudaStream_t st = (cudaStream_t)stream;
  if (N > 0) {
    if (W % 2 == 0 && (uintptr_t)tab % 8 == 0)
      gp_scalar2_kernel<true><<<grid, 128, 0, st>>>(tab, k, out, N, W);
    else
      gp_scalar2_kernel<false><<<grid, 128, 0, st>>>(tab, k, out, N, W);
  }
  return (int)cudaGetLastError();
}

extern "C" int gp_onehot(const int* tab3, const int* k, int* out, int N,
                         int A, void* stream) {
  if (N > 0)
    gp_onehot_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        tab3, k, out, N, (long long)A * 128);
  return (int)cudaGetLastError();
}

extern "C" int gp_take_ax0(const int* tab, const int* kk0, int* out, int R,
                           int steps, void* stream) {
  const long long n = (long long)R * 128;
  if (n > 0)
    gp_take_ax0_kernel<<<(unsigned)((n + 127) / 128), 128, 0,
                         (cudaStream_t)stream>>>(tab, kk0, out, n, steps, R);
  return (int)cudaGetLastError();
}

#else

// Host builds of the lane loops (all pointers are host memory).
extern "C" int gp_scalar_host(const int* tab, const int* k, int* out,
                              int N) {
  for (int q = 0; q < N; ++q) out[q] = scalar_lane(tab, k, q);
  return 0;
}

// the lane with both loads (pair != 0: the 8-byte one, as the card takes
// it for even W at an 8-byte aligned table)
extern "C" int gp_scalar2_host(const int* tab, const int* k, int* out, int N,
                               int W, int pair) {
  for (int q = 0; q < N; ++q)
    out[q] = pair ? scalar2_lane<true>(tab, k, q, W)
                  : scalar2_lane<false>(tab, k, q, W);
  return 0;
}

extern "C" int gp_onehot_host(const int* tab3, const int* k, int* out, int N,
                              int A) {
  for (int q = 0; q < N; ++q)
    out[q] = onehot_lane(tab3, k[q], (long long)A * 128);
  return 0;
}

extern "C" int gp_take_ax0_host(const int* tab, const int* kk0, int* out,
                                int R, int steps) {
  const long long n = (long long)R * 128;
  for (long long e = 0; e < n; ++e)
    out[e] = take_lane(tab, kk0[e], (int)(e & 127), steps, R);
  return 0;
}

#endif
