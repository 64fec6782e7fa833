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
//                rows with k and the rest with 0); the add wraps in 32 bits
//                and the remainder is never negative (jnp's %).  A step of
//                column j is a fixed map of the state, T_j(k) = (k +
//                tab[k, j]) mod R, so the kernel takes the map once a
//                launch and a step is one dependent load: the same
//                function, the wrap and the sign of the remainder inside
//                the map.  Where column j's map fits in shared memory (R up
//                to 109376, take_col_smem: 16 low bits a row and a bitmap
//                of bit 16) the column design, three launches through a
//                scratch from the wrapper: take_in_kernel writes each
//                column's map and kk0 by columns (a tile of 32 x 32
//                transposed in shared memory, so both sides stay
//                coalesced); take_col_kernel, a block of 1024 threads a
//                column, copies the column's map into shared memory and
//                runs every chain of the column there, each step a 16-bit
//                and a 1-bit shared load at the state; take_out_kernel
//                writes the ends back by rows.  Past that R the design it
//                replaced (gp_take_ax0_kernel): a thread an element, j the
//                fast index, each step a load of tab and next_k.
//
// What bounds them on an H100 (3.35 TB/s at 700 W): bytes.  gp_scalar and
// gp_scalar2 move ~100 KB (k, the touched words, out), a fraction of a
// microsecond, and gp_onehot ~97 KB at N = 8192 (k, out and the touched
// words: 0.000029 ms), so a launch's own latency is all one sees;
// gp_take_ax0 moves 80.6 MB on the probe's input (kk in, kk out and the
// table words the chains touch), 0.024 ms.  Its chains are what hold it:
// each step's load depends on the step before, and on an input whose
// chains do not share a state (every row its own start) each load in
// device memory is a scattered 32-byte sector from a 40 MB table, 160 M of
// them at R = 78208 and 16 steps.  The column design keeps every load of
// a chain in its SM's shared memory and moves tab, kk and out in
// coalesced passes (about 320 MB in all, the scratch included).
//
// gp_scalar and gp_scalar2 load through the read-only path (__ldg).
//
// The same source compiles as host C++ (no __CUDACC__), exposing the lane
// loops of all four as *_host entries, so the CPU tests check their
// arithmetic without a card.
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include "smem.cuh"
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

// element e = r * 128 + j of gp_take_ax0, step by step
static GP_HD inline int take_lane(const int* __restrict__ tab, int kk, int j,
                                  int steps, int R) {
  for (int s = 0; s < steps; ++s)
    kk = next_k(kk, GP_LDG(tab + (long long)kk * 128 + j), R);
  return kk;
}

// ---- gp_take_ax0's designs ----

#define TAKE_SMEM_MAX 232448  // bytes of shared memory a block may opt into
#define TAKE_COL_P 1024       // take_col_kernel: threads of a column's block
#define TAKE_COL_E 4          // ... chains a thread has in flight

// The column design's scratch (from the wrapper), at Rp = R rounded up to
// 32: kk0 by columns (kkt, [128, Rp] words), the chains' ends by columns
// (outt, [128, Rp]), each column's map as its 16 low bits (lo, [128, Rp]
// 16-bit) and a bitmap of its bit 16 (hib, [128, Rp / 32] words): 324 Rp
// words in all.
struct TakeScratch {
  int* kkt;
  int* outt;
  uint16_t* lo;
  uint32_t* hib;
  int Rp;
};

static GP_HD inline TakeScratch take_scratch(int* base, int R) {
  TakeScratch t;
  t.Rp = (R + 31) / 32 * 32;
  t.kkt = base;
  t.outt = base + (long long)128 * t.Rp;
  t.lo = reinterpret_cast<uint16_t*>(base + (long long)256 * t.Rp);
  t.hib = reinterpret_cast<uint32_t*>(base + (long long)320 * t.Rp);
  return t;
}

// shared memory of take_col_kernel: the column's lo (2 Rp bytes), then its
// hib (Rp / 8 bytes)
static inline size_t take_col_smem(int R) {
  const size_t rp = (size_t)(R + 31) / 32 * 32;
  return 2 * rp + rp / 8;
}

// The int32 words of gp_take_ax0's scratch at R rows, which the wrapper
// allocates: take_scratch's where the column's map fits a block's shared
// memory (R from 1 to 109376), else 0 (the C entry then takes the design
// the column design replaced, which needs none).  Both builds export it,
// so the design is chosen here alone.
extern "C" long long gp_take_ax0_scratch_words(int R) {
  if (R < 1 || take_col_smem(R) > TAKE_SMEM_MAX) return 0;
  return (long long)324 * ((R + 31) / 32 * 32);
}

// the column's map at state k: its 16 low bits and bit 16 (R <= 2^17)
static GP_HD inline int take_col_map(const uint16_t* lo, const uint32_t* hib,
                                     int k) {
  return (int)lo[k] | (int)((hib[k >> 5] >> (k & 31)) & 1u) << 16;
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

// Pass 1, a block a tile of 32 rows x 32 columns (eight warps, a lane a
// column on the way in and a row on the way out): T = (r + tab[r, c]) mod
// R into lo and hib (bit 16 of 32 rows by one ballot), kk0 into kkt, both
// by columns; rows past R give 0.
__global__ void __launch_bounds__(256)
take_in_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
               int* __restrict__ scratch, int R) {
  __shared__ int tt[32][33], tk[32][33];
  const TakeScratch sc = take_scratch(scratch, R);
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = w; i < 32; i += 8) {
    const int r = r0 + i, e = r * 128 + c0 + lane;
    tt[i][lane] = r < R ? next_k(r, __ldg(tab + e), R) : 0;
    tk[i][lane] = r < R ? __ldg(kk0 + e) : 0;
  }
  __syncthreads();
  for (int i = w; i < 32; i += 8) {
    const long long at = (long long)(c0 + i) * sc.Rp + r0 + lane;
    const int v = tt[lane][i];
    sc.lo[at] = (uint16_t)v;
    const uint32_t b = __ballot_sync(0xffffffffu, (v >> 16) & 1);
    if (lane == 0) sc.hib[(long long)(c0 + i) * (sc.Rp / 32) + r0 / 32] = b;
    sc.kkt[at] = tk[lane][i];
  }
}

// Pass 2, one block a column j: its lo and hib copied into shared memory
// (16 bytes a thread), then every chain of the column from kkt, TAKE_COL_E
// a thread in flight, each step take_col_map, the ends into outt.
__global__ void __launch_bounds__(TAKE_COL_P, 1)
take_col_kernel(int* __restrict__ scratch, int R, int steps) {
  extern __shared__ uint4 take_sm[];
  const TakeScratch sc = take_scratch(scratch, R);
  const int j = blockIdx.x, Rp = sc.Rp;
  uint16_t* lo = reinterpret_cast<uint16_t*>(take_sm);
  uint32_t* hib = reinterpret_cast<uint32_t*>(lo + Rp);
  const uint4* lo_g = reinterpret_cast<const uint4*>(sc.lo + (long long)j * Rp);
  for (int i = threadIdx.x; i < Rp / 8; i += TAKE_COL_P) take_sm[i] = lo_g[i];
  const uint32_t* hib_g = sc.hib + (long long)j * (Rp / 32);
  for (int i = threadIdx.x; i < Rp / 32; i += TAKE_COL_P) hib[i] = hib_g[i];
  __syncthreads();
  const int* kkt = sc.kkt + (long long)j * Rp;
  int* outt = sc.outt + (long long)j * Rp;
  for (int r0 = threadIdx.x; r0 < Rp; r0 += TAKE_COL_P * TAKE_COL_E) {
    int k[TAKE_COL_E];
#pragma unroll
    for (int c = 0; c < TAKE_COL_E; ++c) {
      const int r = r0 + c * TAKE_COL_P;
      k[c] = r < Rp ? kkt[r] : 0;
    }
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int c = 0; c < TAKE_COL_E; ++c) k[c] = take_col_map(lo, hib, k[c]);
    }
#pragma unroll
    for (int c = 0; c < TAKE_COL_E; ++c) {
      const int r = r0 + c * TAKE_COL_P;
      if (r < Rp) outt[r] = k[c];
    }
  }
}

// Pass 3, a block a tile of 32 rows x 32 columns: outt back by rows.
__global__ void __launch_bounds__(256)
take_out_kernel(const int* __restrict__ scratch, int* __restrict__ out,
                int R) {
  __shared__ int t[32][33];
  const TakeScratch sc = take_scratch(const_cast<int*>(scratch), R);
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = w; i < 32; i += 8)
    t[i][lane] = sc.outt[(long long)(c0 + i) * sc.Rp + r0 + lane];
  __syncthreads();
  for (int i = w; i < 32; i += 8) {
    const int r = r0 + i;
    if (r < R) out[r * 128 + c0 + lane] = t[lane][i];
  }
}

// Past the column design's R: a thread an element, j the fast index (the
// design the column design replaced).
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

// where gp_take_ax0_scratch_words(R) is not 0 the column design, its three
// passes through `scratch` (that many words; a null scratch there is
// refused), else gp_take_ax0_kernel (scratch unused)
extern "C" int gp_take_ax0(const int* tab, const int* kk0, int* out,
                           int* scratch, int R, int steps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (R < 1) return (int)cudaGetLastError();
  if (gp_take_ax0_scratch_words(R)) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    const size_t smem = take_col_smem(R);
    const int rc = smem_opt_in((const void*)take_col_kernel, smem);
    if (rc) return rc;
    const dim3 tiles((R + 31) / 32, 4);
    take_in_kernel<<<tiles, 256, 0, st>>>(tab, kk0, scratch, R);
    take_col_kernel<<<128, TAKE_COL_P, smem, st>>>(scratch, R, steps);
    take_out_kernel<<<tiles, 256, 0, st>>>(scratch, out, R);
  } else {
    const long long n = (long long)R * 128;
    gp_take_ax0_kernel<<<(unsigned)((n + 127) / 128), 128, 0, st>>>(
        tab, kk0, out, n, steps, R);
  }
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

// gp_take_ax0's column design as the card runs it: its three passes
// through a scratch laid out as the card's, each element written as the
// card's kernels write it (the map and kk0 by columns, every chain of a
// column through take_col_map, the ends back by rows).  Returns 1 at an R
// where gp_take_ax0_scratch_words is 0 (the C entry then takes
// gp_take_ax0_kernel, whose lane gp_take_ax0_host runs), 2 when the
// scratch cannot be allocated.
extern "C" int gp_take_ax0_lanes_host(const int* tab, const int* kk0, int* out,
                                      int R, int steps) {
  const long long words = gp_take_ax0_scratch_words(R);
  if (!words) return 1;
  int* base = (int*)calloc((size_t)words, 4);
  if (!base) return 2;
  const TakeScratch sc = take_scratch(base, R);
  for (int c = 0; c < 128; ++c)                       // pass 1
    for (int r = 0; r < sc.Rp; ++r) {
      const long long at = (long long)c * sc.Rp + r;
      const int v = r < R ? next_k(r, tab[r * 128 + c], R) : 0;
      sc.lo[at] = (uint16_t)v;
      sc.hib[(long long)c * (sc.Rp / 32) + r / 32] |=
          (uint32_t)((v >> 16) & 1) << (r & 31);
      sc.kkt[at] = r < R ? kk0[r * 128 + c] : 0;
    }
  for (int j = 0; j < 128; ++j) {                     // pass 2
    const uint16_t* lo = sc.lo + (long long)j * sc.Rp;
    const uint32_t* hib = sc.hib + (long long)j * (sc.Rp / 32);
    for (int r = 0; r < sc.Rp; ++r) {
      int k = sc.kkt[(long long)j * sc.Rp + r];
      for (int s = 0; s < steps; ++s) k = take_col_map(lo, hib, k);
      sc.outt[(long long)j * sc.Rp + r] = k;
    }
  }
  for (int r = 0; r < R; ++r)                         // pass 3
    for (int c = 0; c < 128; ++c)
      out[r * 128 + c] = sc.outt[(long long)c * sc.Rp + r];
  free(base);
  return 0;
}

#endif
