// The gather-strategy probe: four ways for an in-kernel FM scan to look up
// a table row per lane, each priced on its own.  They replace the four TPU
// probe kernels of tools/pl_gather_probe.py, one __global__ each:
//
//   gp_scalar    (kernel_scalar, :65)   out[i,j] = tab[k[i,j], j], the pass
//                repeated `steps` times; tab [R,128], k and out [N/128,128].
//                On Hopper: one thread per lane, an uncoalesced 4-byte load
//                per lane from L2 (the 40 MB table of the probe stays there
//                after the first pass).
//   gp_scalar2   (kernel_scalarw, :93)  out = tab[k,0] + tab[k,1], the add
//                wrapping in 32 bits; tab [R,W].  A short row read: one
//                8-byte load per lane.
//   gp_onehot    (kernel_mm, :120)      out = int(bf16(tab3[k>>7, k&127])),
//                0 where k>>7 is outside [0, A); tab3 [A,128].  The strategy
//                the TPU probe prices is the matrix unit: a one-hot [N, A]
//                times the bf16 table [A,128], float32 sums, then column
//                k&127 picked per query.  Here the one-hot tile (bf16) is
//                built in shared memory and multiplied on the tensor cores
//                (nvcuda::wmma 16x16x16, bf16 in, float32 sums) against the
//                table tile, converted int32 -> float -> bf16 with
//                __float2bfloat16_rn (XLA's rounding for |v| < 2^24) as it is
//                staged; the column is picked in the epilogue.  The depth A
//                is padded with zero rows to a multiple of 16.  A direct
//                gather would be gp_scalar again and would price nothing.
//                Not Triton: the product must stay a one-hot tile in shared
//                memory fed to the tensor cores with the pick fused after
//                it, and this build has a plain C interface (nvcc + ctypes)
//                that the three lane loops share and the CPU tests compile.
//   gp_take_ax0  (kernel_dg, :151)      a chained take_along_axis along axis
//                0 over the whole table: kk = (kk + tab[kk, j]) mod R,
//                `steps` times, on [R,128] (the probe seeds the first N/128
//                rows with k and the rest with 0).  One thread per element,
//                j the fast index, so a warp's first loads read 32 adjacent
//                words of a row; the add wraps in 32 bits and the remainder
//                is never negative (jnp's %).
//
// What bounds them on an H100 (3.35 TB/s, 989 TFLOP/s bf16 at 700 W):
// gp_scalar and gp_scalar2 move ~100 KB (k, the touched words, out), a
// fraction of a microsecond, so a launch's own latency is all one sees;
// gp_onehot is 2 x N x 624 x 128 tensor-core operations, ~1.3 us at N =
// 8192, and re-reads the 312 KB table in every block from L2; gp_take_ax0
// moves 120 MB (table, kk in, kk out), ~0.036 ms.
//
// gp_scalar and gp_scalar2 must issue every pass's loads, as the TPU
// kernel's loop does: they load through volatile PTX (ld.volatile) with a
// memory clobber, which nvcc may neither hoist out of the loop nor merge.
//
// The same source compiles as host C++ (no __CUDACC__), exposing the lane
// loops of gp_scalar, gp_scalar2 and gp_take_ax0 as *_host entries, so the
// CPU tests check their arithmetic without a card.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#define GP_HD __device__
#define GP_LDG(p) __ldg(p)

static __device__ __forceinline__ int ld_volatile(const int* p) {
  int v;
  asm volatile("ld.volatile.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

static __device__ __forceinline__ void ld_volatile2(const int* p, int& a,
                                                    int& b) {
  asm volatile("ld.volatile.global.v2.s32 {%0, %1}, [%2];"
               : "=r"(a), "=r"(b) : "l"(p) : "memory");
}
#else
#define GP_HD
#define GP_LDG(p) (*(p))

static inline int ld_volatile(const int* p) {
  return *(const volatile int*)p;
}

static inline void ld_volatile2(const int* p, int& a, int& b) {
  a = ((const volatile int*)p)[0];
  b = ((const volatile int*)p)[1];
}
#endif

// lane q of gp_scalar: row k[q], column q & 127 of the 128-column table
static GP_HD inline void scalar_lane(const int* tab, const int* k, int* out,
                                     int q, int steps) {
  const int j = q & 127;
  for (int s = 0; s < steps; ++s) {
    const int r = ld_volatile(k + q);
    out[q] = ld_volatile(tab + (long long)r * 128 + j);
  }
}

// lane q of gp_scalar2: words 0 and 1 of row k[q] of the W-word table
static GP_HD inline void scalar2_lane(const int* tab, const int* k, int* out,
                                      int q, int W, int steps) {
  for (int s = 0; s < steps; ++s) {
    const int r = ld_volatile(k + q);
    int a, b;
    ld_volatile2(tab + (long long)r * W, a, b);
    out[q] = (int)((uint32_t)a + (uint32_t)b);
  }
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

#ifdef __CUDACC__

__global__ void __launch_bounds__(128)
gp_scalar_kernel(const int* tab, const int* k, int* out, int N, int steps) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < N) scalar_lane(tab, k, out, q, steps);
}

__global__ void __launch_bounds__(128)
gp_scalar2_kernel(const int* tab, const int* k, int* out, int N, int W,
                  int steps) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < N) scalar2_lane(tab, k, out, q, W, steps);
}

__global__ void __launch_bounds__(128)
gp_take_ax0_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                   int* __restrict__ out, long long n, int steps, int R) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) out[e] = take_lane(tab, kk0[e], (int)(e & 127), steps, R);
}

// gp_onehot: a block of 4 warps takes OH_BM = 64 queries (16 per warp, one
// wmma row tile each) and walks the table depth in tiles of 16 rows; a
// warp keeps its 16 x 128 float32 sums in 8 accumulator fragments.
namespace {
constexpr int OH_BM = 64, OH_BK = 16, OH_COLS = 128, OH_LDB = OH_COLS + 8;
}

__global__ void __launch_bounds__(128)
gp_onehot_kernel(const int* __restrict__ tab3, const int* __restrict__ k,
                 int* __restrict__ out, int A) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 As[OH_BM * OH_BK];
  __shared__ __align__(32) __nv_bfloat16 Bs[OH_BK * OH_LDB];
  __shared__ __align__(32) float Cs[OH_BM * OH_COLS];
  __shared__ int hi_s[OH_BM];
  const int t = threadIdx.x, w = t >> 5;
  const int row0 = blockIdx.x * OH_BM;
  if (t < OH_BM) hi_s[t] = k[row0 + t] >> 7;      // arithmetic shift
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[OH_COLS / 16];
  for (int n = 0; n < OH_COLS / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
  const __nv_bfloat16 one = __float2bfloat16_rn(1.0f);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  __syncthreads();
  for (int a0 = 0; a0 < A; a0 += OH_BK) {
    // the table tile: 16 rows x 128 columns, int32 -> float -> bf16; rows
    // past A are the zero padding
    for (int e = t; e < OH_BK * OH_COLS; e += blockDim.x) {
      const int r = e >> 7, c = e & 127, a = a0 + r;
      const int v = a < A ? tab3[(long long)a * OH_COLS + c] : 0;
      Bs[r * OH_LDB + c] = __float2bfloat16_rn((float)v);
    }
    // the one-hot tile: 64 queries x 16 table rows
    for (int e = t; e < OH_BM * OH_BK; e += blockDim.x)
      As[e] = hi_s[e >> 4] == a0 + (e & 15) ? one : zero;
    __syncthreads();
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major> fa;
    wmma::load_matrix_sync(fa, As + w * 16 * OH_BK, OH_BK);
    for (int n = 0; n < OH_COLS / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fb, Bs + n * 16, OH_LDB);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
    __syncthreads();
  }
  for (int n = 0; n < OH_COLS / 16; ++n)
    wmma::store_matrix_sync(Cs + w * 16 * OH_COLS + n * 16, acc[n], OH_COLS,
                            wmma::mem_row_major);
  __syncthreads();
  // epilogue: the pick of column k & 127; float -> int truncates, as
  // XLA's astype(int32)
  if (t < OH_BM)
    out[row0 + t] = (int)Cs[t * OH_COLS + (k[row0 + t] & 127)];
}

// C entries for ctypes: device pointers; each returns cudaGetLastError()
// after the launch on the caller's stream.  The wrappers in
// ops/gather_probe.py check shapes (N a multiple of 128).
extern "C" int gp_scalar(const int* tab, const int* k, int* out, int N,
                         int steps, void* stream) {
  if (N > 0)
    gp_scalar_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        tab, k, out, N, steps);
  return (int)cudaGetLastError();
}

extern "C" int gp_scalar2(const int* tab, const int* k, int* out, int N,
                          int W, int steps, void* stream) {
  if (N > 0)
    gp_scalar2_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        tab, k, out, N, W, steps);
  return (int)cudaGetLastError();
}

extern "C" int gp_onehot(const int* tab3, const int* k, int* out, int N,
                         int A, void* stream) {
  if (N > 0)
    gp_onehot_kernel<<<N / OH_BM, 128, 0, (cudaStream_t)stream>>>(
        tab3, k, out, A);
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
extern "C" int gp_scalar_host(const int* tab, const int* k, int* out, int N,
                              int steps) {
  for (int q = 0; q < N; ++q) scalar_lane(tab, k, out, q, steps);
  return 0;
}

extern "C" int gp_scalar2_host(const int* tab, const int* k, int* out, int N,
                               int W, int steps) {
  for (int q = 0; q < N; ++q) scalar2_lane(tab, k, out, q, W, steps);
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
