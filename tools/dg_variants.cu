// The designs of kernels 5d (gp_take_ax0) and 7A (gp3_dg) weighed beside
// the shipped ones, which the two included sources hold, and 7A's design
// it replaced, as it was (5d's, gp_take_ax0_kernel, still ships past the
// column design's R).  Built only by tools/torch_dg_variants.py (nvcc for
// sm_90a, with copies of the shipped sources beside this file).
//
// 5d, take_variant(design):
//   0 replaced     gp_take_ax0_kernel at any R: a thread an element, j the
//                  fast index, each step a load of tab and the remainder by
//                  a run-time R (next_k: C's %, then the sign fix)
//   1 map_rows     the map pass (T[r, j] = (r + tab[r, j]) mod R into the
//                  scratch s0, int4 a thread), then a thread an element,
//                  each step k = T[k, j]
//   2 magic_rows   no map: a thread an element, each step a load of tab
//                  and take_next (the invariant divisor)
//   3 map_cols     the map pass, then design 4's tile layout (a warp 32
//                  rows of one column, kk0 and out staged through shared
//                  memory) with each step k = T[k, j]
//   4 magic_cols   take_tile_kernel: a block a tile of 32 rows, a warp 32
//                  rows of one column, each step a load of tab and
//                  take_next (the invariant divisor)
//   5 col_strided  the column design with no staging: a block a column
//                  builds its map in shared memory (16 + 1 bits) from the
//                  column of tab and runs its chains, reading kk0 and
//                  writing out down the column (a sector a row); R up to
//                  109386
//   6 double       the map pass into s0, then T^(2^b) by squaring (s0 and
//                  s1 in turns), the state taking T^(2^b) for each set bit
//                  of steps (one launch a round: the apply and the square
//                  read the same power); 0 steps copies kk0
//   7 map          the map pass alone (into s0; out untouched)
// 7A, dg_variant(design):
//   0 replaced     a block a line, the line's words in shared memory, a
//                  thread a row, each step a dependent shared load, the add
//                  and the clip
//   1 chain        the same with the clip taken once a launch: the line's
//                  map T in shared memory, each step k = T[k]
//   2 double_block the shipped block design (pow_block_kernel of
//                  csrc/line_pow.cuh with ClipStep) at any hi
//   3 double_warp  the shipped warp design (pow_warp_kernel), hi <= 32
// chase: `steps` dependent loads k = t[k] by one warp (a permutation of n
// words in shared memory or in device memory), timed by clock64 inside.
#include "gather_probe_kernel.cu"
#include "gather_probe3_kernel.cu"

// ---- 5d ----

#define TAKE_TILE_R 32        // designs 3 and 4: rows of a tile (a warp)
#define TAKE_TILE_P 256       // ... threads of a tile's block
#define TAKE_TILE_E (128 / (TAKE_TILE_P / 32))  // ... chains a thread

static __device__ inline uint32_t umin32(uint32_t a, uint32_t b) {
  return a < b ? a : b;
}

// The remainder by an invariant R: m = floor((2^(32+s) - 1) / R) with s =
// floor(log2 R) fits 32 bits, and for u < 2^32, umulhi(u, m) >> s is
// floor(u / R) or one less; c = 2^31 mod R.
struct TakeMod {
  uint32_t R, m, s, c;
};

static inline TakeMod take_mod(int R) {
  uint32_t s = 0;
  while ((2u << s) <= (uint32_t)R && s < 31) ++s;
  TakeMod f;
  f.R = (uint32_t)R;
  f.s = s;
  f.m = (uint32_t)((((uint64_t)1 << (32 + s)) - 1) / (uint32_t)R);
  f.c = (uint32_t)(((uint64_t)1 << 31) % (uint32_t)R);
  return f;
}

// next_k by the invariant divisor: u = v + 2^31 as unsigned (v the wrapped
// sum), u mod R by one multiply-high and at most one subtraction, then
// v mod R = (u mod R - c) mod R, an unsigned minimum each (the operand
// below 0 wraps past every value in [0, R))
static __device__ inline int take_next(int k, int g, const TakeMod& f) {
  const uint32_t u = (uint32_t)k + (uint32_t)g + 0x80000000u;
  const uint32_t q = __umulhi(u, f.m) >> f.s;
  uint32_t r = u - q * f.R;
  r = umin32(r, r - f.R);
  const uint32_t t = r - f.c;
  return (int)umin32(t, t + f.R);
}

// T[r, j] = (r + tab[r, j]) mod R, four words a thread
__global__ void __launch_bounds__(256)
take_map_kernel(const int* __restrict__ tab, int* __restrict__ T, int n4,
                int R) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n4) {
    const int4 g = __ldg(reinterpret_cast<const int4*>(tab) + i);
    const int r = i >> 5;
    int4 t;
    t.x = next_k(r, g.x, R);
    t.y = next_k(r, g.y, R);
    t.z = next_k(r, g.z, R);
    t.w = next_k(r, g.w, R);
    reinterpret_cast<int4*>(T)[i] = t;
  }
}

__global__ void __launch_bounds__(256)
take_map_rows_kernel(const int* __restrict__ T, const int* __restrict__ kk0,
                     int* __restrict__ out, int n, int steps) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e < n) {
    int k = kk0[e];
    const int* col = T + (e & 127);
    for (int s = 0; s < steps; ++s) k = __ldg(col + k * 128);
    out[e] = k;
  }
}

__global__ void __launch_bounds__(256)
take_magic_rows_kernel(const int* __restrict__ tab,
                       const int* __restrict__ kk0, int* __restrict__ out,
                       int n, int steps, TakeMod f) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e < n) {
    int k = kk0[e];
    const int* col = tab + (e & 127);
    for (int s = 0; s < steps; ++s) k = take_next(k, __ldg(col + k * 128), f);
    out[e] = k;
  }
}

// the column design with no staging (design 5): T_j built in shared
// memory from the column of tab (bit 16 of a warp's 32 rows by one
// ballot), then every chain of the column, kk0 and out down the column
__global__ void __launch_bounds__(TAKE_COL_P, 1)
take_col_strided_kernel(const int* __restrict__ tab,
                        const int* __restrict__ kk0, int* __restrict__ out,
                        int R, int steps) {
  extern __shared__ uint32_t strided_sm[];
  uint32_t* hib = strided_sm;
  uint16_t* lo = reinterpret_cast<uint16_t*>(strided_sm + (R + 31) / 32);
  const int j = blockIdx.x;
  for (int r0 = 0; r0 < R; r0 += TAKE_COL_P) {
    const int r = r0 + threadIdx.x;
    const int v = r < R ? next_k(r, __ldg(tab + r * 128 + j), R) : 0;
    if (r < R) lo[r] = (uint16_t)v;
    const uint32_t b = __ballot_sync(0xffffffffu, (v >> 16) & 1);
    if ((threadIdx.x & 31) == 0 && r < R) hib[r >> 5] = b;
  }
  __syncthreads();
  for (int r0 = threadIdx.x; r0 < R; r0 += TAKE_COL_P * TAKE_COL_E) {
    int k[TAKE_COL_E];
#pragma unroll
    for (int c = 0; c < TAKE_COL_E; ++c) {
      const int r = r0 + c * TAKE_COL_P;
      k[c] = r < R ? __ldg(kk0 + r * 128 + j) : 0;
    }
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int c = 0; c < TAKE_COL_E; ++c) k[c] = take_col_map(lo, hib, k[c]);
    }
#pragma unroll
    for (int c = 0; c < TAKE_COL_E; ++c) {
      const int r = r0 + c * TAKE_COL_P;
      if (r < R) out[r * 128 + j] = k[c];
    }
  }
}

// design 3: take_tile_kernel's layout, each step k = T[k, j]
__global__ void __launch_bounds__(TAKE_TILE_P)
take_map_cols_kernel(const int* __restrict__ T, const int* __restrict__ kk0,
                     int* __restrict__ out, int R, int steps) {
  __shared__ int tile[TAKE_TILE_R][129];
  const int r0 = blockIdx.x * TAKE_TILE_R;
  for (int e = threadIdx.x; e < TAKE_TILE_R * 128; e += TAKE_TILE_P) {
    const int i = e >> 7, j = e & 127;
    tile[i][j] = r0 + i < R ? __ldg(kk0 + (r0 + i) * 128 + j) : 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int k[TAKE_TILE_E];
#pragma unroll
  for (int c = 0; c < TAKE_TILE_E; ++c) k[c] = tile[lane][w + 8 * c];
  const int* col = T + w;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < TAKE_TILE_E; ++c)
      k[c] = __ldg(col + k[c] * 128 + 8 * c);
  }
#pragma unroll
  for (int c = 0; c < TAKE_TILE_E; ++c) tile[lane][w + 8 * c] = k[c];
  __syncthreads();
  for (int e = threadIdx.x; e < TAKE_TILE_R * 128; e += TAKE_TILE_P) {
    const int i = e >> 7, j = e & 127;
    if (r0 + i < R) out[(r0 + i) * 128 + j] = tile[i][j];
  }
}

// design 4: a block a tile of TAKE_TILE_R rows, kk0's tile staged in
// shared memory (a row padded to 129 words, so a warp reading down a
// column hits 32 banks), warp w takes columns w, w + 8, ..., a lane a row,
// each thread its TAKE_TILE_E chains, every step a load of tab and
// take_next
__global__ void __launch_bounds__(TAKE_TILE_P)
take_tile_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                 int* __restrict__ out, int R, int steps, TakeMod f) {
  __shared__ int tile[TAKE_TILE_R][129];
  const int r0 = blockIdx.x * TAKE_TILE_R;
  for (int e = threadIdx.x; e < TAKE_TILE_R * 128; e += TAKE_TILE_P) {
    const int i = e >> 7, j = e & 127;
    tile[i][j] = r0 + i < R ? __ldg(kk0 + (r0 + i) * 128 + j) : 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int k[TAKE_TILE_E];
#pragma unroll
  for (int c = 0; c < TAKE_TILE_E; ++c) k[c] = tile[lane][w + 8 * c];
  const int* col = tab + w;
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < TAKE_TILE_E; ++c)
      k[c] = take_next(k[c], __ldg(col + k[c] * 128 + 8 * c), f);
  }
#pragma unroll
  for (int c = 0; c < TAKE_TILE_E; ++c) tile[lane][w + 8 * c] = k[c];
  __syncthreads();
  for (int e = threadIdx.x; e < TAKE_TILE_R * 128; e += TAKE_TILE_P) {
    const int i = e >> 7, j = e & 127;
    if (r0 + i < R) out[(r0 + i) * 128 + j] = tile[i][j];
  }
}

// one round of the doubling: sout = P[sin] where apply (sin may be sout:
// each element reads and writes only its own), Pn = P[P] where square
__global__ void __launch_bounds__(256)
take_double_kernel(const int* __restrict__ P, int* __restrict__ Pn,
                   const int* sin, int* sout, int n, int apply, int square) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e < n) {
    const int* col = P + (e & 127);
    if (apply) sout[e] = __ldg(col + sin[e] * 128);
    if (square) Pn[e] = __ldg(col + __ldg(P + e) * 128);
  }
}

extern "C" int take_variant(const int* tab, const int* kk0, int* out, int* s0,
                            int* s1, int R, int steps, int design,
                            void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (R < 1) return (int)cudaGetLastError();
  const int n = R * 128, g256 = (n + 255) / 256;
  const int tiles = (R + TAKE_TILE_R - 1) / TAKE_TILE_R;
  if (design == 1 || design == 3 || design == 6 || design == 7)
    take_map_kernel<<<(n / 4 + 255) / 256, 256, 0, st>>>(tab, s0, n / 4, R);
  switch (design) {
    case 0:
      gp_take_ax0_kernel<<<(n + 127) / 128, 128, 0, st>>>(tab, kk0, out, n,
                                                          steps, R);
      break;
    case 1:
      take_map_rows_kernel<<<g256, 256, 0, st>>>(s0, kk0, out, n, steps);
      break;
    case 2:
      take_magic_rows_kernel<<<g256, 256, 0, st>>>(tab, kk0, out, n, steps,
                                                   take_mod(R));
      break;
    case 3:
      take_map_cols_kernel<<<tiles, TAKE_TILE_P, 0, st>>>(s0, kk0, out, R,
                                                          steps);
      break;
    case 4:
      take_tile_kernel<<<tiles, TAKE_TILE_P, 0, st>>>(tab, kk0, out, R, steps,
                                                      take_mod(R));
      break;
    case 5: {
      const size_t smem = (size_t)4 * ((R + 31) / 32) + (size_t)2 * R;
      if (smem > TAKE_SMEM_MAX) return (int)cudaErrorInvalidValue;
      const int rc = smem_opt_in((const void*)take_col_strided_kernel, smem);
      if (rc) return rc;
      take_col_strided_kernel<<<128, TAKE_COL_P, smem, st>>>(tab, kk0, out, R,
                                                             steps);
      break;
    }
    case 6: {
      if (steps == 0)
        return (int)cudaMemcpyAsync(out, kk0, (size_t)n * 4,
                                    cudaMemcpyDeviceToDevice, st);
      const int* sin = kk0;
      int* cur = s0;
      int* nxt = s1;
      for (int s = steps; s; s >>= 1) {
        const int apply = s & 1, square = (s >> 1) != 0;
        take_double_kernel<<<g256, 256, 0, st>>>(cur, nxt, sin, out, n, apply,
                                                 square);
        if (apply) sin = out;
        if (square) {
          int* t = cur;
          cur = nxt;
          nxt = t;
        }
      }
      break;
    }
    case 7:
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- 7A ----

template <int AX>
__global__ void __launch_bounds__(512)
dg_replaced_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
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

// the replaced design's layout with the line's map T in shared memory
template <int AX>
__global__ void __launch_bounds__(512)
dg_chain_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                int* __restrict__ out, int S, int L, int steps) {
  extern __shared__ int t[];
  const int hi = AX == 0 ? S : L;
  const int x = blockIdx.x;
  for (int r = threadIdx.x; r < hi; r += blockDim.x)
    t[r] = clip_step(r, __ldg(tab + line_elem(AX, x, r, L)), hi);
  __syncthreads();
  for (int r = threadIdx.x; r < hi; r += blockDim.x) {
    const long long e = line_elem(AX, x, r, L);
    int k = __ldg(kk0 + e);
    for (int s = 0; s < steps; ++s) k = t[k];
    out[e] = k;
  }
}

extern "C" int dg_variant(const int* tab, const int* kk0, int* out, int S,
                          int L, int steps, int axis, int design,
                          void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int hi = axis == 0 ? S : L, lines = axis == 0 ? L : S;
  if (lines < 1 || hi < 1) return (int)cudaGetLastError();
  const void* fn;
  size_t smem;
  int threads;
  switch (design) {
    case 0:
    case 1:
      smem = (size_t)hi * 4;
      threads = hi < 512 ? (hi + 31) / 32 * 32 : 512;
      fn = design == 0 ? (axis == 0 ? (const void*)dg_replaced_kernel<0>
                                    : (const void*)dg_replaced_kernel<1>)
                       : (axis == 0 ? (const void*)dg_chain_kernel<0>
                                    : (const void*)dg_chain_kernel<1>);
      break;
    case 2:
      smem = (size_t)hi * 4;
      threads = hi < 1024 ? (hi + 31) / 32 * 32 : 1024;
      fn = axis == 0 ? (const void*)pow_block_kernel<ClipStep, 0>
                     : (const void*)pow_block_kernel<ClipStep, 1>;
      break;
    case 3:
      if (hi > 32) return (int)cudaErrorInvalidValue;
      return gp3_dg(tab, kk0, out, S, L, steps, axis, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
  const int rc = smem_opt_in(fn, smem);
  if (rc) return rc;
  void* args[] = {(void*)&tab, (void*)&kk0, (void*)&out, (void*)&S,
                  (void*)&L, (void*)&steps};
  const cudaError_t e =
      cudaLaunchKernel(fn, dim3(lines), dim3(threads), args, smem, st);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// ---- the chain's latency a step ----

__global__ void chase_kernel(const int* __restrict__ t, int n, int steps,
                             int shared, long long* cyc, int* out) {
  extern __shared__ int ch[];
  if (shared) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) ch[i] = t[i];
    __syncthreads();
  }
  int k = (int)((threadIdx.x * 97u) % (unsigned)n);
  const long long c0 = clock64();
  if (shared) {
    for (int s = 0; s < steps; ++s) k = ch[k];
  } else {
    for (int s = 0; s < steps; ++s) k = t[k];
  }
  const long long c1 = clock64();
  out[threadIdx.x] = k;
  if (threadIdx.x == 0) *cyc = c1 - c0;
}

extern "C" int chase(const int* t, int n, int steps, int shared,
                     long long* cyc, int* out, void* stream) {
  const size_t smem = shared ? (size_t)n * 4 : 0;
  const int rc = smem_opt_in((const void*)chase_kernel, smem);
  if (rc) return rc;
  chase_kernel<<<1, 32, smem, (cudaStream_t)stream>>>(t, n, steps, shared, cyc,
                                                      out);
  return (int)cudaGetLastError();
}
