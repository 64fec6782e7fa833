// The designs of kernels 6B (gp2_take_ax0) and 6C (gp2_take_ax1) weighed
// beside the shipped ones, which the included source holds (csrc/
// line_pow.cuh's composed-map kernels with ModStep), and the designs they
// replaced, as they were.  Built only by tools/torch_take2_variants.py
// (nvcc for sm_90a, with copies of the shipped sources beside this file).
//
// take2_variant(design), n = R (axis 0) or S (axis 1):
//   0 replaced     both axes: a block a line, the line's words in shared
//                  memory, a thread a chain, each step a dependent shared
//                  load, the add and the remainder by a run-time divisor
//                  (next_k)
//   1 map_chain    both axes: the same layout with the line's map T taken
//                  once into shared memory (int32), each step k = T[k]
//   2 slab         axis 0: 8 columns a slab (one 32-byte sector of a row),
//                  8 blocks a slab, each over R / 8 rows, every block
//                  building the slab's 8 maps (16-bit, row-major, R x 16
//                  bytes) from L2 with sector-wide loads, a thread a chain,
//                  each step k = T[k]; R up to 14528
//   3 slab_pow     design 2 with the 8 maps' powers by squaring (two
//                  buffers, a block barrier a round), the states in out as
//                  line_pow.cuh's block kernel keeps them; R up to 7264
//   4 slab_cluster design 2 as a cluster of the slab's 8 blocks: each
//                  builds its own rows of the 8 maps, and after a cluster
//                  barrier copies the others' rows from their shared memory
//                  (ld.shared::cluster, 16 bytes a row), arrives on the
//                  cluster barrier, runs its chains and waits on it before
//                  it exits (a peer may still be reading); R up to 14528
//   5 block_pow    axis 1: line_pow.cuh's block kernel (pow_block_kernel
//                  with ModStep, which 6B ships past 128 words and 7A past
//                  32) at 128 words: a block a row, the 16-bit map's
//                  powers by squaring, a block barrier a round
//   6 warp_chain   axis 1: a warp a row, the row's map in 4 registers a
//                  lane as the shipped pow_row_kernel holds it, the 32
//                  steps one lookup each (the shipped kernel squares)
// A design returns cudaErrorInvalidValue for an axis or an n it does not
// take (the tool skips it there).
#include <cooperative_groups.h>

#include "gather_probe2_kernel.cu"

namespace cg = cooperative_groups;

#define SLAB 8                 // columns of a slab
#define SLAB_BLOCKS 8          // blocks of a slab

// the replaced designs' chain: kk = next_k(kk, words[kk], m), `steps`
// times
static __device__ inline int step_chain(const int* words, int kk, int steps,
                                        int m) {
  for (int s = 0; s < steps; ++s) kk = next_k(kk, words[kk], m);
  return kk;
}

// design 0 at axis 0, as gp2_take_ax0_kernel was before line_pow.cuh
__global__ void __launch_bounds__(512)
replaced_ax0_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                    int* __restrict__ out, int R, int steps) {
  extern __shared__ int col[];                   // column j, R words
  const int j = blockIdx.x;
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    col[r] = tab[(long long)r * 128 + j];
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    const long long e = (long long)r * 128 + j;
    out[e] = step_chain(col, kk0[e], steps, R);
  }
}

// design 0 at axis 1, as gp2_take_ax1_kernel was
__global__ void __launch_bounds__(128)
replaced_ax1_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                    int* __restrict__ out, int steps) {
  __shared__ int row[128];
  const long long e = (long long)blockIdx.x * 128 + threadIdx.x;
  row[threadIdx.x] = tab[e];
  __syncthreads();
  out[e] = step_chain(row, kk0[e], steps, 128);
}

// design 1: a block a line, its map once (int32), a thread a chain
template <int AX>
__global__ void __launch_bounds__(1024)
map_chain_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                 int* __restrict__ out, int S, int L, int steps) {
  extern __shared__ int t_map[];
  const int hi = AX == 0 ? S : L;
  const int x = blockIdx.x;
  for (int r = threadIdx.x; r < hi; r += blockDim.x)
    t_map[r] = next_k(r, __ldg(tab + line_elem(AX, x, r, L)), hi);
  __syncthreads();
  for (int r = threadIdx.x; r < hi; r += blockDim.x) {
    const long long e = line_elem(AX, x, r, L);
    int k = __ldg(kk0 + e);
    for (int s = 0; s < steps; ++s) k = t_map[k];
    out[e] = k;
  }
}

// the slab's 8 maps of rows [r0, r1), 16-bit, row r's 8 entries at
// m[8 r .. 8 r + 7]; a thread an entry, a warp 4 whole sectors of tab
static __device__ inline void slab_maps(const int* __restrict__ tab,
                                        uint16_t* m, int slab, int r0, int r1,
                                        int R) {
  for (int t = r0 * SLAB + threadIdx.x; t < r1 * SLAB; t += blockDim.x) {
    const int r = t / SLAB, c = t % SLAB;
    m[t] = (uint16_t)next_k(r, __ldg(tab + (long long)r * 128 + slab * SLAB +
                                     c), R);
  }
}

// rows [r0, r1) of block b of a slab: R split into SLAB_BLOCKS parts
static __device__ inline void slab_rows(int b, int R, int& r0, int& r1) {
  const int rb = (R + SLAB_BLOCKS - 1) / SLAB_BLOCKS;
  r0 = b * rb < R ? b * rb : R;
  r1 = r0 + rb < R ? r0 + rb : R;
}

// design 2
__global__ void __launch_bounds__(1024)
slab_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
            int* __restrict__ out, int R, int steps) {
  extern __shared__ uint16_t slab_sm[];
  const int slab = blockIdx.x / SLAB_BLOCKS;
  int r0, r1;
  slab_rows(blockIdx.x % SLAB_BLOCKS, R, r0, r1);
  slab_maps(tab, slab_sm, slab, 0, R, R);
  __syncthreads();
  for (int t = r0 * SLAB + threadIdx.x; t < r1 * SLAB; t += blockDim.x) {
    const int c = t % SLAB;
    const long long e = (long long)(t / SLAB) * 128 + slab * SLAB + c;
    int k = __ldg(kk0 + e);
    for (int s = 0; s < steps; ++s) k = slab_sm[k * SLAB + c];
    out[e] = k;
  }
}

// design 3
__global__ void __launch_bounds__(1024)
slab_pow_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                int* __restrict__ out, int R, int steps) {
  extern __shared__ uint16_t slab_sm[];
  uint16_t* cur = slab_sm;
  uint16_t* nxt = slab_sm + R * SLAB;
  const int slab = blockIdx.x / SLAB_BLOCKS;
  int r0, r1;
  slab_rows(blockIdx.x % SLAB_BLOCKS, R, r0, r1);
  slab_maps(tab, cur, slab, 0, R, R);
  __syncthreads();
  bool first = true;
  for (int s = steps; s; s >>= 1) {
    if (s & 1)
      for (int t = r0 * SLAB + threadIdx.x; t < r1 * SLAB; t += blockDim.x) {
        const int c = t % SLAB;
        const long long e = (long long)(t / SLAB) * 128 + slab * SLAB + c;
        out[e] = cur[(first ? __ldg(kk0 + e) : out[e]) * SLAB + c];
      }
    if (s >> 1)
      for (int t = threadIdx.x; t < R * SLAB; t += blockDim.x)
        nxt[t] = cur[cur[t] * SLAB + t % SLAB];
    first = first && !(s & 1);
    __syncthreads();
    uint16_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (first)
    for (int t = r0 * SLAB + threadIdx.x; t < r1 * SLAB; t += blockDim.x) {
      const long long e = (long long)(t / SLAB) * 128 + slab * SLAB + t % SLAB;
      out[e] = __ldg(kk0 + e);
    }
}

// design 4
__global__ void __cluster_dims__(SLAB_BLOCKS, 1, 1) __launch_bounds__(1024)
slab_cluster_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                    int* __restrict__ out, int R, int steps) {
  extern __shared__ uint4 slab_sm4[];
  uint16_t* m = reinterpret_cast<uint16_t*>(slab_sm4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int slab = blockIdx.x / SLAB_BLOCKS;
  int r0, r1;
  slab_rows(rank, R, r0, r1);
  slab_maps(tab, m, slab, r0, r1, R);
  cluster.sync();
  const int rb = (R + SLAB_BLOCKS - 1) / SLAB_BLOCKS;
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    if (r < r0 || r >= r1) {
      const uint4* peer = reinterpret_cast<const uint4*>(
          cluster.map_shared_rank(m, r / rb));
      slab_sm4[r] = peer[r];
    }
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  __syncthreads();
  for (int t = r0 * SLAB + threadIdx.x; t < r1 * SLAB; t += blockDim.x) {
    const int c = t % SLAB;
    const long long e = (long long)(t / SLAB) * 128 + slab * SLAB + c;
    int k = __ldg(kk0 + e);
    for (int s = 0; s < steps; ++s) k = m[k * SLAB + c];
    out[e] = k;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// design 6: a warp a row of [S, 128], lane l its elements l, l + 32,
// l + 64, l + 96, the 32 steps one lookup each
__global__ void __launch_bounds__(128)
warp_chain_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                  int* __restrict__ out, int S, int steps) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= S) return;                    // the whole warp
  const int lane = threadIdx.x & 31;
  const long long base = (long long)i * 128 + lane;
  int p[4], k[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    p[c] = next_k(lane + 32 * c, __ldg(tab + base + 32 * c), 128);
    k[c] = __ldg(kk0 + base + 32 * c);
  }
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int c = 0; c < 4; ++c) k[c] = lp_row_lookup(p, k[c]);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out[base + 32 * c] = k[c];
}

extern "C" int take2_variant(const int* tab, const int* kk0, int* out, int n,
                             int steps, int axis, int design, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int bad = (int)cudaErrorInvalidValue;
  if (n < 1) return (int)cudaGetLastError();
  const int S = n, L = 128;
  const int slab_blocks = 128 / SLAB * SLAB_BLOCKS;
  const int slab_rows_b = (n + SLAB_BLOCKS - 1) / SLAB_BLOCKS;
  const int slab_threads =
      slab_rows_b * SLAB < 1024 ? (slab_rows_b * SLAB + 31) / 32 * 32 : 1024;
  const void* fn = nullptr;
  size_t smem = 0;
  int rc;
  switch (design * 2 + axis) {
    case 0: {
      smem = (size_t)n * 4;
      rc = smem_opt_in((const void*)replaced_ax0_kernel, smem);
      if (rc) return rc;
      const int threads = n < 512 ? (n + 31) / 32 * 32 : 512;
      replaced_ax0_kernel<<<128, threads, smem, st>>>(tab, kk0, out, n,
                                                      steps);
      break;
    }
    case 1:
      replaced_ax1_kernel<<<n, 128, 0, st>>>(tab, kk0, out, steps);
      break;
    case 2:
    case 3: {
      const int hi = axis == 0 ? n : 128, lines = axis == 0 ? 128 : n;
      smem = (size_t)hi * 4;
      fn = axis == 0 ? (const void*)map_chain_kernel<0>
                     : (const void*)map_chain_kernel<1>;
      rc = smem_opt_in(fn, smem);
      if (rc) return rc;
      const int threads = hi < 1024 ? (hi + 31) / 32 * 32 : 1024;
      if (axis == 0)
        map_chain_kernel<0><<<lines, threads, smem, st>>>(tab, kk0, out, S, L,
                                                          steps);
      else
        map_chain_kernel<1><<<lines, threads, smem, st>>>(tab, kk0, out, S, L,
                                                          steps);
      break;
    }
    case 4:
      smem = (size_t)n * SLAB * 2;
      if (smem > 232448) return bad;
      rc = smem_opt_in((const void*)slab_kernel, smem);
      if (rc) return rc;
      slab_kernel<<<slab_blocks, slab_threads, smem, st>>>(tab, kk0, out, n,
                                                           steps);
      break;
    case 6:
      smem = (size_t)n * SLAB * 4;
      if (smem > 232448) return bad;
      rc = smem_opt_in((const void*)slab_pow_kernel, smem);
      if (rc) return rc;
      slab_pow_kernel<<<slab_blocks, slab_threads, smem, st>>>(tab, kk0, out,
                                                               n, steps);
      break;
    case 8:
      smem = (size_t)n * SLAB * 2;
      if (smem > 232448) return bad;
      rc = smem_opt_in((const void*)slab_cluster_kernel, smem);
      if (rc) return rc;
      slab_cluster_kernel<<<slab_blocks, slab_threads, smem, st>>>(
          tab, kk0, out, n, steps);
      break;
    case 11:
      pow_block_kernel<ModStep, 1><<<n, 128, 128 * 4, st>>>(tab, kk0, out, S,
                                                            L, steps);
      break;
    case 13:
      warp_chain_kernel<<<(n + 3) / 4, 128, 0, st>>>(tab, kk0, out, n, steps);
      break;
    default:
      return bad;
  }
  return (int)cudaGetLastError();
}
