// The designs of kernels #3 (fm_chain_words, fm_chain_rows) and 7D
// (gp3_mm) weighed beside the shipped ones, which the two included sources
// hold, and the designs they replaced, as they were.  Built only by
// tools/torch_fm_mm_variants.py (nvcc for sm_90a, with copies of the
// shipped sources beside this file).
//
// #3, fm_variant(design) on (cmb, k0, out, sums, N, W, steps, seq_len):
//   0 replaced_words  the design replaced: a thread a lane in blocks of 128,
//                     each step the row's W words by 4-byte loads and the
//                     remainder by C's % and a sign fix
//   1 replaced_rows   the same, the row in 16-byte loads
//   2 l2_table        the sums as a step table: S mod seq_len where k + S
//                     cannot wrap (a step an add and a conditional
//                     subtract), S - 2^31 (negative) where it can (the exact
//                     remainder); the chain from L2 as the shipped one
//   3 l2_x1, 4 l2_x2  the shipped pass and chain with a lane every thread
//                     or every 2 threads (32 or 16 lanes a warp; shipped:
//                     every 4, 8 lanes a warp)
//   5.. clusters      the step table in the shared memory of a cluster of
//                     CS blocks of P threads (fm_cluster_kernel, at the
//                     (CS, P) of FM_CLUSTERS): block r the 2^p entries
//                     from r << p, every load a ld.shared::cluster
//   then full_ldg, full_cg: no sums, a group of 4 threads a lane, each a
//                     16-byte quarter of the row (at W = 12 one idle), two
//                     shuffles and the invariant divisor; the loads by
//                     __ldg or ld.global.cg (L2 only).  The step a seeding
//                     kernel could take.
//   then sums         the shipped row-sum pass alone
// fm_chase(mode): one warp, `steps` dependent loads, clock64 around them:
//   0 k = t[k] from shared memory (n words)
//   1 k = t[k] from device memory (n words)
//   2 a 48-byte row from device memory: three 16-byte loads, k = the sum
//     of its 12 words (the host lays out rows whose first word is the
//     next row and the rest 0)
//   3 k = t[k] from the shared memory of the other block of a cluster of
//     two (ld.shared::cluster)
//   4 the same from the block's own shared memory by ld.shared::cluster
// 7D, mm_variant(design) on (a, b, out, scratch, R, K, N, reps):
//   0 replaced        the design replaced: a block a row of out, a thread a
//                     column, K dependent FMAs on __ldg loads
//   1 cluster8        mm_split_kernel<8, 1>: K in 8 chunks over a cluster
//   2 pull16          a cluster of 16 as the shipped one, but each block
//                     leaves its partial sums in its own shared memory and
//                     the adders read them (ld.shared::cluster): a second
//                     cluster barrier before a block may leave
//   3 cluster8x2      mm_split_kernel<8, 2>: 16 chunks, two a block
//   4 block4          mm_split_kernel<1, 4>: one block of four groups
//   5 blocks16        16 plain blocks a tile write their chunk's partial
//                     sums to the scratch; a second kernel adds them in
//                     order under programmatic dependent launch
//   6 blocks40        the same with 40 chunks
#include "fm_probe_kernel.cu"
#include "gather_probe3_kernel.cu"

// ---- #3 ----

// the replaced design's step: (k + acc) mod seq_len by C's %, then the
// sign fix
static __device__ inline int old_next_k(int k, uint32_t acc, int seq_len) {
  const int v = (int)((uint32_t)k + acc);
  const int r = v % seq_len;
  return r < 0 ? r + seq_len : r;
}

template <bool VEC>
__global__ void __launch_bounds__(128)
old_chain_kernel(const int* __restrict__ cmb, const int* __restrict__ k0,
                 int* __restrict__ out, int N, int W, int steps,
                 int seq_len) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= N) return;
  int k = k0[b];
  for (int s = 0; s < steps; ++s)
    k = old_next_k(k, fm_row_sum<VEC>(cmb, k >> 7, W), seq_len);
  out[b] = k;
}

// The step table's entry for a row whose words sum to S (wrapping): S mod
// L where k + S cannot wrap for any k in [0, L) (S <= 2^31 - L), else S -
// 2^31, which is then in [1 - L, -1]
static __device__ inline int table_entry(uint32_t S, const FmMod& f) {
  if ((int)S > (int)(0x7fffffffu - (f.L - 1u)))
    return (int)(S - 0x80000000u);
  return fm_mod((int)S, f);
}

// (k + S) mod L, wrapping, from the row's entry d (k in [0, L))
static __device__ inline int table_next(int k, int d, const FmMod& f) {
  if (d >= 0) {
    const uint32_t r = (uint32_t)k + (uint32_t)d;
    return (int)fm_umin(r, r - f.L);
  }
  return fm_mod((int)((uint32_t)k + (uint32_t)d + 0x80000000u), f);
}

__global__ void __launch_bounds__(FM_SUMS_P)
table_sums_kernel(const int* __restrict__ cmb, int* __restrict__ D, int nb,
                  int W, FmMod f) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int b = blockIdx.x * FM_SUMS_P + threadIdx.x;
  if (b < nb) D[b] = table_entry(fm_row_sum<true>(cmb, b, W), f);
}

__global__ void __launch_bounds__(FM_L2_P)
table_l2_kernel(const int* __restrict__ D, const int* __restrict__ k0,
                int* __restrict__ out, int N, int steps, FmMod f) {
  const int b = blockIdx.x * FM_L2_P + threadIdx.x;
  int k = b < N ? k0[b] : 0;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (b >= N) return;
  for (int s = 0; s < steps; ++s) k = table_next(k, __ldg(D + (k >> 7)), f);
  out[b] = k;
}

// the shipped chain with a lane every X threads (blocks of FM_L2_P * X;
// X = 1 shipped before the spread)
template <int X>
__global__ void __launch_bounds__(FM_L2_P * X)
spread_l2_kernel(const int* __restrict__ S, const int* __restrict__ k0,
                 int* __restrict__ out, int N, int steps, FmMod f) {
  const int t = blockIdx.x * FM_L2_P * X + threadIdx.x, b = t / X;
  int k = t % X == 0 && b < N ? k0[b] : 0;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (t % X || b >= N) return;
  for (int s = 0; s < steps; ++s) k = fm_next(k, __ldg(S + (k >> 7)), f);
  out[b] = k;
}

static __device__ __forceinline__ unsigned fm_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

static __device__ __forceinline__ void fm_cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the word at shared-memory address addr (of this block's window) in the
// block of rank `rank` of the cluster
static __device__ __forceinline__ int fm_ld_cluster(unsigned addr,
                                                    unsigned rank) {
  unsigned remote;
  int v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.b32 %0, [%1];"
               : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// A cluster of CS blocks of P threads holds the step table: block r the
// 2^p entries from r << p (p the least with CS << p >= nb, so a row's
// block and place are a shift and a mask).  The clusters take the lanes in
// turns, P a block; a step is one ld.shared::cluster, also where the entry
// is the block's own (a branch would split the warp into two loads a step).
template <int CS, int P>
__global__ void __launch_bounds__(P)
fm_cluster_kernel(const int* __restrict__ D, const int* __restrict__ k0,
                  int* __restrict__ out, int N, int nb, int p, int steps,
                  FmMod f) {
  extern __shared__ int4 fm_sm[];
  const unsigned rank = fm_cluster_rank();
  const int clusters = gridDim.x / CS, cluster = blockIdx.x / CS;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lo = (int)rank << p;
  const int n = nb - lo < (1 << p) ? (nb - lo > 0 ? nb - lo : 0) : 1 << p;
  const int4* src = reinterpret_cast<const int4*>(D + lo);
  for (int i = threadIdx.x; i < (n >> 2); i += P) fm_sm[i] = __ldg(src + i);
  int* words = reinterpret_cast<int*>(fm_sm);
  for (int i = (n & ~3) + (int)threadIdx.x; i < n; i += P)
    words[i] = __ldg(D + lo + i);
  fm_cluster_sync();                  // every part in place before a read
  const unsigned a0 = (unsigned)__cvta_generic_to_shared(fm_sm);
  const unsigned mask = (1u << p) - 1u;
  for (int base = cluster * CS * P; base < N; base += clusters * CS * P) {
    const int b = base + (int)rank * P + (int)threadIdx.x;
    if (b < N) {
      int k = k0[b];
      for (int s = 0; s < steps; ++s) {
        const unsigned row = (unsigned)k >> 7;
        k = table_next(k, fm_ld_cluster(a0 + 4u * (row & mask), row >> p),
                       f);
      }
      out[b] = k;
    }
  }
  fm_cluster_sync();                  // no block leaves while others read it
}

// the least p with CS << p >= nb
static inline int fm_part_shift(int nb, int cs) {
  int p = 2;                          // a part of 4 words at least
  while (((long long)cs << p) < nb) ++p;
  return p;
}

template <bool CG>
static __device__ __forceinline__ int4 ld_row4(const int4* p) {
  if (CG) {
    int4 v;
    asm volatile("ld.global.cg.v4.s32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
  }
  return __ldg(p);
}

// a group of 4 threads a lane (N a multiple of 128, so every group of a
// block of 128 threads has a lane)
template <bool CG>
__global__ void __launch_bounds__(128)
full_row_kernel(const int* __restrict__ cmb, const int* __restrict__ k0,
                int* __restrict__ out, int N, int W, int steps, FmMod f) {
  const int b = (blockIdx.x * 128 + threadIdx.x) >> 2, q = threadIdx.x & 3;
  int k = k0[b];
  for (int s = 0; s < steps; ++s) {
    const int4* row =
        reinterpret_cast<const int4*>(cmb + (long long)(k >> 7) * W);
    uint32_t acc = 0;
    for (int x = q; x < (W >> 2); x += 4) {
      const int4 v = ld_row4<CG>(row + x);
      acc += (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z + (uint32_t)v.w;
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    k = fm_mod((int)((uint32_t)k + acc), f);
  }
  if (q == 0) out[b] = k;
}

// the cluster designs timed: (CS, P)
#define FM_CLUSTERS 6
static const int FM_CLUSTER_CS[FM_CLUSTERS] = {4, 4, 8, 8, 16, 16};
static const int FM_CLUSTER_P[FM_CLUSTERS] = {128, 64, 64, 128, 32, 64};

template <int CS, int P>
static int cluster_chain(const int* D, const int* k0, int* out, int N, int nb,
                         int steps, const FmMod& f, cudaStream_t st) {
  const int p = fm_part_shift(nb, CS);
  if (p > 15) return (int)cudaErrorInvalidValue;     // past the cluster
  auto kern = fm_cluster_kernel<CS, P>;
  const size_t smem = (size_t)4 << p;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e == cudaSuccess && CS > 8)
    e = cudaFuncSetAttribute((const void*)kern,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return (int)e;
  int clusters = (N + CS * P - 1) / (CS * P);
  if (clusters > 132 / CS) clusters = 132 / CS;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = CS;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * CS);
  cfg.blockDim = dim3(P);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, kern, D, k0, out, N, nb, p, steps, f);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

static int pdl_launch_l2(const void* fn, int threads, int blocks,
                         const int* D, const int* k0, int* out, int N,
                         int steps, FmMod f, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&D, (void*)&k0, (void*)&out, (void*)&N,
                  (void*)&steps, (void*)&f};
  const cudaError_t e = cudaLaunchKernelExC(&cfg, fn, args);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

#define FM_D_CLUSTER0 5
#define FM_D_FULL (FM_D_CLUSTER0 + FM_CLUSTERS)   // full_ldg, then full_cg
#define FM_D_SUMS (FM_D_FULL + 2)

extern "C" int fm_variant(const int* cmb, const int* k0, int* out, int* D,
                          int N, int W, int steps, int seq_len, int design,
                          void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0) return (int)cudaGetLastError();
  const int nb = (seq_len + 127) / 128;
  const FmMod f = fm_mod_of(seq_len);
  const int g_sums = (nb + FM_SUMS_P - 1) / FM_SUMS_P;
  const int g_l2 = (N + FM_L2_P - 1) / FM_L2_P;
  if (design <= 1) {
    if (design == 0)
      old_chain_kernel<false><<<(N + 127) / 128, 128, 0, st>>>(
          cmb, k0, out, N, W, steps, seq_len);
    else
      old_chain_kernel<true><<<(N + 127) / 128, 128, 0, st>>>(
          cmb, k0, out, N, W, steps, seq_len);
    return (int)cudaGetLastError();
  }
  if (design == FM_D_FULL || design == FM_D_FULL + 1) {
    if (design == FM_D_FULL)
      full_row_kernel<false><<<N * 4 / 128, 128, 0, st>>>(cmb, k0, out, N,
                                                           W, steps, f);
    else
      full_row_kernel<true><<<N * 4 / 128, 128, 0, st>>>(cmb, k0, out, N, W,
                                                         steps, f);
    return (int)cudaGetLastError();
  }
  if (design == 3 || design == 4 || design == FM_D_SUMS) {
    fm_sums_kernel<true><<<g_sums, FM_SUMS_P, 0, st>>>(cmb, D, nb, W);
    const int rc = (int)cudaGetLastError();
    if (rc || design == FM_D_SUMS) return rc;
    if (design == 3)
      return pdl_launch_l2((const void*)spread_l2_kernel<1>, FM_L2_P, g_l2,
                           D, k0, out, N, steps, f, st);
    return pdl_launch_l2((const void*)spread_l2_kernel<2>, FM_L2_P * 2, g_l2,
                         D, k0, out, N, steps, f, st);
  }
  table_sums_kernel<<<g_sums, FM_SUMS_P, 0, st>>>(cmb, D, nb, W, f);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  if (design == 2)
    return pdl_launch_l2((const void*)table_l2_kernel, FM_L2_P, g_l2, D, k0,
                         out, N, steps, f, st);
  switch (design - FM_D_CLUSTER0) {
    case 0: return cluster_chain<4, 128>(D, k0, out, N, nb, steps, f, st);
    case 1: return cluster_chain<4, 64>(D, k0, out, N, nb, steps, f, st);
    case 2: return cluster_chain<8, 64>(D, k0, out, N, nb, steps, f, st);
    case 3: return cluster_chain<8, 128>(D, k0, out, N, nb, steps, f, st);
    case 4: return cluster_chain<16, 32>(D, k0, out, N, nb, steps, f, st);
    case 5: return cluster_chain<16, 64>(D, k0, out, N, nb, steps, f, st);
  }
  return (int)cudaErrorInvalidValue;
}

// (CS, P) of cluster design i, for the tool's labels
extern "C" long long fm_cluster_design(int i) {
  return i < 0 || i >= FM_CLUSTERS
             ? -1
             : (long long)FM_CLUSTER_CS[i] * 1000 + FM_CLUSTER_P[i];
}

__global__ void __launch_bounds__(32)
fm_chase_kernel(const int* __restrict__ t, int n, int steps, int mode,
                long long* cyc, int* out) {
  extern __shared__ int fch[];
  const bool cluster = mode >= 3;
  const unsigned rank = cluster ? fm_cluster_rank() : 0;
  if (mode == 0 || (cluster && rank == (mode == 3 ? 1u : 0u)))
    for (int i = threadIdx.x; i < n; i += 32) fch[i] = t[i];
  if (cluster)
    fm_cluster_sync();
  else
    __syncwarp();
  int k = (int)((threadIdx.x * 97u) % (unsigned)n);
  long long c0 = 0, c1 = 0;
  if (!cluster || rank == 0) {
    c0 = clock64();
    if (mode == 0) {
      for (int s = 0; s < steps; ++s) k = fch[k];
    } else if (mode == 1) {
      for (int s = 0; s < steps; ++s) k = __ldg(t + k);
    } else if (mode == 2) {
      for (int s = 0; s < steps; ++s) {
        const int4* row = reinterpret_cast<const int4*>(t + (long long)k * 12);
        const int4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
        k = a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w + c.x + c.y + c.z +
            c.w;
      }
    } else {
      const unsigned a0 = (unsigned)__cvta_generic_to_shared(fch);
      const unsigned peer = mode == 3 ? 1u : 0u;
      for (int s = 0; s < steps; ++s) k = fm_ld_cluster(a0 + 4u * k, peer);
    }
    c1 = clock64();
  }
  if (cluster) fm_cluster_sync();
  if (!cluster || rank == 0) {
    out[threadIdx.x] = k;
    if (threadIdx.x == 0) *cyc = c1 - c0;
  }
}

// n: words of t (modes 0, 1, 3, 4) or rows of 12 words (mode 2)
extern "C" int fm_chase(const int* t, int n, int steps, int mode,
                        long long* cyc, int* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = mode == 0 || mode >= 3 ? (size_t)n * 4 : 0;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fm_chase_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(mode >= 3 ? 2 : 1);
  cfg.blockDim = dim3(32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = mode >= 3 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, fm_chase_kernel, t, n, steps, mode, cyc, out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// ---- 7D ----

__global__ void __launch_bounds__(1024)
old_mm_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int K, int N, int reps) {
  const int r = blockIdx.x;
  for (int c = threadIdx.x; c < N; c += blockDim.x) {
    float m = 0.0f;
    for (int k = 0; k < K; ++k)
      m = fmaf(__ldg(a + (long long)r * K + k),
               __ldg(b + (long long)k * N + c), m);
    float acc = 0.0f;
    for (int t = 0; t < reps; ++t) acc = acc + m;
    out[(long long)r * N + c] = acc;
  }
}

// chunk blockIdx.x % chunks of tile blockIdx.x / chunks: its partial sums
// to scratch[tile][chunk][MM_TR * MM_TC]
__global__ void __launch_bounds__(MM_P)
mm_part_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ scratch, int R, int K, int N,
               int chunks) {
  __shared__ float st[MM_KB * MM_TC + MM_TR * MM_KB];
  asm volatile("griddepcontrol.launch_dependents;");
  const int j = blockIdx.x % chunks, tile = blockIdx.x / chunks;
  const int ntc = (N + MM_TC - 1) / MM_TC, t = threadIdx.x;
  const int r0 = tile / ntc * MM_TR, c0 = tile % ntc * MM_TC;
  int k0, k1;
  mm_chunk(j, chunks, K, k0, k1);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mm_tile_part(a, b, R, K, N, r0, c0, k0, k1, st, st + MM_KB * MM_TC, t, 1,
               acc);
  float* dst = scratch + ((long long)tile * chunks + j) * MM_TR * MM_TC;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dst[(t / MM_TC * 4 + q) * MM_TC + t % MM_TC] = acc[q];
}

__global__ void __launch_bounds__(256)
mm_reduce_kernel(const float* __restrict__ scratch, float* __restrict__ out,
                 int R, int N, int reps, int chunks, int tiles) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= tiles * MM_TR * MM_TC) return;
  const int tile = i / (MM_TR * MM_TC), o = i % (MM_TR * MM_TC);
  const int ntc = (N + MM_TC - 1) / MM_TC;
  const int r = tile / ntc * MM_TR + o / MM_TC;
  const int c = tile % ntc * MM_TC + o % MM_TC;
  if (r >= R || c >= N) return;
  const float* src = scratch + (long long)tile * chunks * MM_TR * MM_TC + o;
  float m = src[0];
  for (int j = 1; j < chunks; ++j) m = m + src[j * MM_TR * MM_TC];
  float s = 0.0f;
  for (int q = 0; q < reps; ++q) s = s + m;
  out[(long long)r * N + c] = s;
}

static int mm_blocks(const float* a, const float* b, float* out,
                     float* scratch, int R, int K, int N, int reps,
                     int chunks, cudaStream_t st) {
  const int tiles = (R + MM_TR - 1) / MM_TR * ((N + MM_TC - 1) / MM_TC);
  mm_part_kernel<<<tiles * chunks, MM_P, 0, st>>>(a, b, scratch, R, K, N,
                                                  chunks);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((tiles * MM_TR * MM_TC + 255) / 256);
  cfg.blockDim = dim3(256);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mm_reduce_kernel, (const float*)scratch, out,
                         R, N, reps, chunks, tiles);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The shipped kernel at (CS, 1) with the partial sums pulled: each block
// keeps its own in shared memory after its stage, and block `rank` reads
// its outputs' from every block (ld.shared::cluster), then a second
// cluster barrier keeps every block until the others have read it
template <int CS>
__global__ void __launch_bounds__(MM_P)
mm_pull_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int R, int K, int N, int reps) {
  extern __shared__ float mm_pull_sm[];
  constexpr int STAGE = MM_KB * MM_TC + MM_TR * MM_KB;
  constexpr int TILE = MM_TR * MM_TC, PER = TILE / CS;
  const int t = threadIdx.x;
  const unsigned rank = cluster_rank();
  const int tile = blockIdx.x / CS, ntc = (N + MM_TC - 1) / MM_TC;
  const int r0 = tile / ntc * MM_TR, c0 = tile % ntc * MM_TC;
  float* part = mm_pull_sm + STAGE;
  int k0, k1;
  mm_chunk((int)rank, CS, K, k0, k1);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mm_tile_part(a, b, R, K, N, r0, c0, k0, k1, mm_pull_sm,
               mm_pull_sm + MM_KB * MM_TC, t, 1, acc);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    part[(t / MM_TC * 4 + q) * MM_TC + t % MM_TC] = acc[q];
  cluster_sync();
  const unsigned base = (unsigned)__cvta_generic_to_shared(part);
  for (int o = (int)rank * PER + t; o < ((int)rank + 1) * PER; o += MM_P) {
    float v[CS];
#pragma unroll
    for (int x = 0; x < CS; ++x)
      v[x] = __int_as_float(ld_cluster(base + 4u * o, x));
    float m = v[0];
#pragma unroll
    for (int x = 1; x < CS; ++x) m = m + v[x];
    float s = 0.0f;
    for (int x = 0; x < reps; ++x) s = s + m;
    const int r = r0 + o / MM_TC, c = c0 + o % MM_TC;
    if (r < R && c < N) out[(long long)r * N + c] = s;
  }
  cluster_sync();
}

template <int CS>
static int mm_pull_launch(const float* a, const float* b, float* out, int R,
                          int K, int N, int reps, cudaStream_t st) {
  const void* fn = (const void*)mm_pull_kernel<CS>;
  const size_t smem = (size_t)(MM_KB * MM_TC + MM_TR * MM_KB +
                               MM_TR * MM_TC) * sizeof(float);
  int rc = smem_opt_in(fn, smem);
  if (!rc && CS > 8)
    rc = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc) return rc;
  const int tiles = (R + MM_TR - 1) / MM_TR * ((N + MM_TC - 1) / MM_TC);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * CS);
  cfg.blockDim = dim3(MM_P);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mm_pull_kernel<CS>, a, b,
                                           out, R, K, N, reps);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// scratch: tiles x 40 x MM_TR x MM_TC floats for designs 5 and 6
extern "C" int mm_variant(const float* a, const float* b, float* out,
                          float* scratch, int R, int K, int N, int reps,
                          int design, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (R < 1 || N < 1) return (int)cudaGetLastError();
  switch (design) {
    case 0: {
      const int threads = N < 1024 ? (N + 31) / 32 * 32 : 1024;
      old_mm_kernel<<<R, threads, 0, st>>>(a, b, out, K, N, reps);
      return (int)cudaGetLastError();
    }
    case 1: return mm_split_launch<8, 1>(a, b, out, R, K, N, reps, st);
    case 2: return mm_pull_launch<16>(a, b, out, R, K, N, reps, st);
    case 3: return mm_split_launch<8, 2>(a, b, out, R, K, N, reps, st);
    case 4: return mm_split_launch<1, 4>(a, b, out, R, K, N, reps, st);
    case 5: return mm_blocks(a, b, out, scratch, R, K, N, reps, 16, st);
    case 6: return mm_blocks(a, b, out, scratch, R, K, N, reps, 40, st);
  }
  return (int)cudaErrorInvalidValue;
}
