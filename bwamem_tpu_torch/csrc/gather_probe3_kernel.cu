// Round 3 of the gather probe: the gather envelope and a float32 product,
// each the function of one TPU probe kernel of tools/pl_gather_probe3.py,
// one __global__ each (gp3_dg is one template for both axes):
//
//   gp3_dg    (kernel in dg_probe, :56)  a clipped chain along one axis:
//             kk = clip(kk + take_along_axis(tab, kk, axis), 0, hi - 1),
//             `steps` times, on tab and kk [S, L], hi = the gathered
//             axis's size.  An element reads only its column (axis 0) or
//             its row (axis 1), and its step is a fixed map of its own
//             state within that line, T(k) = clip(k + line[k], 0, hi - 1)
//             (the wrap and the clip inside the map: ClipStep).  The
//             kernels are csrc/line_pow.cuh's, which gp2_take_ax0 and
//             gp2_take_ax1 launch with their own step: the map's powers by
//             squaring, the state taking T^(2^b) for each set bit b of
//             `steps` (512 steps are nine squarings and one lookup); at hi
//             up to 32 (B8, B32) a segment of a warp a line, each lookup a
//             shuffle (pow_warp_kernel); past 32 (C512) a block a line,
//             the powers 16-bit in shared memory (pow_block_kernel).
//   gp3_ct    (kernel in probe_ct, :79)  a take along axis 1, a transpose
//             and a second take at the same kk: per step g2[i, j] =
//             tab[m, kk[m, i]] with m = kk[i, j], then kk = clip(kk + g2,
//             0, N - 1), on [N, N].  Element (i, j) reads kk of row m, so
//             every element must finish step t before any starts t + 1:
//             the state is double-buffered in shared memory, each step
//             reads one buffer and writes the other, and a barrier ends
//             it.  The clip is taken out of the steps: T[m, c] =
//             clip(m + tab[m, c], 0, N - 1) once a launch (the same
//             function, the wrap included), so a step is kk[i, j] <-
//             T[m, kk[m, i]].  A thread keeps its elements' states in
//             registers (no load of its own kk) and handles a fixed count
//             of them (a compile-time loop, their loads in flight
//             together).  Element e of a run of rows sits at column
//             j = e % N and row i = (e / N + j) % rows (ct_place): a
//             warp's 32 consecutive e take 32 consecutive j and, where
//             the run has 32 rows or more, 32 distinct i, so at N = 128
//             the store kk[i, j] and the read kk[m, i] hit 32 banks
//             whatever m is; only the read of T[m, c] is a random gather.
//             At N = 128 a cluster of 16 blocks of 512 threads on
//             neighbouring SMs, each with its own copy of T and 8 rows of
//             the state, reading kk[m, i] from the block that owns row m
//             (ld.shared::cluster), a step ended by a block barrier, one
//             cluster-scope fence a block and the cluster barrier; at any
//             other N up to 139 one block of 1024 threads holding T and
//             both buffers, a block barrier a step.  One SM is held by
//             its shared memory (three accesses an element a step, 16384
//             elements, one 32-word wavefront a clock, and about 3.5
//             wavefronts a warp for the T gather on moving chains); the
//             cluster splits that over 16 SMs and pays a remote load an
//             element and the cluster barrier.  tools/torch_ct_variants.py
//             times these against the other designs weighed.
//   gp3_col0  (kernel in probe_d2, :103)  out[q] = tab[k[q], 0] for a few
//             lanes (8 in the probe) of a [R, W] table: col0_kernel of
//             csrc/col0.cuh, which gp2_col0 launches too (one warp here).
//   gp3_mm    (kernel in probe_e2, :125)  out = 64 ordered float32
//             additions acc = acc + m of m = (a @ b)[:8]: a [M, K], b
//             [K, N], out [R, N].  Only rows :R of the product reach the
//             output and they are the same in each of the 64 iterations,
//             so m is computed once, by float32 FMA on the CUDA cores
//             (TF32 would round from 2^11 on), then added 64 times, each
//             add rounded (not 64 * m, which is another number).  K is
//             split into MM_CS x MM_G chunks: a cluster of MM_CS blocks
//             on neighbouring SMs takes a tile of MM_TR x MM_TC outputs,
//             each block MM_G chunks (a group of MM_P threads a chunk,
//             four outputs a thread).  A group stages its chunk of a and
//             b in shared memory with coalesced loads (MM_KB values of k
//             at a time) and sums each output's chunk by FMA in k order
//             from 0; each block then stores its partial sums into the
//             shared memory of the block that adds them up
//             (st.shared::cluster, 1/MM_CS of the tile's outputs a block),
//             and after one cluster barrier each block adds its own in
//             chunk order, then adds the sum 64 times.  No atomics: the
//             order is fixed, so two calls give the same bits, and the
//             host build (gp3_mm_host) computes them on the CPU.
//
// The add of the chains wraps in 32 bits (jnp's int32 add), and the clip
// is jnp.clip's.
//
// What bounds them on an H100 (3.35 TB/s; 67 TFLOP/s float32 outside the
// tensor cores, at 700 W): the chains move kk in and out and the table
// words they touch (kilobytes to 260 KB), a fraction of a microsecond, so
// the launch and the dependent steps are what one sees (gp3_dg's 512
// steps as a chain: 512 dependent loads, 34 cycles each in shared memory
// by tools/torch_dg_variants.py's chase; doubled: ten rounds of two
// dependent lookups, so one launch's latency is what is left; for gp3_ct
// on one SM, its shared memory: three accesses an element a step, 16384
// elements, at most 32 words a clock); gp3_col0 moves
// under 100 bytes; gp3_mm's function moves a[:8], b and out (352 KB, 0.1 us)
// and does 1.4 MFLOP.  The TPU kernel computed 64 whole [1024, 640] x
// [640, 128] products (10.7 GFLOP); this one computes the function.  What
// held the design it replaced (a block a row, a thread a column, 640
// dependent FMAs each waiting on its two loads, on 8 SMs: 0.025 ms on the
// device of an H100 80GB HBM3 at 700 W) was that chain of load latencies;
// split over a cluster of 16 SMs, a block stages 40 values of k (20 KB of
// b) and its chain is 40 FMAs from shared memory, so what is left (0.009
// ms) is a launch (about 0.0055 on that timing), the stage, the remote
// stores of the partial sums and one cluster barrier
// (tools/torch_fm_mm_variants.py on that card: reading the partial sums
// remotely, which needs a second barrier before a block may leave,
// 0.0095; a cluster of 8, two groups a block, one block, and plain blocks
// with a second kernel 0.0101-0.0241).
//
// The same source compiles as host C++ (no __CUDACC__), exposing the lane
// loops as *_host entries, so the CPU tests check their arithmetic without
// a card.
#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "col0.cuh"
#include "line_pow.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include "smem.cuh"
#define GP_HD __device__
#define GP_LDG(p) __ldg(p)
#else
#define GP_HD
#define GP_LDG(p) (*(p))
#endif

#define CT_N 128       // gp3_ct's N in the probe, where it runs as a cluster
#define CT_CS 16       // ... of CT_CS blocks
#define CT_P 512       // ... of CT_P threads
#define CT_N_MAX 139   // the largest N whose T and two states fit a block

// clip(k + g, 0, hi - 1), the add wrapping in 32 bits
static GP_HD inline int clip_step(int k, int g, int hi) {
  const int v = (int)((uint32_t)k + (uint32_t)g);
  return v < 0 ? 0 : (v > hi - 1 ? hi - 1 : v);
}

// gp3_dg's step as line_pow.cuh takes it
struct ClipStep {
  static GP_HD inline int at(int k, int g, int hi) {
    return clip_step(k, g, hi);
  }
};

// one gp3_dg chain over a line of hi words (stride apart)
static GP_HD inline int dg_chain(const int* line, long long stride, int k,
                                 int steps, int hi) {
  for (int s = 0; s < steps; ++s) k = clip_step(k, line[k * stride], hi);
  return k;
}

// element e of the rows [row0, row0 + rows) of an N-column state: column
// e % N, row row0 + (e / N + e % N) % rows (for each column, the rows in
// a rotated order: a bijection of [0, rows * N))
static GP_HD inline void ct_place(int e, int row0, int rows, int N, int& i,
                                  int& j) {
  j = e % N;
  i = row0 + (e / N + j) % rows;
}

// where a gather reads kk[m, i] when blocks of rb rows each hold their
// rows: in the block of rank m / rb, at word (m % rb) * N + i of its
// buffer
static GP_HD inline unsigned ct_src(unsigned m, unsigned i, unsigned rb,
                                    unsigned N, unsigned& rank) {
  rank = m / rb;
  return (m % rb) * N + i;
}

#define MM_CS 16       // gp3_mm's cluster: blocks, each a chunk of K
#define MM_G 1         // ... chunks a block (a group of MM_P threads each)
#define MM_P 256       // threads of a group: a tile's outputs, 4 a thread
#define MM_TR 8        // rows of a tile of outputs
#define MM_TC 128      // columns of a tile
#define MM_KB 64       // values of k a group stages at a time

// chunk j of `chunks` of [0, K): [k0, k1), ceil(K / chunks) values of k
// (the last ones shorter or empty)
static GP_HD inline void mm_chunk(int j, int chunks, int K, int& k0,
                                  int& k1) {
  const int kc = (K + chunks - 1) / chunks;
  k0 = j * kc < K ? j * kc : K;
  k1 = k0 + kc < K ? k0 + kc : K;
}

#ifdef __CUDACC__

// ---- gp3_ct ----
// A thread's K elements: v[k] the state, at[k] = i << 16 | the element's
// word in its block's buffer (i: the row, the column its gather reads).

// one step of the block's elements: cur the state of the step before, nxt
// this step's.  The gathers of CH elements are in flight together: all K
// up to 16, past that (the 19 of N at run time, in the 64 registers a
// thread of 1024 has) chunks of 8, so that nothing spills.
template <int K>
static __device__ __forceinline__ void ct_block_step(
    const int* __restrict__ t, const int* __restrict__ cur,
    int* __restrict__ nxt, int (&v)[K], const int (&at)[K], int N) {
  constexpr int CH = K > 16 ? 8 : K;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += CH) {
    int c[CH];
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (k0 + k < K) c[k] = cur[v[k0 + k] * N + (at[k0 + k] >> 16)];
    }
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (k0 + k < K) {
        v[k0 + k] = t[v[k0 + k] * N + c[k]];
        nxt[at[k0 + k] & 0xffff] = v[k0 + k];
      }
    }
  }
}

// One block of P threads at any N up to CT_N_MAX, K elements a thread (an
// element past N^2 works on a sink word past each buffer, a row N column 0
// whose reads stay inside the buffers).  Shared memory: T, then two
// buffers of N^2 + 1 words.
__global__ void __launch_bounds__(1024)
ct_block_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                int* __restrict__ out, int n_rt, int steps) {
  constexpr int P = 1024, K = (CT_N_MAX * CT_N_MAX + P - 1) / P;
  extern __shared__ int sm[];
  const int N = n_rt, n2 = N * N;
  int* t = sm;
  int* buf0 = t + n2;
  int* buf1 = buf0 + n2 + 1;
  for (int e = threadIdx.x; e < n2; e += P) {
    t[e] = clip_step(e / N, __ldg(tab + e), N);
    buf0[e] = __ldg(kk0 + e);
  }
  if (threadIdx.x == 0) buf0[n2] = buf1[n2] = 0;
  int v[K], at[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = threadIdx.x + k * P;
    int i = N, j = 0;
    if (e < n2) ct_place(e, 0, N, N, i, j);
    const int w = e < n2 ? i * N + j : n2;
    at[k] = i << 16 | w;
    v[k] = e < n2 ? __ldg(kk0 + w) : 0;
  }
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    if (s & 1)
      ct_block_step<K>(t, buf1, buf0, v, at, N);
    else
      ct_block_step<K>(t, buf0, buf1, v, at, N);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((at[k] & 0xffff) < n2) out[at[k] & 0xffff] = v[k];
}

static __device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// the word at shared-memory address addr (of this block's window) in the
// block of rank `rank` of the cluster
static __device__ __forceinline__ int ld_cluster(unsigned addr,
                                                 unsigned rank) {
  unsigned remote;
  int v;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.b32 %0, [%1];"
               : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// every block's memory operations before it ordered before every block's
// after it (the default arrive releases, the wait acquires)
static __device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the same with one release a block in place of one a warp: the block
// barrier orders every thread's stores before warp 0's fence, the fence
// and warp 0's arrive after it release them at cluster scope, and every
// wait acquires them (a fence followed by a relaxed arrive, the pattern
// the PTX memory model gives for a release).  A relaxed arrive with no
// fence is cheaper, but the model then orders nothing across blocks.
static __device__ __forceinline__ void cluster_sync_shared() {
  __syncthreads();
  if (threadIdx.x < 32) asm volatile("fence.acq_rel.cluster;" ::: "memory");
  asm volatile(
      "barrier.cluster.arrive.relaxed.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// one step of a cluster block's elements: src the shared-memory address
// of the buffer of the step before (the same offset in every block),
// nxt this block's buffer of this step
template <int RB, int K>
static __device__ __forceinline__ void ct_cluster_step(
    const int* __restrict__ t, unsigned src, int* __restrict__ nxt,
    int (&v)[K], const int (&at)[K]) {
  constexpr int N = CT_N;
  int c[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    unsigned rank;
    const unsigned w = ct_src(v[k], at[k] >> 16, RB, N, rank);
    c[k] = ld_cluster(src + 4u * w, rank);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = t[v[k] * N + c[k]];
    nxt[at[k] & 0xffff] = v[k];
  }
}

// A cluster of CS blocks of P threads at N = CT_N (shipped at CT_CS x
// CT_P; tools/torch_ct_variants.py instantiates other sizes): block r owns
// the RB = N / CS rows from r * RB, K elements a thread, and reads kk[m, i]
// from the block that owns row m.  Shared memory: T (each block its own),
// then two buffers of the block's rows.  A step ends with
// cluster_sync_shared.
template <int CS, int P>
__global__ void __launch_bounds__(P)
ct_cluster_kernel(const int* __restrict__ tab, const int* __restrict__ kk0,
                  int* __restrict__ out, int steps) {
  constexpr int N = CT_N, RB = N / CS, K = RB * N / P;
  extern __shared__ int sm[];
  int* t = sm;
  int* buf0 = t + N * N;
  int* buf1 = buf0 + RB * N;
  const int row0 = (int)cluster_rank() * RB;
  for (int e = threadIdx.x; e < N * N; e += P)
    t[e] = clip_step(e / N, __ldg(tab + e), N);
  for (int e = threadIdx.x; e < RB * N; e += P)
    buf0[e] = __ldg(kk0 + row0 * N + e);
  int v[K], at[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    int i, j;
    ct_place(threadIdx.x + k * P, row0, RB, N, i, j);
    at[k] = i << 16 | ((i - row0) * N + j);
    v[k] = __ldg(kk0 + i * N + j);
  }
  cluster_sync();            // every block's rows in place before any read
  const unsigned a0 = (unsigned)__cvta_generic_to_shared(buf0);
  const unsigned a1 = (unsigned)__cvta_generic_to_shared(buf1);
  for (int s = 0; s < steps; ++s) {
    if (s & 1)
      ct_cluster_step<RB, K>(t, a1, buf0, v, at);
    else
      ct_cluster_step<RB, K>(t, a0, buf1, v, at);
    cluster_sync_shared();
  }
  cluster_sync();            // no block leaves while others read it
#pragma unroll
  for (int k = 0; k < K; ++k) out[row0 * N + (at[k] & 0xffff)] = v[k];
}

// a named barrier of the n threads of a group
static __device__ __forceinline__ void group_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(n) : "memory");
}

// The partial sums of chunk [k0, k1) for a thread's four outputs (rows
// rq..rq+3 of the tile at r0, column c0 + c), the group's chunk staged in
// shared memory MM_KB values of k at a time (bs [MM_KB, MM_TC], as
// [MM_TR, MM_KB]; outputs past R or N read zeros); `bar` the group's
// barrier
static __device__ __forceinline__ void mm_tile_part(
    const float* __restrict__ a, const float* __restrict__ b, int R, int K,
    int N, int r0, int c0, int k0, int k1, float* bs, float* as, int t,
    int bar, float (&acc)[4]) {
  const int c = t % MM_TC, rq = t / MM_TC * 4;
  for (int kb = k0; kb < k1; kb += MM_KB) {
    const int n = k1 - kb < MM_KB ? k1 - kb : MM_KB;
#pragma unroll 4
    for (int e = t; e < n * MM_TC; e += MM_P) {
      const int col = c0 + e % MM_TC;
      bs[e] = col < N ? __ldg(b + (long long)(kb + e / MM_TC) * N + col)
                      : 0.0f;
    }
    for (int e = t; e < MM_TR * n; e += MM_P) {
      const int row = r0 + e / n;
      as[e / n * MM_KB + e % n] =
          row < R ? __ldg(a + (long long)row * K + kb + e % n) : 0.0f;
    }
    group_sync(bar, MM_P);
    for (int i = 0; i < n; ++i) {
      const float bv = bs[i * MM_TC + c];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] = fmaf(as[(rq + q) * MM_KB + i], bv, acc[q]);
    }
    group_sync(bar, MM_P);            // read before the next stage lands
  }
}

// the partial sum v into the word at shared-memory address addr (of this
// block's window) in the block of rank `rank` of the cluster
static __device__ __forceinline__ void st_cluster_f32(unsigned addr,
                                                      unsigned rank,
                                                      float v) {
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;"
      : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;"
               :: "r"(remote), "f"(v) : "memory");
}

// gp3_mm as a cluster of CS blocks of G groups a tile: chunk j = rank * G
// + g of CS * G.  Block `rank` adds up the tile's outputs [rank * PER,
// (rank + 1) * PER): every group stores its partial sums into row j of
// their adder's inbox [CS * G][PER] (st.shared::cluster; CS = 1: one
// block, no cluster), one barrier, then each block adds its inbox's rows
// in chunk order from its own shared memory, so nothing is read remotely
// and no block waits for the others to finish.  The relaxed arrive at the
// start, waited on before the first remote store, lets no block store into
// a peer that has not started.  Shared memory: each group's stage, then
// the inbox.
template <int CS, int G>
__global__ void __launch_bounds__(MM_P * G)
mm_split_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int R, int K, int N, int reps) {
  extern __shared__ float mm_sm[];
  constexpr int STAGE = MM_KB * MM_TC + MM_TR * MM_KB;
  constexpr int PER = MM_TR * MM_TC / CS;
  if (CS > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;");
  const int g = threadIdx.x / MM_P, t = threadIdx.x % MM_P;
  const unsigned rank = CS > 1 ? cluster_rank() : 0;
  const int tile = blockIdx.x / CS, ntc = (N + MM_TC - 1) / MM_TC;
  const int r0 = tile / ntc * MM_TR, c0 = tile % ntc * MM_TC;
  float* bs = mm_sm + g * STAGE;
  float* inbox = mm_sm + G * STAGE;
  const int j = (int)rank * G + g;
  int k0, k1;
  mm_chunk(j, CS * G, K, k0, k1);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mm_tile_part(a, b, R, K, N, r0, c0, k0, k1, bs, bs + MM_KB * MM_TC, t,
               1 + g, acc);
  if (CS > 1) asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  const unsigned base = (unsigned)__cvta_generic_to_shared(inbox);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = (t / MM_TC * 4 + q) * MM_TC + t % MM_TC;
    if (CS > 1)
      st_cluster_f32(base + 4u * (j * PER + o % PER), o / PER, acc[q]);
    else
      inbox[j * PER + o] = acc[q];
  }
  if (CS > 1)
    cluster_sync();              // every partial sum in its inbox
  else
    __syncthreads();
  for (int i = threadIdx.x; i < PER; i += MM_P * G) {
    float m = inbox[i];
    for (int x = 1; x < CS * G; ++x) m = m + inbox[x * PER + i];
    float s = 0.0f;
    for (int x = 0; x < reps; ++x) s = s + m;
    const int o = (int)rank * PER + i;
    const int r = r0 + o / MM_TC, c = c0 + o % MM_TC;
    if (r < R && c < N) out[(long long)r * N + c] = s;
  }
}

// C entries for ctypes: device pointers; each returns cudaGetLastError()
// after the launch on the caller's stream.  The wrappers in
// ops/gather_probe3.py check shapes and the shared memory each needs.
// line_pow.cuh's kernels with gp3_dg's step
extern "C" int gp3_dg(const int* tab, const int* kk0, int* out, int S, int L,
                      int steps, int axis, void* stream) {
  return line_pow_launch<ClipStep>(tab, kk0, out, S, L, steps, axis,
                                   (cudaStream_t)stream);
}

static int ct_block_launch(const int* tab, const int* kk0, int* out, int N,
                           int steps, cudaStream_t st) {
  const size_t smem = ((size_t)3 * N * N + 2) * sizeof(int);
  const int rc = smem_opt_in((const void*)ct_block_kernel, smem);
  if (rc) return rc;
  ct_block_kernel<<<1, 1024, smem, st>>>(tab, kk0, out, N, steps);
  return (int)cudaGetLastError();
}

// kern as one cluster of `blocks` blocks of `threads`, each with `smem`
// bytes of dynamic shared memory (a cluster of more than 8 blocks is
// non-portable: allowed explicitly)
static int ct_cluster_launch(void (*kern)(const int*, const int*, int*, int),
                             int blocks, int threads, size_t smem,
                             const int* tab, const int* kk0, int* out,
                             int steps, cudaStream_t st) {
  const void* fn = (const void*)kern;
  int rc = smem_opt_in(fn, smem);
  if (!rc && blocks > 8)
    rc = (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, tab, kk0, out, steps);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// shared memory of ct_cluster_kernel's blocks: T and two buffers of rows
static size_t ct_cluster_smem(int blocks) {
  return ((size_t)CT_N * CT_N + 2 * CT_N * CT_N / blocks) * sizeof(int);
}

// at N = CT_N the cluster of CT_CS blocks of CT_P, at any other N one
// block of 1024
extern "C" int gp3_ct(const int* tab, const int* kk0, int* out, int N,
                      int steps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (N < 1) return (int)cudaGetLastError();
  if (N == CT_N)
    return ct_cluster_launch(ct_cluster_kernel<CT_CS, CT_P>, CT_CS, CT_P,
                             ct_cluster_smem(CT_CS), tab, kk0, out, steps,
                             st);
  return ct_block_launch(tab, kk0, out, N, steps, st);
}

extern "C" int gp3_col0(const int* tab, const int* k, int* out, int N, int W,
                        void* stream) {
  return col0_launch(tab, k, out, N, W, (cudaStream_t)stream);
}

// mm_split_kernel<CS, G> over every tile of [R, N], as clusters of CS
// blocks (more than 8: allowed explicitly; 1: no cluster)
template <int CS, int G>
static int mm_split_launch(const float* a, const float* b, float* out, int R,
                           int K, int N, int reps, cudaStream_t st) {
  if (R < 1 || N < 1) return (int)cudaGetLastError();
  const void* fn = (const void*)mm_split_kernel<CS, G>;
  const size_t smem = (size_t)G * (MM_KB * MM_TC + MM_TR * MM_KB +
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
  cfg.blockDim = dim3(MM_P * G);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, mm_split_kernel<CS, G>, a, b,
                                           out, R, K, N, reps);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

extern "C" int gp3_mm(const float* a, const float* b, float* out, int R,
                      int K, int N, int reps, void* stream) {
  return mm_split_launch<MM_CS, MM_G>(a, b, out, R, K, N, reps,
                                      (cudaStream_t)stream);
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

// gp3_dg as the card computes it: line_pow.cuh's algorithm (each line's
// map T, its powers by squaring, the state taking T^(2^b) for each set
// bit b of `steps`, lowest first) with gp3_dg's step
extern "C" int gp3_dg_double_host(const int* tab, const int* kk0, int* out,
                                  int S, int L, int steps, int axis) {
  return line_pow_host<ClipStep>(tab, kk0, out, S, L, steps, axis);
}

// gp3_ct as `blocks` blocks that split the rows (1: the one block; CT_CS
// at N = CT_N: the cluster), T taken once, then each step every block's
// elements in the card's order (ct_place), each reading the state of the
// step before, kk[m, i] where the card reads it (ct_src: the buffer of
// the block that owns row m; the blocks' buffers lie one after another).
// Returns 1 on a split that does not divide N, 2 when the blocks'
// elements do not cover the state once each.
extern "C" int gp3_ct_host(const int* tab, const int* kk0, int* out, int N,
                           int steps, int blocks) {
  const int rows = blocks > 0 ? N / blocks : 0;
  const size_t n2 = (size_t)N * N;
  int* t = (int*)malloc(n2 * sizeof(int));
  int* cur = (int*)malloc(n2 * sizeof(int));
  int* nxt = (int*)calloc(n2, sizeof(int));
  int rc = !t || !cur || !nxt || blocks < 1 || rows * blocks != N;
  for (size_t e = 0; !rc && e < n2; ++e) {
    t[e] = clip_step((int)(e / N), tab[e], N);
    cur[e] = kk0[e];
  }
  for (int b = 0; !rc && b < blocks; ++b)       // each element once
    for (int e = 0; e < rows * N; ++e) {
      int i, j;
      ct_place(e, b * rows, rows, N, i, j);
      nxt[i * N + j] += 1;
    }
  for (size_t e = 0; !rc && e < n2; ++e)
    if (nxt[e] != 1) rc = 2;
  for (int s = 0; !rc && s < steps; ++s) {
    for (int b = 0; b < blocks; ++b)
      for (int e = 0; e < rows * N; ++e) {
        int i, j;
        unsigned rank;
        ct_place(e, b * rows, rows, N, i, j);
        const int m = cur[i * N + j];
        const unsigned w = ct_src(m, i, rows, N, rank);
        nxt[i * N + j] = t[m * N + cur[(size_t)rank * rows * N + w]];
      }
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (!rc) memcpy(out, cur, n2 * sizeof(int));
  free(t);
  free(cur);
  free(nxt);
  return rc;
}

extern "C" int gp3_col0_host(const int* tab, const int* k, int* out, int N,
                             int W) {
  return col0_host(tab, k, out, N, W);
}

// m[r, c] as gp3_mm sums it: each chunk by FMA in k order from 0, the
// chunks' sums added in chunk order; then `reps` rounded adds
static inline float mm_split_elem(const float* a, const float* b, int r,
                                  int c, int K, int N, int reps,
                                  int chunks) {
  float m = 0.0f;
  for (int j = 0; j < chunks; ++j) {
    int k0, k1;
    mm_chunk(j, chunks, K, k0, k1);
    float p = 0.0f;
    for (int k = k0; k < k1; ++k)
      p = fmaf(a[(long long)r * K + k], b[(long long)k * N + c], p);
    m = j ? m + p : p;
  }
  float acc = 0.0f;
  for (int t = 0; t < reps; ++t) acc = acc + m;
  return acc;
}

// gp3_mm's sums in the card's order: MM_CS x MM_G chunks of K
extern "C" int gp3_mm_host(const float* a, const float* b, float* out, int R,
                           int K, int N, int reps) {
  for (int r = 0; r < R; ++r)
    for (int c = 0; c < N; ++c)
      out[(long long)r * N + c] =
          mm_split_elem(a, b, r, c, K, N, reps, MM_CS * MM_G);
  return 0;
}

#endif
