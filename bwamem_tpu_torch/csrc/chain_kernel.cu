// Seed chaining (mem_chain + test_and_merge, bwamem.c:197-307) on Hopper:
// a warp a read, over that read's own seeds.
//
// It replaces no Pallas kernel: the reference package's CHAIN
// (bwamem_tpu/ops/chain.py chain_seeds) is a lax.fori_loop of jnp, S
// lockstep trips, one seed of every read a trip, each trip a one-hot
// reduction over the whole [N, C, 8] chain state and a rewrite of it.
// ops/chain.chain_seeds_plain is that loop in PyTorch, and the CPU
// tests hold it.  On the card it cost S x C x 8 words of traffic a trip,
// whatever the reads held: at the grown seed cap of a human index (S = C
// = 1024, N = 65,536 rows) CHAIN took 233 of the device front's 342
// ms/kread on an H100 (PERF.md section 5).
//
// What bounds this kernel on an H100: bytes, and the longest read's
// serial walk.  The bytes are one read of the [N, S] valid grid and of
// the valid seeds' fields, and one write of the [N, C] chain outputs and
// the [N, S] seed_chain grid (about 3.3 GB at the size above: 1 ms at
// 3.35 TB/s), which the design writes once, coalesced: a warp writes its
// row's used chains as it walks and fills the rest after.  No [N, C, 8]
// scratch.  The walk is serial within a read, as mem_chain's is: each
// seed needs the chain table its predecessors left.  The design keeps it
// short: a read's 32 lanes take its valid bits 32 slots at a time by
// ballot and load those seeds together, then walk the set bits in order,
// the seed handed out by shuffles; the lookup (the chain with the largest
// pos <= rbeg, the later-created one on ties: kb_intervalp's lower) is a
// masked max over the read's own n chains, a lane every 32nd chain, then
// a shuffle max over the lanes; every lane then runs test_and_merge on
// the chosen chain (one broadcast load a field) and lane 0 writes.  So a
// seed costs ceil(n / 32) loads a lane and ten shuffles, not C; a read
// with no seeds reads its valid row and writes its fill.  The chain table
// stays in the output rows in global memory (L1-resident while the warp
// walks): the reads whose tables pass 32 chains are the repeats, and few.
//
// Semantics kept bit for bit with the plain loop: pos = the chain's first
// rbeg; containment merges and appends nothing (seed_chain -1); the strand
// block across l_pac; the w and max_chain_gap growth test in the index
// type with two's-complement wrap; a new chain only while n < C, else the
// row's overflow flag; rid the seed's, is_alt = ctg_is_alt[max(rid, 0)]
// (0 past the table); invalid slots anywhere in a row skipped; unused
// chain slots pos = the type's max, rid -1, the rest 0.  Positions above
// the type's minimum (every real one) are assumed.
//
// The same source compiles as host C++ (no __CUDACC__): chain_host runs
// each row's walk with the warp's 32 lanes one after the other (the
// ballot, the lane partition of the lookup and its reduction spelled out)
// through the same merge test and writes, so the CPU tests check the
// kernel's own logic.
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define CH_HD __host__ __device__ __forceinline__
#else
#define CH_HD inline
#endif

namespace {

constexpr int WARPS = 8;           // warps a block, a read each
constexpr int LANES = 32;

// the unsigned type of T and T's range
template <typename T> struct Int;
template <> struct Int<int32_t> {
  using U = uint32_t;
  static constexpr int32_t lo = INT32_MIN, hi = INT32_MAX;
};
template <> struct Int<int64_t> {
  using U = uint64_t;
  static constexpr int64_t lo = INT64_MIN, hi = INT64_MAX;
};

// two's-complement add and subtract in T, as PyTorch's integer ops wrap
template <typename T>
CH_HD T wadd(T a, T b) {
  using U = typename Int<T>::U;
  return (T)((U)a + (U)b);
}

template <typename T>
CH_HD T wsub(T a, T b) {
  using U = typename Int<T>::U;
  return (T)((U)a - (U)b);
}

// The input grids ([N, S], row strides in elements, unit column stride)
// and the outputs ([N, C] each, [N] n and overflow, [N, S] seed_chain).
template <typename T>
struct Args {
  const T* rbeg;
  const int32_t* qbeg;
  const int32_t* len;
  const int32_t* rid;
  const uint8_t* valid;
  long long st_rbeg, st_qbeg, st_len, st_rid, st_valid;
  const int32_t* alt_of;
  int n_alt;
  T* pos;
  int32_t* crid;
  uint8_t* calt;
  int32_t* fq;
  T* fr;
  int32_t* lq;
  T* lr;
  int32_t* ll;
  int32_t* ns;
  int32_t* n_out;
  int32_t* seed_chain;
  uint8_t* overflow;
  int N, S, C;
  T l_pac, w, gap;
};

// test_and_merge (bwamem.c:52-73) of a seed against chain j of the row
// whose chain outputs start at `oc`: 0 no merge, 1 contained, 2 appended.
template <typename T>
CH_HD int merge_test(const Args<T>& a, long long oc, int j, T rb, T qb,
                     T sl, int sr) {
  if (sr != a.crid[oc + j]) return 0;
  const T c_fq = (T)a.fq[oc + j], c_fr = a.fr[oc + j];
  const T c_lq = (T)a.lq[oc + j], c_lr = a.lr[oc + j];
  const T c_ll = (T)a.ll[oc + j];
  if (qb >= c_fq && wadd(qb, sl) <= wadd(c_lq, c_ll) && rb >= c_fr &&
      wadd(rb, sl) <= wadd(c_lr, c_ll))
    return 1;
  if ((c_lr < a.l_pac || c_fr < a.l_pac) && rb >= a.l_pac) return 0;
  const T x = wsub(qb, c_lq), y = wsub(rb, c_lr);
  if (y >= 0 && wsub(x, y) <= a.w && wsub(y, x) <= a.w &&
      wsub(x, c_ll) < a.gap && wsub(y, c_ll) < a.gap)
    return 2;
  return 0;
}

template <typename T>
CH_HD void write_append(const Args<T>& a, long long oc, int j, T rb, T qb,
                        T sl) {
  a.lq[oc + j] = (int32_t)qb;
  a.lr[oc + j] = rb;
  a.ll[oc + j] = (int32_t)sl;
  a.ns[oc + j] = a.ns[oc + j] + 1;
}

template <typename T>
CH_HD void write_new(const Args<T>& a, long long oc, int j, T rb, T qb, T sl,
                     int sr) {
  const int ai = sr < 0 ? 0 : sr;
  a.pos[oc + j] = rb;
  a.crid[oc + j] = sr;
  a.calt[oc + j] = (uint8_t)(ai < a.n_alt && a.alt_of[ai] > 0);
  a.fq[oc + j] = (int32_t)qb;
  a.fr[oc + j] = rb;
  a.lq[oc + j] = (int32_t)qb;
  a.lr[oc + j] = rb;
  a.ll[oc + j] = (int32_t)sl;
  a.ns[oc + j] = 1;
}

template <typename T>
CH_HD void write_fill(const Args<T>& a, long long oc, int j) {
  a.pos[oc + j] = Int<T>::hi;
  a.crid[oc + j] = -1;
  a.calt[oc + j] = 0;
  a.fq[oc + j] = 0;
  a.fr[oc + j] = 0;
  a.lq[oc + j] = 0;
  a.lr[oc + j] = 0;
  a.ll[oc + j] = 0;
  a.ns[oc + j] = 0;
}

// A lane's share of the lookup: over chains lane, lane + 32, ... < n, the
// largest pos <= rb, the latest chain on ties; *bj -1 when it has none.
template <typename T>
CH_HD void lane_best(const T* prow, int lane, int n, T rb, T* best,
                     int* bj) {
  *bj = -1;
  *best = 0;
  for (int j = lane; j < n; j += LANES) {
    const T p = prow[j];
    if (p <= rb && (*bj < 0 || p >= *best)) {
      *best = p;
      *bj = j;
    }
  }
}

// The seed's outcome after the lookup chose `lower` and merge_test gave
// `m` (0 when lower is -1, no chain): the seed's chain (-1 when contained
// or when the table is full), with the writes done by `writer`, the row's
// n and overflow flag updated.
template <typename T>
CH_HD int place_seed(const Args<T>& a, long long oc, int lower, int m, T rb,
                     T qb, T sl, int sr, bool writer, int* n, bool* ovf) {
  if (m == 2) {
    if (writer) write_append(a, oc, lower, rb, qb, sl);
    return lower;
  }
  if (m == 1) return -1;
  if (*n < a.C) {
    if (writer) write_new(a, oc, *n, rb, qb, sl, sr);
    return (*n)++;
  }
  *ovf = true;
  return -1;
}

#ifdef __CUDACC__

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int32_t shfl(int32_t v, int src) {
  return __shfl_sync(FULL, v, src);
}
__device__ __forceinline__ int64_t shfl(int64_t v, int src) {
  return (int64_t)__shfl_sync(FULL, (long long)v, src);
}
__device__ __forceinline__ int32_t shfl_xor(int32_t v, int m) {
  return __shfl_xor_sync(FULL, v, m);
}
__device__ __forceinline__ int64_t shfl_xor(int64_t v, int m) {
  return (int64_t)__shfl_xor_sync(FULL, (long long)v, m);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * LANES)
chain_kernel(const Args<T> a) {
  const int lane = threadIdx.x & (LANES - 1);
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= a.N) return;                  // the whole warp leaves
  const long long oc = row * a.C;
  const T* prow = a.pos + oc;
  const uint8_t* vrow = a.valid + row * a.st_valid;
  int n = 0;
  bool ovf = false;
  for (int base = 0; base < a.S; base += LANES) {
    const int s = base + lane;
    const bool v = s < a.S && __ldg(vrow + s) != 0;
    unsigned bits = __ballot_sync(FULL, v);
    int sc = -1;
    if (bits) {
      T my_rb = 0;
      int32_t my_qb = 0, my_len = 0, my_rid = 0;
      if (v) {
        my_rb = __ldg(a.rbeg + row * a.st_rbeg + s);
        my_qb = __ldg(a.qbeg + row * a.st_qbeg + s);
        my_len = __ldg(a.len + row * a.st_len + s);
        my_rid = __ldg(a.rid + row * a.st_rid + s);
      }
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        const T rb = shfl(my_rb, src);
        const T qb = (T)shfl(my_qb, src);
        const T sl = (T)shfl(my_len, src);
        const int sr = shfl(my_rid, src);
        T best;
        int bj;
        lane_best(prow, lane, n, rb, &best, &bj);
        T m = bj >= 0 ? best : Int<T>::lo;
#pragma unroll
        for (int o = LANES / 2; o; o >>= 1) {
          const T x = shfl_xor(m, o);
          m = x > m ? x : m;
        }
        const int lower =
            __reduce_max_sync(FULL, (bj >= 0 && best == m) ? bj : -1);
        const int mt =
            lower >= 0 ? merge_test(a, oc, lower, rb, qb, sl, sr) : 0;
        __syncwarp();     // every lane's reads of the chain, then the write
        const int r = place_seed(a, oc, lower, mt, rb, qb, sl, sr, lane == 0,
                                 &n, &ovf);
        if (lane == src) sc = r;
        __syncwarp();     // lane 0's writes, before the next lookup reads
      }
    }
    if (s < a.S) a.seed_chain[row * a.S + s] = sc;
  }
  for (int j = n + lane; j < a.C; j += LANES) write_fill(a, oc, j);
  if (lane == 0) {
    a.n_out[row] = n;
    a.overflow[row] = ovf;
  }
}

template <typename T>
int launch(const Args<T>& a, cudaStream_t stream) {
  if (a.N > 0) {
    const unsigned blocks = (unsigned)((a.N + WARPS - 1) / WARPS);
    chain_kernel<T><<<blocks, WARPS * LANES, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

#else

// The warp's walk on the host: the 32 lanes one after the other in each
// step, the ballot and the lookup's reduction written out.
template <typename T>
int launch(const Args<T>& a) {
  for (long long row = 0; row < a.N; ++row) {
    const long long oc = row * a.C;
    const T* prow = a.pos + oc;
    const uint8_t* vrow = a.valid + row * a.st_valid;
    int n = 0;
    bool ovf = false;
    for (int base = 0; base < a.S; base += LANES) {
      unsigned bits = 0;
      int sc[LANES];
      for (int lane = 0; lane < LANES; ++lane) {
        const int s = base + lane;
        if (s < a.S && vrow[s] != 0) bits |= 1u << lane;
        sc[lane] = -1;
      }
      while (bits) {
        const int src = __builtin_ctz(bits);
        bits &= bits - 1;
        const int s = base + src;
        const T rb = a.rbeg[row * a.st_rbeg + s];
        const T qb = (T)a.qbeg[row * a.st_qbeg + s];
        const T sl = (T)a.len[row * a.st_len + s];
        const int sr = a.rid[row * a.st_rid + s];
        T best[LANES];
        int bj[LANES];
        T m = Int<T>::lo;
        for (int lane = 0; lane < LANES; ++lane) {
          lane_best(prow, lane, n, rb, &best[lane], &bj[lane]);
          if (bj[lane] >= 0 && best[lane] > m) m = best[lane];
        }
        int lower = -1;
        for (int lane = 0; lane < LANES; ++lane)
          if (bj[lane] >= 0 && best[lane] == m && bj[lane] > lower)
            lower = bj[lane];
        const int mt =
            lower >= 0 ? merge_test(a, oc, lower, rb, qb, sl, sr) : 0;
        sc[src] = place_seed(a, oc, lower, mt, rb, qb, sl, sr, true, &n,
                             &ovf);
      }
      for (int lane = 0; lane < LANES && base + lane < a.S; ++lane)
        a.seed_chain[row * a.S + base + lane] = sc[lane];
    }
    for (int j = n; j < a.C; ++j) write_fill(a, oc, j);
    a.n_out[row] = n;
    a.overflow[row] = ovf;
  }
  return 0;
}

#endif

template <typename T>
Args<T> make_args(const void* rbeg, const void* qbeg, const void* len,
                  const void* rid, const void* valid, long long st_rbeg,
                  long long st_qbeg, long long st_len, long long st_rid,
                  long long st_valid, const void* alt_of, int n_alt,
                  void* pos, void* crid, void* calt, void* fq, void* fr,
                  void* lq, void* lr, void* ll, void* ns, void* n_out,
                  void* seed_chain, void* overflow, int N, int S, int C,
                  long long l_pac, long long w, long long gap) {
  Args<T> a;
  a.rbeg = (const T*)rbeg;
  a.qbeg = (const int32_t*)qbeg;
  a.len = (const int32_t*)len;
  a.rid = (const int32_t*)rid;
  a.valid = (const uint8_t*)valid;
  a.st_rbeg = st_rbeg;
  a.st_qbeg = st_qbeg;
  a.st_len = st_len;
  a.st_rid = st_rid;
  a.st_valid = st_valid;
  a.alt_of = (const int32_t*)alt_of;
  a.n_alt = n_alt;
  a.pos = (T*)pos;
  a.crid = (int32_t*)crid;
  a.calt = (uint8_t*)calt;
  a.fq = (int32_t*)fq;
  a.fr = (T*)fr;
  a.lq = (int32_t*)lq;
  a.lr = (T*)lr;
  a.ll = (int32_t*)ll;
  a.ns = (int32_t*)ns;
  a.n_out = (int32_t*)n_out;
  a.seed_chain = (int32_t*)seed_chain;
  a.overflow = (uint8_t*)overflow;
  a.N = N;
  a.S = S;
  a.C = C;
  // the scalars in the index type, as PyTorch compares a tensor with a
  // Python int
  a.l_pac = (T)l_pac;
  a.w = (T)w;
  a.gap = (T)gap;
  return a;
}

}  // namespace

#define CHAIN_ARGS                                                        \
  const void *rbeg, const void *qbeg, const void *len, const void *rid,   \
      const void *valid, long long st_rbeg, long long st_qbeg,            \
      long long st_len, long long st_rid, long long st_valid,             \
      const void *alt_of, int n_alt, void *pos, void *crid, void *calt,   \
      void *fq, void *fr, void *lq, void *lr, void *ll, void *ns,         \
      void *n_out, void *seed_chain, void *overflow, int N, int S, int C, \
      int is64, long long l_pac, long long w, long long gap
#define CHAIN_PASS                                                        \
  rbeg, qbeg, len, rid, valid, st_rbeg, st_qbeg, st_len, st_rid,          \
      st_valid, alt_of, n_alt, pos, crid, calt, fq, fr, lq, lr, ll, ns,   \
      n_out, seed_chain, overflow, N, S, C, l_pac, w, gap

#ifdef __CUDACC__

// Every pointer a device address; the stream the caller's (ops/launch).
extern "C" int chain_launch(CHAIN_ARGS, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return is64 ? launch(make_args<int64_t>(CHAIN_PASS), st)
              : launch(make_args<int32_t>(CHAIN_PASS), st);
}

#else

extern "C" int chain_host(CHAIN_ARGS) {
  return is64 ? launch(make_args<int64_t>(CHAIN_PASS))
              : launch(make_args<int32_t>(CHAIN_PASS));
}

#endif
