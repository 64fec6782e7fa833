// The row-body ablation probe's kernel (make(variant).kernel of
// tools/pl_probe.py:36, pallas_call :97), one function per variant, per
// lane b over ROWS target rows, on qT int32 [L1p, B] and tT [ROWS, B]:
//
//   eh_h[r] = r * 3 % 17, eh_e[r] = 0; then for each target row i:
//     Mq    = M != 0 ? M + (qT[r] == tT[i] ? 1 : -4) : 0, M = eh_h[r]
//             (not clamped: in eh_only it goes negative)
//     eh_only: eh_h = Mq, nothing else (no shift)
//     A     = max(Mq - 7, 0) + r
//     F[r]  = max(max_{j<r} A[j] - r, 0), F[0] = 0   (noscan: F = A)
//     h     = max(Mq, F),  eh_e = max(eh_e - 1, max(Mq - 8, 0))
//     full, roll: mj_enc = max_r ((h << 12) | r), h1_enc = h[LQ - 1],
//             lst = max r with h != 0 or eh_e != 0 (else -1)
//     eh_h  = h shifted down one row, row 0 keeping h[0]
//   out = eh_h; aux int32 [3, B] = (mj_enc, h1_enc, lst) of the last step
//   for full and roll, 0 for the others.
//
// noreduce, full and roll give the same out: the TPU kernel multiplies the
// reductions by zero (:85).  Here they go to aux, so the compiler cannot
// drop them and the ablation still prices them, every step.  (h << 12) is
// an unsigned shift, wrapping as jnp's int32 does.
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; 3.35 TB/s and
// the int32 rate chip_smoke.py phase 1 measures, PEAK_INT32_OPS):
// operations, 5 (eh_only) to 23 (full) a cell over L1p x B x ROWS cells
// (ops/pl_probe.OPS_PER_CELL), against 3.3 MB of qT, tT, out and aux at
// the probe's defaults.  Each lane is a chain of ROWS dependent steps, and
// inside a step the scan and the shift chain the rows; so the design
// spreads a lane's rows over threads, keeps them in registers and lets
// DPX fuse each add with its max.  Three designs:
//
//   * noscan, noreduce, full: a group of G threads a lane (G a template
//     parameter, 8, 16 or 32), thread j holding a contiguous chunk of CH
//     rows (rows j*CH ..; the threads past the last row idle) with its q,
//     h and e in register arrays of compile-time size.  A step: (1) the
//     chunk's max of A in one pass, keeping each row's Mq and A; (2) the
//     chunk maxima scanned inclusively in log2 G __shfl_up_sync steps, the
//     exclusive value by one more; (3) the chunk's rows from it, each F
//     one DPX add-max (max(G - r, 0)) and e one (__viaddmax_s32_relu(e,
//     -1, Mq - 8)); (4) the shift: register moves inside the chunk, one
//     __shfl_up_sync across it; (5) for full, mj_enc and lst by
//     __reduce_max_sync, h1_enc from the thread that holds row LQ - 1.
//     tT is loaded ahead: thread j loads tT[i0 + j, b] once every G steps
//     and step i takes it by __shfl_sync from thread i % G.  Where the
//     chunk passes the register cap (32 rows), the same group runs
//     with its chunk of ceil(L1p / G) rows in shared memory (h and e, two
//     words a row; q read through L1), for any L1p whose state fits a
//     block.  This is the chunked scan: a running max inside the chunk,
//     log2 G shuffles across.
//   * roll: the other scan, as the TPU kernel writes it with pltpu.roll:
//     log2 L1p masked steps, each row taking the max with the row sh above
//     it, sh = 1, 2, 4, ..  A warp a lane, row r on thread r % 32 in slot
//     r / 32 of K in registers: a step with sh < 32 is one __shfl_sync a
//     slot (from the same slot sh threads up, or for the first sh threads
//     the slot before), a step with sh >= 32 a register max with slot k -
//     sh / 32; the exclusive value and the shift take one more shuffle a
//     slot.  Every row takes part in every step.  Past 16 slots (512 rows)
//     a block of up to 1024 threads a lane runs it with one row a thread
//     and the rows' h and e in shared memory, the warps' totals and last
//     rows through shared memory too.
//   * eh_only: no scan and no shift, so every (row, lane) cell is an
//     independent recurrence and takes dp_eh's design (csrc/rows.cuh,
//     ROWS_EH): RPT rows of LPT lanes a thread, in registers.
// No design skips a row or a lane whose state is 0.
// tools/torch_row_variants.py builds a copy with the add-maxes written as
// plain max.
// The designs these replaced (a thread a lane with its state in shared
// memory, and a warp a lane in shared memory) are kept only in that tool.
//
// The same source compiles as host C++ (no __CUDACC__): plp_row_host runs
// every design's threads one after the other, the group's and the warps'
// shuffles, scans, shift and reductions spelled out, with dpx.cuh's plain
// C definitions of the DPX intrinsics, so the CPU tests check them all.
#include <limits.h>
#include <stdint.h>

#include "dpx.cuh"
#include "rows.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <type_traits>
#define PLP_HD __device__ __forceinline__
#define PLP_LDG(p) __ldg(p)
#else
#include <stdlib.h>
#include <string.h>
#define PLP_HD inline
#define PLP_LDG(p) (*(p))
#endif

#define PLP_NEG (-0x40000000)  // the TPU kernel's NEGc
#define PLP_GROUP_THREADS 128  // threads a block of the group design
#define PLP_ROLL_MAX 1024      // threads a block of roll past the warp's slots
enum { V_EH_ONLY = 0, V_NOSCAN = 1, V_NOREDUCE = 2, V_FULL = 3, V_ROLL = 4 };

struct Red {  // the reductions of one step
  int mj, h1, lst;
};

static PLP_HD int imax(int a, int b) { return a > b ? a : b; }

// max(a + b, c) and max(max(a + b, c), 0), one DPX instruction each
static PLP_HD int addmax(int a, int b, int c) { return dpx_addmax(a, b, c); }
static PLP_HD int addmax_relu(int a, int b, int c) {
  return dpx_addmax_relu(a, b, c);
}

static PLP_HD int mq_of(int M, int q, int t) {
  return M != 0 ? M + (q == t ? 1 : -4) : 0;
}
static PLP_HD int a_of(int Mq, int r) { return addmax(Mq, -7, 0) + r; }
static PLP_HD int enc(int h, int r) {
  return (int)(((uint32_t)h << 12) | (uint32_t)r);
}
static PLP_HD Red red_start() { return Red{INT_MIN, PLP_NEG, -1}; }

// Row r from its Mq and A, the max Gr of A over the rows before r and its
// e: returns h; updates Gr and e.  noscan takes F = A.
template <int V>
static PLP_HD int row_cell(int Mq, int A, int r, int& Gr, int& e) {
  int F;
  if (V == V_NOSCAN) {
    F = A;
  } else {
    F = addmax(Gr, -r, 0);
    Gr = imax(Gr, A);
  }
  e = addmax_relu(e, -1, Mq - 8);
  return imax(Mq, F);
}

// Row r's share of the reductions (rows come in order, so the last
// nonzero row wins lst).
static PLP_HD void keep(Red& p, int hv, int e, int r, int LQ) {
  p.mj = imax(p.mj, enc(hv, r));
  if (hv != 0 || e != 0) p.lst = r;
  if (r == LQ - 1) p.h1 = hv;
}

static PLP_HD Red red_max(const Red& a, const Red& b) {
  return Red{imax(a.mj, b.mj), imax(a.h1, b.h1), imax(a.lst, b.lst)};
}

// ------------------------------------------------ the group design's chunk

// A thread's chunk of CH rows in registers: rows r0 .. r0 + CH - 1, of
// which the first n are rows of the lane (the rest lie past L1p: they run
// and are neither stored nor reduced).
template <int CH>
struct RegChunk {
  int q[CH], h[CH], e[CH], mq[CH], a[CH];
  int r0, n;

  PLP_HD void init(const int* __restrict__ qT, long long B, int b, int r0_,
                   int n_) {
    r0 = r0_;
    n = n_;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      q[k] = k < n ? PLP_LDG(qT + (long long)(r0 + k) * B + b) : 0;
      h[k] = k < n ? (r0 + k) * 3 % 17 : 0;
      e[k] = 0;
    }
  }

  // pass 1: each row's Mq and A, and the chunk's max of A
  PLP_HD int pass1(int t) {
    int m = PLP_NEG;
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      mq[k] = mq_of(h[k], q[k], t);
      a[k] = a_of(mq[k], r0 + k);
      m = imax(m, a[k]);
    }
    return m;
  }

  // pass 2 from Gr, the max of A over the rows before the chunk: the
  // rows' h and e, the shift inside the chunk, the chunk's reductions
  // (full).  Returns h of the chunk's last row and sets *first to h of
  // its first (row r0 is the caller's to set: it takes the chunk before).
  template <int V>
  PLP_HD int pass2(int t, int Gr, int LQ, int* first, Red* p) {
    int hv[CH];
    Red red = red_start();
#pragma unroll
    for (int k = 0; k < CH; ++k) {
      if (V == V_NOSCAN) {
        mq[k] = mq_of(h[k], q[k], t);
        a[k] = a_of(mq[k], r0 + k);
      }
      hv[k] = row_cell<V>(mq[k], a[k], r0 + k, Gr, e[k]);
      if (V == V_FULL && k < n) keep(red, hv[k], e[k], r0 + k, LQ);
    }
#pragma unroll
    for (int k = CH - 1; k > 0; --k) h[k] = hv[k - 1];
    *first = hv[0];
    *p = red;
    return hv[CH - 1];
  }

  PLP_HD void shift_in(int v) { h[0] = v; }

  PLP_HD void store(int* __restrict__ out, long long B, int b) const {
#pragma unroll
    for (int k = 0; k < CH; ++k)
      if (k < n) out[(long long)(r0 + k) * B + b] = h[k];
  }
};

// The same chunk in shared memory: h and e of the lane's rows (a word a
// row each), q read from qT through L1, n rows from r0.
struct SmemChunk {
  const int* q;  // qT + b, rows B apart
  int *h, *e;
  long long B;
  int r0, n;

  PLP_HD void init(const int* __restrict__ qT, long long B_, int b, int r0_,
                   int n_, int* h_, int* e_) {
    q = qT + b;
    B = B_;
    r0 = r0_;
    n = n_;
    h = h_;
    e = e_;
    for (int k = 0; k < n; ++k) {
      h[r0 + k] = (r0 + k) * 3 % 17;
      e[r0 + k] = 0;
    }
  }

  PLP_HD int pass1(int t) {
    int m = PLP_NEG;
    for (int k = 0; k < n; ++k) {
      const int r = r0 + k;
      m = imax(m, a_of(mq_of(h[r], PLP_LDG(q + r * B), t), r));
    }
    return m;
  }

  template <int V>
  PLP_HD int pass2(int t, int Gr, int LQ, int* first, Red* p) {
    Red red = red_start();
    int prev = 0;
    *first = 0;
    for (int k = 0; k < n; ++k) {
      const int r = r0 + k;
      const int Mq = mq_of(h[r], PLP_LDG(q + r * B), t);
      int ev = e[r];
      const int hv = row_cell<V>(Mq, a_of(Mq, r), r, Gr, ev);
      e[r] = ev;
      if (V == V_FULL) keep(red, hv, ev, r, LQ);
      if (k > 0)
        h[r] = prev;
      else
        *first = hv;
      prev = hv;
    }
    *p = red;
    return prev;
  }

  PLP_HD void shift_in(int v) {
    if (n > 0) h[r0] = v;
  }

  PLP_HD void store(int* __restrict__ out, long long B_, int b) const {
    for (int k = 0; k < n; ++k)
      out[(long long)(r0 + k) * B_ + b] = h[r0 + k];
  }
};

// rows of thread j's chunk of `ch` rows (0 past the last row)
static PLP_HD int chunk_rows(int L1p, int j, int ch) {
  const int n = L1p - j * ch;
  return n < 0 ? 0 : (n < ch ? n : ch);
}

// The register chunks the kernel is built for (rows a thread).  The
// wrapper rounds ceil(L1p / G) up to one of them (ops/pl_probe.CHUNKS).
#define PLP_FOR_CHUNKS(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(9) X(12) X(13) X(16) X(17) X(24) X(32)
// roll's slots a thread (rows ceil(L1p / 32) rounded up; ops/pl_probe.SLOTS)
#define PLP_FOR_SLOTS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(8) X(12) X(16)

// ---------------------------------------------- the kernels and the entry
// The group design's step and kernel; roll, a warp a lane with K rows a
// thread and the log-step masked scan (past 16 rows a thread, a block a
// lane with its rows in shared memory); the launches and the C entry.

#ifdef __CUDACC__

template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if (G == 32) return 0xffffffffu;
  return ((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1));
}

// One step of the group: scan, rows, shift, reductions (full).
template <int G, int V, class C>
__device__ __forceinline__ void group_step(C& c, int tb, int LQ,
                                           unsigned mask, int t, Red* red) {
  int excl = PLP_NEG;
  if (V != V_NOSCAN) {
    int incl = c.pass1(tb);
#pragma unroll
    for (int d = 1; d < G; d <<= 1) {
      const int u = __shfl_up_sync(mask, incl, d, G);
      if (t >= d) incl = imax(incl, u);
    }
    excl = __shfl_up_sync(mask, incl, 1, G);
    if (t == 0) excl = PLP_NEG;
  }
  int first;
  Red pr;
  const int last = c.template pass2<V>(tb, excl, LQ, &first, &pr);
  const int up = __shfl_up_sync(mask, last, 1, G);
  c.shift_in(t == 0 ? first : up);
  if (V == V_FULL)
    *red = Red{__reduce_max_sync(mask, pr.mj), __reduce_max_sync(mask, pr.h1),
               __reduce_max_sync(mask, pr.lst)};
}

// The group design: CH rows a thread in registers, or CH 0 for
// ceil(L1p / G) rows a thread in shared memory (two words a row a lane).
// Every row is read and written by the thread that holds it, so the
// shared chunk needs no barrier.
template <int G, int CH, int V>
__global__ void __launch_bounds__(PLP_GROUP_THREADS)
plp_group_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
                 int* __restrict__ out, int* __restrict__ aux, int L1p,
                 int rows, int B, int LQ, int lanes) {
  extern __shared__ int sm[];
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const int b = blockIdx.x * lanes + g;
  if (b >= B) return;  // whole groups
  const unsigned mask = group_mask<G>();
  const int ch = CH > 0 ? CH : (L1p + G - 1) / G;
  typename std::conditional<(CH > 0), RegChunk<(CH > 0 ? CH : 1)>,
                            SmemChunk>::type c;
  if constexpr (CH > 0)
    c.init(qT, B, b, t * ch, chunk_rows(L1p, t, ch));
  else
    c.init(qT, B, b, t * ch, chunk_rows(L1p, t, ch), sm + 2LL * g * L1p,
           sm + 2LL * g * L1p + L1p);
  Red red = {0, 0, 0};
  int tnext = t < rows ? PLP_LDG(tT + (long long)t * B + b) : 0, tcur = 0;
  for (int i = 0; i < rows; ++i) {
    if ((i & (G - 1)) == 0) {  // the next G target rows, a word a thread
      tcur = tnext;
      const int k = i + G + t;
      tnext = k < rows ? PLP_LDG(tT + (long long)k * B + b) : 0;
    }
    const int tb = __shfl_sync(mask, tcur, i & (G - 1), G);
    group_step<G, V>(c, tb, LQ, mask, t, &red);
  }
  c.store(out, B, b);
  if (t == 0) {
    aux[b] = red.mj;
    aux[B + b] = red.h1;
    aux[2 * B + b] = red.lst;
  }
}

// roll: a warp a lane, row r on thread r % 32 in slot r / 32 of K, the
// slots' q, h and e in registers.  The prefix max is the TPU kernel's
// log-step masked roll: for sh = 1, 2, .., 16 every row takes the max with
// row r - sh (one __shfl_sync a slot from thread (l - sh) % 32: the same
// slot, or for l < sh the slot before), for sh = 32, 64, .. with slot k -
// sh / 32 of its own thread (a register); rows r < sh are masked.  Then
// the exclusive value and the shift by one more shuffle each.
template <int K>
__global__ void __launch_bounds__(PLP_GROUP_THREADS)
plp_roll_warp_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
                     int* __restrict__ out, int* __restrict__ aux, int L1p,
                     int rows, int B, int LQ) {
  const unsigned FULL = 0xffffffffu;
  const int l = threadIdx.x & 31;
  const int b = blockIdx.x * (PLP_GROUP_THREADS / 32) + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp
  int q[K], h[K], e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = 32 * k + l;
    q[k] = r < L1p ? PLP_LDG(qT + (long long)r * B + b) : 0;
    h[k] = r < L1p ? r * 3 % 17 : 0;
    e[k] = 0;
  }
  Red red = {0, 0, 0};
  int tcur = 0, tnext = l < rows ? PLP_LDG(tT + (long long)l * B + b) : 0;
  for (int i = 0; i < rows; ++i) {
    if ((i & 31) == 0) {
      tcur = tnext;
      const int k = i + 32 + l;
      tnext = k < rows ? PLP_LDG(tT + (long long)k * B + b) : 0;
    }
    const int tb = __shfl_sync(FULL, tcur, i & 31);
    int mq[K], g[K], s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = 32 * k + l;
      mq[k] = mq_of(h[k], q[k], tb);
      g[k] = r < L1p ? a_of(mq[k], r) : PLP_NEG;
    }
#pragma unroll
    for (int sh = 1; sh < 32; sh <<= 1) {
      const int src = (l - sh) & 31;
#pragma unroll
      for (int k = 0; k < K; ++k) s[k] = __shfl_sync(FULL, g[k], src);
#pragma unroll
      for (int k = K - 1; k >= 0; --k) {
        if (l >= sh) {
          g[k] = imax(g[k], s[k]);
        } else if (k > 0) {
          g[k] = imax(g[k], s[k - 1]);
        }
      }
    }
#pragma unroll
    for (int m = 1; m < K; m <<= 1) {
#pragma unroll
      for (int k = K - 1; k >= m; --k) g[k] = imax(g[k], g[k - m]);
    }
    const int src = (l - 1) & 31;
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = __shfl_sync(FULL, g[k], src);
    Red pr = red_start();
    int hv[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int r = 32 * k + l;
      int Gr = l >= 1 ? s[k] : (k > 0 ? s[k - 1] : PLP_NEG);  // row r - 1
      hv[k] = row_cell<V_FULL>(mq[k], g[k], r, Gr, e[k]);  // Gr then dropped
      if (r < L1p) keep(pr, hv[k], e[k], r, LQ);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) s[k] = __shfl_sync(FULL, hv[k], src);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (l >= 1) {
        h[k] = s[k];
      } else {
        h[k] = k > 0 ? s[k - 1] : hv[0];
      }
    }
    red = Red{__reduce_max_sync(FULL, pr.mj), __reduce_max_sync(FULL, pr.h1),
              __reduce_max_sync(FULL, pr.lst)};
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int r = 32 * k + l;
    if (r < L1p) out[(long long)r * B + b] = h[k];
  }
  if (l == 0) {
    aux[b] = red.mj;
    aux[B + b] = red.h1;
    aux[2 * B + b] = red.lst;
  }
}

// roll past the warp's slots: a block of T threads a lane, row r on
// thread r % T, the rows' h and e in shared memory; each segment of T rows
// scanned by the warps' log-step shuffles, then the warps' totals through
// shared memory.  Shared memory also holds two buffers of the warps' scan
// totals and last rows' h (a segment writes one while the other may still
// be read) and the warps' reductions: 7 words a warp.
__global__ void __launch_bounds__(PLP_ROLL_MAX, 1)
plp_roll_block_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
                int* __restrict__ out, int* __restrict__ aux, int L1p,
                int rows, int B, int LQ) {
  extern __shared__ int sm[];
  const unsigned FULL = 0xffffffffu;
  const int T = blockDim.x, tid = threadIdx.x, w = tid >> 5, l = tid & 31;
  const int W = T >> 5, b = blockIdx.x;
  const int S = (L1p + T - 1) / T;
  int* wt = sm;             // [2][W] scan totals
  int* wl = sm + 2 * W;     // [2][W] h of each warp's last row
  int* wr = sm + 4 * W;     // [3][W] the warps' reductions
  int* hs = sm + 7 * W;     // [L1p] h, [L1p] e
  int* es = hs + L1p;
  for (int r = tid; r < L1p; r += T) {
    hs[r] = r * 3 % 17;
    es[r] = 0;
  }
  int par = 0;
  int tcur = 0, tnext = l < rows ? PLP_LDG(tT + (long long)l * B + b) : 0;
  for (int i = 0; i < rows; ++i) {
    if ((i & 31) == 0) {
      tcur = tnext;
      const int k = i + 32 + l;
      tnext = k < rows ? PLP_LDG(tT + (long long)k * B + b) : 0;
    }
    const int tb = __shfl_sync(FULL, tcur, i & 31);
    int carry = PLP_NEG, hprev = 0;
    Red pr = red_start();
    for (int s = 0; s < S; ++s) {
      const int r = s * T + tid;
      const bool ok = r < L1p;
      const int qv = ok ? PLP_LDG(qT + (long long)r * B + b) : 0;
      const int M = ok ? hs[r] : 0;
      const int Mq = mq_of(M, qv, tb);
      const int A = ok ? a_of(Mq, r) : PLP_NEG;
      int incl = A;  // the log-step masked scan inside the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, incl, d);
        if (l >= d) incl = imax(incl, u);
      }
      if (l == 31) wt[par * W + w] = incl;
      __syncthreads();
      int before = carry, total = carry;  // the warps before, and all
      for (int v = 0; v < W; ++v) {
        const int x = wt[par * W + v];
        if (v < w) before = imax(before, x);
        total = imax(total, x);
      }
      const int up = __shfl_up_sync(FULL, incl, 1);
      int Gr = l == 0 ? before : imax(before, up);
      int ev = ok ? es[r] : 0;
      const int hv = row_cell<V_FULL>(Mq, A, r, Gr, ev);
      if (ok) keep(pr, hv, ev, r, LQ);
      const int hup = __shfl_up_sync(FULL, hv, 1);
      if (l == 31) wl[par * W + w] = hv;
      __syncthreads();
      const int hin = r == 0 ? hv : (l > 0 ? hup : (w > 0 ? wl[par * W + w - 1]
                                                      : hprev));
      hprev = wl[par * W + W - 1];
      if (ok) {
        hs[r] = hin;
        es[r] = ev;
      }
      carry = total;
      par ^= 1;
    }
    pr = Red{__reduce_max_sync(FULL, pr.mj), __reduce_max_sync(FULL, pr.h1),
             __reduce_max_sync(FULL, pr.lst)};
    if (l == 0) {
      wr[w] = pr.mj;
      wr[W + w] = pr.h1;
      wr[2 * W + w] = pr.lst;
    }
  }
  __syncthreads();
  for (int r = tid; r < L1p; r += T) out[(long long)r * B + b] = hs[r];
  if (tid == 0) {
    Red red = rows > 0 ? red_start() : Red{0, 0, 0};
    for (int v = 0; v < W && rows > 0; ++v)
      red = red_max(red, Red{wr[v], wr[W + v], wr[2 * W + v]});
    aux[b] = red.mj;
    aux[B + b] = red.h1;
    aux[2 * B + b] = red.lst;
  }
}

static int smem_opt_in(const void* fn, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int G, int CH, int V>
static int launch_group(const int* qT, const int* tT, int* out, int* aux,
                        int L1p, int rows, int B, int LQ, int lanes,
                        int smem, cudaStream_t st) {
  const int rc = smem_opt_in((const void*)plp_group_kernel<G, CH, V>, smem);
  if (rc) return rc;
  plp_group_kernel<G, CH, V><<<(B + lanes - 1) / lanes, lanes * G, smem,
                               st>>>(qT, tT, out, aux, L1p, rows, B, LQ,
                                     lanes);
  return 0;
}

template <int G, int V>
static int group_ch(const int* qT, const int* tT, int* out, int* aux, int L1p,
                    int rows, int B, int LQ, int ch, int lanes, int smem,
                    cudaStream_t st) {
#define PLP_CH_CASE(C)                                                     \
  if (ch == C)                                                             \
    return launch_group<G, C, V>(qT, tT, out, aux, L1p, rows, B, LQ, lanes, \
                                 smem, st);
  PLP_FOR_CHUNKS(PLP_CH_CASE)
  PLP_CH_CASE(0)
#undef PLP_CH_CASE
  return (int)cudaErrorInvalidValue;
}

template <int V>
static int group_g(const int* qT, const int* tT, int* out, int* aux, int L1p,
                   int rows, int B, int LQ, int G, int ch, int lanes,
                   int smem, cudaStream_t st) {
  if (lanes < 1 || lanes * G > PLP_GROUP_THREADS || ch < 0 ||
      (ch > 0 && (long long)ch * G < L1p) ||
      (ch == 0 && smem < 8LL * lanes * L1p))  // h and e a row a lane
    return (int)cudaErrorInvalidValue;
  switch (G) {
    case 8:
      return group_ch<8, V>(qT, tT, out, aux, L1p, rows, B, LQ, ch, lanes,
                            smem, st);
    case 16:
      return group_ch<16, V>(qT, tT, out, aux, L1p, rows, B, LQ, ch, lanes,
                             smem, st);
    case 32:
      return group_ch<32, V>(qT, tT, out, aux, L1p, rows, B, LQ, ch, lanes,
                             smem, st);
  }
  return (int)cudaErrorInvalidValue;
}

// C entry for ctypes: device pointers, then the plan of
// ops/pl_probe.plan, which owns the layouts and checks that they fit:
//   noscan, noreduce, full  p0 = G, p1 = rows a thread in registers (0:
//                           shared memory), p2 = lanes a block, p3 =
//                           shared bytes a block
//   roll                    p0 = threads a lane, p1 = rows a thread in
//                           registers (a warp a lane) or 0 (a block a
//                           lane, shared memory), p2 = lanes a block, p3
//                           = shared bytes
//   eh_only                 p0 = rows a thread, p1 = lanes a thread, p2 =
//                           threads a block, p3 = lane groups a block
// Returns cudaGetLastError() after the launch on the caller's stream, or
// cudaErrorInvalidValue on a plan the kernel does not take.
extern "C" int plp_row(const int* qT, const int* tT, int* out, int* aux,
                       int L1p, int rows, int B, int LQ, int variant, int p0,
                       int p1, int p2, int p3, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (L1p <= 0 || B <= 0) return (int)cudaGetLastError();
  int rc = 0;
  switch (variant) {
    case V_EH_ONLY:
      rc = rows_launch<ROWS_EH>(qT, tT, out, aux, L1p, rows, B, p0, p1, p2,
                                p3, st);
      break;
    case V_NOSCAN:
      rc = group_g<V_NOSCAN>(qT, tT, out, aux, L1p, rows, B, LQ, p0, p1, p2,
                             p3, st);
      break;
    case V_NOREDUCE:
      rc = group_g<V_NOREDUCE>(qT, tT, out, aux, L1p, rows, B, LQ, p0, p1,
                               p2, p3, st);
      break;
    case V_FULL:
      rc = group_g<V_FULL>(qT, tT, out, aux, L1p, rows, B, LQ, p0, p1, p2,
                           p3, st);
      break;
    case V_ROLL:
      if (p1 > 0) {  // a warp a lane, p1 slots a thread
        if ((long long)p1 * 32 < L1p) return (int)cudaErrorInvalidValue;
        const int lanes = PLP_GROUP_THREADS / 32;
#define PLP_K_CASE(KK)                                                     \
  if (p1 == KK) {                                                          \
    plp_roll_warp_kernel<KK><<<(B + lanes - 1) / lanes, PLP_GROUP_THREADS, \
                               0, st>>>(qT, tT, out, aux, L1p, rows, B, LQ); \
    break;                                                                 \
  }
        PLP_FOR_SLOTS(PLP_K_CASE)
#undef PLP_K_CASE
        return (int)cudaErrorInvalidValue;
      }
      if (p0 < 32 || p0 > PLP_ROLL_MAX || p0 % 32 ||
          p3 < 4LL * (7 * (p0 / 32) + 2LL * L1p))  // see the kernel
        return (int)cudaErrorInvalidValue;
      rc = smem_opt_in((const void*)plp_roll_block_kernel, p3);
      if (rc) break;
      plp_roll_block_kernel<<<B, p0, p3, st>>>(qT, tT, out, aux, L1p, rows, B,
                                               LQ);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

#else

// The group's G chunks of lane b, one thread after the other: the
// shuffles' scan and shift and the reductions written out, every chunk's
// pass 2 before any shift.
template <int V, class C>
static void host_group_lane(C* c, int G, const int* tT, int L1p, int rows,
                            int B, int LQ, int b, Red* red) {
  int incl[32], nxt[32], first[32], last[32];
  for (int i = 0; i < rows; ++i) {
    const int tb = tT[(long long)i * B + b];
    for (int j = 0; j < G; ++j) incl[j] = PLP_NEG;
    if (V != V_NOSCAN) {
      for (int j = 0; j < G; ++j) incl[j] = c[j].pass1(tb);
      for (int d = 1; d < G; d <<= 1) {  // __shfl_up_sync(.., d, G)
        for (int j = 0; j < G; ++j)
          nxt[j] = j >= d ? imax(incl[j], incl[j - d]) : incl[j];
        memcpy(incl, nxt, sizeof(int) * G);
      }
    }
    Red r = {0, 0, 0};
    for (int j = 0; j < G; ++j) {
      Red pr;
      last[j] = c[j].template pass2<V>(tb, j == 0 ? PLP_NEG : incl[j - 1], LQ,
                                       &first[j], &pr);
      r = j == 0 ? pr : red_max(r, pr);
    }
    for (int j = 0; j < G; ++j) c[j].shift_in(j == 0 ? first[0] : last[j - 1]);
    if (V == V_FULL) *red = r;
  }
}

template <int V, int CH>
static int host_group_reg(const int* qT, const int* tT, int* out, int* aux,
                          int L1p, int rows, int B, int LQ, int G) {
  RegChunk<CH> c[32];
  for (int b = 0; b < B; ++b) {
    for (int j = 0; j < G; ++j)
      c[j].init(qT, B, b, j * CH, chunk_rows(L1p, j, CH));
    Red red = {0, 0, 0};
    host_group_lane<V>(c, G, tT, L1p, rows, B, LQ, b, &red);
    for (int j = 0; j < G; ++j) c[j].store(out, B, b);
    aux[b] = red.mj;
    aux[B + b] = red.h1;
    aux[2 * B + b] = red.lst;
  }
  return 0;
}

template <int V>
static int host_group_smem(const int* qT, const int* tT, int* out, int* aux,
                           int L1p, int rows, int B, int LQ, int G) {
  int* st = (int*)malloc(sizeof(int) * 2 * (size_t)L1p);
  if (!st) return 1;
  SmemChunk c[32];
  const int ch = (L1p + G - 1) / G;
  for (int b = 0; b < B; ++b) {
    for (int j = 0; j < G; ++j)
      c[j].init(qT, B, b, j * ch, chunk_rows(L1p, j, ch), st, st + L1p);
    Red red = {0, 0, 0};
    host_group_lane<V>(c, G, tT, L1p, rows, B, LQ, b, &red);
    for (int j = 0; j < G; ++j) c[j].store(out, B, b);
    aux[b] = red.mj;
    aux[B + b] = red.h1;
    aux[2 * B + b] = red.lst;
  }
  free(st);
  return 0;
}

template <int V>
static int host_group(const int* qT, const int* tT, int* out, int* aux,
                      int L1p, int rows, int B, int LQ, int G, int ch) {
  if (G != 8 && G != 16 && G != 32) return 1;
  if (ch == 0) return host_group_smem<V>(qT, tT, out, aux, L1p, rows, B, LQ, G);
  if ((long long)ch * G < L1p) return 1;
#define PLP_CH_CASE(C) \
  if (ch == C) return host_group_reg<V, C>(qT, tT, out, aux, L1p, rows, B, LQ, G);
  PLP_FOR_CHUNKS(PLP_CH_CASE)
#undef PLP_CH_CASE
  return 1;
}

// roll's warp for lane b, K slots a thread, its 32 threads one after the
// other: each log step's shuffles (from thread (l - sh) % 32, its slot or
// the slot before), the register steps past 32, the exclusive value, the
// shift and the reductions, written out.
static void host_roll_warp(const int* qT, const int* tT, int* out, int L1p,
                           int rows, int B, int LQ, int K, int b, Red* red) {
  int q[32][16], h[32][16], e[32][16], mq[32][16], g[32][16], s[32][16],
      hv[32][16];
  for (int l = 0; l < 32; ++l)
    for (int k = 0; k < K; ++k) {
      const int r = 32 * k + l;
      q[l][k] = r < L1p ? qT[(long long)r * B + b] : 0;
      h[l][k] = r < L1p ? r * 3 % 17 : 0;
      e[l][k] = 0;
    }
  for (int i = 0; i < rows; ++i) {
    const int tb = tT[(long long)i * B + b];
    for (int l = 0; l < 32; ++l)
      for (int k = 0; k < K; ++k) {
        const int r = 32 * k + l;
        mq[l][k] = mq_of(h[l][k], q[l][k], tb);
        g[l][k] = r < L1p ? a_of(mq[l][k], r) : PLP_NEG;
      }
    for (int sh = 1; sh < 32; sh <<= 1) {
      for (int l = 0; l < 32; ++l)     // __shfl_sync(.., (l - sh) & 31)
        for (int k = 0; k < K; ++k) s[l][k] = g[(l - sh) & 31][k];
      for (int l = 0; l < 32; ++l)
        for (int k = 0; k < K; ++k) {
          if (l >= sh)
            g[l][k] = imax(g[l][k], s[l][k]);
          else if (k > 0)
            g[l][k] = imax(g[l][k], s[l][k - 1]);
        }
    }
    for (int m = 1; m < K; m <<= 1)
      for (int l = 0; l < 32; ++l)
        for (int k = K - 1; k >= m; --k) g[l][k] = imax(g[l][k], g[l][k - m]);
    Red pr = red_start();
    for (int l = 0; l < 32; ++l) {
      Red p = red_start();
      for (int k = 0; k < K; ++k) {
        const int r = 32 * k + l;
        const int* up = g[(l - 1) & 31];
        int Gr = l >= 1 ? up[k] : (k > 0 ? up[k - 1] : PLP_NEG);
        hv[l][k] = row_cell<V_FULL>(mq[l][k], g[l][k], r, Gr, e[l][k]);
        if (r < L1p) keep(p, hv[l][k], e[l][k], r, LQ);
      }
      pr = red_max(pr, p);
    }
    for (int l = 0; l < 32; ++l)
      for (int k = 0; k < K; ++k) {
        const int* up = hv[(l - 1) & 31];
        h[l][k] = l >= 1 ? up[k] : (k > 0 ? up[k - 1] : hv[0][0]);
      }
    *red = pr;
  }
  for (int l = 0; l < 32; ++l)
    for (int k = 0; k < K; ++k) {
      const int r = 32 * k + l;
      if (r < L1p) out[(long long)r * B + b] = h[l][k];
    }
}

// roll's block of T threads for lane b, one warp and one thread after the
// other: the log-step masked shuffles of each warp, the warps' totals and
// last rows through "shared memory", and the reductions, written out.
static void host_roll_lane(const int* qT, const int* tT, int* h, int* e,
                           int L1p, int rows, int B, int LQ, int T, int b,
                           Red* red) {
  const int W = T / 32, S = (L1p + T - 1) / T;
  int* x = (int*)malloc(sizeof(int) * 6 * (size_t)T);
  int *incl = x, *nxt = x + T, *mq = x + 2 * T, *hv = x + 3 * T,
      *ev = x + 4 * T, *a = x + 5 * T;
  for (int i = 0; i < rows; ++i) {
    const int tb = tT[(long long)i * B + b];
    int carry = PLP_NEG, hprev = 0;
    Red pr = red_start();
    for (int s = 0; s < S; ++s) {
      for (int t = 0; t < T; ++t) {
        const int r = s * T + t;
        const bool ok = r < L1p;
        mq[t] = mq_of(ok ? h[r] : 0, ok ? qT[(long long)r * B + b] : 0, tb);
        a[t] = ok ? a_of(mq[t], r) : PLP_NEG;
        incl[t] = a[t];
      }
      for (int d = 1; d < 32; d <<= 1) {  // __shfl_up_sync(.., d) a warp
        for (int t = 0; t < T; ++t)
          nxt[t] = (t & 31) >= d ? imax(incl[t], incl[t - d]) : incl[t];
        memcpy(incl, nxt, sizeof(int) * T);
      }
      int total = carry;
      for (int v = 0; v < W; ++v) total = imax(total, incl[v * 32 + 31]);
      for (int t = 0; t < T; ++t) {
        const int r = s * T + t, w = t >> 5;
        int before = carry;
        for (int v = 0; v < w; ++v) before = imax(before, incl[v * 32 + 31]);
        int Gr = (t & 31) == 0 ? before : imax(before, incl[t - 1]);
        ev[t] = r < L1p ? e[r] : 0;
        hv[t] = row_cell<V_FULL>(mq[t], a[t], r, Gr, ev[t]);
        if (r < L1p) keep(pr, hv[t], ev[t], r, LQ);
      }
      for (int t = 0; t < T; ++t) {
        const int r = s * T + t;
        if (r >= L1p) continue;
        h[r] = r == 0 ? hv[t] : (t > 0 ? hv[t - 1] : hprev);
        e[r] = ev[t];
      }
      hprev = hv[T - 1];
      carry = total;
    }
    *red = pr;
  }
  free(x);
}

// Host build of every design (all pointers are host memory), with the
// plan's ints as the C entry takes them; returns 1 on an unknown variant,
// a plan the kernel does not take, or a failed allocation.
extern "C" int plp_row_host(const int* qT, const int* tT, int* out, int* aux,
                            int L1p, int rows, int B, int LQ, int variant,
                            int p0, int p1, int p2, int p3) {
  (void)p2;
  (void)p3;
  switch (variant) {
    case V_EH_ONLY: {
      const int rc = rows_host<ROWS_EH>(qT, tT, out, L1p, rows, B, p0, p1);
      if (!rc) memset(aux, 0, sizeof(int) * 3 * (size_t)B);
      return rc;
    }
    case V_NOSCAN:
      return host_group<V_NOSCAN>(qT, tT, out, aux, L1p, rows, B, LQ, p0, p1);
    case V_NOREDUCE:
      return host_group<V_NOREDUCE>(qT, tT, out, aux, L1p, rows, B, LQ, p0,
                                    p1);
    case V_FULL:
      return host_group<V_FULL>(qT, tT, out, aux, L1p, rows, B, LQ, p0, p1);
    case V_ROLL: {
      if (p1 > 0) {
        if (p1 > 16 || (long long)p1 * 32 < L1p) return 1;
        for (int b = 0; b < B; ++b) {
          Red red = {0, 0, 0};
          host_roll_warp(qT, tT, out, L1p, rows, B, LQ, p1, b, &red);
          aux[b] = red.mj;
          aux[B + b] = red.h1;
          aux[2 * B + b] = red.lst;
        }
        return 0;
      }
      if (p0 < 32 || p0 > PLP_ROLL_MAX || p0 % 32) return 1;
      int* st = (int*)malloc(sizeof(int) * 2 * (size_t)L1p);
      if (!st) return 1;
      int *h = st, *e = st + L1p;
      for (int b = 0; b < B; ++b) {
        for (int r = 0; r < L1p; ++r) {
          h[r] = r * 3 % 17;
          e[r] = 0;
        }
        Red red = {0, 0, 0};
        host_roll_lane(qT, tT, h, e, L1p, rows, B, LQ, p0, b, &red);
        for (int r = 0; r < L1p; ++r) out[(long long)r * B + b] = h[r];
        aux[b] = red.mj;
        aux[B + b] = red.h1;
        aux[2 * B + b] = red.lst;
      }
      free(st);
      return 0;
    }
  }
  return 1;
}

#endif
