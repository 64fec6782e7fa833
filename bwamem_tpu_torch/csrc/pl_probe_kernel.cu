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
// reductions by zero (:85) and its masked roll is the shift of noreduce.
// Here the reductions go to aux, so the compiler cannot drop them and the
// ablation still prices them.  (h << 12) is an unsigned shift, wrapping as
// jnp's int32 does.
//
// Two designs, the two the redesign of the extension kernels weighs:
//   * eh_only, noscan, noreduce, full: a thread a lane.  The prefix max is
//     a running max down the rows; eh_h and eh_e live in shared memory laid
//     out [row][lane], so the threads of a warp hit different banks; qT is
//     read through L1 (a warp's row r is one 128-byte line).  The rows go
//     in tiles of PLP_TILE held in registers, the next tile loaded ahead.
//     A block takes as many lanes as its shared state allows (32 at L1p
//     136: 34.8 KB).
//   * roll: a warp a lane.  The rows are split in contiguous chunks over
//     the 32 threads; each thread takes its chunk's max of A, the warp
//     scans the chunk maxima with __shfl_up_sync (the log-step masked roll
//     of the TPU kernel is a shuffle up), then each thread runs its rows
//     from the exclusive max; the one-row shift crosses chunks by one more
//     shuffle, and the three reductions are __reduce_max_sync.  qT, eh_h
//     and eh_e of the lane live in shared memory, [row] per warp.
//
// What bounds it on an H100 (33.5 T int32 operations/s, 3.35 TB/s at
// 700 W, chip_smoke.py's peaks): operations, 5 (eh_only) to 23 (full) int32
// operations a cell over L1p x B x ROWS cells (ops/pl_probe.OPS_PER_CELL),
// against 3.3 MB of qT, tT, out and aux at the probe's defaults.  A thread
// a lane runs L1p x ROWS dependent cells on 2048 threads, a fraction of the
// card; a warp a lane runs 32 times the threads, each with a chunk of
// ceil(L1p / 32) rows and log2(32) shuffles a step.
//
// The same source compiles as host C++ (no __CUDACC__): plp_row_host runs
// the thread-a-lane loop, and for roll the warp's chunks one thread after
// the other with the shuffles spelled out, so the CPU tests check both.
#include <limits.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define PLP_HD __device__ __forceinline__
#define PLP_LDG(p) __ldg(p)
#else
#include <stdlib.h>
#define PLP_HD inline
#define PLP_LDG(p) (*(p))
#endif

#define PLP_NEG (-0x40000000)  // the TPU kernel's NEGc
enum { V_EH_ONLY = 0, V_NOSCAN = 1, V_NOREDUCE = 2, V_FULL = 3, V_ROLL = 4 };

struct Red {  // the reductions of one step
  int mj, h1, lst;
};

static PLP_HD int imax(int a, int b) { return a > b ? a : b; }

static PLP_HD int mq_of(int M, int q, int t) {
  return M != 0 ? M + (q == t ? 1 : -4) : 0;
}

static PLP_HD int enc(int h, int r) {
  return (int)(((uint32_t)h << 12) | (uint32_t)r);
}

// The running values of a thread-a-lane step.
struct Run {
  int G, prev, mj, h1, lst;
};

// Row r of a thread-a-lane step from its loaded q, h (M) and e; stores
// the row's e and the shifted h (h of row r - 1) at *hr and *er.
template <int V>
static PLP_HD void lane_row(int r, int qv, int M, int ev0, int t, int LQ,
                            int* hr, int* er, Run& run) {
  const int Mq = mq_of(M, qv, t);
  if (V == V_EH_ONLY) {
    *hr = Mq;
    return;
  }
  const int A = imax(Mq - 7, 0) + r;
  int F;
  if (V == V_NOSCAN) {
    F = A;
  } else {
    F = imax(run.G - r, 0);
    run.G = imax(run.G, A);
  }
  const int hv = imax(Mq, F);
  const int ev = imax(ev0 - 1, imax(Mq - 8, 0));
  *er = ev;
  if (V == V_FULL) {
    run.mj = imax(run.mj, enc(hv, r));
    run.h1 = r == LQ - 1 ? hv : run.h1;
    run.lst = hv != 0 || ev != 0 ? r : run.lst;
  }
  *hr = r == 0 ? hv : run.prev;
  run.prev = hv;
}

// Rows a tile of the thread-a-lane step.  The whole tiles run with the
// tile's q, h and e in registers, and the next tile's loaded before the
// tile's rows are stored (they write none of its rows), so the rows'
// loads do not wait behind the previous row's stores and the rows of a
// tile have no branch between them; the rows after the last whole tile
// run one at a time.
#define PLP_TILE 8

static PLP_HD void load_tile(const int* q, long long qs, const int* h,
                             const int* e, int s, int r0, int* qv, int* hv,
                             int* ev) {
#pragma unroll
  for (int k = 0; k < PLP_TILE; ++k) {
    qv[k] = PLP_LDG(q + (r0 + k) * qs);
    hv[k] = h[(r0 + k) * s];
    ev[k] = e[(r0 + k) * s];
  }
}

// One step of a lane, a thread a lane: rows r of q, h and e at r * qs,
// r * s; t is tT[i] of the lane.  Fills *red for V_FULL.
template <int V>
static PLP_HD void lane_step(const int* __restrict__ q, long long qs,
                             int* __restrict__ h, int* __restrict__ e, int s,
                             int L1p, int LQ, int t, Red* red) {
  Run run = {PLP_NEG, 0, INT_MIN, PLP_NEG, -1};
  const int whole = L1p / PLP_TILE * PLP_TILE;
  int qn[PLP_TILE], hn[PLP_TILE], en[PLP_TILE];
  if (whole > 0) load_tile(q, qs, h, e, s, 0, qn, hn, en);
  for (int r0 = 0; r0 < whole; r0 += PLP_TILE) {
    int qc[PLP_TILE], hc[PLP_TILE], ec[PLP_TILE];
#pragma unroll
    for (int k = 0; k < PLP_TILE; ++k) {
      qc[k] = qn[k];
      hc[k] = hn[k];
      ec[k] = en[k];
    }
    if (r0 + PLP_TILE < whole)
      load_tile(q, qs, h, e, s, r0 + PLP_TILE, qn, hn, en);
#pragma unroll
    for (int k = 0; k < PLP_TILE; ++k)
      lane_row<V>(r0 + k, qc[k], hc[k], ec[k], t, LQ, h + (r0 + k) * s,
                  e + (r0 + k) * s, run);
  }
  for (int r = whole; r < L1p; ++r)
    lane_row<V>(r, PLP_LDG(q + r * qs), h[r * s], e[r * s], t, LQ, h + r * s,
                e + r * s, run);
  if (V == V_FULL) *red = Red{run.mj, run.h1, run.lst};
}

// The warp-a-lane chunk [r0, r1) of a lane (q, h, e one word a row).
// Pass 1: the chunk's max of A.
static PLP_HD int chunk_amax(const int* q, const int* h, int r0, int r1,
                             int t) {
  int m = PLP_NEG;
  for (int r = r0; r < r1; ++r)
    m = imax(m, imax(mq_of(h[r], q[r], t) - 7, 0) + r);
  return m;
}

// Pass 2, from G = the max of A over the rows before r0: the rows' h and
// e, the shift inside the chunk (row r0 is the caller's: it needs the
// chunk before), the chunk's reductions.  Returns h of row r1 - 1 and sets
// *first to h of row r0.
static PLP_HD int chunk_rows(const int* q, int* h, int* e, int r0, int r1,
                             int G, int LQ, int t, int* first, Red* red) {
  int prev = 0, mj = INT_MIN, h1 = PLP_NEG, lst = -1;
  *first = 0;
  for (int r = r0; r < r1; ++r) {
    const int Mq = mq_of(h[r], q[r], t);
    const int A = imax(Mq - 7, 0) + r;
    const int F = imax(G - r, 0);
    G = imax(G, A);
    const int hv = imax(Mq, F);
    const int ev = imax(e[r] - 1, imax(Mq - 8, 0));
    e[r] = ev;
    mj = imax(mj, enc(hv, r));
    if (r == LQ - 1) h1 = hv;
    if (hv != 0 || ev != 0) lst = r;
    if (r > r0)
      h[r] = prev;
    else
      *first = hv;
    prev = hv;
  }
  *red = Red{mj, h1, lst};
  return prev;
}

#ifdef __CUDACC__

template <int V>
__global__ void __launch_bounds__(32)
plp_lane_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
                int* __restrict__ out, int* __restrict__ aux, int L1p,
                int rows, int B, int LQ) {
  extern __shared__ int sm[];
  const int n = blockDim.x, l = threadIdx.x, b = blockIdx.x * n + l;
  if (b >= B) return;
  int* h = sm + l;                     // [row][lane]
  int* e = sm + (long long)L1p * n + l;
  for (int r = 0; r < L1p; ++r) {
    h[r * n] = r * 3 % 17;
    e[r * n] = 0;
  }
  Red red = {0, 0, 0};
  for (int i = 0; i < rows; ++i)
    lane_step<V>(qT + b, B, h, e, n, L1p, LQ,
                 __ldg(tT + (long long)i * B + b), &red);
  for (int r = 0; r < L1p; ++r) out[(long long)r * B + b] = h[r * n];
  aux[b] = red.mj;
  aux[B + b] = red.h1;
  aux[2 * B + b] = red.lst;
}

__global__ void __launch_bounds__(128)
plp_warp_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
                int* __restrict__ out, int* __restrict__ aux, int L1p,
                int rows, int B, int LQ) {
  extern __shared__ int sm[];
  const unsigned FULL = 0xffffffffu;
  const int w = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;                  // the whole warp
  int* q = sm + (long long)w * 3 * L1p;
  int* h = q + L1p;
  int* e = h + L1p;
  for (int r = t; r < L1p; r += 32) {
    q[r] = qT[(long long)r * B + b];
    h[r] = r * 3 % 17;
    e[r] = 0;
  }
  __syncwarp();
  const int ch = (L1p + 31) / 32;
  const int r0 = t * ch < L1p ? t * ch : L1p;
  const int r1 = r0 + ch < L1p ? r0 + ch : L1p;
  Red red = {INT_MIN, PLP_NEG, -1};
  for (int i = 0; i < rows; ++i) {
    const int tb = __ldg(tT + (long long)i * B + b);
    int m = chunk_amax(q, h, r0, r1, tb);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, m, off);
      if (t >= off) m = imax(m, v);
    }
    int G = __shfl_up_sync(FULL, m, 1);
    if (t == 0) G = PLP_NEG;
    int first;
    Red pr;
    const int last = chunk_rows(q, h, e, r0, r1, G, LQ, tb, &first, &pr);
    const int up = __shfl_up_sync(FULL, last, 1);
    if (r0 < r1) h[r0] = t == 0 ? first : up;
    red.mj = __reduce_max_sync(FULL, pr.mj);
    red.h1 = __reduce_max_sync(FULL, pr.h1);
    red.lst = __reduce_max_sync(FULL, pr.lst);
  }
  __syncwarp();
  for (int r = t; r < L1p; r += 32) out[(long long)r * B + b] = h[r];
  if (t == 0) {
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

template <int V>
static int launch_lane(const int* qT, const int* tT, int* out, int* aux,
                       int L1p, int rows, int B, int LQ, int n, int smem,
                       cudaStream_t st) {
  const int rc = smem_opt_in((const void*)plp_lane_kernel<V>, smem);
  if (rc) return rc;
  plp_lane_kernel<V><<<(B + n - 1) / n, n, smem, st>>>(qT, tT, out, aux, L1p,
                                                       rows, B, LQ);
  return 0;
}

// C entry for ctypes: device pointers; `n` is the lanes of a block (a
// thread a lane) or its warps (roll), and `smem` its shared bytes, both
// from ops/pl_probe.lanes_per_block, which owns the layout (2 x L1p words
// a lane, 3 x L1p for roll) and checks that it fits.  Returns
// cudaGetLastError() after the launch on the caller's stream.
extern "C" int plp_row(const int* qT, const int* tT, int* out, int* aux,
                       int L1p, int rows, int B, int LQ, int variant, int n,
                       int smem, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (L1p <= 0 || B <= 0 || n <= 0) return (int)cudaGetLastError();
  int rc = 0;
  switch (variant) {
    case V_EH_ONLY:
      rc = launch_lane<V_EH_ONLY>(qT, tT, out, aux, L1p, rows, B, LQ, n, smem,
                                  st);
      break;
    case V_NOSCAN:
      rc = launch_lane<V_NOSCAN>(qT, tT, out, aux, L1p, rows, B, LQ, n, smem,
                                 st);
      break;
    case V_NOREDUCE:
      rc = launch_lane<V_NOREDUCE>(qT, tT, out, aux, L1p, rows, B, LQ, n,
                                   smem, st);
      break;
    case V_FULL:
      rc = launch_lane<V_FULL>(qT, tT, out, aux, L1p, rows, B, LQ, n, smem,
                               st);
      break;
    case V_ROLL:
      rc = smem_opt_in((const void*)plp_warp_kernel, smem);
      if (!rc)
        plp_warp_kernel<<<(B + n - 1) / n, 32 * n, smem, st>>>(
            qT, tT, out, aux, L1p, rows, B, LQ);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  return (int)cudaGetLastError();
}

#else

template <int V>
static void host_lane(const int* qT, const int* tT, int* h, int* e, int L1p,
                      int rows, int B, int LQ, int b, Red* red) {
  for (int i = 0; i < rows; ++i)
    lane_step<V>(qT + b, B, h, e, 1, L1p, LQ, tT[(long long)i * B + b], red);
}

// The warp's 32 chunks one after the other: the shuffles' scan and shift
// and the reductions written out, every chunk's pass 2 before any shift.
static void host_warp(const int* tT, const int* q, int* h, int* e, int L1p,
                      int rows, int B, int LQ, int b, Red* red) {
  const int ch = (L1p + 31) / 32;
  int r0[32], r1[32], G[32], first[32], last[32];
  for (int t = 0; t < 32; ++t) {
    r0[t] = t * ch < L1p ? t * ch : L1p;
    r1[t] = r0[t] + ch < L1p ? r0[t] + ch : L1p;
  }
  for (int i = 0; i < rows; ++i) {
    const int tb = tT[(long long)i * B + b];
    int m = PLP_NEG;
    for (int t = 0; t < 32; ++t) {     // exclusive scan of the chunk maxima
      G[t] = m;
      m = imax(m, chunk_amax(q, h, r0[t], r1[t], tb));
    }
    *red = Red{INT_MIN, PLP_NEG, -1};
    for (int t = 0; t < 32; ++t) {
      Red pr;
      last[t] = chunk_rows(q, h, e, r0[t], r1[t], G[t], LQ, tb, &first[t],
                           &pr);
      *red = Red{imax(red->mj, pr.mj), imax(red->h1, pr.h1),
                 imax(red->lst, pr.lst)};
    }
    for (int t = 0; t < 32; ++t)
      if (r0[t] < r1[t]) h[r0[t]] = t == 0 ? first[0] : last[t - 1];
  }
}

// Host build of the lane loops (all pointers are host memory); returns 1
// on an unknown variant or a failed allocation.
extern "C" int plp_row_host(const int* qT, const int* tT, int* out, int* aux,
                            int L1p, int rows, int B, int LQ, int variant) {
  if (variant < V_EH_ONLY || variant > V_ROLL) return 1;
  int* st = (int*)malloc(sizeof(int) * 3 * (size_t)(L1p > 0 ? L1p : 1));
  if (!st) return 1;
  int *q = st, *h = st + L1p, *e = st + 2 * L1p;
  for (int b = 0; b < B; ++b) {
    for (int r = 0; r < L1p; ++r) {
      q[r] = qT[(long long)r * B + b];
      h[r] = r * 3 % 17;
      e[r] = 0;
    }
    Red red = {0, 0, 0};
    switch (variant) {
      case V_EH_ONLY:
        host_lane<V_EH_ONLY>(qT, tT, h, e, L1p, rows, B, LQ, b, &red);
        break;
      case V_NOSCAN:
        host_lane<V_NOSCAN>(qT, tT, h, e, L1p, rows, B, LQ, b, &red);
        break;
      case V_NOREDUCE:
        host_lane<V_NOREDUCE>(qT, tT, h, e, L1p, rows, B, LQ, b, &red);
        break;
      case V_FULL:
        host_lane<V_FULL>(qT, tT, h, e, L1p, rows, B, LQ, b, &red);
        break;
      default:
        host_warp(tT, q, h, e, L1p, rows, B, LQ, b, &red);
    }
    for (int r = 0; r < L1p; ++r) out[(long long)r * B + b] = h[r];
    aux[b] = red.mj;
    aux[B + b] = red.h1;
    aux[2 * B + b] = red.lst;
  }
  free(st);
  return 0;
}

#endif
