// The (row, lane) cell design, shared by two kernels whose cells are
// independent recurrences over ROWS target rows, on qT int32 [L1p, B] (a
// query base a row) and tT int32 [ROWS, B], from eh = r * 3 % 17:
//
//   ROWS_DP32   dp_eh (dispatch_probe_kernel.cu): s = qT[r, b] == tT[i, b]
//               ? 1 : -4, eh = max(eh + s, 0), written plainly: on sm_90
//               __viaddmax_s32 runs at half the rate of the add and max the
//               compiler makes of it (tools/torch_int_rate.py;
//               tools/torch_row_variants.py builds a copy that uses it)
//   ROWS_DP16   the same, two rows of a lane packed in one word of 16-bit
//               halves: s2 = 0xFFFCFFFC ^ (the rows' compare masks & 0xFFFD
//               in each half), one LOP3, then __viaddmax_s16x2_relu(eh2,
//               s2, 0).  Exact while eh <= 16 + ROWS fits in int16 (the
//               wrapper checks ROWS) and the halves never carry.
//   ROWS_EH     plp_row's eh_only (pl_probe_kernel.cu): eh = eh != 0 ?
//               eh + s : 0, not clamped (it goes negative)
//
// A thread takes RPT rows of LPT adjacent lanes (LPT 4: one 16-byte load
// of qT a row, one of tT a step), its RPT x LPT cells in registers, so a
// step costs one load of tT for all of them; the loads of the next
// ROWS_AHEAD steps are in flight while a step runs.  A block is either a
// run of lanes (LGB = threads: lanes fastest, so a warp's loads of a row
// are one contiguous run, every thread loading its own tT), or a tile of
// LGB lane groups by threads / LGB row groups that stages ROWS_STAGE steps
// of its lanes' tT in shared memory at a time, one coalesced load a word
// for the whole tile, the rows reading it from there.
// Every cell runs every step: nothing skips a row or a lane whose state is
// 0.
#pragma once
#include <stdint.h>

#include "dpx.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ROWS_HD __device__ __forceinline__
#define ROWS_BOTH __host__ __device__ inline   // called by the launch too
#define ROWS_LDG(p) __ldg(p)
#else
#define ROWS_HD inline
#define ROWS_BOTH inline
#define ROWS_LDG(p) (*(p))
#endif

enum { ROWS_DP32 = 0, ROWS_DP16 = 1, ROWS_EH = 2 };
#define ROWS_AHEAD 4        // steps of tT loaded ahead
#define ROWS_STAGE 32       // steps of tT a tile stages in shared memory
// Every loop that follows #pragma unroll as the body of an if, an else or
// another loop stands in braces: nvcc does not keep such a loop inside a
// braceless if constexpr, and the host compiler ignores the pragma, so
// only the card would see the difference.

// LPT words from p (16-byte aligned when LPT is 4)
template <int LPT>
static ROWS_HD void rows_load(const int* __restrict__ p, int* v) {
#ifdef __CUDACC__
  if (LPT == 4) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
    return;
  }
#endif
#pragma unroll
  for (int l = 0; l < LPT; ++l) v[l] = ROWS_LDG(p + l);
}

// One step of the thread's cells at target row values t[LPT].
template <int RPT, int LPT, int KIND>
static ROWS_HD void rows_step(const int (&q)[RPT][LPT], int (&eh)[RPT][LPT],
                              const int* t) {
  if constexpr (KIND == ROWS_DP16) {
#pragma unroll
    for (int k = 0; k < RPT; k += 2) {
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const unsigned m = (q[k][l] == t[l] ? 0x0000FFFDu : 0u) |
                           (q[k + 1][l] == t[l] ? 0xFFFD0000u : 0u);
        eh[k][l] = (int)dpx_addmax16x2_relu((unsigned)eh[k][l],
                                            0xFFFCFFFCu ^ m, 0u);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < RPT; ++k) {
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        const int s = q[k][l] == t[l] ? 1 : -4;
        if constexpr (KIND == ROWS_DP32) {
          eh[k][l] = eh[k][l] + s > 0 ? eh[k][l] + s : 0;
        } else {
          eh[k][l] = eh[k][l] != 0 ? eh[k][l] + s : 0;
        }
      }
    }
  }
}

// A thread's cells at rows r0 .., lanes b0 ..: q loaded (0 past L1p), eh
// from r * 3 % 17.  ROWS_DP16 keeps rows k and k + 1 in the halves of
// eh[k] (RPT even).
template <int RPT, int LPT, int KIND>
static ROWS_HD void rows_init(const int* __restrict__ qT, int L1p, int B,
                              int r0, int b0, int (&q)[RPT][LPT],
                              int (&eh)[RPT][LPT]) {
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (r0 + k < L1p) {
      rows_load<LPT>(qT + (long long)(r0 + k) * B + b0, q[k]);
    } else {
#pragma unroll
      for (int l = 0; l < LPT; ++l) q[k][l] = 0;
    }
#pragma unroll
    for (int l = 0; l < LPT; ++l) eh[k][l] = (r0 + k) * 3 % 17;
  }
  if constexpr (KIND == ROWS_DP16) {
#pragma unroll
    for (int k = 0; k < RPT; k += 2) {
#pragma unroll
      for (int l = 0; l < LPT; ++l)
        eh[k][l] = (int)(((unsigned)eh[k][l] & 0xFFFFu) |
                         ((unsigned)eh[k + 1][l] << 16));
    }
  }
}

// The cells' eh to out, rows past L1p left out.
template <int RPT, int LPT, int KIND>
static ROWS_HD void rows_store(int* __restrict__ out, int L1p, int B, int r0,
                               int b0, int (&eh)[RPT][LPT]) {
  if constexpr (KIND == ROWS_DP16) {
#pragma unroll
    for (int k = RPT - 2; k >= 0; k -= 2) {
#pragma unroll
      for (int l = 0; l < LPT; ++l) {
        eh[k + 1][l] = (int)(int16_t)(uint16_t)((unsigned)eh[k][l] >> 16);
        eh[k][l] = (int)(int16_t)(uint16_t)(unsigned)eh[k][l];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    if (r0 + k < L1p) {
#pragma unroll
      for (int l = 0; l < LPT; ++l)
        out[(long long)(r0 + k) * B + b0 + l] = eh[k][l];
    }
  }
}

// The cells of thread (lane group lg, row group rg), each loading its own
// tT: rows rg * RPT .., lanes lg * LPT ..; rows past L1p run too and are
// not stored.
template <int RPT, int LPT, int KIND>
static ROWS_HD void rows_thread(const int* __restrict__ qT,
                                const int* __restrict__ tT,
                                int* __restrict__ out, int L1p, int rows,
                                int B, int lg, int rg) {
  const int r0 = rg * RPT, b0 = lg * LPT;
  int q[RPT][LPT], eh[RPT][LPT];
  rows_init<RPT, LPT, KIND>(qT, L1p, B, r0, b0, q, eh);
  const int* tb = tT + b0;
  int t[ROWS_AHEAD][LPT];
#pragma unroll
  for (int a = 0; a < ROWS_AHEAD; ++a)
    if (a < rows) rows_load<LPT>(tb + (long long)a * B, t[a]);
  const int whole = rows / ROWS_AHEAD * ROWS_AHEAD;
  for (int i0 = 0; i0 < whole; i0 += ROWS_AHEAD) {
    int c[ROWS_AHEAD][LPT];
#pragma unroll
    for (int a = 0; a < ROWS_AHEAD; ++a) {
#pragma unroll
      for (int l = 0; l < LPT; ++l) c[a][l] = t[a][l];
    }
#pragma unroll
    for (int a = 0; a < ROWS_AHEAD; ++a)
      if (i0 + ROWS_AHEAD + a < rows)
        rows_load<LPT>(tb + (long long)(i0 + ROWS_AHEAD + a) * B, t[a]);
#pragma unroll
    for (int a = 0; a < ROWS_AHEAD; ++a) rows_step<RPT, LPT, KIND>(q, eh,
                                                                   c[a]);
  }
#pragma unroll
  for (int a = 0; a < ROWS_AHEAD - 1; ++a)
    if (whole + a < rows) rows_step<RPT, LPT, KIND>(q, eh, t[a]);
  rows_store<RPT, LPT, KIND>(out, L1p, B, r0, b0, eh);
}

// Lane groups and row groups of a call.
static ROWS_BOTH int rows_lane_groups(int B, int LPT) { return B / LPT; }
static ROWS_BOTH int rows_row_groups(int L1p, int RPT) {
  return (L1p + RPT - 1) / RPT;
}

#ifdef __CUDACC__

// aux, where given, is plp_row's [3, B] side output, 0 for eh_only.
// A block: lgb lane groups by blockDim.x / lgb row groups.
template <int RPT, int LPT, int KIND>
__global__ void __launch_bounds__(512)
rows_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
            int* __restrict__ out, int* __restrict__ aux, int L1p, int rows,
            int B, int lgb) {
  const int lg = blockIdx.x * lgb + threadIdx.x % lgb;
  const int rg = blockIdx.y * (blockDim.x / lgb) + threadIdx.x / lgb;
  if (lg >= rows_lane_groups(B, LPT) || rg >= rows_row_groups(L1p, RPT))
    return;
  if (aux && rg == 0) {
#pragma unroll
    for (int l = 0; l < LPT; ++l)
      aux[lg * LPT + l] = aux[B + lg * LPT + l] = aux[2 * B + lg * LPT + l] =
          0;
  }
  rows_thread<RPT, LPT, KIND>(qT, tT, out, L1p, rows, B, lg, rg);
}

// A tile of lgb lane groups by blockDim.x / lgb row groups, its lanes' tT
// staged ROWS_STAGE steps at a time in shared memory (W = lgb * LPT words
// a step), double-buffered: each thread loads its share of the next chunk
// (at most ROWS_STAGE_REGS words, in registers) before the tile runs the
// chunk in shared memory, and stores it after.  Threads past the last lane
// or row group load and wait with the others and store nothing.
#define ROWS_STAGE_REGS 8
template <int RPT, int LPT, int KIND>
__global__ void __launch_bounds__(512)
rows_tile_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
                 int* __restrict__ out, int* __restrict__ aux, int L1p,
                 int rows, int B, int lgb) {
  extern __shared__ int stage[];
  const int tl = threadIdx.x % lgb;
  const int lg = blockIdx.x * lgb + tl;
  const int rg = blockIdx.y * (blockDim.x / lgb) + threadIdx.x / lgb;
  const bool live = lg < rows_lane_groups(B, LPT) &&
                    rg < rows_row_groups(L1p, RPT);
  const int W = lgb * LPT, b0 = blockIdx.x * W;
  if (aux && live && rg == 0) {
#pragma unroll
    for (int l = 0; l < LPT; ++l)
      aux[lg * LPT + l] = aux[B + lg * LPT + l] = aux[2 * B + lg * LPT + l] =
          0;
  }
  const int r0 = rg * RPT;
  int q[RPT][LPT], eh[RPT][LPT];
  rows_init<RPT, LPT, KIND>(qT, L1p, B, live ? r0 : L1p, lg * LPT, q, eh);
  int v[ROWS_STAGE_REGS];  // this thread's words of the next chunk
  auto fetch = [&](int i0) {
#pragma unroll
    for (int j = 0; j < ROWS_STAGE_REGS; ++j) {
      const int x = threadIdx.x + j * blockDim.x;
      const int s = x / W, c = x - s * W;
      v[j] = x < ROWS_STAGE * W && i0 + s < rows && b0 + c < B
                 ? __ldg(tT + (long long)(i0 + s) * B + b0 + c)
                 : 0;
    }
  };
  fetch(0);
  for (int i0 = 0; i0 < rows; i0 += ROWS_STAGE) {
    __syncthreads();  // the last chunk is read
#pragma unroll
    for (int j = 0; j < ROWS_STAGE_REGS; ++j) {
      const int x = threadIdx.x + j * blockDim.x;
      if (x < ROWS_STAGE * W) stage[x] = v[j];
    }
    __syncthreads();
    if (i0 + ROWS_STAGE < rows) fetch(i0 + ROWS_STAGE);
    const int* row = stage + tl * LPT;
    if (i0 + ROWS_STAGE <= rows) {  // a whole chunk: its steps unrolled
#pragma unroll 8
      for (int s = 0; s < ROWS_STAGE; ++s) {
        int t[LPT];
#pragma unroll
        for (int l = 0; l < LPT; ++l) t[l] = row[s * W + l];
        rows_step<RPT, LPT, KIND>(q, eh, t);
      }
    } else {
      for (int s = 0; s < rows - i0; ++s) {
        int t[LPT];
#pragma unroll
        for (int l = 0; l < LPT; ++l) t[l] = row[s * W + l];
        rows_step<RPT, LPT, KIND>(q, eh, t);
      }
    }
  }
  if (live) rows_store<RPT, LPT, KIND>(out, L1p, B, r0, lg * LPT, eh);
}

template <int RPT, int LPT, int KIND>
static int rows_launch_one(const int* qT, const int* tT, int* out, int* aux,
                           int L1p, int rows, int B, int threads, int lgb,
                           cudaStream_t st) {
  const int rgb = threads / lgb;
  const dim3 grid((rows_lane_groups(B, LPT) + lgb - 1) / lgb,
                  (rows_row_groups(L1p, RPT) + rgb - 1) / rgb);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  if (lgb == threads)
    rows_kernel<RPT, LPT, KIND><<<grid, threads, 0, st>>>(qT, tT, out, aux,
                                                          L1p, rows, B, lgb);
  else
    rows_tile_kernel<RPT, LPT, KIND>
        <<<grid, threads, sizeof(int) * ROWS_STAGE * lgb * LPT, st>>>(
            qT, tT, out, aux, L1p, rows, B, lgb);
  return 0;
}

// The plan's kernel: rpt in {1, 2, 4, 8, 16} (even for ROWS_DP16), lpt in
// {1, 4} (4: B % 4 == 0 and 16-byte aligned qT, tT and out), threads a
// block in [32, 512], lgb lane groups a block dividing them (a tile: lgb <
// threads, its ROWS_STAGE steps of lgb * lpt words at most
// ROWS_STAGE_REGS a thread); cudaErrorInvalidValue on another plan.
template <int KIND>
static int rows_launch(const int* qT, const int* tT, int* out, int* aux,
                       int L1p, int rows, int B, int rpt, int lpt,
                       int threads, int lgb, cudaStream_t st) {
  const uintptr_t at = (uintptr_t)qT | (uintptr_t)tT | (uintptr_t)out;
  if (threads < 32 || threads > 512 || (lpt == 4 && (B % 4 || at % 16)) ||
      (KIND == ROWS_DP16 && rpt < 2) || lgb < 1 || threads % lgb ||
      (lgb < threads && ROWS_STAGE * lgb * lpt > ROWS_STAGE_REGS * threads))
    return (int)cudaErrorInvalidValue;
#define ROWS_CASE(R, L)                                                    \
  if (rpt == R && lpt == L)                                                \
    return rows_launch_one<R, L, KIND>(qT, tT, out, aux, L1p, rows, B,     \
                                       threads, lgb, st);
  if constexpr (KIND != ROWS_DP16) {
    ROWS_CASE(1, 1) ROWS_CASE(1, 4)
  }
  ROWS_CASE(2, 1) ROWS_CASE(2, 4) ROWS_CASE(4, 1) ROWS_CASE(4, 4)
  ROWS_CASE(8, 1) ROWS_CASE(8, 4) ROWS_CASE(16, 1) ROWS_CASE(16, 4)
#undef ROWS_CASE
  return (int)cudaErrorInvalidValue;
}

#else

// Host build: every thread of the plan one after the other; returns 1 on
// a plan the kernel does not take.
template <int RPT, int LPT, int KIND>
static int rows_host_one(const int* qT, const int* tT, int* out, int L1p,
                         int rows, int B) {
  for (int rg = 0; rg < rows_row_groups(L1p, RPT); ++rg)
    for (int lg = 0; lg < rows_lane_groups(B, LPT); ++lg)
      rows_thread<RPT, LPT, KIND>(qT, tT, out, L1p, rows, B, lg, rg);
  return 0;
}

template <int KIND>
static int rows_host(const int* qT, const int* tT, int* out, int L1p,
                     int rows, int B, int rpt, int lpt) {
  if ((lpt == 4 && B % 4) || (KIND == ROWS_DP16 && rpt < 2)) return 1;
#define ROWS_CASE(R, L)                                                    \
  if (rpt == R && lpt == L)                                                \
    return rows_host_one<R, L, KIND>(qT, tT, out, L1p, rows, B);
  if constexpr (KIND != ROWS_DP16) {
    ROWS_CASE(1, 1) ROWS_CASE(1, 4)
  }
  ROWS_CASE(2, 1) ROWS_CASE(2, 4) ROWS_CASE(4, 1) ROWS_CASE(4, 4)
  ROWS_CASE(8, 1) ROWS_CASE(8, 4) ROWS_CASE(16, 1) ROWS_CASE(16, 4)
#undef ROWS_CASE
  return 1;
}

#endif
