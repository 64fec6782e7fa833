// The dispatch probe's kernel (make_kernel(L1p, ROWS, B).kernel of
// tools/dispatch_probe.py:32, pallas_call :53), the function alone:
//
//   dp_eh   out[r, b] = eh after ROWS steps of
//           eh = max(eh + (qT[r, b] == tT[i, b] ? 1 : -4), 0), i < ROWS,
//           from eh = r * 3 % 17; qT and out int32 [L1p, B], tT [ROWS, B].
//           (The TPU kernel reads tT at min(i, ROWS - 1), which inside the
//           loop is always i.)
//
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W; 3.35 TB/s, and
// the int32 rate that chip_smoke.py phase 1 measures, PEAK_INT32_OPS): 4
// int32 operations a cell (compare, select, add, max) over L1p x B x ROWS
// cells against qT, tT and out moved once.  At the probe's L1p = 136, B =
// 2048: ROWS = 8 is bytes (2.3 MB) and under the launch's own cost, ROWS =
// 128 to 2048 operations.
//
// The design (csrc/rows.cuh, ROWS_DP32 and ROWS_DP16): every cell is an
// independent recurrence, so a thread takes RPT rows of LPT adjacent lanes
// and keeps its cells in registers; a step is one load of tT[i, b..] for
// all of them (issued ROWS_AHEAD steps ahead) and, a cell, a compare, a
// select, an add and a max.  A block is a tile of lanes by row groups, so
// that a tT word read once from L2 serves the tile's rows.  The 16x2 form
// packs two rows in one word and runs two cells a DPX add-max
// (__viaddmax_s16x2_relu), for ROWS up to 32751 (the wrapper keeps the
// 32-bit form past it).  The 32-bit cell is not written as __viaddmax_s32:
// sm_90 runs that at half the rate of the add and max the compiler makes
// of the plain form (tools/torch_int_rate.py), and the kernel measured
// slower with it (tools/torch_row_variants.py).  The design this replaced,
// a thread a cell with a load of tT each step, is kept only in that tool.  The
// plan (RPT, LPT, bits, threads and lane groups a block) is the wrapper's:
// ops/dispatch_probe.plan.
//
// The same source compiles as host C++ (no __CUDACC__), exposing every
// plan's threads one after another as dp_eh_host, so the CPU tests check
// its arithmetic, DPX and 16-bit packing included, without a card.
#include "rows.cuh"

#ifdef __CUDACC__

// C entry for ctypes: device pointers; rpt, lpt, bits (32 or 16), threads
// a block and lgb (lane groups a block) from ops/dispatch_probe.plan,
// which checks shapes and alignment.  Returns cudaGetLastError() after the
// launch on the caller's stream, or cudaErrorInvalidValue on a plan the
// kernel does not take.
extern "C" int dp_eh(const int* qT, const int* tT, int* out, int L1p,
                     int rows, int B, int rpt, int lpt, int bits,
                     int threads, int lgb, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (L1p <= 0 || B <= 0) return (int)cudaGetLastError();
  const int rc = bits == 16
                     ? rows_launch<ROWS_DP16>(qT, tT, out, nullptr, L1p, rows,
                                              B, rpt, lpt, threads, lgb, st)
                     : rows_launch<ROWS_DP32>(qT, tT, out, nullptr, L1p, rows,
                                              B, rpt, lpt, threads, lgb, st);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

#else

// Host build of the plan's threads (all pointers are host memory); returns
// 1 on a plan the kernel does not take.
extern "C" int dp_eh_host(const int* qT, const int* tT, int* out, int L1p,
                          int rows, int B, int rpt, int lpt, int bits) {
  return bits == 16
             ? rows_host<ROWS_DP16>(qT, tT, out, L1p, rows, B, rpt, lpt)
             : rows_host<ROWS_DP32>(qT, tT, out, L1p, rows, B, rpt, lpt);
}

#endif
