// The dispatch probe's kernel (make_kernel(L1p, ROWS, B).kernel of
// tools/dispatch_probe.py:32, pallas_call :53), the function alone:
//
//   dp_eh   out[r, b] = eh after ROWS steps of
//           eh = max(eh + (qT[r, b] == tT[i, b] ? 1 : -4), 0), i < ROWS,
//           from eh = r * 3 % 17; qT and out int32 [L1p, B], tT [ROWS, B].
//           (The TPU kernel reads tT at min(i, ROWS - 1), which inside the
//           loop is always i.)
//
// Every element is independent, so a thread takes one (r, b) and runs its
// ROWS steps in a register.  A block is 128 lanes by 4 rows, lanes fastest
// across the threads of a warp: the qT and out accesses are coalesced, a
// warp reads tT[i, b..b+31] as one 128-byte line a step, and the four row
// warps of a block find it in L1.
//
// What bounds it on an H100 (3.35 TB/s, 33.5 T int32 operations/s at
// 700 W, chip_smoke.py's peaks): about 4 int32 operations a cell (compare,
// select, add, max) over L1p x B x ROWS cells against qT, tT and out moved
// once.  At the probe's L1p = 136, B = 2048: ROWS = 8 is bytes (2.3 MB,
// 0.7 us), ROWS = 2048 operations (2.3 G, 0.068 ms).  The TPU script uses
// it to price a call against its work; on this card the launch and the
// host's issue are what one sees at small ROWS.
//
// The same source compiles as host C++ (no __CUDACC__), exposing the lane
// loop as dp_eh_host, so the CPU tests check its arithmetic without a card.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DP_HD __device__ __forceinline__
#define DP_LDG(p) __ldg(p)
#else
#define DP_HD inline
#define DP_LDG(p) (*(p))
#endif

// one element's ROWS steps; t points at tT[0, b], rows B words apart
static DP_HD int dp_cell(int q, const int* __restrict__ t, int B, int rows,
                         int eh) {
#ifdef __CUDACC__
#pragma unroll 4
#endif
  for (int i = 0; i < rows; ++i) {
    const int v = eh + (q == DP_LDG(t + (long long)i * B) ? 1 : -4);
    eh = v > 0 ? v : 0;
  }
  return eh;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(512)
dp_eh_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
             int* __restrict__ out, int L1p, int rows, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (b >= B || r >= L1p) return;
  const long long e = (long long)r * B + b;
  out[e] = dp_cell(__ldg(qT + e), tT + b, B, rows, r * 3 % 17);
}

// C entry for ctypes: device pointers; returns cudaGetLastError() after
// the launch on the caller's stream.  ops/dispatch_probe.py checks shapes.
extern "C" int dp_eh(const int* qT, const int* tT, int* out, int L1p,
                     int rows, int B, void* stream) {
  const dim3 block(128, 4);
  const dim3 grid((B + 127) / 128, (L1p + 3) / 4);
  if (L1p > 0 && B > 0)
    dp_eh_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(qT, tT, out, L1p,
                                                           rows, B);
  return (int)cudaGetLastError();
}

#else

// Host build of the lane loop (all pointers are host memory).
extern "C" int dp_eh_host(const int* qT, const int* tT, int* out, int L1p,
                          int rows, int B) {
  for (int r = 0; r < L1p; ++r)
    for (int b = 0; b < B; ++b) {
      const long long e = (long long)r * B + b;
      out[e] = dp_cell(qT[e], tT + b, B, rows, r * 3 % 17);
    }
  return 0;
}

#endif
