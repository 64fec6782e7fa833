// The card's int32 rate outside the tensor cores, measured: the peak that
// every bound by int32 operations divides by (PEAK_INT32_OPS in
// chip_smoke.py, read by tools/torch_dispatch_probe.bound).  No TPU kernel
// is replaced; the wrapper is ops/int_rate.py, the timing
// tools/torch_int_rate.py and chip_smoke.py phase 1.
//
// Each thread runs IR_CHAINS independent register chains through `iters`
// iterations of IR_UNROLL unrolled steps and stores one word (the XOR of
// its chains), so that nothing is dropped.  The mixes, one step of a chain
// (q, y, z are registers fixed per thread and chain, so nothing folds):
//
//   MIX_ALU       chains in pairs (u, v): u = u + v + C, v = max(v, u):
//                 a three-input add (IADD3) and a max (IMNMX), 3 operations
//                 a pair, 1.5 a chain
//   MIX_CELL      dp_eh's cell written plainly: s = x == q ? 1 : -4,
//                 x = max(x + s, 0): compare, select, add, max, 4 operations
//   MIX_CELL_DPX  the same cell with x = __viaddmax_s32(x, s, 0): 4
//   MIX_S16X2     x = __viaddmax_s16x2_relu(x, y, z): two 16-bit cells an
//                 instruction, counted as an add and a max each, 4
//   MIX_DPX32     x = __viaddmax_s32(x, y, z): the 32-bit DPX instruction
//                 alone (the cell's max with 0 lets the compiler trade it
//                 for a plain add and max), 2
//
// A DPX instruction counts the operations of its function (add and max),
// not one.  The operations a thread does are ops/int_rate.ops_per_thread;
// the rate is their sum over the grid over the kernel's time.
//
// Compiled as host C++ (no __CUDACC__), int_rate_host runs the same chains
// per thread, with dpx.cuh's plain C definitions of the DPX intrinsics, so
// that the CPU tests hold them against ops/int_rate.plain.
#include <stdint.h>

#include "dpx.cuh"

#ifdef __CUDACC__
#define IR_HD __device__ __forceinline__
#else
#define IR_HD inline
#endif

#define IR_CHAINS 8
#define IR_UNROLL 16
enum { MIX_ALU = 0, MIX_CELL = 1, MIX_CELL_DPX = 2, MIX_S16X2 = 3,
       MIX_DPX32 = 4 };

static IR_HD int ir_add(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
static IR_HD int ir_max(int a, int b) { return a > b ? a : b; }

// The chains of thread `tid`: starting values and the fixed registers.
// ops/int_rate.plain draws the same.
static IR_HD int ir_seed(int seed, int tid, int k, int salt) {
  return (int)((uint32_t)seed * 2654435761u + (uint32_t)tid * 40503u +
               (uint32_t)k * 977u + (uint32_t)salt) & 0x3fff;
}

template <int MIX>
static IR_HD int ir_thread(int tid, int iters, int seed) {
  int x[IR_CHAINS], q[IR_CHAINS], y[IR_CHAINS], z[IR_CHAINS];
#pragma unroll
  for (int k = 0; k < IR_CHAINS; ++k) {
    x[k] = ir_seed(seed, tid, k, 0);
    q[k] = ir_seed(seed, tid, k, 1) & 31;
    y[k] = ir_seed(seed, tid, k, 2) - 0x2000;
    z[k] = ir_seed(seed, tid, k, 3) - 0x2000;
  }
  if (MIX == MIX_S16X2) {
#pragma unroll
    for (int k = 0; k < IR_CHAINS; ++k) {
      const uint32_t y0 = (uint32_t)y[k], z0 = (uint32_t)z[k];
      x[k] = (int)((uint32_t)x[k] | ((uint32_t)q[k] << 16));
      y[k] = (int)((y0 & 0xffffu) | (z0 << 16));
      z[k] = (int)((z0 & 0xffffu) | (y0 << 16));
    }
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int u = 0; u < IR_UNROLL; ++u) {
      if (MIX == MIX_ALU) {
#pragma unroll
        for (int k = 0; k < IR_CHAINS; k += 2) {
          x[k] = ir_add(ir_add(x[k], x[k + 1]), y[k]);
          x[k + 1] = ir_max(x[k + 1], x[k]);
        }
      } else if (MIX == MIX_S16X2) {
#pragma unroll
        for (int k = 0; k < IR_CHAINS; ++k)
          x[k] = (int)dpx_addmax16x2_relu((unsigned)x[k], (unsigned)y[k],
                                          (unsigned)z[k]);
      } else if (MIX == MIX_DPX32) {
#pragma unroll
        for (int k = 0; k < IR_CHAINS; ++k)
          x[k] = dpx_addmax(x[k], y[k], z[k]);
      } else {
#pragma unroll
        for (int k = 0; k < IR_CHAINS; ++k) {
          const int s = x[k] == q[k] ? 1 : -4;
          x[k] = MIX == MIX_CELL_DPX ? dpx_addmax(x[k], s, 0)
                                     : ir_max(ir_add(x[k], s), 0);
        }
      }
    }
  }
  int acc = 0;
#pragma unroll
  for (int k = 0; k < IR_CHAINS; ++k) acc ^= x[k];
  return acc;
}

#ifdef __CUDACC__

template <int MIX>
__global__ void __launch_bounds__(256)
int_rate_kernel(int* __restrict__ out, int iters, int seed) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  out[tid] = ir_thread<MIX>(tid, iters, seed);
}

// C entry for ctypes: `blocks` x `threads` threads (threads <= 256), one
// word each to out; returns cudaGetLastError() after the launch on the
// caller's stream.
extern "C" int int_rate(int* out, int blocks, int threads, int iters,
                        int seed, int mix, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (blocks <= 0 || threads <= 0 || threads > 256)
    return (int)cudaErrorInvalidValue;
  switch (mix) {
    case MIX_ALU:
      int_rate_kernel<MIX_ALU><<<blocks, threads, 0, st>>>(out, iters, seed);
      break;
    case MIX_CELL:
      int_rate_kernel<MIX_CELL><<<blocks, threads, 0, st>>>(out, iters,
                                                            seed);
      break;
    case MIX_CELL_DPX:
      int_rate_kernel<MIX_CELL_DPX><<<blocks, threads, 0, st>>>(out, iters,
                                                                seed);
      break;
    case MIX_S16X2:
      int_rate_kernel<MIX_S16X2><<<blocks, threads, 0, st>>>(out, iters,
                                                             seed);
      break;
    case MIX_DPX32:
      int_rate_kernel<MIX_DPX32><<<blocks, threads, 0, st>>>(out, iters,
                                                             seed);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

#else

// Host build: the chains of threads 0 .. n - 1 (out host memory); returns
// 1 on an unknown mix.
extern "C" int int_rate_host(int* out, int n, int iters, int seed, int mix) {
  for (int tid = 0; tid < n; ++tid) {
    switch (mix) {
      case MIX_ALU: out[tid] = ir_thread<MIX_ALU>(tid, iters, seed); break;
      case MIX_CELL: out[tid] = ir_thread<MIX_CELL>(tid, iters, seed); break;
      case MIX_CELL_DPX:
        out[tid] = ir_thread<MIX_CELL_DPX>(tid, iters, seed);
        break;
      case MIX_S16X2:
        out[tid] = ir_thread<MIX_S16X2>(tid, iters, seed);
        break;
      case MIX_DPX32:
        out[tid] = ir_thread<MIX_DPX32>(tid, iters, seed);
        break;
      default:
        return 1;
    }
  }
  return 0;
}

// Host build: one DPX form of dpx.cuh on (a, b, c) (op 0 addmax, 1
// addmax_relu, 2 addmax16x2, 3 addmax16x2_relu), for the CPU tests'
// edge cases.
extern "C" int dpx_host(int op, int a, int b, int c) {
  switch (op) {
    case 0: return dpx_addmax(a, b, c);
    case 1: return dpx_addmax_relu(a, b, c);
    case 2: return (int)dpx_addmax16x2((unsigned)a, (unsigned)b, (unsigned)c);
    default:
      return (int)dpx_addmax16x2_relu((unsigned)a, (unsigned)b, (unsigned)c);
  }
}

#endif
