// The column-0 gather out[q] = tab[k[q], 0] of a [R, W] int32 table, for
// two TPU probe kernels that price it at two widths:
//
//   kernel in probe_d,  tools/pl_gather_probe2.py:122 (pallas_call :132):
//                       1024 lanes of a [78208, 8] table (one `aln` occ
//                       round's lookups); C entry gp2_col0
//   kernel in probe_d2, tools/pl_gather_probe3.py:103 (pallas_call :110):
//                       8 lanes of the same table; C entry gp3_col0
//
// Both C entries (csrc/gather_probe2_kernel.cu and gather_probe3_kernel.cu
// include this file) launch the one kernel below through col0_launch, and
// both host entries run the one lane loop col0_host.
//
// What bounds it on an H100 (3.35 TB/s at 700 W): bytes, and there are
// few: k read once, out written once and one 32-byte sector of each row
// touched, 12 KB at 1024 lanes and under 100 bytes at 8, well under a
// microsecond.  So the launch is what one sees, on the host (the
// wrapper's issue) and on the device (a launch's latency between two
// kernels).  The design spends nothing past the gather: a thread a lane,
// one coalesced read of k, one read-only (ld.global.nc) load of the
// table word and one store; one warp for up to 32 lanes, else blocks of
// COL0_BLOCK threads over the lanes.  It launches with programmatic
// dependent launch (cudaLaunchAttributeProgrammaticStreamSerialization):
// the kernel lets the next one on its stream start at once
// (griddepcontrol.launch_dependents) and waits for the one before it to
// finish and flush (griddepcontrol.wait) before its first read of k or
// tab, so a launch's latency overlaps the kernel ahead of it.  A kernel
// not launched that way passes the wait at once.
//
// Compiled as host C++ (no __CUDACC__), the lane loop is built instead of
// the kernel.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define COL0_HD __device__
#define COL0_LDG(p) __ldg(p)
#else
#define COL0_HD
#define COL0_LDG(p) (*(p))
#endif

#define COL0_BLOCK 128      // threads a block past one warp

// lane q: word 0 of row k[q] of the W-word table (k[q] in [0, R))
static COL0_HD inline int col0_lane(const int* __restrict__ tab,
                                    const int* __restrict__ k, int q,
                                    int W) {
  return COL0_LDG(tab + (long long)COL0_LDG(k + q) * W);
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(COL0_BLOCK)
col0_kernel(const int* __restrict__ tab, const int* __restrict__ k,
            int* __restrict__ out, int N, int W) {
  asm volatile("griddepcontrol.launch_dependents;");
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q < N) out[q] = col0_lane(tab, k, q, W);
}

// col0_kernel over N lanes on `stream`; returns the launch's error, or
// cudaGetLastError() after it (so no error is left pending for the next
// entry to report).
static inline int col0_launch(const int* tab, const int* k, int* out, int N,
                              int W, cudaStream_t stream) {
  if (N > 0) {
    const int threads = N <= 32 ? 32 : COL0_BLOCK;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((N + threads - 1) / threads);
    cfg.blockDim = dim3(threads);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, col0_kernel, tab, k, out,
                                             N, W);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
  }
  return (int)cudaGetLastError();
}

#else

// the lane loop on the host (all pointers host memory)
static inline int col0_host(const int* tab, const int* k, int* out, int N,
                            int W) {
  for (int q = 0; q < N; ++q) out[q] = col0_lane(tab, k, q, W);
  return 0;
}

#endif
