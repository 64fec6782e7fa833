// Dynamic shared memory past the 48 KB a launch gets by default: a kernel
// must opt in before it is launched with more (up to 227 KB a block on an
// H100).  Included by the CUDA builds of gather_probe_kernel.cu and
// gather_probe3_kernel.cu.
#pragma once

#include <cuda_runtime.h>

#include <stddef.h>

// opts `fn` into `bytes` of dynamic shared memory where that is past 48 KB;
// returns the CUDA error code (0 on success)
static inline int smem_opt_in(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}
