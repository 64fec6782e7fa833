// Hopper's DPX add-max instructions, under names of this package, for the
// kernels that run the extension row's recurrence (pl_probe_kernel.cu,
// dispatch_probe_kernel.cu, int_rate_kernel.cu).
//
// On the card each maps to its CUDA intrinsic, which sm_90 runs as one
// instruction (VIADDMNMX) and older targets emulate.  Compiled as host C++
// (no __CUDACC__) each is written out in plain C with the intrinsic's
// semantics, so that the CPU tests run the formulas the card runs:
//
//   dpx_addmax(a, b, c)          max(a + b, c)               __viaddmax_s32
//   dpx_addmax_relu(a, b, c)     max(max(a + b, c), 0)       __viaddmax_s32_relu
//   dpx_addmax16x2(a, b, c)      per 16-bit half, as s16     __viaddmax_s16x2
//   dpx_addmax16x2_relu(a, b, c) per 16-bit half, as s16     __viaddmax_s16x2_relu
//
// The adds wrap: a + b in 32 bits, and in the 16x2 forms each half's sum
// in 16 bits with no carry into the other half (the host code adds the
// halves apart and keeps the low 16 bits of each).
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define DPX_HD __device__ __forceinline__

static DPX_HD int dpx_addmax(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);
}
static DPX_HD int dpx_addmax_relu(int a, int b, int c) {
  return __viaddmax_s32_relu(a, b, c);
}
static DPX_HD unsigned dpx_addmax16x2(unsigned a, unsigned b, unsigned c) {
  return __viaddmax_s16x2(a, b, c);
}
static DPX_HD unsigned dpx_addmax16x2_relu(unsigned a, unsigned b,
                                           unsigned c) {
  return __viaddmax_s16x2_relu(a, b, c);
}

#else
#define DPX_HD inline

static DPX_HD int dpx_add32(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
static DPX_HD int dpx_addmax(int a, int b, int c) {
  const int s = dpx_add32(a, b);
  return s > c ? s : c;
}
static DPX_HD int dpx_addmax_relu(int a, int b, int c) {
  const int m = dpx_addmax(a, b, c);
  return m > 0 ? m : 0;
}
// one 16-bit half (bits `sh`..`sh`+15) of the 16x2 forms, as int16
static DPX_HD int dpx_half(unsigned x, int sh) {
  return (int16_t)(uint16_t)(x >> sh);
}
static DPX_HD unsigned dpx_half_addmax(unsigned a, unsigned b, unsigned c,
                                       int sh, int relu) {
  int s = (int16_t)(uint16_t)(dpx_half(a, sh) + dpx_half(b, sh));
  const int hc = dpx_half(c, sh);
  s = s > hc ? s : hc;
  if (relu && s < 0) s = 0;
  return (unsigned)(uint16_t)s << sh;
}
static DPX_HD unsigned dpx_addmax16x2(unsigned a, unsigned b, unsigned c) {
  return dpx_half_addmax(a, b, c, 0, 0) | dpx_half_addmax(a, b, c, 16, 0);
}
static DPX_HD unsigned dpx_addmax16x2_relu(unsigned a, unsigned b,
                                           unsigned c) {
  return dpx_half_addmax(a, b, c, 0, 1) | dpx_half_addmax(a, b, c, 16, 1);
}

#endif
