// The chained FM-row gather probe: for each lane, `steps` times,
//     blk = k >> 7
//     acc = sum of the W 32-bit words of row cmb[blk], wrapping int32
//     k   = (k + acc) mod seq_len        (wrapping add, non-negative mod)
// i.e. the dependent chain of combined-row gathers that the seeding scans
// issue from the host one step at a time (ops/fm.occ4 reads one cmb row per
// rank), run inside ONE kernel, one CUDA thread per lane.
//
// It replaces the two TPU probe kernels of tools/fm_step_probe.py: `kernel`
// (:120, a take per word column with the table pinned in VMEM) is
// fm_chain_words (one 4-byte load a word), `kernel_rows` (:150, a take of
// whole rows) is fm_chain_rows (16-byte vector loads, 3 or 4 a row).  There
// is no VMEM to pin the table in on Hopper: the table (3.75 MB for a 5 Mbp
// genome, W = 12) stays in the 50 MB L2 by itself once touched, and each
// lane's chain is a serial walk of L2 hits.
//
// What holds it: not bytes and not operations — the table comes from memory
// once and from L2 after that, and W adds a step are nothing; the chain
// is serial, so a lane cannot go faster than `steps` L2 round trips, and
// the card hides that latency only across lanes (8192 lanes are 2 warps an
// SM).  fm_chain_rows cuts the loads in flight per step from W to W/4.
//
// The same source compiles as host C++ (no __CUDACC__), exposing the lane
// loops as fm_chain_words_host and fm_chain_rows_host so the arithmetic
// (the wrapping sum, the sign of the modulus) can be checked without a
// card.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FM_HD __device__      // the host build is a compile of its own
#define FM_LDG(p) __ldg(p)
#else
#define FM_HD
#define FM_LDG(p) (*(p))
struct int4 { int x, y, z, w; };
#endif

// (k + acc) mod seq_len with the add wrapping in 32 bits and the result in
// [0, seq_len): C's % keeps the sign of a negative left side.
static FM_HD inline int next_k(int k, uint32_t acc, int seq_len) {
  const int v = (int)((uint32_t)k + acc);
  const int r = v % seq_len;
  return r < 0 ? r + seq_len : r;
}

static FM_HD inline int chain_words(const int* __restrict__ cmb, int k, int W,
                                    int steps, int seq_len) {
  for (int s = 0; s < steps; ++s) {
    const int* row = cmb + (long long)(k >> 7) * W;
    uint32_t acc = 0;
    for (int w = 0; w < W; ++w) acc += (uint32_t)FM_LDG(row + w);
    k = next_k(k, acc, seq_len);
  }
  return k;
}

// W is a multiple of 4 and the table 16-byte aligned, so is every row.
static FM_HD inline int chain_rows(const int* __restrict__ cmb, int k, int W,
                                   int steps, int seq_len) {
  const int W4 = W >> 2;
  for (int s = 0; s < steps; ++s) {
    const int4* row =
        reinterpret_cast<const int4*>(cmb + (long long)(k >> 7) * W);
    uint32_t acc = 0;
    for (int q = 0; q < W4; ++q) {
      const int4 v = FM_LDG(row + q);
      acc += (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z + (uint32_t)v.w;
    }
    k = next_k(k, acc, seq_len);
  }
  return k;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(128)
fm_chain_words_kernel(const int* __restrict__ cmb, const int* __restrict__ k0,
                      int* __restrict__ out, int N, int W, int steps,
                      int seq_len) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= N) return;
  out[b] = chain_words(cmb, k0[b], W, steps, seq_len);
}

__global__ void __launch_bounds__(128)
fm_chain_rows_kernel(const int* __restrict__ cmb, const int* __restrict__ k0,
                     int* __restrict__ out, int N, int W, int steps,
                     int seq_len) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= N) return;
  out[b] = chain_rows(cmb, k0[b], W, steps, seq_len);
}

// C entries for ctypes: device pointers; each returns cudaGetLastError()
// after the launch on the caller's stream.
extern "C" int fm_chain_words(const int* cmb, const int* k0, int* out, int N,
                              int W, int steps, int seq_len, void* stream) {
  if (N > 0)
    fm_chain_words_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        cmb, k0, out, N, W, steps, seq_len);
  return (int)cudaGetLastError();
}

extern "C" int fm_chain_rows(const int* cmb, const int* k0, int* out, int N,
                             int W, int steps, int seq_len, void* stream) {
  if (N > 0)
    fm_chain_rows_kernel<<<(N + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        cmb, k0, out, N, W, steps, seq_len);
  return (int)cudaGetLastError();
}

#else

// Host builds of the same lane loops (all pointers are host memory).
extern "C" int fm_chain_words_host(const int* cmb, const int* k0, int* out,
                                   int N, int W, int steps, int seq_len) {
  for (int b = 0; b < N; ++b)
    out[b] = chain_words(cmb, k0[b], W, steps, seq_len);
  return 0;
}

extern "C" int fm_chain_rows_host(const int* cmb, const int* k0, int* out,
                                  int N, int W, int steps, int seq_len) {
  for (int b = 0; b < N; ++b)
    out[b] = chain_rows(cmb, k0[b], W, steps, seq_len);
  return 0;
}

#endif
