// The chained FM-row gather probe: for each lane, `steps` times,
//     blk = k >> 7
//     acc = sum of the W 32-bit words of row cmb[blk], wrapping int32
//     k   = (k + acc) mod seq_len        (wrapping add, non-negative mod)
// i.e. the dependent chain of combined-row gathers that the seeding scans
// issue from the host one step at a time (ops/fm.occ4 reads one cmb row per
// rank), run on the card in one call.
//
// It replaces the two TPU probe kernels of tools/fm_step_probe.py: `kernel`
// (:120, a take per word column with the table pinned in VMEM) is
// fm_chain_words, `kernel_rows` (:150, a take of whole rows) is
// fm_chain_rows.  Both compute one function and share one design; they
// differ only in how the row-sum pass reads a row (word by word, or in
// 16-byte vectors).
//
// What holds it on an H100: not bytes (the 5 Mbp genome's table is
// 3.75 MB, W = 12, read once) and not operations (W adds a step), but the
// serial chain: a lane cannot finish before `steps` dependent loads have
// come back, each a scattered read from L2 (about 330 cycles on an H100
// 80GB HBM3 at 700 W by tools/torch_fm_mm_variants.py's chase).  So the
// design cuts each step to one such load and a few instructions:
//
//   * A step reads a row only through its sum, and the sum of a row is the
//     same whatever k reads it, so the sums are taken once a call: a
//     coalesced pass (fm_sums_kernel, a thread a row) writes the wrapping
//     sum of every row a lane can reach into the wrapper's scratch, 313 KB
//     in place of 3.75 MB, and the chain reads one 4-byte word a step in
//     place of three 16-byte ones (or twelve 4-byte ones).  That is the
//     same function.  A seeding step cannot take it: the FM step reads the
//     part of a row that the read's next base picks, so its cost is the
//     full-row step, which the variants tool times.
//   * The chain (fm_l2_kernel) takes a lane every FM_SPREAD threads, 8
//     lanes a warp, FM_L2_P lanes a block spread over the SMs: a warp's
//     load then asks L1 for 8 scattered sectors, not 32, which the
//     variants tool measured 4-5 % faster on that card than a lane a
//     thread.  It starts under programmatic dependent launch, so its
//     launch overlaps the pass, and reads k0 before it waits.
//   * The remainder by the run-time seq_len is an invariant divisor
//     (FmMod, computed once a call on the host): a multiply-high, a shift
//     and three unsigned minimums in place of the hardware's
//     reciprocal-and-fixup sequence.
//
// The same source compiles as host C++ (no __CUDACC__): fm_chain_words_host
// and fm_chain_rows_host run the row-sum pass and the chain with the
// invariant divisor, and fm_mod_host the divisor alone, so the CPU tests
// check the algorithm without a card.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FM_HD __device__      // the host build is a compile of its own
#define FM_LDG(p) __ldg(p)
#else
#include <stdlib.h>
#define FM_HD
#define FM_LDG(p) (*(p))
struct int4 { int x, y, z, w; };
#endif

#define FM_SUMS_P 256         // threads of a block of the row-sum pass
#define FM_L2_P 64            // lanes of a block of the chain
#define FM_SPREAD 4           // ... one every FM_SPREAD threads

// The remainder by an invariant L (0 < L < 2^31): with s = floor(log2 L),
// m = floor((2^(32+s) - 1) / L) fits 32 bits, and for u < 2^32
// umulhi(u, m) >> s is floor(u / L) or one less; c = 2^31 mod L.
struct FmMod {
  uint32_t L, m, s, c;
};

static inline FmMod fm_mod_of(int L) {
  uint32_t s = 0;
  while ((2u << s) <= (uint32_t)L && s < 30) ++s;
  FmMod f;
  f.L = (uint32_t)L;
  f.s = s;
  f.m = (uint32_t)((((uint64_t)1 << (32 + s)) - 1) / (uint32_t)L);
  f.c = (uint32_t)(((uint64_t)1 << 31) % (uint32_t)L);
  return f;
}

static FM_HD inline uint32_t fm_umin(uint32_t a, uint32_t b) {
  return a < b ? a : b;
}

static FM_HD inline uint32_t fm_umulhi(uint32_t a, uint32_t b) {
#ifdef __CUDACC__
  return __umulhi(a, b);
#else
  return (uint32_t)(((uint64_t)a * b) >> 32);
#endif
}

// v mod L in [0, L) for any int32 v: u = v + 2^31 as unsigned, u mod L by
// one multiply-high and one conditional subtract, then (u mod L - c) mod L
// (an operand below 0 wraps past every value in [0, L), so an unsigned
// minimum picks the right one each time)
static FM_HD inline int fm_mod(int v, const FmMod& f) {
  const uint32_t u = (uint32_t)v + 0x80000000u;
  const uint32_t q = fm_umulhi(u, f.m) >> f.s;
  uint32_t r = u - q * f.L;
  r = fm_umin(r, r - f.L);
  const uint32_t t = r - f.c;
  return (int)fm_umin(t, t + f.L);
}

// one step from the row's wrapping sum S: (k + S) mod L, the add wrapping
static FM_HD inline int fm_next(int k, int S, const FmMod& f) {
  return fm_mod((int)((uint32_t)k + (uint32_t)S), f);
}

// the wrapping sum of row b, word by word or in 16-byte vectors (W a
// multiple of 4 and the table 16-byte aligned, so every row is)
template <bool VEC>
static FM_HD inline uint32_t fm_row_sum(const int* __restrict__ cmb, int b,
                                        int W) {
  uint32_t acc = 0;
  if (VEC) {
    const int4* row = reinterpret_cast<const int4*>(cmb + (long long)b * W);
    for (int q = 0; q < (W >> 2); ++q) {
      const int4 v = FM_LDG(row + q);
      acc += (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z + (uint32_t)v.w;
    }
  } else {
    const int* row = cmb + (long long)b * W;
    for (int w = 0; w < W; ++w) acc += (uint32_t)FM_LDG(row + w);
  }
  return acc;
}

#ifdef __CUDACC__

// the row-sum pass: S of every row a lane can reach, a thread a row
template <bool VEC>
__global__ void __launch_bounds__(FM_SUMS_P)
fm_sums_kernel(const int* __restrict__ cmb, int* __restrict__ S, int nb,
               int W) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int b = blockIdx.x * FM_SUMS_P + threadIdx.x;
  if (b < nb) S[b] = (int)fm_row_sum<VEC>(cmb, b, W);
}

// the chain, a lane every FM_SPREAD threads, S from L2
__global__ void __launch_bounds__(FM_L2_P * FM_SPREAD)
fm_l2_kernel(const int* __restrict__ S, const int* __restrict__ k0,
             int* __restrict__ out, int N, int steps, FmMod f) {
  const int b = blockIdx.x * FM_L2_P + threadIdx.x / FM_SPREAD;
  const bool on = threadIdx.x % FM_SPREAD == 0 && b < N;
  int k = on ? k0[b] : 0;        // k0 is no output of the sums pass
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (!on) return;
  for (int s = 0; s < steps; ++s) k = fm_next(k, __ldg(S + (k >> 7)), f);
  out[b] = k;
}

// the row-sum pass, then the chain with programmatic dependent launch
template <bool VEC>
static int fm_chain_launch(const int* cmb, const int* k0, int* out, int* S,
                           int N, int W, int steps, int seq_len,
                           cudaStream_t st) {
  if (N <= 0) return (int)cudaGetLastError();
  const int nb = (seq_len + 127) / 128;   // the rows a lane can reach
  fm_sums_kernel<VEC><<<(nb + FM_SUMS_P - 1) / FM_SUMS_P, FM_SUMS_P, 0,
                        st>>>(cmb, S, nb, W);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + FM_L2_P - 1) / FM_L2_P);
  cfg.blockDim = dim3(FM_L2_P * FM_SPREAD);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fm_l2_kernel, (const int*)S, k0, out, N,
                         steps, fm_mod_of(seq_len));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// C entries for ctypes: device pointers, `sums` the wrapper's scratch of
// (seq_len + 127) / 128 int32 words; each returns the launches' error, or
// cudaGetLastError() after them, on the caller's stream.
extern "C" int fm_chain_words(const int* cmb, const int* k0, int* out,
                              int* sums, int N, int W, int steps,
                              int seq_len, void* stream) {
  return fm_chain_launch<false>(cmb, k0, out, sums, N, W, steps, seq_len,
                                (cudaStream_t)stream);
}

extern "C" int fm_chain_rows(const int* cmb, const int* k0, int* out,
                             int* sums, int N, int W, int steps, int seq_len,
                             void* stream) {
  return fm_chain_launch<true>(cmb, k0, out, sums, N, W, steps, seq_len,
                               (cudaStream_t)stream);
}

#else

// Host builds (all pointers host memory): the row-sum pass into a table
// of its own, then each lane's chain through it, as the card runs them.
template <bool VEC>
static int fm_chain_host(const int* cmb, const int* k0, int* out, int N,
                         int W, int steps, int seq_len) {
  const int nb = (seq_len + 127) / 128;
  const FmMod f = fm_mod_of(seq_len);
  int* S = (int*)malloc((size_t)nb * sizeof(int));
  if (!S) return 2;
  for (int b = 0; b < nb; ++b) S[b] = (int)fm_row_sum<VEC>(cmb, b, W);
  for (int b = 0; b < N; ++b) {
    int k = k0[b];
    for (int s = 0; s < steps; ++s) k = fm_next(k, S[k >> 7], f);
    out[b] = k;
  }
  free(S);
  return 0;
}

extern "C" int fm_chain_words_host(const int* cmb, const int* k0, int* out,
                                   int N, int W, int steps, int seq_len) {
  return fm_chain_host<false>(cmb, k0, out, N, W, steps, seq_len);
}

extern "C" int fm_chain_rows_host(const int* cmb, const int* k0, int* out,
                                  int N, int W, int steps, int seq_len) {
  return fm_chain_host<true>(cmb, k0, out, N, W, steps, seq_len);
}

// the invariant divisor alone: out[i] = v[i] mod L in [0, L)
extern "C" int fm_mod_host(const int* v, int* out, int n, int L) {
  const FmMod f = fm_mod_of(L);
  for (int i = 0; i < n; ++i) out[i] = fm_mod(v[i], f);
  return 0;
}

#endif
