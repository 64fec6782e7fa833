// Banded affine-gap extension (ksw_extend2, ksw.c:380-479) on Hopper: a
// group of G threads computes one lane, a row's cells in parallel.  Two
// kernels over one group step (group_pass):
//   ext_pl2_kernel  both passes of mem_chain2aln's band-doubling retry
//                   (bwamem.c:732-741) in the lane;
//   ext_pl_kernel   one pass at a per-lane band, no retry (the caller
//                   drives the retry over the lanes that need it).
//
// They replace the TPU kernels of bwamem_tpu/ops/pallas_ext.py:
// _kernel_retry via extend_batch_pl2 (pallas_ext.py:229, pallas_call :353)
// and _kernel via extend_batch_pl (:213, :292).  Like them (a whole row at
// once, F by a log-shift prefix max), the row runs in parallel:
//   * the window [beg, end) of row i goes in chunks of G consecutive
//     columns, thread t of the group taking column beg + G*k + t.  G is a
//     template parameter, 8, 16 or 32 (ops/ext_kernel.GROUP is 32:
//     it measured fastest on every main-path call); a sub-warp group
//     shuffles with width G and its own mask;
//   * a cell's M is the stored H(i-1, j-1) plus the score, its E the
//     stored E(i, j): no neighbour.  The score is one byte of the target
//     row's five matrix entries packed in 64 bits (no second dependent
//     load).  F is a max-plus scan: the f entering column t of a chunk is
//     max(Fc - t*e_ins, max_{k<t}(c_k + k*e_ins) - (t-1)*e_ins), c_k =
//     max(M_k - oe_ins, 0), Fc the carry of the chunk before; the max is
//     an inclusive __shfl_up_sync scan in log2 G steps.  The store
//     H(i, j-1) takes the left neighbour's h by one rotation, the chunk's
//     first column the carry (the row's h1 at beg);
//   * per row, group-uniform: the row max and its LAST column, and the
//     first and last nonzero column of the new eh row (the window shrink,
//     ksw.c:466-469), by __reduce_max_sync / __reduce_min_sync of each
//     thread's running values; the gscore update and the m == 0 and z-drop
//     breaks on those reduced values, so the group leaves together;
//   * a lane's H and E (one 8-byte word a column) live in a ring of R
//     columns, R a power of two of at least 2 w + 8, column j in slot
//     j & (R - 1): the columns read again, [beg, highest stored], span at
//     most 2 w + 2 (beg >= i - w, end <= i + w + 1), and a column above
//     the highest stored still holds its first-row value (ksw.c:395-397),
//     computed when it is read.  When R reaches lq_max + 1 nothing wraps
//     and the lane keeps lq_max + 1 slots.  The lane's query follows as
//     bytes, staged once, so a chunk reads G consecutive words and bytes;
//   * the lane area (8 x min(R, lq_max + 1) + lq_max bytes, rounded to 16)
//     lies in shared memory, 128 / G lanes a block; when a block's lanes
//     do not fit (lq_max and w past about 16 000 and 4 000) it lies
//     lane-major in a global scratch from the wrapper: the same code over
//     another base (template parameter SMEM), G consecutive 8-byte words a
//     chunk either way;
//   * the target code of row i: G rows at a time, loaded one block of
//     rows ahead, one per thread, handed out by a shuffle;
//   * the band clamp (ksw.c:399-407) runs in the lane: w1 and w2 from
//     w_opt for ext_pl2, w[b] for ext_pl;
//   * offsets into the [rows, B] planes are 64-bit: rows x B passes 2^31
//     for long reads.
// What bounds it: the DP cells of the band (about 16 int32 operations
// each, at the card's int32 rate), not bytes (the query and target rows of
// nonempty lanes are read once).  What holds it on an H100: each row is a
// dependent chain (load, scan, rotation, the row's reductions, the window
// for the next row), and a call of 1024-2048 long lanes keeps 2-4 warps
// on each scheduler, too few to hide it: about 630 cycles a chunk on the
// widest 5000 bp call (PERF.md section 6).  Measured on the card and not
// kept: two or four chunks' scans interleaved, a contiguous segment of
// columns a thread with one scan a row (tools/pl_probe.py's roll),
// loading the next chunk's cells before a chunk's scan, and the row's four
// reductions ahead of its breaks (tools/torch_ext_variants.py times the
// last two); none was faster on both the short and the long lanes.
//
// The same source compiles as host C++ (no __CUDACC__): ext_pl2_host and
// ext_pl_host run the group step with its G virtual threads one after the
// other, the shuffles, the scan and the reductions spelled out, at any G
// and in either storage mode, so the CPU tests check the kernels' own row
// logic.
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define EXT_HD __host__ __device__ __forceinline__
#define EXT_LDG(p) __ldg(p)
#else
#include <stdlib.h>
#define EXT_HD inline
#define EXT_LDG(p) (*(p))
#endif

#define EXT_THREADS 128  // threads a block: EXT_THREADS / G lanes

struct ExtParams {
  int mat[25];
  int o_del, e_del, o_ins, e_ins, zdrop;
  int B, LQ, t_max;
  int max_mat;      // the matrix's largest entry (the band clamp)
  int w_opt, thr;   // ext_pl2: pass-1 band and the retry threshold
  int R, area;      // ring columns (a power of two), a lane's bytes
};

struct PassOut {
  int mx, max_j, max_i, max_ie, gscore, max_off;
};

// H(i, j-1) and E(i+1, j) of column j: one 8-byte word
struct alignas(8) EH {
  int h, e;
};

// one thread's running values over a row's chunks: its best h and the
// last of its columns reaching it, its first and last column whose stored
// pair is nonzero
struct Keep {
  int m, mj, fnz, lnz;
};

static EXT_HD int imax(int a, int b) { return a > b ? a : b; }
static EXT_HD int imin(int a, int b) { return a < b ? a : b; }
static EXT_HD int code5(int x) { return (x >= 0 && x < 4) ? x : 4; }

// ksw.c:399-407: w = min(w, max_ins, max_del), in C double arithmetic with
// int truncation (ops/extend._adjust_w)
static EXT_HD int clamp_w(int w, int qlen, int eb, const ExtParams& P) {
  int max_ins =
      (int)(((double)qlen * P.max_mat + eb - P.o_ins) / P.e_ins + 1.0);
  int max_del =
      (int)(((double)qlen * P.max_mat + eb - P.o_del) / P.e_del + 1.0);
  max_ins = imax(max_ins, 1);
  max_del = imax(max_del, 1);
  return imin(w, imin(max_ins, max_del));
}

static EXT_HD PassOut pass_start(int h0) {
  PassOut r;
  r.mx = h0;
  r.max_i = r.max_j = r.max_ie = r.gscore = -1;
  r.max_off = 0;
  return r;
}

static EXT_HD Keep keep_start() {
  Keep k;
  k.m = 0;
  k.mj = -1;
  k.fnz = INT_MAX;
  k.lnz = -1;
  return k;
}

// The window of row i (ksw.c:409-413); returns H(i, beg-1), the h1 that
// enters column beg.
static EXT_HD int row_open(int i, int w, int qlen, int h0,
                           const ExtParams& P, int& beg, int& end) {
  if (beg < i - w) beg = i - w;
  if (end > i + w + 1) end = i + w + 1;
  if (end > qlen) end = qlen;
  return beg == 0 ? imax(h0 - (P.o_del + P.e_del * (i + 1)), 0) : 0;
}

// Row c of the matrix (target code c), its five int8 entries packed in
// the low 40 bits, and the entry for query code q of a packed row.
static EXT_HD uint64_t pack_row(const int* mat, int c) {
  uint64_t r = 0;
  for (int k = 0; k < 5; ++k)
    r |= (uint64_t)(uint8_t)(int8_t)mat[5 * c + k] << (8 * k);
  return r;
}

static EXT_HD int score(uint64_t row, int q) {
  return (int)(int8_t)(uint8_t)(row >> (8 * q));
}

// Column j's M (the stored H(i-1, j-1) plus the score, 0 where H is 0:
// ksw.c:433) and E.  Above `hi`, the highest column stored so far, a
// column still holds its first-row value.
static EXT_HD void cell_in(const EH* eh, const uint8_t* Q, int j, int hi,
                           int R, int h0, uint64_t srow,
                           const ExtParams& P, int& M, int& e) {
  int H;
  if (j <= hi) {
    const EH v = eh[j & (R - 1)];
    H = v.h;
    e = v.e;
  } else {
    H = imax(h0 - (P.o_ins + P.e_ins) - (j - 1) * P.e_ins, 0);
    e = 0;
  }
  M = H ? H + score(srow, Q[j]) : 0;
}

// F entering column t of a chunk, from the carry Fc entering the chunk and
// excl = max_{k<t} (c_k + k*e_ins), c_k = max(M_k - oe_ins, 0) (ksw.c:441)
static EXT_HD int cell_f(int t, int Fc, int excl, int e_ins) {
  return t == 0 ? Fc : imax(Fc - t * e_ins, excl - (t - 1) * e_ins);
}

// h = max(M, E, F) and E(i+1, j) (ksw.c:434-439)
static EXT_HD void cell_out(int M, int e, int f, const ExtParams& P, int& h,
                            int& en) {
  h = imax(imax(M, e), f);
  en = imax(e - P.e_del, imax(M - (P.o_del + P.e_del), 0));
}

// A column's share of the row's reductions, in column order within a
// thread: mj = m > h ? mj : j (the LAST column reaching the max).
static EXT_HD void keep_max(int j, int h, Keep& k) {
  if (h >= k.m) {
    k.m = h;
    k.mj = j;
  }
}

// A stored pair's share of the nonzero span, in any order.
static EXT_HD void keep_nz(int j, int hs, int en, Keep& k) {
  if (hs != 0 || en != 0) {
    k.fnz = imin(k.fnz, j);
    k.lnz = imax(k.lnz, j);
  }
}

// After row i: the gscore update when the row reached the last query
// column (jx is the column loop's exit value, ksw.c:445-448), the break on
// m == 0, the new max (:449-452) or the z-drop (:453-458).  Returns 1 when
// the pass stops.
static EXT_HD int row_close(int i, int jx, int h1, int m, int mj, int qlen,
                            const ExtParams& P, PassOut& r) {
  if (jx == qlen) {
    r.max_ie = r.gscore > h1 ? r.max_ie : i;
    r.gscore = imax(r.gscore, h1);
  }
  if (m == 0) return 1;
  if (m > r.mx) {
    r.mx = m;
    r.max_i = i;
    r.max_j = mj;
    const int off = mj > i ? mj - i : i - mj;
    r.max_off = imax(r.max_off, off);
  } else if (P.zdrop > 0) {
    const int di = i - r.max_i, dj = mj - r.max_j;
    if (di > dj) {
      if (r.mx - m - (di - dj) * P.e_del > P.zdrop) return 1;
    } else {
      if (r.mx - m - (dj - di) * P.e_ins > P.zdrop) return 1;
    }
  }
  return 0;
}

// The next window (ksw.c:466-469) from fnz, the first column of [beg, end)
// whose stored pair is nonzero (INT_MAX: none), and lnz, the last of
// [beg, end] (-1: none).
static EXT_HD void row_shrink(int fnz, int lnz, int qlen, int& beg,
                              int& end) {
  beg = fnz < end ? fnz : end;
  const int j = lnz >= beg ? lnz : beg - 1;
  end = imin(j + 2, qlen);
}

static EXT_HD void lane_out(int* out, long long B, int b, const PassOut& r,
                            bool retry, int retried) {
  out[0 * B + b] = r.mx;
  out[1 * B + b] = r.max_j + 1;
  out[2 * B + b] = r.max_i + 1;
  out[3 * B + b] = r.max_ie + 1;
  out[4 * B + b] = r.gscore;
  out[5 * B + b] = r.max_off;
  if (retry) out[6 * B + b] = retried;
}

static void fill_params(ExtParams& P, const int* mat25, int o_del, int e_del,
                        int o_ins, int e_ins, int zdrop, int B, int LQ,
                        int t_max, int w_opt, int thr, int R, int area) {
  P.max_mat = mat25[0];
  for (int k = 0; k < 25; ++k) {
    P.mat[k] = mat25[k];
    P.max_mat = imax(P.max_mat, mat25[k]);
  }
  P.o_del = o_del; P.e_del = e_del; P.o_ins = o_ins; P.e_ins = e_ins;
  P.zdrop = zdrop; P.B = B; P.LQ = LQ; P.t_max = t_max;
  P.w_opt = w_opt; P.thr = thr; P.R = R; P.area = area;
}

// The group and the ring the caller planned: G threads a lane (8, 16 or
// 32), R a power of two, the area a multiple of 16 holding min(R, LQ + 1)
// words and LQ query bytes.
static int plan_ok(int G, int R, int area, int LQ) {
  if (G != 8 && G != 16 && G != 32) return 0;
  if (R < 1 || (R & (R - 1)) != 0 || area % 16 != 0) return 0;
  const long long slots = R < LQ + 1 ? R : (long long)LQ + 1;
  return (long long)area >= 8 * slots + LQ;
}

#ifdef __CUDACC__

template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if (G == 32) return 0xffffffffu;
  return ((1u << G) - 1u) << (threadIdx.x & 31 & ~(G - 1));
}

// One ksw_extend2 pass of lane b at (clamped) band w, thread t of the
// group.  eh is the lane's ring, Q its staged query.
template <int G>
__device__ PassOut group_pass(EH* eh, const uint8_t* Q,
                              const int* __restrict__ tT, int b, int qlen,
                              int tlen, int h0, int w, const uint64_t* spk,
                              const ExtParams& P, unsigned mask, int t) {
  const long long B = P.B;
  const int R = P.R, e_ins = P.e_ins, oe_ins = P.o_ins + P.e_ins;
  PassOut r = pass_start(h0);
  __syncwarp(mask);                    // the staged query; a pass before
  if (t == 0) eh[0] = EH{h0, 0};       // first row: column 0 stored,
  __syncwarp(mask);                    // the others computed when read
  int hi = 0, beg = 0, end = qlen;
  const int rows = imin(tlen, P.t_max);
  int tcur = 4;
  int tnext = t < rows ? EXT_LDG(tT + (long long)t * B + b) : 4;
  for (int i = 0; i < rows; ++i) {
    if ((i & (G - 1)) == 0) {          // the next block of target rows
      tcur = tnext;
      const int k = i + G + t;
      tnext = k < rows ? EXT_LDG(tT + (long long)k * B + b) : 4;
    }
    const uint64_t srow =
        spk[code5(__shfl_sync(mask, tcur, i & (G - 1), G))];
    int h1 = row_open(i, w, qlen, h0, P, beg, end);
    int Fc = 0, hc = h1, hl = 0;
    Keep k = keep_start();
    for (int c0 = beg; c0 < end; c0 += G) {
      const int j = c0 + t;
      int M = 0, e = 0;
      if (j < end) cell_in(eh, Q, j, hi, R, h0, srow, P, M, e);
      int incl = imax(M - oe_ins, 0) + t * e_ins;
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const int u = __shfl_up_sync(mask, incl, d, G);
        if (t >= d) incl = imax(incl, u);
      }
      const int excl = __shfl_up_sync(mask, incl, 1, G);
      const int tot = __shfl_sync(mask, incl, G - 1, G);
      int h, en;
      cell_out(M, e, cell_f(t, Fc, excl, e_ins), P, h, en);
      const int rot = __shfl_sync(mask, h, (t + G - 1) & (G - 1), G);
      if (j < end) {
        const int hs = t == 0 ? hc : rot;   // H(i, j-1)
        eh[j & (R - 1)] = EH{hs, en};
        keep_max(j, h, k);
        keep_nz(j, hs, en, k);
      }
      hc = rot;                        // thread 0: h of the chunk's last
      Fc = imax(Fc - G * e_ins, tot - (G - 1) * e_ins);
      hl = h;
    }
    if (beg < end)                     // h of column end - 1
      h1 = __shfl_sync(mask, hl, (end - 1 - beg) & (G - 1), G);
    if (t == 0) eh[end & (R - 1)] = EH{h1, 0};
    hi = imax(hi, end);
    const int m = __reduce_max_sync(mask, k.m);
    const int mj = __reduce_max_sync(mask, k.m == m ? k.mj : -1);
    if (row_close(i, imax(beg, end), h1, m, mj, qlen, P, r)) break;
    const int fnz = __reduce_min_sync(mask, k.fnz);
    const int lnz = h1 != 0 ? end : __reduce_max_sync(mask, k.lnz);
    row_shrink(fnz, lnz, qlen, beg, end);
    __syncwarp(mask);                  // this row's stores, read next row
  }
  return r;
}

// Lane b on its group: stage the query, run the pass (and the retry),
// write the outputs.  spk: the matrix's rows packed (pack_row).
template <int G, bool SMEM, bool RETRY>
__device__ __forceinline__ void group_lane(
    unsigned char* sm, const uint64_t* spk, const int* __restrict__ qT,
    const int* __restrict__ tT, const int* __restrict__ qlen,
    const int* __restrict__ tlen, const int* __restrict__ h0,
    const int* __restrict__ w, const int* __restrict__ eb,
    unsigned char* __restrict__ scratch, int* __restrict__ out,
    const ExtParams& P) {
  const int g = threadIdx.x / G, t = threadIdx.x % G;
  const int b = blockIdx.x * (EXT_THREADS / G) + g;
  if (b >= P.B) return;                // the ragged edge: whole groups
  const unsigned mask = group_mask<G>();
  const long long B = P.B;
  unsigned char* area = SMEM ? sm + (size_t)g * P.area
                             : scratch + (size_t)b * P.area;
  EH* eh = (EH*)area;
  uint8_t* Q = area + 8 * (size_t)imin(P.R, P.LQ + 1);
  const int ql = qlen[b], tl = tlen[b], hh = h0[b], ebv = eb[b];
  for (int j = t; j < ql; j += G)
    Q[j] = (uint8_t)code5(EXT_LDG(qT + (long long)j * B + b));
  PassOut r = group_pass<G>(eh, Q, tT, b, ql, tl, hh,
                            clamp_w(RETRY ? P.w_opt : w[b], ql, ebv, P),
                            spk, P, mask, t);
  int retried = 0;
  if (RETRY) {
    retried = (r.max_off >= P.thr) && (r.mx != hh) && (ql > 0);
    if (retried)
      r = group_pass<G>(eh, Q, tT, b, ql, tl, hh,
                        clamp_w(2 * P.w_opt, ql, ebv, P), spk, P, mask, t);
  }
  if (t == 0) lane_out(out, B, b, r, RETRY, retried);
}

#define EXT_KERNEL_ARGS                                                   \
  const int *__restrict__ qT, const int *__restrict__ tT,                 \
      const int *__restrict__ qlen, const int *__restrict__ tlen,         \
      const int *__restrict__ h0, const int *__restrict__ w,              \
      const int *__restrict__ eb, unsigned char *__restrict__ scratch,    \
      int *__restrict__ out, ExtParams P

template <int G, bool SMEM>
__global__ void __launch_bounds__(EXT_THREADS)
ext_pl2_kernel(EXT_KERNEL_ARGS) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ uint64_t spk[5];
  if (threadIdx.x < 5) spk[threadIdx.x] = pack_row(P.mat, threadIdx.x);
  __syncthreads();
  group_lane<G, SMEM, true>(sm, spk, qT, tT, qlen, tlen, h0, w, eb,
                            scratch, out, P);
}

template <int G, bool SMEM>
__global__ void __launch_bounds__(EXT_THREADS)
ext_pl_kernel(EXT_KERNEL_ARGS) {
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ uint64_t spk[5];
  if (threadIdx.x < 5) spk[threadIdx.x] = pack_row(P.mat, threadIdx.x);
  __syncthreads();
  group_lane<G, SMEM, false>(sm, spk, qT, tT, qlen, tlen, h0, w, eb,
                             scratch, out, P);
}

typedef void (*ExtKernel)(EXT_KERNEL_ARGS);

template <int G>
static ExtKernel pick(bool retry, bool smem) {
  if (retry) return smem ? ext_pl2_kernel<G, true> : ext_pl2_kernel<G, false>;
  return smem ? ext_pl_kernel<G, true> : ext_pl_kernel<G, false>;
}

// Launches kernel (retry: ext_pl2, else ext_pl) at group G, storage 0
// (shared memory) or 1 (global scratch); returns a CUDA error code.
static int ext_launch(bool retry, const int* qT, const int* tT,
                      const int* qlen, const int* tlen, const int* h0,
                      const int* w, const int* eb, unsigned char* scratch,
                      int* out, const ExtParams& P, int G, int storage,
                      cudaStream_t st) {
  if (!plan_ok(G, P.R, P.area, P.LQ) || (storage != 0 && storage != 1) ||
      (storage == 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  if (P.B <= 0) return (int)cudaGetLastError();
  const bool smem_mode = storage == 0;
  const ExtKernel k = G == 8    ? pick<8>(retry, smem_mode)
                      : G == 16 ? pick<16>(retry, smem_mode)
                                : pick<32>(retry, smem_mode);
  const int lanes = EXT_THREADS / G;
  const long long smem = smem_mode ? (long long)lanes * P.area : 0;
  if (smem > INT_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const int blocks = (P.B + lanes - 1) / lanes;
  k<<<blocks, EXT_THREADS, (size_t)smem, st>>>(qT, tT, qlen, tlen, h0, w, eb,
                                               scratch, out, P);
  return (int)cudaGetLastError();
}

// C entries for ctypes: device pointers, a host int32[25] matrix; G, the
// ring R, the lane area in bytes and the storage (0 shared, 1 global:
// `scratch` then holds B areas) from ops/ext_kernel.plan.  Return cudaGetLastError() after the launch on the
// caller's stream.
extern "C" int ext_pl2_launch(const int* qT, const int* tT, const int* qlen,
                              const int* tlen, const int* h0, const int* eb,
                              int w_opt, int thr, unsigned char* scratch,
                              int* out, int B, int LQ, int t_max,
                              const int* mat25, int o_del, int e_del,
                              int o_ins, int e_ins, int zdrop, int G, int R,
                              int area, int storage, void* stream) {
  ExtParams P;
  fill_params(P, mat25, o_del, e_del, o_ins, e_ins, zdrop, B, LQ, t_max,
              w_opt, thr, R, area);
  return ext_launch(true, qT, tT, qlen, tlen, h0, nullptr, eb, scratch, out,
                    P, G, storage, (cudaStream_t)stream);
}

extern "C" int ext_pl_launch(const int* qT, const int* tT, const int* qlen,
                             const int* tlen, const int* h0, const int* w,
                             const int* eb, unsigned char* scratch, int* out,
                             int B, int LQ, int t_max, const int* mat25,
                             int o_del, int e_del, int o_ins, int e_ins,
                             int zdrop, int G, int R, int area, int storage,
                             void* stream) {
  ExtParams P;
  fill_params(P, mat25, o_del, e_del, o_ins, e_ins, zdrop, B, LQ, t_max, 0,
              0, R, area);
  return ext_launch(false, qT, tT, qlen, tlen, h0, w, eb, scratch, out, P,
                    G, storage, (cudaStream_t)stream);
}

#else

// The group step on the host: the G threads one after the other inside
// each phase, with the shuffles, the scan and the reductions written out.
template <int G>
static PassOut host_pass(EH* eh, const uint8_t* Q, const int* tT, int b,
                         int qlen, int tlen, int h0, int w,
                         const uint64_t* spk, const ExtParams& P) {
  const long long B = P.B;
  const int R = P.R, e_ins = P.e_ins, oe_ins = P.o_ins + P.e_ins;
  PassOut r = pass_start(h0);
  eh[0] = EH{h0, 0};
  int hi = 0, beg = 0, end = qlen;
  const int rows = imin(tlen, P.t_max);
  int tcur[G], tnext[G];
  for (int t = 0; t < G; ++t)
    tnext[t] = t < rows ? tT[(long long)t * B + b] : 4;
  for (int i = 0; i < rows; ++i) {
    if ((i & (G - 1)) == 0) {
      for (int t = 0; t < G; ++t) {
        tcur[t] = tnext[t];
        const int k = i + G + t;
        tnext[t] = k < rows ? tT[(long long)k * B + b] : 4;
      }
    }
    const uint64_t srow = spk[code5(tcur[i & (G - 1)])];
    int h1 = row_open(i, w, qlen, h0, P, beg, end);
    int Fc = 0, hc = h1, hl[G];
    Keep k[G];
    for (int t = 0; t < G; ++t) {
      hl[t] = 0;
      k[t] = keep_start();
    }
    for (int c0 = beg; c0 < end; c0 += G) {
      int M[G], e[G], incl[G], h[G], en[G];
      for (int t = 0; t < G; ++t) {
        M[t] = e[t] = 0;
        if (c0 + t < end) cell_in(eh, Q, c0 + t, hi, R, h0, srow, P, M[t], e[t]);
        incl[t] = imax(M[t] - oe_ins, 0) + t * e_ins;
      }
      // __shfl_up_sync steps: every thread reads the values before the step
      for (int d = 1; d < G; d <<= 1)
        for (int t = G - 1; t >= d; --t) incl[t] = imax(incl[t], incl[t - d]);
      for (int t = 0; t < G; ++t) {
        const int excl = t >= 1 ? incl[t - 1] : incl[t];
        cell_out(M[t], e[t], cell_f(t, Fc, excl, e_ins), P, h[t], en[t]);
      }
      for (int t = 0; t < G; ++t) {
        const int j = c0 + t;
        if (j < end) {
          const int hs = t == 0 ? hc : h[t - 1];
          eh[j & (R - 1)] = EH{hs, en[t]};
          keep_max(j, h[t], k[t]);
          keep_nz(j, hs, en[t], k[t]);
        }
      }
      hc = h[G - 1];
      Fc = imax(Fc - G * e_ins, incl[G - 1] - (G - 1) * e_ins);
      for (int t = 0; t < G; ++t) hl[t] = h[t];
    }
    if (beg < end) h1 = hl[(end - 1 - beg) & (G - 1)];
    eh[end & (R - 1)] = EH{h1, 0};
    hi = imax(hi, end);
    int m = INT_MIN, mj = INT_MIN, fnz = INT_MAX, lnz = INT_MIN;
    for (int t = 0; t < G; ++t) m = imax(m, k[t].m);
    for (int t = 0; t < G; ++t) mj = imax(mj, k[t].m == m ? k[t].mj : -1);
    if (row_close(i, imax(beg, end), h1, m, mj, qlen, P, r)) break;
    for (int t = 0; t < G; ++t) {
      fnz = imin(fnz, k[t].fnz);
      lnz = imax(lnz, k[t].lnz);
    }
    row_shrink(fnz, h1 != 0 ? end : lnz, qlen, beg, end);
  }
  return r;
}

template <int G, bool RETRY>
static void host_lane(unsigned char* area, const int* qT, const int* tT,
                      const int* qlen, const int* tlen, const int* h0,
                      const int* w, const int* eb, int* out, int b,
                      const ExtParams& P) {
  const long long B = P.B;
  EH* eh = (EH*)area;
  uint8_t* Q = area + 8 * (size_t)imin(P.R, P.LQ + 1);
  const int ql = qlen[b], tl = tlen[b], hh = h0[b], ebv = eb[b];
  for (int j = 0; j < ql; ++j) Q[j] = (uint8_t)code5(qT[(long long)j * B + b]);
  uint64_t spk[5];
  for (int c = 0; c < 5; ++c) spk[c] = pack_row(P.mat, c);
  PassOut r = host_pass<G>(eh, Q, tT, b, ql, tl, hh,
                           clamp_w(RETRY ? P.w_opt : w[b], ql, ebv, P), spk,
                           P);
  int retried = 0;
  if (RETRY) {
    retried = (r.max_off >= P.thr) && (r.mx != hh) && (ql > 0);
    if (retried)
      r = host_pass<G>(eh, Q, tT, b, ql, tl, hh,
                       clamp_w(2 * P.w_opt, ql, ebv, P), spk, P);
  }
  lane_out(out, B, b, r, RETRY, retried);
}

typedef void (*HostLane)(unsigned char*, const int*, const int*, const int*,
                         const int*, const int*, const int*, const int*,
                         int*, int, const ExtParams&);

// Every lane at group G; storage 0 runs each lane in one area reused
// lane after lane (a block's shared memory), storage 1 lane b in
// scratch + b * area (the kernel's global scratch).  Returns 1 on a bad
// plan or a failed allocation.
template <bool RETRY>
static int host_lanes(const int* qT, const int* tT, const int* qlen,
                      const int* tlen, const int* h0, const int* w,
                      const int* eb, unsigned char* scratch, int* out,
                      const ExtParams& P, int G, int storage) {
  if (!plan_ok(G, P.R, P.area, P.LQ) || (storage != 0 && storage != 1) ||
      (storage == 1 && scratch == NULL))
    return 1;
  const HostLane lane = G == 8    ? host_lane<8, RETRY>
                        : G == 16 ? host_lane<16, RETRY>
                                  : host_lane<32, RETRY>;
  unsigned char* own = NULL;
  if (storage == 0) {
    own = (unsigned char*)malloc((size_t)P.area);
    if (!own) return 1;
  }
  for (int b = 0; b < P.B; ++b)
    lane(own ? own : scratch + (size_t)b * P.area, qT, tT, qlen, tlen, h0, w,
         eb, out, b, P);
  free(own);
  return 0;
}

// Host builds of the two kernels (all pointers are host memory), with the
// C entries' arguments less the stream.
extern "C" int ext_pl2_host(const int* qT, const int* tT, const int* qlen,
                            const int* tlen, const int* h0, const int* eb,
                            int w_opt, int thr, unsigned char* scratch,
                            int* out, int B, int LQ, int t_max,
                            const int* mat25, int o_del, int e_del,
                            int o_ins, int e_ins, int zdrop, int G, int R,
                            int area, int storage) {
  ExtParams P;
  fill_params(P, mat25, o_del, e_del, o_ins, e_ins, zdrop, B, LQ, t_max,
              w_opt, thr, R, area);
  return host_lanes<true>(qT, tT, qlen, tlen, h0, NULL, eb, scratch, out, P,
                          G, storage);
}

extern "C" int ext_pl_host(const int* qT, const int* tT, const int* qlen,
                           const int* tlen, const int* h0, const int* w,
                           const int* eb, unsigned char* scratch, int* out,
                           int B, int LQ, int t_max, const int* mat25,
                           int o_del, int e_del, int o_ins, int e_ins,
                           int zdrop, int G, int R, int area, int storage) {
  ExtParams P;
  fill_params(P, mat25, o_del, e_del, o_ins, e_ins, zdrop, B, LQ, t_max, 0,
              0, R, area);
  return host_lanes<false>(qT, tT, qlen, tlen, h0, w, eb, scratch, out, P,
                           G, storage);
}

#endif
