// Banded affine-gap extension (ksw_extend2, ksw.c:380-479), one CUDA thread
// per lane, in two kernels over one lane loop (dp_pass):
//   ext_pl2_kernel  both passes of mem_chain2aln's band-doubling retry
//                   (bwamem.c:732-741) in the lane;
//   ext_pl_kernel   one pass at a per-lane band, no retry (the caller
//                   drives the retry over the lanes that need it).
//
// They replace the TPU kernels of bwamem_tpu/ops/pallas_ext.py:
// _kernel_retry via extend_batch_pl2 (pallas_ext.py:229, 316) and _kernel
// via extend_batch_pl (pallas_ext.py:213, 262).  The Pallas kernels solve
// the F recurrence of a whole row with a log-shift prefix max down the
// sublanes because the TPU has no fast scalar loop; on Hopper each thread
// runs the scalar row loop of ksw.c over its own lane instead:
//   * ext_pl2: pass 1 at band w1; lanes whose max_off reached thr with a
//     changed score (and qlen > 0) rerun from scratch at band w2;
//   * a lane with qlen == 0 and tlen == 0 (padding) writes one scratch
//     cell and returns score = h0;
//   * every offset into the [L, B] planes is 64-bit: rows * B passes 2^31
//     for long reads;
//   * the [L, B] layouts of the query, target and eh scratch are kept, so
//     at a given row/column thread b reads column b and a warp's loads
//     are coalesced when its lanes sit at the same column;
//   * the 5x5 matrix and gap penalties arrive as kernel arguments; the
//     kernel allocates nothing and launches on the caller's stream.
// What bounds it: the DP cells of the band (about 16 int32 operations
// each, at the card's int32 rate), not bytes — only the rows and columns
// of nonempty lanes are read, once.  In practice the thread-serial band
// and the load imbalance between lanes of a warp set the time.
//
// The same source compiles as host C++ (no __CUDACC__), exposing the lane
// loops as ext_pl2_host and ext_pl_host so the DP can be checked on a
// machine without a card.
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define EXT_HD __host__ __device__
#else
#define EXT_HD
#endif

struct ExtParams {
  int mat[25];
  int o_del, e_del, o_ins, e_ins, zdrop;
  int B, LQ, t_max;
};

struct PassOut {
  int mx, max_j, max_i, max_ie, gscore, max_off;
};

static EXT_HD inline int imax(int a, int b) { return a > b ? a : b; }
static EXT_HD inline int imin(int a, int b) { return a < b ? a : b; }
static EXT_HD inline int code5(int x) { return (x >= 0 && x < 4) ? x : 4; }

// One ksw_extend2 pass for lane b at (already clamped) band w.  eh_h/eh_e
// are this call's [L1, B] scratch planes; only columns [0, qlen] are used.
static EXT_HD PassOut dp_pass(const int* __restrict__ qT,
                              const int* __restrict__ tT,
                              int* __restrict__ eh_h, int* __restrict__ eh_e,
                              const int* __restrict__ mat, int b, int qlen,
                              int tlen, int h0, int w, const ExtParams& P) {
  const long long B = P.B;
  const int oe_del = P.o_del + P.e_del, oe_ins = P.o_ins + P.e_ins;
  PassOut r;
  r.mx = h0; r.max_i = -1; r.max_j = -1; r.max_ie = -1; r.gscore = -1;
  r.max_off = 0;
  // first row (ksw.c:395-397)
  eh_h[b] = h0; eh_e[b] = 0;
  for (int j = 1; j <= qlen; ++j) {
    eh_h[j * B + b] = imax(h0 - oe_ins - (j - 1) * P.e_ins, 0);
    eh_e[j * B + b] = 0;
  }
  int beg = 0, end = qlen;
  const int rows = imin(tlen, P.t_max);
  for (int i = 0; i < rows; ++i) {
    const int* srow = mat + 5 * code5(tT[i * B + b]);
    int f = 0, h1, m = 0, mj = -1;
    if (beg < i - w) beg = i - w;
    if (end > i + w + 1) end = i + w + 1;
    if (end > qlen) end = qlen;
    h1 = beg == 0 ? imax(h0 - (P.o_del + P.e_del * (i + 1)), 0) : 0;
    int j;
    for (j = beg; j < end; ++j) {
      const long long o = j * B + b;
      int M = eh_h[o], e = eh_e[o];
      eh_h[o] = h1;                       // H(i, j-1) for the next row
      M = M ? M + srow[code5(qT[o])] : 0;  // no "100M3I3D20M"
      int h = imax(imax(M, e), f);
      h1 = h;
      mj = m > h ? mj : j;                // LAST column reaching the max
      m = m > h ? m : h;
      int t = imax(M - oe_del, 0);
      e = imax(e - P.e_del, t);
      eh_e[o] = e;                        // E(i+1, j)
      t = imax(M - oe_ins, 0);
      f = imax(f - P.e_ins, t);           // F(i, j+1)
    }
    eh_h[end * B + b] = h1;
    eh_e[end * B + b] = 0;
    if (j == qlen) {
      r.max_ie = r.gscore > h1 ? r.max_ie : i;
      r.gscore = imax(r.gscore, h1);
    }
    if (m == 0) break;
    if (m > r.mx) {
      r.mx = m; r.max_i = i; r.max_j = mj;
      int off = mj > i ? mj - i : i - mj;
      r.max_off = imax(r.max_off, off);
    } else if (P.zdrop > 0) {
      int di = i - r.max_i, dj = mj - r.max_j;
      if (di > dj) {
        if (r.mx - m - (di - dj) * P.e_del > P.zdrop) break;
      } else {
        if (r.mx - m - (dj - di) * P.e_ins > P.zdrop) break;
      }
    }
    // shrink the window to the nonzero eh span (ksw.c:466-469)
    for (j = beg; j < end && eh_h[j * B + b] == 0 && eh_e[j * B + b] == 0;
         ++j) {}
    beg = j;
    for (j = end; j >= beg && eh_h[j * B + b] == 0 && eh_e[j * B + b] == 0;
         --j) {}
    end = imin(j + 2, qlen);
  }
  return r;
}

// Lane b: pass 1 at w1, in-lane retry at w2 (bwamem.c:732-741).  out is
// [7, B]: score, qle, tle, gtle, gscore, max_off, retried.
static EXT_HD void ext_lane(const int* qT, const int* tT, const int* qlen,
                            const int* tlen, const int* h0, const int* w1,
                            const int* w2, int thr, int* eh, int* out,
                            const int* mat, int b,
                            const ExtParams& P) {
  const long long B = P.B;
  const long long plane = (long long)(P.LQ + 1) * B;
  int* eh_h = eh;
  int* eh_e = eh + plane;
  const int ql = qlen[b], tl = tlen[b], h = h0[b];
  PassOut r = dp_pass(qT, tT, eh_h, eh_e, mat, b, ql, tl, h, w1[b], P);
  const int retry = (r.max_off >= thr) && (r.mx != h) && (ql > 0);
  if (retry) r = dp_pass(qT, tT, eh_h, eh_e, mat, b, ql, tl, h, w2[b], P);
  out[0 * B + b] = r.mx;
  out[1 * B + b] = r.max_j + 1;
  out[2 * B + b] = r.max_i + 1;
  out[3 * B + b] = r.max_ie + 1;
  out[4 * B + b] = r.gscore;
  out[5 * B + b] = r.max_off;
  out[6 * B + b] = retry;
}

// Lane b: one pass at band w[b].  out is [6, B]: score, qle, tle, gtle,
// gscore, max_off.
static EXT_HD void ext_pl_lane(const int* qT, const int* tT, const int* qlen,
                               const int* tlen, const int* h0, const int* w,
                               int* eh, int* out, const int* mat, int b,
                               const ExtParams& P) {
  const long long B = P.B;
  const long long plane = (long long)(P.LQ + 1) * B;
  const PassOut r = dp_pass(qT, tT, eh, eh + plane, mat, b, qlen[b], tlen[b],
                            h0[b], w[b], P);
  out[0 * B + b] = r.mx;
  out[1 * B + b] = r.max_j + 1;
  out[2 * B + b] = r.max_i + 1;
  out[3 * B + b] = r.max_ie + 1;
  out[4 * B + b] = r.gscore;
  out[5 * B + b] = r.max_off;
}

static void fill_params(ExtParams& P, const int* mat25, int o_del, int e_del,
                        int o_ins, int e_ins, int zdrop, int B, int LQ,
                        int t_max) {
  for (int k = 0; k < 25; ++k) P.mat[k] = mat25[k];
  P.o_del = o_del; P.e_del = e_del; P.o_ins = o_ins; P.e_ins = e_ins;
  P.zdrop = zdrop; P.B = B; P.LQ = LQ; P.t_max = t_max;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(128)
ext_pl_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
              const int* __restrict__ qlen, const int* __restrict__ tlen,
              const int* __restrict__ h0, const int* __restrict__ w,
              int* __restrict__ eh, int* __restrict__ out, ExtParams P) {
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = P.mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;                   // ragged edge
  ext_pl_lane(qT, tT, qlen, tlen, h0, w, eh, out, smat, b, P);
}

// C entry for ctypes, as ext_pl2_launch below: device pointers, a host
// int32[25] matrix; returns cudaGetLastError() after the launch.
extern "C" int ext_pl_launch(const int* qT, const int* tT, const int* qlen,
                             const int* tlen, const int* h0, const int* w,
                             int* eh, int* out, int B, int LQ, int t_max,
                             const int* mat25, int o_del, int e_del,
                             int o_ins, int e_ins, int zdrop, void* stream) {
  ExtParams P;
  fill_params(P, mat25, o_del, e_del, o_ins, e_ins, zdrop, B, LQ, t_max);
  if (B > 0) {
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    ext_pl_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        qT, tT, qlen, tlen, h0, w, eh, out, P);
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(128)
ext_pl2_kernel(const int* __restrict__ qT, const int* __restrict__ tT,
               const int* __restrict__ qlen, const int* __restrict__ tlen,
               const int* __restrict__ h0, const int* __restrict__ w1,
               const int* __restrict__ w2, int thr, int* __restrict__ eh,
               int* __restrict__ out, ExtParams P) {
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = P.mat[threadIdx.x];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= P.B) return;                   // ragged edge
  ext_lane(qT, tT, qlen, tlen, h0, w1, w2, thr, eh, out, smat, b, P);
}

// C entry for ctypes: pointers are device pointers, mat25 a host int32[25];
// returns cudaGetLastError() after the launch.
extern "C" int ext_pl2_launch(const int* qT, const int* tT, const int* qlen,
                              const int* tlen, const int* h0, const int* w1,
                              const int* w2, int thr, int* eh, int* out,
                              int B, int LQ, int t_max,
                              const int* mat25, int o_del, int e_del,
                              int o_ins, int e_ins, int zdrop,
                              void* stream) {
  ExtParams P;
  fill_params(P, mat25, o_del, e_del, o_ins, e_ins, zdrop, B, LQ, t_max);
  if (B > 0) {
    const int threads = 128;
    const int blocks = (B + threads - 1) / threads;
    ext_pl2_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        qT, tT, qlen, tlen, h0, w1, w2, thr, eh, out, P);
  }
  return (int)cudaGetLastError();
}

#else

// Host builds of the same lane loops (all pointers are host memory).
extern "C" int ext_pl_host(const int* qT, const int* tT, const int* qlen,
                           const int* tlen, const int* h0, const int* w,
                           int* eh, int* out, int B, int LQ, int t_max,
                           const int* mat25, int o_del, int e_del,
                           int o_ins, int e_ins, int zdrop) {
  ExtParams P;
  fill_params(P, mat25, o_del, e_del, o_ins, e_ins, zdrop, B, LQ, t_max);
  for (int b = 0; b < B; ++b)
    ext_pl_lane(qT, tT, qlen, tlen, h0, w, eh, out, P.mat, b, P);
  return 0;
}

extern "C" int ext_pl2_host(const int* qT, const int* tT, const int* qlen,
                            const int* tlen, const int* h0, const int* w1,
                            const int* w2, int thr, int* eh, int* out,
                            int B, int LQ, int t_max,
                            const int* mat25, int o_del, int e_del,
                            int o_ins, int e_ins, int zdrop) {
  ExtParams P;
  fill_params(P, mat25, o_del, e_del, o_ins, e_ins, zdrop, B, LQ, t_max);
  for (int b = 0; b < B; ++b)
    ext_lane(qT, tT, qlen, tlen, h0, w1, w2, thr, eh, out, P.mat, b, P);
  return 0;
}

#endif
