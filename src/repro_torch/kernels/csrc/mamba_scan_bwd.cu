// Backward of the Mamba2 SSD chunked scan (B5-bwd) for Hopper, on the CUDA cores.
//
// No TPU kernel corresponds to it: the JAX package differentiates the
// `lax.scan` over chunks in `mamba2_forward` (models/ssm.py) with autodiff.
// This is the gradient of csrc/mamba_scan.cu's function for the port's
// `MambaScanFn` (kernels/mamba_scan.py), the same gradient autograd takes
// through its plain version.  Inputs, all f32: x (B, H, NC, Q, P), dt and ld
// (B, H, NC, Q), Bm and Cm (B, NC, Q, N) through their strides (the last dim
// of x, Bm, Cm and dy contiguous), the output's gradient dy (B, H, NC, Q, P),
// the final state's gradient dh (B, H, P, N), and the forward's `states`
// scratch: the state h_c entering each chunk (B, H, NC, P, N).  Outputs,
// contiguous f32: dx, d dt, d ld, dBm, dCm and dh0.
//
// Per chunk, with cum the within-chunk cumulative sum of ld, u_s = dt_s x_s,
// G_ts = C_t . B_s and A_ts = exp(cum_t - cum_s) for s <= t, the forward is
//   y_t = sum_s G_ts A_ts u_s + exp(cum_t) h_c C_t,
//   h_{c+1} = exp(cum_end) h_c + sum_s exp(cum_end - cum_s) u_s (x) B_s.
// With g_{c+1} the gradient of the state leaving chunk c:
//   g_c = g_{c+1} exp(cum_end_c) + sum_t exp(cum_t) dy_t (x) C_t   (g_NC = dh)
//   du_s = sum_t G_ts A_ts dy_t + exp(cum_end - cum_s) g_{c+1} B_s
//   dB_s = sum_t D_ts A_ts C_t + exp(cum_end - cum_s) g_{c+1}^T u_s, D_ts = dy_t . u_s
//   dC_t = sum_s D_ts A_ts B_s + exp(cum_t) h_c^T dy_t
//   d cum_t += M_ts = G_ts A_ts D_ts, d cum_s -= M_ts; the state terms add
//   exp(cum_t) dy_t . h_c C_t to d cum_t, move T_s = exp(cum_end - cum_s)
//   u_s . g_{c+1} B_s from d cum_s to d cum_end, and add exp(cum_end)
//   <g_{c+1}, h_c> to d cum_end; d ld is the reverse cumulative sum of d cum
//   over the chunk, dx = dt du and d dt = x . du.
// Six launches on one stream (the wrapper counts one call):
//   1. dstate: per (b, h, c) the chunk's own part of g, sum_t exp(cum_t)
//      dy_t (x) C_t, and cum_end;
//   2. carry:  per (b, h) and state element, in reverse chunk order,
//      g_c = g_{c+1} exp(cum_end_c) + that part, from dh: written over it, so
//      scratch c ends holding g_{c+1}; dh0 = g_0;
//   3. rows_s: per (b, h, c) and 64-step tile of s, du, dx, d dt, this
//      head's part of dB, the -M and -T parts of d cum_s and the tile's sum of T;
//   4. rows_t: per (b, h, c) and 64-step tile of t, this head's part of dC
//      and the +M and read-out parts of d cum_t;
//   5. finish: per (b, h, c), d cum_end's state terms and d ld, the
//      reverse cumulative sum of d cum;
//   6. heads:  dBm and dCm, each head's parts summed in head order.
// No atomics: every output element is written once by one thread, so the
// step is deterministic.
//
// What bounds it on this card: operations.  At zamba2-1.2b's training shape
// (B 2, 64 heads, 32 chunks of 256, P = N = 64) launches 3 and 4 take ~11 M
// multiply-adds per (b, h, c) (the products G and D twice, the W dy, V C and
// V B products and the state terms), ~1e11 flops in all on ~0.8 GB of
// inputs and outputs plus ~0.7 GB of per-head scratch.  They run as f32 FMAs
// on the CUDA cores (67 TFLOP/s on an H100 SXM): a simple kernel, right
// first.  Thread (ty, tx) of 16 x 16 keeps 4 x 4 tiles in registers; tiles
// of 64 steps are staged in shared memory in rows of 65 floats.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch_mamba_bwd {

constexpr int kT = 64;         // steps per tile; P and N are zero-padded to this
constexpr int kLd = kT + 1;    // a staged row
constexpr int kMaxQ = 256;
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx)

// Element strides: (batch, head, chunk, step) of x, dt, ld and dy; (batch,
// chunk, step) of Bm and Cm.
struct BwdStrides {
  long long x[4], dt[4], ld[4], bm[3], cm[3], dy[4];
};

// rows [0, kT) x cols [0, kT) from src (row stride `stride`) into shared rows
// of kLd floats; rows at or past `rows` and columns at or past `cols` are zero.
__device__ __forceinline__ void stage(float* dst, const float* src, long long stride, int rows,
                                      int cols) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    dst[r * kLd + c] = r < rows && c < cols ? src[r * stride + c] : 0.f;
  }
}

// Inclusive cumsum of the chunk's Q log decays into cum[0..Q), in step order
// (every launch computes it with this one function).
__device__ __forceinline__ void chunk_cumsum(const float* ldc, long long st, int Q,
                                             float* cum) {
  for (int t = threadIdx.x; t < Q; t += kThreads) cum[t] = ldc[t * st];
  __syncthreads();
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int t = 0; t < Q; ++t) {
      run += cum[t];
      cum[t] = run;
    }
  }
  __syncthreads();
}

// acc[i][j] = sum_d a[ra + 16 i][d] b[rb + 16 j][d] over kT columns
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, int ra,
                                         const float* b, int rb) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kT; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ra + 16 * i) * kLd + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(rb + 16 * j) * kLd + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c w[r + 16 i][c] m[c][tx + 16 j] over kT rows c
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][4], const float* w, int r,
                                                const float* m, int tx) {
#pragma unroll 4
  for (int c = 0; c < kT; ++c) {
    float wv[4], mv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w[(r + 16 * i) * kLd + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) mv[j] = m[c * kLd + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], mv[j], acc[i][j]);
  }
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- 1. dstate: sum_t exp(cum_t) dy_t (x) C_t per (b, h, c) -----------------
// grid (B H NC): block i = (b H + h) NC + c.
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel_dstate(const float* __restrict__ ld, const float* __restrict__ cm,
                             const float* __restrict__ dy, float* __restrict__ gout,
                             float* __restrict__ cum_end, int H, int NC, int Q, int P, int N,
                             BwdStrides sd) {
  __shared__ float cum[kMaxQ];
  __shared__ float dys[kT * kLd];
  __shared__ float cs[kT * kLd];
  const int i = blockIdx.x;
  const int c = i % NC, h = (i / NC) % H, b = i / (NC * H);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  chunk_cumsum(ld + b * sd.ld[0] + h * sd.ld[1] + c * sd.ld[2], sd.ld[3], Q, cum);
  const float* dyc = dy + b * sd.dy[0] + h * sd.dy[1] + c * sd.dy[2];
  const float* cmc = cm + b * sd.cm[0] + c * sd.cm[1];
  float acc[4][4] = {};  // rows p = ty + 16 i, cols n = tx + 16 j
  for (int t0 = 0; t0 < Q; t0 += kT) {
    __syncthreads();
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, col = e % kT;
      const bool in = t0 + r < Q;
      dys[r * kLd + col] =
          in && col < P ? dyc[(t0 + r) * sd.dy[3] + col] * expf(cum[t0 + r]) : 0.f;
      cs[r * kLd + col] = in && col < N ? cmc[(t0 + r) * sd.cm[2] + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kT; ++t) {
      float a[4], bv[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) a[ii] = dys[t * kLd + ty + 16 * ii];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = cs[t * kLd + tx + 16 * j];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[ii][j] = fmaf(a[ii], bv[j], acc[ii][j]);
    }
  }
  float* gc = gout + (long long)i * P * N;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = ty + 16 * ii, n = tx + 16 * j;
      if (p < P && n < N) gc[p * N + n] = acc[ii][j];
    }
  if (threadIdx.x == 0) cum_end[i] = cum[Q - 1];
}

// ---- 2. carry: the state gradient, in reverse chunk order ------------------
// One thread per (b, h, state element); gout[b, h, c] holds chunk c's part on
// entry and g_{c+1}, the gradient of the state leaving chunk c, on exit.
__global__ void __launch_bounds__(256)
mamba_scan_bwd_kernel_carry(float* __restrict__ gout, const float* __restrict__ cum_end,
                            const float* __restrict__ dh, float* __restrict__ dh0, int NC,
                            int PN, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long bh = i / PN;
  const int e = static_cast<int>(i % PN);
  float g = dh[i];
  float* gp = gout + bh * NC * PN + e;
  const float* ce = cum_end + bh * NC;
  for (int c = NC - 1; c >= 0; --c) {
    const float part = gp[(long long)c * PN];
    gp[(long long)c * PN] = g;
    g = g * expf(ce[c]) + part;
  }
  dh0[i] = g;
}

// ---- 3. rows_s: du, dx, d dt, dB (this head), d cum_s's negative terms -----
// grid (B H NC, tiles of s); block (i, st) owns steps s0 = 64 st ...
constexpr int rows_s_smem_floats() { return kMaxQ + kT + kT + 7 * kT * kLd; }

__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel_rows_s(const float* __restrict__ x, const float* __restrict__ dt,
                             const float* __restrict__ ld, const float* __restrict__ bm,
                             const float* __restrict__ cm, const float* __restrict__ dy,
                             const float* __restrict__ gout, float* __restrict__ dx,
                             float* __restrict__ ddt, float* __restrict__ dbp,
                             float* __restrict__ dcum_a, float* __restrict__ tpart, int H,
                             int NC, int Q, int P, int N, BwdStrides sd) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;               // [kMaxQ]
  float* dts = cum + kMaxQ;        // [kT]: dt of this tile's steps
  float* tl = dts + kT;            // [kT]: T_s of this tile's steps
  float* bs = tl + kT;             // [kT][kLd]: B_s
  float* xs = bs + kT * kLd;       // [kT][kLd]: x_s
  float* cs = xs + kT * kLd;       // [kT][kLd]: C_t
  float* dys = cs + kT * kLd;      // [kT][kLd]: dy_t
  float* wt = dys + kT * kLd;      // [kT][kLd]: W = G A, rows s, cols t
  float* vt = wt + kT * kLd;       // [kT][kLd]: V = D A
  float* gs = vt + kT * kLd;       // [kT][kLd]: g_{c+1}, rows p, cols n

  const int i = blockIdx.x, st = blockIdx.y, s0 = st * kT;
  const int c = i % NC, h = (i / NC) % H, b = i / (NC * H);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_tiles = (Q + kT - 1) / kT;
  chunk_cumsum(ld + b * sd.ld[0] + h * sd.ld[1] + c * sd.ld[2], sd.ld[3], Q, cum);
  const float* dtc = dt + b * sd.dt[0] + h * sd.dt[1] + c * sd.dt[2];
  const float* xc = x + b * sd.x[0] + h * sd.x[1] + c * sd.x[2];
  const float* bmc = bm + b * sd.bm[0] + c * sd.bm[1];
  const float* cmc = cm + b * sd.cm[0] + c * sd.cm[1];
  const float* dyc = dy + b * sd.dy[0] + h * sd.dy[1] + c * sd.dy[2];
  for (int r = threadIdx.x; r < kT; r += kThreads) dts[r] = s0 + r < Q ? dtc[(s0 + r) * sd.dt[3]] : 0.f;
  stage(bs, bmc + s0 * sd.bm[2], sd.bm[2], Q - s0, N);
  stage(xs, xc + s0 * sd.x[3], sd.x[3], Q - s0, P);
  stage(gs, gout + (long long)i * P * N, N, P, N);

  float du[4][4] = {}, db[4][4] = {};  // rows s = ty + 16 i; cols p (du) or n (db)
  float mrow[4] = {};                   // sum_t M_ts, this thread's columns
  for (int tt = st; tt < n_tiles; ++tt) {
    const int t0 = tt * kT;
    __syncthreads();  // the previous tile's C, dy, W and V are no longer read
    stage(cs, cmc + t0 * sd.cm[2], sd.cm[2], Q - t0, N);
    stage(dys, dyc + t0 * sd.dy[3], sd.dy[3], Q - t0, P);
    __syncthreads();
    float g[4][4], d[4][4];  // rows s = ty + 16 i, cols t = tx + 16 j
    tile_dot(g, bs, ty, cs, tx);
    tile_dot(d, xs, ty, dys, tx);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int sl = ty + 16 * ii, sp = s0 + sl;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int tl_ = tx + 16 * j, tp = t0 + tl_;
        const bool ok = sp < Q && tp < Q && tp >= sp;
        const float a = ok ? expf(cum[tp] - cum[sp]) : 0.f;
        const float dd = dts[sl] * d[ii][j];
        const float w = g[ii][j] * a;
        wt[sl * kLd + tl_] = w;
        vt[sl * kLd + tl_] = dd * a;
        mrow[ii] = fmaf(w, dd, mrow[ii]);
      }
    }
    __syncthreads();
    tile_accumulate(du, wt, ty, dys, tx);
    tile_accumulate(db, vt, ty, cs, tx);
  }

  // the state terms, then the outputs
  const float ce = cum[Q - 1];
  const long long row0 = (long long)i * Q;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int sl = ty + 16 * ii, sp = s0 + sl;
    const float es = sp < Q ? expf(ce - cum[sp]) : 0.f;
    float tpart_ = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      float gb = 0.f, gx = 0.f;  // (g B_s)[p = col], (g^T x_s)[n = col]
      for (int e = 0; e < kT; ++e) {
        gb = fmaf(gs[col * kLd + e], bs[sl * kLd + e], gb);
        gx = fmaf(gs[e * kLd + col], xs[sl * kLd + e], gx);
      }
      du[ii][j] = fmaf(es, gb, du[ii][j]);
      db[ii][j] = fmaf(es * dts[sl], gx, db[ii][j]);
      tpart_ = fmaf(xs[sl * kLd + col], gb, tpart_);
    }
    const float t_s = es * dts[sl] * row_sum(tpart_);
    const float m_s = row_sum(mrow[ii]);
    float dd = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dd = fmaf(xs[sl * kLd + tx + 16 * j], du[ii][j], dd);
    dd = row_sum(dd);
    if (tx == 0) tl[sl] = t_s;
    if (sp >= Q) continue;
    float* dxr = dx + (row0 + sp) * P;
    float* dbr = dbp + (row0 + sp) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (col < P) dxr[col] = dts[sl] * du[ii][j];
      if (col < N) dbr[col] = db[ii][j];
    }
    if (tx == 0) {
      ddt[row0 + sp] = dd;
      dcum_a[row0 + sp] = -m_s - t_s;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int r = 0; r < kT; ++r) sum += tl[r];
    tpart[(long long)i * n_tiles + st] = sum;
  }
}

// ---- 4. rows_t: dC (this head), d cum_t's positive terms --------------------
constexpr int rows_t_smem_floats() { return kMaxQ + kT + 6 * kT * kLd; }

__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel_rows_t(const float* __restrict__ x, const float* __restrict__ dt,
                             const float* __restrict__ ld, const float* __restrict__ bm,
                             const float* __restrict__ cm, const float* __restrict__ dy,
                             const float* __restrict__ states, float* __restrict__ dcp,
                             float* __restrict__ dcum_b, int H, int NC, int Q, int P, int N,
                             BwdStrides sd) {
  extern __shared__ __align__(16) float smem[];
  float* cum = smem;               // [kMaxQ]
  float* dts = cum + kMaxQ;        // [kT]: dt of the s tile
  float* cs = dts + kT;            // [kT][kLd]: C_t
  float* dys = cs + kT * kLd;      // [kT][kLd]: dy_t
  float* bs = dys + kT * kLd;      // [kT][kLd]: B_s
  float* xs = bs + kT * kLd;       // [kT][kLd]: x_s
  float* vt = xs + kT * kLd;       // [kT][kLd]: V = D A, rows t, cols s
  float* hs = vt + kT * kLd;       // [kT][kLd]: h_c, rows p, cols n

  const int i = blockIdx.x, tt = blockIdx.y, t0 = tt * kT;
  const int c = i % NC, h = (i / NC) % H, b = i / (NC * H);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  chunk_cumsum(ld + b * sd.ld[0] + h * sd.ld[1] + c * sd.ld[2], sd.ld[3], Q, cum);
  const float* dtc = dt + b * sd.dt[0] + h * sd.dt[1] + c * sd.dt[2];
  const float* xc = x + b * sd.x[0] + h * sd.x[1] + c * sd.x[2];
  const float* bmc = bm + b * sd.bm[0] + c * sd.bm[1];
  const float* cmc = cm + b * sd.cm[0] + c * sd.cm[1];
  const float* dyc = dy + b * sd.dy[0] + h * sd.dy[1] + c * sd.dy[2];
  stage(cs, cmc + t0 * sd.cm[2], sd.cm[2], Q - t0, N);
  stage(dys, dyc + t0 * sd.dy[3], sd.dy[3], Q - t0, P);
  stage(hs, states + (long long)i * P * N, N, P, N);

  float dc[4][4] = {};   // rows t = ty + 16 i, cols n
  float mrow[4] = {};
  for (int st = 0; st <= tt; ++st) {
    const int s0 = st * kT;
    __syncthreads();  // the previous tile's B, x, dt and V are no longer read
    stage(bs, bmc + s0 * sd.bm[2], sd.bm[2], Q - s0, N);
    stage(xs, xc + s0 * sd.x[3], sd.x[3], Q - s0, P);
    for (int r = threadIdx.x; r < kT; r += kThreads) dts[r] = s0 + r < Q ? dtc[(s0 + r) * sd.dt[3]] : 0.f;
    __syncthreads();
    float g[4][4], d[4][4];  // rows t = ty + 16 i, cols s = tx + 16 j
    tile_dot(g, cs, ty, bs, tx);
    tile_dot(d, dys, ty, xs, tx);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int tl_ = ty + 16 * ii, tp = t0 + tl_;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int sl = tx + 16 * j, sp = s0 + sl;
        const bool ok = sp < Q && tp < Q && sp <= tp;
        const float a = ok ? expf(cum[tp] - cum[sp]) : 0.f;
        const float dd = dts[sl] * d[ii][j];
        vt[tl_ * kLd + sl] = dd * a;
        mrow[ii] = fmaf(g[ii][j] * a, dd, mrow[ii]);
      }
    }
    __syncthreads();
    tile_accumulate(dc, vt, ty, bs, tx);
  }

  const long long row0 = (long long)i * Q;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int tl_ = ty + 16 * ii, tp = t0 + tl_;
    const float et = tp < Q ? expf(cum[tp]) : 0.f;
    float rpart = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      float hd = 0.f, hc = 0.f;  // (h_c^T dy_t)[n = col], (h_c C_t)[p = col]
      for (int e = 0; e < kT; ++e) {
        hd = fmaf(dys[tl_ * kLd + e], hs[e * kLd + col], hd);
        hc = fmaf(hs[col * kLd + e], cs[tl_ * kLd + e], hc);
      }
      dc[ii][j] = fmaf(et, hd, dc[ii][j]);
      rpart = fmaf(dys[tl_ * kLd + col], hc, rpart);
    }
    const float r_t = et * row_sum(rpart);
    const float m_t = row_sum(mrow[ii]);
    if (tp >= Q) continue;
    float* dcr = dcp + (row0 + tp) * N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      if (col < N) dcr[col] = dc[ii][j];
    }
    if (tx == 0) dcum_b[row0 + tp] = m_t + r_t;
  }
}

// ---- 5. finish: d cum_end's state terms and d ld ----------------------------
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel_finish(const float* __restrict__ gout, const float* __restrict__ states,
                             const float* __restrict__ cum_end,
                             const float* __restrict__ dcum_a, const float* __restrict__ dcum_b,
                             const float* __restrict__ tpart, float* __restrict__ dld, int Q,
                             int PN, int n_tiles) {
  __shared__ float red[kThreads];
  __shared__ float dcs[kMaxQ];
  const int i = blockIdx.x;
  const float* gc = gout + (long long)i * PN;
  const float* hc = states + (long long)i * PN;
  float part = 0.f;
  for (int e = threadIdx.x; e < PN; e += kThreads) part = fmaf(gc[e], hc[e], part);
  red[threadIdx.x] = part;
  const long long row0 = (long long)i * Q;
  for (int t = threadIdx.x; t < Q; t += kThreads) dcs[t] = dcum_a[row0 + t] + dcum_b[row0 + t];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float extra = 0.f;
    for (int st = 0; st < n_tiles; ++st) extra += tpart[(long long)i * n_tiles + st];
    extra = fmaf(expf(cum_end[i]), red[0], extra);
    float run = extra;
    for (int t = Q - 1; t >= 0; --t) {
      run += dcs[t];
      dld[row0 + t] = run;
    }
  }
}

// ---- 6. heads: dBm, dCm = sum over heads of each head's part ----------------
__global__ void __launch_bounds__(256)
mamba_scan_bwd_kernel_heads(const float* __restrict__ dbp, const float* __restrict__ dcp,
                            float* __restrict__ dbm, float* __restrict__ dcm, int H,
                            long long per_head, long long total) {
  // output (b, rest) with rest = (c, t, n); part (b, h, rest)
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const long long b = o / per_head, rest = o % per_head;
  const float* pb = dbp + b * H * per_head + rest;
  const float* pc = dcp + b * H * per_head + rest;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < H; ++h) {
    sb += pb[(long long)h * per_head];
    sc += pc[(long long)h * per_head];
  }
  dbm[o] = sb;
  dcm[o] = sc;
}

}  // namespace repro_torch_mamba_bwd

// strides: 22 element strides, (batch, head, chunk, step) of x, dt, ld; (batch,
// chunk, step) of Bm, Cm; (batch, head, chunk, step) of dy.  states, dh and
// every output and scratch buffer are contiguous: gout (B, H, NC, P, N),
// cum_end (B, H, NC), dcum_a and dcum_b (B, H, NC, Q), tpart (B, H, NC,
// ceil(Q / 64)), dbp and dcp (B, H, NC, Q, N).  Q <= 256, P, N <= 64.
// Returns the CUDA error of the launches (0 on success); runs on `stream`.
extern "C" int repro_torch_mamba_scan_bwd(
    const float* x, const float* dt, const float* ld, const float* bm, const float* cm,
    const float* dy, const float* states, const float* dh, float* dx, float* ddt, float* dld,
    float* dbm, float* dcm, float* dh0, float* gout, float* cum_end, float* dcum_a,
    float* dcum_b, float* tpart, float* dbp, float* dcp, int B, int H, int NC, int Q, int P,
    int N, const long long* strides, void* stream) {
  namespace k = repro_torch_mamba_bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (Q < 1 || Q > k::kMaxQ || P > k::kT || N > k::kT) return (int)cudaErrorInvalidValue;
  k::BwdStrides sd;
  for (int i = 0; i < 4; ++i) {
    sd.x[i] = strides[i];
    sd.dt[i] = strides[4 + i];
    sd.ld[i] = strides[8 + i];
    sd.dy[i] = strides[18 + i];
  }
  for (int i = 0; i < 3; ++i) {
    sd.bm[i] = strides[12 + i];
    sd.cm[i] = strides[15 + i];
  }
  const long long PN = (long long)P * N;
  const long long bh = (long long)B * H;
  if (NC == 0) {  // no steps: the state passes through
    const long long total = bh * PN;
    cudaMemcpyAsync(dh0, dh, total * sizeof(float), cudaMemcpyDeviceToDevice, st);
    return (int)cudaGetLastError();
  }
  const long long chunks = bh * NC;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int n_tiles = (Q + k::kT - 1) / k::kT;
  const int smem_s = k::rows_s_smem_floats() * (int)sizeof(float);
  const int smem_t = k::rows_t_smem_floats() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(k::mamba_scan_bwd_kernel_rows_s,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(k::mamba_scan_bwd_kernel_rows_t,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_t);
  if (err != cudaSuccess) return (int)err;

  k::mamba_scan_bwd_kernel_dstate<<<(unsigned)chunks, k::kThreads, 0, st>>>(
      ld, cm, dy, gout, cum_end, H, NC, Q, P, N, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long total = bh * PN;
  k::mamba_scan_bwd_kernel_carry<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      gout, cum_end, dh, dh0, NC, (int)PN, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k::mamba_scan_bwd_kernel_rows_s<<<dim3((unsigned)chunks, n_tiles), k::kThreads, smem_s, st>>>(
      x, dt, ld, bm, cm, dy, gout, dx, ddt, dbp, dcum_a, tpart, H, NC, Q, P, N, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k::mamba_scan_bwd_kernel_rows_t<<<dim3((unsigned)chunks, n_tiles), k::kThreads, smem_t, st>>>(
      x, dt, ld, bm, cm, dy, states, dcp, dcum_b, H, NC, Q, P, N, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  k::mamba_scan_bwd_kernel_finish<<<(unsigned)chunks, k::kThreads, 0, st>>>(
      gout, states, cum_end, dcum_a, dcum_b, tpart, dld, Q, (int)PN, n_tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long per_head = (long long)NC * Q * N;
  const long long outs = (long long)B * per_head;
  k::mamba_scan_bwd_kernel_heads<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(
      dbp, dcp, dbm, dcm, H, per_head, outs);
  return (int)cudaGetLastError();
}
