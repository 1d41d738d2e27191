// Backward of the Mamba2 SSD chunked scan (B5-bwd) for Hopper, on the tensor cores.
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
// With g_{c+1} the gradient of the state leaving chunk c, W = G o A, D_ts =
// dy_t . u_s and V = D o A:
//   g_c = g_{c+1} exp(cum_end_c) + sum_t exp(cum_t) dy_t (x) C_t   (g_NC = dh)
//   du_s = sum_t W_ts dy_t + exp(cum_end - cum_s) g_{c+1} B_s
//   dB_s = sum_t V_ts C_t + exp(cum_end - cum_s) g_{c+1}^T u_s
//   dC_t = sum_s V_ts B_s + exp(cum_t) h_c^T dy_t
//   d cum_t += M_ts = W_ts D_ts, d cum_s -= M_ts; the state terms add R_t =
//   exp(cum_t) dy_t . h_c C_t to d cum_t, move T_s = exp(cum_end - cum_s)
//   u_s . g_{c+1} B_s from d cum_s to d cum_end, and add exp(cum_end)
//   <g_{c+1}, h_c> to d cum_end; d ld is the reverse cumulative sum of d cum
//   over the chunk, dx = dt du and d dt = x . du.
// Six launches on one stream (the wrapper counts one call):
//   1. gram:   G = C B^T, every lower-triangular 64 x 64 tile once per
//              (batch, chunk), into scratch (16.8 MB at the training shape):
//              B5's own gram pass (csrc/mamba_common.cuh), read from L2 by
//              every head;
//   2. dstate: per (b, h, c) the chunk's own part of g, sum_t exp(cum_t)
//              dy_t (x) C_t, and cum_end;
//   3. carry:  per (b, h) and state element, in reverse chunk order,
//              g_c = g_{c+1} exp(cum_end_c) + that part, from dh: written over
//              it, so scratch c ends holding g_{c+1}; dh0 = g_0;
//   4. main:   one block per (b, c, 64-step tile i of s) walks the heads in
//              order; for each head and each t tile j >= i it forms D_ji once
//              and from it W, V and M, and accumulates du_i (this head's, so
//              dx and d dt), dB_i (summed over the heads in registers, so dBm
//              is written once, with no per-head scratch) and dC_j's part
//              from tile i (summed over the heads; 8.4 MB of scratch, one
//              slice per i), and writes d cum's parts: its own rows' -M
//              column sums, -T and +R, and the M row sums of every t tile j
//              (a slice per i); at j = i the state terms;
//   5. finish: per (b, h, c), d cum = its parts in tile order, d cum_end's
//              state terms, and d ld, the reverse cumulative sum, by a warp
//              in a fixed order;
//   6. dcsum:  dCm = the slices of dC's parts, summed in tile order.
// No atomics: every output element is written once by one thread, in a
// fixed order, so a step is deterministic.
//
// What bounds it on this card: operations.  At zamba2-1.2b's training shape
// (B 2, 64 heads, 32 chunks of 256, P = N = 64) the function's products are
// ~112 GFLOP (C B^T per (b, c), four triangular products and five state
// products per (b, h, c)) on ~0.8 GB of inputs and outputs.  Every product
// runs on the tensor cores as 3xTF32 (`mma.sync.m16n8k8`, B5's helpers):
// each f32 operand a is split into a_hi (its top 10 mantissa bits) and a_lo
// (the top 10 bits of what is left), and a b ~= a_hi b_hi + a_hi b_lo + a_lo
// b_hi with f32 sums, within ~2^-19 of the f32 product; one TF32 product
// (~2^-11) would not meet the 1e-4 the gradients are held to.  Launch 4's
// block (8 warps) owns 64 x 64 output tiles, warp w rows 16 (w & 3) .. and
// columns 32 (w >> 2) ..; B_i stays in shared memory, each head's x_i,
// g_{c+1} and h_c are staged once, and each step's dy_j, C_j and G_ji come
// through a two-stage cp.async ring, so the next step's loads overlap this
// step's products.  W is written over G in shared memory and V beside it,
// since the products read them in both orientations.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_common.cuh"

namespace repro_torch_mamba_bwd {

using namespace repro_torch;

constexpr int kT = kTile;               // steps per tile; P and N are zero-padded to it
constexpr int kMaxTiles = kMaxQ / kT;   // tiles of a chunk
constexpr int kThreads = 256;           // main: 8 warps
constexpr int kStage = kT * kLd + 2 * kT * kLdT;  // a ring stage: dy_j, C_j, G_ji

// Element strides: (batch, head, chunk, step) of x, dt, ld and dy; (batch,
// chunk, step) of Bm and Cm.
struct BwdStrides {
  long long x[4], dt[4], ld[4], bm[3], cm[3], dy[4];
};

// ---- 2. dstate: sum_t exp(cum_t) dy_t (x) C_t per (b, h, c) -----------------
// grid (B H NC): block i = (b H + h) NC + c, warp w owns state rows p = 16 w ..
// 16 w + 15; the chunk's steps go through a two-stage ring of 64-step tiles.
__global__ void __launch_bounds__(kGemmThreads)
mamba_scan_bwd_kernel_dstate(const float* __restrict__ ld, const float* __restrict__ cm,
                             const float* __restrict__ dy, float* __restrict__ gout,
                             float* __restrict__ cum_end, int H, int NC, int Q, int P, int N,
                             int vec4, BwdStrides sd) {
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                   // [2][kT][kLdT]
  float* cs = dys + 2 * kT * kLdT;     // [2][kT][kLdT]
  float* cum = cs + 2 * kT * kLdT;     // [kMaxQ]
  float* wt = cum + kMaxQ;             // [kMaxQ]: exp(cum_t)

  const int i = blockIdx.x;
  const int c = i % NC, h = (i / NC) % H, b = i / (NC * H);
  const float* dyc = dy + b * sd.dy[0] + h * sd.dy[1] + c * sd.dy[2];
  const float* cmc = cm + b * sd.cm[0] + c * sd.cm[1];
  const int n_tiles = (Q + kT - 1) / kT;
  auto load_stage = [&](int tt, int stage) {
    const int t0 = tt * kT;
    load_tile(dys + stage * kT * kLdT, kLdT, dyc + t0 * sd.dy[3], sd.dy[3], kT, Q - t0, P,
              vec4, kGemmThreads);
    load_tile(cs + stage * kT * kLdT, kLdT, cmc + t0 * sd.cm[2], sd.cm[2], kT, Q - t0, N,
              vec4, kGemmThreads);
  };
  load_stage(0, 0);
  cp_async_commit();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0)
    chunk_cumsum(ld + b * sd.ld[0] + h * sd.ld[1] + c * sd.ld[2], sd.ld[3], Q, n_tiles * kT,
                 cum);
  __syncthreads();
  for (int t = threadIdx.x; t < n_tiles * kT; t += kGemmThreads)
    wt[t] = t < Q ? expf(cum[t]) : 0.f;
  if (threadIdx.x == 0) cum_end[i] = cum[Q - 1];

  const int g = lane >> 2, t4 = lane & 3;
  const int p0 = 16 * warp;
  float acc[8][4] = {};
  for (int tt = 0; tt < n_tiles; ++tt) {
    if (tt + 1 < n_tiles) load_stage(tt + 1, (tt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this stage's tiles, and wt, are in
    if (p0 < P) {
      const float* yt = dys + (tt & 1) * kT * kLdT;
      const float* ct = cs + (tt & 1) * kT * kLdT;
      const float* wl = wt + tt * kT;
#pragma unroll 2
      for (int kk = 0; kk < kT / 8; ++kk) {
        // A[p][t] = dy[t][p] exp(cum_t): rows p0 + g (+8), columns t = 8 kk + t4 (+4)
        const int t = 8 * kk + t4;
        const float w0 = wl[t], w1 = wl[t + 4];
        uint32_t ah[4], al[4];
        split_tf32(yt[t * kLdT + p0 + g] * w0, ah[0], al[0]);
        split_tf32(yt[t * kLdT + p0 + g + 8] * w0, ah[1], al[1]);
        split_tf32(yt[(t + 4) * kLdT + p0 + g] * w1, ah[2], al[2]);
        split_tf32(yt[(t + 4) * kLdT + p0 + g + 8] * w1, ah[3], al[3]);
        BSplit<8> bf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          split_tf32(ct[t * kLdT + 8 * j + g], bf.v[j][0], bf.v[j][2]);
          split_tf32(ct[(t + 4) * kLdT + 8 * j + g], bf.v[j][1], bf.v[j][3]);
        }
        mma_3xtf32_row(acc, ah, al, bf);
      }
    }
    __syncthreads();  // this stage is free for the load the next step issues
  }
  cp_async_wait<0>();
  if (p0 >= P) return;
  float* gc = gout + (long long)i * P * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + 8 * (e >> 1), n = 8 * j + 2 * t4 + (e & 1);
      if (p < P && n < N) gc[p * N + n] = acc[j][e];
    }
}

// ---- 3. carry: the state gradient, in reverse chunk order ------------------
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

// ---- 4. main ------------------------------------------------------------------

// acc[j][e] += sum_{k < 64} a(r, k) b(k, n) for the warp's 16 x 32 block of a
// 64 x 64 product, as 3xTF32 mma.sync: element (j, e) is row g + 8 (e >> 1),
// column 8 j + 2 t4 + (e & 1) of the block; a(r, k) and b(k, n) read the
// operands with r and n relative to the block's first row and column.  The
// product is summed in an accumulator of its own and added to acc by an f32
// add: the tensor cores' accumulation truncates each mma's sum, so a long sum
// kept in their accumulator (dB over 64 heads and 256 steps, ~7 700 mma's)
// drifts by up to an ulp of the running total an mma; measured on an H100,
// 1.6e-4 of dB's largest value at the padded chunk's last real step.
template <class FA, class FB>
__device__ __forceinline__ void mma_block(float (&acc)[4][4], FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float part[4][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < kT / 8; ++kk) {
    const int k = 8 * kk + t4;
    uint32_t ah[4], al[4];
    split_tf32(a(g, k), ah[0], al[0]);
    split_tf32(a(g + 8, k), ah[1], al[1]);
    split_tf32(a(g, k + 4), ah[2], al[2]);
    split_tf32(a(g + 8, k + 4), ah[3], al[3]);
    BSplit<4> bf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_tf32(b(k, 8 * j + g), bf.v[j][0], bf.v[j][2]);
      split_tf32(b(k + 4, 8 * j + g), bf.v[j][1], bf.v[j][3]);
    }
    mma_3xtf32_row(part, ah, al, bf);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

// the two values of a block row (g and g + 8 of each warp) summed over the
// four lanes that hold its columns, into red[half][row] (half: w >> 2)
__device__ __forceinline__ void row_partials(float (&v)[2], float* red, int r0, int half) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    v[hr] += __shfl_xor_sync(0xffffffffu, v[hr], 1);
    v[hr] += __shfl_xor_sync(0xffffffffu, v[hr], 2);
  }
  if ((lane & 3) == 0) {
    red[half * kT + r0 + (lane >> 2)] = v[0];
    red[half * kT + r0 + (lane >> 2) + 8] = v[1];
  }
}

constexpr int main_smem_floats() {
  return kT * kLdT          // B_i [s][n]
         + 3 * kT * kLd     // x_i [s][p], g_{c+1} [p][n], h_c [p][n]
         + 2 * kStage       // the ring
         + kT * kLdT        // V [t][s]
         + kMaxQ            // cum
         + 4 * kT           // dt, es, es dt, et of tile i's rows
         + 12 * kT;         // reductions: M rows, T, R, d dt (2 each), M columns (4)
}

__global__ void __launch_bounds__(kThreads, 1)
mamba_scan_bwd_kernel_main(const float* __restrict__ x, const float* __restrict__ dt,
                           const float* __restrict__ ld, const float* __restrict__ bm,
                           const float* __restrict__ cm, const float* __restrict__ dy,
                           const float* __restrict__ gram, const float* __restrict__ gout,
                           const float* __restrict__ states, float* __restrict__ dx,
                           float* __restrict__ ddt, float* __restrict__ dbm,
                           float* __restrict__ dcp, float* __restrict__ own,
                           float* __restrict__ mrow, float* __restrict__ tpart, int H, int NC,
                           int Q, int P, int N, int Qg, int vec4, BwdStrides sd) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                    // [kT][kLdT]  B_i
  float* xs = bs + kT * kLdT;          // [kT][kLd]   x_i
  float* gs = xs + kT * kLd;           // [kT][kLd]   g_{c+1}, rows p
  float* hs = gs + kT * kLd;           // [kT][kLd]   h_c, rows p
  float* ring = hs + kT * kLd;         // [2][kStage]
  float* vs = ring + 2 * kStage;       // [kT][kLdT]  V, rows t, columns s
  float* cum = vs + kT * kLdT;         // [kMaxQ]
  float* dts = cum + kMaxQ;            // [kT]  dt_s of tile i
  float* ess = dts + kT;               // [kT]  exp(cum_end - cum_s)
  float* esdt = ess + kT;              // [kT]  exp(cum_end - cum_s) dt_s
  float* ets = esdt + kT;              // [kT]  exp(cum_t)
  float* red_m = ets + kT;             // [2][kT]  M row sums of a step
  float* red_t = red_m + 2 * kT;       // [2][kT]  T_s / dt_s
  float* red_r = red_t + 2 * kT;       // [2][kT]  R_t / exp(cum_t)
  float* red_d = red_r + 2 * kT;       // [2][kT]  d dt
  float* red_c = red_d + 2 * kT;       // [4][kT]  M column sums of a head
  float* tfin = red_m;                 // [kT]  T_s, once red_m is read

  // s tiles in order: the first sees the most t tiles
  const int nt = (Q + kT - 1) / kT;
  const int nbc = gridDim.x / nt;
  const int i = blockIdx.x / nbc, bc = blockIdx.x % nbc;
  const int b = bc / NC, c = bc % NC;
  const int s0 = i * kT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rt = warp & 3, half = warp >> 2;
  const int r0 = 16 * rt, c0 = 32 * half;  // this warp's block of every 64 x 64 product
  const int nj = nt - i;                    // t tiles j = i .. nt - 1
  const int steps = H * nj;
  const float* bmc = bm + b * sd.bm[0] + c * sd.bm[1];
  const float* cmc = cm + b * sd.cm[0] + c * sd.cm[1];
  const float* gbc = gram + (long long)bc * Qg * Qg;

  auto load_step = [&](int n, int stage) {  // step n = (head n / nj, t tile i + n % nj)
    const int h = n / nj, t0 = (i + n % nj) * kT;
    float* st = ring + stage * kStage;
    load_tile(st, kLd, dy + b * sd.dy[0] + h * sd.dy[1] + c * sd.dy[2] + t0 * sd.dy[3],
              sd.dy[3], kT, Q - t0, P, vec4, kThreads);
    load_tile(st + kT * kLd, kLdT, cmc + t0 * sd.cm[2], sd.cm[2], kT, Q - t0, N, vec4,
              kThreads);
    load_tile(st + kT * kLd + kT * kLdT, kLdT, gbc + (long long)t0 * Qg + s0, Qg, kT, kT, kT,
              true, kThreads);
  };
  load_tile(bs, kLdT, bmc + s0 * sd.bm[2], sd.bm[2], kT, Q - s0, N, vec4, kThreads);
  if (steps > 0) load_step(0, 0);
  cp_async_commit();

  float dba[4][4] = {};             // dB_i: rows s, columns n; over every head
  float dca[kMaxTiles][4][4] = {};  // dC_j's part from tile i: rows t, columns n
  int n = 0;
  for (int h = 0; h < H; ++h) {
    // ---- the head's own data
    __syncthreads();  // the previous head is done with x_i, g, h_c, cum and the reductions
    const long long bhc = ((long long)b * H + h) * NC + c;
    load_tile(xs, kLd, x + b * sd.x[0] + h * sd.x[1] + c * sd.x[2] + s0 * sd.x[3], sd.x[3],
              kT, Q - s0, P, vec4, kThreads);
    load_tile(gs, kLd, gout + bhc * P * N, N, kT, P, N, vec4, kThreads);
    load_tile(hs, kLd, states + bhc * P * N, N, kT, P, N, vec4, kThreads);
    cp_async_commit();
    if (warp == 0)
      chunk_cumsum(ld + b * sd.ld[0] + h * sd.ld[1] + c * sd.ld[2], sd.ld[3], Q, nt * kT, cum);
    __syncthreads();
    if (threadIdx.x < kT) {
      const int r = threadIdx.x, sp = s0 + r;
      const bool in = sp < Q;
      const float d = in ? dt[b * sd.dt[0] + h * sd.dt[1] + c * sd.dt[2] + sp * sd.dt[3]] : 0.f;
      const float e = in ? expf(cum[Q - 1] - cum[sp]) : 0.f;
      dts[r] = d;
      ess[r] = e;
      esdt[r] = e * d;
      ets[r] = in ? expf(cum[sp]) : 0.f;
    }
    cp_async_wait<0>();
    __syncthreads();

    float dua[4][4] = {};   // du_i: rows s, columns p
    float mcol[4][2] = {};  // this thread's share of the M column sums
    for (int jj = 0; jj < nj; ++jj, ++n) {
      const int j = i + jj, t0 = j * kT;
      const int stage = n & 1;
      if (n + 1 < steps) load_step(n + 1, stage ^ 1);  // overlaps this step's products
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // this step's dy_j, C_j, G_ji are in
      float* dys = ring + stage * kStage;  // [t][p]
      float* cs = dys + kT * kLd;          // [t][n]
      float* gw = cs + kT * kLdT;          // [t][s]: G, then W

      if (jj == 0) {
        // ---- the state terms; here dy_j = dy_i and C_j = C_i
        // du_i += (es B_i) g^T, and T_s / dt_s = x_s . (es g B_s)
        float gb[4][4] = {};
        mma_block(gb, [&](int r, int k) { return ess[r0 + r] * bs[(r0 + r) * kLdT + k]; },
                  [&](int k, int nn) { return gs[(c0 + nn) * kLd + k]; });
        float tr[2] = {0.f, 0.f};
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int sl = r0 + g + 8 * (e >> 1), p = c0 + 8 * j4 + 2 * t4 + (e & 1);
            tr[e >> 1] = fmaf(xs[sl * kLd + p], gb[j4][e], tr[e >> 1]);
            dua[j4][e] += gb[j4][e];
          }
        row_partials(tr, red_t, r0, half);
        // dB_i += (es dt x_i) g
        mma_block(dba, [&](int r, int k) { return esdt[r0 + r] * xs[(r0 + r) * kLd + k]; },
                  [&](int k, int nn) { return gs[k * kLd + c0 + nn]; });
        // dC_i += (et dy_i) h_c
#pragma unroll
        for (int q = 0; q < kMaxTiles; ++q)
          if (q == i)
            mma_block(dca[q], [&](int r, int k) { return ets[r0 + r] * dys[(r0 + r) * kLd + k]; },
                      [&](int k, int nn) { return hs[k * kLd + c0 + nn]; });
        // R_t / et = dy_t . (h_c C_t)
        float ch[4][4] = {};
        mma_block(ch, [&](int r, int k) { return cs[(r0 + r) * kLdT + k]; },
                  [&](int k, int nn) { return hs[(c0 + nn) * kLd + k]; });
        float rr[2] = {0.f, 0.f};
#pragma unroll
        for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tl = r0 + g + 8 * (e >> 1), p = c0 + 8 * j4 + 2 * t4 + (e & 1);
            rr[e >> 1] = fmaf(dys[tl * kLd + p], ch[j4][e], rr[e >> 1]);
          }
        row_partials(rr, red_r, r0, half);
      }

      // ---- D_ji = dy_j u_i^T: rows t, columns s (dt_s applied below)
      float da[4][4] = {};
      mma_block(da, [&](int r, int k) { return dys[(r0 + r) * kLd + k]; },
                [&](int k, int nn) { return xs[(c0 + nn) * kLd + k]; });
      // W = G A over G, V = D A, M = W D; A = exp(cum_t - cum_s) for s <= t < Q.
      // The decay's argument is <= 0: the SFU's exp2 errs by ~2^-22 of it.
      float mr[2] = {0.f, 0.f};
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tl = r0 + g + 8 * (e >> 1), sl = c0 + 8 * j4 + 2 * t4 + (e & 1);
          const int tp = t0 + tl, sp = s0 + sl;
          const float d = da[j4][e] * dts[sl];
          const float a = sp <= tp && tp < Q ? ex2((cum[tp] - cum[sp]) * kLog2e) : 0.f;
          const float w = gw[tl * kLdT + sl] * a;
          const float m = w * d;
          gw[tl * kLdT + sl] = w;
          vs[tl * kLdT + sl] = d * a;
          mr[e >> 1] += m;
          mcol[j4][e & 1] += m;
        }
      row_partials(mr, red_m, r0, half);
      __syncthreads();  // W, V and the M row sums are in
      if (threadIdx.x < kT && t0 + (int)threadIdx.x < Q)
        mrow[(bhc * nt + i) * Q + t0 + threadIdx.x] = red_m[threadIdx.x] + red_m[kT + threadIdx.x];

      // du_i += W^T dy_j; dB_i += V^T C_j; dC_j += V B_i
      mma_block(dua, [&](int r, int k) { return gw[k * kLdT + r0 + r]; },
                [&](int k, int nn) { return dys[k * kLd + c0 + nn]; });
      mma_block(dba, [&](int r, int k) { return vs[k * kLdT + r0 + r]; },
                [&](int k, int nn) { return cs[k * kLdT + c0 + nn]; });
#pragma unroll
      for (int q = 0; q < kMaxTiles; ++q)
        if (q == j)
          mma_block(dca[q], [&](int r, int k) { return vs[(r0 + r) * kLdT + k]; },
                    [&](int k, int nn) { return bs[k * kLdT + c0 + nn]; });
      __syncthreads();  // this stage and V are free
    }

    // ---- the head's outputs: dx, d dt, and d cum's own parts of tile i
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = mcol[j4][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (g == 0) red_c[rt * kT + c0 + 8 * j4 + 2 * t4 + e] = v;
      }
    float dd[2] = {0.f, 0.f};
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = r0 + g + 8 * (e >> 1), p = c0 + 8 * j4 + 2 * t4 + (e & 1);
        dd[e >> 1] = fmaf(xs[sl * kLd + p], dua[j4][e], dd[e >> 1]);
        if (s0 + sl < Q && p < P) dx[(bhc * Q + s0 + sl) * P + p] = dts[sl] * dua[j4][e];
      }
    row_partials(dd, red_d, r0, half);
    __syncthreads();
    if (threadIdx.x < kT) {
      const int r = threadIdx.x, sp = s0 + r;
      const float t_s = dts[r] * (red_t[r] + red_t[kT + r]);
      const float r_t = ets[r] * (red_r[r] + red_r[kT + r]);
      const float m_s = ((red_c[r] + red_c[kT + r]) + red_c[2 * kT + r]) + red_c[3 * kT + r];
      tfin[r] = t_s;
      if (sp < Q) {
        ddt[bhc * Q + sp] = red_d[r] + red_d[kT + r];
        own[bhc * Q + sp] = r_t - t_s - m_s;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int r = 0; r < kT; ++r) sum += tfin[r];
      tpart[bhc * nt + i] = sum;
    }
  }
  cp_async_wait<0>();

  // ---- dB_i, summed over the heads; dC's parts from tile i
#pragma unroll
  for (int j4 = 0; j4 < 4; ++j4)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = r0 + g + 8 * (e >> 1), col = c0 + 8 * j4 + 2 * t4 + (e & 1);
      if (col >= N) continue;
      if (s0 + rl < Q) dbm[((long long)bc * Q + s0 + rl) * N + col] = dba[j4][e];
#pragma unroll
      for (int q = 0; q < kMaxTiles; ++q) {
        const int tp = q * kT + rl;
        if (q >= i && tp < Q) dcp[(((long long)bc * nt + i) * Q + tp) * N + col] = dca[q][j4][e];
      }
    }
}

// ---- 5. finish: d cum, d cum_end's state terms, d ld -------------------------
__global__ void __launch_bounds__(kThreads)
mamba_scan_bwd_kernel_finish(const float* __restrict__ gout, const float* __restrict__ states,
                             const float* __restrict__ cum_end, const float* __restrict__ own,
                             const float* __restrict__ mrow, const float* __restrict__ tpart,
                             float* __restrict__ dld, int Q, int PN, int nt) {
  __shared__ float red[kThreads];
  __shared__ float dcs[kMaxQ];
  const long long i = blockIdx.x;  // (b H + h) NC + c
  const float* gc = gout + i * PN;
  const float* hc = states + i * PN;
  float part = 0.f;
  for (int e = threadIdx.x; e < PN; e += kThreads) part = fmaf(gc[e], hc[e], part);
  red[threadIdx.x] = part;
  for (int t = threadIdx.x; t < Q; t += kThreads) {
    float v = own[i * Q + t];
    for (int q = 0; q <= t / kT; ++q) v += mrow[(i * nt + q) * Q + t];
    dcs[t] = v;
  }
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x >= 32) return;
  // d ld_t = extra + sum_{t' >= t} d cum_t': lane l sums steps 8 l .. 8 l + 7
  // from the last, then the lanes after it are added
  const int lane = threadIdx.x;
  float extra = 0.f;
  for (int q = 0; q < nt; ++q) extra += tpart[i * nt + q];
  extra = fmaf(expf(cum_end[i]), red[0], extra);
  float v[8];
  float run = 0.f;
#pragma unroll
  for (int u = 7; u >= 0; --u) {
    const int t = 8 * lane + u;
    run += t < Q ? dcs[t] : 0.f;
    v[u] = run;
  }
  float post = run;  // inclusive over lanes >= lane
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, post, off);
    if (lane + off < 32) post += nb;
  }
  post = __shfl_down_sync(0xffffffffu, post, 1);  // exclusive: the lanes after this one
  if (lane == 31) post = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int t = 8 * lane + u;
    if (t < Q) dld[i * Q + t] = extra + (v[u] + post);
  }
}

// ---- 6. dcsum: dCm = its parts from every s tile, in tile order -----------------
__global__ void __launch_bounds__(256)
mamba_scan_bwd_kernel_dcsum(const float* __restrict__ dcp, float* __restrict__ dcm, int Q,
                            int N, int nt, long long total) {
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // (b NC + c, t, n)
  if (o >= total) return;
  const int n = static_cast<int>(o % N);
  const long long rest = o / N;
  const int t = static_cast<int>(rest % Q);
  const long long bc = rest / Q;
  float s = 0.f;
  for (int q = 0; q <= t / kT; ++q) s += dcp[((bc * nt + q) * Q + t) * N + n];
  dcm[o] = s;
}

}  // namespace repro_torch_mamba_bwd

// strides: 22 element strides, (batch, head, chunk, step) of x, dt, ld; (batch,
// chunk, step) of Bm, Cm; (batch, head, chunk, step) of dy.  states, dh and
// every output and scratch buffer are contiguous: gram (B, NC, Qg, Qg) with
// Qg = Q rounded up to 64, gout (B, H, NC, P, N), cum_end (B, H, NC), own (B,
// H, NC, Q), mrow (B, H, NC, nt, Q) and tpart (B, H, NC, nt) with nt =
// ceil(Q / 64), dcp (B, NC, nt, Q, N).  Q <= 256, P, N <= 64.  vec4: every
// row of x, Bm, Cm and dy starts on a 16-byte boundary and P, N are multiples
// of 4.  Returns the CUDA error of the launches (0 on success); runs on
// `stream`.
extern "C" int repro_torch_mamba_scan_bwd(
    const float* x, const float* dt, const float* ld, const float* bm, const float* cm,
    const float* dy, const float* states, const float* dh, float* dx, float* ddt, float* dld,
    float* dbm, float* dcm, float* dh0, float* gram, float* gout, float* cum_end, float* own,
    float* mrow, float* tpart, float* dcp, int B, int H, int NC, int Q, int P, int N, int vec4,
    const long long* strides, void* stream) {
  namespace k = repro_torch_mamba_bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (Q < 1 || Q > repro_torch::kMaxQ || P > k::kT || N > k::kT)
    return (int)cudaErrorInvalidValue;
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
    cudaMemcpyAsync(dh0, dh, bh * PN * sizeof(float), cudaMemcpyDeviceToDevice, st);
    return (int)cudaGetLastError();
  }
  const long long chunks = bh * NC;
  const int nt = (Q + k::kT - 1) / k::kT;
  if (chunks > 0x7fffffffLL || (long long)B * NC * nt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int Qg = nt * k::kT;

  repro_torch::mamba_scan_kernel_gram<<<dim3(nt * (nt + 1) / 2, B * NC),
                                        repro_torch::kGemmThreads, 0, st>>>(
      bm, cm, gram, NC, Q, N, Qg, vec4, sd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int smem_d = (4 * k::kT * repro_torch::kLdT + 2 * repro_torch::kMaxQ) * (int)sizeof(float);
  err = cudaFuncSetAttribute(k::mamba_scan_bwd_kernel_dstate,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_d);
  if (err != cudaSuccess) return (int)err;
  k::mamba_scan_bwd_kernel_dstate<<<(unsigned)chunks, repro_torch::kGemmThreads, smem_d, st>>>(
      ld, cm, dy, gout, cum_end, H, NC, Q, P, N, vec4, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long total = bh * PN;
  k::mamba_scan_bwd_kernel_carry<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      gout, cum_end, dh, dh0, NC, (int)PN, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  constexpr int smem_m = k::main_smem_floats() * (int)sizeof(float);
  static_assert(smem_m <= 232448, "a block may have 227 KB of shared memory");
  err = cudaFuncSetAttribute(k::mamba_scan_bwd_kernel_main,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_m);
  if (err != cudaSuccess) return (int)err;
  k::mamba_scan_bwd_kernel_main<<<(unsigned)(B * NC * nt), k::kThreads, smem_m, st>>>(
      x, dt, ld, bm, cm, dy, gram, gout, states, dx, ddt, dbm, dcp, own, mrow, tpart, H, NC, Q,
      P, N, Qg, vec4, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  k::mamba_scan_bwd_kernel_finish<<<(unsigned)chunks, k::kThreads, 0, st>>>(
      gout, states, cum_end, own, mrow, tpart, dld, Q, (int)PN, nt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long outs = (long long)B * NC * Q * N;
  k::mamba_scan_bwd_kernel_dcsum<<<(unsigned)((outs + 255) / 256), 256, 0, st>>>(
      dcp, dcm, Q, N, nt, outs);
  return (int)cudaGetLastError();
}
