// Mamba2 SSD chunked scan for Hopper, as chunk-parallel passes.
//
// Replaces the TPU kernel `mamba_chunk_scan_kernel` (`_ssd_body`) of the JAX
// package's kernels/mamba_scan.py.  Inputs, all f32: x (B, H, NC, Q, P),
// dt and ld (B, H, NC, Q), Bm and Cm (B, NC, Q, N), h0 (B, H, P, N); outputs
// y (B, H, NC, Q, P) and the final state (B, H, P, N).  h0 and the final
// state are contiguous; the others are read and written through their
// strides (the last dim of x, Bm, Cm and y contiguous), so the model's
// step-major (B, S, H, P) tensors and slices of its (B, S, .) projection
// need no head-major copies.  Per chunk, with cum the within-chunk
// cumulative sum of ld:
//   y_t = sum_{s<=t} exp(cum_t - cum_s) (C_t . B_s) dt_s x_s + exp(cum_t) C_t h^T
// where h is the state entering the chunk, and only then
//   h <- h exp(cum_end) + sum_s x_s (x) B_s exp(cum_end - cum_s) dt_s.
//
// What bounds it on this card: at the hybrid model's prefill (B 4, 64 heads,
// 32 chunks of 256, P = N = 64) the scan does ~69 GFLOP on ~1.1 GB of inputs
// and outputs (x and y, 0.54 GB each), so with its products on the tensor
// cores (TF32, 495 TFLOP/s) it is bound by bytes; on the CUDA cores (67
// TFLOP/s f32) it would be bound by operations.
//
// The TPU body walks the chunks of one (batch, head) in order on its
// sequential grid, with the state in VMEM.  Here the chunks are independent
// work for 132 SMs, in four launches on one stream (the wrapper counts one
// call):
//   1. gram:   G = C B^T, every lower-triangular 64 x 64 tile once per
//              (batch, chunk), into scratch (33.5 MB at the prefill shape,
//              read back from L2 by all 64 heads);
//   2. states: per (batch, chunk, head) the chunk's own contribution
//              S_c = sum_s x_s (x) B_s exp(cum_end - cum_s) dt_s, and cum_end;
//   3. carry:  per (batch, head) and state element, in chunk order,
//              h_c = h_{c-1} exp(cum_end, c-1) + S_{c-1} from h0, written over
//              S in place (the state entering each chunk), and the final state;
//   4. output: per (batch, chunk, head), y = (G o exp(cum_t - cum_s)[s <= t]
//              dt_s) x + exp(cum_t) C h_c^T.
// Every product runs on the tensor cores as 3xTF32 (`mma.sync.m16n8k8`):
// each f32 operand a is split into a_hi (its top 10 mantissa bits) and a_lo
// (the top 10 bits of what is left), and a b ~= a_hi b_hi + a_hi b_lo +
// a_lo b_hi with f32 sums, within ~2^-19 of the f32 product; one TF32
// product (~2^-11) would not meet the 1e-4 the scan is held to.  Tiles are
// staged in shared memory by cp.async (16 bytes a thread where rows are
// 16-byte aligned, else 4), in rows padded so fragment reads never share a
// bank; the decay exp(cum_t - cum_s) is taken only where s <= t.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mamba_common.cuh"

namespace repro_torch {

constexpr int kOutThreads = 256;  // output: 8 warps, two m16 row tiles each

// Element strides: (batch, head, chunk, step) of x, dt, ld and y;
// (batch, chunk, step) of Bm and Cm.
struct ScanStrides {
  long long x[4], dt[4], ld[4], bm[3], cm[3], y[4];
};

// ---- 2. states: S_c = x~^T Bm, x~_s = x_s exp(cum_end - cum_s) dt_s --------
// grid (B NC H): block (b, c, h), warp w owns state rows p = 16 w..16 w + 15;
// the chunk's steps go through a two-stage ring of 64-step tiles.
__global__ void __launch_bounds__(kGemmThreads)
mamba_scan_kernel_states(const float* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ ld, const float* __restrict__ bm,
                         float* __restrict__ states, float* __restrict__ cum_end,
                         int H, int NC, int Q, int P, int N, int vec4, ScanStrides sd) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                       // [2][kTile][kLdT]
  float* bs = xs + 2 * kTile * kLdT;      // [2][kTile][kLdT]
  float* cum = bs + 2 * kTile * kLdT;     // [kMaxQ]
  float* tail = cum + kMaxQ;              // [kMaxQ]

  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int b = bc / NC, c = bc % NC;
  const float* xc = x + b * sd.x[0] + h * sd.x[1] + c * sd.x[2];
  const float* bc_ = bm + b * sd.bm[0] + c * sd.bm[1];
  const int n_tiles = (Q + kTile - 1) / kTile;
  auto load_stage = [&](int st, int stage) {
    const int s0 = st * kTile;
    load_tile(xs + stage * kTile * kLdT, kLdT, xc + s0 * sd.x[3], sd.x[3], kTile, Q - s0,
              P, vec4, kGemmThreads);
    load_tile(bs + stage * kTile * kLdT, kLdT, bc_ + s0 * sd.bm[2], sd.bm[2], kTile, Q - s0,
              N, vec4, kGemmThreads);
  };
  load_stage(0, 0);
  cp_async_commit();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0)
    chunk_cumsum(ld + b * sd.ld[0] + h * sd.ld[1] + c * sd.ld[2], sd.ld[3], Q,
                 n_tiles * kTile, cum);
  __syncthreads();
  const float ce = cum[Q - 1];
  const float* dtc = dt + b * sd.dt[0] + h * sd.dt[1] + c * sd.dt[2];
  for (int s = threadIdx.x; s < n_tiles * kTile; s += kGemmThreads)
    tail[s] = s < Q ? expf(ce - cum[s]) * dtc[s * sd.dt[3]] : 0.f;
  if (threadIdx.x == 0) cum_end[blockIdx.x] = ce;  // (b, c, h) order: see carry

  const int g = lane >> 2, t = lane & 3;
  const int p0 = 16 * warp;
  float acc[8][4] = {};
  for (int st = 0; st < n_tiles; ++st) {
    if (st + 1 < n_tiles) load_stage(st + 1, (st + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // this stage's tiles, and tail, are in
    if (p0 < P) {
      const float* xt = xs + (st & 1) * kTile * kLdT;
      const float* bt = bs + (st & 1) * kTile * kLdT;
      const float* tl = tail + st * kTile;
#pragma unroll 2
      for (int kk = 0; kk < kTile / 8; ++kk) {
        // A[p][s] = x~[s][p]: rows p0 + g (+8), columns s = 8 kk + t (+4)
        const int s = 8 * kk + t;
        const float w0 = tl[s], w1 = tl[s + 4];
        uint32_t ah[4], al[4];
        split_tf32(xt[s * kLdT + p0 + g] * w0, ah[0], al[0]);
        split_tf32(xt[s * kLdT + p0 + g + 8] * w0, ah[1], al[1]);
        split_tf32(xt[(s + 4) * kLdT + p0 + g] * w1, ah[2], al[2]);
        split_tf32(xt[(s + 4) * kLdT + p0 + g + 8] * w1, ah[3], al[3]);
        BSplit<8> bf;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          split_tf32(bt[s * kLdT + 8 * j + g], bf.v[j][0], bf.v[j][2]);
          split_tf32(bt[(s + 4) * kLdT + 8 * j + g], bf.v[j][1], bf.v[j][3]);
        }
        mma_3xtf32_row(acc, ah, al, bf);
      }
    }
    __syncthreads();  // this stage is free for the load the next step issues
  }
  cp_async_wait<0>();
  if (p0 >= P) return;
  // states (B, H, NC, P, N), contiguous
  float* sc = states + (((long long)b * H + h) * NC + c) * P * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + 8 * (e >> 1), n = 8 * j + 2 * t + (e & 1);
      if (p < P && n < N) sc[p * N + n] = acc[j][e];
    }
}

// ---- 3. carry: the state entering each chunk, in chunk order ---------------
// One thread per (b, h, state element); states[b, h, c] is S_c on entry and
// the state entering chunk c on exit.  Eight chunks' S and cum_end are loaded
// before any is written back, so the loads overlap.
__global__ void __launch_bounds__(256)
mamba_scan_kernel_carry(float* __restrict__ states, const float* __restrict__ cum_end,
                        const float* __restrict__ h0, float* __restrict__ h_out, int H,
                        int NC, int PN, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long bh = i / PN;
  const int e = static_cast<int>(i % PN);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  float hv = h0[i];
  float* sp = states + bh * NC * PN + e;
  const float* ce = cum_end + (long long)b * NC * H + h;  // chunk c at ce[c * H]
  for (int c0 = 0; c0 < NC; c0 += 8) {
    float s[8], d[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const bool in = c0 + u < NC;
      s[u] = in ? sp[(long long)(c0 + u) * PN] : 0.f;
      d[u] = in ? ce[(long long)(c0 + u) * H] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < NC) {
        sp[(long long)(c0 + u) * PN] = hv;
        hv = hv * expf(d[u]) + s[u];
      }
  }
  h_out[i] = hv;
}

// ---- 4. output --------------------------------------------------------------
// grid (B NC H): block (b, c, h); warp w owns m16 row tiles w and 15 - w (a
// balanced share of the triangle) and works on both at once, so every x
// fragment it splits serves two products.  x, C and the entering state are
// staged whole; G comes from the gram pass's scratch (L2), two steps ahead.
__global__ void __launch_bounds__(kOutThreads)
mamba_scan_kernel_output(const float* __restrict__ x, const float* __restrict__ dt,
                         const float* __restrict__ ld, const float* __restrict__ cm,
                         const float* __restrict__ gram, const float* __restrict__ states,
                         float* __restrict__ y, int H, int NC, int Q, int P, int N, int Qg,
                         int vec4, ScanStrides sd) {
  extern __shared__ __align__(16) float smem[];
  const int q16 = (Q + 15) / 16 * 16;
  float* xs = smem;                // [q16][kLd]  x[s][p]
  float* cs = xs + q16 * kLd;      // [q16][kLd]  C[t][n]
  float* hs = cs + q16 * kLd;      // [kMaxPN][kLd]  h[p][n], entering the chunk
  float* cum = hs + kMaxPN * kLd;  // [q16]
  float* dts = cum + q16;          // [q16]

  const int h = blockIdx.x % H, bc = blockIdx.x / H;
  const int b = bc / NC, c = bc % NC;
  const float* xc = x + b * sd.x[0] + h * sd.x[1] + c * sd.x[2];
  load_tile(xs, kLd, xc, sd.x[3], q16, Q, P, vec4, kOutThreads);
  load_tile(cs, kLd, cm + b * sd.cm[0] + c * sd.cm[1], sd.cm[2], q16, Q, N, vec4,
            kOutThreads);
  load_tile(hs, kLd, states + (((long long)b * H + h) * NC + c) * P * N, N, kMaxPN, P, N,
            vec4 && N % 4 == 0, kOutThreads);
  cp_async_commit();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp == 0)
    chunk_cumsum(ld + b * sd.ld[0] + h * sd.ld[1] + c * sd.ld[2], sd.ld[3], Q, q16, cum);
  const float* dtc = dt + b * sd.dt[0] + h * sd.dt[1] + c * sd.dt[2];
  for (int s = threadIdx.x; s < q16; s += kOutThreads)
    dts[s] = s < Q ? dtc[s * sd.dt[3]] : 0.f;
  cp_async_wait<0>();
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const int mts = q16 / 16;
  // this warp's row tiles: m = 0 the smaller (rows 16 w..), m = 1 the larger
  // (rows 16 (15 - w)..); a tile past the chunk's rows is idle
  const int r0[2] = {16 * warp, 16 * (15 - warp)};
  const bool live[2] = {warp < mts, 15 - warp < mts};
  if (!live[0]) return;
  const int s_end[2] = {r0[0] + 16, live[1] ? r0[1] + 16 : 0};  // steps s < s_end

  float acc[2][8][4] = {};
  // inter-chunk read-out: acc[m][t][p] = sum_n C[t][n] h[p][n]
#pragma unroll 2
  for (int kk = 0; kk < kMaxPN / 8; ++kk) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* a = cs + (min(r0[m], q16 - 16) + g) * kLd + 8 * kk + t;
      split_tf32(a[0], ah[m][0], al[m][0]);
      split_tf32(a[8 * kLd], ah[m][1], al[m][1]);
      split_tf32(a[4], ah[m][2], al[m][2]);
      split_tf32(a[8 * kLd + 4], ah[m][3], al[m][3]);
    }
    BSplit<8> bf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* bp = hs + (8 * j + g) * kLd + 8 * kk + t;
      split_tf32(bp[0], bf.v[j][0], bf.v[j][2]);
      split_tf32(bp[4], bf.v[j][1], bf.v[j][3]);
    }
    mma_3xtf32_row(acc[0], ah[0], al[0], bf);
    if (live[1]) mma_3xtf32_row(acc[1], ah[1], al[1], bf);
  }
  float cr[2][2];  // cum of this lane's rows: [m][row g or g + 8]
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = min(r0[m], q16 - 16) + g + 8 * hr;
      cr[m][hr] = cum[r];
      const float e = expf(cr[m][hr]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[m][j][2 * hr] *= e;
        acc[m][j][2 * hr + 1] *= e;
      }
    }

  // intra-chunk term over steps s < s_end[m], 8 at a time.  The A operand
  // W[t][s] is built in the accumulator's layout (columns 2t, 2t + 1), so
  // its k index is permuted: logical k = t is step s0 + 2t, k = t + 4 is
  // s0 + 2t + 1, and x's B fragment takes the same rows.  G's values for a
  // step are loaded two steps ahead.
  const float* gbc = gram + (long long)bc * Qg * Qg + 2 * t;
  const float* grow[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      grow[m][hr] = gbc + (long long)(min(r0[m], q16 - 16) + g + 8 * hr) * Qg;
  const int steps = max(s_end[0], s_end[1]);
  float2 gq[2][2][2];  // [in flight: s0, s0 + 8][m][row half]
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        gq[u][m][hr] = 8 * u < s_end[m]
                           ? *reinterpret_cast<const float2*>(grow[m][hr] + 8 * u)
                           : make_float2(0.f, 0.f);
#pragma unroll 2
  for (int s0 = 0; s0 < steps; s0 += 8) {
    float2 gv[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        gv[m][hr] = gq[0][m][hr];
        gq[0][m][hr] = gq[1][m][hr];
        gq[1][m][hr] = s0 + 16 < s_end[m]
                           ? *reinterpret_cast<const float2*>(grow[m][hr] + s0 + 16)
                           : make_float2(0.f, 0.f);
      }
    const int sa = s0 + 2 * t, sb = sa + 1;
    const float da = dts[sa], db = dts[sb], ca = cum[sa], cb = cum[sb];
    uint32_t ah[2][4], al[2][4];
    bool on[2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      on[m] = s0 < s_end[m];
      const int ra = r0[m] + g, rb = ra + 8;
      // W[row][s] = G exp(cum_row - cum_s) dt_s for s <= row, else 0.  The
      // decay's argument is <= 0; exp by the SFU's exp2 errs by ~2^-22 of the
      // weight plus |arg| 2^-24 of it, and |arg| e^arg <= 1 / e.
      const float w00 = on[m] && sa <= ra ? gv[m][0].x * ex2((cr[m][0] - ca) * kLog2e) * da : 0.f;
      const float w01 = on[m] && sb <= ra ? gv[m][0].y * ex2((cr[m][0] - cb) * kLog2e) * db : 0.f;
      const float w10 = on[m] && sa <= rb ? gv[m][1].x * ex2((cr[m][1] - ca) * kLog2e) * da : 0.f;
      const float w11 = on[m] && sb <= rb ? gv[m][1].y * ex2((cr[m][1] - cb) * kLog2e) * db : 0.f;
      split_tf32(w00, ah[m][0], al[m][0]);
      split_tf32(w10, ah[m][1], al[m][1]);
      split_tf32(w01, ah[m][2], al[m][2]);
      split_tf32(w11, ah[m][3], al[m][3]);
    }
    BSplit<8> bf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split_tf32(xs[sa * kLd + 8 * j + g], bf.v[j][0], bf.v[j][2]);
      split_tf32(xs[sb * kLd + 8 * j + g], bf.v[j][1], bf.v[j][3]);
    }
    if (on[0]) mma_3xtf32_row(acc[0], ah[0], al[0], bf);
    if (on[1]) mma_3xtf32_row(acc[1], ah[1], al[1], bf);
  }
  float* yc = y + b * sd.y[0] + h * sd.y[1] + c * sd.y[2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    if (!live[m]) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0[m] + g + 8 * (e >> 1), p = 8 * j + 2 * t + (e & 1);
        if (r < Q && p < P) yc[r * sd.y[3] + p] = acc[m][j][e];
      }
  }
}

}  // namespace repro_torch

// Q <= 256 and P, N <= 64 (kernels/mamba_scan.py checks them first).
// strides: the 22 element strides of ScanStrides, in its order.  vec4: every
// row of x, Bm and Cm starts on a 16-byte boundary and P, N are multiples of
// 4 (cp.async then moves 16 bytes a thread).  Scratch, f32: gram (B, NC, Qg,
// Qg) with Qg = Q rounded up to 64, states (B, H, NC, P, N), cum_end (B, NC,
// H).  Launches the four passes on `stream`; returns the first CUDA error (0
// on success).
extern "C" int repro_torch_mamba_scan(const float* x, const float* dt,
                                      const float* ld, const float* bm,
                                      const float* cm, const float* h0,
                                      float* y, float* h_out, float* gram,
                                      float* states, float* cum_end, int B, int H,
                                      int NC, int Q, int P, int N, int vec4,
                                      const long long* strides, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || NC == 0) return 0;
  if (Q < 1 || Q > kMaxQ || P < 1 || N < 1 || P > kMaxPN || N > kMaxPN)
    return (int)cudaErrorInvalidValue;
  ScanStrides sd;
  long long* dst[] = {sd.x, sd.dt, sd.ld, sd.bm, sd.cm, sd.y};
  const int len[] = {4, 4, 4, 3, 3, 4};
  for (int a = 0, i = 0; a < 6; ++a)
    for (int j = 0; j < len[a]; ++j) dst[a][j] = strides[i++];
  const int qt = (Q + kTile - 1) / kTile;
  const int Qg = qt * kTile;
  const int q16 = (Q + 15) / 16 * 16;

  mamba_scan_kernel_gram<<<dim3(qt * (qt + 1) / 2, B * NC), kGemmThreads, 0, st>>>(
      bm, cm, gram, NC, Q, N, Qg, vec4, sd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int states_smem = (4 * kTile * kLdT + 2 * kMaxQ) * (int)sizeof(float);
  err = cudaFuncSetAttribute(mamba_scan_kernel_states,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, states_smem);
  if (err != cudaSuccess) return (int)err;
  mamba_scan_kernel_states<<<B * NC * H, kGemmThreads, states_smem, st>>>(
      x, dt, ld, bm, states, cum_end, H, NC, Q, P, N, vec4, sd);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long total = (long long)B * H * P * N;
  mamba_scan_kernel_carry<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      states, cum_end, h0, h_out, H, NC, P * N, total);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const int out_smem = ((2 * q16 + kMaxPN) * kLd + 2 * q16) * (int)sizeof(float);
  err = cudaFuncSetAttribute(mamba_scan_kernel_output,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem);
  if (err != cudaSuccess) return (int)err;
  mamba_scan_kernel_output<<<B * NC * H, kOutThreads, out_smem, st>>>(
      x, dt, ld, cm, gram, states, y, H, NC, Q, P, N, Qg, vec4, sd);
  return (int)cudaGetLastError();
}
