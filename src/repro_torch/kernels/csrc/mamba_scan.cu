// Mamba2 SSD chunked scan for Hopper.
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
// What bounds it on this card: operations.  Per (batch, head) and chunk of
// Q = 256 steps with P = N = 64 the scan does ~6 M multiply-adds (the two
// triangular Q x Q products, the C h^T read-out and the state update) on
// 100 KB of input, far above the byte line at the f32 rate.  Its design: one
// block per (batch, head) walks the chunks in order and keeps the P x N
// state in shared memory across them, as the Pallas body keeps it in VMEM
// scratch.  The Pallas body holds the whole Q x Q score and gate matrices
// (256 KB in f32 at Q = 256, over the 227 KB a block may use); here t and s
// are tiled 64 x 64, tiles above the diagonal are never visited, and the
// decay exp(cum_t - cum_s) is taken only where s <= t (where it is <= 0,
// since ld < 0) instead of over the whole matrix.  Each thread keeps a 4 x 4
// tile of the output (or of the new state) in registers; the products run on
// the CUDA cores in f32 with explicit fmaf.  Tensor-core products are later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kT = 64;           // rows of an output tile (t) and of an s tile
constexpr int kLd = kT + 1;      // padded row length of the staged tiles
constexpr int kScanThreads = 256;
constexpr int kMaxQ = kScanThreads;  // one thread per step for the cumsum
constexpr int kMaxPN = kT;           // P and N each fit one tile

__device__ __forceinline__ float block_inclusive_scan(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kScanThreads / 32 ? warp_tot[lane] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += n;
    }
    if (lane < kScanThreads / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  return warp > 0 ? v + warp_tot[warp - 1] : v;
}

// Element strides: (batch, head, chunk, step) of x, dt, ld and y;
// (batch, chunk, step) of Bm and Cm.
struct ScanStrides {
  long long x[4], dt[4], ld[4], bm[3], cm[3], y[4];
};

__global__ void __launch_bounds__(kScanThreads)
mamba_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ ld, const float* __restrict__ bm,
                  const float* __restrict__ cm, const float* __restrict__ h0,
                  float* __restrict__ y, float* __restrict__ h_out, int H,
                  int NC, int Q, int P, int N, ScanStrides sd) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;              // [P][kLd]   state h[p][n]
  float* cs = hs + kT * kLd;     // [kT][kLd]  C rows of the t tile
  float* bs = cs + kT * kLd;     // [kT][kLd]  B rows of the s tile
  float* xs = bs + kT * kLd;     // [kT][kLd]  x rows of the s tile
  float* ws = xs + kT * kLd;     // [kT][kLd]  W[t][s] of the tile pair
  float* cum = ws + kT * kLd;    // [kMaxQ]
  float* dts = cum + kMaxQ;      // [kMaxQ]
  float* warp_tot = dts + kMaxQ; // [kScanThreads / 32]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.x / H, hh = blockIdx.x % H;
  const size_t bh = (size_t)b * H + hh;  // into h0 and h_out
  const float* xbh = x + b * sd.x[0] + hh * sd.x[1];
  const float* dtbh = dt + b * sd.dt[0] + hh * sd.dt[1];
  const float* ldbh = ld + b * sd.ld[0] + hh * sd.ld[1];
  float* ybh = y + b * sd.y[0] + hh * sd.y[1];

  for (int e = tid; e < P * N; e += kScanThreads)
    hs[(e / N) * kLd + e % N] = h0[bh * P * N + e];

  const int n_tiles = (Q + kT - 1) / kT;
  for (int c = 0; c < NC; ++c) {
    // this chunk's rows: step t of x at xc[t * sd.x[3]], and so on
    const float* xc = xbh + c * sd.x[2];
    const float* bc = bm + b * sd.bm[0] + c * sd.bm[1];
    const float* cc = cm + b * sd.cm[0] + c * sd.cm[1];
    float* yc = ybh + c * sd.y[2];

    __syncthreads();  // the previous chunk is done with cum, dts and the tiles
    const float ldv = tid < Q ? ldbh[c * sd.ld[2] + tid * sd.ld[3]] : 0.f;
    if (tid < Q) dts[tid] = dtbh[c * sd.dt[2] + tid * sd.dt[3]];
    const float cv = block_inclusive_scan(ldv, warp_tot);
    if (tid < Q) cum[tid] = cv;
    __syncthreads();

    for (int tt = 0; tt < n_tiles; ++tt) {
      const int t0 = tt * kT, tn = min(kT, Q - t0);
      __syncthreads();  // the previous t tile's C rows are no longer read
      for (int e = tid; e < kT * N; e += kScanThreads) {
        const int r = e / N, n = e % N;
        cs[r * kLd + n] = r < tn ? cc[(t0 + r) * sd.cm[2] + n] : 0.f;
      }
      __syncthreads();

      // inter-chunk read-out with the state entering the chunk:
      // acc[t = ty + 16 i][p = tx + 16 j] = exp(cum_t) * sum_n C[t][n] h[p][n]
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv4[4], hv4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv4[i] = cs[(ty + 16 * i) * kLd + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) hv4[j] = (tx + 16 * j) < P ? hs[(tx + 16 * j) * kLd + n] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(cv4[i], hv4[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        const float g = t < tn ? expf(cum[t0 + t]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= g;
      }

      // intra-chunk term over the s tiles at or below the diagonal
      for (int st = 0; st <= tt; ++st) {
        const int s0 = st * kT, sn = min(kT, Q - s0);
        __syncthreads();  // the previous s tile's B, x and W are no longer read
        for (int e = tid; e < kT * N; e += kScanThreads) {
          const int r = e / N, n = e % N;
          bs[r * kLd + n] = r < sn ? bc[(s0 + r) * sd.bm[2] + n] : 0.f;
        }
        for (int e = tid; e < kT * P; e += kScanThreads) {
          const int r = e / P, p = e % P;
          xs[r * kLd + p] = r < sn ? xc[(s0 + r) * sd.x[3] + p] : 0.f;
        }
        __syncthreads();
        // W[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t, else 0
        float w[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) w[i][j] = 0.f;
        for (int n = 0; n < N; ++n) {
          float cv4[4], bv4[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv4[i] = cs[(ty + 16 * i) * kLd + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv4[j] = bs[(tx + 16 * j) * kLd + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) w[i][j] = fmaf(cv4[i], bv4[j], w[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            const bool live = s <= t && t < t0 + tn && s < s0 + sn;
            ws[(ty + 16 * i) * kLd + tx + 16 * j] =
                live ? w[i][j] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
          }
        }
        __syncthreads();
        // acc[t][p] += sum_s W[t][s] x[s][p]
        for (int s = 0; s < sn; ++s) {
          float wv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) wv[i] = ws[(ty + 16 * i) * kLd + s];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = xs[s * kLd + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (t >= tn) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) yc[(t0 + t) * sd.y[3] + p] = acc[i][j];
        }
      }
    }

    // state update, after every read of the entering state:
    // h[p = ty + 16 i][n = tx + 16 j] = h exp(cum_end) + sum_s x[s][p] B[s][n] tail_s
    const float cum_end = cum[Q - 1];
    const float decay = expf(cum_end);
    float hn[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = ty + 16 * i, n = tx + 16 * j;
        hn[i][j] = (p < P && n < N) ? hs[p * kLd + n] * decay : 0.f;
      }
    for (int st = 0; st < n_tiles; ++st) {
      const int s0 = st * kT, sn = min(kT, Q - s0);
      __syncthreads();
      for (int e = tid; e < kT * N; e += kScanThreads) {
        const int r = e / N, n = e % N;
        bs[r * kLd + n] = r < sn ? bc[(s0 + r) * sd.bm[2] + n] *
                                       (expf(cum_end - cum[s0 + r]) * dts[s0 + r])
                                 : 0.f;
      }
      for (int e = tid; e < kT * P; e += kScanThreads) {
        const int r = e / P, p = e % P;
        xs[r * kLd + p] = r < sn ? xc[(s0 + r) * sd.x[3] + p] : 0.f;
      }
      __syncthreads();
      for (int s = 0; s < sn; ++s) {
        float xv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[s * kLd + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bs[s * kLd + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) hn[i][j] = fmaf(xv[i], bv[j], hn[i][j]);
      }
    }
    __syncthreads();  // every thread has read the entering state
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = ty + 16 * i, n = tx + 16 * j;
        if (p < P && n < N) hs[p * kLd + n] = hn[i][j];
      }
  }

  __syncthreads();
  for (int e = tid; e < P * N; e += kScanThreads)
    h_out[bh * P * N + e] = hs[(e / N) * kLd + e % N];
}

}  // namespace repro_torch

// Q <= 256 and P, N <= 64 (kernels/mamba_scan.py checks them first).
// strides: the 22 element strides of ScanStrides, in its order.  Returns the
// CUDA error of the launch (0 on success); runs on `stream`.
extern "C" int repro_torch_mamba_scan(const float* x, const float* dt,
                                      const float* ld, const float* bm,
                                      const float* cm, const float* h0,
                                      float* y, float* h_out, int B, int H,
                                      int NC, int Q, int P, int N,
                                      const long long* strides, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  if (Q < 1 || Q > kMaxQ || P > kMaxPN || N > kMaxPN) return (int)cudaErrorInvalidValue;
  ScanStrides sd;
  long long* dst[] = {sd.x, sd.dt, sd.ld, sd.bm, sd.cm, sd.y};
  const int len[] = {4, 4, 4, 3, 3, 4};
  for (int a = 0, i = 0; a < 6; ++a)
    for (int j = 0; j < len[a]; ++j) dst[a][j] = strides[i++];
  const int smem = (5 * kT * kLd + 2 * kMaxQ + kScanThreads / 32) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mamba_scan_kernel<<<B * H, kScanThreads, smem, st>>>(x, dt, ld, bm, cm, h0, y,
                                                       h_out, H, NC, Q, P, N, sd);
  return (int)cudaGetLastError();
}
