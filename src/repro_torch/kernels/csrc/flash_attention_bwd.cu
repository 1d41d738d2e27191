// Backward of the online-softmax attention (B4-bwd) for Hopper.
//
// No TPU kernel corresponds to it: the JAX package differentiates its
// pure-JAX `chunked_attention` (models/attention.py) with autodiff.  This is
// the gradient of csrc/flash_attention.cu's function (causal / full / sliding
// window, GQA by index, value heads hd_v narrower than q/k's hd allowed) for
// the port's `FlashAttentionFn` (kernels/flash_attention.py), the same
// gradient autograd takes through its plain version.  Inputs: q, k, v, the
// forward's output o and its gradient dout, f32 or bf16, each in any layout
// whose rows are contiguous (batch, head and row strides are arguments), and
// the row log-sum-exp L that B4's forward wrote ((B, H, Sq) f32, base e).
// Outputs dq, dk, dv in the input dtype; every sum is f32.
//
// With P = exp(scale q k^T - L) over the visible keys (0 elsewhere, so a row
// with no visible key has P = 0) and D = rowsum(dout o o):
//   dv_j = sum_i P_ij dout_i,  dS_ij = P_ij (dout_i . v_j - D_i),
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i.
// Three launches on one stream:
//   1. D:     one warp a row, D = rowsum(dout o o) into scratch (B, H, Sq) f32;
//   2. dk/dv: one block per (key tile, KV head, batch) walks the query heads of
//      its group in head order and, for each, the query tiles that can see
//      its keys, accumulating dk and dv in registers: the GQA sum over the
//      group's heads is taken in one block, in head order;
//   3. dq:    one block per (query tile, head, batch) walks the visible key
//      tiles once, accumulating dq in registers.
// No atomics anywhere: every output element is written by one thread once,
// so a step is deterministic.
//
// What bounds it on this card: operations.  Per visible (query, key) pair the
// function needs five products (S again, dP = dout v^T, P^T dout, dS^T q,
// dS k); launch 2 does four and launch 3 three (S, dP, dS k), since dq is
// taken by its own launch rather than by atomics.  Two variants, chosen by
// the caller (`variant`, fixed by dtype and widths in
// kernels/flash_attention.py:flash_bwd_variant):
//
// * tensor cores (bf16 at (hd, hd_v) = (64, 64), (128, 128) and (192, 128)):
//   every product is `wgmma.mma_async` m64n64k16 (csrc/flash_common.cuh),
//   bf16 operands and f32 sums, in B4's two shapes: wgmma_s for S^T = K Q^T and dP^T =
//   V dout^T (launch 2) and S = Q K^T and dP = dout V^T (launch 3), all
//   operands K-major in shared memory; wgmma_o for dV += P^T dout, dK +=
//   dS^T Q (launch 2) and dQ += dS K (launch 3), the A operand from
//   registers: the accumulator of a 64 x 64 product already holds the A
//   fragment of its 16-column slices, so P^T and dS^T (P and dS) go from
//   one product to the next without shared memory.  P and dS are rounded to
//   bf16 as operands (relative error 2^-9 each, a random sign over the sum:
//   far inside the 2^-7 of the largest gradient the gradients are held to;
//   tests/test_torch_bwd_tc.py emulates both the rounded and the unrounded
//   sums).  A block is NWG warpgroups sharing the streamed tiles: one at
//   (64, 64) and (128, 128), two at (192, 128), by what an H100 measured
//   (tools/torch_kernel_probe.py flash-bwd-variants): at zamba2-1.2b's and
//   qwen2-7b's training shapes one ran 7.04-7.05 and 2.24-2.25 ms against
//   7.71-7.80 and 2.55-2.58 at two; at (192, 128), bf16 2 x 16 x 4096,
//   two ran 2.10-2.12 against 3.06-3.08 at one.  ptxas gives
//   launch 2 201 registers at (64, 64), 255 with 8 bytes spilled at (128,
//   128) and 255 without spills at (192, 128), launch 3 140, 173 and 210.
//   In launch 2 a warpgroup owns 64 keys, K and V stay resident in
//   the 128-byte swizzle, and the query and dout tiles (with their L and D)
//   come through a two-stage cp.async ring, so the next tile's load overlaps
//   this tile's products; launch 3 holds its 64 queries a warpgroup resident
//   and streams K and V the same way.  Masks are applied only on the tiles
//   the band's edge crosses; tiles outside the band are never visited.  The
//   heaviest tiles are launched first (the first key tiles of launch 2, the
//   last query tiles of launch 3, under a causal mask).
// * CUDA cores (f32, and bf16 at the narrow pairs):
//   thread (ty, tx) of 16 x 16 keeps a 4 x 4 tile of scores and a 4 x
//   width/16 tile of its accumulators in registers; tiles are staged in
//   shared memory as f32 in rows padded to width + 1 floats, so column reads
//   of 16 consecutive rows hit 16 banks; products are f32 FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace repro_torch_bwd {

constexpr int kB = 64;         // query or key rows per tile
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Element strides (batch, head, row) of q, k, v, o, dout, dq, dk, dv.
struct BwdStrides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

// The forward's mask: key kp is seen by query qp.
__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk, int causal,
                                        int window) {
  return kp < Sk && qp < Sq && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

// The key tiles a query tile [q0, q0 + rows) can see: [*kt_begin, *kt_end).
__device__ __forceinline__ void key_tiles(int q0, int rows, int Sq, int Sk, int causal,
                                          int window, int* kt_begin, int* kt_end) {
  const int q_last = min(q0 + rows, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  *kt_begin = k_lo / kB;
  *kt_end = q0 < Sq && k_hi > k_lo ? (k_hi - 1) / kB + 1 : *kt_begin;
}

// The query tiles that can see a key tile [k0, k0 + rows): [*qt_begin, *qt_end).
__device__ __forceinline__ void query_tiles(int k0, int rows, int Sq, int Sk, int causal,
                                            int window, int* qt_begin, int* qt_end) {
  const int k_last = min(k0 + rows, Sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window >= 0 ? min(Sq, k_last + window) : Sq;
  *qt_begin = q_lo / kB;
  *qt_end = k0 < Sk && q_hi > q_lo ? (q_hi - 1) / kB + 1 : *qt_begin;
}

// ---- 1. D = rowsum(dout o o), one warp a row ---------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
flash_attention_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                 float* __restrict__ delta, int H, int Sq, int HDV,
                                 long long rows, BwdStrides sd) {
  const long long r = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int qp = static_cast<int>(r % Sq);
  const long long bh = r / Sq;
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  const T* orow = o + b * sd.o[0] + h * sd.o[1] + qp * sd.o[2];
  const T* drow = dout + b * sd.dout[0] + h * sd.dout[1] + qp * sd.dout[2];
  float part = 0.f;
  for (int d = lane; d < HDV; d += 32) part = fmaf(to_f32(drow[d]), to_f32(orow[d]), part);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
  if (lane == 0) delta[r] = part;
}

// ---------------------------------------------------------------------------
// CUDA-core variant
// ---------------------------------------------------------------------------

// rows [row0, row0 + kB) of a [*][W] matrix into shared rows of W + 1
// floats; rows at or past `limit` are zero.
template <typename T, int W>
__device__ __forceinline__ void stage(float* dst, const T* src, long long stride, int row0,
                                      int limit) {
  for (int e = threadIdx.x; e < kB * W; e += kThreads) {
    const int r = e / W, d = e % W;
    dst[r * (W + 1) + d] = row0 + r < limit ? to_f32(src[(long long)(row0 + r) * stride + d])
                                            : 0.f;
  }
}

// acc[i][j] = sum_d a[ra + 16 i][d] b[rb + 16 j][d] over W columns (rows of
// W + 1 floats)
template <int W>
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* a, int ra,
                                         const float* b, int rb) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < W; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ra + 16 * i) * (W + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(rb + 16 * j) * (W + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_c w[r + 16 i][c] m[c][tx + 16 j] over the kB columns of
// w (rows of kB + 1 floats) and the W columns of m (rows of W + 1 floats)
template <int W, int DJ>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][DJ], const float* w, int r,
                                                const float* m, int tx) {
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float wv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) wv[i] = w[(r + 16 * i) * (kB + 1) + c];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < W) {
        const float mv = m[c * (W + 1) + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(wv[i], mv, acc[i][j]);
      }
    }
  }
}

template <int HD, int HDV>
constexpr int dq_smem_floats() {
  return 2 * kB * (HD + 1) + 2 * kB * (HDV + 1) + kB * (kB + 1);
}
template <int HD, int HDV>
constexpr int dkdv_smem_floats() {
  return 2 * kB * (HD + 1) + 2 * kB * (HDV + 1) + 2 * kB * (kB + 1) + 2 * kB;
}

// dq: one block per (query tile of 64 rows, head, batch)
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ dout,
                              T* __restrict__ dq, const float* __restrict__ lse,
                              const float* __restrict__ delta, int H, int Hkv, int Sq,
                              int Sk, int causal, int window, float scale, BwdStrides sd) {
  constexpr int DJ = (HD + 15) / 16;  // dq columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // [kB][HD + 1]
  float* ks = qs + kB * (HD + 1);      // [kB][HD + 1]
  float* dos = ks + kB * (HD + 1);     // [kB][HDV + 1]
  float* vs = dos + kB * (HDV + 1);    // [kB][HDV + 1]
  float* dss = vs + kB * (HDV + 1);    // [kB][kB + 1]: dS of the tile

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* kg = k + b * sd.k[0] + hk * sd.k[1];
  const T* vg = v + b * sd.v[0] + hk * sd.v[1];
  T* dqg = dq + b * sd.dq[0] + h * sd.dq[1];
  const long long row_base = ((long long)b * H + h) * Sq;

  stage<T, HD>(qs, q + b * sd.q[0] + h * sd.q[1], sd.q[2], q0, Sq);
  stage<T, HDV>(dos, dout + b * sd.dout[0] + h * sd.dout[1], sd.dout[2], q0, Sq);
  float lr[4], dr[4];  // L and D of rows ty + 16 i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    lr[i] = qp < Sq ? lse[row_base + qp] : 0.f;
    dr[i] = qp < Sq ? delta[row_base + qp] : 0.f;
  }
  int kt_begin, kt_end;
  key_tiles(q0, kB, Sq, Sk, causal, window, &kt_begin, &kt_end);

  // dS = P (dout v^T - D), dq += dS k
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the previous tile's K, V and dS are no longer read
    stage<T, HD>(ks, kg, sd.k[2], k0, Sk);
    stage<T, HDV>(vs, vg, sd.v[2], k0, Sk);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<HD>(s, qs, ty, ks, tx);
    tile_dot<HDV>(dp, dos, ty, vs, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qp, k0 + tx + 16 * j, Sq, Sk, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lr[i]) : 0.f;
        dss[(ty + 16 * i) * (kB + 1) + tx + 16 * j] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
    tile_accumulate<HD, DJ>(acc, dss, ty, ks, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) store(dqg + (long long)qp * sd.dq[2] + d, acc[i][j] * scale);
    }
  }
}

// dk and dv: one block per (key tile of 64 rows, KV head, batch)
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                const T* __restrict__ v, const T* __restrict__ dout,
                                T* __restrict__ dk, T* __restrict__ dv,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                int H, int Hkv, int Sq, int Sk, int causal, int window,
                                float scale, BwdStrides sd) {
  constexpr int DK = (HD + 15) / 16, DV = (HDV + 15) / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                    // [kB][HD + 1]   this block's keys
  float* qs = ks + kB * (HD + 1);      // [kB][HD + 1]
  float* vs = qs + kB * (HD + 1);      // [kB][HDV + 1]  this block's values
  float* dos = vs + kB * (HDV + 1);    // [kB][HDV + 1]
  float* pt = dos + kB * (HDV + 1);    // [kB][kB + 1]: P^T of the tile, keys x queries
  float* dst = pt + kB * (kB + 1);     // [kB][kB + 1]: dS^T
  float* ls = dst + kB * (kB + 1);     // [kB]: L of the tile's queries
  float* ds_ = ls + kB;                // [kB]: D of the tile's queries

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kB, hk = blockIdx.y, b = blockIdx.z;
  const int rep = H / Hkv;
  stage<T, HD>(ks, k + b * sd.k[0] + hk * sd.k[1], sd.k[2], k0, Sk);
  stage<T, HDV>(vs, v + b * sd.v[0] + hk * sd.v[1], sd.v[2], k0, Sk);
  int qt_begin, qt_end;
  query_tiles(k0, kB, Sq, Sk, causal, window, &qt_begin, &qt_end);

  float adk[4][DK], adv[4][DV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < DK; ++j) adk[i][j] = 0.f;
#pragma unroll
    for (int j = 0; j < DV; ++j) adv[i][j] = 0.f;
  }
  for (int hh = 0; hh < rep; ++hh) {
    const int h = hk * rep + hh;
    const T* qg = q + b * sd.q[0] + h * sd.q[1];
    const T* dog = dout + b * sd.dout[0] + h * sd.dout[1];
    const long long row_base = ((long long)b * H + h) * Sq;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kB;
      __syncthreads();  // the previous tile's Q, dout, P^T and dS^T are no longer read
      stage<T, HD>(qs, qg, sd.q[2], q0, Sq);
      stage<T, HDV>(dos, dog, sd.dout[2], q0, Sq);
      for (int r = threadIdx.x; r < kB; r += kThreads) {
        const bool in = q0 + r < Sq;
        ls[r] = in ? lse[row_base + q0 + r] : 0.f;
        ds_[r] = in ? delta[row_base + q0 + r] : 0.f;
      }
      __syncthreads();
      // keys ty + 16 i against queries tx + 16 j
      float s[4][4], dp[4][4];
      tile_dot<HD>(s, ks, ty, qs, tx);
      tile_dot<HDV>(dp, vs, ty, dos, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const bool ok = visible(q0 + c, kp, Sq, Sk, causal, window);
          const float p = ok ? expf(s[i][j] * scale - ls[c]) : 0.f;
          pt[(ty + 16 * i) * (kB + 1) + c] = p;
          dst[(ty + 16 * i) * (kB + 1) + c] = p * (dp[i][j] - ds_[c]);
        }
      }
      __syncthreads();
      tile_accumulate<HDV, DV>(adv, pt, ty, dos, tx);
      tile_accumulate<HD, DK>(adk, dst, ty, qs, tx);
    }
  }
  T* dkg = dk + b * sd.dk[0] + hk * sd.dk[1];
  T* dvg = dv + b * sd.dv[0] + hk * sd.dv[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DK; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) store(dkg + (long long)kp * sd.dk[2] + d, adk[i][j] * scale);
    }
#pragma unroll
    for (int j = 0; j < DV; ++j) {
      const int d = tx + 16 * j;
      if (d < HDV) store(dvg + (long long)kp * sd.dv[2] + d, adv[i][j]);
    }
  }
}

template <typename T, int HD, int HDV>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, const float* lse, const float* delta, int B, int H,
                   int Hkv, int Sq, int Sk, int causal, int window, float scale,
                   const BwdStrides& sd, cudaStream_t st) {
  constexpr int smem_dq = dq_smem_floats<HD, HDV>() * (int)sizeof(float);
  constexpr int smem_dkdv = dkdv_smem_floats<HD, HDV>() * (int)sizeof(float);
  static_assert(smem_dq <= 232448 && smem_dkdv <= 232448,
                "a block may have 227 KB of shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dq_kernel<T, HD, HDV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, HD, HDV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return err;
  if (Sk > 0) {
    dim3 grid((Sk + kB - 1) / kB, Hkv, B);
    flash_attention_bwd_dkdv_kernel<T, HD, HDV><<<grid, kThreads, smem_dkdv, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv), lse, delta,
        H, Hkv, Sq, Sk, causal, window, scale, sd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (Sq > 0) {
    dim3 grid((Sq + kB - 1) / kB, H, B);
    flash_attention_bwd_dq_kernel<T, HD, HDV><<<grid, kThreads, smem_dq, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<T*>(dq), lse, delta, H, Hkv, Sq, Sk,
        causal, window, scale, sd);
    err = cudaGetLastError();
  }
  return err;
}

// The (hd, hd_v) pairs of the forward (kernels/flash_attention.py:FLASH_HEAD_DIMS).
template <typename T>
cudaError_t dispatch_hd(int hd, int hd_v, const void* q, const void* k, const void* v,
                        const void* dout, void* dq, void* dk, void* dv, const float* lse,
                        const float* delta, int B, int H, int Hkv, int Sq, int Sk,
                        int causal, int window, float scale, const BwdStrides& sd,
                        cudaStream_t st) {
#define REPRO_FLASH_BWD_PAIR(A, C)                                                     \
  if (hd == A && hd_v == C)                                                           \
    return launch<T, A, C>(q, k, v, dout, dq, dk, dv, lse, delta, B, H, Hkv, Sq, Sk,    \
                           causal, window, scale, sd, st);
  REPRO_FLASH_BWD_PAIR(8, 8)
  REPRO_FLASH_BWD_PAIR(16, 16)
  REPRO_FLASH_BWD_PAIR(32, 32)
  REPRO_FLASH_BWD_PAIR(64, 64)
  REPRO_FLASH_BWD_PAIR(128, 128)
  REPRO_FLASH_BWD_PAIR(24, 16)
  REPRO_FLASH_BWD_PAIR(192, 128)
#undef REPRO_FLASH_BWD_PAIR
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Tensor-core variant: bf16 at (hd, hd_v) = (64, 64), (128, 128) or (192, 128)
// ---------------------------------------------------------------------------

namespace tc {

using namespace repro_torch::tc;
using bf16 = __nv_bfloat16;

// The A fragments (m64 x k16, bf16 pairs) of a 64 x 64 f32 accumulator's
// four 16-column slices: slice kk is accumulator elements 8 kk .. 8 kk + 7.
__device__ __forceinline__ void to_a_fragments(const float (&acc)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(acc[8 * kk + 2 * r], acc[8 * kk + 2 * r + 1]);
      a[kk][r] = *reinterpret_cast<const uint32_t*>(&h);
    }
}

// Shared memory of launch 2: K [64 NWG][HD] and V [64 NWG][HDV] resident, a
// two-stage ring of Q [64][HD], dout [64][HDV], L and D [64] f32 each; bf16
// tiles as width / 64 column blocks of [rows][64] in the 128-byte swizzle.
template <int HD, int HDV, int NWG>
constexpr int dkdv_smem_bytes() {
  return (64 * NWG + 2 * kB) * (HD + HDV) * 2 + 2 * 2 * kB * 4 + 1024;
}
// Launch 3: Q [64 NWG][HD] and dout [64 NWG][HDV] resident, a two-stage ring
// of K [64][HD] and V [64][HDV].
template <int HD, int HDV, int NWG>
constexpr int dq_smem_bytes() {
  return (64 * NWG + 2 * kB) * (HD + HDV) * 2 + 1024;
}

// ---- 2. dk, dv: warpgroup w of block (key tile, KV head, batch) owns keys
// k0 + 64 w .. k0 + 64 w + 63 ------------------------------------------------
template <int HD, int HDV, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
flash_attention_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            int B, int H, int Hkv, int Sq, int Sk, int causal, int window,
                            float scale, BwdStrides sd) {
  constexpr int NT = 128 * NWG, BK = 64 * NWG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(align1024(smem_raw));  // [BK][HD]
  bf16* vs = ks + BK * HD;                                   // [BK][HDV]
  bf16* qs = vs + BK * HDV;                                  // [2][kB][HD]
  bf16* dos = qs + 2 * kB * HD;                              // [2][kB][HDV]
  float* ls = reinterpret_cast<float*>(dos + 2 * kB * HDV);  // [2][kB]: L
  float* dls = ls + 2 * kB;                                  // [2][kB]: D

  // key tiles in order: under a causal mask the first see the most queries
  const int nb = B * Hkv;
  const int k0 = (blockIdx.x / nb) * BK;
  const int b = (blockIdx.x % nb) / Hkv, hk = (blockIdx.x % nb) % Hkv;
  const int rep = H / Hkv;
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_w = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // this warp's keys in the block
  const int kw0 = k0 + wg * 64;                                // this warpgroup's keys

  int qt_begin, qt_end, wq_begin, wq_end;
  query_tiles(k0, BK, Sq, Sk, causal, window, &qt_begin, &qt_end);
  query_tiles(kw0, kB, Sq, Sk, causal, window, &wq_begin, &wq_end);
  const int n_qt = qt_end - qt_begin;
  const int steps = rep * n_qt;
  const float scale_log2 = scale * kLog2e;

  auto load_step = [&](int i, int stage) {
    const int h = hk * rep + i / n_qt, q0 = (qt_begin + i % n_qt) * kB;
    load_swizzled<HD, NT>(qs + stage * kB * HD, q + b * sd.q[0] + h * sd.q[1], sd.q[2], q0,
                          kB, Sq);
    load_swizzled<HDV, NT>(dos + stage * kB * HDV, dout + b * sd.dout[0] + h * sd.dout[1],
                           sd.dout[2], q0, kB, Sq);
    const long long row = ((long long)b * H + h) * Sq + q0;
    for (int r = threadIdx.x; r < 2 * kB; r += NT) {
      const int rr = r & (kB - 1);
      const bool in = q0 + rr < Sq;
      const float* src = (r < kB ? lse : delta) + (in ? row + rr : 0);
      cp_async4(smem_addr((r < kB ? ls : dls) + stage * kB + rr), src, in);
    }
  };

  load_swizzled<HD, NT>(ks, k + b * sd.k[0] + hk * sd.k[1], sd.k[2], k0, BK, Sk);
  load_swizzled<HDV, NT>(vs, v + b * sd.v[0] + hk * sd.v[1], sd.v[2], k0, BK, Sk);
  if (steps > 0) load_step(0, 0);
  cp_async_commit();

  float adk[HD / 64][32], adv[HDV / 64][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
#pragma unroll
    for (int c = 0; c < HD / 64; ++c) adk[c][i] = 0.f;
#pragma unroll
    for (int c = 0; c < HDV / 64; ++c) adv[c][i] = 0.f;
  }
  const bf16* kw = ks + wg * 64 * 64;  // this warpgroup's rows of each column block
  const bf16* vw = vs + wg * 64 * 64;

  for (int i = 0; i < steps; ++i) {
    const int stage = i & 1;
    if (i + 1 < steps) load_step(i + 1, stage ^ 1);  // overlaps this step's products
    cp_async_commit();
    cp_async_wait<1>();   // all but the newest group: K, V and this step's tiles are in
    fence_proxy_async();  // cp.async wrote them; wgmma reads them
    __syncthreads();
    const int qt = qt_begin + i % n_qt, q0 = qt * kB;
    if (qt >= wq_begin && qt < wq_end) {  // one value for the whole warpgroup
      const bf16* qst = qs + stage * kB * HD;
      const bf16* dost = dos + stage * kB * HDV;
      const float* lst = ls + stage * kB;
      const float* dlst = dls + stage * kB;
      // S^T = K Q^T, dP^T = V dout^T: element e holds key row_w + g + 8
      // ((e >> 1) & 1), query q0 + 8 (e >> 2) + 2 t4 + (e & 1)
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_s(s, wg_desc(kw + (kk >> 2) * BK * 64 + (kk & 3) * 16),
                wg_desc(qst + (kk >> 2) * kB * 64 + (kk & 3) * 16), kk);
#pragma unroll
      for (int kk = 0; kk < HDV / 16; ++kk)
        wgmma_s(dp, wg_desc(vw + (kk >> 2) * BK * 64 + (kk & 3) * 16),
                wg_desc(dost + (kk >> 2) * kB * 64 + (kk & 3) * 16), kk);
      wg_commit();
      wg_wait_all();

      // P^T = exp2(S^T scale log2(e) - L log2(e)), dS^T = P^T (dP^T - D); the
      // mask only where the band's edge crosses this tile
      const bool edge = kw0 + kB > Sk || q0 + kB > Sq || (causal && kw0 + kB - 1 > q0) ||
                        (window >= 0 && kw0 <= q0 + kB - 1 - window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = 8 * (e >> 2) + 2 * t4 + (e & 1);
        float p = ex2(fmaf(s[e], scale_log2, -lst[c] * kLog2e));
        if (edge && !visible(q0 + c, k0 + row_w + g + 8 * ((e >> 1) & 1), Sq, Sk, causal,
                             window))
          p = 0.f;
        s[e] = p;
        dp[e] = p * (dp[e] - dlst[c]);
      }

      // dV += P^T dout, dK += dS^T Q, P^T and dS^T from registers
      uint32_t pa[4][4], da[4][4];
      to_a_fragments(s, pa);
      to_a_fragments(dp, da);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int c = 0; c < HDV / 64; ++c)
          wgmma_o(adv[c], pa[kk], wg_desc(dost + c * kB * 64 + kk * 16 * 64));
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          wgmma_o(adk[c], da[kk], wg_desc(qst + c * kB * 64 + kk * 16 * 64));
      }
      wg_commit();
      wg_wait_all();
    }
    __syncthreads();  // this stage is free for the load the next step issues
  }
  cp_async_wait<0>();

  bf16* dkg = dk + b * sd.dk[0] + hk * sd.dk[1];
  bf16* dvg = dv + b * sd.dv[0] + hk * sd.dv[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = k0 + row_w + g + 8 * r;
    if (kp >= Sk) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float* a = adk[j >> 3] + 4 * (j & 7) + 2 * r;
      *reinterpret_cast<uint32_t*>(dkg + kp * sd.dk[2] + 8 * j + 2 * t4) =
          pack_bf16(__float2bfloat16_rn(a[0] * scale), __float2bfloat16_rn(a[1] * scale));
    }
#pragma unroll
    for (int j = 0; j < HDV / 8; ++j) {
      const float* a = adv[j >> 3] + 4 * (j & 7) + 2 * r;
      *reinterpret_cast<uint32_t*>(dvg + kp * sd.dv[2] + 8 * j + 2 * t4) =
          pack_bf16(__float2bfloat16_rn(a[0]), __float2bfloat16_rn(a[1]));
    }
  }
}

// ---- 3. dq: warpgroup w of block (query tile, head, batch) owns queries
// q0 + 64 w .. q0 + 64 w + 63 ------------------------------------------------
template <int HD, int HDV, int NWG>
__global__ void __launch_bounds__(128 * NWG, 1)
flash_attention_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          bf16* __restrict__ dq, const float* __restrict__ lse,
                          const float* __restrict__ delta, int B, int H, int Hkv, int Sq,
                          int Sk, int causal, int window, float scale, BwdStrides sd) {
  constexpr int NT = 128 * NWG, BQ = 64 * NWG;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(align1024(smem_raw));  // [BQ][HD]
  bf16* dos = qs + BQ * HD;                                  // [BQ][HDV]
  bf16* ks = dos + BQ * HDV;                                 // [2][kB][HD]
  bf16* vs = ks + 2 * kB * HD;                               // [2][kB][HDV]

  // query tiles from the last: under a causal mask the last see the most keys
  const int nq = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nq - 1 - blockIdx.x / (B * H)) * BQ;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const bf16* kg = k + b * sd.k[0] + hk * sd.k[1];
  const bf16* vg = v + b * sd.v[0] + hk * sd.v[1];
  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_w = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // this warp's queries
  const int qw0 = q0 + wg * 64;

  int kt_begin, kt_end, wk_begin, wk_end;
  key_tiles(q0, BQ, Sq, Sk, causal, window, &kt_begin, &kt_end);
  key_tiles(qw0, kB, Sq, Sk, causal, window, &wk_begin, &wk_end);
  const float scale_log2 = scale * kLog2e;

  load_swizzled<HD, NT>(qs, q + b * sd.q[0] + h * sd.q[1], sd.q[2], q0, BQ, Sq);
  load_swizzled<HDV, NT>(dos, dout + b * sd.dout[0] + h * sd.dout[1], sd.dout[2], q0, BQ, Sq);
  if (kt_begin < kt_end) {
    load_swizzled<HD, NT>(ks, kg, sd.k[2], kt_begin * kB, kB, Sk);
    load_swizzled<HDV, NT>(vs, vg, sd.v[2], kt_begin * kB, kB, Sk);
  }
  cp_async_commit();

  float l2[2], dr[2];  // L log2(e) and D of rows g and g + 8 of this warp
  const long long row_base = ((long long)b * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + row_w + g + 8 * r;
    l2[r] = qp < Sq ? lse[row_base + qp] * kLog2e : 0.f;
    dr[r] = qp < Sq ? delta[row_base + qp] : 0.f;
  }
  float adq[HD / 64][32];
#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) adq[c][i] = 0.f;
  const bf16* qw = qs + wg * 64 * 64;
  const bf16* dow = dos + wg * 64 * 64;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    const int k0 = kt * kB;
    if (kt + 1 < kt_end) {
      load_swizzled<HD, NT>(ks + (stage ^ 1) * kB * HD, kg, sd.k[2], k0 + kB, kB, Sk);
      load_swizzled<HDV, NT>(vs + (stage ^ 1) * kB * HDV, vg, sd.v[2], k0 + kB, kB, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    if (kt >= wk_begin && kt < wk_end) {
      const bf16* kst = ks + stage * kB * HD;
      const bf16* vst = vs + stage * kB * HDV;
      // S = Q K^T, dP = dout V^T: element e holds query row_w + g + 8 ((e >>
      // 1) & 1), key k0 + 8 (e >> 2) + 2 t4 + (e & 1)
      float s[32], dp[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        wgmma_s(s, wg_desc(qw + (kk >> 2) * BQ * 64 + (kk & 3) * 16),
                wg_desc(kst + (kk >> 2) * kB * 64 + (kk & 3) * 16), kk);
#pragma unroll
      for (int kk = 0; kk < HDV / 16; ++kk)
        wgmma_s(dp, wg_desc(dow + (kk >> 2) * BQ * 64 + (kk & 3) * 16),
                wg_desc(vst + (kk >> 2) * kB * 64 + (kk & 3) * 16), kk);
      wg_commit();
      wg_wait_all();

      const bool edge = k0 + kB > Sk || qw0 + kB > Sq || (causal && k0 + kB - 1 > qw0) ||
                        (window >= 0 && k0 <= qw0 + kB - 1 - window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e >> 1) & 1;
        float p = ex2(fmaf(s[e], scale_log2, -l2[r]));
        if (edge && !visible(q0 + row_w + g + 8 * r, k0 + 8 * (e >> 2) + 2 * t4 + (e & 1), Sq,
                             Sk, causal, window))
          p = 0.f;
        dp[e] = p * (dp[e] - dr[r]);
      }

      // dQ += dS K, dS from registers
      uint32_t da[4][4];
      to_a_fragments(dp, da);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < HD / 64; ++c)
          wgmma_o(adq[c], da[kk], wg_desc(kst + c * kB * 64 + kk * 16 * 64));
      wg_commit();
      wg_wait_all();
    }
    __syncthreads();  // this stage is free for the load the next step issues
  }
  cp_async_wait<0>();

  bf16* dqg = dq + b * sd.dq[0] + h * sd.dq[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = q0 + row_w + g + 8 * r;
    if (qp >= Sq) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float* a = adq[j >> 3] + 4 * (j & 7) + 2 * r;
      *reinterpret_cast<uint32_t*>(dqg + qp * sd.dq[2] + 8 * j + 2 * t4) =
          pack_bf16(__float2bfloat16_rn(a[0] * scale), __float2bfloat16_rn(a[1] * scale));
    }
  }
}

template <int HD, int HDV, int NWG>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, const float* lse, const float* delta, int B, int H,
                   int Hkv, int Sq, int Sk, int causal, int window, float scale,
                   const BwdStrides& sd, cudaStream_t st) {
  constexpr int smem_kv = dkdv_smem_bytes<HD, HDV, NWG>();
  constexpr int smem_q = dq_smem_bytes<HD, HDV, NWG>();
  static_assert(smem_kv <= 232448 && smem_q <= 232448,
                "a block may have 227 KB of shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_tc<HD, HDV, NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dq_tc<HD, HDV, NWG>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return err;
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  const auto* db = static_cast<const bf16*>(dout);
  const long long kv_blocks = (long long)((Sk + 64 * NWG - 1) / (64 * NWG)) * B * Hkv;
  const long long q_blocks = (long long)((Sq + 64 * NWG - 1) / (64 * NWG)) * B * H;
  if (kv_blocks > 0x7fffffffLL || q_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (kv_blocks > 0) {
    flash_attention_bwd_dkdv_tc<HD, HDV, NWG><<<(unsigned)kv_blocks, 128 * NWG, smem_kv, st>>>(
        qb, kb, vb, db, static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, delta, B, H, Hkv,
        Sq, Sk, causal, window, scale, sd);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (q_blocks > 0) {
    flash_attention_bwd_dq_tc<HD, HDV, NWG><<<(unsigned)q_blocks, 128 * NWG, smem_q, st>>>(
        qb, kb, vb, db, static_cast<bf16*>(dq), lse, delta, B, H, Hkv, Sq, Sk, causal, window,
        scale, sd);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace tc

}  // namespace repro_torch_bwd

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = CUDA cores, 1 = tensor
// cores (bf16 at (hd, hd_v) = (64, 64), (128, 128) or (192, 128) only; rows
// 16-byte aligned).  window < 0 means no window.  strides: 24 element strides,
// (batch, head, row) of q, k, v, o, dout, dq, dk and dv in that order.  lse:
// the forward's (B, H, Sq) f32 log-sum-exp, base e; delta: (B, H, Sq) f32
// scratch.  Returns the CUDA error of the launches (0 on success); runs on
// `stream`.
extern "C" int repro_torch_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, const float* lse, float* delta, int B, int H, int Hkv, int Sq, int Sk,
    int hd, int hd_v, int causal, int window, float scale, int dtype, int variant,
    const long long* strides, void* stream) {
  namespace fb = repro_torch_bwd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  fb::BwdStrides sd;
  long long* fields[8] = {sd.q, sd.k, sd.v, sd.o, sd.dout, sd.dq, sd.dk, sd.dv};
  for (int f = 0; f < 8; ++f)
    for (int i = 0; i < 3; ++i) fields[f][i] = strides[3 * f + i];
  const long long rows = (long long)B * H * Sq;
  if (rows > 0) {
    const long long blocks = (rows + 7) / 8;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      fb::flash_attention_bwd_delta_kernel<float><<<(unsigned)blocks, 256, 0, st>>>(
          static_cast<const float*>(o), static_cast<const float*>(dout), delta, H, Sq, hd_v,
          rows, sd);
    else
      fb::flash_attention_bwd_delta_kernel<__nv_bfloat16><<<(unsigned)blocks, 256, 0, st>>>(
          static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), delta,
          H, Sq, hd_v, rows, sd);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (hd == 64 && hd_v == 64)
      return (int)fb::tc::launch<64, 64, 1>(q, k, v, dout, dq, dk, dv, lse, delta, B, H, Hkv,
                                            Sq, Sk, causal, window, scale, sd, st);
    if (hd == 128 && hd_v == 128)
      return (int)fb::tc::launch<128, 128, 1>(q, k, v, dout, dq, dk, dv, lse, delta, B, H,
                                              Hkv, Sq, Sk, causal, window, scale, sd, st);
    if (hd == 192 && hd_v == 128)
      return (int)fb::tc::launch<192, 128, 2>(q, k, v, dout, dq, dk, dv, lse, delta, B, H,
                                              Hkv, Sq, Sk, causal, window, scale, sd, st);
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err =
      dtype == 0
          ? fb::dispatch_hd<float>(hd, hd_v, q, k, v, dout, dq, dk, dv, lse, delta, B, H, Hkv,
                                   Sq, Sk, causal, window, scale, sd, st)
          : fb::dispatch_hd<__nv_bfloat16>(hd, hd_v, q, k, v, dout, dq, dk, dv, lse, delta, B,
                                           H, Hkv, Sq, Sk, causal, window, scale, sd, st);
  return (int)err;
}
