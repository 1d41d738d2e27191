// Backward of the online-softmax attention (B4-bwd) for Hopper, on the CUDA cores.
//
// No TPU kernel corresponds to it: the JAX package differentiates its
// pure-JAX `chunked_attention` (models/attention.py) with autodiff.  This is
// the gradient of csrc/flash_attention.cu's function (causal / full / sliding
// window, GQA by index, value heads hd_v narrower than q/k's hd allowed) for
// the port's `FlashAttentionFn` (kernels/flash_attention.py), the same
// gradient autograd takes through its plain version.  Inputs: q, k, v, the
// forward's output o and its gradient dout, f32 or bf16, each in any layout
// whose rows are contiguous (batch, head and row strides are arguments).
// Outputs dq, dk, dv in the input dtype; every sum is f32.
//
// With P = softmax(scale q k^T) over the visible keys, L the row
// log-sum-exp of the scaled scores and D = rowsum(dout o o):
//   dv_j = sum_i P_ij dout_i,  dS_ij = P_ij (dout_i . v_j - D_i),
//   dq_i = scale sum_j dS_ij k_j,  dk_j = scale sum_i dS_ij q_i.
// Two launches on one stream:
//   1. dq: one block per (query tile of 64 rows, head, batch): D from the
//      tile's dout and o; a first walk over the visible key tiles gives each
//      row's running max and sum, so L (the forward does not keep it); a
//      second walk recomputes P from L and accumulates dq in registers.
//      L and D go to scratch (B, H, Sq) f32 for launch 2.
//   2. dk/dv: one block per (key tile of 64 rows, KV head, batch) walks the
//      query heads of its group and, for each, the query tiles that can see
//      its keys, accumulating dk and dv in registers: the GQA sum over the
//      group's heads is taken in one block, in head order.
// No atomics anywhere: every output element is written by one thread once,
// so a step is deterministic.
//
// What bounds it on this card: operations.  Per visible (query, key) pair
// launch 1 does three products of width hd or hd_v (S twice, dout v^T) and
// one of hd (dS k), launch 2 four (S, dout v^T, P^T dout, dS^T q): about
// 8 hd multiply-adds a pair against a few bytes of q/k/v read per tile.  It
// runs them as f32 FMAs on the CUDA cores (67 TFLOP/s on an H100 SXM), not
// on the tensor cores: a simple kernel, right first (the tensor-core
// redesign is later work).  Thread (ty, tx) of 16 x 16 keeps a 4 x 4 tile
// of scores and a 4 x width/16 tile of its accumulators in registers; tiles
// are staged in shared memory as f32 in rows padded to width + 1 floats, so
// column reads of 16 consecutive rows hit 16 banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch_bwd {

constexpr int kB = 64;         // query or key rows per tile
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx)
constexpr float kNegInf = -1073741824.0f;  // -2^30, the forward's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Element strides (batch, head, row) of q, k, v, o, dout, dq, dk, dv.
struct BwdStrides {
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

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

// The forward's mask: key kp is seen by query qp.
__device__ __forceinline__ bool visible(int qp, int kp, int Sq, int Sk, int causal,
                                        int window) {
  return kp < Sk && qp < Sq && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
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

// sum over the 16 lanes of a row (lanes 16 k .. 16 k + 15 of a warp)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int HD, int HDV>
constexpr int dq_smem_floats() {
  return 2 * kB * (HD + 1) + 2 * kB * (HDV + 1) + kB * (kB + 1);
}
template <int HD, int HDV>
constexpr int dkdv_smem_floats() {
  return 2 * kB * (HD + 1) + 2 * kB * (HDV + 1) + 2 * kB * (kB + 1) + 2 * kB;
}

// ---- 1. dq, and L and D for launch 2 ---------------------------------------
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ o,
                              const T* __restrict__ dout, T* __restrict__ dq,
                              float* __restrict__ lse, float* __restrict__ delta, int H,
                              int Hkv, int Sq, int Sk, int causal, int window, float scale,
                              BwdStrides sd) {
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
  const T* qg = q + b * sd.q[0] + h * sd.q[1];
  const T* kg = k + b * sd.k[0] + hk * sd.k[1];
  const T* vg = v + b * sd.v[0] + hk * sd.v[1];
  const T* og = o + b * sd.o[0] + h * sd.o[1];
  const T* dog = dout + b * sd.dout[0] + h * sd.dout[1];
  T* dqg = dq + b * sd.dq[0] + h * sd.dq[1];
  const long long row_base = ((long long)b * H + h) * Sq;

  stage<T, HD>(qs, qg, sd.q[2], q0, Sq);
  stage<T, HDV>(dos, dog, sd.dout[2], q0, Sq);
  __syncthreads();

  // D of rows ty + 16 i: the 16 lanes of a row split its hd_v columns
  float dr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float part = 0.f;
    if (q0 + r < Sq)
      for (int d = tx; d < HDV; d += 16)
        part = fmaf(dos[r * (HDV + 1) + d], to_f32(og[(long long)(q0 + r) * sd.o[2] + d]), part);
    dr[i] = row_sum(part);
  }

  // keys this tile's rows can see: [k_lo, k_hi)
  const int q_last = min(q0 + kB, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_lo / kB;
  const int kt_end = k_hi > k_lo ? (k_hi - 1) / kB + 1 : kt_begin;

  // walk 1: each row's max and sum of exp over its visible scaled scores
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();
    stage<T, HD>(ks, kg, sd.k[2], k0, Sk);
    __syncthreads();
    float s[4][4];
    tile_dot<HD>(s, qs, ty, ks, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(qp, k0 + tx + 16 * j, Sq, Sk, causal, window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += ok[j] ? expf(s[i][j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }
  float lr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lr[i] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;  // a row with no visible key has P = 0
    const int qp = q0 + ty + 16 * i;
    if (tx == 0 && qp < Sq) {
      lse[row_base + qp] = lr[i];
      delta[row_base + qp] = dr[i];
    }
  }

  // walk 2: dS = P (dout v^T - D), dq += dS k
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

// ---- 2. dk and dv ------------------------------------------------------------
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
  const T* kg = k + b * sd.k[0] + hk * sd.k[1];
  const T* vg = v + b * sd.v[0] + hk * sd.v[1];
  stage<T, HD>(ks, kg, sd.k[2], k0, Sk);
  stage<T, HDV>(vs, vg, sd.v[2], k0, Sk);

  // queries that can see this tile's keys: [q_lo, q_hi)
  const int k_last = min(k0 + kB, Sk) - 1;
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window >= 0 ? min(Sq, k_last + window) : Sq;
  const int qt_begin = q_lo / kB;
  const int qt_end = q_hi > q_lo ? (q_hi - 1) / kB + 1 : qt_begin;

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
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
                   int B, int H, int Hkv, int Sq, int Sk, int causal, int window, float scale,
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
  if (Sq > 0) {
    dim3 grid((Sq + kB - 1) / kB, H, B);
    flash_attention_bwd_dq_kernel<T, HD, HDV><<<grid, kThreads, smem_dq, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(o), static_cast<const T*>(dout), static_cast<T*>(dq), lse,
        delta, H, Hkv, Sq, Sk, causal, window, scale, sd);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (Sk > 0) {
    dim3 grid((Sk + kB - 1) / kB, Hkv, B);
    flash_attention_bwd_dkdv_kernel<T, HD, HDV><<<grid, kThreads, smem_dkdv, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const T*>(dout), static_cast<T*>(dk), static_cast<T*>(dv), lse, delta,
        H, Hkv, Sq, Sk, causal, window, scale, sd);
    err = cudaGetLastError();
  }
  return err;
}

// The (hd, hd_v) pairs of the forward (kernels/flash_attention.py:FLASH_HEAD_DIMS).
template <typename T>
cudaError_t dispatch_hd(int hd, int hd_v, const void* q, const void* k, const void* v,
                        const void* o, const void* dout, void* dq, void* dk, void* dv,
                        float* lse, float* delta, int B, int H, int Hkv, int Sq, int Sk,
                        int causal, int window, float scale, const BwdStrides& sd,
                        cudaStream_t st) {
#define REPRO_FLASH_BWD_PAIR(A, C)                                                     \
  if (hd == A && hd_v == C)                                                           \
    return launch<T, A, C>(q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, Hkv, Sq, Sk, \
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

}  // namespace repro_torch_bwd

// dtype: 0 = float32, 1 = bfloat16.  window < 0 means no window.  strides: 24
// element strides, (batch, head, row) of q, k, v, o, dout, dq, dk and dv in
// that order.  lse and delta: (B, H, Sq) f32 scratch.  Returns the CUDA
// error of the launches (0 on success); runs on `stream`.
extern "C" int repro_torch_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, void* dq,
    void* dk, void* dv, float* lse, float* delta, int B, int H, int Hkv, int Sq, int Sk,
    int hd, int hd_v, int causal, int window, float scale, int dtype,
    const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0) return 0;
  repro_torch_bwd::BwdStrides sd;
  long long* fields[8] = {sd.q, sd.k, sd.v, sd.o, sd.dout, sd.dq, sd.dk, sd.dv};
  for (int f = 0; f < 8; ++f)
    for (int i = 0; i < 3; ++i) fields[f][i] = strides[3 * f + i];
  cudaError_t err =
      dtype == 0
          ? repro_torch_bwd::dispatch_hd<float>(hd, hd_v, q, k, v, o, dout, dq, dk, dv, lse,
                                                delta, B, H, Hkv, Sq, Sk, causal, window,
                                                scale, sd, st)
          : repro_torch_bwd::dispatch_hd<__nv_bfloat16>(hd, hd_v, q, k, v, o, dout, dq, dk,
                                                        dv, lse, delta, B, H, Hkv, Sq, Sk,
                                                        causal, window, scale, sd, st);
  return (int)err;
}
