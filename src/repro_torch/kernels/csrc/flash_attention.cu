// Online-softmax attention (causal / full / sliding window, GQA) for Hopper.
//
// Replaces the TPU kernel `flash_attention_kernel` (`_flash_body`) of the JAX
// package's kernels/flash_attention.py.  q (B, H, Sq, hd), k/v (B, Hkv, Sk,
// hd), f32 or bf16, each in any layout whose hd elements of a row are
// contiguous: the batch, head and row strides are arguments, so the model's
// (B, S, H, hd) tensors are read and written in place, with no copies.  Query
// head h reads KV head h / (H / Hkv), never a repeated copy.  A key k is seen by query q iff k < Sk, q < Sq,
// k <= q (causal) and k > q - window (window), absolute indices, exactly as
// the Pallas body masks; so K and V need no padding.  Products, the running
// max m, sum l and accumulator are f32, as in the Pallas body (which casts
// its tiles to f32 before both products); a row whose keys are all masked
// ends at 0 / max(l, 1e-30) = 0.  The output is in q's dtype.
//
// What bounds it on this card: operations.  At the hybrid model's prefill
// (hd 64, window 4096) each query row meets up to 4096 keys and every (q, k)
// pair costs 4 hd flops against 2 hd bytes of K/V read once per query tile,
// so the work is far above the byte line; the card's bound is its bf16
// tensor-core rate.  This first version does the products on the CUDA cores
// in f32 (explicit fmaf), so it sits well above that bound; what its design
// does: one block per (query tile of 64 rows, head, batch) walks the key
// tiles in order with Q, K, V staged in shared memory as f32, each thread
// keeps a 4 x 4 tile of scores and a 4 x hd/16 tile of the accumulator in
// registers, and key tiles that lie wholly outside the causal/window band
// are never visited (they would add exactly nothing).  wgmma, TMA and
// warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx)
constexpr float kNegInf = -1073741824.0f;  // -2^30, the Pallas body's NEG_INF

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Shared memory: Q tile and K tile row-padded to hd + 1 floats (conflict-free
// column reads), V tile hd floats a row, P tile kBK + 1 floats a row.
template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1);
}

// Element strides (batch, head, row) of q, k, v and out.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int Sq, int Sk, int causal, int window,
                       float scale, Strides sd) {
  constexpr int DJ = (HD + 15) / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kBQ][HD + 1]
  float* ks = qs + kBQ * (HD + 1);         // [kBK][HD + 1]
  float* vs = ks + kBK * (HD + 1);         // [kBK][HD]
  float* ps = vs + kBK * HD;               // [kBQ][kBK + 1]

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const T* qg = q + b * sd.q[0] + h * sd.q[1];
  const T* kg = k + b * sd.k[0] + hk * sd.k[1];
  const T* vg = v + b * sd.v[0] + hk * sd.v[1];
  T* og = out + b * sd.o[0] + h * sd.o[1];

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    qs[r * (HD + 1) + d] = (q0 + r < Sq) ? to_f32(qg[(q0 + r) * sd.q[2] + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // keys this tile's rows can see: [k_lo, k_hi)
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kt_end = k_hi > k_lo ? (k_hi - 1) / kBK + 1 : 0;

  for (int kt = k_lo / kBK; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const bool in = k0 + r < Sk;
      ks[r * (HD + 1) + d] = in ? to_f32(kg[(k0 + r) * sd.k[2] + d]) : 0.f;
      vs[r * HD + d] = in ? to_f32(vg[(k0 + r) * sd.v[2] + d]) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax; a row's 16 threads are 16 consecutive lanes
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < Sk && qp < Sq && (!causal || kp <= qp) &&
                (window < 0 || kp > qp - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc[rows ty + 16 i][dims tx + 16 j] += P · V
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < HD) {
          const float vv = vs[c * HD + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) store(og + qp * sd.o[2] + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Hkv, int Sq, int Sk, int causal,
                   int window, float scale, const Strides& sd, cudaStream_t st) {
  const int smem = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, Hkv, Sq, Sk, causal, window, scale, sd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        void* out, int B, int H, int Hkv, int Sq, int Sk,
                        int causal, int window, float scale, const Strides& sd,
                        cudaStream_t st) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, window, scale, sd, st);
    case 16: return launch<T, 16>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, window, scale, sd, st);
    case 32: return launch<T, 32>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, window, scale, sd, st);
    case 64: return launch<T, 64>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, window, scale, sd, st);
    case 128: return launch<T, 128>(q, k, v, out, B, H, Hkv, Sq, Sk, causal, window, scale, sd, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro_torch

// dtype: 0 = float32, 1 = bfloat16.  window < 0 means no window.  strides:
// 12 element strides, (batch, head, row) of q, k, v and out in that order.
// Returns the CUDA error of the launch (0 on success); runs on `stream`.
extern "C" int repro_torch_flash_attention(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int H, int Hkv, int Sq, int Sk,
                                           int hd, int causal, int window,
                                           float scale, int dtype,
                                           const long long* strides,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0 || H == 0 || Sq == 0) return 0;
  repro_torch::Strides sd;
  for (int i = 0; i < 3; ++i) {
    sd.q[i] = strides[i];
    sd.k[i] = strides[3 + i];
    sd.v[i] = strides[6 + i];
    sd.o[i] = strides[9 + i];
  }
  cudaError_t err =
      dtype == 0
          ? repro_torch::dispatch_hd<float>(hd, q, k, v, out, B, H, Hkv, Sq, Sk,
                                            causal, window, scale, sd, st)
          : repro_torch::dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, H, Hkv,
                                                    Sq, Sk, causal, window, scale,
                                                    sd, st);
  return (int)err;
}
