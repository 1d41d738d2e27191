// Online-softmax attention (causal / full / sliding window, GQA) for Hopper.
//
// Replaces the TPU kernel `flash_attention_kernel` (`_flash_body`) of the JAX
// package's kernels/flash_attention.py.  q/k (B, H|Hkv, S, hd), v (B, Hkv,
// Sk, hd_v) and out (B, H, Sq, hd_v), f32 or bf16, each in any layout whose
// elements of a row are contiguous: the batch, head and row strides are arguments, so the model's
// (B, S, H, hd) tensors are read and written in place, with no copies.  Query
// head h reads KV head h / (H / Hkv), never a repeated copy.  A key k is seen
// by query q iff k < Sk, q < Sq, k <= q (causal) and k > q - window (window),
// absolute indices, exactly as the Pallas body masks; so K and V need no
// padding.  The running max m, sum l and accumulator are f32, as in the
// Pallas body; a row whose keys are all masked ends at 0 / max(l, 1e-30) = 0.
// The output is in q's dtype.  v's head width hd_v may be narrower than q's
// and k's hd: MLA (DeepSeek-V2) attends with q/k heads of 192 (128 without
// position + 64 rotary) and value heads of 128.
//
// What bounds it on this card: operations.  At the hybrid model's prefill
// (hd 64, window 4096) each query row meets up to 4096 keys and every (q, k)
// pair costs 4 hd flops against 2 hd bytes of K/V read once per query tile,
// so the work is far above the byte line; the card's bound is its bf16
// tensor-core rate, and at hd 64 the pair's one exponential (the SFU's rate)
// is close behind.  Two variants, chosen by the caller (`variant`, fixed by
// dtype and hd in kernels/flash_attention.py:flash_variant):
//
// * tensor cores (`flash_attention_kernel_tc`, bf16 at (hd, hd_v) = (64,
//   64), (128, 128) and (192, 128)): one block of NWG warpgroups (4 warps
//   each) per query tile of 64 NWG rows (NWG 2 at hd 64, 4 above), each
//   warpgroup owning 64 rows.  At (192, 128) shared memory holds Q (256 x
//   192, 96 KB), a two-stage K ring (2 x 64 x 192, 48 KB) and a V ring (2 x
//   64 x 128, 32 KB): 177 KB of the 227 a block may have; S = Q K^T is 12 k
//   steps of 16 over 192, O += P V the same N = 128 accumulator as at hd 128.
//   ptxas spills 32 bytes a thread there at 128 registers; NWG 2 (155
//   registers, no spill) measured slower on an H100 at deepseek-v2's prefill
//   (24.5-24.7 against 21.5-22.1 ms, tools/torch_kernel_probe.py
//   flash-mla-variants), so it stays at NWG 4.  Q is staged
//   once, K and V tiles of 64 keys go through a two-stage shared-memory ring
//   by cp.async, 16 bytes a thread, so the next tile's load overlaps this
//   tile's products; the tiles are stored in the 128-byte swizzle, which
//   wgmma reads without bank conflicts.  Both products run on
//   `wgmma.mma_async` (m64n64k16): S = Q K^T from shared memory, bf16 with
//   f32 sums (the products of two bf16 values are exact in f32: the Pallas
//   body's cast-then-multiply up to the order of the sum); O += P V with P
//   from registers, where the S accumulator already has the A operand's
//   layout.  The softmax is exp2 of
//   the scores scaled by log2(e) scale (one fused multiply-add each), in f32
//   registers, the row max and sum shared by the four lanes of a row.  P is
//   split as P_hi = bf16(P) and P_lo = bf16(P - P_hi), both multiplied on
//   the tensor cores (V is bf16, so exact as an operand): P V is then within
//   ~2^-16 of the f32 product the Pallas body takes, where bf16(P) alone
//   (~2^-9) leaves small outputs more than one bf16 step off.  Masks are
//   applied only on the key tiles the band's edge crosses; tiles wholly
//   outside it are never visited.  Query tiles are launched heaviest first.
//   Registers are held to 128 a thread at hd 64 so two blocks share an SM.
// * CUDA cores (`flash_attention_kernel`, f32, and bf16 at hd 8 to 32, at
//   the (hd, hd_v) pairs of `dispatch_hd` below): one
//   block per (query tile of 64 rows, head, batch) walks the key tiles in
//   order with Q, K, V staged in shared memory as f32; each thread keeps a
//   4 x 4 tile of scores and a 4 x hd_v/16 tile of the accumulator in registers;
//   products in f32 with explicit fmaf, exactly the Pallas body's arithmetic.
//
// Both variants write each row's log-sum-exp L of the scaled scores to
// `lse` ((B, H, Sq) f32, contiguous) when the pointer is non-null, in base
// e: L = log sum_k exp(scale q.k) over the visible keys, so P = exp(scale
// q.k - L).  A row with no visible key gets L = 0 (its P is 0 by the mask).
// The backward (csrc/flash_attention_bwd.cu) reads it; serving passes null.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

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
// column reads), V tile hd_v floats a row, P tile kBK + 1 floats a row.
template <int HD, int HDV>
constexpr int smem_floats() {
  return kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HDV + kBQ * (kBK + 1);
}

// Element strides (batch, head, row) of q, k, v and out.
struct Strides {
  long long q[3], k[3], v[3], o[3];
};

template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                       int causal, int window, float scale, Strides sd) {
  constexpr int DJ = (HDV + 15) / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kBQ][HD + 1]
  float* ks = qs + kBQ * (HD + 1);         // [kBK][HD + 1]
  float* vs = ks + kBK * (HD + 1);         // [kBK][HDV]
  float* ps = vs + kBK * HDV;              // [kBQ][kBK + 1]

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
    }
    for (int e = tid; e < kBK * HDV; e += kThreads) {
      const int r = e / HDV, d = e % HDV;
      vs[r * HDV + d] = (k0 + r < Sk) ? to_f32(vg[(k0 + r) * sd.v[2] + d]) : 0.f;
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
        if (d < HDV) {
          const float vv = vs[c * HDV + d];
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
    if (lse != nullptr && tx == 0)
      lse[((long long)b * H + h) * Sq + qp] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < HDV) store(og + qp * sd.o[2] + d, acc[i][j] * inv);
    }
  }
}

template <typename T, int HD, int HDV>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int H, int Hkv, int Sq, int Sk, int causal,
                   int window, float scale, const Strides& sd, cudaStream_t st) {
  const int smem = smem_floats<HD, HDV>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD, HDV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, HD, HDV><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, H, Hkv, Sq, Sk, causal, window, scale, sd);
  return cudaGetLastError();
}

// The (hd, hd_v) pairs of the CUDA-core variant: equal widths 8 to 128, and
// MLA's (192, 128) with the reduced (24, 16) the tests' small configs give.
template <typename T>
cudaError_t dispatch_hd(int hd, int hd_v, const void* q, const void* k, const void* v,
                        void* out, float* lse, int B, int H, int Hkv, int Sq, int Sk,
                        int causal, int window, float scale, const Strides& sd,
                        cudaStream_t st) {
#define REPRO_FLASH_PAIR(A, C)                                                           \
  if (hd == A && hd_v == C)                                                             \
    return launch<T, A, C>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, causal, window, scale, sd, \
                           st);
  REPRO_FLASH_PAIR(8, 8)
  REPRO_FLASH_PAIR(16, 16)
  REPRO_FLASH_PAIR(32, 32)
  REPRO_FLASH_PAIR(64, 64)
  REPRO_FLASH_PAIR(128, 128)
  REPRO_FLASH_PAIR(24, 16)
  REPRO_FLASH_PAIR(192, 128)
#undef REPRO_FLASH_PAIR
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// Tensor-core variant: bf16 q, k, v at (hd, hd_v) (64, 64), (128, 128) or
// (192, 128).
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBK = 64;        // keys per tile

// Shared memory of the wgmma variant: Q [64 NWG rows][HD], K [2
// stages][kBK][HD] and V [2 stages][kBK][HDV], bf16, each as width / 64
// column blocks of [rows][64] in
// the 128-byte swizzle (Q and K K-major for S = Q K^T; V, rows = keys,
// MN-major for P V).  A swizzled row chunk is one 16-byte cp.async.  1024
// bytes more than the tiles: the base is rounded up to a 1024-byte boundary.
template <int HD, int HDV, int NWG>
constexpr int smem_bytes() {
  return (64 * NWG + 2 * kBK) * HD * 2 + 2 * kBK * HDV * 2 + 1024;
}

template <int HD, int HDV, int NWG, int MINB>
__global__ void __launch_bounds__(128 * NWG, MINB)
flash_attention_kernel_tc(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                          int B, int H, int Hkv,
                          int Sq, int Sk, int causal, int window, float scale_log2,
                          Strides sd) {
  constexpr int NT = 128 * NWG;    // threads: NWG warpgroups
  constexpr int BQ = 64 * NWG;     // query rows per block, 64 per warpgroup
  constexpr int NO = HDV / 8;      // n tiles of O (8 dims each)
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // [BQ][HD]
  __nv_bfloat16* ks = qs + BQ * HD;                                 // [2][kBK][HD]
  __nv_bfloat16* vs = ks + 2 * kBK * HD;                            // [2][kBK][HDV]

  // heaviest query tiles first: the light ones near the causal start fill the tail
  const int nq = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x % (B * H);
  const int q0 = (nq - 1 - blockIdx.x / (B * H)) * BQ;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const __nv_bfloat16* qg = q + b * sd.q[0] + h * sd.q[1];
  const __nv_bfloat16* kg = k + b * sd.k[0] + hk * sd.k[1];
  const __nv_bfloat16* vg = v + b * sd.v[0] + hk * sd.v[1];
  __nv_bfloat16* og = out + b * sd.o[0] + h * sd.o[1];

  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  const int g = lane >> 2, t4 = lane & 3;  // fragment row group, column pair
  const int row_w = wg * 64 + ((threadIdx.x >> 5) & 3) * 16;  // this warp's rows

  // keys this tile's rows can see: [k_lo, k_hi)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, q_last + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_lo / kBK;
  const int kt_end = k_hi > k_lo ? (k_hi - 1) / kBK + 1 : kt_begin;

  load_swizzled<HD, NT>(qs, qg, sd.q[2], q0, BQ, Sq);
  if (kt_begin < kt_end) {
    load_swizzled<HD, NT>(ks, kg, sd.k[2], kt_begin * kBK, kBK, Sk);
    load_swizzled<HDV, NT>(vs, vg, sd.v[2], kt_begin * kBK, kBK, Sk);
  }
  cp_async_commit();

  float o[HDV / 64][32];  // dims 64 h..64 h + 63: n tile j of them at o[h][4 j..]
  float m[2], l[2];  // per row half (g, g + 8): running max, this lane's sum
#pragma unroll
  for (int h2 = 0; h2 < HDV / 64; ++h2)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[h2][i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  const __nv_bfloat16* qw = qs + wg * 64 * 64;  // this warpgroup's 64 rows

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    const int k0 = kt * kBK;
    if (kt + 1 < kt_end) {  // the next tile's load overlaps this tile's products
      load_swizzled<HD, NT>(ks + (stage ^ 1) * kBK * HD, kg, sd.k[2], k0 + kBK, kBK, Sk);
      load_swizzled<HDV, NT>(vs + (stage ^ 1) * kBK * HDV, vg, sd.v[2], k0 + kBK, kBK, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: Q and this tile are in
    fence_proxy_async();  // cp.async wrote them; wgmma reads them
    __syncthreads();
    const __nv_bfloat16* kst = ks + stage * kBK * HD;
    const __nv_bfloat16* vst = vs + stage * kBK * HDV;

    // S = Q K^T: s[4 j + e] holds rows (g, g + 8) x keys k0 + 8 j + 2 t4 + {0, 1}
    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_s(s, wg_desc(qw + (kk >> 2) * BQ * 64 + (kk & 3) * 16),
              wg_desc(kst + (kk >> 2) * kBK * 64 + (kk & 3) * 16), kk);
    wg_commit();
    wg_wait_all();

    // mask (only where the band's edge crosses this tile), online softmax.
    // The row max is taken on the raw scores and scaled once (rounding is
    // monotonic, so it is the max of the scaled scores); p = exp2(s scale_log2
    // - m) is one fused multiply-add and one exp2.  Masked scores are exactly
    // kNegInf, and only an edge tile has them.
    const bool edge = k0 + kBK > Sk || q0 + BQ > Sq ||
                      (causal && k0 + kBK - 1 > q0) ||
                      (window >= 0 && k0 <= q0 + BQ - 1 - window);
    if (edge) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qp = q0 + row_w + g + 8 * ((e >> 1) & 1);
        const int kp = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
        const bool ok = kp < Sk && qp < Sq && (!causal || kp <= qp) &&
                        (window < 0 || kp > qp - window);
        s[e] = ok ? s[e] : kNegInf;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * scale_log2);
      const float corr = ex2(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float x = s[4 * j + 2 * r + c];
          float p = ex2(fmaf(x, scale_log2, -m_new));
          if (edge) p = x == kNegInf ? 0.f : p;
          s[4 * j + 2 * r + c] = p;
          sum += p;
        }
      l[r] = l[r] * corr + sum;
#pragma unroll
      for (int h2 = 0; h2 < HDV / 64; ++h2)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[h2][4 * j + 2 * r] *= corr;
          o[h2][4 * j + 2 * r + 1] *= corr;
        }
    }

    // O += P V with P = P_hi + P_lo; the S accumulators of key tiles 2 kk and
    // 2 kk + 1 are, element for element, the A fragment of keys 16 kk..16 kk + 15
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      split_pair(s[8 * kk], s[8 * kk + 1], ph[kk][0], pl[kk][0]);
      split_pair(s[8 * kk + 2], s[8 * kk + 3], ph[kk][1], pl[kk][1]);
      split_pair(s[8 * kk + 4], s[8 * kk + 5], ph[kk][2], pl[kk][2]);
      split_pair(s[8 * kk + 6], s[8 * kk + 7], ph[kk][3], pl[kk][3]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h2 = 0; h2 < HDV / 64; ++h2) {
        const uint64_t dv = wg_desc(vst + h2 * kBK * 64 + kk * 16 * 64);
        wgmma_o(o[h2], pl[kk], dv);
        wgmma_o(o[h2], ph[kk], dv);
      }
    wg_commit();
    wg_wait_all();
    __syncthreads();  // this stage is free for the load the next step issues
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qp = q0 + row_w + g + 8 * r;
    if (qp >= Sq) continue;
    // m is in units of log2: L = ln 2 (m + log2 l)
    if (lse != nullptr && t4 == 0)
      lse[((long long)b * H + h) * Sq + qp] =
          sum > 0.f ? (m[r] + log2f(sum)) * 0.6931471805599453f : 0.f;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    __nv_bfloat16* orow = og + qp * sd.o[2];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const float* oj = o[j >> 3] + 4 * (j & 7) + 2 * r;
      const uint32_t pair = pack_bf16(__float2bfloat16_rn(oj[0] * inv),
                                      __float2bfloat16_rn(oj[1] * inv));
      *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) = pair;
    }
  }
}

template <int HD, int HDV, int NWG, int MINB>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse,
                   int B, int H, int Hkv, int Sq, int Sk, int causal, int window,
                   float scale, const Strides& sd, cudaStream_t st) {
  constexpr int smem = smem_bytes<HD, HDV, NWG>();
  static_assert(smem <= 232448, "a block may have 227 KB of shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel_tc<HD, HDV, NWG, MINB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)((Sq + 64 * NWG - 1) / (64 * NWG)) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_kernel_tc<HD, HDV, NWG, MINB><<<(unsigned)blocks, 128 * NWG, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), lse, B, H,
      Hkv, Sq, Sk, causal, window, scale * 1.4426950408889634f, sd);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace repro_torch

// hd: q's and k's head width; hd_v: v's and out's.  lse: null, or (B, H, Sq)
// f32 for each row's log-sum-exp (base e; see the header).  dtype: 0 = float32, 1 =
// bfloat16.  variant: 0 = CUDA cores, 1 = tensor cores (bf16 at (hd, hd_v) =
// (64, 64), (128, 128) or (192, 128) only; rows 16-byte aligned).  window < 0 means
// no window.  strides: 12 element strides, (batch, head, row) of q, k, v and
// out in that order.  Returns the CUDA error of the launch (0 on success);
// runs on `stream`.
extern "C" int repro_torch_flash_attention(const void* q, const void* k,
                                           const void* v, void* out, float* lse, int B,
                                           int H, int Hkv, int Sq, int Sk,
                                           int hd, int hd_v, int causal, int window,
                                           float scale, int dtype, int variant,
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
  if (variant == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (hd == 64 && hd_v == 64)
      return (int)repro_torch::tc::launch<64, 64, 2, 2>(q, k, v, out, lse, B, H, Hkv, Sq,
                                                        Sk, causal, window, scale, sd, st);
    if (hd == 128 && hd_v == 128)
      return (int)repro_torch::tc::launch<128, 128, 4, 1>(q, k, v, out, lse, B, H, Hkv, Sq,
                                                          Sk, causal, window, scale, sd, st);
    if (hd == 192 && hd_v == 128)
      return (int)repro_torch::tc::launch<192, 128, 4, 1>(q, k, v, out, lse, B, H, Hkv, Sq,
                                                          Sk, causal, window, scale, sd, st);
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err =
      dtype == 0
          ? repro_torch::dispatch_hd<float>(hd, hd_v, q, k, v, out, lse, B, H, Hkv, Sq,
                                            Sk, causal, window, scale, sd, st)
          : repro_torch::dispatch_hd<__nv_bfloat16>(hd, hd_v, q, k, v, out, lse, B, H,
                                                    Hkv, Sq, Sk, causal, window, scale,
                                                    sd, st);
  return (int)err;
}
