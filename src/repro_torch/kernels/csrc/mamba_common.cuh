// Building blocks shared by B5 (csrc/mamba_scan.cu) and its backward
// (csrc/mamba_scan_bwd.cu): cp.async staging of f32 tiles, 3xTF32
// mma.sync products, the chunk's cumulative sum, and the Gram pass G = C B^T.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kMaxQ = 256;     // steps of a chunk
constexpr int kMaxPN = 64;     // P and N are zero-padded to this
constexpr int kTile = 64;      // gram tiles and states s tiles
constexpr int kLd = kMaxPN + 4;   // row of a [.][P or N] tile read as A rows
constexpr int kLdT = kMaxPN + 8;  // row of a tile read down its columns
constexpr int kGemmThreads = 128; // gram, states: 4 warps
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x kMaxPN floats into shared rows of `ld` floats: row r from
// src + r * stride, `cols` valid columns; rows at or past `valid_rows` and
// columns at or past `cols` are zero-filled.  All `nthreads` threads take part.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long stride, int rows, int valid_rows,
                                          int cols, bool vec4, int nthreads) {
  if (vec4) {
    constexpr int kChunks = kMaxPN / 4;
    for (int e = threadIdx.x; e < rows * kChunks; e += nthreads) {
      const int r = e / kChunks, c = 4 * (e % kChunks);
      const bool in = r < valid_rows && c < cols;
      cp_async16(smem_addr(dst + r * ld + c), src + (in ? r * stride + c : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < rows * kMaxPN; e += nthreads) {
      const int r = e / kMaxPN, c = e % kMaxPN;
      const bool in = r < valid_rows && c < cols;
      cp_async4(smem_addr(dst + r * ld + c), src + (in ? r * stride + c : 0), in);
    }
  }
}

// 2^x by the SFU (relative error ~2^-22; results below 2^-126 flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// a = hi + lo, each with the low 13 of its 23 mantissa bits clear (TF32):
// hi holds a's top 10 bits, lo the top 10 of what is left.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(a) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of one k step for NJ n tiles of 8, split: b[j] = {hi b0, hi b1,
// lo b0, lo b1}.
template <int NJ>
struct BSplit {
  uint32_t v[NJ][4];
};

// acc[j] += a . b[j] for j < NJ with a (16 x 8) and b[j] (8 x 8) given
// split: all a_lo b_hi products, then all a_hi b_lo, then all a_hi b_hi, so
// that no product waits on the one before it (each j is a chain of three).
template <int NJ>
__device__ __forceinline__ void mma_3xtf32_row(float (&acc)[NJ][4], const uint32_t (&ah)[4],
                                               const uint32_t (&al)[4], const BSplit<NJ>& b) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], al, b.v[j][0], b.v[j][1]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], ah, b.v[j][2], b.v[j][3]);
#pragma unroll
  for (int j = 0; j < NJ; ++j) mma_tf32(acc[j], ah, b.v[j][0], b.v[j][1]);
}

// Inclusive cumsum of a chunk's Q log decays (ld[t] at ldc[t * st]) into
// cum[0..Q); cum[Q..Qpad) = cum[Q - 1].  Run by one whole warp: lane l sums
// steps 8 l..8 l + 7 in order, then the lanes' totals are scanned.  Every
// pass computes cum with this one function, so they agree bit for bit.
__device__ __forceinline__ void chunk_cumsum(const float* ldc, long long st, int Q,
                                             int Qpad, float* cum) {
  const int lane = threadIdx.x & 31;
  float v[8];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = 8 * lane + i;
    run += t < Q ? ldc[t * st] : 0.f;
    v[i] = run;
  }
  float pre = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, pre, off);
    if (lane >= off) pre += n;
  }
  pre = __shfl_up_sync(0xffffffffu, pre, 1);  // exclusive: the lanes before this one
  if (lane == 0) pre = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = 8 * lane + i;
    if (t < Q) cum[t] = v[i] + pre;
  }
  __syncwarp();
  for (int t = Q + lane; t < Qpad; t += 32) cum[t] = cum[Q - 1];
}

// ---- 1. gram: G[b, c] = C B^T, lower-triangular 64 x 64 tiles -------------
// grid (tiles, B NC); G is (B NC, Qg, Qg) with Qg = Q rounded up to 64.
// S: any strides struct with the (batch, chunk, step) strides bm[3], cm[3].
template <class S>
__global__ void __launch_bounds__(kGemmThreads)
mamba_scan_kernel_gram(const float* __restrict__ bm, const float* __restrict__ cm,
                       float* __restrict__ gram, int NC, int Q, int N, int Qg,
                       int vec4, S sd) {
  __shared__ __align__(16) float cs[kTile * kLd];
  __shared__ __align__(16) float bs[kTile * kLd];
  int ti = 0, si = blockIdx.x;  // the blockIdx.x-th tile of the lower triangle
  while (si > ti) si -= ++ti;
  const int b = blockIdx.y / NC, c = blockIdx.y % NC;
  const int t0 = ti * kTile, s0 = si * kTile;
  load_tile(cs, kLd, cm + b * sd.cm[0] + c * sd.cm[1] + t0 * sd.cm[2], sd.cm[2], kTile,
            Q - t0, N, vec4, kGemmThreads);
  load_tile(bs, kLd, bm + b * sd.bm[0] + c * sd.bm[1] + s0 * sd.bm[2], sd.bm[2], kTile,
            Q - s0, N, vec4, kGemmThreads);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp;
  float acc[8][4] = {};
#pragma unroll
  for (int kk = 0; kk < kMaxPN / 8; ++kk) {
    uint32_t ah[4], al[4];
    const float* a = cs + (r0 + g) * kLd + 8 * kk + t;
    split_tf32(a[0], ah[0], al[0]);
    split_tf32(a[8 * kLd], ah[1], al[1]);
    split_tf32(a[4], ah[2], al[2]);
    split_tf32(a[8 * kLd + 4], ah[3], al[3]);
    BSplit<8> bf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* bp = bs + (8 * j + g) * kLd + 8 * kk + t;
      split_tf32(bp[0], bf.v[j][0], bf.v[j][2]);
      split_tf32(bp[4], bf.v[j][1], bf.v[j][3]);
    }
    mma_3xtf32_row(acc, ah, al, bf);
  }
  float* gt = gram + ((long long)blockIdx.y * Qg + t0 + r0 + g) * Qg + s0 + 2 * t;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    *reinterpret_cast<float2*>(gt + 8 * j) = make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(gt + 8 * Qg + 8 * j) = make_float2(acc[j][2], acc[j][3]);
  }
}

}  // namespace repro_torch
