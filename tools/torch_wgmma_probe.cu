// Which descriptor fields make wgmma read a no-swizzle shared-memory operand
// right: one warpgroup multiplies 64 x 64 bf16 matrices laid out in 8 x 8
// core matrices, for every (layout, LBO, SBO) candidate, and the caller
// compares D with torch.  Built and driven by tools/torch_kernel_probe.py
// (subcommand wgmma-layout); not part of the package.
//
// which 0: D = A . Bt^T with A and Bt K-major, both from shared memory.
// which 1: D = A . B with A from registers (the mma.sync m16n8k16 fragment
//          layout, per warp) and B MN-major in shared memory.
// which 2, 3: as 0 and 1 with the operands in shared memory 128-byte swizzled.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint64_t make_desc(const void* p, int lbo, int sbo, int swz = 0) {
  const uint32_t a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swz << 62);
}
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

// element (r, c) of a [R=64][C=64] matrix with 8x8 cores (rows r8 of 8, cols c8 of 8 elements):
// layout 0: core (r8, c8) at (r8 * 8 + c8) * 128 B; layout 1: at (c8 * 8 + r8) * 128 B.
__device__ __forceinline__ int off(int r, int c, int layout) {
  const int core = layout == 0 ? (r / 8) * 8 + c / 8 : (c / 8) * 8 + r / 8;
  return core * 64 + (r % 8) * 8 + c % 8;  // in elements
}

__device__ void store_d(const float (&d)[32], float* D) {
  const int t = threadIdx.x, w = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  for (int j = 0; j < 8; ++j) {
    const int r = 16 * w + g, c = 8 * j + 2 * q;
    D[r * 64 + c] = d[4 * j];
    D[r * 64 + c + 1] = d[4 * j + 1];
    D[(r + 8) * 64 + c] = d[4 * j + 2];
    D[(r + 8) * 64 + c + 1] = d[4 * j + 3];
  }
}

// D = A (64 x 64, row-major, K-major) . Bt^T, Bt (64 N x 64 K row-major, K-major)
__global__ void probe_ss_k(const __nv_bfloat16* A, const __nv_bfloat16* Bt, float* D,
                           int layout, int lbo, int sbo, int kstep_bytes) {
  __shared__ __align__(128) __nv_bfloat16 as[2 * 64 * 64], bs[2 * 64 * 64];
  for (int e = threadIdx.x; e < 4096; e += 128) {
    as[off(e / 64, e % 64, layout)] = A[e];
    bs[off(e / 64, e % 64, layout)] = Bt[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence();
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(d, make_desc(reinterpret_cast<const char*>(as) + kk * kstep_bytes, lbo, sbo),
                make_desc(reinterpret_cast<const char*>(bs) + kk * kstep_bytes, lbo, sbo), 1);
  commit();
  wait0();
  store_d(d, D);
}

// D = A (64 x 64 K, row-major; A from registers) . B, B (64 K x 64 N row-major: MN-major)
__global__ void probe_rs_mn(const __nv_bfloat16* A, const __nv_bfloat16* B, float* D,
                            int layout, int lbo, int sbo, int kstep_bytes) {
  __shared__ __align__(128) __nv_bfloat16 bs[4 * 64 * 64];
  // B stored as cores of 8 k-rows x 8 n: element (k, n) -> off(n, k) with rows = n
  // blocks: core (n8, k8), inside it row = k % 8, 8 n values
  for (int e = threadIdx.x; e < 4096; e += 128) {
    const int k = e / 64, n = e % 64;
    const int core = layout == 0 ? (k / 8) * 8 + n / 8 : (n / 8) * 8 + k / 8;
    bs[core * 64 + (k % 8) * 8 + n % 8] = B[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int t = threadIdx.x, w = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence();
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    const int r = 16 * w + g, c = 16 * kk + 2 * q;
    auto pk = [&](int rr, int cc) {
      return (uint32_t)__bfloat16_as_ushort(A[rr * 64 + cc]) |
             ((uint32_t)__bfloat16_as_ushort(A[rr * 64 + cc + 1]) << 16);
    };
    a[0] = pk(r, c); a[1] = pk(r + 8, c); a[2] = pk(r, c + 8); a[3] = pk(r + 8, c + 8);
    wgmma_rs<1>(d, a, make_desc(reinterpret_cast<const char*>(bs) + kk * kstep_bytes, lbo, sbo), 1);
  }
  commit();
  wait0();
  store_d(d, D);
}

// 128-byte swizzle: row r of 64 bf16 (128 bytes) at r * 128, its 16-byte
// chunk c at chunk c ^ (r % 8); layout type 1 in the descriptor.
__device__ __forceinline__ int swz(int r, int c) { return r * 64 + ((c / 8) ^ (r % 8)) * 8 + c % 8; }

// which 2: as which 0 with both operands 128-byte swizzled (rows = M or N).
__global__ void probe_ss_k_sw128(const __nv_bfloat16* A, const __nv_bfloat16* Bt, float* D,
                                 int lbo, int sbo, int kstep_bytes) {
  __shared__ __align__(1024) __nv_bfloat16 as[2 * 64 * 64], bs[2 * 64 * 64];
  for (int e = threadIdx.x; e < 4096; e += 128) {
    as[swz(e / 64, e % 64)] = A[e];
    bs[swz(e / 64, e % 64)] = Bt[e];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence();
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss<0>(d, make_desc(reinterpret_cast<const char*>(as) + kk * kstep_bytes, lbo, sbo, 1),
                make_desc(reinterpret_cast<const char*>(bs) + kk * kstep_bytes, lbo, sbo, 1), 1);
  commit();
  wait0();
  store_d(d, D);
}

// which 3: as which 1 with B (rows = K, 64 N a row) 128-byte swizzled.
__global__ void probe_rs_mn_sw128(const __nv_bfloat16* A, const __nv_bfloat16* B, float* D,
                                  int lbo, int sbo, int kstep_bytes) {
  __shared__ __align__(1024) __nv_bfloat16 bs[4 * 64 * 64];
  for (int e = threadIdx.x; e < 4096; e += 128) bs[swz(e / 64, e % 64)] = B[e];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int t = threadIdx.x, w = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  float d[32];
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence();
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t a[4];
    const int r = 16 * w + g, c = 16 * kk + 2 * q;
    auto pk = [&](int rr, int cc) {
      return (uint32_t)__bfloat16_as_ushort(A[rr * 64 + cc]) |
             ((uint32_t)__bfloat16_as_ushort(A[rr * 64 + cc + 1]) << 16);
    };
    a[0] = pk(r, c); a[1] = pk(r + 8, c); a[2] = pk(r, c + 8); a[3] = pk(r + 8, c + 8);
    wgmma_rs<1>(d, a, make_desc(reinterpret_cast<const char*>(bs) + kk * kstep_bytes, lbo, sbo, 1), 1);
  }
  commit();
  wait0();
  store_d(d, D);
}

extern "C" int probe(int which, const void* A, const void* B, float* D, int layout, int lbo,
                     int sbo, int kstep) {
  const __nv_bfloat16* a = (const __nv_bfloat16*)A;
  const __nv_bfloat16* b = (const __nv_bfloat16*)B;
  if (which == 0) probe_ss_k<<<1, 128>>>(a, b, D, layout, lbo, sbo, kstep);
  else if (which == 1) probe_rs_mn<<<1, 128>>>(a, b, D, layout, lbo, sbo, kstep);
  else if (which == 2) probe_ss_k_sw128<<<1, 128>>>(a, b, D, lbo, sbo, kstep);
  else probe_rs_mn_sw128<<<1, 128>>>(a, b, D, lbo, sbo, kstep);
  cudaError_t e = cudaDeviceSynchronize();
  return (int)(e == cudaSuccess ? cudaGetLastError() : e);
}
