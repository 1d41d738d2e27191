// Latency of the warp operations an MCOP absorb step chains together, on
// one warp alone on its SM: each test runs `iters` dependent operations
// and reports SM clock cycles per operation (clock64 around the loop).
// Built and run by tools/torch_kernel_probe.py (probe "mcop-variants").
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int kWhich>
__device__ __forceinline__ unsigned step(unsigned x, unsigned lane, const unsigned* ring) {
  switch (kWhich) {
    case 0: return __reduce_max_sync(0xffffffffu, x + lane);         // redux.sync max
    case 1: return __reduce_min_sync(0xffffffffu, x ^ lane);         // redux.sync min
    case 2: return __shfl_xor_sync(0xffffffffu, x, 1) + 1;           // shfl
    case 3: return __ballot_sync(0xffffffffu, (x + lane) & 1) + x;   // vote
    case 4: return ring[x & 1023];                                  // lds chase
    default: return x * 3 + 1;                                      // imad
  }
}

template <int kWhich>
__global__ void latency_kernel(int iters, long long* cycles, unsigned* sink) {
  __shared__ unsigned ring[1024];
  const unsigned lane = threadIdx.x;
  for (int i = lane; i < 1024; i += 32) ring[i] = (i * 97 + 13) & 1023;
  __syncwarp();
  unsigned x = lane;
  const long long t0 = clock64();
  for (int i = 0; i < iters; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) x = step<kWhich>(x, lane, ring);
  }
  const long long t1 = clock64();
  if (lane == 0) *cycles = t1 - t0;
  sink[lane] = x;
}

}  // namespace

// Cycles for `iters` (a multiple of 8) dependent operations of kind `which`
// (0 redux max, 1 redux min, 2 shfl, 3 ballot, 4 shared-memory load, 5 imad).
extern "C" int latency_probe(int which, int iters, long long* cycles, unsigned* sink) {
  switch (which) {
    case 0: latency_kernel<0><<<1, 32>>>(iters, cycles, sink); break;
    case 1: latency_kernel<1><<<1, 32>>>(iters, cycles, sink); break;
    case 2: latency_kernel<2><<<1, 32>>>(iters, cycles, sink); break;
    case 3: latency_kernel<3><<<1, 32>>>(iters, cycles, sink); break;
    case 4: latency_kernel<4><<<1, 32>>>(iters, cycles, sink); break;
    default: latency_kernel<5><<<1, 32>>>(iters, cycles, sink); break;
  }
  return (int)cudaGetLastError();
}
