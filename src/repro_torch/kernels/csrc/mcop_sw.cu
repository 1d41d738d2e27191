// Batched modified Stoer-Wagner solve (MCOP, paper Algorithms 1-3) for Hopper.
//
// Replaces the TPU kernel `mcop_stoer_wagner_kernel` (its `_sw_call` /
// `_solve_graph` body) of the JAX package's kernels/mcop_phase.py: per graph,
// fold the pinned vertices into the anchor, run one MinCutPhase per surviving
// vertex, keep the best Eq.-10 cut and its cloud side, merge (s, t).
//
// What bounds it on this card: neither bytes nor arithmetic but latency.  A
// graph is read once (4 n^2 bytes) and then costs sum(n_alive - 1) ~ n^2 / 2
// dependent absorb steps, each an argmax over the graph's vertices followed
// by one row read.  The design makes that chain as short as the card allows:
// up to the packed limit (n = 341 at 227 KB) one warp solves one graph, its
// adjacency kept on chip as the packed upper triangle of the symmetric matrix
// (8 KB at n = 64, 130 560 bytes at n = 256), staged by 4-byte cp.async copies
// all in flight at once, and its per-vertex vectors in registers
// (sw_common.cuh:solve_graph_warp).  An absorb step is two redux.sync and one
// shared-memory row read, with no barrier; several graphs share a block, one
// per warp, and each warp walks over graphs until the batch is done.  Above
// the packed limit one block solves a graph in a per-block scratch matrix in
// device memory, with one barrier per absorb step (solve_graph).  The warp
// variant reads the upper triangle only, so it needs an exactly symmetric
// adjacency with a zero diagonal.  A WCG is symmetric only to a tolerance, so
// the host sends a bucket that is not exactly symmetric to the block variant
// at any n (repro_torch_sw_plan_rows): it reads full rows and merges rows and
// columns as the reference does.  Rows are indexed directly; the one-hot
// reductions and identity-mask transposes of the TPU body have no
// counterpart here, and the n x n membership matrix is a label vector.
#include "sw_common.cuh"

namespace repro_torch {

// Issue the copies of graph `adj`'s upper triangle into the warp's packed
// matrix, one 4-byte cp.async per element (rows are not 16-byte aligned in
// the packed layout); the caller waits.
__device__ inline void stage_triangle(float* P, const float* adj, int n, int lane) {
  for (int i = 0; i < n - 1; ++i) {
    const int ri = tri_row(i, n);
    const float* row = adj + (size_t)i * n;
    for (int j = i + 1 + lane; j < n; j += 32) cp_async4(P + ri + j, row + j);
  }
}

template <int CPL>
__global__ void __launch_bounds__(kMaxGraphsPerBlock * 32, 1)
    mcop_sw_warp_kernel(const float* __restrict__ adj, const float* __restrict__ w_local,
                        const float* __restrict__ w_cloud,
                        const uint8_t* __restrict__ pinned, float* __restrict__ cuts,
                        uint8_t* __restrict__ masks, int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gpb = blockDim.x >> 5;
  float* P = reinterpret_cast<float*>(smem + warp * tri_bytes(n));
  for (int b = blockIdx.x * gpb + warp; b < batch; b += gridDim.x * gpb) {
    stage_triangle(P, adj + (size_t)b * n * n, n, lane);
    float wl[CPL], wc[CPL];
    uint32_t pin = 0;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      wl[k] = 0.f;
      wc[k] = 0.f;
      if (j >= n) continue;
      wl[k] = w_local[(size_t)b * n + j];
      wc[k] = w_cloud[(size_t)b * n + j];
      if (pinned[(size_t)b * n + j]) pin |= 1u << k;
    }
    cp_async_wait_all();
    __syncwarp();
    solve_graph_warp<CPL>(P, n, lane, wl, wc, pin, cuts + b, masks + (size_t)b * n);
  }
}

template <bool FULL>
__global__ void mcop_sw_block_kernel(const float* __restrict__ adj,
                                     const float* __restrict__ w_local,
                                     const float* __restrict__ w_cloud,
                                     const uint8_t* __restrict__ pinned,
                                     float* __restrict__ cuts, uint8_t* __restrict__ masks,
                                     float* __restrict__ scratch, int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Workspace ws = carve_workspace(smem, n);
  float* A = scratch + (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    const float* src_adj = adj + (size_t)b * n * n;
    for (int e = tid; e < n * n; e += nt) A[e] = src_adj[e];
    for (int j = tid; j < n; j += nt) {
      ws.wl[j] = w_local[(size_t)b * n + j];
      ws.wc[j] = w_cloud[(size_t)b * n + j];
      ws.in_a[j] = pinned[(size_t)b * n + j] ? 1 : 0;
    }
    solve_graph<FULL>(A, ws, n, cuts + b, masks + (size_t)b * n);
  }
}

inline const void* warp_kernel(int cpl) {
  switch (cpl) {
    case 1: return (const void*)mcop_sw_warp_kernel<1>;
    case 2: return (const void*)mcop_sw_warp_kernel<2>;
    case 4: return (const void*)mcop_sw_warp_kernel<4>;
    case 8: return (const void*)mcop_sw_warp_kernel<8>;
    case 11: return (const void*)mcop_sw_warp_kernel<11>;
    default: return nullptr;
  }
}

}  // namespace repro_torch

using repro_torch::Plan;

// Largest n the warp variant takes on this device (its packed limit).
extern "C" int repro_torch_sw_packed_limit(int* out) {
  int smem_optin = 0, sms = 0;
  cudaError_t err = repro_torch::device_limits(&smem_optin, &sms);
  if (err != cudaSuccess) return (int)err;
  *out = repro_torch::packed_limit(smem_optin);
  return 0;
}

// Launch geometry for a batch of n-vertex graphs: out[0] columns a lane (0 =
// the block variant with a scratch matrix), out[1] threads, out[2] dynamic
// shared bytes, out[3] blocks the card keeps resident, out[4] graphs a block.
// The grid is min(ceil(batch / out[4]), out[3]); the caller sizes the scratch
// as grid * n * n floats when out[0] is 0.  graphs_per_block > 0 asks for
// that many (warp variant only; the result does not depend on it).
extern "C" int repro_torch_sw_plan(int n, int batch, int graphs_per_block, int* out) {
  Plan p;
  cudaError_t err = repro_torch::make_plan(
      n, batch, graphs_per_block, repro_torch::warp_kernel(repro_torch::warp_cpl(n)),
      (const void*)repro_torch::mcop_sw_block_kernel<false>, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.cpl;
  out[1] = p.threads;
  out[2] = p.smem_bytes;
  out[3] = p.resident_blocks;
  out[4] = p.graphs_per_block;
  return 0;
}

// The same for the full-row block variant at any n: the plan of a batch
// whose adjacencies are not all exactly symmetric (out[0] is 0; launch it
// with full_rows set).
extern "C" int repro_torch_sw_plan_rows(int n, int batch, int* out) {
  Plan p;
  cudaError_t err = repro_torch::make_plan(
      n, batch, 0, nullptr, (const void*)repro_torch::mcop_sw_block_kernel<true>, &p, true);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.cpl;
  out[1] = p.threads;
  out[2] = p.smem_bytes;
  out[3] = p.resident_blocks;
  out[4] = p.graphs_per_block;
  return 0;
}

extern "C" int repro_torch_sw_solve(const float* adj, const float* w_local,
                                    const float* w_cloud, const uint8_t* pinned,
                                    float* cuts, uint8_t* masks, float* scratch,
                                    int batch, int n, int grid, int threads, int cpl,
                                    int smem_bytes, int full_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cpl) {
#define REPRO_SW_WARP(C)                                                         \
  case C:                                                                        \
    repro_torch::mcop_sw_warp_kernel<C><<<grid, threads, smem_bytes, st>>>(      \
        adj, w_local, w_cloud, pinned, cuts, masks, batch, n);                   \
    break;
    REPRO_SW_WARP(1)
    REPRO_SW_WARP(2)
    REPRO_SW_WARP(4)
    REPRO_SW_WARP(8)
    REPRO_SW_WARP(11)
#undef REPRO_SW_WARP
    case 0:
      if (full_rows)
        repro_torch::mcop_sw_block_kernel<true><<<grid, threads, smem_bytes, st>>>(
            adj, w_local, w_cloud, pinned, cuts, masks, scratch, batch, n);
      else
        repro_torch::mcop_sw_block_kernel<false><<<grid, threads, smem_bytes, st>>>(
            adj, w_local, w_cloud, pinned, cuts, masks, scratch, batch, n);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
