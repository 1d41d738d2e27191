// Batched modified Stoer-Wagner solve (MCOP, paper Algorithms 1-3) for Hopper.
//
// Replaces the TPU kernel `mcop_stoer_wagner_kernel` (its `_sw_call` /
// `_solve_graph` body) of the JAX package's kernels/mcop_phase.py: per graph,
// fold the pinned vertices into the anchor, run one MinCutPhase per surviving
// vertex, keep the best Eq.-10 cut and its cloud side, merge (s, t).
//
// What bounds it on this card: neither bytes nor arithmetic but latency.  A
// graph is read once (4 n^2 bytes) and then costs sum(n_alive - 1) ~ n^2 / 2
// dependent absorb steps, each a block-wide argmax plus one row add of n
// floats, with a barrier in between.  The design therefore puts one thread
// block on each graph, keeps the mutable adjacency private to the block (in
// shared memory while 4 n^2 plus the vectors fit in the opt-in limit,
// otherwise in a per-block scratch matrix that stays hot in L2), spends one
// barrier per absorb step, and lets every resident block walk over several
// graphs so that the scratch is sized by the card, not by the batch.  Rows
// are indexed directly (A[v * n + j]); the one-hot reductions and
// identity-mask transposes of the TPU body have no counterpart here, and the
// n x n membership matrix is a label vector.
#include "sw_common.cuh"

namespace repro_torch {

template <bool kAdjShared>
__global__ void mcop_sw_kernel(const float* __restrict__ adj,
                               const float* __restrict__ w_local,
                               const float* __restrict__ w_cloud,
                               const uint8_t* __restrict__ pinned,
                               float* __restrict__ cuts,
                               uint8_t* __restrict__ masks,
                               float* __restrict__ scratch, int batch, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Workspace ws = carve_workspace(smem, n);
  float* A = kAdjShared
                 ? reinterpret_cast<float*>(smem + workspace_bytes(n))
                 : scratch + (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    const float* src_adj = adj + (size_t)b * n * n;
    for (int e = tid; e < n * n; e += nt) A[e] = src_adj[e];
    for (int j = tid; j < n; j += nt) {
      ws.wl[j] = w_local[(size_t)b * n + j];
      ws.wc[j] = w_cloud[(size_t)b * n + j];
      ws.in_a[j] = pinned[(size_t)b * n + j] ? 1 : 0;
    }
    solve_graph(A, ws, n, cuts + b, masks + (size_t)b * n);
  }
}

}  // namespace repro_torch

using repro_torch::Plan;

// Launch geometry for n-vertex graphs: out[0] threads, out[1] 1 if the
// adjacency lives in shared memory, out[2] dynamic shared bytes, out[3] blocks
// the card keeps resident (the grid is min(batch, that); the caller sizes the
// scratch as grid * n * n floats when out[1] is 0).
extern "C" int repro_torch_sw_plan(int n, int* out) {
  Plan p;
  cudaError_t err = repro_torch::make_plan(n, repro_torch::mcop_sw_kernel<true>,
                                           repro_torch::mcop_sw_kernel<false>, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.threads;
  out[1] = p.adj_in_smem;
  out[2] = p.smem_bytes;
  out[3] = p.resident_blocks;
  return 0;
}

extern "C" int repro_torch_sw_solve(const float* adj, const float* w_local,
                                    const float* w_cloud, const uint8_t* pinned,
                                    float* cuts, uint8_t* masks, float* scratch,
                                    int batch, int n, int grid, int threads,
                                    int adj_in_smem, int smem_bytes,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (adj_in_smem)
    repro_torch::mcop_sw_kernel<true><<<grid, threads, smem_bytes, st>>>(
        adj, w_local, w_cloud, pinned, cuts, masks, scratch, batch, n);
  else
    repro_torch::mcop_sw_kernel<false><<<grid, threads, smem_bytes, st>>>(
        adj, w_local, w_cloud, pinned, cuts, masks, scratch, batch, n);
  return (int)cudaGetLastError();
}
