// Fused WCG build + modified Stoer-Wagner solve for Hopper.
//
// Replaces the TPU kernel `mcop_fused_solve_kernel` (its `_fused_call` /
// `_kernel_weights` body) of the JAX package's kernels/mcop_phase.py: each
// warp (up to the packed limit) or block (above it) builds one environment's
// Eq. 4 / 6 / 8 weights from the shared application profile straight into
// its private working adjacency and then runs the same solve as mcop_sw.cu
// (sw_common.cuh: solve_graph_warp on the packed upper triangle in shared
// memory, or solve_graph on a scratch matrix).  Per graph only six floats
// come in and 1 + n go out; the (K, n, n) adjacency batch is never written to
// device memory.
//
// What bounds it on this card: the same dependent chain of ~n^2 / 2 absorb
// steps as mcop_sw.cu.  The profile (t_local, data_in, data_out: 8 n^2 + 4 n
// bytes) is read by every graph but is shared, so after the first wave it
// comes from L2.  The build reads data[j * n + i] directly where the TPU body
// needed pre-transposed copies, and computes element (i, j) once for both
// halves (the value is symmetric).  Arithmetic keeps the association of the
// host cost models, (in/b_up + out/b_down) + its transpose, and is compiled
// without fused multiply-add so that it rounds like the plain version.
#include "sw_common.cuh"

namespace repro_torch {

enum Kind { kTime = 0, kEnergy = 1, kWeighted = 2 };

struct EnvRow {
  float b_up, b_down, speedup, p_c, p_i, p_tr;
};

__device__ inline EnvRow env_row(const float* env, int b) {
  const float* r = env + (size_t)b * 6;
  return {r[0], r[1], r[2], r[3], r[4], r[5]};
}

// Eq. 4 / 6 / 8 node weights of vertex j.
__device__ inline void node_weights(const EnvRow& e, float t, int kind, float w,
                                    float t_norm, float e_norm, float* wl, float* wc) {
  const float omw = 1.0f - w;
  const float wc_t = t / e.speedup;
  const float wl_e = e.p_c * t;
  const float wc_e = e.p_i * wc_t;
  *wl = t;
  *wc = wc_t;
  if (kind == kEnergy) {
    *wl = wl_e;
    *wc = wc_e;
  } else if (kind == kWeighted) {
    *wl = (w * t) / t_norm + (omw * wl_e) / e_norm;
    *wc = (w * wc_t) / t_norm + (omw * wc_e) / e_norm;
  }
}

// Eq. 1 (symmetrised) priced by the cost model: the weight of edge (i, j).
__device__ inline float edge_weight(const EnvRow& e, const float* data_in,
                                    const float* data_out, int i, int j, int n, int kind,
                                    float w, float t_norm, float e_norm) {
  const float per_dir = data_in[i * n + j] / e.b_up + data_out[i * n + j] / e.b_down;
  const float per_dir_t = data_in[j * n + i] / e.b_up + data_out[j * n + i] / e.b_down;
  const float adj_t = per_dir + per_dir_t;
  if (kind == kEnergy) return e.p_tr * adj_t;
  if (kind == kWeighted) return (w * adj_t) / t_norm + ((1.0f - w) * (e.p_tr * adj_t)) / e_norm;
  return adj_t;
}

template <int CPL>
__global__ void __launch_bounds__(kMaxGraphsPerBlock * 32, 1)
    mcop_fused_warp_kernel(const float* __restrict__ t_local,
                           const float* __restrict__ data_in,
                           const float* __restrict__ data_out,
                           const uint8_t* __restrict__ pinned,
                           const float* __restrict__ env, float* __restrict__ cuts,
                           uint8_t* __restrict__ masks, int batch, int n, int kind,
                           float omega) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, gpb = blockDim.x >> 5;
  float* P = reinterpret_cast<float*>(smem + warp * tri_bytes(n));
  for (int b = blockIdx.x * gpb + warp; b < batch; b += gridDim.x * gpb) {
    const EnvRow e = env_row(env, b);
    // Eq. 8 normalisers: T_local and E_local of this environment.
    float t_norm = 1.f, e_norm = 1.f;
    if (kind == kWeighted) {
      float pt = 0.f, pe = 0.f;
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int j = lane + 32 * k;
        if (j >= n) continue;
        pt += t_local[j];
        pe += e.p_c * t_local[j];
      }
      t_norm = fmaxf(warp_sum(pt), 1e-30f);
      e_norm = fmaxf(warp_sum(pe), 1e-30f);
    }
    float wl[CPL], wc[CPL];
    uint32_t pin = 0;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      wl[k] = 0.f;
      wc[k] = 0.f;
      if (j >= n) continue;
      node_weights(e, t_local[j], kind, omega, t_norm, e_norm, &wl[k], &wc[k]);
      if (pinned[j]) pin |= 1u << k;
    }
    for (int i = 0; i < n - 1; ++i) {
      const int ri = tri_row(i, n);
      for (int j = i + 1 + lane; j < n; j += 32)
        P[ri + j] = edge_weight(e, data_in, data_out, i, j, n, kind, omega, t_norm, e_norm);
    }
    __syncwarp();
    solve_graph_warp<CPL>(P, n, lane, wl, wc, pin, cuts + b, masks + (size_t)b * n);
  }
}

__global__ void mcop_fused_block_kernel(const float* __restrict__ t_local,
                                        const float* __restrict__ data_in,
                                        const float* __restrict__ data_out,
                                        const uint8_t* __restrict__ pinned,
                                        const float* __restrict__ env,
                                        float* __restrict__ cuts,
                                        uint8_t* __restrict__ masks,
                                        float* __restrict__ scratch, int batch, int n,
                                        int kind, float omega) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Workspace ws = carve_workspace(smem, n);
  float* A = scratch + (size_t)blockIdx.x * n * n;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int b = blockIdx.x; b < batch; b += gridDim.x) {
    const EnvRow e = env_row(env, b);
    float t_norm = 1.f, e_norm = 1.f;
    if (kind == kWeighted) {
      float pt = 0.f, pe = 0.f;
      for (int j = tid; j < n; j += nt) {
        pt += t_local[j];
        pe += e.p_c * t_local[j];
      }
      t_norm = fmaxf(block_sum(pt, ws.red_sum), 1e-30f);
      e_norm = fmaxf(block_sum(pe, ws.red_sum), 1e-30f);
    }
    for (int j = tid; j < n; j += nt) {
      node_weights(e, t_local[j], kind, omega, t_norm, e_norm, &ws.wl[j], &ws.wc[j]);
      ws.in_a[j] = pinned[j] ? 1 : 0;
    }
    for (int x = tid; x < n * n; x += nt) {
      const int i = x / n, j = x - i * n;
      A[x] = edge_weight(e, data_in, data_out, i, j, n, kind, omega, t_norm, e_norm);
    }
    solve_graph<false>(A, ws, n, cuts + b, masks + (size_t)b * n);
  }
}

inline const void* warp_kernel(int cpl) {
  switch (cpl) {
    case 1: return (const void*)mcop_fused_warp_kernel<1>;
    case 2: return (const void*)mcop_fused_warp_kernel<2>;
    case 4: return (const void*)mcop_fused_warp_kernel<4>;
    case 8: return (const void*)mcop_fused_warp_kernel<8>;
    case 11: return (const void*)mcop_fused_warp_kernel<11>;
    default: return nullptr;
  }
}

}  // namespace repro_torch

using repro_torch::Plan;

// Same contract as repro_torch_sw_plan.
extern "C" int repro_torch_fused_plan(int n, int batch, int graphs_per_block, int* out) {
  Plan p;
  cudaError_t err = repro_torch::make_plan(
      n, batch, graphs_per_block, repro_torch::warp_kernel(repro_torch::warp_cpl(n)),
      (const void*)repro_torch::mcop_fused_block_kernel, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.cpl;
  out[1] = p.threads;
  out[2] = p.smem_bytes;
  out[3] = p.resident_blocks;
  out[4] = p.graphs_per_block;
  return 0;
}

extern "C" int repro_torch_fused_solve(
    const float* t_local, const float* data_in, const float* data_out,
    const uint8_t* pinned, const float* env, float* cuts, uint8_t* masks,
    float* scratch, int batch, int n, int kind, float omega, int grid,
    int threads, int cpl, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cpl) {
#define REPRO_FUSED_WARP(C)                                                      \
  case C:                                                                        \
    repro_torch::mcop_fused_warp_kernel<C><<<grid, threads, smem_bytes, st>>>(   \
        t_local, data_in, data_out, pinned, env, cuts, masks, batch, n, kind,    \
        omega);                                                                  \
    break;
    REPRO_FUSED_WARP(1)
    REPRO_FUSED_WARP(2)
    REPRO_FUSED_WARP(4)
    REPRO_FUSED_WARP(8)
    REPRO_FUSED_WARP(11)
#undef REPRO_FUSED_WARP
    case 0:
      repro_torch::mcop_fused_block_kernel<<<grid, threads, smem_bytes, st>>>(
          t_local, data_in, data_out, pinned, env, cuts, masks, scratch, batch, n,
          kind, omega);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
