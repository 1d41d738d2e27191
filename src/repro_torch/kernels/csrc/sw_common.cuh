// Shared device code of the two MCOP solve kernels: one thread block runs
// the full modified Stoer-Wagner (paper Algorithms 1-3) on one graph whose
// working adjacency `A` (n x n, row-major, private to the block) and node
// weights are already in place.  mcop_sw.cu fills them from a batch in
// device memory, mcop_fused.cu builds them from an application profile.
//
// Layout of the work: thread `tid` owns columns tid, tid+T, tid+2T, ...  Every
// per-vertex vector (conn, gains, alive, in_a, label, cloud) lives in shared
// memory and element j is read and written only by the owner of column j
// unless a comment says otherwise, so one absorb step costs exactly one
// __syncthreads(): the cross-warp half of the argmax.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// f32 sentinels shared with the plain PyTorch version and the reference
// solvers: cuts priced in bytes or FLOPs can exceed 2^30.
constexpr float kNegInf = -1e30f;
constexpr float kPosInf = 1e30f;
constexpr int kMaxWarps = 32;
constexpr int kNoIndex = 0x7fffffff;

struct Workspace {
  float* wl;       // (n) local node cost, merged in place
  float* wc;       // (n) cloud node cost
  float* gains;    // (n) wl - wc, refreshed every phase
  float* conn;     // (n) w(e(A, v)); holds the fold row before the phases
  int* label;      // (n) representative vertex of each original vertex
  uint8_t* alive;  // (n)
  uint8_t* in_a;   // (n) holds the pinned mask on entry to solve_graph
  uint8_t* cloud;  // (n) membership of the best cut's t
  float* red_sum;  // (kMaxWarps)
  float* red_val;  // (2, kMaxWarps) argmax slots, double-buffered by step parity
  int* red_idx;    // (2, kMaxWarps)
};

__host__ __device__ inline size_t padded_bytes(int n) {
  return (size_t)((n + 15) / 16) * 16;
}

// Bytes of shared memory the vectors and reduction slots take.
__host__ __device__ inline size_t workspace_bytes(int n) {
  return 5 * padded_bytes(4 * n) + 3 * padded_bytes(n) + 5 * kMaxWarps * 4;
}

__device__ inline Workspace carve_workspace(unsigned char* base, int n) {
  Workspace ws;
  size_t fb = padded_bytes(4 * n), bb = padded_bytes(n);
  ws.wl = reinterpret_cast<float*>(base);
  ws.wc = reinterpret_cast<float*>(base + fb);
  ws.gains = reinterpret_cast<float*>(base + 2 * fb);
  ws.conn = reinterpret_cast<float*>(base + 3 * fb);
  ws.label = reinterpret_cast<int*>(base + 4 * fb);
  unsigned char* p = base + 5 * fb;
  ws.alive = p;
  ws.in_a = p + bb;
  ws.cloud = p + 2 * bb;
  p += 3 * bb;
  ws.red_sum = reinterpret_cast<float*>(p);
  ws.red_val = reinterpret_cast<float*>(p + kMaxWarps * 4);
  ws.red_idx = reinterpret_cast<int*>(p + 3 * kMaxWarps * 4);
  return ws;
}

// Sum over the block; every thread gets the result.  Fixed order (shuffle
// tree inside a warp, then warps in ascending order), so a graph's result
// does not depend on which block solved it.
__device__ inline float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += red[w];
  __syncthreads();
  return s;
}

__device__ inline int block_min(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = red[0];
  for (int w = 1; w < nw; ++w) s = min(s, red[w]);
  __syncthreads();
  return s;
}

__device__ inline bool better(float ov, int oi, float v, int i) {
  // ties go to the lowest index (Algorithm 3's strict '<')
  return ov > v || (ov == v && oi < i);
}

// First index of the maximum over the block; every thread gets it.  `rv`/`ri`
// are this step's slots; the caller alternates between two sets so that the
// single barrier here also protects the slots of the step before.
__device__ inline int block_argmax(float v, int i, float* rv, int* ri) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, o);
    int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) { rv[warp] = v; ri[warp] = i; }
  __syncthreads();
  v = rv[0];
  i = ri[0];
  for (int w = 1; w < nw; ++w) {
    float ov = rv[w];
    int oi = ri[w];
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  return i;
}

// Full solve of the graph held in (A, ws.wl, ws.wc) with the pinned mask in
// ws.in_a.  Writes the minimum Eq.-10 cut and the local mask (1 = run
// locally).  Must be called by every thread of the block.
__device__ inline void solve_graph(float* A, const Workspace& ws, int n,
                                   float* cut_out, uint8_t* mask_out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const uint8_t* pin = ws.in_a;
  __syncthreads();  // A, wl, wc, pin written by other threads

  // ---- C_local and the anchor -----------------------------------------
  float part = 0.f, part_l = 0.f, part_c = 0.f, n_pin = 0.f;
  int first = kNoIndex;
  for (int j = tid; j < n; j += nt) {
    part += ws.wl[j];
    if (pin[j]) {
      part_l += ws.wl[j];
      part_c += ws.wc[j];
      n_pin += 1.f;
      first = min(first, j);
    }
  }
  const float ctot = block_sum(part, ws.red_sum);
  const float pin_l = block_sum(part_l, ws.red_sum);
  const float pin_c = block_sum(part_c, ws.red_sum);
  const int count_pin = (int)block_sum(n_pin, ws.red_sum);  // exact: n < 2^24
  first = block_min(first, ws.red_idx);
  const bool any_pinned = first != kNoIndex;
  int src = any_pinned ? first : 0;
  const float wl_src = pin_l + (any_pinned ? 0.f : ws.wl[src]);
  const float wc_src = pin_c + (any_pinned ? 0.f : ws.wc[src]);

  // ---- fold every other pinned vertex into the anchor ------------------
  // fold[j] = sum over folded rows i of A[i][j], rows in ascending order.
  for (int j = tid; j < n; j += nt) {
    float f = 0.f;
    for (int i = 0; i < n; ++i)
      if (pin[i] && i != src) f += A[i * n + j];
    ws.conn[j] = f;
  }
  __syncthreads();  // all folded rows read before they are cleared
  for (int e = tid; e < n * n; e += nt) {
    const int i = e / n, j = e - i * n;
    if ((pin[i] && i != src) || (pin[j] && j != src)) A[e] = 0.f;
  }
  __syncthreads();
  for (int j = tid; j < n; j += nt) {
    const bool other = pin[j] && j != src;
    if (j == src) {
      A[src * n + src] = 0.f;
    } else if (!other) {
      const float f = ws.conn[j];
      A[src * n + j] += f;
      A[j * n + src] += f;
    }
    ws.label[j] = pin[j] ? src : j;
    ws.alive[j] = other ? 0 : 1;
    ws.cloud[j] = 0;
    if (other) { ws.wl[j] = 0.f; ws.wc[j] = 0.f; }
    if (j == src) { ws.wl[j] = wl_src; ws.wc[j] = wc_src; }
  }
  int n_alive = n - (any_pinned ? count_pin - 1 : 0);
  float best_cut = kPosInf;
  int parity = 0;
  __syncthreads();

  // ---- Algorithm 2: one phase per surviving vertex beyond the first ----
  while (n_alive > 1) {
    for (int j = tid; j < n; j += nt) {
      ws.gains[j] = ws.wl[j] - ws.wc[j];
      ws.in_a[j] = j == src;
      ws.conn[j] = A[src * n + j];
    }
    int s = src, t = src;
    // Algorithm 3: absorb the most tightly connected vertex n_alive-1 times.
    for (int step = 0; step + 1 < n_alive; ++step) {
      float best = kNegInf;
      int idx = kNoIndex;
      for (int j = tid; j < n; j += nt) {
        const float sc =
            (ws.alive[j] && !ws.in_a[j]) ? ws.conn[j] - ws.gains[j] : kNegInf;
        if (idx == kNoIndex || sc > best) { best = sc; idx = j; }
      }
      const int v = block_argmax(best, idx, ws.red_val + parity * kMaxWarps,
                                 ws.red_idx + parity * kMaxWarps);
      parity ^= 1;
      for (int j = tid; j < n; j += nt) {
        ws.conn[j] += A[v * n + j];
        if (j == v) ws.in_a[j] = 1;
      }
      s = t;
      t = v;
    }

    // Eq. 10 cut-of-the-phase.  gains[t] belongs to another thread: the
    // barrier of the absorb steps above (n_alive >= 2) made it visible.
    part = 0.f;
    for (int j = tid; j < n; j += nt)
      if (ws.alive[j]) part += A[t * n + j];
    const float comm = block_sum(part, ws.red_sum);
    const float cut = (ctot - ws.gains[t]) + comm;
    if (cut < best_cut) {
      best_cut = cut;
      for (int j = tid; j < n; j += nt) ws.cloud[j] = ws.label[j] == t;
    }

    // Algorithm 1: merge t into s.  Column owner j writes A[s][j], A[j][s],
    // A[t][j], A[j][t]; owner s also clears A[s][s], so no element has two
    // writers.
    for (int j = tid; j < n; j += nt) {
      const float r = A[t * n + j];
      if (j != s && j != t) {
        A[s * n + j] += r;
        A[j * n + s] += r;
      }
      A[t * n + j] = 0.f;
      A[j * n + t] = 0.f;
      if (j == s) A[s * n + s] = 0.f;
      if (ws.label[j] == t) ws.label[j] = s;
    }
    if (tid == 0) {  // the only cross-owner vector writes; read after the barrier
      ws.wl[s] += ws.wl[t];
      ws.wc[s] += ws.wc[t];
      ws.wl[t] = 0.f;
      ws.wc[t] = 0.f;
      ws.alive[t] = 0;
    }
    if (t == src) src = s;  // the anchor follows a merged source
    --n_alive;
    __syncthreads();
  }

  if (tid == 0) *cut_out = best_cut;
  for (int j = tid; j < n; j += nt) mask_out[j] = ws.cloud[j] ? 0 : 1;
  __syncthreads();  // the workspace is reused by the block's next graph
}

// Launch geometry shared by both kernels.
struct Plan {
  int threads;
  int adj_in_smem;
  int smem_bytes;
  int resident_blocks;
};

template <typename KernelSmem, typename KernelGlobal>
inline cudaError_t make_plan(int n, KernelSmem k_smem, KernelGlobal k_global,
                             Plan* plan) {
  int dev = 0, smem_optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  int threads = ((n + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const size_t vec = workspace_bytes(n);
  const size_t with_adj = vec + (size_t)n * n * 4;
  plan->threads = threads;
  plan->adj_in_smem = with_adj <= (size_t)smem_optin ? 1 : 0;
  plan->smem_bytes = (int)(plan->adj_in_smem ? with_adj : vec);
  if (plan->adj_in_smem) {
    err = cudaFuncSetAttribute(k_smem, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               plan->smem_bytes);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_smem, threads,
                                                        plan->smem_bytes);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_global, threads,
                                                        plan->smem_bytes);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  plan->resident_blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace repro_torch
