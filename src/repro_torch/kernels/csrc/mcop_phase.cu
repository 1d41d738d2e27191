// One MinCutPhase (MCOP, paper Algorithm 3) per launch, for Hopper.
//
// Replaces the TPU kernel `mcop_phase_kernel` (its `_phase_body`) of the JAX
// package's kernels/mcop_phase.py: from A = {src} among the alive vertices
// and conn = adj[src], absorb exactly n_alive - 1 vertices, each the
// first-index argmax of conn - gains over the alive vertices outside A, add
// its row to conn, and report the Eq.-10 cut of the last one (t) together
// with the one before it (s).  The host loop (kernels/ops.py:mcop_min_cut)
// merges t into s and launches again, once per phase.
//
// What bounds it on this card: latency, not bytes or arithmetic.  A phase
// reads n_alive + 2 rows of the adjacency, (n_alive + 2) n 4 bytes, and does
// about 3 n^2 operations, but its n_alive - 1 absorb steps form a chain: each
// needs the argmax of the step before it.  The TPU body loads the whole
// (n, n) adjacency into VMEM; here it stays in device memory (and L2, where
// the host loop's previous phase left it), because a phase reads each row at
// most once.  Only the length-n vectors live on chip, in shared memory: conn,
// gains and a state byte (alive, in A).  One block of up to 256 threads;
// thread `tid` owns columns tid, tid + T, ...  and is the only one to touch
// their entries, so an absorb step is one pass over the owned columns (add
// the absorbed row with coalesced loads, score, keep the local best) and one
// block argmax: warp shuffles, then one shared-memory pass, ties to the
// lowest index (sw_common.cuh), with a single barrier.
#include "sw_common.cuh"

namespace repro_torch {

constexpr uint8_t kAlive = 1;
constexpr uint8_t kInA = 2;

__global__ void mcop_phase_kernel(const float* __restrict__ adj,
                                  const float* __restrict__ gains,
                                  const uint8_t* __restrict__ alive, int src,
                                  float ctot, int n, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* conn = reinterpret_cast<float*>(smem);
  float* gain = reinterpret_cast<float*>(smem + padded_bytes(4 * n));
  uint8_t* state = smem + 2 * padded_bytes(4 * n);
  float* red_sum = reinterpret_cast<float*>(smem + 2 * padded_bytes(4 * n) +
                                            padded_bytes(n));
  float* red_val = red_sum + kMaxWarps;                          // (2, kMaxWarps)
  int* red_idx = reinterpret_cast<int*>(red_val + 2 * kMaxWarps);  // (2, kMaxWarps)
  const int tid = threadIdx.x, nt = blockDim.x;

  // A = {src} among the alive vertices; conn = adj[src]; first scores.
  const float* row = adj + (size_t)src * n;
  float count = 0.f, best = kNegInf;
  int idx = kNoIndex;
  for (int j = tid; j < n; j += nt) {
    uint8_t st = alive[j] ? kAlive : 0;
    if (st && j == src) st |= kInA;
    const float c = row[j], g = gains[j];
    state[j] = st;
    conn[j] = c;
    gain[j] = g;
    count += st ? 1.f : 0.f;
    const float sc = st == kAlive ? c - g : kNegInf;
    if (idx == kNoIndex || sc > best) { best = sc; idx = j; }
  }
  const int n_alive = (int)block_sum(count, red_sum);  // exact: n < 2^24

  // Algorithm 3: absorb the most tightly connected vertex n_alive - 1 times.
  int s = src, t = src, parity = 0;
  for (int step = 0; step + 1 < n_alive; ++step) {
    const int v = block_argmax(best, idx, red_val + parity * kMaxWarps,
                               red_idx + parity * kMaxWarps);
    parity ^= 1;
    row = adj + (size_t)v * n;
    best = kNegInf;
    idx = kNoIndex;
    for (int j = tid; j < n; j += nt) {
      const float c = conn[j] + row[j];
      uint8_t st = state[j];
      if (j == v) {
        st |= kInA;
        state[j] = st;
      }
      conn[j] = c;
      const float sc = st == kAlive ? c - gain[j] : kNegInf;
      if (idx == kNoIndex || sc > best) { best = sc; idx = j; }
    }
    s = t;
    t = v;
  }

  // Eq. 10 cut of the phase.  gain[t] belongs to another thread: the
  // barrier inside block_sum makes it visible.
  row = adj + (size_t)t * n;
  float part = 0.f;
  for (int j = tid; j < n; j += nt)
    if (state[j] & kAlive) part += row[j];
  const float comm = block_sum(part, red_sum);
  if (tid == 0) {
    out[0] = __float_as_int((ctot - gain[t]) + comm);
    out[1] = s;
    out[2] = t;
  }
}

__host__ inline size_t phase_smem_bytes(int n) {
  return 2 * padded_bytes(4 * n) + padded_bytes(n) + 5 * kMaxWarps * 4;
}

}  // namespace repro_torch

// One phase on the n-vertex graph `adj` (row-major, contiguous), launched on
// `stream` with `threads` threads (a multiple of 32, at most 1024).  Writes
// out[0] = the cut's f32 bits, out[1] = s, out[2] = t.  Returns the CUDA
// error of the launch (0 if it was accepted).
extern "C" int repro_torch_phase_solve(const float* adj, const float* gains,
                                       const uint8_t* alive, int src, float ctot,
                                       int n, int threads, int* out,
                                       void* stream) {
  const size_t smem = repro_torch::phase_smem_bytes(n);
  repro_torch::mcop_phase_kernel<<<1, threads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      adj, gains, alive, src, ctot, n, out);
  return (int)cudaGetLastError();
}
