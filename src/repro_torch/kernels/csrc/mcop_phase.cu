// One MinCutPhase (MCOP, paper Algorithm 3) per launch, for Hopper.
//
// Replaces the TPU kernel `mcop_phase_kernel` (its `_phase_body`) of the JAX
// package's kernels/mcop_phase.py: from A = {src} among the alive vertices
// and conn = adj[src], absorb exactly n_alive - 1 vertices, each the
// first-index argmax of conn - gains over the alive vertices outside A, add
// its row to conn, and report the Eq.-10 cut of the last one (t) together
// with the one before it (s).
//
// Two entry points share the phase body:
//
// * repro_torch_phase_solve: one phase on an (n, n) adjacency in device
//   memory, (cut, s, t) out.  The counterpart of the Pallas kernel.
// * repro_torch_phase_step: one phase of kernels/ops.py:mcop_min_cut's loop
//   and everything the host did after it, on the loop's device state: the
//   working matrix, wl, wc, alive, label, the best cut and its cloud mask,
//   the anchor, and a log of (cut, s, t) per phase.  After the phase the same
//   launch keeps a strictly smaller cut and its cloud side (label == t),
//   merges t into s (Algorithm 1, in the reference's f32 arithmetic), adds
//   wl[t] and wc[t] into s, relabels t's members and moves the anchor when t
//   was the source.  The host issues one launch per phase and reads nothing
//   back until the end.  The working matrix is the packed upper triangle
//   (sw_common.cuh) when the graph is exactly symmetric with a zero diagonal,
//   and the full (n, n) matrix otherwise: the phase then reads rows and the
//   merge adds row t into row s and column t into column s, as the
//   reference's loop does on any matrix.
//
// What bounds it on this card: latency, not bytes or arithmetic.  A phase
// reads n_alive + 2 rows, (n_alive + 2) n 4 bytes, and does about 3 n^2
// operations, but its n_alive - 1 absorb steps form a chain: each needs the
// argmax of the step before it.  The design shortens each link.  Up to
// n = 256 one warp runs the phase: lane `lane` owns columns lane + 32 k and
// holds their conn, gains and state in registers (templated on columns per
// lane), and a step is two redux.sync (sw_common.cuh:warp_argmax) and one
// row read, with no barrier.  The row read leaves the chain's device-memory
// latency behind: where the matrix fits (the loop's packed matrix up to
// n = 341, a full (n, n) one up to n = 241) the launch first stages it into
// shared memory with all 256 threads of its block, every 16-byte cp.async in
// flight at once, and then one warp runs the phase.  The variant that reads
// rows from device memory and L2 runs the matrices that do not fit (a full
// loop matrix above n = 241), and the smoke times it beside the staged one.  Above n = 256 one block runs the
// phase (shared-memory vectors, one block argmax a step).
#include <stdint.h>

#include "sw_common.cuh"

namespace repro_torch {

constexpr int kWarpMaxN = 256;
constexpr uint8_t kAlive = 1;
constexpr uint8_t kInA = 2;

// The loop's device state (kernels/mcop_phase.py:LoopState lays it out in one
// buffer, so that it goes up in one copy and the result comes back in one).
struct LoopState {
  float* P;        // working matrix: packed (tri_bytes(n) bytes) or full (n, n)
  float* wl;       // (n) merged local cost
  float* wc;       // (n) merged cloud cost
  uint8_t* alive;  // (n)
  int* label;      // (n) the surviving vertex each original vertex merged into
  uint8_t* cloud;  // (n) the best cut's cloud side (label == t)
  int* scal;       // [0] anchor, [1] best cut's f32 bits
  int* log;        // (phases, 3) cut bits, s, t
};

// Threads a staged launch has: every warp issues copies, then all but the
// first leave and warp 0 runs the phase.
constexpr int kStageThreads = 256;

// Copy `count` floats into shared memory with every thread of the block
// (16-byte cp.async chunks when the source allows it, all in flight at
// once), then wait and release every warp but the first.  Returns false in
// the threads that leave.
__device__ inline bool stage_floats(float* dst, const float* src, int count) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = count >> 2;
    for (int c = tid; c < chunks; c += nt) cp_async16(dst + 4 * c, src + 4 * c);
    done = chunks << 2;
  }
  for (int e = done + tid; e < count; e += nt) cp_async4(dst + e, src + e);
  cp_async_wait_all();
  __syncthreads();
  return tid < 32;
}

// Number of set bits k over the warp: the alive vertices.
template <int CPL>
__device__ __forceinline__ int warp_count(uint32_t bits) {
  int c = 0;
#pragma unroll
  for (int k = 0; k < CPL; ++k) c += __popc(__ballot_sync(kFull, bit(bits, k)));
  return c;
}

// ---------------------------------------------------------------------------
// Warp variant, n <= 256
// ---------------------------------------------------------------------------

template <int CPL, bool kStaged>
__global__ void __launch_bounds__(kStageThreads, 1)
    phase_warp_kernel(const float* __restrict__ adj, const float* __restrict__ gains,
                      const uint8_t* __restrict__ alive_in, int src, float ctot, int n,
                      int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  float* rows = kStaged ? reinterpret_cast<float*>(smem) : const_cast<float*>(adj);
  if (kStaged && !stage_floats(rows, adj, n * n)) return;
  const Rows<false> A{rows, n};
  int rj[CPL];
  float gain[CPL], conn[CPL];
  uint32_t alive = 0, in_a = 0;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    rj[k] = 0;
    gain[k] = 0.f;
    if (j >= n) continue;
    gain[k] = gains[j];
    if (alive_in[j]) {
      alive |= 1u << k;
      if (j == src) in_a |= 1u << k;
    }
  }
  const int n_alive = warp_count<CPL>(alive);
  const int rsrc = A.row(src);
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    conn[k] = bit(alive, k) ? rows[A.at(rsrc, src, lane + 32 * k, 0)] : 0.f;
  const int2 st = absorb_chain<CPL, false>(A, lane, n_alive, src, conn, gain, rj, alive, in_a);
  const float cut = phase_cut<CPL, false>(A, lane, st.y, ctot, gain, rj, alive);
  if (lane == 0) {
    out[0] = __float_as_int(cut);
    out[1] = st.x;
    out[2] = st.y;
  }
}

// Algorithm 1 on a full matrix, for the lane's columns: row s += row t and
// column s += column t off {s, t}, A[s][s] = 0, row and column t zeroed,
// read from `from` and written to `to` (the same matrix, or a staged copy
// and the original).  Column owner j writes A[s][j], A[j][s], A[t][j],
// A[j][t]; the owner of s writes A[s][s], A[s][t], A[t][s]; the owner of t
// writes A[t][t]: no element has two writers.  The caller orders these
// writes after every read of the phase.
template <int CPL>
__device__ __forceinline__ void full_merge(const float* from, float* to, int n, int lane,
                                           int s, int t) {
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    if (j >= n) continue;
    if (j == t) {
      to[(size_t)t * n + t] = 0.f;
      continue;
    }
    if (j == s) {
      to[(size_t)s * n + s] = 0.f;
    } else {
      to[(size_t)s * n + j] = from[(size_t)s * n + j] + from[(size_t)t * n + j];
      to[(size_t)j * n + s] = from[(size_t)j * n + s] + from[(size_t)j * n + t];
    }
    to[(size_t)t * n + j] = 0.f;
    to[(size_t)j * n + t] = 0.f;
  }
}

// Floats of the loop's working matrix.
__host__ __device__ inline size_t matrix_floats(int n, bool packed) {
  return packed ? tri_bytes(n) / 4 : (size_t)n * n;
}

template <int CPL, bool kStaged, bool kPacked>
__global__ void __launch_bounds__(kStageThreads, 1)
    phase_step_warp_kernel(LoopState S, int phase, float ctot, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x;
  float* rows = kStaged ? reinterpret_cast<float*>(smem) : S.P;
  if (kStaged && !stage_floats(rows, S.P, (int)matrix_floats(n, kPacked))) return;
  const Rows<kPacked> A{rows, n};
  const int src = S.scal[0];
  const float best = __int_as_float(S.scal[1]);
  int rj[CPL], label[CPL];
  float wl[CPL], wc[CPL], gain[CPL], conn[CPL];
  uint32_t alive = 0, in_a = 0;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    rj[k] = kPacked ? tri_row(j, n) : 0;
    wl[k] = 0.f;
    wc[k] = 0.f;
    label[k] = -1;
    if (j >= n) continue;
    wl[k] = S.wl[j];
    wc[k] = S.wc[j];
    label[k] = S.label[j];
    if (S.alive[j]) alive |= 1u << k;
    if (j == src) in_a |= 1u << k;
  }
#pragma unroll
  for (int k = 0; k < CPL; ++k) gain[k] = wl[k] - wc[k];
  const int n_alive = warp_count<CPL>(alive);
  const int rsrc = A.row(src);
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    conn[k] = (bit(alive, k) && j != src) ? rows[A.at(rsrc, src, j, rj[k])] : 0.f;
  }
  const int2 st =
      absorb_chain<CPL, kPacked>(A, lane, n_alive, src, conn, gain, rj, alive, in_a);
  const int s = st.x, t = st.y;
  const float cut = phase_cut<CPL, kPacked>(A, lane, t, ctot, gain, rj, alive);
  const bool improved = cut < best;  // the same bits in every lane

  // Algorithm 1 in the device matrix, from the rows this launch read, after
  // every lane's reads; the next launch sees the writes at the kernel
  // boundary.
  __syncwarp();
  if (kPacked)
    packed_merge<CPL>(rows, S.P, n, lane, s, t, rj);
  else
    full_merge<CPL>(rows, S.P, n, lane, s, t);
  const float wl_t = lane_value<CPL>(wl, t), wc_t = lane_value<CPL>(wc, t);
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    if (j >= n) continue;
    if (improved) S.cloud[j] = label[k] == t ? 1 : 0;
    if (label[k] == t) S.label[j] = s;
    if (j == s) {
      S.wl[j] = wl[k] + wl_t;
      S.wc[j] = wc[k] + wc_t;
    }
    if (j == t) S.alive[j] = 0;
  }
  if (lane == 0) {
    if (improved) S.scal[1] = __float_as_int(cut);
    if (t == src) S.scal[0] = s;  // the anchor follows a merged source
    S.log[3 * phase] = __float_as_int(cut);
    S.log[3 * phase + 1] = s;
    S.log[3 * phase + 2] = t;
  }
}

// ---------------------------------------------------------------------------
// Block variant, 256 < n <= PHASE_MAX_N: rows from device memory and L2
// ---------------------------------------------------------------------------

template <bool kPacked>
__device__ __forceinline__ float elem(const Rows<kPacked>& A, int rv, int v, int j) {
  if (kPacked && j == v) return 0.f;
  return A.a[A.at(rv, v, j, kPacked ? tri_row(j, A.n) : 0)];
}

// The phase on a block: thread `tid` owns columns tid, tid + T, ... and is the
// only one to touch their conn, gain and state entries, so an absorb step is
// one pass over the owned columns and one block argmax (warp shuffles, then
// one shared-memory pass, ties to the lowest index) with a single barrier.
// Returns (s, t); every thread gets the cut.
template <bool kPacked>
__device__ int2 block_phase(const Rows<kPacked>& A, const float* gains,
                            const uint8_t* alive, int src, float ctot, float* cut_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = A.n;
  float* conn = reinterpret_cast<float*>(smem);
  float* gain = reinterpret_cast<float*>(smem + padded_bytes(4 * n));
  uint8_t* state = smem + 2 * padded_bytes(4 * n);
  float* red_sum = reinterpret_cast<float*>(smem + 2 * padded_bytes(4 * n) +
                                            padded_bytes(n));
  float* red_val = red_sum + kMaxWarps;                            // (2, kMaxWarps)
  int* red_idx = reinterpret_cast<int*>(red_val + 2 * kMaxWarps);  // (2, kMaxWarps)
  const int tid = threadIdx.x, nt = blockDim.x;

  // A = {src} among the alive vertices; conn = adj[src]; first scores.
  int rv = A.row(src);
  float count = 0.f, best = kNegInf;
  int idx = kNoIndex;
  for (int j = tid; j < n; j += nt) {
    uint8_t st = alive[j] ? kAlive : 0;
    if (st && j == src) st |= kInA;
    const float c = elem(A, rv, src, j), g = gains[j];
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
    rv = A.row(v);
    best = kNegInf;
    idx = kNoIndex;
    for (int j = tid; j < n; j += nt) {
      uint8_t st = state[j];
      if (j == v) {
        st |= kInA;
        state[j] = st;
      }
      const float c = st == kAlive ? conn[j] + elem(A, rv, v, j) : conn[j];
      conn[j] = c;
      const float sc = st == kAlive ? c - gain[j] : kNegInf;
      if (idx == kNoIndex || sc > best) { best = sc; idx = j; }
    }
    s = t;
    t = v;
  }

  // Eq. 10 cut of the phase.  gain[t] belongs to another thread: the
  // barrier inside block_sum makes it visible.
  rv = A.row(t);
  float part = 0.f;
  for (int j = tid; j < n; j += nt)
    if ((state[j] & kAlive) && (!kPacked || j != t)) part += elem(A, rv, t, j);
  const float comm = block_sum(part, red_sum);
  *cut_out = (ctot - gain[t]) + comm;
  return make_int2(s, t);
}

__host__ inline size_t block_smem_bytes(int n) {
  return 2 * padded_bytes(4 * n) + padded_bytes(n) + 5 * kMaxWarps * 4;
}

__global__ void phase_block_kernel(const float* __restrict__ adj,
                                   const float* __restrict__ gains,
                                   const uint8_t* __restrict__ alive, int src, float ctot,
                                   int n, int* __restrict__ out) {
  float cut;
  const int2 st =
      block_phase<false>(Rows<false>{const_cast<float*>(adj), n}, gains, alive, src, ctot, &cut);
  if (threadIdx.x == 0) {
    out[0] = __float_as_int(cut);
    out[1] = st.x;
    out[2] = st.y;
  }
}

// The loop's step on a block.  The gains go through a scratch vector of the
// state: block_phase reads gains[j] in the thread that wrote it.
template <bool kPacked>
__global__ void phase_step_block_kernel(LoopState S, float* __restrict__ gains,
                                        int phase, float ctot, int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int src = S.scal[0];
  const float best = __int_as_float(S.scal[1]);
  for (int j = tid; j < n; j += nt) gains[j] = S.wl[j] - S.wc[j];
  float cut;
  const Rows<kPacked> A{S.P, n};
  const int2 st = block_phase<kPacked>(A, gains, S.alive, src, ctot, &cut);
  const int s = st.x, t = st.y;
  const bool improved = cut < best;
  const int rs = A.row(s), rt = A.row(t);
  // every read of the phase is behind block_phase's last barrier; column
  // owner j writes only elements of row or column j (full_merge's rule)
  for (int j = tid; j < n; j += nt) {
    const int lab = S.label[j];
    if (improved) S.cloud[j] = lab == t ? 1 : 0;
    if (lab == t) S.label[j] = s;
    if (!kPacked) {
      float* P = S.P;
      if (j == t) {
        P[(size_t)t * n + t] = 0.f;
        continue;
      }
      if (j == s) {
        P[(size_t)s * n + s] = 0.f;
      } else {
        P[(size_t)s * n + j] += P[(size_t)t * n + j];
        P[(size_t)j * n + s] += P[(size_t)j * n + t];
      }
      P[(size_t)t * n + j] = 0.f;
      P[(size_t)j * n + t] = 0.f;
      continue;
    }
    if (j == t) continue;
    const int rj = tri_row(j, n);
    const int et = A.at(rt, t, j, rj);
    if (j != s) S.P[A.at(rs, s, j, rj)] += S.P[et];
    S.P[et] = 0.f;
  }
  if (tid == 0) {
    S.wl[s] += S.wl[t];
    S.wc[s] += S.wc[t];
    S.alive[t] = 0;
    if (improved) S.scal[1] = __float_as_int(cut);
    if (t == src) S.scal[0] = s;
    S.log[3 * phase] = __float_as_int(cut);
    S.log[3 * phase + 1] = s;
    S.log[3 * phase + 2] = t;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

inline int block_threads(int n) { return n >= 256 ? 256 : ((n + 31) / 32) * 32; }

inline int smem_optin() {
  static int bytes = 0;
  if (bytes == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
      bytes = 48 * 1024;
  }
  return bytes;
}

// Dynamic shared memory above 48 KB needs the function's opt-in; `allowed`
// remembers what this kernel was given.
inline cudaError_t allow_smem(const void* kernel, size_t bytes, size_t* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <int CPL>
inline cudaError_t launch_phase_warp(const float* adj, const float* gains,
                                     const uint8_t* alive, int src, float ctot, int n,
                                     int* out, bool staged, cudaStream_t st) {
  if (staged) {
    static size_t allowed = 48 * 1024;
    const size_t smem = (size_t)n * n * 4;
    cudaError_t err = allow_smem((const void*)phase_warp_kernel<CPL, true>, smem, &allowed);
    if (err != cudaSuccess) return err;
    phase_warp_kernel<CPL, true><<<1, kStageThreads, smem, st>>>(adj, gains, alive, src, ctot,
                                                               n, out);
  } else {
    phase_warp_kernel<CPL, false><<<1, 32, 0, st>>>(adj, gains, alive, src, ctot, n, out);
  }
  return cudaGetLastError();
}

template <int CPL, bool kPacked>
inline cudaError_t launch_step_warp(const LoopState& S, int phase, float ctot, int n,
                                    bool staged, cudaStream_t st) {
  if (staged) {
    static size_t allowed = 48 * 1024;
    const size_t smem = matrix_floats(n, kPacked) * 4;
    cudaError_t err =
        allow_smem((const void*)phase_step_warp_kernel<CPL, true, kPacked>, smem, &allowed);
    if (err != cudaSuccess) return err;
    phase_step_warp_kernel<CPL, true, kPacked>
        <<<1, kStageThreads, smem, st>>>(S, phase, ctot, n);
  } else {
    phase_step_warp_kernel<CPL, false, kPacked><<<1, 32, 0, st>>>(S, phase, ctot, n);
  }
  return cudaGetLastError();
}

template <bool kPacked>
inline cudaError_t launch_step(const LoopState& S, float* gains, int phase, float ctot,
                               int n, bool staged, cudaStream_t st) {
  switch (n <= kWarpMaxN ? warp_cpl(n) : 0) {
    case 1: return launch_step_warp<1, kPacked>(S, phase, ctot, n, staged, st);
    case 2: return launch_step_warp<2, kPacked>(S, phase, ctot, n, staged, st);
    case 4: return launch_step_warp<4, kPacked>(S, phase, ctot, n, staged, st);
    case 8: return launch_step_warp<8, kPacked>(S, phase, ctot, n, staged, st);
    default:
      phase_step_block_kernel<kPacked><<<1, block_threads(n), block_smem_bytes(n), st>>>(
          S, gains, phase, ctot, n);
      return cudaGetLastError();
  }
}

}  // namespace repro_torch

// Row strategies: 0 = staged in shared memory where the matrix fits (the
// default), 1 = rows read from device memory and L2.  The block variant
// (n > 256) always reads device memory.
//
// One phase on the n-vertex graph `adj` (row-major, contiguous) on `stream`.
// Writes out[0] = the cut's f32 bits, out[1] = s, out[2] = t.  Returns the
// CUDA error of the launch (0 if it was accepted).
extern "C" int repro_torch_phase_solve(const float* adj, const float* gains,
                                       const uint8_t* alive, int src, float ctot,
                                       int n, int rows, int* out, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool staged = rows == 0 && (size_t)n * n * 4 <= (size_t)smem_optin();
  cudaError_t err;
  switch (n <= kWarpMaxN ? warp_cpl(n) : 0) {
    case 1: err = launch_phase_warp<1>(adj, gains, alive, src, ctot, n, out, staged, st); break;
    case 2: err = launch_phase_warp<2>(adj, gains, alive, src, ctot, n, out, staged, st); break;
    case 4: err = launch_phase_warp<4>(adj, gains, alive, src, ctot, n, out, staged, st); break;
    case 8: err = launch_phase_warp<8>(adj, gains, alive, src, ctot, n, out, staged, st); break;
    default:
      phase_block_kernel<<<1, block_threads(n), block_smem_bytes(n), st>>>(
          adj, gains, alive, src, ctot, n, out);
      err = cudaGetLastError();
  }
  return (int)err;
}

// One phase of mcop_min_cut's loop and its merge on the loop state (the
// pointers are sections of one buffer; `gains` is (n) floats of scratch for
// the block variant).  `phase` is the log row to write; `full` = 1 when P is
// the full (n, n) matrix, 0 when it is the packed upper triangle.
extern "C" int repro_torch_phase_step(float* P, float* wl, float* wc, float* gains,
                                      int* label, int* log, int* scal, uint8_t* alive,
                                      uint8_t* cloud, int n, int phase, float ctot,
                                      int rows, int full, void* stream) {
  using namespace repro_torch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  LoopState S{P, wl, wc, alive, label, cloud, scal, log};
  const bool staged = rows == 0 && matrix_floats(n, !full) * 4 <= (size_t)smem_optin();
  return (int)(full ? launch_step<false>(S, gains, phase, ctot, n, staged, st)
                    : launch_step<true>(S, gains, phase, ctot, n, staged, st));
}
