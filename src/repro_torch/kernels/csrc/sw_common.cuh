// Shared device code of the three MCOP kernels (paper Algorithms 1-3).
//
// Two bodies solve one graph whose working adjacency and node weights are in
// place (mcop_sw.cu fills them from a batch in device memory, mcop_fused.cu
// builds them from an application profile):
//
// * solve_graph_warp: one warp per graph, up to the packed limit (n = 341 at
//   the H100's 227 KB).  The adjacency is the packed upper triangle of the
//   symmetric matrix (4 n (n - 1) / 2 bytes) in the warp's own slice of
//   shared memory; lane `lane` owns columns lane + 32 k, and every per-vertex
//   vector (conn, gains, wl, wc, label, alive, in A, cloud) lives in the
//   lane's registers, templated on columns per lane so that nothing is
//   indexed dynamically.  An absorb step is two warp reductions (redux.sync)
//   and a row read from shared memory: no block barrier.  Several graphs
//   share a block, one per warp, and never synchronise with each other.
// * solve_graph: one block per graph, the full n x n matrix in a per-block
//   scratch in device memory, the vectors in shared memory; one
//   __syncthreads per absorb step (the cross-warp half of the argmax).  Kept
//   for the graphs above the packed limit, and for any bucket whose
//   adjacency is not exactly symmetric: it reads rows and merges rows and
//   columns as the reference does, so it needs no symmetry (on a symmetric
//   matrix its row and column terms are the same numbers in the same order).
//
// The absorb chain, the packed index map, the order-preserving score key
// and the two-step warp argmax are shared with mcop_phase.cu (B3).
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
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxGraphsPerBlock = 8;

// ---------------------------------------------------------------------------
// The packed upper triangle of a symmetric n x n matrix with a zero diagonal:
// element (i, j), i < j, lies at tri_row(i, n) + j (rows i = 0, 1, ... one
// after another, each holding columns i + 1 .. n - 1).
// ---------------------------------------------------------------------------

__host__ __device__ inline int tri_row(int i, int n) {
  return i * (2 * n - i - 1) / 2 - i - 1;
}

__host__ __device__ inline size_t tri_floats(int n) {
  return (size_t)n * (n - 1) / 2;
}

// Bytes of a packed matrix, padded to whole 16-byte chunks.
__host__ __device__ inline size_t tri_bytes(int n) {
  return (tri_floats(n) * 4 + 15) / 16 * 16;
}

// Index of element (v, j), j != v, of a working matrix given rv = row(v) and
// rj = row(j): full row-major (a[v n + j]) or packed.
template <bool kPacked>
struct Rows {
  float* a;
  int n;
  __device__ __forceinline__ int row(int v) const {
    return kPacked ? tri_row(v, n) : v * n;
  }
  __device__ __forceinline__ int at(int rv, int v, int j, int rj) const {
    return (!kPacked || j > v) ? rv + j : rj + v;
  }
  // at() clamped into the matrix: for a column j >= n or j == v it reads
  // some element of it, which the caller then ignores.
  __device__ __forceinline__ int at_clamped(int rv, int v, int j, int rj) const {
    const int last = kPacked ? n * (n - 1) / 2 - 1 : n * n - 1;
    return min(max(at(rv, v, j, rj), 0), last);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 or 16 bytes from device to shared memory, asynchronously.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Warp reductions
// ---------------------------------------------------------------------------

// Order-preserving key of an f32 score: key(a) > key(b) iff a > b as floats,
// and key(-0) == key(+0), as the float '>' has them equal (-0 + +0 is +0).
__device__ __forceinline__ uint32_t score_key(float x) {
  const uint32_t u = __float_as_uint(x + 0.0f);
  return u ^ ((uint32_t)((int32_t)u >> 31) | 0x80000000u);
}

// First index of the maximum over the warp, from each lane's own first-index
// best (key, idx): the largest key, then the smallest index among the lanes
// that hold it (Algorithm 3's strict '<': ties go to the lowest index).
__device__ __forceinline__ int warp_argmax(uint32_t key, int idx) {
  const uint32_t top = __reduce_max_sync(kFull, key);
  return (int)__reduce_min_sync(kFull, key == top ? (uint32_t)idx : 0xffffffffu);
}

// Sum over the warp; every lane gets the same bits (a butterfly: each level
// adds the same two partial sums on both sides).  The order is fixed by the
// lane layout alone, so a graph's result does not depend on its block.
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Element v of a vector held as x[k] = element lane + 32 k.  Every x[k] is
// shuffled and the one wanted kept afterwards: selecting x[v >> 5] first
// lets the compiler index the array dynamically, which moves it to local
// memory for every other use as well.
template <int CPL, typename T>
__device__ __forceinline__ T lane_value(const T (&x)[CPL], int v) {
  const int kv = v >> 5, from = v & 31;
  T out = __shfl_sync(kFull, x[0], from);
#pragma unroll
  for (int k = 1; k < CPL; ++k) {
    const T got = __shfl_sync(kFull, x[k], from);
    if (k == kv) out = got;
  }
  return out;
}

__device__ __forceinline__ bool bit(uint32_t m, int k) { return (m >> k) & 1u; }

// Algorithm 3 from A = {src}: absorb n_alive - 1 vertices, each the
// first-index argmax of conn - gain over the alive vertices outside A, and
// add its row to conn (only where a candidate is left: no other entry is read
// again).  Bit k of `alive` / `in_a` is column lane + 32 k; columns >= n are
// never alive.  rj[k] = A.row(lane + 32 k).  Returns (s, t), the last two
// absorbed (both src when n_alive < 2).  Every lane loads all CPL entries
// of the row (at_clamped) and keeps what it needs by a select.
template <int CPL, bool kPacked>
__device__ __forceinline__ int2 absorb_chain(const Rows<kPacked>& A, int lane,
                                             int n_alive, int src, float (&conn)[CPL],
                                             const float (&gain)[CPL],
                                             const int (&rj)[CPL], uint32_t alive,
                                             uint32_t& in_a) {
  int s = src, t = src;
  for (int step = 0; step + 1 < n_alive; ++step) {
    // the lane's first-index best: a tree over k (depth log2 CPL) that keeps
    // the lower column unless the higher one is strictly larger
    float sc[CPL];
    int ix[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      sc[k] = bit(alive & ~in_a, k) ? conn[k] - gain[k] : kNegInf;
      ix[k] = lane + 32 * k;
    }
#pragma unroll
    for (int w = 1; w < CPL; w *= 2)
#pragma unroll
      for (int k = 0; k + w < CPL; k += 2 * w)
        if (sc[k + w] > sc[k]) {
          sc[k] = sc[k + w];
          ix[k] = ix[k + w];
        }
    const int v = warp_argmax(score_key(sc[0]), ix[0]);
    in_a |= ((v & 31) == lane ? 1u : 0u) << (v >> 5);
    const int rv = A.row(v);
    float r[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      r[k] = A.a[A.at_clamped(rv, v, lane + 32 * k, rj[k])];
    // g = +0 computed from every loaded value, so that each add waits for
    // all the loads: the compiler then issues them together instead of
    // pairing each load with its add, where a warp alone on its SM waits for
    // one load at a time (tools/torch_kernel_probe.py mcop-variants).
    // r + (+0) changes no value but the sign of a zero, which no key sees.
    float m[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) m[k] = r[k];
#pragma unroll
    for (int w = 1; w < CPL; w *= 2)
#pragma unroll
      for (int k = 0; k + w < CPL; k += 2 * w) m[k] = fminf(m[k], m[k + w]);
    const float g = m[0] - m[0];
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      conn[k] = bit(alive & ~in_a, k) ? conn[k] + (r[k] + g) : conn[k];
    s = t;
    t = v;
  }
  return make_int2(s, t);
}

// Eq. 10 cut-of-the-phase: C_local - gains[t] + sum over alive j of A[t][j],
// the lane's columns in ascending order, then warp_sum.  A packed matrix has
// no diagonal; a full one's A[t][t] is added as the reference adds it.
template <int CPL, bool kPacked>
__device__ __forceinline__ float phase_cut(const Rows<kPacked>& A, int lane, int t,
                                           float ctot, const float (&gain)[CPL],
                                           const int (&rj)[CPL], uint32_t alive) {
  const int rt = A.row(t);
  float r[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    r[k] = A.a[bit(alive, k) && (!kPacked || j != t) ? A.at(rt, t, j, rj[k]) : 0];
  }
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    part = bit(alive, k) && (!kPacked || j != t) ? part + r[k] : part;
  }
  const float comm = warp_sum(part);
  return (ctot - lane_value<CPL>(gain, t)) + comm;
}

// Algorithm 1 on a packed matrix, for the lane's columns: row s += row t
// (j not in {s, t}), row t = 0, read from `from` and written to `to` (the
// same matrix, or a staged copy of it and the original).  Element {s, j} and
// {t, j} are touched only by the owner of column j ({s, t} by the owner of
// s), so no two lanes write one element; the caller orders these writes
// after every read of the phase.
template <int CPL>
__device__ __forceinline__ void packed_merge(const float* from, float* to, int n, int lane,
                                             int s, int t, const int (&rj)[CPL]) {
  const int rs = tri_row(s, n), rt = tri_row(t, n);
  const Rows<true> A{to, n};
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    if (j >= n || j == t) continue;
    const int et = A.at(rt, t, j, rj[k]);
    if (j != s) {
      const int es = A.at(rs, s, j, rj[k]);
      to[es] = from[es] + from[et];
    }
    to[et] = 0.f;
  }
}

// ---------------------------------------------------------------------------
// Warp-per-graph solve (B1 and B2 up to the packed limit)
// ---------------------------------------------------------------------------

// Columns a lane holds for an n-vertex graph in the warp bodies (0: none fits).
__host__ __device__ inline int warp_cpl(int n) {
  return n <= 32 ? 1 : n <= 64 ? 2 : n <= 128 ? 4 : n <= 256 ? 8 : n <= 352 ? 11 : 0;
}

// Full solve of the graph in the warp's packed matrix P (shared memory,
// written and made visible to the warp by the caller) with node weights
// wl/wc and pinned mask `pin` (bit k) in registers.  Writes the minimum
// Eq.-10 cut and the local mask (1 = run locally).  Called by all 32 lanes.
template <int CPL>
__device__ void solve_graph_warp(float* P, int n, int lane, float (&wl)[CPL],
                                 float (&wc)[CPL], uint32_t pin, float* cut_out,
                                 uint8_t* mask_out) {
  const Rows<true> A{P, n};
  int rj[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) rj[k] = tri_row(lane + 32 * k, n);

  // ---- C_local and the anchor -----------------------------------------
  float part = 0.f, part_l = 0.f, part_c = 0.f, n_pin = 0.f;
  int first = kNoIndex;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    if (j >= n) continue;
    part += wl[k];
    if (bit(pin, k)) {
      part_l += wl[k];
      part_c += wc[k];
      n_pin += 1.f;
      first = min(first, j);
    }
  }
  const float ctot = warp_sum(part);
  const float pin_l = warp_sum(part_l);
  const float pin_c = warp_sum(part_c);
  const int count_pin = (int)warp_sum(n_pin);  // exact: n < 2^24
  first = (int)__reduce_min_sync(kFull, (uint32_t)first);
  const bool any_pinned = first != kNoIndex;
  int src = any_pinned ? first : 0;
  const float wl0 = lane_value<CPL>(wl, src), wc0 = lane_value<CPL>(wc, src);
  const float wl_src = pin_l + (any_pinned ? 0.f : wl0);
  const float wc_src = pin_c + (any_pinned ? 0.f : wc0);

  // ---- fold every other pinned vertex into the anchor ------------------
  if (count_pin > 1) {
    uint32_t pins[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) pins[k] = __ballot_sync(kFull, bit(pin, k));
    // fold[j] = sum over folded rows i of A[i][j], rows in ascending order
    float fold[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k) fold[k] = 0.f;
#pragma unroll
    for (int kk = 0; kk < CPL; ++kk) {
      for (uint32_t m = pins[kk]; m; m &= m - 1) {
        const int i = 32 * kk + __ffs(m) - 1;
        if (i == src) continue;
        const int ri = tri_row(i, n);
#pragma unroll
        for (int k = 0; k < CPL; ++k) {
          const int j = lane + 32 * k;
          if (j < n && j != i) fold[k] += P[A.at(ri, i, j, rj[k])];
        }
      }
    }
    __syncwarp();  // every folded row read before it is cleared
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      if (j >= n) continue;
      if (bit(pin, k) && j != src) {  // a folded vertex: its whole row
        for (int i = 0; i < n; ++i)
          if (i != j) P[i < j ? tri_row(i, n) + j : rj[k] + i] = 0.f;
      } else {
#pragma unroll
        for (int kk = 0; kk < CPL; ++kk) {
          for (uint32_t m = pins[kk]; m; m &= m - 1) {
            const int i = 32 * kk + __ffs(m) - 1;
            if (i != src && i != j) P[i < j ? tri_row(i, n) + j : rj[k] + i] = 0.f;
          }
        }
      }
    }
    __syncwarp();
    const int rsrc = tri_row(src, n);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      if (j < n && j != src && !bit(pin, k)) P[A.at(rsrc, src, j, rj[k])] += fold[k];
    }
  }
  uint32_t alive = 0, cloud = 0;
  int label[CPL];
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    label[k] = j;
    if (j >= n) continue;
    const bool other = bit(pin, k) && j != src;
    if (!other) alive |= 1u << k;
    if (bit(pin, k)) label[k] = src;
    if (other) {
      wl[k] = 0.f;
      wc[k] = 0.f;
    }
    if (j == src) {
      wl[k] = wl_src;
      wc[k] = wc_src;
    }
  }
  int n_alive = n - (any_pinned ? count_pin - 1 : 0);
  float best_cut = kPosInf;
  __syncwarp();

  // ---- Algorithm 2: one phase per surviving vertex beyond the first ----
  while (n_alive > 1) {
    float gain[CPL], conn[CPL];
    uint32_t in_a = 0;
    const int rsrc = tri_row(src, n);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      gain[k] = wl[k] - wc[k];
      conn[k] = (bit(alive, k) && j != src) ? P[A.at(rsrc, src, j, rj[k])] : 0.f;
      if (j == src) in_a |= 1u << k;
    }
    const int2 st =
        absorb_chain<CPL, true>(A, lane, n_alive, src, conn, gain, rj, alive, in_a);
    const int s = st.x, t = st.y;
    const float cut = phase_cut<CPL, true>(A, lane, t, ctot, gain, rj, alive);
    if (cut < best_cut) {
      best_cut = cut;
      cloud = 0;
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        if (label[k] == t) cloud |= 1u << k;
    }

    // Algorithm 1: merge t into s, after every lane's reads of this phase.
    __syncwarp();
    packed_merge<CPL>(P, P, n, lane, s, t, rj);
    const float wl_t = lane_value<CPL>(wl, t), wc_t = lane_value<CPL>(wc, t);
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const int j = lane + 32 * k;
      if (label[k] == t) label[k] = s;
      if (j == s) {
        wl[k] += wl_t;
        wc[k] += wc_t;
      }
      if (j == t) {
        wl[k] = 0.f;
        wc[k] = 0.f;
        alive &= ~(1u << k);
      }
    }
    if (t == src) src = s;  // the anchor follows a merged source
    --n_alive;
    __syncwarp();  // the merged rows, for the next phase's reads by other lanes
  }

  if (lane == 0) *cut_out = best_cut;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    const int j = lane + 32 * k;
    if (j < n) mask_out[j] = bit(cloud, k) ? 0 : 1;
  }
  __syncwarp();  // P is overwritten by the warp's next graph
}

// ---------------------------------------------------------------------------
// Block-per-graph solve with a scratch matrix (B1 and B2 above the packed
// limit).  Thread `tid` owns columns tid, tid+T, tid+2T, ...  Every
// per-vertex vector lives in shared memory and element j is read and written
// only by the owner of column j unless a comment says otherwise, so one
// absorb step costs exactly one __syncthreads(): the cross-warp half of the
// argmax.
// ---------------------------------------------------------------------------

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
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
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
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
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
    float ov = __shfl_xor_sync(kFull, v, o);
    int oi = __shfl_xor_sync(kFull, i, o);
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
// locally).  Must be called by every thread of the block.  FULL folds and
// merges true columns (a matrix that is not exactly symmetric, read as the
// reference reads it); without it the fold and the merge read rows only and
// mirror them into the columns, one coalesced read, which needs an exactly
// symmetric matrix.  On a symmetric matrix both give the same numbers.
template <bool FULL>
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
  // fold[j] = sum over folded rows i of A[i][j] (row src gains it) and, with
  // FULL, sum over folded columns i of A[j][i] (column src gains it; else
  // the row sum), i ascending; the column sum waits in gains, which every
  // phase refreshes.
  for (int j = tid; j < n; j += nt) {
    float f = 0.f, fc = 0.f;
    for (int i = 0; i < n; ++i)
      if (pin[i] && i != src) {
        f += A[i * n + j];
        if constexpr (FULL) fc += A[j * n + i];
      }
    ws.conn[j] = f;
    if constexpr (FULL) ws.gains[j] = fc;
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
      A[j * n + src] += FULL ? ws.gains[j] : f;
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

    // Algorithm 1: merge t into s, row s += row t and column s += column t
    // (without FULL, row t's value stands for column t's).  Column owner j
    // writes A[s][j], A[j][s], A[t][j], A[j][t]; owner s also clears
    // A[s][s], so no element has two writers.
    for (int j = tid; j < n; j += nt) {
      if (j != s && j != t) {
        const float r = A[t * n + j];
        A[s * n + j] += r;
        A[j * n + s] += FULL ? A[j * n + t] : r;
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

// ---------------------------------------------------------------------------
// Launch geometry shared by B1 and B2
// ---------------------------------------------------------------------------

struct Plan {
  int cpl;               // columns a lane (warp variant), 0 = block variant
  int threads;
  int smem_bytes;
  int resident_blocks;
  int graphs_per_block;  // warps a block in the warp variant, else 1
};

// Largest n whose packed adjacency fits one block's shared memory: the warp
// variant's limit.
inline int packed_limit(int smem_optin) {
  int n = 2;
  while (warp_cpl(n + 1) > 0 && tri_bytes(n + 1) <= (size_t)smem_optin) ++n;
  return n;
}

inline cudaError_t device_limits(int* smem_optin, int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// `warp_kernel` is the warp variant for warp_cpl(n) (null above the packed
// limit), `block_kernel` the scratch variant.  `want_gpb` > 0 asks for that
// many graphs a block (the result is bitwise the same for every choice);
// 0 takes the count that keeps the most graphs resident on an SM, lowered
// so that a small batch still spreads over every SM.  `full_rows` takes the
// scratch variant at every n (a matrix that is not exactly symmetric).
inline cudaError_t make_plan(int n, int batch, int want_gpb, const void* warp_kernel,
                             const void* block_kernel, Plan* plan,
                             bool full_rows = false) {
  int smem_optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = device_limits(&smem_optin, &sms);
  if (err != cudaSuccess) return err;
  if (!full_rows && n <= packed_limit(smem_optin)) {
    const size_t per = tri_bytes(n);
    const int fit = (int)(smem_optin / per);
    err = cudaFuncSetAttribute(warp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_optin);
    if (err != cudaSuccess) return err;
    int g = want_gpb;
    if (g <= 0) {
      int most = 0;
      for (int c = 1; c <= kMaxGraphsPerBlock && c <= fit; ++c) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp_kernel, 32 * c,
                                                            c * per);
        if (err != cudaSuccess) return err;
        if (per_sm * c > most) {
          most = per_sm * c;
          g = c;
        }
      }
      const int spread = (batch + sms - 1) / sms;
      if (g > spread) g = spread > 0 ? spread : 1;
    }
    if (g < 1 || g > kMaxWarps || (size_t)g * per > (size_t)smem_optin)
      return cudaErrorInvalidValue;
    plan->cpl = warp_cpl(n);
    plan->threads = 32 * g;
    plan->smem_bytes = (int)(g * per);
    plan->graphs_per_block = g;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, warp_kernel,
                                                        plan->threads, plan->smem_bytes);
  } else {
    plan->cpl = 0;
    plan->threads = 256;
    plan->smem_bytes = (int)workspace_bytes(n);
    plan->graphs_per_block = 1;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_kernel,
                                                        plan->threads, plan->smem_bytes);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  plan->resident_blocks = per_sm * sms;
  return cudaSuccess;
}

}  // namespace repro_torch
