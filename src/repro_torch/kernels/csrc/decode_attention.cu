// B6: attention of a few queries over a plain KV cache (flash-decoding) for
// Hopper: `models/attention.py:decode_attention` on its KV-cache route.
//
// Replaces no TPU kernel.  The JAX package's `_flash_decode_attention`
// (src/repro/models/attention.py:72) is two jnp einsums over the cache in
// float32; the port ran the same function as ~44 eager launches a layer
// (`_decode_local`: both 8 192-slot chunks of k and v cast to float32, the
// scores and P V as batched products, an online softmax of some fifteen
// elementwise ops).  This kernel computes exactly that function:
//
//   * a row is one (query, query head) of a kv head: rows r = qi g + gi for
//     the g = H / Hkv query heads kvh g .. kvh g + g - 1 of kv head kvh,
//     never a repeated copy of K/V;
//   * slot j holds position j and is seen by a row at position p iff j <= p
//     and, with a window W, j > p - W;
//   * the score is scale (q . k), the products of two bf16 values exact in
//     f32 and summed in f32; the softmax in f32; P V takes P in f32 and V
//     widened to f32 in registers (P is never rounded); the output is
//     written in bf16, q's dtype.
//
// Slots past the last position any row sees are not read: in the reference
// they add exp(NEG_INF - m) = 0 exactly.  Only the order of the f32 sums
// differs, and the softmax's max: the reference rescales its running sums
// at each of its chunks, this kernel takes each block's max over all of its
// slots at once (no rescaling inside a block, one weighing of the blocks in
// the combine).  The dot products are explicit fused multiply-adds (the
// build passes -fmad=false): in q . k the product of two bf16 values is
// exact, so fmaf rounds as the separate multiply and add do; in P V fmaf
// rounds once where a multiply and an add round twice, as the f32 batched
// products of the reference do on this card.
//
// What bounds it on this card: bytes.  At the served shape (B 8, 4 kv heads
// of 128, 8 201 slots) a layer reads 134 MB of K and V once, 40 us at 3.35
// TB/s, against 0.94 GFLOP of f32 products, 14 us at the CUDA cores' 67
// TFLOP/s.  So the design moves each cache byte once, keeps enough of them
// in flight, and keeps the block's steps few and wide (on the card a block
// with no loads at all took 60 us where one that rescaled per tile, with
// three barriers a tile, took 75 us with them; tools/torch_kernel_probe.py
// decode-variants):
//
//   * one block of 128 threads per (slot split, batch, kv head); the split
//     count (`splits`, chosen by the wrapper from the blocks the card holds
//     at once) fills the card, since B x Hkv pairs alone would occupy a
//     quarter of it.  Each block finds the slots its rows can see from the
//     positions on the device (no read-back to the host) and takes its share
//     of them, at most kMaxTiles tiles of kT slots;
//   * K tiles, then V tiles, stream through one kStages-deep shared-memory
//     ring by cp.async, 16 bytes a thread, so the next tile's load overlaps
//     this tile's arithmetic (the first V tile's the softmax); one barrier a
//     tile.  Two stages and at most 16 tiles a block leave 68 KB of shared
//     memory a block at hd 128 and registers held to 168 a thread, so three
//     blocks share an SM: 60.5 us against 63.3 for three stages, 24 tiles and
//     two blocks (decode-variants);
//   * pass 1, scores: a lane takes kSlots slots and an eighth of hd,
//     multiplying each K chunk it reads into the ROWS query rows and each
//     query chunk into its kSlots slots (the queries are f32 in shared
//     memory, laid out so that the eight lanes of a slot read one 128-byte
//     line); the eight lanes' partial sums are added by a reduce-scatter of
//     shuffles, and each lane keeps its kSlots ROWS / 8 whole dot products in
//     shared memory (ROWS x kMaxTiles kT f32);
//   * the softmax once, one warp a row: the max over the block's slots the
//     row sees, P = exp(s - max) and its sum;
//   * pass 2, P V: a lane takes 8 columns of a group of slots of each V
//     tile; its ROWS x 8 accumulators live in registers, and the groups'
//     partial sums are added at the end;
//   * each block writes its rows' max m, exp-sum l and unnormalised output to
//     f32 scratch; `decode_attention_combine`, one block per (batch, kv
//     head, row), weighs the splits by exp(m - max m) and divides.  Two
//     launches a call.
//
// Rows are g Sq <= 8 (instantiated for 2, 4 and 8 rows, the unused ones
// zero), hd 64 or 128, bf16.  A row that sees no slot (a position below 0,
// or past the cache by more than the window) is written as 0; the KV-cache
// route never makes one, as a query's own slot is always written before it
// is read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro_torch {
namespace decode {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;         // slots a tile
constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;     // tiles in the shared-memory ring
constexpr int kParts = 8;      // lanes that share a slot's dot product in the score step
constexpr int kSlots = kT * kParts / kThreads;  // slots a thread in the score step: 4
constexpr int kMaxTiles = 16;  // tiles a block: its scores stay in shared memory

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared, asynchronously; zero-filled when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// eight bf16 (16 bytes, the lower address first) as f32: exact
__device__ __forceinline__ void widen8(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One step of the score step's reduce-scatter over the lanes that differ in
// `bit`: each keeps W of its 2 W partial sums (the upper half where its bit
// is set) and adds its partner's of the same.
template <int W>
__device__ __forceinline__ void halve(float* v, int bit, int lane) {
  const bool up = (lane & bit) != 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const float send = up ? v[k] : v[k + W];
    const float keep = up ? v[k + W] : v[k];
    v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, bit));
  }
}

template <int HD, int ROWS>
struct Smem {
  static constexpr int kRing = kStages * kT * HD * 2;      // K tiles, then V tiles
  static constexpr int kQ = ROWS * HD * 4;
  static constexpr int kS = ROWS * kMaxTiles * kT * 4;     // scores, then P; at the end
                                                           // the slot groups' outputs
  static constexpr int kPos = ROWS * 8;
  static constexpr int kStats = 2 * ROWS * 4;              // the block's m and l
  static constexpr int kRed = kWarps * (32 / (HD / 8)) * ROWS * HD * 4;
  static constexpr int bytes = kRing + kQ + kS + kPos + kStats;
  static_assert(kRed <= kS, "the end's reduction reuses the scores");
  static_assert(bytes <= 232448, "a block may have 227 KB of shared memory");
};

struct Strides {
  long long q[3], k[3], v[3];  // (batch, slot or query, head) in elements
};

// grid (splits, B * Hkv); R = g * Sq rows of ROWS; a block's share of the
// visible tiles at most kMaxTiles.  Writes part_ml[(pair, split, r)] = (m, l)
// and part_o[(pair, split, r)][HD].
template <int HD, int ROWS>
__global__ void __launch_bounds__(kThreads, 3)
decode_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const long long* __restrict__ qpos,
                        float* __restrict__ part_ml, float* __restrict__ part_o, int Sq,
                        int Hkv, int g, int S, int window, float scale, Strides sd) {
  using L = Smem<HD, ROWS>;
  constexpr int CH = HD / 8;           // 16-byte chunks a row
  constexpr int M = CH / kParts;       // chunks a lane's part of a dot product
  constexpr int N = kSlots * ROWS;     // partial dot products a lane
  constexpr int LG = HD / 8;           // lanes a slot group in P V (8 columns each)
  constexpr int SG = 32 / LG;          // slot groups a warp
  constexpr int SPG = kT / kWarps / SG;  // slots a slot group
  constexpr int SMAX = kMaxTiles * kT;   // a score row's length
  static_assert(CH % kParts == 0 && N % kParts == 0 && SPG % 4 == 0, "shapes");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* qs = reinterpret_cast<float*>(smem + L::kRing);
  float* sc = reinterpret_cast<float*>(smem + L::kRing + L::kQ);
  long long* pos = reinterpret_cast<long long*>(smem + L::kRing + L::kQ + L::kS);
  float* m_s = reinterpret_cast<float*>(smem + L::kRing + L::kQ + L::kS + L::kPos);
  float* l_s = m_s + ROWS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, splits = gridDim.x, pair = blockIdx.y;
  const int b = pair / Hkv, kvh = pair % Hkv;
  const int R = g * Sq;

  // the rows' queries in f32 (rows past R are 0), laid out so that the
  // eight lanes of a slot read their eight parts of a row as one 128-byte
  // line: element (r, chunk m kParts + p, e) at ((r M + m) 2 + e / 4) 32 +
  // 4 p + e % 4
  for (int e = tid; e < ROWS * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, c = d / 8, x = d % 8;
    float val = 0.f;
    if (r < R) {
      const int qi = r / g, h = kvh * g + r % g;
      val = __bfloat162float(q[b * sd.q[0] + qi * sd.q[1] + h * sd.q[2] + d]);
    }
    qs[((r * M + c / kParts) * 2 + x / 4) * 32 + (c % kParts) * 4 + x % 4] = val;
  }
  for (int r = tid; r < ROWS; r += kThreads) pos[r] = r < R ? qpos[r / g] : -1;

  // the slots any row sees, [lo, hi), in tiles split evenly over the blocks
  long long pmin = qpos[0], pmax = qpos[0];
  for (int i = 1; i < Sq; ++i) {
    pmin = min(pmin, qpos[i]);
    pmax = max(pmax, qpos[i]);
  }
  const long long lo = window > 0 ? max(0LL, pmin - window + 1) : 0LL;
  const long long hi = min((long long)S, pmax + 1);
  const int span = hi > lo ? (int)(hi - lo) : 0;
  const int tiles = (span + kT - 1) / kT;
  const int per = (tiles + splits - 1) / splits;
  const int t0 = min(tiles, split * per), ntiles = min(tiles, t0 + per) - t0;
  const int jlo = (int)lo + t0 * kT;
  const int jhi = min((int)hi, jlo + ntiles * kT);

  // the ring's units: K tiles 0 .. ntiles - 1, then V tiles
  const bf16* kg = k + b * sd.k[0] + kvh * sd.k[2];
  const bf16* vg = v + b * sd.v[0] + kvh * sd.v[2];
  const int units = 2 * ntiles;
  auto load_unit = [&](int u, int stage) {
    const bool is_v = u >= ntiles;
    const int j0 = jlo + (is_v ? u - ntiles : u) * kT;
    const bf16* src = is_v ? vg : kg;
    const long long stride = is_v ? sd.v[1] : sd.k[1];
    bf16* dst = ring + stage * kT * HD;
    for (int e = tid; e < kT * CH; e += kThreads) {
      const int r = e / CH, c = e % CH;
      const int j = j0 + r;
      const bool in = j < jhi;
      cp_async16(smem_addr(dst + r * HD + c * 8), src + (in ? j : jlo) * stride + c * 8, in);
    }
  };
  // unit u has landed, every thread is done with unit u - 1, and unit u +
  // kStages - 1 is on its way
  auto advance = [&](int u) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (u + kStages - 1 < units) load_unit(u + kStages - 1, (u + kStages - 1) % kStages);
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < units) load_unit(s, s);
    cp_async_commit();
  }

  // pass 1, the scores: each lane multiplies its part (chunks p + kParts m)
  // of kSlots slots into the ROWS rows; the eight parts are summed across
  // the lanes by a reduce-scatter that leaves each lane N / 8 whole dot
  // products, kept in shared memory for the block's softmax
  const int p = lane % kParts, sg = tid / kParts;
  const int base = (lane & 4 ? N / 2 : 0) + (lane & 2 ? N / 4 : 0) + (lane & 1 ? N / 8 : 0);
  for (int t = 0; t < ntiles; ++t) {
    advance(t);
    const bf16* kt = ring + (t % kStages) * kT * HD;
    float acc[N];  // acc[i ROWS + r]
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = 0.f;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int c = p + kParts * m;
      float kf[kSlots][8];
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
        widen8(*reinterpret_cast<const uint4*>(kt + (sg + 16 * i) * HD + c * 8), kf[i]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qa = *reinterpret_cast<const float4*>(qs + ((r * M + m) * 2) * 32 + p * 4);
        const float4 qb = *reinterpret_cast<const float4*>(qs + ((r * M + m) * 2 + 1) * 32 + p * 4);
        const float qf[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int i = 0; i < kSlots; ++i) {
          float a = acc[i * ROWS + r];
#pragma unroll
          for (int d = 0; d < 8; ++d) a = __fmaf_rn(qf[d], kf[i][d], a);
          acc[i * ROWS + r] = a;
        }
      }
    }
    halve<N / 2>(acc, 4, lane);
    halve<N / 4>(acc, 2, lane);
    halve<N / 8>(acc, 1, lane);
#pragma unroll
    for (int e = 0; e < N / 8; ++e) {
      const int x = base + e, i = x / ROWS, r = x % ROWS;
      sc[r * SMAX + t * kT + sg + 16 * i] = acc[e];
    }
  }
  __syncthreads();  // every score is written

  // the softmax over the block's slots, one warp a row: the scaled scores'
  // max over the slots the row sees, P = exp(s - max) (0 where unseen, and
  // on the last tile's slots past the block's), and their sum
  const int nslots = jhi - jlo, padded = ntiles * kT;
  for (int r = warp; r < ROWS; r += kWarps) {
    const long long pr = pos[r];
    float* row = sc + r * SMAX;
    float mx = -INFINITY;
    for (int c = lane; c < padded; c += 32) {
      const int j = jlo + c;
      if (r < R && c < nslots && j <= pr && (window <= 0 || j > pr - window))
        mx = fmaxf(mx, __fmul_rn(row[c], scale));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int c = lane; c < padded; c += 32) {
      const int j = jlo + c;
      const bool seen = r < R && c < nslots && j <= pr && (window <= 0 || j > pr - window);
      const float e = seen ? expf(__fmul_rn(row[c], scale) - mx) : 0.f;
      row[c] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }

  // pass 2, O = P V: lane (slot group gi, columns col .. col + 7) of this
  // warp's quarter of each V tile; V past the block's slots is zero-filled
  const int gi = lane / LG, col = (lane % LG) * 8;
  const int pj = warp * (kT / kWarps) + gi * SPG;  // the group's first slot in a tile
  float o[ROWS][8];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int d = 0; d < 8; ++d) o[r][d] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    advance(ntiles + t);  // also: P is written
    const bf16* vt = ring + ((ntiles + t) % kStages) * kT * HD + pj * HD + col;
    const float* pt = sc + t * kT + pj;
#pragma unroll
    for (int jj = 0; jj < SPG; jj += 4) {
      float vf[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        widen8(*reinterpret_cast<const uint4*>(vt + (jj + i) * HD), vf[i]);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 pp = *reinterpret_cast<const float4*>(pt + r * SMAX + jj);
        const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int d = 0; d < 8; ++d) o[r][d] = __fmaf_rn(pv[i], vf[i][d], o[r][d]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // P is read: the scores' space takes the groups' outputs

  constexpr int NP = kWarps * SG;  // partial outputs: one a slot group
  float* red = sc;
  const int pid = warp * SG + gi;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float4* dst = reinterpret_cast<float4*>(red + (pid * ROWS + r) * HD + col);
    dst[0] = make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
    dst[1] = make_float4(o[r][4], o[r][5], o[r][6], o[r][7]);
  }
  __syncthreads();
  const long long base_out = ((long long)pair * splits + split) * R;
  for (int e = tid; e < R * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < NP; ++w) x += red[(w * ROWS + r) * HD + d];
    part_o[(base_out + r) * HD + d] = x;
  }
  for (int r = tid; r < R; r += kThreads) {
    part_ml[(base_out + r) * 2] = m_s[r];
    part_ml[(base_out + r) * 2 + 1] = l_s[r];
  }
}

// grid (B * Hkv, R), HD threads: row r's splits' (m, l, o) weighed by
// exp(m - max m), summed and divided; out is a contiguous (B, Sq, H, HD)
// tensor.
__global__ void decode_attention_combine(const float* __restrict__ part_ml,
                                         const float* __restrict__ part_o,
                                         bf16* __restrict__ out, int splits, int Sq, int Hkv,
                                         int g) {
  extern __shared__ float ml[];  // [splits][2]
  const int pair = blockIdx.x, r = blockIdx.y, d = threadIdx.x, HD = blockDim.x;
  const int b = pair / Hkv, kvh = pair % Hkv, R = g * Sq;
  const long long base = (long long)pair * splits * R + r;  // split s at base + s R
  for (int s = d; s < splits; s += HD) {
    ml[2 * s] = part_ml[(base + (long long)s * R) * 2];
    ml[2 * s + 1] = part_ml[(base + (long long)s * R) * 2 + 1];
  }
  __syncthreads();
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[2 * s]);
  float den = 0.f, x = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float m = ml[2 * s];
    const float w = m == -INFINITY ? 0.f : expf(m - mx);
    den += w * ml[2 * s + 1];
    x = __fmaf_rn(w, part_o[(base + (long long)s * R) * HD + d], x);
  }
  const int qi = r / g, h = kvh * g + r % g;
  out[(((long long)b * Sq + qi) * Hkv * g + h) * HD + d] =
      __float2bfloat16_rn(den > 0.f ? __fdiv_rn(x, den) : 0.f);
}

template <int HD, int ROWS>
cudaError_t prepare() {
  static bool done = false;  // the attribute is set once a process
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<HD, ROWS>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Smem<HD, ROWS>::bytes);
  done = err == cudaSuccess;
  return err;
}

template <int HD, int ROWS>
cudaError_t resident(int* blocks) {
  cudaError_t err = prepare<HD, ROWS>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, decode_attention_kernel<HD, ROWS>, kThreads, Smem<HD, ROWS>::bytes);
}

// The arguments of one call.
struct Call {
  const void *q, *k, *v;
  const long long* qpos;
  void* out;
  float *part_ml, *part_o;
  int B, Sq, Hkv, g, S, window;
  float scale;
  int splits;
  Strides sd;
  cudaStream_t st;
};

template <int HD, int ROWS>
cudaError_t launch(const Call& a) {
  // a block's share of the visible tiles, at most a share of the cache's
  const int tiles = (a.S + kT - 1) / kT;
  if ((tiles + a.splits - 1) / a.splits > kMaxTiles) return cudaErrorInvalidValue;
  cudaError_t err = prepare<HD, ROWS>();
  if (err != cudaSuccess) return err;
  decode_attention_kernel<HD, ROWS>
      <<<dim3(a.splits, a.B * a.Hkv), kThreads, Smem<HD, ROWS>::bytes, a.st>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), a.qpos, a.part_ml, a.part_o, a.Sq, a.Hkv, a.g, a.S,
          a.window, a.scale, a.sd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int wbytes = 2 * a.splits * (int)sizeof(float);
  if (wbytes > 48 * 1024) return cudaErrorInvalidValue;
  decode_attention_combine<<<dim3(a.B * a.Hkv, a.g * a.Sq), HD, wbytes, a.st>>>(
      a.part_ml, a.part_o, static_cast<bf16*>(a.out), a.splits, a.Sq, a.Hkv, a.g);
  return cudaGetLastError();
}

struct Launch {
  const Call& call;
  template <int HD, int ROWS>
  cudaError_t run() const { return launch<HD, ROWS>(call); }
};
struct Resident {
  int* blocks;
  template <int HD, int ROWS>
  cudaError_t run() const { return resident<HD, ROWS>(blocks); }
};

// the instantiation for hd and R = g Sq rows: ROWS = 2, 4 or 8, the least
// that holds them (the score step's reduce-scatter leaves each of eight
// lanes kSlots ROWS / 8 dot products)
template <typename F>
cudaError_t dispatch(int hd, int R, const F& fn) {
  if (hd != 64 && hd != 128) return cudaErrorInvalidValue;
  if (R <= 2) return hd == 64 ? fn.template run<64, 2>() : fn.template run<128, 2>();
  if (R <= 4) return hd == 64 ? fn.template run<64, 4>() : fn.template run<128, 4>();
  if (R <= 8) return hd == 64 ? fn.template run<64, 8>() : fn.template run<128, 8>();
  return cudaErrorInvalidValue;
}

}  // namespace decode
}  // namespace repro_torch

// hd: 64 or 128 (q's, k's and v's head width).  rows: g Sq, at most 8.
// Writes the blocks of the kernel that takes these arguments resident on one
// SM of the current device to `blocks`.  Returns the CUDA error (0 on
// success).
extern "C" int repro_torch_decode_attention_resident(int hd, int rows, int* blocks) {
  return (int)repro_torch::decode::dispatch(hd, rows, repro_torch::decode::Resident{blocks});
}

// q (B, Sq, H, hd), k and v (B, S, Hkv, hd), all bf16, each with a contiguous
// last dim and the (batch, slot or query, head) element strides in `strides`
// (q's, k's, v's); k's and v's rows 16-byte aligned.  qpos: (Sq,) int64
// positions on the device.  out: contiguous bf16 (B, Sq, H, hd).  part_ml,
// part_o: f32 scratch of B Hkv splits g Sq x 2 and x hd; splits at least
// ceil(ceil(S / 64) / 16).  window <= 0 means none.  Two launches on
// `stream`; returns the CUDA error (0 on success).
extern "C" int repro_torch_decode_attention(const void* q, const void* k, const void* v,
                                            const long long* qpos, void* out, float* part_ml,
                                            float* part_o, int B, int Sq, int H, int Hkv,
                                            int S, int hd, int window, float scale, int splits,
                                            const long long* strides, void* stream) {
  if (B == 0 || Sq == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv || splits <= 0) return (int)cudaErrorInvalidValue;
  repro_torch::decode::Call call{q, k, v, qpos, out, part_ml, part_o, B, Sq, Hkv, H / Hkv,
                                 S, window, scale, splits, {}, static_cast<cudaStream_t>(stream)};
  for (int i = 0; i < 3; ++i) {
    call.sd.q[i] = strides[i];
    call.sd.k[i] = strides[3 + i];
    call.sd.v[i] = strides[6 + i];
  }
  return (int)repro_torch::decode::dispatch(hd, call.g * Sq, repro_torch::decode::Launch{call});
}
