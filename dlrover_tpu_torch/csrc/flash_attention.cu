// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/flash_attention.py:
//   flash_fwd_kernel       <- _fwd_kernel, launched by _fwd
//                             (pl.pallas_call "flash_attention_fwd")
//   flash_bwd_dkdv_kernel  <- _bwd_kernel, launched by _bwd: dk and dv
//   flash_bwd_dq_kernel    <- _bwd_kernel, launched by _bwd: dq
//
// What bounds them on this card. At the GPT-2 training shape (batch 8,
// T 1024, 12 heads, head_dim 64, causal, bf16) the forward moves ~50 MB
// (q, k, v, o; ~15 us at 3.35 TB/s) and does ~13 GFLOP (~13 us at
// 989 TFLOP/s), so bytes and tensor-core operations bound it about
// equally; the backward does 2.5x the operations and is bound by them.
// Neither kernel reaches either bound: they are the simple first
// version, limited by the issue rate of mma.sync on fragments read from
// shared memory with scalar loads, and by synchronous tile loads that
// nothing overlaps. wgmma, TMA and a load pipeline are later work.
//
// What the design does about it:
// * One block of 4 warps owns 64 query rows of one (batch, head) and
//   loops over 64-key tiles itself: the loop replaces the TPU's
//   sequential kv grid axis, and the running (max, sum, acc) live in
//   registers instead of VMEM scratch. Each warp owns 16 rows, so the
//   online softmax needs only shuffles inside a quad of lanes.
// * S = QK^T and PV are mma.sync.m16n8k16 bf16 products accumulated in
//   f32. P goes from the S accumulators straight into the A operand of
//   PV (the accumulator layout of two n8 tiles is the A layout of one
//   k16 step), so scores never touch shared or device memory.
// * The kv loop stops at the causal limit and starts at the sliding
//   window's band, the TPU's dead-block skip (_dispatch_block): causal
//   attention does half the work of full attention. Only tiles that
//   cross the diagonal, the band edge or a ragged edge evaluate the
//   element mask. The ragged key edge is masked in the kernel; there is
//   no padded copy of the inputs.
// * Inputs are read in the JAX layout [B, T, H, D] through strides (the
//   q/k/v views of the fused qkv projection need no copy); each row of a
//   64-row tile is one run of 2 * head_dim bytes, loaded 16 bytes a
//   thread.
// * The TPU backward accumulates dq for the whole sequence in one VMEM
//   scratch across an ordered grid. Hopper's blocks run in no order, so
//   the backward is two deterministic kernels: dkdv (one block per key
//   tile, looping over the query tiles that see it) and dq (one block
//   per query tile, looping over the key tiles it sees). Both recompute
//   P from the forward's lse. No atomics, so results are bitwise
//   repeatable. delta = rowsum(dO * O) - g_lse is computed outside.
// * head_dim 64 and 128 are template instances of the same kernels.
//   The tiles live in dynamic shared memory (at head_dim 128 the
//   forward's q, k and v tiles take 52 KB, past the 48 KB static limit).
//   The dk/dv kernel keeps its two [16 keys x head_dim] f32 accumulators
//   per warp in registers (128 a thread at head_dim 128) and reads its
//   K and V operand fragments from the resident shared-memory tiles
//   instead of holding them in registers too.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Every
// entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBlockQ = 64;   // query rows per block: 4 warps x 16
constexpr int kBlockK = 64;   // keys per tile
constexpr int kThreads = 128;
constexpr int kKTiles = kBlockK / 8;    // n8 tiles over a key tile
constexpr int kQTiles = kBlockQ / 8;    // n8 tiles over a query tile

// Per head_dim constants. Shared-memory row pitch in elements, kLd =
// D + 8: rows stay 16-byte aligned, and the pitch in 32-bit words is 4
// mod 32 words at D 64 (36) and D 128 (68), so the 8 rows x 4 words of
// a fragment read fall in 32 different banks.
template <int D>
struct Dims {
  static constexpr int kLd = D + 8;
  static constexpr int kKSteps = D / 16;  // k16 steps over head_dim
  static constexpr int kDTiles = D / 8;   // n8 tiles over head_dim
  static constexpr int kTile = 64 * kLd;  // elements of one 64-row tile
};

struct MaskArgs {
  int tq;        // query rows
  int seq_len;   // true key length: keys at or past it are masked
  int q_offset;  // global position of query row 0, in key coordinates
  int causal;
  int window;    // > 0: query at position i sees keys (i - window, i]
};

// Element strides of a [B, T, H, D] tensor whose D stride is 1.
struct Strides {
  long long b, t, h;
};

__device__ __forceinline__ bool visible(const MaskArgs& m, int qi, int kj) {
  if (qi >= m.tq || kj >= m.seq_len) return false;
  const int qp = m.q_offset + qi;
  if (m.causal && kj > qp) return false;
  if (m.window > 0 && qp - kj >= m.window) return false;
  return true;
}

// Whether the (q0, k0) tile pair needs the element mask: it crosses the
// diagonal, the band's lower edge, or a ragged edge.
__device__ __forceinline__ bool tile_needs_mask(const MaskArgs& m, int q0,
                                                int k0) {
  if (q0 + kBlockQ > m.tq || k0 + kBlockK > m.seq_len) return true;
  const int qp_first = m.q_offset + q0;
  const int qp_last = qp_first + kBlockQ - 1;
  if (m.causal && k0 + kBlockK - 1 > qp_first) return true;
  if (m.window > 0 && k0 < qp_last - m.window + 1) return true;
  return false;
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two adjacent bf16 as one 32-bit register (lower address, lower half).
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// p[0] and the element one shared-memory row (ld elements) below it.
template <int LD>
__device__ __forceinline__ uint32_t ld_col_pair(const bf16* p) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + LD);
  return lo | (hi << 16);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of one (batch, head) slice into shared memory,
// 16 bytes a thread; rows at or past `rows` are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long row_stride, int row0,
                                          int rows) {
  constexpr int kChunks = D / 8;
  for (int i = threadIdx.x; i < 64 * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(
          g + (long long)(row0 + r) * row_stride + c * 8);
    }
    *reinterpret_cast<uint4*>(s + r * Dims<D>::kLd + c * 8) = val;
  }
}

// mma.m16n8k16 operand fragments. Lane = 4 * g + t.
// A (16 x 16, row major) from rows [r0, r0 + 16) of a row-major tile,
// columns [16 kk, 16 kk + 16).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* s, int r0,
                                       int kk, int g, int t) {
  const bf16* p = s + (r0 + g) * LD + kk * 16 + 2 * t;
  a[0] = ld_pair(p);
  a[1] = ld_pair(p + 8 * LD);
  a[2] = ld_pair(p + 8);
  a[3] = ld_pair(p + 8 * LD + 8);
}

// B (16 x 8) for X Y^T, from a row-major Y tile whose rows are the n
// index: b(k, n) = Y[n0 + n][16 kk + k].
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t& b0, uint32_t& b1,
                                          const bf16* s, int n0, int kk,
                                          int g, int t) {
  const bf16* p = s + (n0 + g) * LD + kk * 16 + 2 * t;
  b0 = ld_pair(p);
  b1 = ld_pair(p + 8);
}

// B (16 x 8) for X Y, from a row-major Y tile whose rows are the k
// index: b(k, n) = Y[16 kk + k][n0 + n].
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t& b0, uint32_t& b1,
                                          const bf16* s, int n0, int kk,
                                          int g, int t) {
  const bf16* p = s + (kk * 16 + 2 * t) * LD + n0 + g;
  b0 = ld_col_pair<LD>(p);
  b1 = ld_col_pair<LD>(p + 8 * LD);
}

// The f32 accumulators of two n8 tiles (columns [0, 8) and [8, 16) of a
// k16 step), rounded to bf16, are the A operand of that step.
__device__ __forceinline__ void acc_to_a(uint32_t* a, const float* c0,
                                         const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Key tiles [begin, end) that the query tile at q0 can see.
__device__ __forceinline__ void key_tile_range(const MaskArgs& m, int q0,
                                               int& begin, int& end) {
  const int qp_first = m.q_offset + q0;
  const int qp_last = m.q_offset + min(q0 + kBlockQ, m.tq) - 1;
  int k_end = m.seq_len;
  if (m.causal) k_end = min(k_end, qp_last + 1);
  int k_begin = 0;
  if (m.window > 0) k_begin = max(0, qp_first - m.window + 1);
  begin = k_begin / kBlockK;
  end = k_end > k_begin ? (k_end + kBlockK - 1) / kBlockK : begin;
}

// Dynamic shared memory of the three kernels, in bytes.
template <int D>
constexpr int fwd_smem() { return 3 * Dims<D>::kTile * 2; }
template <int D>
constexpr int dkdv_smem() { return 4 * Dims<D>::kTile * 2 + 2 * kBlockQ * 4; }
template <int D>
constexpr int dq_smem() { return 2 * Dims<D>::kTile * 2; }

// O and lse for 64 query rows of one (batch, head). Grid: (query tiles,
// heads, batch); the last (most loaded, under causal) query tiles are
// scheduled first. Shared memory: q, k, v tiles.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int tk, int heads, Strides qs,
                     Strides ks, Strides vs, float scale, MaskArgs m) {
  using Dm = Dims<D>;
  constexpr int kLd = Dm::kLd, kKSteps = Dm::kKSteps, kDTiles = Dm::kDTiles;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + Dm::kTile;
  bf16* sv = sk + Dm::kTile;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  load_tile<D>(sq, qb, qs.t, q0, m.tq);
  __syncthreads();
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) load_a<kLd>(qf[kk], sq, wr, kk, g, t);

  float acc[kDTiles][4];
#pragma unroll
  for (int dn = 0; dn < kDTiles; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  // Rows g and g + 8 of this warp's strip: running max and this
  // thread's share of the running sum (summed over the quad at the end).
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};

  int kt_begin, kt_end;
  key_tile_range(m, q0, kt_begin, kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(sk, kb, ks.t, k0, tk);
    load_tile<D>(sv, vb, vs.t, k0, tk);
    __syncthreads();
    const bool masked = tile_needs_mask(m, q0, k0);

    float s[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t b0, b1;
        load_b_nk<kLd>(b0, b1, sk, nt * 8, kk, g, t);
        mma16816(s[nt], qf[kk], b0, b1);
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[nt][e] * scale;
        if (masked &&
            !visible(m, q0 + wr + g + 8 * r, k0 + nt * 8 + 2 * t + (e & 1)))
          x = -INFINITY;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(row_m[r], quad_max(mx[r]));
      // A row with no visible key so far keeps exp() finite: p = 0.
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = __expf(row_m[r] - m_use[r]);
      row_m[r] = m_new;
      row_l[r] *= alpha[r];
    }
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = __expf(s[nt][e] - m_use[e >> 1]);
        s[nt][e] = p;
        row_l[e >> 1] += p;
      }
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }
    // O += P V, with P in bf16 as the TPU kernel feeds the MXU.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        uint32_t b0, b1;
        load_b_kn<kLd>(b0, b1, sv, dn * 8, kk, g, t);
        mma16816(acc[dn], a, b0, b1);
      }
    }
  }

  const long long o_row = (long long)heads * D;  // o is contiguous
  bf16* ob = o + (long long)b * m.tq * o_row + h * D;
  float* lse_bh = lse + ((long long)b * heads + h) * m.tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(row_l[r]);
    const int qi = q0 + wr + g + 8 * r;
    if (qi >= m.tq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* orow = ob + qi * o_row;
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
    }
    if (t == 0) lse_bh[qi] = l > 0.f ? row_m[r] + logf(l) : -INFINITY;
  }
}

// dK and dV for 64 keys of one (batch, head), looping over the query
// tiles that see them. Grid: (key tiles, heads, batch). Shared memory:
// the q and dO tiles of the loop, this block's K and V tiles (resident:
// each warp reads its 16 keys' A fragments from them), lse and delta.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int tk, int heads,
    Strides qs, Strides ks, Strides vs, Strides dos, float scale,
    MaskArgs m) {
  using Dm = Dims<D>;
  constexpr int kLd = Dm::kLd, kKSteps = Dm::kKSteps, kDTiles = Dm::kDTiles;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + Dm::kTile;
  bf16* sk = sdo + Dm::kTile;
  bf16* sv = sk + Dm::kTile;
  float* slse = reinterpret_cast<float*>(sv + Dm::kTile);
  float* sdelta = slse + kBlockQ;

  const int k0 = blockIdx.x * kBlockK;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const float* lse_bh = lse + ((long long)b * heads + h) * m.tq;
  const float* delta_bh = delta + ((long long)b * heads + h) * m.tq;

  load_tile<D>(sk, k + b * ks.b + h * ks.h, ks.t, k0, tk);
  load_tile<D>(sv, v + b * vs.b + h * vs.h, vs.t, k0, tk);

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int dn = 0; dn < kDTiles; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;

  // Query rows that see at least one key of this tile.
  const int k_last = min(k0 + kBlockK, m.seq_len) - 1;
  int q_lo = 0, q_hi = m.tq;
  if (m.causal) q_lo = max(0, k0 - m.q_offset);
  if (m.window > 0) q_hi = min(m.tq, k_last + m.window - m.q_offset);
  const int qt_begin = q_lo / kBlockQ;
  const int qt_end = q_hi > q_lo ? (q_hi + kBlockQ - 1) / kBlockQ : qt_begin;

  for (int qt = qt_begin; qt < qt_end; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();
    load_tile<D>(sq, qb, qs.t, q0, m.tq);
    load_tile<D>(sdo, dob, dos.t, q0, m.tq);
    if (threadIdx.x < kBlockQ) {
      const int qi = q0 + threadIdx.x;
      slse[threadIdx.x] = qi < m.tq ? lse_bh[qi] : 0.f;
      sdelta[threadIdx.x] = qi < m.tq ? delta_bh[qi] : 0.f;
    }
    __syncthreads();
    const bool masked = tile_needs_mask(m, q0, k0);

    // P^T = exp(K Q^T * scale - lse): rows are this warp's keys,
    // columns the tile's queries. k16 steps outermost, so each K
    // fragment is read from shared memory once.
    float pt[kQTiles][4];
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) pt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t a[4];
      load_a<kLd>(a, sk, wr, kk, g, t);
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt) {
        uint32_t b0, b1;
        load_b_nk<kLd>(b0, b1, sq, nt * 8, kk, g, t);
        mma16816(pt[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float p = __expf(pt[nt][e] * scale - slse[col]);
        if (masked && !visible(m, q0 + col, k0 + wr + g + 8 * (e >> 1)))
          p = 0.f;
        pt[nt][e] = p;
      }
    // dV += P^T dO
#pragma unroll
    for (int kk = 0; kk < kBlockQ / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, pt[2 * kk], pt[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        uint32_t b0, b1;
        load_b_kn<kLd>(b0, b1, sdo, dn * 8, kk, g, t);
        mma16816(dv_acc[dn], a, b0, b1);
      }
    }
    // dS^T = P^T (V dO^T - delta) * scale, in place of P^T.
#pragma unroll
    for (int nt = 0; nt < kQTiles; ++nt) {
      float dpt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t a[4], b0, b1;
        load_a<kLd>(a, sv, wr, kk, g, t);
        load_b_nk<kLd>(b0, b1, sdo, nt * 8, kk, g, t);
        mma16816(dpt, a, b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        pt[nt][e] = pt[nt][e] * (dpt[e] - sdelta[col]) * scale;
      }
    }
    // dK += dS^T Q
#pragma unroll
    for (int kk = 0; kk < kBlockQ / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, pt[2 * kk], pt[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        uint32_t b0, b1;
        load_b_kn<kLd>(b0, b1, sq, dn * 8, kk, g, t);
        mma16816(dk_acc[dn], a, b0, b1);
      }
    }
  }

  const long long row = (long long)heads * D;  // dk, dv contiguous
  const long long base = (long long)b * tk * row + h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = k0 + wr + g + 8 * r;
    if (kj >= tk) continue;
    bf16* dkrow = dk + base + kj * row;
    bf16* dvrow = dv + base + kj * row;
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      *reinterpret_cast<uint32_t*>(dkrow + dn * 8 + 2 * t) =
          pack_bf16(dk_acc[dn][2 * r], dk_acc[dn][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvrow + dn * 8 + 2 * t) =
          pack_bf16(dv_acc[dn][2 * r], dv_acc[dn][2 * r + 1]);
    }
  }
}

// dQ for 64 query rows of one (batch, head), looping over the key tiles
// they see. Grid: (query tiles, heads, batch), last tiles first.
// Shared memory: the k and v tiles of the loop.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int tk, int heads, Strides qs, Strides ks,
    Strides vs, Strides dos, float scale, MaskArgs m) {
  using Dm = Dims<D>;
  constexpr int kLd = Dm::kLd, kKSteps = Dm::kKSteps, kDTiles = Dm::kDTiles;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + Dm::kTile;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp * 16;

  const bf16* kb = k + b * ks.b + h * ks.h;
  const bf16* vb = v + b * vs.b + h * vs.h;

  // This warp's 16 rows of Q and dO as A fragments, staged through the
  // key buffers before the loop reuses them.
  load_tile<D>(sk, q + b * qs.b + h * qs.h, qs.t, q0, m.tq);
  load_tile<D>(sv, dout + b * dos.b + h * dos.h, dos.t, q0, m.tq);
  __syncthreads();
  uint32_t qf[kKSteps][4], dof[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    load_a<kLd>(qf[kk], sk, wr, kk, g, t);
    load_a<kLd>(dof[kk], sv, wr, kk, g, t);
  }
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wr + g + 8 * r;
    const long long i = ((long long)b * heads + h) * m.tq + qi;
    row_lse[r] = qi < m.tq ? lse[i] : 0.f;
    row_delta[r] = qi < m.tq ? delta[i] : 0.f;
  }

  float dq_acc[kDTiles][4];
#pragma unroll
  for (int dn = 0; dn < kDTiles; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dn][e] = 0.f;

  int kt_begin, kt_end;
  key_tile_range(m, q0, kt_begin, kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tile<D>(sk, kb, ks.t, k0, tk);
    load_tile<D>(sv, vb, vs.t, k0, tk);
    __syncthreads();
    const bool masked = tile_needs_mask(m, q0, k0);

    // dS = P (dO V^T - delta) * scale with P = exp(Q K^T * scale - lse).
    float ds[kKTiles][4];
#pragma unroll
    for (int nt = 0; nt < kKTiles; ++nt) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t b0, b1;
        load_b_nk<kLd>(b0, b1, sk, nt * 8, kk, g, t);
        mma16816(s, qf[kk], b0, b1);
        load_b_nk<kLd>(b0, b1, sv, nt * 8, kk, g, t);
        mma16816(dp, dof[kk], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = __expf(s[e] * scale - row_lse[r]);
        if (masked &&
            !visible(m, q0 + wr + g + 8 * r, k0 + nt * 8 + 2 * t + (e & 1)))
          p = 0.f;
        ds[nt][e] = p * (dp[e] - row_delta[r]) * scale;
      }
    }
    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, ds[2 * kk], ds[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < kDTiles; ++dn) {
        uint32_t b0, b1;
        load_b_kn<kLd>(b0, b1, sk, dn * 8, kk, g, t);
        mma16816(dq_acc[dn], a, b0, b1);
      }
    }
  }

  const long long row = (long long)heads * D;  // dq contiguous
  bf16* dqb = dq + (long long)b * m.tq * row + h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wr + g + 8 * r;
    if (qi >= m.tq) continue;
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      *reinterpret_cast<uint32_t*>(dqb + qi * row + dn * 8 + 2 * t) =
          pack_bf16(dq_acc[dn][2 * r], dq_acc[dn][2 * r + 1]);
    }
  }
}

// Allow `bytes` of dynamic shared memory for `kernel` on the current
// device, once per device (above 48 KB a launch is refused without it).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << (dev & 31);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch, int tq, int tk, int heads, Strides qs,
               Strides ks, Strides vs, float scale, MaskArgs m,
               cudaStream_t stream) {
  static unsigned done = 0;
  constexpr int smem = fwd_smem<D>();
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
      (float*)lse, tk, heads, qs, ks, vs, scale, m);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int batch, int tk, int heads,
                Strides qs, Strides ks, Strides vs, Strides dos,
                float scale, MaskArgs m, cudaStream_t stream) {
  static unsigned done = 0;
  constexpr int smem = dkdv_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tk + kBlockK - 1) / kBlockK, heads, batch);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, tk,
      heads, qs, ks, vs, dos, scale, m);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int batch,
              int tq, int tk, int heads, Strides qs, Strides ks, Strides vs,
              Strides dos, float scale, MaskArgs m, cudaStream_t stream) {
  static unsigned done = 0;
  constexpr int smem = dq_smem<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, tk, heads, qs, ks,
      vs, dos, scale, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Tq, H, D], k/v [B, Tk, H, D] bf16, D 64 or 128, with the given
// element strides (unit stride on the head dim, 16-byte aligned rows);
// o [B, Tq, H, D] bf16 and lse [B, H, Tq] f32, both contiguous.
int dlrover_flash_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int batch, int tq, int tk, int heads,
                      int head_dim, long long q_sb, long long q_st,
                      long long q_sh, long long k_sb, long long k_st,
                      long long k_sh, long long v_sb, long long v_st,
                      long long v_sh, float scale, int causal, int window,
                      int q_offset, int seq_len, void* stream) {
  if (tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  const MaskArgs m{tq, seq_len, q_offset, causal, window};
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh};
  const cudaStream_t s = (cudaStream_t)stream;
  if (head_dim == 64)
    return launch_fwd<64>(q, k, v, o, lse, batch, tq, tk, heads, qs, ks, vs,
                          scale, m, s);
  if (head_dim == 128)
    return launch_fwd<128>(q, k, v, o, lse, batch, tq, tk, heads, qs, ks,
                           vs, scale, m, s);
  return (int)cudaErrorInvalidValue;
}

// dk/dv [B, Tk, H, D] bf16 contiguous; dout strided like q; lse and
// delta [B, H, Tq] f32 contiguous.
int dlrover_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dk, void* dv, int batch,
                           int tq, int tk, int heads, int head_dim,
                           long long q_sb, long long q_st, long long q_sh,
                           long long k_sb, long long k_st, long long k_sh,
                           long long v_sb, long long v_st, long long v_sh,
                           long long do_sb, long long do_st, long long do_sh,
                           float scale, int causal, int window, int q_offset,
                           int seq_len, void* stream) {
  if (tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  const MaskArgs m{tq, seq_len, q_offset, causal, window};
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, dos{do_sb, do_st, do_sh};
  const cudaStream_t s = (cudaStream_t)stream;
  if (head_dim == 64)
    return launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, batch, tk,
                           heads, qs, ks, vs, dos, scale, m, s);
  if (head_dim == 128)
    return launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, batch, tk,
                            heads, qs, ks, vs, dos, scale, m, s);
  return (int)cudaErrorInvalidValue;
}

// dq [B, Tq, H, D] bf16 contiguous.
int dlrover_flash_bwd_dq(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse, const void* delta,
                         void* dq, int batch, int tq, int tk, int heads,
                         int head_dim, long long q_sb, long long q_st,
                         long long q_sh, long long k_sb, long long k_st,
                         long long k_sh, long long v_sb, long long v_st,
                         long long v_sh, long long do_sb, long long do_st,
                         long long do_sh, float scale, int causal, int window,
                         int q_offset, int seq_len, void* stream) {
  if (tq <= 0 || tk <= 0) return (int)cudaErrorInvalidValue;
  const MaskArgs m{tq, seq_len, q_offset, causal, window};
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh},
      vs{v_sb, v_st, v_sh}, dos{do_sb, do_st, do_sh};
  const cudaStream_t s = (cudaStream_t)stream;
  if (head_dim == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, tq, tk, heads,
                         qs, ks, vs, dos, scale, m, s);
  if (head_dim == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, tq, tk,
                          heads, qs, ks, vs, dos, scale, m, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
