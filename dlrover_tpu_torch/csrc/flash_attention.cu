// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/flash_attention.py:
//   flash_fwd_kernel       <- _fwd_kernel, launched by _fwd
//                             (pl.pallas_call "flash_attention_fwd")
//   flash_bwd_dkdv_kernel  <- _bwd_kernel, launched by _bwd: dk and dv
//   flash_bwd_dq_kernel    <- _bwd_kernel, launched by _bwd: dq
//
// What bounds them on this card. At the Llama-2-7B training shape
// (batch 2, T 4096, 32 heads, head_dim 128, causal, bf16) the forward
// does ~275 GFLOP on the visible pairs (~0.28 ms at 989 TFLOP/s) and
// moves ~135 MB (~0.04 ms at 3.35 TB/s); the backward does 2.5x the
// operations. At GPT-2's (batch 8, T 1024, 12 heads, head_dim 64) bytes
// and operations bound the forward about equally. So the tensor cores
// bound both kernels, and only wgmma reaches their full rate.
//
// What the design does about it:
// * Every product is a warpgroup wgmma.m64nNk16 (bf16 in, f32
//   accumulate). Operands in shared memory are read through matrix
//   descriptors of the 128-byte swizzled layout that TMA writes: a tile
//   of R rows x head_dim is head_dim / 64 panels of R rows x 128 bytes.
//   A K-major operand (rows = M or N, the head dim contiguous) advances
//   32 bytes a k16 step inside a panel; an MN-major one (rows = the
//   reduction index, the head dim contiguous: V in PV, dO in P^T dO, Q in
//   dS^T Q, K in dS K) is read with the transpose bit, so no transposed
//   copy exists.
// * The second product of each pair takes its A operand from registers:
//   the f32 accumulators of two n8 column blocks, rounded to bf16 as the
//   TPU kernel feeds its MXU, are the A fragment of one k16 step. Scores
//   and dS never touch shared or device memory.
// * Warp specialization: a block is three warpgroups. The first
//   (setmaxnreg down to 24 registers) has one thread that issues TMA
//   loads of the streamed tiles into a ring of stages, each with a
//   "full" and an "empty" mbarrier (in the dk/dv kernel its warp also
//   stores the tiles' lse and delta); the other two (setmaxnreg up to
//   240) each own 64 rows of the block's tile and run the products, so
//   one warpgroup's softmax overlaps the other's wgmma and the loads of
//   the next stages overlap both. ptxas reports the 168 registers a
//   thread has at entry (384 threads, one block an SM).
// * No product is issued under a branch that ptxas cannot prove uniform
//   across the warpgroup (the consumer index is read through a shuffle,
//   the last tile of a pipelined loop is peeled): ptxas then serializes
//   every wgmma. And no __trap() sits in the barrier wait: with one,
//   ptxas held the consumers to the 168 entry registers and spilled.
// * Tiles: the forward and dq blocks own 128 query rows and stream key
//   tiles (128 keys in the forward; 128 at head_dim 64 and 64 at 128 in
//   dq, which holds S, dP and dQ accumulators at once); the dk/dv block
//   owns 128 keys and streams 64-row query tiles with their lse and
//   delta. Inputs are read in the JAX layout [B, T, H, D] through 4-D
//   tensor maps (D, H, T, B) built from the caller's strides, so the
//   q/k/v views of the fused qkv projection need no copy. TMA fills rows
//   past T with zeros; keys at or past seq_len are still masked.
// * The kv loop stops at the causal limit and starts at the sliding
//   window's band, the TPU's dead-block skip (_dispatch_block): causal
//   attention does half the work of full attention. Only tiles that
//   cross the diagonal, the band edge or a ragged edge evaluate the
//   element mask, and the dk/dv kernel's warpgroups skip the query
//   tiles their keys cannot see. Tiles are scheduled longest first.
// * The TPU backward accumulates dq for the whole sequence in one VMEM
//   scratch across an ordered grid. Hopper's blocks run in no order, so
//   the backward is two deterministic kernels: dk/dv (one block per key
//   tile, K and V resident, looping over the query tiles that see it;
//   S^T = K Q^T and dP^T = V dO^T land in the accumulator layout that
//   dV += P^T dO and dK += dS^T Q take as A) and dq (one block per query
//   tile, Q and dO resident, looping over the key tiles it sees). Both
//   recompute P from the forward's lse, so S and dP are computed twice
//   (7 products instead of 5); no atomics, so results are bitwise
//   repeatable. delta = rowsum(dO * O) - g_lse is computed outside.
//
// Plain C interface (no PyTorch headers), loaded with ctypes. Every
// entry point encodes its tensor maps (cuTensorMapEncodeTiled, fetched
// from libcuda through the runtime), launches on the given stream,
// allocates nothing and returns a CUDA error code (cudaGetLastError()
// after the launch) so the caller sees a refused launch.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 384;     // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kPanel = 64;        // head-dim elements in one 128 B row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Tiles, stages and shared memory of each kernel, by head_dim. Every
// tile is a multiple of 1 KB, so each stays aligned to the 1 KB period
// of the 128-byte swizzle.
template <int D>
struct FwdCfg {
  static constexpr int kBQ = 128, kBK = 128;
  static constexpr int kStages = D == 64 ? 5 : 3;
  static constexpr int kQBytes = kBQ * D * 2, kKBytes = kBK * D * 2;
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKBytes + 8 * (1 + 2 * kStages);
};

template <int D>
struct DqCfg {
  static constexpr int kBQ = 128, kBK = D == 64 ? 128 : 64;
  static constexpr int kStages = 3;
  static constexpr int kQBytes = kBQ * D * 2, kKBytes = kBK * D * 2;
  static constexpr int kSmem =
      2 * kQBytes + 2 * kStages * kKBytes + 8 * (1 + 2 * kStages);
};

template <int D>
struct DkdvCfg {
  static constexpr int kBK = 128, kBQ = 64;
  static constexpr int kStages = 3;
  static constexpr int kKBytes = kBK * D * 2, kQBytes = kBQ * D * 2;
  static constexpr int kRowBytes = kBQ * 4;  // lse or delta of a tile
  static constexpr int kSmem = 2 * kKBytes + 2 * kStages * kQBytes +
                               2 * kStages * kRowBytes +
                               8 * (1 + 2 * kStages);
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

// Whether the tile pair of nq query rows at q0 and nk keys at k0 needs
// the element mask: it crosses the diagonal, the band's lower edge, or
// a ragged edge.
__device__ __forceinline__ bool tile_needs_mask(const MaskArgs& m, int q0,
                                                int nq, int k0, int nk) {
  if (q0 + nq > m.tq || k0 + nk > m.seq_len) return true;
  const int qp_first = m.q_offset + q0;
  const int qp_last = qp_first + nq - 1;
  if (m.causal && k0 + nk - 1 > qp_first) return true;
  if (m.window > 0 && k0 < qp_last - m.window + 1) return true;
  return false;
}

// Whether any (query, key) pair of the tile pair is visible.
__device__ __forceinline__ bool tile_live(const MaskArgs& m, int q0, int nq,
                                          int k0, int nk) {
  if (q0 >= m.tq || k0 >= m.seq_len) return false;
  const int qp_first = m.q_offset + q0;
  const int qp_last = m.q_offset + min(q0 + nq, m.tq) - 1;
  if (m.causal && k0 > qp_last) return false;
  if (m.window > 0 && k0 + nk - 1 <= qp_first - m.window) return false;
  return true;
}

// Key tiles [begin, end) of nk keys that nq query rows at q0 can see.
__device__ __forceinline__ void key_tile_range(const MaskArgs& m, int q0,
                                               int nq, int nk, int& begin,
                                               int& end) {
  const int qp_first = m.q_offset + q0;
  const int qp_last = m.q_offset + min(q0 + nq, m.tq) - 1;
  int k_end = m.seq_len;
  if (m.causal) k_end = min(k_end, qp_last + 1);
  int k_begin = 0;
  if (m.window > 0) k_begin = max(0, qp_first - m.window + 1);
  begin = k_begin / nk;
  end = k_end > k_begin ? (k_end + nk - 1) / nk : begin;
}

// Query tiles [begin, end) of nq rows that see a key of the nk keys at k0.
__device__ __forceinline__ void query_tile_range(const MaskArgs& m, int k0,
                                                 int nk, int nq, int& begin,
                                                 int& end) {
  const int k_last = min(k0 + nk, m.seq_len) - 1;
  int q_lo = 0, q_hi = m.tq;
  if (m.causal) q_lo = max(0, k0 - m.q_offset);
  if (m.window > 0) q_hi = min(m.tq, k_last + m.window - m.q_offset);
  begin = q_lo / nq;
  end = q_hi > q_lo ? (q_hi + nq - 1) / nq : begin;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The f32 accumulators of two n8 blocks (columns [0, 8) and [8, 16) of a
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

// ---------------------------------------------------------------------------
// mbarriers, TMA, register reallocation
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Rows [row, row + box rows) of head h, batch b of a [B, T, H, D]
// tensor map into `dst`, head_dim / 64 panels of 128-byte swizzled rows.
template <int D>
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         int rows, int row, int h, int b,
                                         uint64_t* bar) {
  const uint32_t d0 = smem_u32(dst), mb = smem_u32(bar);
  const uint64_t desc = reinterpret_cast<uint64_t>(map);
#pragma unroll
  for (int p = 0; p < D / kPanel; ++p) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
        ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
        ::"r"(d0 + p * rows * 128), "l"(desc), "r"(p * kPanel), "r"(h),
        "r"(row), "r"(b), "r"(mb)
        : "memory");
  }
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barriers in shared memory: initialized by one thread, made visible to
// the TMA unit, then to every thread. A stage is full after
// `full_arrivals` arrivals and its TMA bytes.
__device__ __forceinline__ void init_barriers(uint64_t* bars, int stages,
                                              int full_arrivals = 1) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);  // the resident tiles
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 1 + s, full_arrivals);            // full
      mbar_init(bars + 1 + stages + s, kConsumerWarps);  // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major operand: rows [r0, r0 + 64 or N) of a tile of `rows` rows,
// head-dim columns [16 kk, 16 kk + 16). 8-row groups are 1 KB apart.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0,
                                           int kk) {
  return smem_desc(tile + (kk >> 2) * rows * 128 + r0 * 128 + (kk & 3) * 32,
                   16, 1024);
}

// MN-major operand (transposed B): tile rows [16 kk, 16 kk + 16) are the
// reduction index, all head-dim columns the N index. 64-column panels
// are rows * 128 bytes apart, 8-row groups 1 KB.
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int kk) {
  return smem_desc(tile + kk * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The two consumer warpgroups take turns to issue their products: named
// barrier 1 + c is consumer c's turn, passed to it by the other one.
__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + c) : "memory");
}

__device__ __forceinline__ void turn_pass(int c) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + c) : "memory");
}

// Keeps the compiler from moving accumulator registers across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// m64nNk16, bf16 in, f32 accumulate (N / 2 accumulators a thread).
// ss: A and B K-major from shared memory; rs: A from registers, B
// MN-major from shared memory. `accumulate` 0 overwrites the sum.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float* d, uint64_t a, uint64_t b,
                                            int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// One tile of scores, in place: scaled, masked (rows row0 and row0 + 8,
// keys k0 + the column), folded into the running max and sum of the two
// rows, and exponentiated. alpha gets the factor that rescales what O
// holds so far.
// 2^x on the special-function unit (what __expf uses after scaling by
// log2(e)): exponents are kept in base-2 units, so one FMA forms them.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile of scores, in place: scaled by scale * log2(e), masked (rows
// row0 and row0 + 8, keys k0 + the column), folded into the running max
// (base-2 units) and sum of the two rows, and exponentiated with ex2.
// alpha gets the factor that rescales what O holds so far.
template <int NT>
__device__ __forceinline__ void softmax_tile(float (&sc)[NT][4],
                                             float (&row_m)[2],
                                             float (&row_l)[2],
                                             float (&alpha)[2],
                                             const MaskArgs& m, bool masked,
                                             int row0, int k0, int t,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      float x = sc[nt][e] * scale_log2;
      if (masked && !visible(m, row0 + 8 * r, k0 + nt * 8 + 2 * t + (e & 1)))
        x = -INFINITY;
      sc[nt][e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(row_m[r], quad_max(mx[r]));
    // A row with no visible key so far keeps exp() finite: p = 0.
    m_use[r] = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2(row_m[r] - m_use[r]);
    row_m[r] = m_new;
    row_l[r] *= alpha[r];
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(sc[nt][e] - m_use[e >> 1]);
      sc[nt][e] = p;
      row_l[e >> 1] += p;
    }
}

// O and lse for 128 query rows of one (batch, head). Grid: (query tiles,
// heads, batch); the last (most loaded, under causal) query tiles are
// scheduled first. Shared memory: the Q tile, then a ring of K and V
// tiles. Each consumer warpgroup issues S(i+1) = Q K(i+1)^T together
// with O += P(i) V(i) and runs the softmax of S(i+1) while O's product
// finishes; the two warpgroups take turns to issue (named barriers), so
// one's softmax overlaps the other's products.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     bf16* __restrict__ o, float* __restrict__ lse, int heads,
                     float scale, MaskArgs m) {
  using C = FwdCfg<D>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1k(smem_raw);
  unsigned char* sk = sq + C::kQBytes;
  unsigned char* sv = sk + kS * C::kKBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kS * C::kKBytes);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  int kt_begin, kt_end;
  key_tile_range(m, q0, kBQ, kBK, kt_begin, kt_end);
  const int n_tiles = kt_end - kt_begin;
  init_barriers(bars, kS);

  if (threadIdx.x < 128) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars, C::kQBytes);
      tma_tile<D>(sq, &mq, kBQ, q0, h, b, bars);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kS;
        if (i >= kS) mbar_wait(&empty[s], ((i / kS) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::kKBytes);
        const int k0 = (kt_begin + i) * kBK;
        tma_tile<D>(sk + s * C::kKBytes, &mk, kBK, k0, h, b, &full[s]);
        tma_tile<D>(sv + s * C::kKBytes, &mv, kBK, k0, h, b, &full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // consumer warpgroup 0 or 1, read through a shuffle so the compiler
  // knows it is uniform across each warp
  const int c = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) - 1;
  const int r0 = 64 * c;                 // its rows of the tile
  const int qr = q0 + r0;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qr + warp * 16 + g;  // this thread's rows: row0, +8
  const uint32_t sq_a = smem_u32(sq), sk_a = smem_u32(sk),
                 sv_a = smem_u32(sv);
  const float scale_log2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  // Running max and this thread's share of the running sum of its two
  // rows (summed over the quad at the end).
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};
  float alpha[2];
  float sc[kBK / 8][4];
  uint32_t pa[kBK / 16][4];

  mbar_wait(bars, 0);
  if (n_tiles > 0) {
    if (c == 1) turn_pass(0);  // warpgroup 0 issues first
    mbar_wait(&full[0], 0);
    const int k0 = kt_begin * kBK;
    turn_wait(c);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBK>::ss(&sc[0][0], desc_k(sq_a, kBQ, r0, kk),
                     desc_k(sk_a, kBK, 0, kk), kk);
    wgmma_commit();
    turn_pass(1 - c);
    wgmma_wait<0>();
    fence_regs<kBK / 2>(&sc[0][0]);
    softmax_tile(sc, row_m, row_l, alpha, m,
                 tile_needs_mask(m, qr, 64, k0, kBK), row0, k0, t,
                 scale_log2);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      acc_to_a(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
    for (int i = 0; i + 1 < n_tiles; ++i) {
      const int s = i % kS, s1 = (i + 1) % kS;
      const int k0 = (kt_begin + i + 1) * kBK;
      mbar_wait(&full[s1], ((i + 1) / kS) & 1);
      turn_wait(c);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<kBK>::ss(&sc[0][0], desc_k(sq_a, kBQ, r0, kk),
                       desc_k(sk_a + s1 * C::kKBytes, kBK, 0, kk), kk);
      wgmma_commit();
      // O += P V, with P in bf16 as the TPU kernel feeds the MXU.
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        Wgmma<D>::rs(&acc[0][0], pa[kk],
                     desc_mn(sv_a + s * C::kKBytes, kBK, kk), 1);
      wgmma_commit();
      turn_pass(1 - c);
      wgmma_wait<1>();
      fence_regs<kBK / 2>(&sc[0][0]);
      softmax_tile(sc, row_m, row_l, alpha, m,
                   tile_needs_mask(m, qr, 64, k0, kBK), row0, k0, t,
                   scale_log2);
      wgmma_wait<0>();
      fence_regs<D / 2>(&acc[0][0]);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        acc_to_a(pa[kk], sc[2 * kk], sc[2 * kk + 1]);
    }
    // The last tile: O += P V alone. Warpgroup 1 passes no turn after
    // its last issue, so every pass is waited for.
    const int s = (n_tiles - 1) % kS;
    turn_wait(c);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<D>::rs(&acc[0][0], pa[kk], desc_mn(sv_a + s * C::kKBytes, kBK, kk),
                   1);
    wgmma_commit();
    if (c == 0) turn_pass(1);
    wgmma_wait<0>();
    fence_regs<D / 2>(&acc[0][0]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const long long o_row = (long long)heads * D;  // o is contiguous
  bf16* ob = o + (long long)b * m.tq * o_row + h * D;
  float* lse_bh = lse + ((long long)b * heads + h) * m.tq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(row_l[r]);
    const int qi = row0 + 8 * r;
    if (qi >= m.tq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    bf16* orow = ob + qi * o_row;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * t) =
          pack_bf16(acc[dn][2 * r] * inv, acc[dn][2 * r + 1] * inv);
    }
    if (t == 0)
      lse_bh[qi] = l > 0.f ? row_m[r] * kLn2 + logf(l) : -INFINITY;
  }
}

// dK and dV for 128 keys of one (batch, head), looping over the 64-row
// query tiles that see them. Grid: (key tiles, heads, batch); under
// causal the first key tiles, the most loaded, are scheduled first.
// Shared memory: the resident K and V tiles, then a ring of Q, dO, lse
// and delta tiles. A warpgroup skips the query tiles that none of its
// keys can see; the skip also puts the two warpgroups' products out of
// step, so one's elementwise work overlaps the other's products.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkdv_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int tk, int heads, float scale, MaskArgs m) {
  using C = DkdvCfg<D>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sk = align_1k(smem_raw);
  unsigned char* sv = sk + C::kKBytes;
  unsigned char* sq = sv + C::kKBytes;
  unsigned char* sdo = sq + kS * C::kQBytes;
  float* slse = reinterpret_cast<float*>(sdo + kS * C::kQBytes);
  float* sdelta = slse + kS * kBQ;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sdelta + kS * kBQ);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kS;

  const int k0 = blockIdx.x * kBK;
  const int h = blockIdx.y, b = blockIdx.z;
  int qt_begin, qt_end;
  query_tile_range(m, k0, kBK, kBQ, qt_begin, qt_end);
  const int n_tiles = qt_end - qt_begin;
  // A stage is full when the TMA bytes of Q and dO have landed and each
  // lane of the producer warp has stored its share of lse and delta.
  init_barriers(bars, kS, 1 + 32);

  if (threadIdx.x < 128) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(bars, 2 * C::kKBytes);
        tma_tile<D>(sk, &mk, kBK, k0, h, b, bars);
        tma_tile<D>(sv, &mv, kBK, k0, h, b, bars);
      }
      const long long row_base = ((long long)b * heads + h) * m.tq;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kS;
        if (i >= kS) mbar_wait(&empty[s], ((i / kS) - 1) & 1);
        const int q0 = (qt_begin + i) * kBQ;
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * C::kQBytes);
          tma_tile<D>(sq + s * C::kQBytes, &mq, kBQ, q0, h, b, &full[s]);
          tma_tile<D>(sdo + s * C::kQBytes, &mdo, kBQ, q0, h, b, &full[s]);
        }
        // lse (in base-2 units) and delta: TMA would need the row's bytes
        // to be a multiple of 16, so the warp loads them (rows past Tq
        // read 0).
#pragma unroll
        for (int j = lane; j < kBQ; j += 32) {
          const int qi = q0 + j;
          slse[s * kBQ + j] = qi < m.tq ? lse[row_base + qi] * kLog2e : 0.f;
          sdelta[s * kBQ + j] = qi < m.tq ? delta[row_base + qi] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // consumer warpgroup 0 or 1, read through a shuffle so the compiler
  // knows it is uniform across each warp
  const int c = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) - 1;
  const int r0 = 64 * c;  // this warpgroup's keys
  const int kr = k0 + r0;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = kr + warp * 16 + g;  // this thread's keys: key0, +8
  const uint32_t sk_a = smem_u32(sk), sv_a = smem_u32(sv),
                 sq_a = smem_u32(sq), sdo_a = smem_u32(sdo);
  const float scale_log2 = scale * kLog2e;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dn][e] = dv_acc[dn][e] = 0.f;
  mbar_wait(bars, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kS;
    const int q0 = (qt_begin + i) * kBQ;
    mbar_wait(&full[s], (i / kS) & 1);
    if (!tile_live(m, q0, kBQ, kr, 64)) {
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    const uint32_t qt = sq_a + s * C::kQBytes, dot = sdo_a + s * C::kQBytes;
    const float* lse_s = slse + s * kBQ;
    const float* delta_s = sdelta + s * kBQ;

    // S^T = K Q^T and dP^T = V dO^T: rows are this warpgroup's keys,
    // columns the tile's queries.
    float st[kBQ / 8][4], dpt[kBQ / 8][4];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBQ>::ss(&st[0][0], desc_k(sk_a, kBK, r0, kk),
                     desc_k(qt, kBQ, 0, kk), kk);
      Wgmma<kBQ>::ss(&dpt[0][0], desc_k(sv_a, kBK, r0, kk),
                     desc_k(dot, kBQ, 0, kk), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<kBQ / 2>(&st[0][0]);
    fence_regs<kBQ / 2>(&dpt[0][0]);

    // P^T = exp(S^T * scale - lse)
    const bool masked = tile_needs_mask(m, q0, kBQ, kr, 64);
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        float p = ex2(fmaf(st[nt][e], scale_log2, -lse_s[col]));
        if (masked && !visible(m, q0 + col, key0 + 8 * (e >> 1))) p = 0.f;
        st[nt][e] = p;
      }
    // dV += P^T dO
    uint32_t pa[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      acc_to_a(pa[kk], st[2 * kk], st[2 * kk + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      Wgmma<D>::rs(&dv_acc[0][0], pa[kk], desc_mn(dot, kBQ, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(&dv_acc[0][0]);
    // dS^T = P^T (dP^T - delta) * scale
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * t + (e & 1);
        st[nt][e] = st[nt][e] * (dpt[nt][e] - delta_s[col]) * scale;
      }
    // dK += dS^T Q
    uint32_t da[kBQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      acc_to_a(da[kk], st[2 * kk], st[2 * kk + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      Wgmma<D>::rs(&dk_acc[0][0], da[kk], desc_mn(qt, kBQ, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(&dk_acc[0][0]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const long long row = (long long)heads * D;  // dk, dv contiguous
  const long long base = (long long)b * tk * row + h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key0 + 8 * r;
    if (kj >= tk) continue;
    bf16* dkrow = dk + base + kj * row;
    bf16* dvrow = dv + base + kj * row;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(dkrow + dn * 8 + 2 * t) =
          pack_bf16(dk_acc[dn][2 * r], dk_acc[dn][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dvrow + dn * 8 + 2 * t) =
          pack_bf16(dv_acc[dn][2 * r], dv_acc[dn][2 * r + 1]);
    }
  }
}

// dQ for 128 query rows of one (batch, head), looping over the key tiles
// they see. Grid: (query tiles, heads, batch), last tiles first. Shared
// memory: the resident Q and dO tiles, then a ring of K and V tiles. As
// in the forward, a warpgroup issues S and dP of the next tile with dQ's
// product of this one, and the two warpgroups take turns to issue.
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int heads,
    float scale, MaskArgs m) {
  using C = DqCfg<D>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kS = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1k(smem_raw);
  unsigned char* sdo = sq + C::kQBytes;
  unsigned char* sk = sdo + C::kQBytes;
  unsigned char* sv = sk + kS * C::kKBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sv + kS * C::kKBytes);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + kS;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  int kt_begin, kt_end;
  key_tile_range(m, q0, kBQ, kBK, kt_begin, kt_end);
  const int n_tiles = kt_end - kt_begin;
  init_barriers(bars, kS);

  if (threadIdx.x < 128) {  // producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bars, 2 * C::kQBytes);
      tma_tile<D>(sq, &mq, kBQ, q0, h, b, bars);
      tma_tile<D>(sdo, &mdo, kBQ, q0, h, b, bars);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kS;
        if (i >= kS) mbar_wait(&empty[s], ((i / kS) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * C::kKBytes);
        const int k0 = (kt_begin + i) * kBK;
        tma_tile<D>(sk + s * C::kKBytes, &mk, kBK, k0, h, b, &full[s]);
        tma_tile<D>(sv + s * C::kKBytes, &mv, kBK, k0, h, b, &full[s]);
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  // consumer warpgroup 0 or 1, read through a shuffle so the compiler
  // knows it is uniform across each warp
  const int c = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0) - 1;
  const int r0 = 64 * c;                 // its rows of the tile
  const int qr = q0 + r0;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = qr + warp * 16 + g;  // this thread's rows: row0, +8
  const uint32_t sq_a = smem_u32(sq), sdo_a = smem_u32(sdo),
                 sk_a = smem_u32(sk), sv_a = smem_u32(sv);
  const float scale_log2 = scale * kLog2e;

  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    const long long i = ((long long)b * heads + h) * m.tq + qi;
    row_lse[r] = qi < m.tq ? lse[i] * kLog2e : 0.f;  // base-2 units
    row_delta[r] = qi < m.tq ? delta[i] : 0.f;
  }
  float dq_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[dn][e] = 0.f;
  float sc[kBK / 8][4], dp[kBK / 8][4];
  uint32_t da[kBK / 16][4];

  // S = Q K^T and dP = dO V^T of the key tile in stage s.
  auto issue_s_dp = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      Wgmma<kBK>::ss(&sc[0][0], desc_k(sq_a, kBQ, r0, kk),
                     desc_k(sk_a + s * C::kKBytes, kBK, 0, kk), kk);
      Wgmma<kBK>::ss(&dp[0][0], desc_k(sdo_a, kBQ, r0, kk),
                     desc_k(sv_a + s * C::kKBytes, kBK, 0, kk), kk);
    }
  };
  // dQ += dS K, with dS from da and K from stage s.
  auto issue_dq = [&](int s) {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<D>::rs(&dq_acc[0][0], da[kk],
                   desc_mn(sk_a + s * C::kKBytes, kBK, kk), 1);
  };
  // dS = P (dP - delta) * scale with P = exp(S * scale - lse), in sc.
  auto make_ds = [&](int k0) {
    fence_regs<kBK / 2>(&sc[0][0]);
    fence_regs<kBK / 2>(&dp[0][0]);
    const bool masked = tile_needs_mask(m, qr, 64, k0, kBK);
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = ex2(fmaf(sc[nt][e], scale_log2, -row_lse[r]));
        if (masked && !visible(m, row0 + 8 * r, k0 + nt * 8 + 2 * t + (e & 1)))
          p = 0.f;
        sc[nt][e] = p * (dp[nt][e] - row_delta[r]) * scale;
      }
  };

  mbar_wait(bars, 0);
  if (n_tiles > 0) {
    if (c == 1) turn_pass(0);  // warpgroup 0 issues first
    mbar_wait(&full[0], 0);
    turn_wait(c);
    wgmma_fence();
    issue_s_dp(0);
    wgmma_commit();
    turn_pass(1 - c);
    wgmma_wait<0>();
    make_ds(kt_begin * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      acc_to_a(da[kk], sc[2 * kk], sc[2 * kk + 1]);
    for (int i = 0; i + 1 < n_tiles; ++i) {
      const int s = i % kS, s1 = (i + 1) % kS;
      mbar_wait(&full[s1], ((i + 1) / kS) & 1);
      turn_wait(c);
      wgmma_fence();
      issue_s_dp(s1);
      wgmma_commit();
      issue_dq(s);
      wgmma_commit();
      turn_pass(1 - c);
      wgmma_wait<1>();
      make_ds((kt_begin + i + 1) * kBK);
      wgmma_wait<0>();
      fence_regs<D / 2>(&dq_acc[0][0]);
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        acc_to_a(da[kk], sc[2 * kk], sc[2 * kk + 1]);
    }
    // The last tile: dQ's product alone (warpgroup 1 passes no turn).
    const int s = (n_tiles - 1) % kS;
    turn_wait(c);
    wgmma_fence();
    issue_dq(s);
    wgmma_commit();
    if (c == 0) turn_pass(1);
    wgmma_wait<0>();
    fence_regs<D / 2>(&dq_acc[0][0]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const long long row = (long long)heads * D;  // dq contiguous
  bf16* dqb = dq + (long long)b * m.tq * row + h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= m.tq) continue;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(dqb + qi * row + dn * 8 + 2 * t) =
          pack_bf16(dq_acc[dn][2 * r], dq_acc[dn][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not the runtime; the runtime hands
// out its entry point, so nothing links against libcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, T, H, D] bf16 tensor as a 4-D map (D, H, T, B) read in boxes of
// 64 head-dim elements x `rows` rows of one head, 128-byte swizzled.
// TMA needs a 16-byte aligned base and strides; rows past T read zeros.
bool map_bthd(CUtensorMap* map, const void* ptr, int batch, int t, int heads,
              int d, Strides s, int rows) {
  EncodeTiled encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)t, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s.h * 2, (cuuint64_t)s.t * 2,
                                 (cuuint64_t)s.b * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kPanel, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// Dynamic shared memory of a launch: the layout plus room to align it
// to 1 KB.
constexpr int with_align(int bytes) { return bytes + 1024; }

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch, int tq, int tk, int heads, Strides qs,
               Strides ks, Strides vs, float scale, MaskArgs m,
               cudaStream_t stream) {
  using C = FwdCfg<D>;
  static unsigned done = 0;
  constexpr int smem = with_align(C::kSmem);
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv;
  if (!map_bthd(&mq, q, batch, tq, heads, D, qs, C::kBQ) ||
      !map_bthd(&mk, k, batch, tk, heads, D, ks, C::kBK) ||
      !map_bthd(&mv, v, batch, tk, heads, D, vs, C::kBK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((tq + C::kBQ - 1) / C::kBQ, heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, heads, scale, m);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int batch, int tq, int tk, int heads,
                Strides qs, Strides ks, Strides vs, Strides dos, float scale,
                MaskArgs m, cudaStream_t stream) {
  using C = DkdvCfg<D>;
  static unsigned done = 0;
  constexpr int smem = with_align(C::kSmem);
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv, mdo;
  if (!map_bthd(&mq, q, batch, tq, heads, D, qs, C::kBQ) ||
      !map_bthd(&mk, k, batch, tk, heads, D, ks, C::kBK) ||
      !map_bthd(&mv, v, batch, tk, heads, D, vs, C::kBK) ||
      !map_bthd(&mdo, dout, batch, tq, heads, D, dos, C::kBQ))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((tk + C::kBK - 1) / C::kBK, heads, batch);
  flash_bwd_dkdv_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, tk, heads, scale, m);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int batch,
              int tq, int tk, int heads, Strides qs, Strides ks, Strides vs,
              Strides dos, float scale, MaskArgs m, cudaStream_t stream) {
  using C = DqCfg<D>;
  static unsigned done = 0;
  constexpr int smem = with_align(C::kSmem);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, smem, done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mq, mk, mv, mdo;
  if (!map_bthd(&mq, q, batch, tq, heads, D, qs, C::kBQ) ||
      !map_bthd(&mk, k, batch, tk, heads, D, ks, C::kBK) ||
      !map_bthd(&mv, v, batch, tk, heads, D, vs, C::kBK) ||
      !map_bthd(&mdo, dout, batch, tq, heads, D, dos, C::kBQ))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((tq + C::kBQ - 1) / C::kBQ, heads, batch);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (bf16*)dq,
      heads, scale, m);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Tq, H, D], k/v [B, Tk, H, D] bf16, D 64 or 128, with the given
// element strides (unit stride on the head dim; base and other strides
// 16-byte aligned, as TMA reads them); o [B, Tq, H, D] bf16 and lse
// [B, H, Tq] f32, both contiguous.
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
// delta [B, H, Tq] f32 contiguous, 16-byte aligned.
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
    return launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, batch, tq, tk,
                           heads, qs, ks, vs, dos, scale, m, s);
  if (head_dim == 128)
    return launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, batch, tq,
                            tk, heads, qs, ks, vs, dos, scale, m, s);
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
