// Fused LayerNorm / RMSNorm with an optional residual add, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/layer_norm.py:
//   layer_norm_fwd_kernel   <- _fwd_kernel (via _kernel_fwd_dispatch),
//                              launched by _fwd (pl.pallas_call)
//   layer_norm_bwd_kernel   <- _bwd_kernel, launched by _bwd, whose
//   layer_norm_dgdb_kernel     partial dg/db sum (outside the TPU kernel
//                              there) this second kernel takes over
//
// What bounds them on this card: bytes. A norm does ~10 operations per
// element and moves 2 bytes per bf16 element each way, far below the
// ~295 operations per byte where the tensor cores would matter. At the
// Llama-2-7B shape (8192 rows x 4096, bf16) the forward moves 134 MB
// (40 us at 3.35 TB/s), the add variant 268 MB (80 us) and the
// backward 201 MB (60 us); at GPT-2's (8192 x 768) 13-38 MB, 4-11 us,
// where a launch's fixed costs weigh as much as the bytes.
//
// What the design does about it:
// * A row is reduced by a group of threads: one warp (E <= 1024, so at
//   GPT-2's 768 every lane holds 3 chunks of 8 and no lane idles) or one
//   block (E > 1024). A warp reduces with shuffles alone; a block with
//   one barrier per sum (warp shuffles, then every thread adds the
//   warps' partials from shared memory in the same order).
// * The grid is persistent: two blocks per SM (three for the forward of
//   a block a row; one where a thread holds four chunks, whose registers
//   two blocks would not have), each group
//   owning a contiguous range of rows. g and b are loaded into
//   registers once per group, not once per row.
// * The rows come through a ring of 1-8 stages in shared memory. One
//   thread of the group (lane 0, or thread 0 of the block) fills it with
//   1-D bulk copies (cp.async.bulk ... mbarrier::complete_tx::bytes:
//   rows are contiguous, so no tensor map is needed), each stage with
//   its own mbarrier, so the next rows' bytes are in flight while the
//   group reduces and stores the current one. x and the residual (or
//   dout and y) of a row share a stage. A warp stores its outputs from
//   registers with 16-byte stores; a block's forward stages its rows of
//   out (and resid) in shared memory and thread 0 writes each with a
//   bulk copy a row later (measured a few percent faster at E 4096
//   than 16-byte stores); the backward stores dx from registers.
// * Statistics are f32 and two passes over the row held on chip (mean,
//   then the centred variance, as the TPU kernel computes them). The add
//   variant normalises the f32 sum x + residual and writes that sum,
//   rounded to x's dtype, as `resid`.
// * Backward: each thread keeps dg/db partials for its own columns in
//   registers across its group's rows; a block adds its warps' partials
//   in a fixed order and writes one [E] row of partials, and
//   layer_norm_dgdb_kernel, launched from the same entry point, sums the
//   blocks' rows in a fixed order. No atomics, so results are bitwise
//   repeatable.
// * Ragged row counts need no padded copy: the groups cover exactly the
//   rows there are.
//
// The launch shape (path, chunks a thread, threads, blocks, rows a
// group, ring stages, shared memory) is computed by the Python wrapper
// (ops/layer_norm.py:launch_shape, where the CPU tests check it) and
// handed over as a NormShape; the entry points check it before use.
//
// Inputs: x / residual / dout / y in bf16, contiguous [N, E] with E a
// multiple of 8 up to kMaxWidth, 16-byte aligned; g and b f32 [E];
// stats f32 [2, N] (mu, then rstd). Plain C interface (no PyTorch
// headers), loaded with ctypes. Every entry point launches on the given
// stream on the given device (switching to it and back only when it is
// not current), allocates nothing and returns cudaGetLastError() so the
// caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// A launch of the kernels; mirrors ops/layer_norm.py:_Shape. At global
// scope, as the C entry points take it.
struct NormShape {
  int n, e;
  int warp;     // 1: a warp reduces a row; 0: a block does
  int nv;       // 8-element chunks a thread
  int threads;  // a block
  int blocks;
  int rows;     // rows a group (warp or block)
  int stages;   // ring depth
  int smem;     // dynamic shared memory a block, bytes
  int device;
  int rms;
  float eps;
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxWidth = 8192;
constexpr int kWarpMaxWidth = 1024;  // the widest row a warp reduces
constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 8;
// mbarriers at the start of dynamic shared memory: a stage's barrier for
// each of up to 8 groups (warps) of a block
constexpr int kBarBytes = (kMaxThreads / 32) * kMaxStages * 8;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxDevices = 64;
// Blocks an SM of the forward with a block a row (so at most 85
// registers a thread): on the card 3 ran a few percent faster than 2 at
// E 4096 (tools/norm_ab.py).
constexpr int kFwdBlocksPerSM = 3;

// ---------------------------------------------------------------------------
// loads, stores, reductions
// ---------------------------------------------------------------------------

// 8 consecutive elements as f32, from 16-byte aligned global or shared
// memory.
__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)): a thread keeps one
// partial sum per element of its chunks, so its sums are chains of NV
// adds, not 8 NV.
__device__ __forceinline__ float sum8(const float* p) {
  return ((p[0] + p[1]) + (p[2] + p[3])) + ((p[4] + p[5]) + (p[6] + p[7]));
}

// Sums of v.x and v.y over the group, the same value in every thread.
// A warp: butterfly shuffles, which leave every lane the same bits (each
// step adds the same two values in either order). A block: one barrier;
// every thread adds the warps' partials in warp order. Calls alternate
// between the two halves of `red`: the next call writes the other half,
// and the one after it writes this half only after its own barrier,
// which every thread reaches after reading this half.
template <bool WARP>
__device__ __forceinline__ float2 group_sum(float2 v, float2 (*red)[32],
                                            int& half) {
  v.x = warp_sum(v.x);
  v.y = warp_sum(v.y);
  if (WARP) return v;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[half][warp] = v;
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) {
    s.x += red[half][w].x;
    s.y += red[half][w].y;
  }
  half ^= 1;
  return s;
}

// ---------------------------------------------------------------------------
// mbarriers and 1-D bulk copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(1)
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

// Row `row` of each of the `streams` inputs into one ring stage: the
// barrier expects their bytes, and completes when the copies land.
template <int STREAMS>
__device__ __forceinline__ void fill_stage(bf16* dst, const bf16* src0,
                                           const bf16* src1, long long row,
                                           int e, uint64_t* bar) {
  const int bytes = e * 2;
  const uint32_t mb = smem_u32(bar);
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mb),
      "r"(STREAMS * bytes)
      : "memory");
  const bf16* srcs[2] = {src0, src1};
#pragma unroll
  for (int k = 0; k < STREAMS; ++k) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst + k * e)),
        "l"(srcs[k] + row * e), "r"(bytes), "r"(mb)
        : "memory");
  }
}

// Bulk copies out of shared memory: issue, commit, and wait until the
// committed copies have read their source (READ) or landed.
__device__ __forceinline__ void bulk_store(bf16* dst, const bf16* src,
                                           int bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_u32(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <bool READ>
__device__ __forceinline__ void bulk_wait_all() {
  if (READ) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// A group's place in the launch: its rank in the group, its size, its
// rows [r0, r0 + count), its ring (stages x streams rows of e) and its
// barriers. Barriers are initialized here and made visible to the bulk
// copy unit and to the group.
template <bool WARP, int STREAMS>
struct Group {
  int t, size, r0, count;
  bf16* ring;
  uint64_t* bars;

  __device__ __forceinline__ Group(const NormShape& s, unsigned char* smem) {
    const int warp = threadIdx.x >> 5;
    const int gib = WARP ? warp : 0;  // group in block
    const int gpb = WARP ? (int)(blockDim.x >> 5) : 1;
    t = WARP ? (threadIdx.x & 31) : threadIdx.x;
    size = WARP ? 32 : blockDim.x;
    r0 = (blockIdx.x * gpb + gib) * s.rows;
    count = max(0, min(s.n - r0, s.rows));
    bars = reinterpret_cast<uint64_t*>(smem) + gib * kMaxStages;
    ring = reinterpret_cast<bf16*>(smem + kBarBytes) +
           (size_t)gib * s.stages * STREAMS * s.e;
    if (t == 0) {
      for (int st = 0; st < s.stages; ++st) mbar_init(bars + st);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (WARP) __syncwarp();
    else __syncthreads();
  }
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const bf16* x;
  const bf16* res;   // null: no residual add
  const float* g;
  const float* b;    // null: no bias
  bf16* out;
  bf16* resid;       // written on the add path only
  float* stats;      // [2, n]: mu, rstd
};

// Thread t of a group holds the 8-element chunks t, t + size, ... (NV of
// them) of the group's current row.
template <bool WARP, int NV, bool RMS, bool BIAS, bool ADD>
__global__ void __launch_bounds__(kMaxThreads,
                                  NV == 4 ? 1 : (WARP ? 2 : kFwdBlocksPerSM))
    layer_norm_fwd_kernel(FwdArgs a, NormShape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float2 red[2][32];
  constexpr int STREAMS = ADD ? 2 : 1;
  // A block stages its rows of out (and resid) in two buffers after its
  // ring; thread 0 writes row j - 1 with bulk copies once every thread
  // has passed row j's first barrier.
  constexpr bool BULK = !WARP;
  constexpr int OUTS = ADD ? 2 : 1;
  const Group<WARP, STREAMS> grp(s, smem);
  const int e = s.e, chunks = e >> 3;
  bf16* obuf = grp.ring + (size_t)s.stages * STREAMS * e;
  const float inv_e = 1.f / (float)e;
  float gv[NV][8], bv[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = grp.t + i * grp.size;
    if (c < chunks) {
      load8(a.g + c * 8, gv[i]);
      if (BIAS) load8(a.b + c * 8, bv[i]);
    }
  }
  if (grp.t == 0) {
    for (int j = 0; j < min(grp.count, s.stages); ++j)
      fill_stage<STREAMS>(grp.ring + j * STREAMS * e, a.x, a.res,
                          grp.r0 + j, e, grp.bars + j);
  }
  int half = 0;
  for (int j = 0; j < grp.count; ++j) {
    const int st = j % s.stages;
    const long long row = grp.r0 + j;
    const bf16* xs = grp.ring + st * STREAMS * e;
    bf16* ob = obuf + (j & 1) * OUTS * e;
    // row j - 2's copies, out of this buffer, have read it
    if (BULK && grp.t == 0) bulk_wait_all<true>();
    mbar_wait(grp.bars + st, (j / s.stages) & 1);
    float v[NV][8];
    float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = grp.t + i * grp.size;
      if (c < chunks) {
        load8(xs + c * 8, v[i]);
        if (ADD) {
          float r[8];
          load8(xs + e + c * 8, r);
#pragma unroll
          for (int k = 0; k < 8; ++k) v[i][k] += r[k];
          if (!BULK) store8(a.resid + row * e + c * 8, v[i]);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) part[k] += RMS ? v[i][k] * v[i][k] : v[i][k];
      }
    }
    float mu = 0.f, var;
    if (RMS) {
      var = group_sum<WARP>(make_float2(sum8(part), 0.f), red, half).x * inv_e;
    } else {
      mu = group_sum<WARP>(make_float2(sum8(part), 0.f), red, half).x * inv_e;
#pragma unroll
      for (int k = 0; k < 8; ++k) part[k] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (grp.t + i * grp.size < chunks) {
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float d = v[i][k] - mu;
            part[k] += d * d;
          }
        }
      }
      var = group_sum<WARP>(make_float2(sum8(part), 0.f), red, half).x * inv_e;
    }
    // Every thread of the group has read the stage into registers: a
    // block's threads have passed a barrier since, a warp's lanes meet
    // here. Refill it with the row `stages` ahead.
    if (WARP) __syncwarp();
    if (grp.t == 0 && j + s.stages < grp.count)
      fill_stage<STREAMS>(grp.ring + st * STREAMS * e, a.x, a.res,
                          row + s.stages, e, grp.bars + st);
    if (BULK && grp.t == 0 && j > 0) {
      const bf16* prev = obuf + ((j - 1) & 1) * OUTS * e;
      bulk_store(a.out + (row - 1) * e, prev, e * 2);
      if (ADD) bulk_store(a.resid + (row - 1) * e, prev + e, e * 2);
      bulk_commit();
    }
    const float rstd = rsqrtf(var + s.eps);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = grp.t + i * grp.size;
      if (c < chunks) {
        float o[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          o[k] = (v[i][k] - mu) * rstd * gv[i][k];
          if (BIAS) o[k] += bv[i][k];
        }
        store8(BULK ? ob + c * 8 : a.out + row * e + c * 8, o);
        // `ob` may be written only past the barrier thread 0 reaches
        // after row j - 2's copies have read it
        if (BULK && ADD) store8(ob + e + c * 8, v[i]);
      }
    }
    // this thread's rows in `ob` visible to the bulk copies
    if (BULK) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (grp.t == 0) {
      a.stats[row] = mu;
      a.stats[s.n + row] = rstd;
    }
  }
  if (BULK) {
    __syncthreads();
    if (grp.t == 0) {
      if (grp.count > 0) {
        const long long last = grp.r0 + grp.count - 1;
        const bf16* prev = obuf + ((grp.count - 1) & 1) * OUTS * e;
        bulk_store(a.out + last * e, prev, e * 2);
        if (ADD) bulk_store(a.resid + last * e, prev + e, e * 2);
        bulk_commit();
      }
      bulk_wait_all<false>();
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const bf16* dout;
  const bf16* y;      // the normalised input: x, or resid on the add path
  const float* g;
  const float* stats; // [2, n]: mu, rstd
  bf16* dx;
  float* part;        // [1 or 2, blocks, e]: dg partials, then db
};

// dxhat-side sums of one row: s1 = sum(dy g), s2 = sum(dy g xhat).
// A block holds dy and xhat of its chunks in registers (HOLD) and
// refills the stage right after its sum; a warp, short of registers at
// E 768-1024, reads them again from the stage and refills after dx.
template <bool WARP, int NV, bool RMS, bool BIAS>
__global__ void __launch_bounds__(kMaxThreads, NV == 4 ? 1 : 2)
    layer_norm_bwd_kernel(BwdArgs a, NormShape s) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float2 red[2][32];
  constexpr bool HOLD = !WARP;
  const Group<WARP, 2> grp(s, smem);
  const int e = s.e, chunks = e >> 3;
  const float inv_e = 1.f / (float)e;
  const float* mus = a.stats;
  const float* rstds = a.stats + s.n;
  float gv[NV][8], acc_g[NV][8], acc_b[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = grp.t + i * grp.size;
    if (c < chunks) load8(a.g + c * 8, gv[i]);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc_g[i][k] = acc_b[i][k] = 0.f;
  }
  if (grp.t == 0) {
    for (int j = 0; j < min(grp.count, s.stages); ++j)
      fill_stage<2>(grp.ring + j * 2 * e, a.dout, a.y, grp.r0 + j, e,
                    grp.bars + j);
  }
  // the row's statistics, read one row ahead
  float mu = 0.f, rstd = 0.f;
  if (grp.count > 0) {
    mu = mus[grp.r0];
    rstd = rstds[grp.r0];
  }
  int half = 0;
  for (int j = 0; j < grp.count; ++j) {
    const int st = j % s.stages;
    const long long row = grp.r0 + j;
    float mu_next = 0.f, rstd_next = 0.f;
    if (j + 1 < grp.count) {
      mu_next = mus[row + 1];
      rstd_next = rstds[row + 1];
    }
    const bf16* dys = grp.ring + st * 2 * e;
    const bf16* ys = dys + e;
    mbar_wait(grp.bars + st, (j / s.stages) & 1);
    float dy[HOLD ? NV : 1][8], xh[HOLD ? NV : 1][8];
    float s1[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float s2[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = grp.t + i * grp.size;
      if (c < chunks) {
        float* d = dy[HOLD ? i : 0];
        float* xhat = xh[HOLD ? i : 0];
        load8(dys + c * 8, d);
        load8(ys + c * 8, xhat);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          xhat[k] = (xhat[k] - mu) * rstd;
          acc_g[i][k] += d[k] * xhat[k];
          if (BIAS) acc_b[i][k] += d[k];
          const float w = d[k] * gv[i][k];
          s1[k] += w;
          s2[k] += w * xhat[k];
        }
      }
    }
    const float2 sums =
        group_sum<WARP>(make_float2(sum8(s1), sum8(s2)), red, half);
    const float c1 = sums.x * inv_e, c2 = sums.y * inv_e;
    if (HOLD && grp.t == 0 && j + s.stages < grp.count)
      fill_stage<2>(grp.ring + st * 2 * e, a.dout, a.y, row + s.stages, e,
                    grp.bars + st);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = grp.t + i * grp.size;
      if (c < chunks) {
        float* d = dy[HOLD ? i : 0];
        float* xhat = xh[HOLD ? i : 0];
        if (!HOLD) {
          load8(dys + c * 8, d);
          load8(ys + c * 8, xhat);
#pragma unroll
          for (int k = 0; k < 8; ++k) xhat[k] = (xhat[k] - mu) * rstd;
        }
        float dx[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float w = d[k] * gv[i][k];
          dx[k] = RMS ? (w - xhat[k] * c2) * rstd
                      : (w - c1 - xhat[k] * c2) * rstd;
        }
        store8(a.dx + row * e + c * 8, dx);
      }
    }
    if (!HOLD) {
      __syncwarp();
      if (grp.t == 0 && j + s.stages < grp.count)
        fill_stage<2>(grp.ring + st * 2 * e, a.dout, a.y, row + s.stages, e,
                      grp.bars + st);
    }
    mu = mu_next;
    rstd = rstd_next;
  }

  // One row of partials a block: a block's threads own its columns; a
  // block of warps adds the warps' partials in warp order through shared
  // memory (the ring is idle: every copy into it has landed).
  float* dg_part = a.part + (size_t)blockIdx.x * e;
  float* db_part = a.part + ((size_t)s.blocks + blockIdx.x) * e;
  if (!WARP) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = grp.t + i * grp.size;
      if (c < chunks) {
        store8(dg_part + c * 8, acc_g[i]);
        if (BIAS) store8(db_part + c * 8, acc_b[i]);
      }
    }
    return;
  }
  float* buf = reinterpret_cast<float*>(smem + kBarBytes);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
#pragma unroll
  for (int which = 0; which < (BIAS ? 2 : 1); ++which) {
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = grp.t + i * 32;
      if (c < chunks) store8(buf + warp * e + c * 8, which ? acc_b[i] : acc_g[i]);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int w = 0; w < warps; ++w) {
        float p[8];
        load8(buf + w * e + c * 8, p);
#pragma unroll
        for (int k = 0; k < 8; ++k) sum[k] += p[k];
      }
      store8((which ? db_part : dg_part) + c * 8, sum);
    }
  }
}

// dg (blockIdx.y 0) or db (1) [e] = the sum of `parts` partial rows,
// added in a fixed order: a lane owns 4 columns (one 16-byte load a
// row), a block's 32 warps take every 32nd row, then warp 0 adds the
// warps' sums in warp order.
__global__ void __launch_bounds__(1024)
    layer_norm_dgdb_kernel(const float* part, float* dg, float* db,
                           int parts, int e) {
  __shared__ float4 red[32][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = (blockIdx.x * 32 + lane) * 4;
  const float* src = part + (size_t)blockIdx.y * parts * e;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (col < e) {
#pragma unroll 8
    for (int p = warp; p < parts; p += 32) {
      const float4 v = *reinterpret_cast<const float4*>(src + (size_t)p * e + col);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp == 0 && col < e) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < 32; ++w) {
      sum.x += red[w][lane].x; sum.y += red[w][lane].y;
      sum.z += red[w][lane].z; sum.w += red[w][lane].w;
    }
    *reinterpret_cast<float4*>((blockIdx.y ? db : dg) + col) = sum;
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Shared memory above 48 KB needs the kernel's attribute raised, once
// per kernel and device.
template <typename K>
cudaError_t allow_smem(K kernel, int smem, int device, int* allowed) {
  if (smem <= 48 * 1024 || allowed[device] >= smem) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed[device] = smem;
  return err;
}

template <bool W, int NV, bool R, bool B, bool A>
cudaError_t fwd_launch(const FwdArgs& a, const NormShape& s, cudaStream_t st) {
  static int allowed[kMaxDevices];
  const auto kernel = layer_norm_fwd_kernel<W, NV, R, B, A>;
  const cudaError_t err = allow_smem(kernel, s.smem, s.device, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<s.blocks, s.threads, s.smem, st>>>(a, s);
  return cudaGetLastError();
}

template <bool W, int NV>
cudaError_t fwd_variant(const FwdArgs& a, const NormShape& s,
                        cudaStream_t st) {
  const bool r = s.rms != 0, b = a.b != nullptr, add = a.res != nullptr;
  if (r) {
    if (b) return add ? fwd_launch<W, NV, true, true, true>(a, s, st)
                      : fwd_launch<W, NV, true, true, false>(a, s, st);
    return add ? fwd_launch<W, NV, true, false, true>(a, s, st)
               : fwd_launch<W, NV, true, false, false>(a, s, st);
  }
  if (b) return add ? fwd_launch<W, NV, false, true, true>(a, s, st)
                    : fwd_launch<W, NV, false, true, false>(a, s, st);
  return add ? fwd_launch<W, NV, false, false, true>(a, s, st)
             : fwd_launch<W, NV, false, false, false>(a, s, st);
}

template <bool W, int NV, bool R, bool B>
cudaError_t bwd_launch(const BwdArgs& a, const NormShape& s, cudaStream_t st) {
  static int allowed[kMaxDevices];
  const auto kernel = layer_norm_bwd_kernel<W, NV, R, B>;
  const cudaError_t err = allow_smem(kernel, s.smem, s.device, allowed);
  if (err != cudaSuccess) return err;
  kernel<<<s.blocks, s.threads, s.smem, st>>>(a, s);
  return cudaGetLastError();
}

template <bool W, int NV>
cudaError_t bwd_variant(const BwdArgs& a, bool bias, const NormShape& s,
                        cudaStream_t st) {
  if (s.rms) return bias ? bwd_launch<W, NV, true, true>(a, s, st)
                         : bwd_launch<W, NV, true, false>(a, s, st);
  return bias ? bwd_launch<W, NV, false, true>(a, s, st)
              : bwd_launch<W, NV, false, false>(a, s, st);
}

// The kernel instance for the shape's path and chunks a thread: a warp
// takes 1-4 chunks (E up to 1024), a block 1, 2 or 4.
template <typename F>
cudaError_t by_nv(const NormShape& s, const F& f) {
  if (s.warp) {
    switch (s.nv) {
      case 1: return f.template run<true, 1>();
      case 2: return f.template run<true, 2>();
      case 3: return f.template run<true, 3>();
      case 4: return f.template run<true, 4>();
    }
  } else {
    switch (s.nv) {
      case 1: return f.template run<false, 1>();
      case 2: return f.template run<false, 2>();
      case 4: return f.template run<false, 4>();
    }
  }
  return cudaErrorInvalidValue;
}

// Whether the shape is one the kernels can run: every row in a group,
// every chunk in a thread, the ring in the block's shared memory.
bool bad_shape(const NormShape& s, int streams, int outs) {
  if (s.n <= 0 || s.e <= 0 || s.e % 8 || s.e > kMaxWidth) return true;
  if (s.threads <= 0 || s.threads > kMaxThreads || s.threads % 32) return true;
  if (s.blocks <= 0 || s.rows <= 0 || s.stages < 1 || s.stages > kMaxStages)
    return true;
  if (s.device < 0 || s.device >= kMaxDevices) return true;
  if (s.warp && s.e > kWarpMaxWidth) return true;
  const int gpb = s.warp ? s.threads / 32 : 1;
  const int lanes = s.warp ? 32 : s.threads;
  if ((long long)s.nv * lanes * 8 < s.e) return true;
  if ((long long)s.blocks * gpb * s.rows < s.n) return true;
  const long long ring = (long long)gpb * s.stages * streams * s.e * 2;
  const long long obuf = s.warp ? 0 : 2LL * outs * s.e * 2;
  return s.smem < kBarBytes + ring + obuf || s.smem > kMaxSmem;
}

// Makes `device` current for the scope when it is not.
struct DeviceScope {
  int prev = -1;
  explicit DeviceScope(int device) {
    int cur = 0;
    cudaGetDevice(&cur);
    if (cur != device && cudaSetDevice(device) == cudaSuccess) prev = cur;
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// The variant of a call, by the template arguments that by_nv picks.
struct FwdLaunch {
  const FwdArgs& a;
  const NormShape& s;
  cudaStream_t st;
  template <bool W, int NV>
  cudaError_t run() const { return fwd_variant<W, NV>(a, s, st); }
};

struct BwdLaunch {
  const BwdArgs& a;
  bool bias;
  const NormShape& s;
  cudaStream_t st;
  template <bool W, int NV>
  cudaError_t run() const { return bwd_variant<W, NV>(a, bias, s, st); }
};

}  // namespace

extern "C" {

// x, res [n, e] bf16 (res may be null), g and b [e] f32 (b may be
// null); out [n, e] and resid [n, e] (add path) bf16, stats [2, n] f32.
int dlrover_norm_fwd(const void* x, const void* res, const void* g,
                     const void* b, void* out, void* resid, void* stats,
                     const NormShape* shape, void* stream) {
  const NormShape& s = *shape;
  if (bad_shape(s, res ? 2 : 1, res ? 2 : 1) || (res && !resid))
    return (int)cudaErrorInvalidValue;
  const FwdArgs a{(const bf16*)x, (const bf16*)res, (const float*)g,
                  (const float*)b, (bf16*)out, (bf16*)resid, (float*)stats};
  const DeviceScope scope(s.device);
  return (int)by_nv(s, FwdLaunch{a, s, (cudaStream_t)stream});
}

// dout and y [n, e] bf16, g [e] f32, stats [2, n] f32; dx [n, e] bf16,
// dg and db [e] f32 (db null without bias); part [1 or 2, blocks, e]
// f32 scratch for the blocks' partial sums.
int dlrover_norm_bwd(const void* dout, const void* y, const void* g,
                     const void* stats, void* dx, void* dg, void* db,
                     void* part, const NormShape* shape, void* stream) {
  const NormShape& s = *shape;
  if (bad_shape(s, 2, 0)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{(const bf16*)dout, (const bf16*)y, (const float*)g,
                  (const float*)stats, (bf16*)dx, (float*)part};
  const bool bias = db != nullptr;
  const DeviceScope scope(s.device);
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = by_nv(s, BwdLaunch{a, bias, s, st});
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.e / 4 + 31) / 32, bias ? 2 : 1);
  layer_norm_dgdb_kernel<<<grid, 1024, 0, st>>>(
      (const float*)part, (float*)dg, (float*)db, s.blocks, s.e);
  return (int)cudaGetLastError();
}

}  // extern "C"
