// Fused LayerNorm / RMSNorm with an optional residual add, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/layer_norm.py:
//   layer_norm_fwd_kernel  <- _fwd_kernel (via _kernel_fwd_dispatch),
//                             launched by _fwd (pl.pallas_call)
//   layer_norm_bwd_kernel  <- _bwd_kernel, launched by _bwd
//
// What bounds them on this card: bytes. A norm does ~10 operations per
// element and moves 2 bytes per bf16 element each way, far below the
// ~295 operations per byte where the tensor cores would matter. At the
// Llama-2-7B shape (8192 rows x 4096, bf16) the forward moves 134 MB
// (40 us at 3.35 TB/s), the add variant 268 MB (80 us) and the
// backward 201 MB (60 us).
//
// What the design does about it:
// * Forward: one block per row. Each thread holds its share of the row
//   in registers (8 elements per 16-byte bf16 load, NV loads a thread),
//   so the row is read from device memory once; the statistics are two
//   block reductions (warp shuffles, then one shared-memory step) in
//   f32. Compiled variants: rms or layer norm, with or without bias,
//   with or without the residual add. The add variant normalises the
//   f32 sum x + residual and writes that sum, rounded to x's dtype, as
//   `resid` (only there: the plain norm's caller already holds x).
// * Backward: the TPU kernel accumulates dg/db into one shared partial
//   block across a sequential grid. Here blocks run in no order, so each
//   block owns a contiguous range of rows, keeps its dg/db partials for
//   its own columns in registers across those rows, and writes one
//   [n_blocks, E] f32 row of partials; the caller sums the partials
//   outside the kernel, as the JAX wrapper sums its [8, E] partials.
//   No atomics, so results are bitwise repeatable.
// * Ragged row counts need no padded copy: the grid covers exactly the
//   rows there are.
//
// Inputs: x / residual / dout in bf16, contiguous [N, E] with E a
// multiple of 8 up to kMaxWidth (8192: 256 threads x 4 loads x 8); g and
// b f32 [E]; mu and rstd f32 [N]. Blocks have at most 256 threads, so
// even the widest backward variant (~170 registers a thread) fits an
// SM's 65,536 registers.
// Plain C interface (no PyTorch headers), loaded with ctypes. Every
// entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() so the caller sees a refused launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxThreads = 256;
constexpr int kMaxWidth = kMaxThreads * 4 * 8;

// 8 consecutive elements as f32, from or to 16-byte aligned memory.
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

// Sums of a and b over the block. `sm` holds 33 float2; two barriers.
// A later call may start as soon as this one returns: its writes to
// sm[warp] come after every thread has passed the second barrier, and
// its write to sm[32] after its own first barrier, which every thread
// reaches only once it has read sm[32] here.
__device__ __forceinline__ float2 block_sum2(float a, float b, float2* sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) sm[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x + 31) >> 5;
    float2 v = lane < nwarps ? sm[lane] : make_float2(0.f, 0.f);
    v.x = warp_sum(v.x);
    v.y = warp_sum(v.y);
    if (lane == 0) sm[32] = v;
  }
  __syncthreads();
  return sm[32];
}

struct FwdArgs {
  const bf16* x;
  const bf16* res;   // null: no residual add
  const float* g;
  const float* b;    // null: no bias
  bf16* out;
  bf16* resid;       // written on the add path only
  float* mu;
  float* rstd;
  int n, e;
  float eps;
};

// One row per block; thread t holds the 8-element chunks t, t + blockDim,
// ... (NV of them) of its row.
template <int NV, bool RMS, bool BIAS, bool ADD>
__global__ void __launch_bounds__(kMaxThreads)
    layer_norm_fwd_kernel(FwdArgs a) {
  __shared__ float2 red[33];
  const int row = blockIdx.x;
  const int chunks = a.e >> 3;
  const long long base = (long long)row * a.e;
  const bf16* x = a.x + base;
  float v[NV][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      load8(x + c * 8, v[i]);
      if (ADD) {
        float r[8];
        load8(a.res + base + c * 8, r);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[i][k] += r[k];
        store8(a.resid + base + c * 8, v[i]);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) s += RMS ? v[i][k] * v[i][k] : v[i][k];
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) v[i][k] = 0.f;
    }
  }
  const float inv_e = 1.f / (float)a.e;
  float mu = 0.f, var;
  if (RMS) {
    var = block_sum2(s, 0.f, red).x * inv_e;
  } else {
    mu = block_sum2(s, 0.f, red).x * inv_e;
    float s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (threadIdx.x + i * blockDim.x < chunks) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = v[i][k] - mu;
          s2 += d * d;
        }
      }
    }
    var = block_sum2(s2, 0.f, red).x * inv_e;
  }
  const float rstd = rsqrtf(var + a.eps);
  bf16* out = a.out + base;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      float gv[8], o[8];
      load8(a.g + c * 8, gv);
#pragma unroll
      for (int k = 0; k < 8; ++k) o[k] = (v[i][k] - mu) * rstd * gv[k];
      if (BIAS) {
        float bv[8];
        load8(a.b + c * 8, bv);
#pragma unroll
        for (int k = 0; k < 8; ++k) o[k] += bv[k];
      }
      store8(out + c * 8, o);
    }
  }
  if (threadIdx.x == 0) {
    a.mu[row] = mu;
    a.rstd[row] = rstd;
  }
}

struct BwdArgs {
  const bf16* dout;
  const bf16* y;     // the normalised input: x, or resid on the add path
  const float* g;
  const float* mu;
  const float* rstd;
  bf16* dx;
  float* dg_part;    // [gridDim.x, E]
  float* db_part;    // [gridDim.x, E], null without bias
  int n, e, rows_per_block;
};

// Rows [blockIdx.x * rows_per_block, +rows_per_block) of one block;
// thread t owns the same chunks of every row, so its dg/db partials
// stay in registers across the rows.
template <int NV, bool RMS, bool BIAS>
__global__ void __launch_bounds__(kMaxThreads)
    layer_norm_bwd_kernel(BwdArgs a) {
  __shared__ float2 red[33];
  const int chunks = a.e >> 3;
  const int r0 = blockIdx.x * a.rows_per_block;
  const int r1 = min(a.n, r0 + a.rows_per_block);
  const float inv_e = 1.f / (float)a.e;
  float acc_g[NV][8], acc_b[NV][8];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc_g[i][k] = acc_b[i][k] = 0.f;

  for (int row = r0; row < r1; ++row) {
    const long long base = (long long)row * a.e;
    const float mu = a.mu[row], rstd = a.rstd[row];
    float dy[NV][8], xhat[NV][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < chunks) {
        float gv[8];
        load8(a.dout + base + c * 8, dy[i]);
        load8(a.y + base + c * 8, xhat[i]);
        load8(a.g + c * 8, gv);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          xhat[i][k] = (xhat[i][k] - mu) * rstd;
          acc_g[i][k] += dy[i][k] * xhat[i][k];
          if (BIAS) acc_b[i][k] += dy[i][k];
          const float w = dy[i][k] * gv[k];
          s1 += w;
          s2 += w * xhat[i][k];
        }
      }
    }
    const float2 s = block_sum2(s1, s2, red);
    const float c1 = s.x * inv_e, c2 = s.y * inv_e;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < chunks) {
        float gv[8], d[8];
        load8(a.g + c * 8, gv);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float w = dy[i][k] * gv[k];
          d[k] = RMS ? (w - xhat[i][k] * c2) * rstd
                     : (w - c1 - xhat[i][k] * c2) * rstd;
        }
        store8(a.dx + base + c * 8, d);
      }
    }
  }
  const long long pbase = (long long)blockIdx.x * a.e;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < chunks) {
      store8(a.dg_part + pbase + c * 8, acc_g[i]);
      if (BIAS) store8(a.db_part + pbase + c * 8, acc_b[i]);
    }
  }
}

// Threads per block and 8-element loads per thread for a row of e.
inline void row_shape(int e, int& threads, int& nv) {
  const int chunks = e / 8;
  threads = chunks <= 512 ? 128 : kMaxThreads;
  const int per = (chunks + threads - 1) / threads;
  nv = per <= 1 ? 1 : (per <= 2 ? 2 : 4);
}

template <int NV, bool R, bool B, bool A>
void fwd_launch(const FwdArgs& a, int threads, cudaStream_t s) {
  layer_norm_fwd_kernel<NV, R, B, A><<<a.n, threads, 0, s>>>(a);
}

template <int NV, bool R, bool B>
void fwd_add(const FwdArgs& a, int threads, cudaStream_t s) {
  if (a.res) fwd_launch<NV, R, B, true>(a, threads, s);
  else fwd_launch<NV, R, B, false>(a, threads, s);
}

template <int NV, bool R>
void fwd_bias(const FwdArgs& a, int threads, cudaStream_t s) {
  if (a.b) fwd_add<NV, R, true>(a, threads, s);
  else fwd_add<NV, R, false>(a, threads, s);
}

template <int NV>
void fwd_rms(const FwdArgs& a, bool rms, int threads, cudaStream_t s) {
  if (rms) fwd_bias<NV, true>(a, threads, s);
  else fwd_bias<NV, false>(a, threads, s);
}

void fwd_nv(const FwdArgs& a, bool rms, cudaStream_t s) {
  int threads, nv;
  row_shape(a.e, threads, nv);
  if (nv == 1) fwd_rms<1>(a, rms, threads, s);
  else if (nv == 2) fwd_rms<2>(a, rms, threads, s);
  else fwd_rms<4>(a, rms, threads, s);
}

template <int NV, bool R, bool B>
void bwd_launch(const BwdArgs& a, int threads, cudaStream_t s) {
  const int blocks = (a.n + a.rows_per_block - 1) / a.rows_per_block;
  layer_norm_bwd_kernel<NV, R, B><<<blocks, threads, 0, s>>>(a);
}

template <int NV, bool R>
void bwd_bias(const BwdArgs& a, int threads, cudaStream_t s) {
  if (a.db_part) bwd_launch<NV, R, true>(a, threads, s);
  else bwd_launch<NV, R, false>(a, threads, s);
}

template <int NV>
void bwd_rms(const BwdArgs& a, bool rms, int threads, cudaStream_t s) {
  if (rms) bwd_bias<NV, true>(a, threads, s);
  else bwd_bias<NV, false>(a, threads, s);
}

void bwd_nv(const BwdArgs& a, bool rms, cudaStream_t s) {
  int threads, nv;
  row_shape(a.e, threads, nv);
  if (nv == 1) bwd_rms<1>(a, rms, threads, s);
  else if (nv == 2) bwd_rms<2>(a, rms, threads, s);
  else bwd_rms<4>(a, rms, threads, s);
}

inline bool bad_shape(int n, int e) {
  return n <= 0 || e <= 0 || e % 8 != 0 || e > kMaxWidth;
}

}  // namespace

extern "C" {

// x, res [n, e] bf16 (res may be null), g and b [e] f32 (b may be
// null); out [n, e] and resid [n, e] (add path) bf16, mu and rstd [n]
// f32.
int dlrover_layer_norm_fwd(const void* x, const void* res, const void* g,
                           const void* b, void* out, void* resid, void* mu,
                           void* rstd, int n, int e, float eps, int rms,
                           void* stream) {
  if (bad_shape(n, e) || (res && !resid)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{(const bf16*)x, (const bf16*)res, (const float*)g,
                  (const float*)b, (bf16*)out, (bf16*)resid, (float*)mu,
                  (float*)rstd, n, e, eps};
  fwd_nv(a, rms != 0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// dout and y [n, e] bf16, g [e] f32, mu and rstd [n] f32; dx [n, e]
// bf16; dg_part and db_part [ceil(n / rows_per_block), e] f32 (db_part
// null without bias).
int dlrover_layer_norm_bwd(const void* dout, const void* y, const void* g,
                           const void* mu, const void* rstd, void* dx,
                           void* dg_part, void* db_part, int n, int e,
                           int rows_per_block, int rms, void* stream) {
  if (bad_shape(n, e) || rows_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  const BwdArgs a{(const bf16*)dout, (const bf16*)y, (const float*)g,
                  (const float*)mu, (const float*)rstd, (bf16*)dx,
                  (float*)dg_part, (float*)db_part, n, e, rows_per_block};
  bwd_nv(a, rms != 0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
