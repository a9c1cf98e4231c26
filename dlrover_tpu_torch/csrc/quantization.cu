// Blockwise int8 and packed int4 quantization, quantize and dequantize,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels of dlrover_tpu/ops/quantization.py:
//   quantize_kernel                  <- _quantize_kernel    (int8)
//   dequantize_kernel                <- _dequantize_kernel  (int8)
//   quantize_nibble_kernel<signed>   <- _quantize4_kernel   (packed int4)
//   dequantize_nibble_kernel<signed> <- _dequantize4_kernel (packed int4)
// all launched through pl.pallas_call by _quant_call / _dequant_call.
//
// Semantics, exactly as the TPU kernels compute them under jit. Each
// block of kBlock = 1024 consecutive values of the flat input shares
// one f32 scale:
//   scale = absmax * (1 / L)      L = 127 (int8), 7 (signed int4),
//                                 15 (unsigned int4); 1/L is an f32
//                                 constant: XLA rewrites the JAX
//                                 source's absmax / L into this product
//   safe  = max(scale, 1e-30)
//   code  = rint(x / safe)        a true IEEE division (__fdiv_rn), so
//                                 fast-math flags cannot turn it into a
//                                 multiply; rint rounds half to even
//   int8: clip(code, -127, 127); signed int4: clip(code, -7, 7) + 8;
//   unsigned int4: clip(code, 0, 15).
// Packed int4 pairs element i of a block with element i + 512: byte i
// holds element i in its low nibble and element i + 512 in its high
// nibble (not the adjacent-pair layout of other 4-bit libraries).
// Dequantize is code * scale in f32 (8 taken off signed nibbles).
// Values past n read as 0, so a ragged tail needs no padded copy; the
// dequantize kernels write only the n real values.
//
// What bounds them on this card: bytes. A value takes ~8 operations
// and moves 4 bytes of f32 plus 1 (int8) or 0.5 (int4) bytes of code.
// GPT-2's largest leaf, wte (38,633,472 values, 37,728 blocks), moves
// 193 MB to quantize at int8: 57.7 us at 3.35 TB/s.
//
// What the design does about it: one warp per block, no shared memory
// and no __syncthreads. Lane l holds the 32 values k * 128 + 4 l + j
// (k < 8, j < 4), read as eight 16-byte float4 loads that are
// contiguous across the warp; the block's absmax is a __shfl_xor_sync
// max. Codes leave as one 4-byte store a lane per 128 values. The int4
// pairing needs no exchange between lanes: values k * 128 + 4 l + j and
// (k + 4) * 128 + 4 l + j are in the same lane.
//
// Inputs: f32 x, 16-byte aligned; codes int8 [rows, 1024] or uint8
// [rows, 512]; scales f32 [rows]. Plain C interface (no PyTorch
// headers), loaded with ctypes. Every entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError() so the
// caller sees a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 1024;                // values per scale
constexpr int kWarp = 32;
constexpr int kVecs = kBlock / (kWarp * 4);  // float4 loads a lane: 8
constexpr int kStride = kWarp * 4;          // values per warp-wide load
constexpr int kWarpsPerCta = 8;
constexpr float kMinScale = 1e-30f;

// 1/L rounded once to f32, as XLA folds the division by the constant.
template <int L>
struct Recip {
  static constexpr float value = 1.0f / static_cast<float>(L);
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The lane's 32 values: v[k] = x[base + k * 128 + 4 lane + 0..3], 0 at
// and past n.
__device__ __forceinline__ void load_lane(const float* __restrict__ x,
                                          long long base, long long n,
                                          int lane, float4 (&v)[kVecs]) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long i = base + k * kStride + 4 * lane;
    if (i + 3 < n) {
      v[k] = *reinterpret_cast<const float4*>(x + i);
    } else {
      v[k].x = i < n ? x[i] : 0.f;
      v[k].y = i + 1 < n ? x[i + 1] : 0.f;
      v[k].z = i + 2 < n ? x[i + 2] : 0.f;
      v[k].w = 0.f;  // i + 3 >= n
    }
  }
}

// The block's scale from the lane's values (every lane gets it).
template <int L>
__device__ __forceinline__ float block_scale(const float4 (&v)[kVecs]) {
  float m = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v[k].x), fabsf(v[k].y)),
                       fmaxf(fabsf(v[k].z), fabsf(v[k].w))));
  return warp_max(m) * Recip<L>::value;
}

__device__ __forceinline__ int code(float x, float safe, float lo,
                                    float hi) {
  return static_cast<int>(fminf(fmaxf(rintf(__fdiv_rn(x, safe)), lo), hi));
}

// The quantization block (one per warp) of this thread.
__device__ __forceinline__ long long warp_row() {
  return (long long)blockIdx.x * kWarpsPerCta + threadIdx.x / kWarp;
}

// Packed byte of a nibble pair: a low, b high, each offset to 0..15.
template <bool kSigned>
__device__ __forceinline__ uint32_t nibbles(float a, float b, float safe) {
  constexpr float lo = kSigned ? -7.f : 0.f;
  constexpr float hi = kSigned ? 7.f : 15.f;
  constexpr int offset = kSigned ? 8 : 0;
  return (code(a, safe, lo, hi) + offset) |
         ((code(b, safe, lo, hi) + offset) << 4);
}

// Byte j of a little-endian word as a signed int8 code, times scale.
__device__ __forceinline__ float int8_value(uint32_t w, int j, float scale) {
  return (float)(int8_t)((w >> (8 * j)) & 0xff) * scale;
}

// Stores the lane's 4 dequantized values at out[i..i+3], only those
// below n.
__device__ __forceinline__ void store4(float* __restrict__ out, long long i,
                                       long long n, float4 v) {
  if (i + 3 < n) {
    *reinterpret_cast<float4*>(out + i) = v;
  } else {
    if (i < n) out[i] = v.x;
    if (i + 1 < n) out[i + 1] = v.y;
    if (i + 2 < n) out[i + 2] = v.z;
  }
}

__global__ void __launch_bounds__(kWarpsPerCta * kWarp)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scales, long long n, long long rows) {
  const int lane = threadIdx.x % kWarp;
  const long long row = warp_row();
  if (row >= rows) return;  // the whole warp leaves together
  const long long base = row * kBlock;
  float4 v[kVecs];
  load_lane(x, base, n, lane, v);
  const float scale = block_scale<127>(v);
  const float safe = fmaxf(scale, kMinScale);
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const uint32_t b0 = (uint8_t)code(v[k].x, safe, -127.f, 127.f);
    const uint32_t b1 = (uint8_t)code(v[k].y, safe, -127.f, 127.f);
    const uint32_t b2 = (uint8_t)code(v[k].z, safe, -127.f, 127.f);
    const uint32_t b3 = (uint8_t)code(v[k].w, safe, -127.f, 127.f);
    *reinterpret_cast<uint32_t*>(q + base + k * kStride + 4 * lane) =
        b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
  }
  if (lane == 0) scales[row] = scale;
}

__global__ void __launch_bounds__(kWarpsPerCta * kWarp)
dequantize_kernel(const int8_t* __restrict__ q,
                  const float* __restrict__ scales, float* __restrict__ out,
                  long long n, long long rows) {
  const int lane = threadIdx.x % kWarp;
  const long long row = warp_row();
  if (row >= rows) return;
  const long long base = row * kBlock;
  const float scale = scales[row];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const long long i = base + k * kStride + 4 * lane;
    const uint32_t w = *reinterpret_cast<const uint32_t*>(q + i);
    store4(out, i, n,
           make_float4(int8_value(w, 0, scale), int8_value(w, 1, scale),
                       int8_value(w, 2, scale), int8_value(w, 3, scale)));
  }
}

template <bool kSigned>
__global__ void __launch_bounds__(kWarpsPerCta * kWarp)
quantize_nibble_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                       float* __restrict__ scales, long long n,
                       long long rows) {
  const int lane = threadIdx.x % kWarp;
  const long long row = warp_row();
  if (row >= rows) return;
  const long long base = row * kBlock;
  float4 v[kVecs];
  load_lane(x, base, n, lane, v);
  const float scale = block_scale<kSigned ? 7 : 15>(v);
  const float safe = fmaxf(scale, kMinScale);
  // Byte i of the packed row: element i low, element i + 512 high.
#pragma unroll
  for (int k = 0; k < kVecs / 2; ++k) {
    const float4 a = v[k];
    const float4 b = v[k + kVecs / 2];
    *reinterpret_cast<uint32_t*>(q + row * (kBlock / 2) + k * kStride +
                                 4 * lane) =
        nibbles<kSigned>(a.x, b.x, safe) |
        (nibbles<kSigned>(a.y, b.y, safe) << 8) |
        (nibbles<kSigned>(a.z, b.z, safe) << 16) |
        (nibbles<kSigned>(a.w, b.w, safe) << 24);
  }
  if (lane == 0) scales[row] = scale;
}

template <bool kSigned>
__global__ void __launch_bounds__(kWarpsPerCta * kWarp)
dequantize_nibble_kernel(const uint8_t* __restrict__ q,
                         const float* __restrict__ scales,
                         float* __restrict__ out, long long n, long long rows) {
  const int lane = threadIdx.x % kWarp;
  const long long row = warp_row();
  if (row >= rows) return;
  const long long base = row * kBlock;
  const float scale = scales[row];
  constexpr int offset = kSigned ? 8 : 0;
#pragma unroll
  for (int k = 0; k < kVecs / 2; ++k) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(
        q + row * (kBlock / 2) + k * kStride + 4 * lane);
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int byte = (w >> (8 * j)) & 0xff;
      lo[j] = (float)((byte & 15) - offset) * scale;
      hi[j] = (float)(((byte >> 4) & 15) - offset) * scale;
    }
    const long long i = base + k * kStride + 4 * lane;
    store4(out, i, n, make_float4(lo[0], lo[1], lo[2], lo[3]));
    store4(out, i + kBlock / 2, n, make_float4(hi[0], hi[1], hi[2], hi[3]));
  }
}

bool bad_args(long long n, long long rows) {
  return rows < 1 || n < 0 || n > rows * kBlock;
}

unsigned grid(long long rows) {
  return (unsigned)((rows + kWarpsPerCta - 1) / kWarpsPerCta);
}

constexpr unsigned kThreads = kWarpsPerCta * kWarp;

}  // namespace

extern "C" {

// x [n] f32, 16-byte aligned; q [rows, 1024] int8, scales [rows] f32,
// rows >= ceil(n / 1024) and >= 1.
int dlrover_quantize(const void* x, void* q, void* scales, long long n,
                     long long rows, void* stream) {
  if (bad_args(n, rows)) return (int)cudaErrorInvalidValue;
  quantize_kernel<<<grid(rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (int8_t*)q, (float*)scales, n, rows);
  return (int)cudaGetLastError();
}

// q [rows, 1024] int8, scales [rows] f32; out [n] f32, 16-byte aligned.
int dlrover_dequantize(const void* q, const void* scales, void* out,
                       long long n, long long rows, void* stream) {
  if (bad_args(n, rows)) return (int)cudaErrorInvalidValue;
  dequantize_kernel<<<grid(rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scales, (float*)out, n, rows);
  return (int)cudaGetLastError();
}

// x [n] f32, 16-byte aligned; q [rows, 512] uint8, scales [rows] f32.
int dlrover_quantize_nibble(const void* x, void* q, void* scales, long long n,
                            long long rows, int is_signed, void* stream) {
  if (bad_args(n, rows)) return (int)cudaErrorInvalidValue;
  auto kernel = is_signed ? quantize_nibble_kernel<true>
                          : quantize_nibble_kernel<false>;
  kernel<<<grid(rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (uint8_t*)q, (float*)scales, n, rows);
  return (int)cudaGetLastError();
}

// q [rows, 512] uint8, scales [rows] f32; out [n] f32, 16-byte aligned.
int dlrover_dequantize_nibble(const void* q, const void* scales, void* out,
                              long long n, long long rows, int is_signed,
                              void* stream) {
  if (bad_args(n, rows)) return (int)cudaErrorInvalidValue;
  auto kernel = is_signed ? dequantize_nibble_kernel<true>
                          : dequantize_nibble_kernel<false>;
  kernel<<<grid(rows), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)q, (const float*)scales, (float*)out, n, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
