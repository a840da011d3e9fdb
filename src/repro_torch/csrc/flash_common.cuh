// Helpers shared by K7 (flash_attention.cu) and K8 (flash_attention_bwd.cu):
// float32 <-> input-dtype conversion and the staging of one 64-row tile of
// a (B, S, heads, D) tensor into shared memory as float32.
//
// A tile row r holds sequence position s0 + r; rows at or past S read as
// zeros, so the ragged tail needs no padding in device memory.  Columns
// run to the true D; rows in shared memory are padded to D + 1 floats so
// that 16 threads reading one column hit 16 banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FLASH_THREADS 256
#define FLASH_ROWS 64  // query and key tile rows
#define FLASH_MAX_D 128
#define FLASH_NC (FLASH_MAX_D / 16)  // accumulator columns per thread
#define FLASH_NEG_INF (-1e30f)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// dst[r * (D + 1) + c] = src[(s0 + r) * row_stride + c] * mul, zero past S.
// ``src`` points at the (batch, head) slice's first element.
template <typename T>
__device__ __forceinline__ void flash_load_tile(float* dst, const T* src,
                                                int s0, int S,
                                                long long row_stride, int D,
                                                float mul) {
  const int DP = D + 1;
  for (int idx = threadIdx.x; idx < FLASH_ROWS * D; idx += FLASH_THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int s = s0 + r;
    dst[r * DP + c] =
        s < S ? to_f32(src[(long long)s * row_stride + c]) * mul : 0.f;
  }
}

// Two tiles at the same positions of two tensors with one stride (k and
// v), in one pass over the index space.
template <typename T>
__device__ __forceinline__ void flash_load_tile_pair(float* dst_a,
                                                     float* dst_b,
                                                     const T* a, const T* b,
                                                     int s0, int S,
                                                     long long row_stride,
                                                     int D) {
  const int DP = D + 1;
  for (int idx = threadIdx.x; idx < FLASH_ROWS * D; idx += FLASH_THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int s = s0 + r;
    const bool in = s < S;
    const long long off = (long long)s * row_stride + c;
    dst_a[r * DP + c] = in ? to_f32(a[off]) : 0.f;
    dst_b[r * DP + c] = in ? to_f32(b[off]) : 0.f;
  }
}
