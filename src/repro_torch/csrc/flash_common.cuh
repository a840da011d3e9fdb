// Helpers shared by K7 (flash_attention.cu) and K8 (flash_attention_bwd.cu).
//
// Two families of kernels use them:
//  * the CUDA-core kernels (K7, K8a and K8b in float32) stage tiles into
//    shared memory as float32 (flash_load_tile*): a tile row r holds
//    sequence position s0 + r, rows at or past S read as zeros, columns
//    run to the true D, and rows are padded to D + 1 floats so that 16
//    threads reading one column hit 16 banks;
//  * the tensor-core kernels (K7, K8a and K8b in bfloat16) stage bf16 tiles
//    with cp.async (flash_stage_bf16) and multiply them with mma.sync
//    m16n8k16 (bf16 in, float32 accumulate), reading operand fragments
//    with ldmatrix.  Their rows are DP + 8 bf16 wide, DP the head dim
//    rounded up to 32, 64, 128 or 256: a row stride of an odd number of
//    16-byte chunks, so the 8 rows of one ldmatrix hit 8 distinct bank
//    groups.  Columns past D and rows past S are zero-filled.
#pragma once

#include <cuda_bf16.h>

#include "tc_common.cuh"

#define FLASH_THREADS 256
#define FLASH_MAX_D 256
#define FLASH_NEG_INF (-1e30f)
#define FLASH_LOG2E 1.4426950408889634f

// CUDA-core kernels: accumulator columns a thread owns (tx + 16 c), for
// D <= 128 and for D <= 256
#define FLASH_NC_SMALL 8
#define FLASH_NC_LARGE 16

// dst[r * (D + 1) + c] = src[(s0 + r) * row_stride + c] * mul, zero past S.
// ``src`` points at the (batch, head) slice's first element.
template <int ROWS>
__device__ __forceinline__ void flash_load_tile(float* dst, const float* src,
                                                int s0, int S,
                                                long long row_stride, int D,
                                                float mul) {
  const int DP = D + 1;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += FLASH_THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int s = s0 + r;
    dst[r * DP + c] =
        s < S ? src[(long long)s * row_stride + c] * mul : 0.f;
  }
}

// Two tiles at the same positions of two tensors with one stride (k and
// v), in one pass over the index space.
template <int ROWS>
__device__ __forceinline__ void flash_load_tile_pair(float* dst_a,
                                                     float* dst_b,
                                                     const float* a,
                                                     const float* b,
                                                     int s0, int S,
                                                     long long row_stride,
                                                     int D) {
  const int DP = D + 1;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += FLASH_THREADS) {
    const int r = idx / D, c = idx - r * D;
    const int s = s0 + r;
    const bool in = s < S;
    const long long off = (long long)s * row_stride + c;
    dst_a[r * DP + c] = in ? a[off] : 0.f;
    dst_b[r * DP + c] = in ? b[off] : 0.f;
  }
}

// ---------------------------------------------------------------------
// bf16 tensor-core building blocks (sm_80+ PTX, run on sm_90a)

typedef __nv_bfloat16 bf16;

// the head dim the tensor-core kernels are instantiated for
__host__ __device__ __forceinline__ int flash_dp(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// what rounding x to bf16 left over, itself rounded to bf16
__device__ __forceinline__ uint32_t pack_bf16_rest(float lo, float hi) {
  const float rlo = lo - __bfloat162float(__float2bfloat16_rn(lo));
  const float rhi = hi - __bfloat162float(__float2bfloat16_rn(hi));
  return pack_bf16(rlo, rhi);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// dst[r * LD + c] = src[(s0 + r) * row_stride + c] for r < ROWS, c < DP;
// zero where s0 + r >= S or c >= D.  With ``vec`` (D % 8 == 0, so every
// row starts on 16 bytes) as cp.async 16-byte chunks that land when the
// caller waits on its group; otherwise as plain element loads.
template <int ROWS, int DP, int LD, int NT>
__device__ __forceinline__ void flash_stage_bf16(bf16* dst, const bf16* src,
                                                 int s0, int S,
                                                 long long row_stride, int D,
                                                 bool vec) {
  if (vec) {
    constexpr int CH = DP / 8;
    for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
      const int r = idx / CH, c = (idx - r * CH) * 8;
      const int s = s0 + r;
      const bool in = s < S && c < D;
      const bf16* g = in ? src + (long long)s * row_stride + c : src;
      cp_async16(smem_u32(dst + r * LD + c), g, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
      const int r = idx / DP, c = idx - r * DP;
      const int s = s0 + r;
      dst[r * LD + c] = (s < S && c < D)
                            ? src[(long long)s * row_stride + c]
                            : __float2bfloat16_rn(0.f);
    }
  }
}

// o[c], o[c + 1] of one output row (columns past D dropped); a pair
// store when D is even (every row then starts on 4 bytes)
__device__ __forceinline__ void flash_store_pair(bf16* row, int c, int D,
                                                 float x0, float x1) {
  if (c >= D) return;
  if ((D & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x0,
                                                                        x1);
  } else {
    row[c] = __float2bfloat16_rn(x0);
    if (c + 1 < D) row[c + 1] = __float2bfloat16_rn(x1);
  }
}
