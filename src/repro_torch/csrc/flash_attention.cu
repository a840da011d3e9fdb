// K7: causal GQA flash-attention forward with the online softmax.
//
// Replaces the JAX package's kernels/flash_attention.py::
// flash_attention_pallas (_kernel).  q (B, S, H, D), k/v (B, S, KVH, D) in
// float32 or bfloat16, read by stride as they lie (no transpose, no
// padding of S or D); o (B, S, H, D) in the input dtype; m, l (B, H, S)
// float32: the running max of the scaled scores and the softmax
// denominator each query row ended with.  Query head h reads KV head
// h / group.  Scores, the online-softmax state and the accumulator are
// float32 and never leave the block.
//
// What bounds it on the H100: operations.  The causal half needs about
// 4 B H S^2 D / 2 float32 operations (Q K^T and P V) against 2 (q + o) +
// 2 (k + v) tensors of bytes; at the serving shape (B 4, S 2048, H 40,
// D 128) the operations take ~40x longer than the bytes on the CUDA
// cores.  This simple kernel uses CUDA cores only (no tensor cores, TMA
// or warp specialisation) and reads its operands from shared memory for
// every multiply-add, so it runs well below the float32 peak.
//
// Design.  The TPU kernel carried (m, l, acc) in scratch across a
// sequential grid axis over key blocks; Hopper's blocks run in no order,
// so here one block owns one (batch*head, 64-row query block) and loops
// over the 64-row key blocks itself, up to the causal diagonal (fully
// future key blocks are never visited).  It stages the scaled Q tile and
// each K/V tile in shared memory as float32 (rows padded by one float so
// a column read by 16 threads hits 16 banks), 256 threads as a 16 x 16
// grid each own a 4 x 4 patch of the scores (rows ty + 16 i, keys tx +
// 16 j) and the same 4 query rows of the output accumulator (columns
// tx + 16 c).  Row max and row sum reduce over the 16 lanes of a half
// warp with shuffles; P goes through shared memory (over the K tile,
// whose scores are done) to feed P V.  Query blocks launch longest-first
// so the last wave holds the short ones.
#include "flash_common.cuh"

#define K7_THREADS FLASH_THREADS
#define K7_BQ FLASH_ROWS
#define K7_BK FLASH_ROWS
#define K7_MAX_D FLASH_MAX_D
#define K7_NC FLASH_NC
#define K7_NEG_INF FLASH_NEG_INF

struct K7Dims {
  int S, H, KVH, D, group;
  float scale;
};

// floats of the region that holds the K tile, then the P tile over it
__host__ __device__ __forceinline__ int k7_kp_floats(int D) {
  const int k_tile = K7_BK * (D + 1), p_tile = K7_BQ * (K7_BK + 1);
  return k_tile > p_tile ? k_tile : p_tile;
}

template <typename T>
__global__ void __launch_bounds__(K7_THREADS, 2)
flash_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out, K7Dims P) {
  extern __shared__ __align__(16) float smem[];
  const int DP = P.D + 1;  // padded row stride
  const int PS = K7_BK + 1;
  float* Qs = smem;             // K7_BQ x DP, pre-scaled
  float* Ks = Qs + K7_BQ * DP;  // K7_BK x DP; then P, K7_BQ x PS
  float* Vs = Ks + k7_kp_floats(P.D);  // K7_BK x DP
  float* Ps = Ks;

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / P.H, h = bh - b * P.H;
  const int kvh = h / P.group;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qb * K7_BQ;
  const long long q_stride = (long long)P.H * P.D;
  const long long kv_stride = (long long)P.KVH * P.D;
  const T* qg = q + (long long)b * P.S * q_stride + (long long)h * P.D;
  const T* kg = k + (long long)b * P.S * kv_stride + (long long)kvh * P.D;
  const T* vg = v + (long long)b * P.S * kv_stride + (long long)kvh * P.D;

  flash_load_tile(Qs, qg, q0, P.S, q_stride, P.D, P.scale);

  float m_i[4], l_i[4], acc[4][K7_NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = K7_NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < K7_NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + K7_BQ, P.S) - 1;
  const int nkb = q_last / K7_BK + 1;  // key blocks up to the diagonal
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * K7_BK;
    __syncthreads();  // the previous tile's readers are done
    flash_load_tile_pair(Ks, Vs, kg, vg, k0, P.S, kv_stride, P.D);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < P.D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
    __syncthreads();  // every score read of Ks is done: P may overwrite it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = K7_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (!(kp <= qp && kp < P.S)) sc[i][j] = K7_NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      // the 16 lanes of a half warp share ty: reduce over them
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < K7_NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // the P tile is complete

    for (int t = 0; t < K7_BK; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PS + t];
#pragma unroll
      for (int c = 0; c < K7_NC; ++c) {
        const int col = tx + 16 * c;
        const float vv = col < P.D ? Vs[t * DP + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= P.S) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
    T* orow = o + ((long long)b * P.S + qp) * q_stride + (long long)h * P.D;
#pragma unroll
    for (int c = 0; c < K7_NC; ++c) {
      const int col = tx + 16 * c;
      if (col < P.D) orow[col] = from_f32<T>(acc[i][c] / denom);
    }
    if (tx == 0) {
      m_out[(long long)bh * P.S + qp] = m_i[i];
      l_out[(long long)bh * P.S + qp] = l_i[i];
    }
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o,
                  float* m, float* l, int B, const K7Dims& P,
                  cudaStream_t st) {
  const size_t smem =
      (size_t)((K7_BQ + K7_BK) * (P.D + 1) + k7_kp_floats(P.D)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((P.S + K7_BQ - 1) / K7_BQ), (unsigned)(B * P.H));
  flash_attention_fwd_kernel<T><<<grid, K7_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, m, l, P);
  return (int)cudaGetLastError();
}

extern "C" int repro_k7_flash_attention(const void* q, const void* k,
                                        const void* v, void* o, float* m,
                                        float* l, int B, int S, int H,
                                        int KVH, int D, int is_bf16,
                                        double scale, void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || H % KVH != 0 || D < 1 || D > K7_MAX_D ||
      (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  K7Dims P;
  P.S = S;
  P.H = H;
  P.KVH = KVH;
  P.D = D;
  P.group = H / KVH;
  P.scale = (float)scale;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch<__nv_bfloat16>(q, k, v, o, m, l, B, P, st)
                 : launch<float>(q, k, v, o, m, l, B, P, st);
}
