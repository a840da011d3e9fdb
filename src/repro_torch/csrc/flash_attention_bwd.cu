// K8a / K8b: the backward of causal GQA flash attention (K7).
//
// Replaces the JAX package's kernels/flash_attention_bwd.py::
// flash_dq_pallas (_dq_kernel, K8a) and flash_dkdv_pallas (_dkdv_kernel,
// K8b).  With scale = D**-0.5 (the true D), the saved softmax statistics
// m and linv = 1 / l of K7 and delta = sum_d do * o:
//
//   p_ij  = exp(scale q_i . k_j - m_i) * linv_i   (0 above the diagonal)
//   ds_ij = p_ij * (do_i . v_j - delta_i)
//   K8a:  dq_i = scale * sum_j ds_ij k_j
//   K8b:  dk_j = scale * sum_{g, i} ds_ij q_i,   dv_j = sum_{g, i} p_ij do_i
//
// q, do (B, S, H, D) and k, v (B, S, KVH, D) in float32 or bfloat16 are
// read by stride as they lie (no transpose, no padding of S or D); m,
// linv, delta are (B, H, S) float32; dq comes back as (B, S, H, D) and dk,
// dv as (B, S, KVH, D), in the input dtype, rounded once at the end.  All
// arithmetic is float32; the scores never leave the block.
//
// What bounds them on the H100: operations.  Each allowed query-key pair
// costs 6 D multiply-adds in K8a (q.k, do.v, ds k) and 8 D in K8b (q.k,
// do.v, p do, ds q) against a few bytes per element of q, k, v, do and
// the outputs.  These simple kernels run the products on CUDA cores
// (no tensor cores, TMA or warp specialisation) and read both operands
// of every multiply-add from shared memory, so they run well below the
// float32 peak, like K7.
//
// Design.  The TPU kernels carried their accumulators in scratch across a
// sequential grid axis; Hopper's blocks run in no order, so each block
// owns its output rows and loops itself:
//  * K8a: one block per (batch*head, 64-row query block), looping over
//    the 64-row key blocks up to the diagonal, as K7 does.  It stages the
//    scaled q tile and the do tile once, each k/v tile per key block,
//    forms the 64 x 64 scores and do.v^T together, writes ds over the v
//    tile (its reads are done) and accumulates ds k into registers.
//  * K8b: one block per (batch*kv_head, 64-row key block), holding the k
//    and v tiles and looping over the G query heads of its group and,
//    for each, over the query blocks from the diagonal to S.  The group
//    sum stays in the block's registers: no G x partials in device
//    memory and no atomics.  It forms p^T and ds^T (keys x queries) in
//    shared memory and accumulates p^T do and ds^T (scale q).
// 256 threads as a 16 x 16 grid each own a 4 x 4 patch of a 64 x 64 tile
// (rows ty + 16 i, columns tx + 16 j) and 4 rows x 8 columns (tx + 16 c)
// of each accumulator.  K8b holds four staged tiles, p^T and ds^T (166 KB
// of shared memory at D = 128) and K8a three tiles and ds (132 KB): both
// run one block per SM.  The grid's x axis is the (batch, head) slice so
// that every slice's longest block (K8a: the last query block; K8b: the
// first key block) is dispatched before any shorter one.
#include "flash_common.cuh"

struct K8Dims {
  int S, H, KVH, D, group;
  float scale;
};

// floats of a tile region that holds a D-wide tile or a 64 x 64 one
__host__ __device__ __forceinline__ int k8_tile_floats(int D) {
  const int w = (D + 1) > (FLASH_ROWS + 1) ? (D + 1) : (FLASH_ROWS + 1);
  return FLASH_ROWS * w;
}

template <typename T>
__global__ void __launch_bounds__(FLASH_THREADS, 1)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ m, const float* __restrict__ linv,
                const float* __restrict__ delta, T* __restrict__ dq,
                K8Dims P) {
  extern __shared__ __align__(16) float smem[];
  const int DP = P.D + 1;
  const int PS = FLASH_ROWS + 1;
  float* Qs = smem;                      // 64 x DP, pre-scaled
  float* dOs = Qs + FLASH_ROWS * DP;     // 64 x DP
  float* Ks = dOs + FLASH_ROWS * DP;     // 64 x DP
  float* Vs = Ks + FLASH_ROWS * DP;      // 64 x DP; then ds, 64 x PS
  float* dSs = Vs;

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int b = bh / P.H, h = bh - b * P.H;
  const int kvh = h / P.group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qb * FLASH_ROWS;
  const long long q_stride = (long long)P.H * P.D;
  const long long kv_stride = (long long)P.KVH * P.D;
  const long long q_off = (long long)b * P.S * q_stride + (long long)h * P.D;
  const long long kv_off =
      (long long)b * P.S * kv_stride + (long long)kvh * P.D;

  flash_load_tile(Qs, q + q_off, q0, P.S, q_stride, P.D, P.scale);
  flash_load_tile(dOs, dout + q_off, q0, P.S, q_stride, P.D, 1.f);

  float m_i[4], li_i[4], dl_i[4], acc[4][FLASH_NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    const long long si = (long long)bh * P.S + qp;
    m_i[i] = qp < P.S ? m[si] : 0.f;
    li_i[i] = qp < P.S ? linv[si] : 0.f;
    dl_i[i] = qp < P.S ? delta[si] : 0.f;
#pragma unroll
    for (int c = 0; c < FLASH_NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + FLASH_ROWS, P.S) - 1;
  const int nkb = q_last / FLASH_ROWS + 1;  // key blocks up to the diagonal
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * FLASH_ROWS;
    __syncthreads();  // the previous key block's readers are done
    flash_load_tile_pair(Ks, Vs, k + kv_off, v + kv_off, k0, P.S, kv_stride,
                         P.D);
    __syncthreads();

    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < P.D; ++d) {
      float a[4], o[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * DP + d];
        o[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = Ks[(tx + 16 * j) * DP + d];
        bv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
          dp[i][j] = fmaf(o[i], bv[j], dp[i][j]);
        }
    }
    __syncthreads();  // every read of Vs is done: ds may overwrite it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool allowed = kp <= qp && qp < P.S;
        const float p = allowed ? expf(sc[i][j] - m_i[i]) * li_i[i] : 0.f;
        dSs[(ty + 16 * i) * PS + tx + 16 * j] = p * (dp[i][j] - dl_i[i]);
      }
    }
    __syncthreads();  // the ds tile is complete

    for (int t = 0; t < FLASH_ROWS; ++t) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * PS + t];
#pragma unroll
      for (int c = 0; c < FLASH_NC; ++c) {
        const int col = tx + 16 * c;
        const float kk = col < P.D ? Ks[t * DP + col] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= P.S) continue;
    T* row = dq + q_off + (long long)qp * q_stride;
#pragma unroll
    for (int c = 0; c < FLASH_NC; ++c) {
      const int col = tx + 16 * c;
      if (col < P.D) row[col] = from_f32<T>(acc[i][c] * P.scale);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(FLASH_THREADS, 1)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ m,
                  const float* __restrict__ linv,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, K8Dims P) {
  extern __shared__ __align__(16) float smem[];
  const int DP = P.D + 1;
  const int PS = FLASH_ROWS + 1;
  float* Ks = smem;                      // 64 x DP (keys)
  float* Vs = Ks + FLASH_ROWS * DP;      // 64 x DP
  float* Qs = Vs + FLASH_ROWS * DP;      // 64 x DP (queries), pre-scaled
  float* dOs = Qs + FLASH_ROWS * DP;     // 64 x DP
  float* PT = dOs + FLASH_ROWS * DP;     // 64 x PS: p^T (keys x queries)
  float* dST = PT + FLASH_ROWS * PS;     // 64 x PS: ds^T
  float* ms = dST + FLASH_ROWS * PS;     // 64: the query rows' m
  float* ls = ms + FLASH_ROWS;           // 64: linv
  float* dls = ls + FLASH_ROWS;          // 64: delta

  const int bkv = blockIdx.x;
  const int kb = blockIdx.y;  // key block 0 has the most query blocks
  const int b = bkv / P.KVH, kvh = bkv - b * P.KVH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kb * FLASH_ROWS;
  const long long q_stride = (long long)P.H * P.D;
  const long long kv_stride = (long long)P.KVH * P.D;
  const long long kv_off =
      (long long)b * P.S * kv_stride + (long long)kvh * P.D;

  flash_load_tile_pair(Ks, Vs, k + kv_off, v + kv_off, k0, P.S, kv_stride,
                       P.D);

  float acc_k[4][FLASH_NC], acc_v[4][FLASH_NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < FLASH_NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nqb = (P.S + FLASH_ROWS - 1) / FLASH_ROWS;
  for (int g = 0; g < P.group; ++g) {
    const int h = kvh * P.group + g;
    const long long bh = (long long)b * P.H + h;
    const long long q_off =
        (long long)b * P.S * q_stride + (long long)h * P.D;
    // query blocks from the diagonal on (earlier ones see none of these
    // keys)
    for (int qb = kb; qb < nqb; ++qb) {
      const int q0 = qb * FLASH_ROWS;
      __syncthreads();  // the previous query block's readers are done
      flash_load_tile(Qs, q + q_off, q0, P.S, q_stride, P.D, P.scale);
      flash_load_tile(dOs, dout + q_off, q0, P.S, q_stride, P.D, 1.f);
      for (int r = threadIdx.x; r < FLASH_ROWS; r += FLASH_THREADS) {
        const int qp = q0 + r;
        const long long si = bh * P.S + qp;
        ms[r] = qp < P.S ? m[si] : 0.f;
        ls[r] = qp < P.S ? linv[si] : 0.f;
        dls[r] = qp < P.S ? delta[si] : 0.f;
      }
      __syncthreads();

      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int d = 0; d < P.D; ++d) {
        float a[4], av[4], bq[4], bo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = Ks[(ty + 16 * i) * DP + d];
          av[i] = Vs[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bq[j] = Qs[(tx + 16 * j) * DP + d];
          bo[j] = dOs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(a[i], bq[j], st[i][j]);
            dpt[i][j] = fmaf(av[i], bo[j], dpt[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const int qp = q0 + r;
          const bool allowed = kp <= qp && qp < P.S;
          const float p = allowed ? expf(st[i][j] - ms[r]) * ls[r] : 0.f;
          PT[(ty + 16 * i) * PS + r] = p;
          dST[(ty + 16 * i) * PS + r] = p * (dpt[i][j] - dls[r]);
        }
      }
      __syncthreads();  // p^T and ds^T are complete

      for (int t = 0; t < FLASH_ROWS; ++t) {
        float pt[4], dst[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pt[i] = PT[(ty + 16 * i) * PS + t];
          dst[i] = dST[(ty + 16 * i) * PS + t];
        }
#pragma unroll
        for (int c = 0; c < FLASH_NC; ++c) {
          const int col = tx + 16 * c;
          const float oo = col < P.D ? dOs[t * DP + col] : 0.f;
          const float qq = col < P.D ? Qs[t * DP + col] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(pt[i], oo, acc_v[i][c]);
            acc_k[i][c] = fmaf(dst[i], qq, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= P.S) continue;
    const long long off = kv_off + (long long)kp * kv_stride;
#pragma unroll
    for (int c = 0; c < FLASH_NC; ++c) {
      const int col = tx + 16 * c;
      if (col < P.D) {
        // q was staged pre-scaled, so acc_k already carries the scale
        dk[off + col] = from_f32<T>(acc_k[i][c]);
        dv[off + col] = from_f32<T>(acc_v[i][c]);
      }
    }
  }
}

static bool k8_dims_ok(int B, int S, int H, int KVH, int D) {
  return B >= 1 && S >= 1 && KVH >= 1 && H % KVH == 0 && D >= 1 &&
         D <= FLASH_MAX_D &&
         (S + FLASH_ROWS - 1) / FLASH_ROWS <= 65535;
}

static K8Dims k8_dims(int S, int H, int KVH, int D, double scale) {
  K8Dims P;
  P.S = S;
  P.H = H;
  P.KVH = KVH;
  P.D = D;
  P.group = H / KVH;
  P.scale = (float)scale;
  return P;
}

template <typename T>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* m, const float* linv,
                     const float* delta, void* dq, int B, const K8Dims& P,
                     cudaStream_t st) {
  const size_t smem =
      (size_t)(3 * FLASH_ROWS * (P.D + 1) + k8_tile_floats(P.D)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * P.H),
            (unsigned)((P.S + FLASH_ROWS - 1) / FLASH_ROWS));
  flash_dq_kernel<T><<<grid, FLASH_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, linv, delta,
      (T*)dq, P);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const float* m, const float* linv,
                       const float* delta, void* dk, void* dv, int B,
                       const K8Dims& P, cudaStream_t st) {
  const size_t smem = (size_t)(4 * FLASH_ROWS * (P.D + 1) +
                               2 * FLASH_ROWS * (FLASH_ROWS + 1) +
                               3 * FLASH_ROWS) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * P.KVH),
            (unsigned)((P.S + FLASH_ROWS - 1) / FLASH_ROWS));
  flash_dkdv_kernel<T><<<grid, FLASH_THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, m, linv, delta,
      (T*)dk, (T*)dv, P);
  return (int)cudaGetLastError();
}

extern "C" int repro_k8a_flash_dq(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* m, const float* linv,
                                  const float* delta, void* dq, int B, int S,
                                  int H, int KVH, int D, int is_bf16,
                                  double scale, void* stream) {
  if (!k8_dims_ok(B, S, H, KVH, D)) return (int)cudaErrorInvalidValue;
  const K8Dims P = k8_dims(S, H, KVH, D, scale);
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_dq<__nv_bfloat16>(q, k, v, dout, m, linv, delta,
                                            dq, B, P, st)
                 : launch_dq<float>(q, k, v, dout, m, linv, delta, dq, B, P,
                                    st);
}

extern "C" int repro_k8b_flash_dkdv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* m, const float* linv,
                                    const float* delta, void* dk, void* dv,
                                    int B, int S, int H, int KVH, int D,
                                    int is_bf16, double scale, void* stream) {
  if (!k8_dims_ok(B, S, H, KVH, D)) return (int)cudaErrorInvalidValue;
  const K8Dims P = k8_dims(S, H, KVH, D, scale);
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_dkdv<__nv_bfloat16>(q, k, v, dout, m, linv, delta,
                                              dk, dv, B, P, st)
                 : launch_dkdv<float>(q, k, v, dout, m, linv, delta, dk, dv,
                                      B, P, st);
}
