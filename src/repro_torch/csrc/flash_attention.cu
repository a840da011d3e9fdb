// K7: causal GQA flash-attention forward with the online softmax.
//
// Replaces the JAX package's kernels/flash_attention.py::
// flash_attention_pallas (_kernel).  q (B, S, H, D), k/v (B, S, KVH, D) in
// float32 or bfloat16, D <= 256, read by stride as they lie (no
// transpose, no padding of S or D in device memory); o (B, S, H, D) in the
// input dtype; m, l (B, H, S) float32: the running max of the scaled
// scores (natural-log units) and the softmax denominator each query row
// ended with.  Query head h reads KV head h / group.  Scores, the
// online-softmax state and the accumulator are float32 and never leave
// the block.
//
// What bounds it on the H100: operations.  The causal half needs about
// 4 B H S^2 D / 2 operations (Q K^T and P V) against 2 (q + o) + 2 (k + v)
// tensors of bytes; at the serving shape (B 4, S 2048, H 40, D 128, bf16)
// the operations take ~8x longer than the bytes even at the bf16
// tensor-core peak.
//
// Two instantiations:
//  * bfloat16, on the tensor cores (flash_fwd_bf16_kernel).  FA2's
//    structure on mma.sync m16n8k16 (bf16 in, float32 accumulate): one
//    block of 4 warps per (batch*head, 64-row query block), each warp
//    owning 16 query rows.  Q is copied once with cp.async into shared
//    memory as bf16 and kept as A fragments in registers (D <= 128) or
//    re-read with ldmatrix (D 256).  K and V tiles (64 keys; 32 at D 256)
//    sit in a two-stage ring: the cp.async loads of tile j + 1 are issued
//    before tile j is computed.  S = Q K^T accumulates in float32 and is
//    scaled in float32 (Q is not pre-scaled in bf16); the online softmax
//    runs on the C fragments (row max and sum across the 4-thread quad,
//    exp2 with the log2(e) factor folded into the scale, m kept as the raw
//    max and written as raw * scale); P is packed to bf16 A fragments in
//    registers and O += P V reads V with ldmatrix.trans.  Key tiles below
//    the diagonal run unmasked, tiles above it are never visited.  Shared
//    memory: 87,040 B at D 128 (two blocks an SM), 101,376 B at D 256.
//  * float32, on the CUDA cores (flash_attention_fwd_kernel): tensor cores
//    would compute it in TF32, which breaks the float32 tolerance.  One
//    block of 256 threads per (batch*head, 64-row query block) stages the
//    scaled Q tile and each K/V tile as float32 (rows padded by one
//    float), a 16 x 16 thread grid each owns a 4 x 4 patch of the scores
//    and 4 query rows of the accumulator (columns tx + 16 c, NC of them);
//    P goes through shared memory (over the K tile) to feed P V.
// Query blocks launch longest-first in both, so the last wave holds the
// short ones.
#include "flash_common.cuh"
#include "kernel_attributes.cuh"

#define K7_THREADS FLASH_THREADS
#define K7_BQ 64
#define K7_BK 64
#define K7_NEG_INF FLASH_NEG_INF
#define K7_TC_THREADS 128  // 4 warps x 16 query rows

struct K7Dims {
  int S, H, KVH, D, group;
  float scale;
};

// ------------------------------------------------ bfloat16, tensor cores

// key rows per tile of the tensor-core kernel
template <int DP>
struct K7Tile {
  static constexpr int BK = DP > 128 ? 32 : 64;
  static constexpr int LD = DP + 8;  // bf16 per shared-memory row
  static constexpr int smem_bytes = (K7_BQ + 4 * BK) * LD * 2;
};

template <int DP>
__global__ void __launch_bounds__(K7_TC_THREADS, 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ m_out, float* __restrict__ l_out,
                      K7Dims P) {
  constexpr int BQ = K7_BQ, BK = K7Tile<DP>::BK, LD = K7Tile<DP>::LD;
  constexpr int NT = K7_TC_THREADS;
  constexpr int NKT = BK / 8;   // key n-tiles of a score row block
  constexpr int NDT = DP / 8;   // head-dim n-tiles of the accumulator
  constexpr int KD = DP / 16;   // k-steps over the head dim
  constexpr bool Q_IN_REGS = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* Ks = Qs + BQ * LD;                       // 2 stages of BK x LD
  bf16* Vs = Ks + 2 * BK * LD;                   // 2 stages of BK x LD

  const int qb = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int bh = blockIdx.y;
  const int b = bh / P.H, h = bh - b * P.H;
  const int kvh = h / P.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = qb * BQ;
  const int row0 = warp * 16;  // the warp's first row in the tile
  const long long q_stride = (long long)P.H * P.D;
  const long long kv_stride = (long long)P.KVH * P.D;
  const bf16* qg = q + (long long)b * P.S * q_stride + (long long)h * P.D;
  const bf16* kg = k + (long long)b * P.S * kv_stride + (long long)kvh * P.D;
  const bf16* vg = v + (long long)b * P.S * kv_stride + (long long)kvh * P.D;
  const bool vec = (P.D & 7) == 0;

  flash_stage_bf16<BQ, DP, LD, NT>(Qs, qg, q0, P.S, q_stride, P.D, vec);
  flash_stage_bf16<BK, DP, LD, NT>(Ks, kg, 0, P.S, kv_stride, P.D, vec);
  flash_stage_bf16<BK, DP, LD, NT>(Vs, vg, 0, P.S, kv_stride, P.D, vec);
  cp_async_commit();

  // ldmatrix lane offsets: A (16 x 16 row-major), B from an n x k
  // row-major tile (non-trans), B from a k x n row-major tile (trans)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3),
            b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3),
            t_col = (lane >> 4) * 8;

  float acc[NDT][4];
#pragma unroll
  for (int n = 0; n < NDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // raw (unscaled) row maxima
  float l_r[2] = {0.f, 0.f};              // this thread's partial sums
  uint32_t qf[Q_IN_REGS ? KD : 1][4];
  const float sl2 = P.scale * FLASH_LOG2E;

  const int q_last = min(q0 + BQ, P.S) - 1;
  const int nkb = q_last / BK + 1;  // key tiles up to the diagonal
  for (int kb = 0; kb < nkb; ++kb) {
    const int st = kb & 1;
    if (kb + 1 < nkb) {
      const int nst = st ^ 1;
      flash_stage_bf16<BK, DP, LD, NT>(Ks + nst * BK * LD, kg, (kb + 1) * BK,
                                       P.S, kv_stride, P.D, vec);
      flash_stage_bf16<BK, DP, LD, NT>(Vs + nst * BK * LD, vg, (kb + 1) * BK,
                                       P.S, kv_stride, P.D, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kb (and Q) have landed
    __syncthreads();
    const bf16* Kt = Ks + st * BK * LD;
    const bf16* Vt = Vs + st * BK * LD;
    if constexpr (Q_IN_REGS) {
      if (kb == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd)
          ldsm_x4(qf[kd],
                  smem_u32(Qs + (row0 + a_row) * LD + kd * 16 + a_col));
      }
    }

    // S = Q K^T (raw dot products) for the warp's 16 rows x BK keys
    float s[NKT][4];
#pragma unroll
    for (int n = 0; n < NKT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kd][e];
      } else {
        ldsm_x4(a, smem_u32(Qs + (row0 + a_row) * LD + kd * 16 + a_col));
      }
#pragma unroll
      for (int np = 0; np < NKT / 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, smem_u32(Kt + (np * 16 + b_row) * LD + kd * 16 + b_col));
        mma_bf16(s[2 * np], a, bfr[0], bfr[1]);
        mma_bf16(s[2 * np + 1], a, bfr[2], bfr[3]);
      }
    }

    // causal mask, only where a key can pass one of the warp's rows
    const int k0 = kb * BK;
    if (k0 + BK - 1 > q0 + row0) {
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + n * 8 + 2 * tig + (e & 1);
          const int qp = q0 + row0 + gid + 8 * (e >> 1);
          if (kp > qp) s[n][e] = -INFINITY;
        }
    }

    // online softmax on the C fragments: rows gid (e 0, 1), gid + 8 (2, 3)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = m_r[hr];
#pragma unroll
      for (int n = 0; n < NKT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * hr], s[n][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every row sees key 0 in tile 0, so mx is finite from then on
      const float corr = fast_exp2((m_r[hr] - mx) * sl2);
      m_r[hr] = mx;
      const float mb = mx * sl2;
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < NKT; ++n)
#pragma unroll
        for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
          const float p = fast_exp2(fmaf(s[n][e], sl2, -mb));
          s[n][e] = p;
          rs += p;
        }
      l_r[hr] = l_r[hr] * corr + rs;
#pragma unroll
      for (int n = 0; n < NDT; ++n) {
        acc[n][2 * hr] *= corr;
        acc[n][2 * hr + 1] *= corr;
      }
    }

    // O += P V: P from the C fragments as bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t bfr[4];
        ldsm_x4_t(bfr,
                  smem_u32(Vt + (kk * 16 + t_row) * LD + dp * 16 + t_col));
        mma_bf16(acc[2 * dp], a, bfr[0], bfr[1]);
        mma_bf16(acc[2 * dp + 1], a, bfr[2], bfr[3]);
      }
    }
    __syncthreads();  // stage st is read: the next prefetch may refill it
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_r[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qp = q0 + row0 + gid + 8 * hr;
    if (qp >= P.S) continue;
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = o + ((long long)b * P.S + qp) * q_stride + (long long)h * P.D;
#pragma unroll
    for (int n = 0; n < NDT; ++n)
      flash_store_pair(orow, n * 8 + 2 * tig, P.D, acc[n][2 * hr] * inv,
                       acc[n][2 * hr + 1] * inv);
    if (tig == 0) {
      m_out[(long long)bh * P.S + qp] = m_r[hr] * P.scale;
      l_out[(long long)bh * P.S + qp] = l;
    }
  }
}

template <int DP>
static int launch_bf16(const void* q, const void* k, const void* v, void* o,
                       float* m, float* l, int B, const K7Dims& P,
                       cudaStream_t st) {
  constexpr int smem = K7Tile<DP>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((P.S + K7_BQ - 1) / K7_BQ), (unsigned)(B * P.H));
  flash_fwd_bf16_kernel<DP><<<grid, K7_TC_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, m, l, P);
  return (int)cudaGetLastError();
}

// ------------------------------------------------- float32, CUDA cores

// floats of the region that holds the K tile, then the P tile over it
__host__ __device__ __forceinline__ int k7_kp_floats(int D) {
  const int k_tile = K7_BK * (D + 1), p_tile = K7_BQ * (K7_BK + 1);
  return k_tile > p_tile ? k_tile : p_tile;
}

template <int NC>
__global__ void __launch_bounds__(K7_THREADS, NC > FLASH_NC_SMALL ? 1 : 2)
flash_attention_fwd_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, float* __restrict__ m_out,
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
  const long long q_off = (long long)b * P.S * q_stride + (long long)h * P.D;
  const long long kv_off =
      (long long)b * P.S * kv_stride + (long long)kvh * P.D;
  const float *qg = q + q_off, *kg = k + kv_off, *vg = v + kv_off;

  flash_load_tile<K7_BQ>(Qs, qg, q0, P.S, q_stride, P.D, P.scale);

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = K7_NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + K7_BQ, P.S) - 1;
  const int nkb = q_last / K7_BK + 1;  // key blocks up to the diagonal
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * K7_BK;
    __syncthreads();  // the previous tile's readers are done
    flash_load_tile_pair<K7_BK>(Ks, Vs, kg, vg, k0, P.S, kv_stride, P.D);
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
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // the P tile is complete

    for (int t = 0; t < K7_BK; ++t) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PS + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
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
    float* orow = o + q_off + (long long)qp * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < P.D) orow[col] = acc[i][c] / denom;
    }
    if (tx == 0) {
      m_out[(long long)bh * P.S + qp] = m_i[i];
      l_out[(long long)bh * P.S + qp] = l_i[i];
    }
  }
}

static int k7_f32_smem(int D) {
  return ((K7_BQ + K7_BK) * (D + 1) + k7_kp_floats(D)) * (int)sizeof(float);
}

template <int NC>
static int launch_f32(const void* q, const void* k, const void* v, void* o,
                      float* m, float* l, int B, const K7Dims& P,
                      cudaStream_t st) {
  const int smem = k7_f32_smem(P.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((P.S + K7_BQ - 1) / K7_BQ), (unsigned)(B * P.H));
  flash_attention_fwd_kernel<NC><<<grid, K7_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, m, l, P);
  return (int)cudaGetLastError();
}

extern "C" int repro_k7_flash_attention(const void* q, const void* k,
                                        const void* v, void* o, float* m,
                                        float* l, int B, int S, int H,
                                        int KVH, int D, int is_bf16,
                                        double scale, void* stream) {
  if (B < 1 || S < 1 || KVH < 1 || H % KVH != 0 || D < 1 ||
      D > FLASH_MAX_D || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  K7Dims P;
  P.S = S;
  P.H = H;
  P.KVH = KVH;
  P.D = D;
  P.group = H / KVH;
  P.scale = (float)scale;
  cudaStream_t st = (cudaStream_t)stream;
  if (!is_bf16)
    return D > 16 * FLASH_NC_SMALL
               ? launch_f32<FLASH_NC_LARGE>(q, k, v, o, m, l, B, P, st)
               : launch_f32<FLASH_NC_SMALL>(q, k, v, o, m, l, B, P, st);
  switch (flash_dp(D)) {
    case 32:
      return launch_bf16<32>(q, k, v, o, m, l, B, P, st);
    case 64:
      return launch_bf16<64>(q, k, v, o, m, l, B, P, st);
    case 128:
      return launch_bf16<128>(q, k, v, o, m, l, B, P, st);
    default:
      return launch_bf16<256>(q, k, v, o, m, l, B, P, st);
  }
}

// the dynamic shared memory a K7 launch at head dim D asks for (-1 if D
// is out of range)
extern "C" int repro_k7_smem_bytes(int D, int is_bf16) {
  if (D < 1 || D > FLASH_MAX_D) return -1;
  if (!is_bf16) return k7_f32_smem(D);
  switch (flash_dp(D)) {
    case 32:
      return K7Tile<32>::smem_bytes;
    case 64:
      return K7Tile<64>::smem_bytes;
    case 128:
      return K7Tile<128>::smem_bytes;
    default:
      return K7Tile<256>::smem_bytes;
  }
}

// K7's instantiations, each at the largest head dim it takes
// (kernel_attributes.cuh)
int repro_flash_fwd_attributes(ReproKernelAttr* out, int* err) {
  REPRO_ATTR(0, "K7 bf16 D32", flash_fwd_bf16_kernel<32>, K7_TC_THREADS,
             K7Tile<32>::smem_bytes);
  REPRO_ATTR(1, "K7 bf16 D64", flash_fwd_bf16_kernel<64>, K7_TC_THREADS,
             K7Tile<64>::smem_bytes);
  REPRO_ATTR(2, "K7 bf16 D128", flash_fwd_bf16_kernel<128>, K7_TC_THREADS,
             K7Tile<128>::smem_bytes);
  REPRO_ATTR(3, "K7 bf16 D256", flash_fwd_bf16_kernel<256>, K7_TC_THREADS,
             K7Tile<256>::smem_bytes);
  REPRO_ATTR(4, "K7 f32 D128", flash_attention_fwd_kernel<FLASH_NC_SMALL>,
             K7_THREADS, k7_f32_smem(16 * FLASH_NC_SMALL));
  REPRO_ATTR(5, "K7 f32 D256", flash_attention_fwd_kernel<FLASH_NC_LARGE>,
             K7_THREADS, k7_f32_smem(FLASH_MAX_D));
  return 6;
}
