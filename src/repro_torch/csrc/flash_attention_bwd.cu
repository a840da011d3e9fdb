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
// q, do (B, S, H, D) and k, v (B, S, KVH, D) in float32 or bfloat16, D <=
// 256, are read by stride as they lie (no transpose, no padding of S or D
// in device memory); m, linv, delta are (B, H, S) float32; dq comes back
// as (B, S, H, D) and dk, dv as (B, S, KVH, D), in the input dtype,
// rounded once at the end.  The scores never leave the block.
//
// What bounds them on the H100: operations.  Each allowed query-key pair
// costs 6 D multiply-adds in K8a (q.k, do.v, ds k) and 8 D in K8b (q.k,
// do.v, p do, ds q) against a few bytes per element of q, k, v, do and
// the outputs.
//
// In bfloat16 both run on the tensor cores: mma.sync m16n8k16, bf16 in,
// float32 accumulate, operands staged with cp.async and read with
// ldmatrix.  dS sums to zero along each query row, so dq = sum_j ds_ij k_j
// cancels and dK, dV sum P and dS over up to G x S query rows: one bf16
// rounding of P or dS misses the 5e-3 + 1e-2 relative tolerance (for dq
// at a peaked softmax, q scaled by 4, in a CPU emulation of the kernel,
// tests/test_torch_tc_numerics.py), so both kernels store P and dS as two
// bf16 terms (x = hi + lo, lo the rounding rest) and multiply both; the
// split error is ~2^-16.
//
// K8a in bfloat16 (flash_dq_bf16_kernel), K7's structure with one more
// score product: one block of 4 warps per (batch*head, 64-row query
// tile), each warp owning 16 query rows; every (batch, head)'s longest
// tile is dispatched first.  The rows of m, linv and delta are read once
// per tile into registers.  Q and dO are copied once with cp.async and
// kept as A fragments in registers (D <= 128) or re-read with ldmatrix (D
// 256).  K and V tiles (64 keys; 16 at D 256) sit in a two-stage cp.async
// ring: tile j + 1 is issued before tile j is computed.  Each tile runs in
// score steps of 32 keys (16 at D 256), so the S and dP fragments of a
// step stay small beside the dQ accumulator (64 floats a thread at D 128,
// 128 at D 256):
//  * S = Q K^T and dP = dO V^T (B from K and V with ldmatrix);
//  * P = exp2(S scale log2e - m log2e) linv, masked only where a key of
//    the step can pass a row of the warp, and dS = P (dP - delta), in
//    float32 on the C fragments;
//  * dQ += dS K: dS packed from the C fragments straight into hi and lo
//    bf16 A fragments (as K7 packs P), K read with ldmatrix.trans.
// Steps wholly above the warp's rows are skipped.  dQ is scaled once, in
// float32, in the epilogue.  Shared memory: 104,448 B at D 128, 101,376 B
// at D 256 (two blocks an SM).
//
// K8b in bfloat16 (flash_dkdv_bf16_kernel): one block of 8 warps per
// (batch*kv_head, key tile of BK = 64 keys, 32 at D 256) holds the K and V
// tiles and loops over the G query heads of its group and, for each, over
// the 64-row query tiles from the diagonal to S, so the group sum stays in
// registers: no partials in device memory, no atomics.  The q and do tiles
// and the rows of m, linv and delta go through a two-stage cp.async ring
// across that loop (the loads of step t + 1 are issued before step t is
// computed).  Each step:
//  * S^T = K Q^T and dP^T = V dO^T (B from q and do with ldmatrix); the
//    8 warps split the BK x 64 tile into 16-key x (64 / (8 / (BK / 16)))
//    query patches, K and V as A fragments (kept in registers at D <=
//    128);
//  * P^T = exp(scale S^T - m) linv, masked only on the diagonal tile, and
//    dS^T = P^T (dP^T - delta), in float32 on the C fragments;
//  * dV += P^T dO and dK += dS^T Q, with dO and Q read by ldmatrix.trans.
//    The dK and dV accumulators (2 x BK x D float32) are split across the
//    warps by columns: the warp with key rows r and column slice c holds
//    only that slice (64 floats a thread at D 128 and at D 256), so P^T and
//    dS^T, which every column slice needs, go through shared memory as
//    their hi and lo terms.
// dK is scaled once, in float32, in the epilogue.  Load balance: the key
// tiles' lengths fall linearly (tile 0 runs G * S / 64 steps, the last G);
// the grid dispatches every (batch, kv_head)'s longest tile first, so the
// longest-processing-time order keeps the SMs busy to within about one
// step of the mean at the training shape (256 blocks, one per SM).
//
// The float32 instantiations run on the CUDA cores with float32 tiles
// (tensor cores would compute float32 in TF32, which breaks the float32
// tolerance): 256 threads as a 16 x 16 grid each own a (ROWS / 16)^2
// patch of a ROWS x ROWS tile and NC columns (tx + 16 c) of the
// accumulator rows; ROWS is 64 for D <= 128 and 32 above, so the staged
// tiles fit the 227 KB a block may use.
//  * K8a: one block per (batch*head, query block), looping over the key
//    blocks up to the diagonal as K7 does: it stages the scaled q tile and
//    the do tile once, each k/v tile per key block, forms the scores and
//    do.v^T together, writes ds over the v tile and accumulates ds k into
//    registers.
//  * K8b: one block per (batch*kv_head, key block), looping over the
//    group's heads and the query blocks from the diagonal, forming p^T and
//    ds^T in shared memory and accumulating p^T do and ds^T (scale q).
// Both put the (batch, head) slice on the grid's x axis, so every slice's
// longest block is dispatched before any shorter one.
#include "flash_common.cuh"
#include "kernel_attributes.cuh"

struct K8Dims {
  int S, H, KVH, D, group;
  float scale;
};

// ------------------------------------------------ CUDA-core kernels

// floats of a tile region that holds a D-wide tile or a ROWS x ROWS one
template <int ROWS>
__host__ __device__ __forceinline__ int k8_tile_floats(int D) {
  const int w = (D + 1) > (ROWS + 1) ? (D + 1) : (ROWS + 1);
  return ROWS * w;
}

template <int ROWS, int NC>
__global__ void __launch_bounds__(FLASH_THREADS, 1)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ m, const float* __restrict__ linv,
                const float* __restrict__ delta, float* __restrict__ dq,
                K8Dims P) {
  constexpr int RI = ROWS / 16;  // patch rows and columns a thread owns
  extern __shared__ __align__(16) float smem[];
  const int DP = P.D + 1;
  const int PS = ROWS + 1;
  float* Qs = smem;                // ROWS x DP, pre-scaled
  float* dOs = Qs + ROWS * DP;     // ROWS x DP
  float* Ks = dOs + ROWS * DP;     // ROWS x DP
  float* Vs = Ks + ROWS * DP;      // ROWS x DP; then ds, ROWS x PS
  float* dSs = Vs;

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // longest rows first
  const int b = bh / P.H, h = bh - b * P.H;
  const int kvh = h / P.group;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = qb * ROWS;
  const long long q_stride = (long long)P.H * P.D;
  const long long kv_stride = (long long)P.KVH * P.D;
  const long long q_off = (long long)b * P.S * q_stride + (long long)h * P.D;
  const long long kv_off =
      (long long)b * P.S * kv_stride + (long long)kvh * P.D;

  flash_load_tile<ROWS>(Qs, q + q_off, q0, P.S, q_stride, P.D, P.scale);
  flash_load_tile<ROWS>(dOs, dout + q_off, q0, P.S, q_stride, P.D, 1.f);

  float m_i[RI], li_i[RI], dl_i[RI], acc[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    const long long si = (long long)bh * P.S + qp;
    m_i[i] = qp < P.S ? m[si] : 0.f;
    li_i[i] = qp < P.S ? linv[si] : 0.f;
    dl_i[i] = qp < P.S ? delta[si] : 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + ROWS, P.S) - 1;
  const int nkb = q_last / ROWS + 1;  // key blocks up to the diagonal
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * ROWS;
    __syncthreads();  // the previous key block's readers are done
    flash_load_tile_pair<ROWS>(Ks, Vs, k + kv_off, v + kv_off, k0, P.S,
                               kv_stride, P.D);
    __syncthreads();

    float sc[RI][RI], dp[RI][RI];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RI; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < P.D; ++d) {
      float a[RI], o[RI], bk[RI], bv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        a[i] = Qs[(ty + 16 * i) * DP + d];
        o[i] = dOs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        bk[j] = Ks[(tx + 16 * j) * DP + d];
        bv[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
          dp[i][j] = fmaf(o[i], bv[j], dp[i][j]);
        }
    }
    __syncthreads();  // every read of Vs is done: ds may overwrite it

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RI; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool allowed = kp <= qp && qp < P.S;
        const float p = allowed ? expf(sc[i][j] - m_i[i]) * li_i[i] : 0.f;
        dSs[(ty + 16 * i) * PS + tx + 16 * j] = p * (dp[i][j] - dl_i[i]);
      }
    }
    __syncthreads();  // the ds tile is complete

    for (int t = 0; t < ROWS; ++t) {
      float ds[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) ds[i] = dSs[(ty + 16 * i) * PS + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 16 * c;
        const float kk = col < P.D ? Ks[t * DP + col] : 0.f;
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][c] = fmaf(ds[i], kk, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= P.S) continue;
    float* row = dq + q_off + (long long)qp * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < P.D) row[col] = acc[i][c] * P.scale;
    }
  }
}

template <int ROWS, int NC>
__global__ void __launch_bounds__(FLASH_THREADS, 1)
flash_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ m,
                  const float* __restrict__ linv,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, K8Dims P) {
  constexpr int RI = ROWS / 16;
  extern __shared__ __align__(16) float smem[];
  const int DP = P.D + 1;
  const int PS = ROWS + 1;
  float* Ks = smem;                // ROWS x DP (keys)
  float* Vs = Ks + ROWS * DP;      // ROWS x DP
  float* Qs = Vs + ROWS * DP;      // ROWS x DP (queries), pre-scaled
  float* dOs = Qs + ROWS * DP;     // ROWS x DP
  float* PT = dOs + ROWS * DP;     // ROWS x PS: p^T (keys x queries)
  float* dST = PT + ROWS * PS;     // ROWS x PS: ds^T
  float* ms = dST + ROWS * PS;     // ROWS: the query rows' m
  float* ls = ms + ROWS;           // ROWS: linv
  float* dls = ls + ROWS;          // ROWS: delta

  const int bkv = blockIdx.x;
  const int kb = blockIdx.y;  // key block 0 has the most query blocks
  const int b = bkv / P.KVH, kvh = bkv - b * P.KVH;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = kb * ROWS;
  const long long q_stride = (long long)P.H * P.D;
  const long long kv_stride = (long long)P.KVH * P.D;
  const long long kv_off =
      (long long)b * P.S * kv_stride + (long long)kvh * P.D;

  flash_load_tile_pair<ROWS>(Ks, Vs, k + kv_off, v + kv_off, k0, P.S,
                             kv_stride, P.D);

  float acc_k[RI][NC], acc_v[RI][NC];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int nqb = (P.S + ROWS - 1) / ROWS;
  for (int g = 0; g < P.group; ++g) {
    const int h = kvh * P.group + g;
    const long long bh = (long long)b * P.H + h;
    const long long q_off =
        (long long)b * P.S * q_stride + (long long)h * P.D;
    // query blocks from the diagonal on (earlier ones see none of these
    // keys)
    for (int qb = kb; qb < nqb; ++qb) {
      const int q0 = qb * ROWS;
      __syncthreads();  // the previous query block's readers are done
      flash_load_tile<ROWS>(Qs, q + q_off, q0, P.S, q_stride, P.D, P.scale);
      flash_load_tile<ROWS>(dOs, dout + q_off, q0, P.S, q_stride, P.D, 1.f);
      for (int r = threadIdx.x; r < ROWS; r += FLASH_THREADS) {
        const int qp = q0 + r;
        const long long si = bh * P.S + qp;
        ms[r] = qp < P.S ? m[si] : 0.f;
        ls[r] = qp < P.S ? linv[si] : 0.f;
        dls[r] = qp < P.S ? delta[si] : 0.f;
      }
      __syncthreads();

      float st[RI][RI], dpt[RI][RI];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RI; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int d = 0; d < P.D; ++d) {
        float a[RI], av[RI], bq[RI], bo[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          a[i] = Ks[(ty + 16 * i) * DP + d];
          av[i] = Vs[(ty + 16 * i) * DP + d];
        }
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          bq[j] = Qs[(tx + 16 * j) * DP + d];
          bo[j] = dOs[(tx + 16 * j) * DP + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RI; ++j) {
            st[i][j] = fmaf(a[i], bq[j], st[i][j]);
            dpt[i][j] = fmaf(av[i], bo[j], dpt[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RI; ++j) {
          const int r = tx + 16 * j;
          const int qp = q0 + r;
          const bool allowed = kp <= qp && qp < P.S;
          const float p = allowed ? expf(st[i][j] - ms[r]) * ls[r] : 0.f;
          PT[(ty + 16 * i) * PS + r] = p;
          dST[(ty + 16 * i) * PS + r] = p * (dpt[i][j] - dls[r]);
        }
      }
      __syncthreads();  // p^T and ds^T are complete

      for (int t = 0; t < ROWS; ++t) {
        float pt[RI], dst[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          pt[i] = PT[(ty + 16 * i) * PS + t];
          dst[i] = dST[(ty + 16 * i) * PS + t];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = tx + 16 * c;
          const float oo = col < P.D ? dOs[t * DP + col] : 0.f;
          const float qq = col < P.D ? Qs[t * DP + col] : 0.f;
#pragma unroll
          for (int i = 0; i < RI; ++i) {
            acc_v[i][c] = fmaf(pt[i], oo, acc_v[i][c]);
            acc_k[i][c] = fmaf(dst[i], qq, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= P.S) continue;
    const long long off = kv_off + (long long)kp * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < P.D) {
        // q was staged pre-scaled, so acc_k already carries the scale
        dk[off + col] = acc_k[i][c];
        dv[off + col] = acc_v[i][c];
      }
    }
  }
}

// ------------------------------------------- K8b, bfloat16, tensor cores

#define K8_TC_THREADS 256  // 8 warps
#define K8_BQ 64           // query rows a step

template <int DP>
struct K8Tile {
  static constexpr int BK = DP > 128 ? 32 : 64;  // key rows a block
  static constexpr int LD = DP + 8;              // bf16 per q/do/k/v row
  static constexpr int PLD = K8_BQ + 8;          // bf16 per P^T/dS^T row
  // K, V; two stages of q and do; P^T and dS^T as hi and lo terms; two
  // stages of (m, linv, delta) rows
  static constexpr int smem_bytes =
      (2 * BK * LD + 4 * K8_BQ * LD + 4 * BK * PLD) * 2 + 2 * 3 * K8_BQ * 4;
};

template <int DP>
__global__ void __launch_bounds__(K8_TC_THREADS, 1)
flash_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ m,
                       const float* __restrict__ linv,
                       const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                       K8Dims P) {
  constexpr int BQ = K8_BQ, BK = K8Tile<DP>::BK, LD = K8Tile<DP>::LD,
                PLD = K8Tile<DP>::PLD;
  constexpr int NT = K8_TC_THREADS;
  constexpr int KG = BK / 16;    // 16-key row groups
  constexpr int WG = 8 / KG;     // warps sharing a row group
  constexpr int QW = BQ / WG;    // queries of a warp's score patch
  constexpr int CW = DP / WG;    // accumulator columns a warp owns
  constexpr int NQT = QW / 8;    // query n-tiles of the score patch
  constexpr int NCT = CW / 8;    // column n-tiles of the accumulators
  constexpr int KD = DP / 16;    // k-steps over the head dim
  constexpr bool KV_IN_REGS = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BK x LD
  bf16* Vs = Ks + BK * LD;                        // BK x LD
  bf16* Qs = Vs + BK * LD;                        // 2 stages of BQ x LD
  bf16* dOs = Qs + 2 * BQ * LD;                   // 2 stages of BQ x LD
  bf16* PT = dOs + 2 * BQ * LD;                   // BK x PLD, hi then lo
  bf16* dST = PT + 2 * BK * PLD;                  // BK x PLD, hi then lo
  float* stats = reinterpret_cast<float*>(dST + 2 * BK * PLD);  // 2 x 3 x BQ

  const int bkv = blockIdx.x;
  const int kb = blockIdx.y;  // key tile 0 has the most query tiles
  const int b = bkv / P.KVH, kvh = bkv - b * P.KVH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int kr = 16 * (warp % KG);  // the warp's key rows in the tile
  const int qc = QW * (warp / KG);  // its score patch's first query
  const int cc = CW * (warp / KG);  // its accumulator columns
  const int k0 = kb * BK;
  const long long q_stride = (long long)P.H * P.D;
  const long long kv_stride = (long long)P.KVH * P.D;
  const long long kv_off =
      (long long)b * P.S * kv_stride + (long long)kvh * P.D;
  const bool vec = (P.D & 7) == 0;

  // query tiles from the one holding key k0 to the end, for each head
  const int qb0 = k0 / BQ;
  const int nq = (P.S + BQ - 1) / BQ - qb0;
  const int nsteps = P.group * nq;

  // stage step t's q and do tiles and stat rows into ring slot ``slot``
  auto prefetch = [&](int t, int slot) {
    const int g = t / nq;
    const int q0 = (qb0 + t - g * nq) * BQ;
    const int h = kvh * P.group + g;
    const long long q_off =
        (long long)b * P.S * q_stride + (long long)h * P.D;
    flash_stage_bf16<BQ, DP, LD, NT>(Qs + slot * BQ * LD, q + q_off, q0, P.S,
                                     q_stride, P.D, vec);
    flash_stage_bf16<BQ, DP, LD, NT>(dOs + slot * BQ * LD, dout + q_off, q0,
                                     P.S, q_stride, P.D, vec);
    const long long si = ((long long)b * P.H + h) * P.S;
    for (int i = threadIdx.x; i < 3 * BQ; i += NT) {
      const int which = i / BQ, r = i - which * BQ;
      const float* src = which == 0 ? m : which == 1 ? linv : delta;
      const bool in = q0 + r < P.S;
      cp_async4(smem_u32(stats + (slot * 3 + which) * BQ + r),
                in ? src + si + q0 + r : src, in ? 4 : 0);
    }
  };

  flash_stage_bf16<BK, DP, LD, NT>(Ks, k + kv_off, k0, P.S, kv_stride, P.D,
                                   vec);
  flash_stage_bf16<BK, DP, LD, NT>(Vs, v + kv_off, k0, P.S, kv_stride, P.D,
                                   vec);
  prefetch(0, 0);
  cp_async_commit();

  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3),
            b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + (((lane >> 3) & 1) << 3),
            t_col = (lane >> 4) * 8;

  float acc_k[NCT][4], acc_v[NCT][4];
#pragma unroll
  for (int n = 0; n < NCT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  uint32_t kf[KV_IN_REGS ? KD : 1][4], vf[KV_IN_REGS ? KD : 1][4];
  const float sl2 = P.scale * FLASH_LOG2E;

  for (int t = 0; t < nsteps; ++t) {
    const int slot = t & 1;
    if (t + 1 < nsteps) prefetch(t + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // step t's tiles (and K, V) have landed
    __syncthreads();
    if constexpr (KV_IN_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          ldsm_x4(kf[kd], smem_u32(Ks + (kr + a_row) * LD + kd * 16 + a_col));
          ldsm_x4(vf[kd], smem_u32(Vs + (kr + a_row) * LD + kd * 16 + a_col));
        }
      }
    }
    const bf16* Qt = Qs + slot * BQ * LD;
    const bf16* dOt = dOs + slot * BQ * LD;
    const float* m_s = stats + slot * 3 * BQ;
    const float* li_s = m_s + BQ;
    const float* dl_s = li_s + BQ;
    const int q0 = (qb0 + t % nq) * BQ;

    // S^T = K Q^T and dP^T = V dO^T on the warp's 16 keys x QW queries
    float s[NQT][4], dp[NQT][4];
#pragma unroll
    for (int n = 0; n < NQT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ka[4], va[4];
      if constexpr (KV_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ka[e] = kf[kd][e];
          va[e] = vf[kd][e];
        }
      } else {
        ldsm_x4(ka, smem_u32(Ks + (kr + a_row) * LD + kd * 16 + a_col));
        ldsm_x4(va, smem_u32(Vs + (kr + a_row) * LD + kd * 16 + a_col));
      }
#pragma unroll
      for (int np = 0; np < NQT / 2; ++np) {
        const int off = (qc + np * 16 + b_row) * LD + kd * 16 + b_col;
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, smem_u32(Qt + off));
        ldsm_x4(bo, smem_u32(dOt + off));
        mma_bf16(s[2 * np], ka, bq[0], bq[1]);
        mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dp[2 * np], va, bo[0], bo[1]);
        mma_bf16(dp[2 * np + 1], va, bo[2], bo[3]);
      }
    }

    // P^T and dS^T in float32, stored as bf16 hi and lo terms
    const bool diag = q0 < k0 + BK - 1;
#pragma unroll
    for (int n = 0; n < NQT; ++n)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = kr + gid + 8 * hr;
        const int col = qc + n * 8 + 2 * tig;
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = col + e;
          float x = fast_exp2(fmaf(s[n][2 * hr + e], sl2,
                                   -m_s[c] * FLASH_LOG2E)) *
                    li_s[c];
          if (diag && k0 + row > q0 + c) x = 0.f;
          p[e] = x;
          ds[e] = x * (dp[n][2 * hr + e] - dl_s[c]);
        }
        const int at = row * PLD + col;
        *reinterpret_cast<uint32_t*>(PT + at) = pack_bf16(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(PT + BK * PLD + at) =
            pack_bf16_rest(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dST + at) = pack_bf16(ds[0], ds[1]);
        *reinterpret_cast<uint32_t*>(dST + BK * PLD + at) =
            pack_bf16_rest(ds[0], ds[1]);
      }
    __syncthreads();  // P^T and dS^T are complete

    // dV += P^T dO and dK += dS^T Q on the warp's 16 keys x CW columns
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const int aoff = (kr + a_row) * PLD + kk * 16 + a_col;
      uint32_t ph[4], pl[4], sh[4], sl[4];
      ldsm_x4(ph, smem_u32(PT + aoff));
      ldsm_x4(pl, smem_u32(PT + BK * PLD + aoff));
      ldsm_x4(sh, smem_u32(dST + aoff));
      ldsm_x4(sl, smem_u32(dST + BK * PLD + aoff));
#pragma unroll
      for (int cp = 0; cp < NCT / 2; ++cp) {
        const int boff = (kk * 16 + t_row) * LD + cc + cp * 16 + t_col;
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, smem_u32(dOt + boff));
        ldsm_x4_t(bq, smem_u32(Qt + boff));
        mma_bf16(acc_v[2 * cp], ph, bo[0], bo[1]);
        mma_bf16(acc_v[2 * cp + 1], ph, bo[2], bo[3]);
        mma_bf16(acc_v[2 * cp], pl, bo[0], bo[1]);
        mma_bf16(acc_v[2 * cp + 1], pl, bo[2], bo[3]);
        mma_bf16(acc_k[2 * cp], sh, bq[0], bq[1]);
        mma_bf16(acc_k[2 * cp + 1], sh, bq[2], bq[3]);
        mma_bf16(acc_k[2 * cp], sl, bq[0], bq[1]);
        mma_bf16(acc_k[2 * cp + 1], sl, bq[2], bq[3]);
      }
    }
    __syncthreads();  // slot and P^T/dS^T are read: both may be refilled
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kp = k0 + kr + gid + 8 * hr;
    if (kp >= P.S) continue;
    const long long off = kv_off + (long long)kp * kv_stride;
#pragma unroll
    for (int n = 0; n < NCT; ++n) {
      const int col = cc + n * 8 + 2 * tig;
      flash_store_pair(dk + off, col, P.D, acc_k[n][2 * hr] * P.scale,
                       acc_k[n][2 * hr + 1] * P.scale);
      flash_store_pair(dv + off, col, P.D, acc_v[n][2 * hr],
                       acc_v[n][2 * hr + 1]);
    }
  }
}

// ------------------------------------------- K8a, bfloat16, tensor cores

#define K8A_TC_THREADS 128  // 4 warps x 16 query rows
#define K8A_BQ 64           // query rows a block

template <int DP>
struct K8aTile {
  static constexpr int BK = DP > 128 ? 16 : 64;  // keys a staged tile
  static constexpr int KS = DP > 128 ? 16 : 32;  // keys a score step
  static constexpr int LD = DP + 8;              // bf16 per row
  // Q, dO; two stages of K and V
  static constexpr int smem_bytes = (2 * K8A_BQ + 4 * BK) * LD * 2;
};

template <int DP>
__global__ void __launch_bounds__(K8A_TC_THREADS, 2)
flash_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ m,
                     const float* __restrict__ linv,
                     const float* __restrict__ delta, bf16* __restrict__ dq,
                     K8Dims P) {
  constexpr int BQ = K8A_BQ, BK = K8aTile<DP>::BK, KS = K8aTile<DP>::KS,
                LD = K8aTile<DP>::LD;
  constexpr int NT = K8A_TC_THREADS;
  constexpr int NKS = KS / 8;   // key n-tiles of a score step
  constexpr int NDT = DP / 8;   // head-dim n-tiles of the accumulator
  constexpr int KD = DP / 16;   // k-steps over the head dim
  constexpr bool QO_IN_REGS = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BQ x LD
  bf16* dOs = Qs + BQ * LD;                       // BQ x LD
  bf16* Ks = dOs + BQ * LD;                       // 2 stages of BK x LD
  bf16* Vs = Ks + 2 * BK * LD;                    // 2 stages of BK x LD

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;  // longest tiles first
  const int b = bh / P.H, h = bh - b * P.H;
  const int kvh = h / P.group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q0 = qb * BQ;
  const int row0 = warp * 16;  // the warp's first row in the tile
  const long long q_stride = (long long)P.H * P.D;
  const long long kv_stride = (long long)P.KVH * P.D;
  const long long q_off = (long long)b * P.S * q_stride + (long long)h * P.D;
  const long long kv_off =
      (long long)b * P.S * kv_stride + (long long)kvh * P.D;
  const bf16* kg = k + kv_off;
  const bf16* vg = v + kv_off;
  const bool vec = (P.D & 7) == 0;

  flash_stage_bf16<BQ, DP, LD, NT>(Qs, q + q_off, q0, P.S, q_stride, P.D,
                                   vec);
  flash_stage_bf16<BQ, DP, LD, NT>(dOs, dout + q_off, q0, P.S, q_stride,
                                   P.D, vec);
  flash_stage_bf16<BK, DP, LD, NT>(Ks, kg, 0, P.S, kv_stride, P.D, vec);
  flash_stage_bf16<BK, DP, LD, NT>(Vs, vg, 0, P.S, kv_stride, P.D, vec);
  cp_async_commit();

  // the statistics of the thread's two C-fragment rows, gid and gid + 8
  // (zero past S: such a row's P is exp2(0) * 0)
  float mb[2], li[2], dl[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = q0 + row0 + gid + 8 * hr;
    const long long si = (long long)bh * P.S + qp;
    const bool in = qp < P.S;
    mb[hr] = in ? m[si] * FLASH_LOG2E : 0.f;
    li[hr] = in ? linv[si] : 0.f;
    dl[hr] = in ? delta[si] : 0.f;
  }

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
  uint32_t qf[QO_IN_REGS ? KD : 1][4], of[QO_IN_REGS ? KD : 1][4];
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
    cp_async_wait<1>();  // tile kb (and Q, dO) have landed
    __syncthreads();
    const bf16* Kt = Ks + st * BK * LD;
    const bf16* Vt = Vs + st * BK * LD;
    if constexpr (QO_IN_REGS) {
      if (kb == 0) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          const int off = (row0 + a_row) * LD + kd * 16 + a_col;
          ldsm_x4(qf[kd], smem_u32(Qs + off));
          ldsm_x4(of[kd], smem_u32(dOs + off));
        }
      }
    }

#pragma unroll
    for (int ks = 0; ks < BK / KS; ++ks) {
      const int kk0 = ks * KS;       // the step's first key in the tile
      const int kp0 = kb * BK + kk0;  // and in the sequence
      if (kp0 > q0 + row0 + 15) continue;  // every key past every row

      // S = Q K^T and dP = dO V^T on the warp's 16 rows x KS keys
      float s[NKS][4], dp[NKS][4];
#pragma unroll
      for (int n = 0; n < NKS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4], o[4];
        if constexpr (QO_IN_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a[e] = qf[kd][e];
            o[e] = of[kd][e];
          }
        } else {
          const int off = (row0 + a_row) * LD + kd * 16 + a_col;
          ldsm_x4(a, smem_u32(Qs + off));
          ldsm_x4(o, smem_u32(dOs + off));
        }
#pragma unroll
        for (int np = 0; np < NKS / 2; ++np) {
          const int off = (kk0 + np * 16 + b_row) * LD + kd * 16 + b_col;
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, smem_u32(Kt + off));
          ldsm_x4(bv, smem_u32(Vt + off));
          mma_bf16(s[2 * np], a, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
          mma_bf16(dp[2 * np], o, bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], o, bv[2], bv[3]);
        }
      }

      // dS = P (dP - delta) in float32 on the C fragments: rows gid (e 0,
      // 1) and gid + 8 (e 2, 3)
      const bool mask = kp0 + KS - 1 > q0 + row0;
#pragma unroll
      for (int n = 0; n < NKS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1;
          float p = fast_exp2(fmaf(s[n][e], sl2, -mb[hr])) * li[hr];
          if (mask && kp0 + n * 8 + 2 * tig + (e & 1) >
                          q0 + row0 + gid + 8 * hr)
            p = 0.f;
          s[n][e] = p * (dp[n][e] - dl[hr]);
        }

      // dQ += dS K: dS as hi and lo bf16 A fragments, K by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* c = s[2 * kk + (e >> 1)] + 2 * (e & 1);
          ah[e] = pack_bf16(c[0], c[1]);
          al[e] = pack_bf16_rest(c[0], c[1]);
        }
#pragma unroll
        for (int dt = 0; dt < DP / 16; ++dt) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, smem_u32(Kt + (kk0 + kk * 16 + t_row) * LD +
                                  dt * 16 + t_col));
          mma_bf16(acc[2 * dt], ah, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dt + 1], ah, bfr[2], bfr[3]);
          mma_bf16(acc[2 * dt], al, bfr[0], bfr[1]);
          mma_bf16(acc[2 * dt + 1], al, bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // stage st is read: the next prefetch may refill it
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qp = q0 + row0 + gid + 8 * hr;
    if (qp >= P.S) continue;
    bf16* row = dq + q_off + (long long)qp * q_stride;
#pragma unroll
    for (int n = 0; n < NDT; ++n)
      flash_store_pair(row, n * 8 + 2 * tig, P.D, acc[n][2 * hr] * P.scale,
                       acc[n][2 * hr + 1] * P.scale);
  }
}

// ---------------------------------------------------------- launchers

static bool k8_dims_ok(int B, int S, int H, int KVH, int D) {
  return B >= 1 && S >= 1 && KVH >= 1 && H % KVH == 0 && D >= 1 &&
         D <= FLASH_MAX_D && (S + 31) / 32 <= 65535;
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

template <int ROWS>
static int k8a_smem(int D) {
  return (3 * ROWS * (D + 1) + k8_tile_floats<ROWS>(D)) * (int)sizeof(float);
}

template <int ROWS>
static int k8b_f32_smem(int D) {
  return (4 * ROWS * (D + 1) + 2 * ROWS * (ROWS + 1) + 3 * ROWS) *
         (int)sizeof(float);
}

template <int ROWS, int NC>
static int launch_dq_f32(const void* q, const void* k, const void* v,
                         const void* dout, const float* m, const float* linv,
                         const float* delta, void* dq, int B,
                         const K8Dims& P, cudaStream_t st) {
  const int smem = k8a_smem<ROWS>(P.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<ROWS, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * P.H), (unsigned)((P.S + ROWS - 1) / ROWS));
  flash_dq_kernel<ROWS, NC><<<grid, FLASH_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      m, linv, delta, (float*)dq, P);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_dq_bf16(const void* q, const void* k, const void* v,
                          const void* dout, const float* m, const float* linv,
                          const float* delta, void* dq, int B,
                          const K8Dims& P, cudaStream_t st) {
  constexpr int smem = K8aTile<DP>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * P.H), (unsigned)((P.S + K8A_BQ - 1) / K8A_BQ));
  flash_dq_bf16_kernel<DP><<<grid, K8A_TC_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, m,
      linv, delta, (bf16*)dq, P);
  return (int)cudaGetLastError();
}

template <int ROWS, int NC>
static int launch_dkdv_f32(const void* q, const void* k, const void* v,
                           const void* dout, const float* m,
                           const float* linv, const float* delta, void* dk,
                           void* dv, int B, const K8Dims& P,
                           cudaStream_t st) {
  const int smem = k8b_f32_smem<ROWS>(P.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkdv_kernel<ROWS, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(B * P.KVH), (unsigned)((P.S + ROWS - 1) / ROWS));
  flash_dkdv_kernel<ROWS, NC><<<grid, FLASH_THREADS, smem, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      m, linv, delta, (float*)dk, (float*)dv, P);
  return (int)cudaGetLastError();
}

template <int DP>
static int launch_dkdv_bf16(const void* q, const void* k, const void* v,
                            const void* dout, const float* m,
                            const float* linv, const float* delta, void* dk,
                            void* dv, int B, const K8Dims& P,
                            cudaStream_t st) {
  constexpr int smem = K8Tile<DP>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkdv_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  constexpr int BK = K8Tile<DP>::BK;
  dim3 grid((unsigned)(B * P.KVH), (unsigned)((P.S + BK - 1) / BK));
  flash_dkdv_bf16_kernel<DP><<<grid, K8_TC_THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, m,
      linv, delta, (bf16*)dk, (bf16*)dv, P);
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
  if (!is_bf16)
    return D <= 16 * FLASH_NC_SMALL
               ? launch_dq_f32<64, FLASH_NC_SMALL>(q, k, v, dout, m, linv,
                                                   delta, dq, B, P, st)
               : launch_dq_f32<32, FLASH_NC_LARGE>(q, k, v, dout, m, linv,
                                                   delta, dq, B, P, st);
  switch (flash_dp(D)) {
    case 32:
      return launch_dq_bf16<32>(q, k, v, dout, m, linv, delta, dq, B, P, st);
    case 64:
      return launch_dq_bf16<64>(q, k, v, dout, m, linv, delta, dq, B, P, st);
    case 128:
      return launch_dq_bf16<128>(q, k, v, dout, m, linv, delta, dq, B, P,
                                 st);
    default:
      return launch_dq_bf16<256>(q, k, v, dout, m, linv, delta, dq, B, P,
                                 st);
  }
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
  if (!is_bf16)
    return D <= 16 * FLASH_NC_SMALL
               ? launch_dkdv_f32<64, FLASH_NC_SMALL>(q, k, v, dout, m, linv,
                                                     delta, dk, dv, B, P, st)
               : launch_dkdv_f32<32, FLASH_NC_LARGE>(q, k, v, dout, m, linv,
                                                     delta, dk, dv, B, P, st);
  switch (flash_dp(D)) {
    case 32:
      return launch_dkdv_bf16<32>(q, k, v, dout, m, linv, delta, dk, dv, B,
                                  P, st);
    case 64:
      return launch_dkdv_bf16<64>(q, k, v, dout, m, linv, delta, dk, dv, B,
                                  P, st);
    case 128:
      return launch_dkdv_bf16<128>(q, k, v, dout, m, linv, delta, dk, dv, B,
                                   P, st);
    default:
      return launch_dkdv_bf16<256>(q, k, v, dout, m, linv, delta, dk, dv, B,
                                   P, st);
  }
}

// the dynamic shared memory a K8a (which 0) or K8b (which 1) launch at
// head dim D asks for (-1 if D is out of range)
extern "C" int repro_k8_smem_bytes(int which, int D, int is_bf16) {
  if (D < 1 || D > FLASH_MAX_D) return -1;
  const bool small = D <= 16 * FLASH_NC_SMALL;
  if (!is_bf16) {
    if (which == 0) return small ? k8a_smem<64>(D) : k8a_smem<32>(D);
    return small ? k8b_f32_smem<64>(D) : k8b_f32_smem<32>(D);
  }
  switch (flash_dp(D)) {
    case 32:
      return which == 0 ? K8aTile<32>::smem_bytes : K8Tile<32>::smem_bytes;
    case 64:
      return which == 0 ? K8aTile<64>::smem_bytes : K8Tile<64>::smem_bytes;
    case 128:
      return which == 0 ? K8aTile<128>::smem_bytes : K8Tile<128>::smem_bytes;
    default:
      return which == 0 ? K8aTile<256>::smem_bytes : K8Tile<256>::smem_bytes;
  }
}

// K8a's and K8b's instantiations, each at the largest head dim it takes
// (kernel_attributes.cuh)
int repro_flash_bwd_attributes(ReproKernelAttr* out, int* err) {
  constexpr int small = 16 * FLASH_NC_SMALL;
  REPRO_ATTR(0, "K8a bf16 D32", flash_dq_bf16_kernel<32>, K8A_TC_THREADS,
             K8aTile<32>::smem_bytes);
  REPRO_ATTR(1, "K8a bf16 D64", flash_dq_bf16_kernel<64>, K8A_TC_THREADS,
             K8aTile<64>::smem_bytes);
  REPRO_ATTR(2, "K8a bf16 D128", flash_dq_bf16_kernel<128>, K8A_TC_THREADS,
             K8aTile<128>::smem_bytes);
  REPRO_ATTR(3, "K8a bf16 D256", flash_dq_bf16_kernel<256>, K8A_TC_THREADS,
             K8aTile<256>::smem_bytes);
  REPRO_ATTR(4, "K8a f32 D128", (flash_dq_kernel<64, FLASH_NC_SMALL>),
             FLASH_THREADS, k8a_smem<64>(small));
  REPRO_ATTR(5, "K8a f32 D256", (flash_dq_kernel<32, FLASH_NC_LARGE>),
             FLASH_THREADS, k8a_smem<32>(FLASH_MAX_D));
  REPRO_ATTR(6, "K8b bf16 D32", flash_dkdv_bf16_kernel<32>, K8_TC_THREADS,
             K8Tile<32>::smem_bytes);
  REPRO_ATTR(7, "K8b bf16 D64", flash_dkdv_bf16_kernel<64>, K8_TC_THREADS,
             K8Tile<64>::smem_bytes);
  REPRO_ATTR(8, "K8b bf16 D128", flash_dkdv_bf16_kernel<128>, K8_TC_THREADS,
             K8Tile<128>::smem_bytes);
  REPRO_ATTR(9, "K8b bf16 D256", flash_dkdv_bf16_kernel<256>, K8_TC_THREADS,
             K8Tile<256>::smem_bytes);
  REPRO_ATTR(10, "K8b f32 D128", (flash_dkdv_kernel<64, FLASH_NC_SMALL>),
             FLASH_THREADS, k8b_f32_smem<64>(small));
  REPRO_ATTR(11, "K8b f32 D256", (flash_dkdv_kernel<32, FLASH_NC_LARGE>),
             FLASH_THREADS, k8b_f32_smem<32>(FLASH_MAX_D));
  return 12;
}
