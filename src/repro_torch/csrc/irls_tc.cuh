// The IRLS summaries on Hopper's tensor cores: the rows, Gram and reduce
// code that K3 (csrc/fused_irls.cu), K5 (csrc/fused_irls_cv.cu) and K6
// (csrc/gram_hessian.cu) share.  Each of those files wraps the bodies
// below in `__global__` kernels of its own name, so a profile and the
// ptxas report tell the three apart, and exports its plan and entry.
//
// The contract (the JAX fused_irls_sim / fused_irls_cv_sim one).
// Configuration q carries its own iterate betas[q] and held-out fold
// fold_of[q] (-1: none, a full-data fit; K3 passes no folds at all, so
// every valid row trains).  For institution s with counts[s] valid rows
// (a count past n_max reads n_max rows), row r is
//
//   valid = r < counts[s],  hold = valid && fold_ids[s, r] == fold_of[q],
//   train = valid && !hold
//
// (the row mask comes first: padding rows carry fold id -1, which equals a
// refit's fold_of; no kernel reads a row past counts[s]), and
//
//   H[q, s]           = Xm^T diag(w * train) Xm   float32 sums, 3xTF32
//   g[q, s]           = X^T ((y - p) * train)     float64
//   dev_train/dev_val = -2 sum(y z - softplus z) over train / hold rows
//   correct_val       = #hold rows with (z > 0) == (y > 0.5)  (z = 0 is 0)
//   count_val         = #hold rows
//
// with z = X betas[q], p = sigmoid(z), w = p (1 - p), all in float64 but
// the Gram; K6 takes w from its caller instead.  The Gram's products run
// on the tensor cores: a = (w Xm) rounded to float32 as the plain version
// rounds it, each of a and Xm split into two TF32 terms, x = hi + lo with
// hi = rna(x) and lo = rna(x - hi), and H = a_lo^T x_hi + a_hi^T x_lo +
// a_hi^T x_hi.  The dropped a_lo x_lo term and the split's rounding are
// ~2^-21 of each product.  The tensor cores round their float32 sums
// toward zero, and a chain of such sums over a slice of a few thousand
// rows drifts past the float32 tolerance: so each staged tile's products
// (32 rows) start from zero, the small cross terms first, and are added to
// the running sum in float32 with round to nearest; the slices' float32
// partials are added in float64 and rounded once.  Every sum runs in a
// fixed order and no kernel uses float atomics: two calls give the same
// bits.
//
// Three kernels (K6 launches the last two):
//
// 1. irls_rows, the float64 work; what bounds it is the read of X (8 d
//    bytes a row).  Grid (chunks of 8 configurations, NSLR row slices,
//    S).  A block reads its rows of X once for its 8 configurations, in
//    tiles of TNR rows through a two-stage cp.async ring.  z = X betas^T
//    and g += X^T r run on the float64 tensor cores (mma.sync m8n8k4, the
//    8 configurations its n, unused ones zero; float64 products and sums,
//    in a fixed order); between them one thread per (configuration, row)
//    computes p, the train weight (written to w, float32, for the Gram),
//    the residual and the statistics.
// 2. irls_gram, the Gram on Hopper's warpgroup products (wgmma: a = w x
//    from registers, x from shared memory, float32 sums).  H is cut into
//    tiles of 64 rows by NT columns, a warpgroup's, of which only those
//    that reach the diagonal or above are computed (the reduce mirrors the
//    result).  A block is a producer (a warp, or a warpgroup that hands
//    its registers to the consumers) and one or two consumer warpgroups;
//    they meet only at mbarriers, a full and an empty one a stage, never
//    at a block-wide barrier.  The producer keeps RSTAGES tiles of IRLS_TN
//    rows in flight (cp.async): the block's column ranges of Xm, zero past
//    the slice and past d, and the rows' weights.  A consumer warpgroup
//    splits tile t + 1's x once into the TF32 terms x_hi and x_lo (K-major
//    in tc_common.cuh's core layout, one of SSTAGES split stages) while
//    the tensor cores run tile t; each warpgroup forms its a = w x from
//    the staged tile in registers, splits it there into a_hi and a_lo, and
//    issues the tile's products a k-step at a time, its 64 x 128 tile as
//    two 64-column chains.  The tile is chosen by d alone:
//    - narrow, d <= 32: one warpgroup computes the whole 64 x 32 upper
//      block (NT = 32) and streams Xm once.  What bounds it is the read of
//      Xm (4 d bytes a row) beside one warpgroup's chain of products a
//      tile (the 64 rows padded from d), four blocks an SM;
//    - wide, d > 32: H is cut into 128-column ranges and a block takes the
//      range pair (I, J), I <= J: its two warpgroups compute rows 128 I +
//      0..63 and 64..127 against columns 128 J + 0..127 (NT = 128), so x_hi
//      and x_lo of range J are split once a tile for both (the warpgroups
//      take turns), and a row of Xm is split ceil(d / 128) times.  What
//      bounds it is the staging from L2 (the blocks of a row read its
//      ranges 2 ceil(d / 128) times over: 4x Xm at d = 500) beside the
//      consumers' chain: shared memory carries the split, the loads of a
//      and each product's read of x_hi or x_lo (64 bytes a clock at the
//      TF32 peak).
//    The grid is (Q x units, NSLG, S), the range pair the fastest axis,
//    so the blocks that read the same rows of Xm run side by side and
//    share them through L2.
// 3. irls_reduce sums the per-slice partials (the upper half of each H,
//    packed, float32; g and the statistics in float64) in a fixed order,
//    H's in float64 rounded once, and mirrors H; it moves the partials
//    once, a few percent of the Gram.
//
// The launch plan.  irls_plan reports the configurations a rows block, the
// rows kernel's tile rows (the largest of 32, 16, 8 whose shared memory
// lets two blocks share an SM), the Gram's tile rows (IRLS_TN), the Gram
// blocks a configuration (the range pairs: one in the narrow regime) and
// the Gram blocks an SM; kernels/fused_irls.py picks the slice counts from
// it: about two rows blocks an SM, and the fewest Gram slices from one
// full wave whose waves are at least 95% full, no slice shorter than a
// tile.
#pragma once

#include "kernel_attributes.cuh"
#include "tc_common.cuh"

#define IRLS_THREADS 256     // the rows and reduce kernels
#define IRLS_WARPS (IRLS_THREADS / 32)
#define IRLS_CB 8            // configurations a rows block (the dmma's n)
#define IRLS_MAX_DIM 1024
#define IRLS_NSTAT 4         // dev_train, dev_val, correct_val, count_val
#define IRLS_TN 32           // rows a Gram tile: one tensor-core chain
#define IRLS_TWO_PER_SM (113 * 1024)  // shared memory for two blocks an SM
#define IRLS_MAX_SMEM (227 * 1024)

struct IrlsDims {
  int S;
  long long n_max;
  int d;
  int C;      // configurations
  int NSLR;   // row slices of the rows kernel
  int TNR;    // rows a tile of the rows kernel: 8, 16 or 32
  int NSLG;   // row slices of the Gram kernel
  int ldx;    // doubles per staged X row and beta row: d rounded to 16,
              // plus 4, so the dmma fragments' 8-byte loads hit distinct
              // banks
  int nt;     // columns of a Gram warpgroup's tile: 32 (narrow) or 128
  int nr;     // NT-column ranges of H
  int units;  // Gram blocks a configuration: the range pairs (I, J), I <= J
  int vec_x;  // X rows start on 16 bytes: 16-byte copies
  int vec_m;  // Xm rows start on 16 bytes
};

// the Gram warpgroup's tile columns at dimension d: the narrow regime's
// whole upper block up to d = 32, 128-column ranges past it
static int irls_gram_nt(int d) { return d <= 32 ? 32 : 128; }

static IrlsDims irls_dims(int d) {
  IrlsDims D = {};
  D.d = d;
  D.ldx = (d + 15) / 16 * 16 + 4;
  D.nt = irls_gram_nt(d);
  D.nr = (d + D.nt - 1) / D.nt;
  D.units = D.nr * (D.nr + 1) / 2;
  return D;
}

static size_t irls_rows_smem(const IrlsDims& D, int TNR) {
  return sizeof(double) * ((size_t)2 * TNR * D.ldx + IRLS_CB * D.ldx +
                           64 * IRLS_CB + IRLS_CB * (TNR + 4) + 2 * TNR +
                           IRLS_THREADS * IRLS_NSTAT) +
         sizeof(int) * 2 * TNR;
}

// A Gram kernel's shape at warpgroup tile width NT
template <int NT>
struct IrlsGram {
  static constexpr int WGS = NT > 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int CONSUMERS = 128 * WGS;
  // the producer: a warp, or (wide) a warpgroup that hands registers to
  // the consumers (setmaxnreg: PREGS a thread, the consumers CREGS)
  static constexpr int PRODUCERS = NT > 64 ? 128 : 32;
  static constexpr int PREGS = 72, CREGS = 216;  // the block's 168 a thread
  static constexpr int THREADS = CONSUMERS + PRODUCERS;
  static constexpr int MIN_BLOCKS = NT > 64 ? 1 : 3;
  static constexpr int RSTAGES = NT > 64 ? 3 : 4;  // raw tiles in flight
  static constexpr int SSTAGES = NT > 64 ? 3 : 2;  // split tiles: two
                                                   // warpgroups drift
  static constexpr int LDR = NT + 8;  // floats a staged row: A's loads hit
                                      // distinct banks
  static constexpr int RAW = WGS * IRLS_TN * LDR;  // a stage: the j-range,
                                                   // and the i-range (wide)
  static constexpr int OPS = NT * IRLS_TN;  // floats of x_hi (or x_lo)
};

// the split stages (x_hi and x_lo), the raw stages (the ranges and the
// weights), and a full and an empty mbarrier a stage of each
template <int NT>
static size_t irls_gram_smem_of() {
  using G = IrlsGram<NT>;
  return sizeof(float) * (G::SSTAGES * 2 * G::OPS +
                          G::RSTAGES * (G::RAW + IRLS_TN)) +
         sizeof(uint64_t) * 2 * (G::RSTAGES + G::SSTAGES);
}

static size_t irls_gram_smem(int nt) {
  return nt > 64 ? irls_gram_smem_of<128>() : irls_gram_smem_of<32>();
}

static int irls_gram_threads(int nt) {
  return nt > 64 ? IrlsGram<128>::THREADS : IrlsGram<32>::THREADS;
}

// the largest of 32, 16, 8 rows whose rows-kernel shared memory lets two
// blocks share an SM, else 8 (one block)
static int irls_rows_tile(const IrlsDims& D) {
  for (int tn = 32; tn >= 8; tn /= 2)
    if (irls_rows_smem(D, tn) <= IRLS_TWO_PER_SM) return tn;
  return irls_rows_smem(D, 8) <= IRLS_MAX_SMEM ? 8 : -1;
}

extern __shared__ __align__(128) unsigned char irls_smem[];

// rows [r_begin, r_end) of slice sl of nsl over an institution's count
// valid rows, the count clamped to n_max (an int clamp: a 64-bit min() in
// its place made the CUDA-core K3 11% slower on an H100)
__device__ __forceinline__ void irls_slice(int cnt, long long n_max, int sl,
                                           int nsl, long long& r_begin,
                                           long long& r_end) {
  if ((long long)cnt > n_max) cnt = (int)n_max;
  const long long count = cnt;
  const long long chunk = (count + nsl - 1) / nsl;
  r_begin = min(count, (long long)sl * chunk);
  r_end = min(count, r_begin + chunk);
}

// ------------------------------------------------- 1. the float64 rows

// X rows [r0, r0 + TNR) (zero past nrows), their y and (where there are
// folds) fold ids, into one ring slot
__device__ __forceinline__ void irls_stage_rows(double* Xs, double* ys,
                                                int* fs, const double* Xb,
                                                const double* yb,
                                                const int* fb, long long r0,
                                                int nrows, const IrlsDims& D) {
  const int tid = threadIdx.x;
  if (D.vec_x) {
    const int ch = D.d / 2;  // 16-byte chunks a row (d even)
    for (int idx = tid; idx < D.TNR * ch; idx += IRLS_THREADS) {
      const int r = idx / ch, c = (idx - r * ch) * 2;
      const bool in = r < nrows;
      cp_async16(smem_u32(Xs + r * D.ldx + c),
                 in ? Xb + (r0 + r) * D.d + c : Xb, in ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < D.TNR * D.d; idx += IRLS_THREADS) {
      const int r = idx / D.d, c = idx - r * D.d;
      const bool in = r < nrows;
      cp_async8(smem_u32(Xs + r * D.ldx + c),
                in ? Xb + (r0 + r) * D.d + c : Xb, in ? 8 : 0);
    }
  }
  if (tid < D.TNR) {
    const bool in = tid < nrows;
    cp_async8(smem_u32(ys + tid), in ? yb + r0 + tid : yb, in ? 8 : 0);
    if (fb)
      cp_async4(smem_u32(fs + tid), in ? fb + r0 + tid : fb, in ? 4 : 0);
  }
}

// d += a (8 x 4, row) b (4 x 8, col) on the float64 tensor cores: thread
// (gid, tig) gives a[gid][tig] and b[tig][gid] and holds d[gid][2 tig + 0..1]
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

#define IRLS_ROWS_PARAMS                                                   \
  const double *__restrict__ betas, const double *__restrict__ X,          \
      const double *__restrict__ y, const int *__restrict__ counts,        \
      const int *__restrict__ fold_ids, const int *__restrict__ fold_of,   \
      float *__restrict__ w, double *__restrict__ gp,                      \
      double *__restrict__ sp, IrlsDims D
#define IRLS_ROWS_ARGS betas, X, y, counts, fold_ids, fold_of, w, gp, sp, D

// MTW: 8-column m-tiles of g each warp owns (ceil(d / 64) rounded up to a
// power of two).  fold_ids == nullptr (and fold_of == nullptr): no folds,
// every valid row trains.
template <int MTW>
__device__ __forceinline__ void irls_rows(IRLS_ROWS_PARAMS) {
  const int TN = D.TNR, RS = TN + 4;
  const int MT = TN / 8, KS = IRLS_WARPS / MT;  // z: m-tiles, K splits
  double* Xs = (double*)irls_smem;        // 2 stages of TN x ldx
  double* bs = Xs + 2 * TN * D.ldx;       // IRLS_CB x ldx
  double* zp = bs + IRLS_CB * D.ldx;      // KS x IRLS_CB x TN partial z
  double* rs = zp + KS * IRLS_CB * TN;    // IRLS_CB x RS train residuals
  double* ys = rs + IRLS_CB * RS;         // 2 stages of TN
  double* red = ys + 2 * TN;              // IRLS_THREADS x IRLS_NSTAT
  int* fs = (int*)(red + IRLS_THREADS * IRLS_NSTAT);  // 2 stages of TN

  const int c0 = blockIdx.x * IRLS_CB;
  const int nc = min(IRLS_CB, D.C - c0);  // configurations of this block
  const int sl = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  long long r_begin, r_end;
  irls_slice(counts[s], D.n_max, sl, D.NSLR, r_begin, r_end);
  const double* Xb = X + (long long)s * D.n_max * D.d;
  const double* yb = y + (long long)s * D.n_max;
  const int* fb = fold_ids ? fold_ids + (long long)s * D.n_max : nullptr;

  // betas (zero past the block's configurations and past d), the X pads
  // past d (never copied), the residuals
  for (int i = tid; i < IRLS_CB * D.ldx; i += IRLS_THREADS) {
    const int c = i / D.ldx, k = i - c * D.ldx;
    bs[i] = c < nc && k < D.d ? betas[(long long)(c0 + c) * D.d + k] : 0.0;
  }
  for (int i = tid; i < 2 * TN * D.ldx; i += IRLS_THREADS)
    if (i % D.ldx >= D.d) Xs[i] = 0.0;
  for (int i = tid; i < IRLS_CB * RS; i += IRLS_THREADS) rs[i] = 0.0;

  // the epilogue's thread (configuration ce, row re)
  const int ce = tid / TN, re = tid - ce * TN;
  const bool epi = ce < nc;
  const int fold = epi && fb ? fold_of[c0 + ce] : 0;
  float* wq = w + ((long long)(c0 + (epi ? ce : 0)) * D.S + s) * D.n_max;
  // z: warp (m-tile zm of the tile's rows, K split zk); g: m-tiles warp +
  // 8 i of the columns, for configurations 2 tig and 2 tig + 1
  const int zm = warp % MT, zk = warp / MT;
  const int ksteps = (D.d + 3) / 4;
  double gacc[MTW][2];
#pragma unroll
  for (int i = 0; i < MTW; ++i) gacc[i][0] = gacc[i][1] = 0.0;
  double st[IRLS_NSTAT] = {0.0, 0.0, 0.0, 0.0};

  const int ntiles = (int)((r_end - r_begin + TN - 1) / TN);
  __syncthreads();
  if (ntiles > 0)
    irls_stage_rows(Xs, ys, fs, Xb, yb, fb, r_begin,
                    (int)min((long long)TN, r_end - r_begin), D);
  cp_async_commit();

  for (int it = 0; it < ntiles; ++it) {
    const int slot = it & 1;
    const long long r0 = r_begin + (long long)it * TN;
    const int nrows = (int)min((long long)TN, r_end - r0);
    if (it + 1 < ntiles) {
      const long long r1 = r0 + TN;
      irls_stage_rows(Xs + (slot ^ 1) * TN * D.ldx, ys + (slot ^ 1) * TN,
                      fs + (slot ^ 1) * TN, Xb, yb, fb, r1,
                      (int)min((long long)TN, r_end - r1), D);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed
    __syncthreads();
    const double* Xt = Xs + slot * TN * D.ldx;

    // z = X betas^T on the float64 tensor cores: this warp's 8 rows, its
    // share of the k-steps, all eight configuration columns
    {
      double zc[2] = {0.0, 0.0};
      const double* xa = Xt + (8 * zm + gid) * D.ldx + tig;
      const double* xb = bs + gid * D.ldx + tig;
      for (int kk = zk; kk < ksteps; kk += KS)
        dmma(zc, xa[4 * kk], xb[4 * kk]);
      double* o = zp + (zk * IRLS_CB + 2 * tig) * TN + 8 * zm + gid;
      o[0] = zc[0];
      o[TN] = zc[1];
    }
    __syncthreads();  // the partial z are complete

    // p, the weight, the residual and the statistics of (ce, re)
    if (epi) {
      double resid = 0.0;
      if (re < nrows) {  // a valid row: r0 + re < counts[s]
        double z = 0.0;
        for (int k = 0; k < KS; ++k) z += zp[(k * IRLS_CB + ce) * TN + re];
        const double e = exp(-fabs(z));
        const double p = z >= 0.0 ? 1.0 / (1.0 + e) : e / (1.0 + e);
        const double yr = ys[slot * TN + re];
        const double ll = yr * z - (fmax(z, 0.0) + log1p(e));
        float w32 = 0.f;
        if (fb && fs[slot * TN + re] == fold) {  // held out
          st[1] += ll;
          st[2] += ((z > 0.0) == (yr > 0.5)) ? 1.0 : 0.0;
          st[3] += 1.0;
        } else {  // trains
          w32 = (float)(p * (1.0 - p));
          resid = yr - p;
          st[0] += ll;
        }
        wq[r0 + re] = w32;
      }
      rs[ce * RS + re] = resid;
    }
    __syncthreads();  // rs is complete

    // g += X^T r on the float64 tensor cores: columns of this warp's
    // m-tiles, all eight configurations
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int mt = warp + IRLS_WARPS * i;
      if (8 * mt >= D.d) break;
      const double* xa = Xt + tig * D.ldx + 8 * mt + gid;
      const double* rb = rs + gid * RS + tig;
      for (int k0 = 0; k0 < TN; k0 += 4)
        dmma(gacc[i], xa[k0 * D.ldx], rb[k0]);
    }
    __syncthreads();  // slot, zp and rs are read: all may be refilled
  }

#pragma unroll
  for (int i = 0; i < MTW; ++i) {
    const int col = 8 * (warp + IRLS_WARPS * i) + gid;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * tig + h;
      if (col < D.d && c < nc)
        gp[(((long long)(c0 + c) * D.S + s) * D.NSLR + sl) * D.d + col] =
            gacc[i][h];
    }
  }
#pragma unroll
  for (int k = 0; k < IRLS_NSTAT; ++k) red[tid * IRLS_NSTAT + k] = st[k];
  __syncthreads();
  if (tid < nc * IRLS_NSTAT) {
    const int c = tid / IRLS_NSTAT, k = tid - c * IRLS_NSTAT;
    double tot = 0.0;
    for (int r = 0; r < TN; ++r) tot += red[(c * TN + r) * IRLS_NSTAT + k];
    // the deviances carry the -2; the counts go out as they are
    sp[(((long long)(c0 + c) * D.S + s) * D.NSLR + sl) * IRLS_NSTAT + k] =
        k < 2 ? -2.0 * tot : tot;
  }
}

// ------------------------------------------ 2. the Gram, tensor cores

// range pair b of the upper triangle, row by row: (qi, qj), qi <= qj
__device__ __forceinline__ void irls_block(int b, int nq, int& qi, int& qj) {
  for (qi = 0; b >= nq - qi; ++qi) b -= nq - qi;
  qj = qi + b;
}

// x as hi + lo, two TF32 terms as floats
__device__ __forceinline__ void irls_split(float x, float& hi, float& lo) {
  uint32_t h, l;
  tf32_split(x, h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// the compiler keeps these registers where the asm leaves them: no read or
// write of them moves across this point (the accumulator, and the A
// fragments an issued product still reads)
template <int N>
__device__ __forceinline__ void irls_fence_operand(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

template <int K>
__device__ __forceinline__ void irls_fence_frag(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[k][e])::"memory");
}

#define IRLS_GRAM_PARAMS                                                \
  const float *__restrict__ Xm, const float *__restrict__ w,            \
      const int *__restrict__ counts, float *__restrict__ Hp, IrlsDims D
#define IRLS_GRAM_ARGS Xm, w, counts, Hp, D

// counts == nullptr: every institution's n_max rows are valid (K6)
template <int NT>
__device__ __forceinline__ void irls_gram(IRLS_GRAM_PARAMS) {
  using G = IrlsGram<NT>;
  constexpr int KG = IRLS_TN / 4;  // cores along K a tile
  constexpr int KS = IRLS_TN / 8;  // k-steps a tile
  constexpr int RS = G::RSTAGES, SS = G::SSTAGES;
  float* sb = (float*)irls_smem;     // SS split stages of x_hi, x_lo
  float* raw = sb + SS * 2 * G::OPS;  // RS raw stages of G::RAW
  float* ws = raw + RS * G::RAW;      // RS x IRLS_TN weights
  uint64_t* raw_full = (uint64_t*)(ws + RS * IRLS_TN);
  uint64_t* raw_empty = raw_full + RS;
  uint64_t* split_full = raw_empty + RS;
  uint64_t* split_empty = split_full + SS;

  // the block's range pair: rows of H from range bi, columns from bj
  const int q = blockIdx.x / D.units, u = blockIdx.x - q * D.units;
  const int sl = blockIdx.y, s = blockIdx.z;
  int bi, bj;
  irls_block(u, D.nr, bi, bj);
  const bool diag = bi == bj;  // one raw range serves both
  long long r_begin, r_end;
  irls_slice(counts ? counts[s] : (int)D.n_max, D.n_max, sl, D.NSLG,
             r_begin, r_end);
  const int ntiles = (int)((r_end - r_begin + IRLS_TN - 1) / IRLS_TN);

  if (threadIdx.x == 0) {
    for (int i = 0; i < RS; ++i) {
      mbar_init(raw_full + i, G::PRODUCERS);       // their copies landed
      mbar_init(raw_empty + i, G::CONSUMERS / 32);  // a's loads done
    }
    for (int i = 0; i < SS; ++i) {
      mbar_init(split_full + i, 128);                 // split
      mbar_init(split_empty + i, G::CONSUMERS / 32);  // products done
    }
    mbar_init_fence();
  }
  __syncthreads();

  // the warp's role, as a value the compiler knows to be the same in the
  // whole warp: a branch on threadIdx.x would make it treat every product
  // as divergent and serialise them
  const int warp_id = __shfl_sync(0xffffffff, (int)threadIdx.x / 32, 0);
  if (warp_id >= G::CONSUMERS / 32) {
    // The producer: tile t's rows of the j-range (and, off the diagonal,
    // of the i-range) and their weights go to raw stage t % RS once the
    // consumers have read tile t - RS there.
    if constexpr (G::PRODUCERS == 128) wg_setmaxnreg_dec<G::PREGS>();
    const int ptid = threadIdx.x - G::CONSUMERS;
    const float* Xmb = Xm + (long long)s * D.n_max * D.d;
    const float* wb = w + ((long long)q * D.S + s) * D.n_max;
    auto copy = [&](int t) {
      const int st = t % RS;
      if (t >= RS) mbar_wait(raw_empty + st, (t / RS - 1) & 1);
      const long long r0 = r_begin + (long long)t * IRLS_TN;
      const int nrows = (int)min((long long)IRLS_TN, r_end - r0);
      const float* src = Xmb + r0 * D.d;
      for (int rg = 0; rg < (diag ? 1 : 2); ++rg) {
        float* dst = raw + st * G::RAW + rg * IRLS_TN * G::LDR;
        const int c0 = (rg ? bi : bj) * NT;
        if (D.vec_m) {  // d % 4 == 0: a chunk is all in or all out
          constexpr int CPR = NT / 4;  // 16-byte chunks a row
          const int c = 4 * (ptid % CPR);
          const bool cin = c0 + c < D.d;
#pragma unroll 1
          for (int row = ptid / CPR; row < IRLS_TN;
               row += G::PRODUCERS / CPR) {
            const bool in = cin && row < nrows;
            cp_async16(smem_u32(dst + row * G::LDR + c),
                       in ? src + (long long)row * D.d + c0 + c : Xmb,
                       in ? 16 : 0);
          }
        } else {
          for (int idx = ptid; idx < IRLS_TN * NT; idx += G::PRODUCERS) {
            const int row = idx / NT, c = idx - row * NT;
            const bool in = row < nrows && c0 + c < D.d;
            cp_async4(smem_u32(dst + row * G::LDR + c),
                      in ? src + (long long)row * D.d + c0 + c : Xmb,
                      in ? 4 : 0);
          }
        }
      }
      if (ptid < IRLS_TN) {
        const bool in = ptid < nrows;
        cp_async4(smem_u32(ws + st * IRLS_TN + ptid),
                  in ? wb + r0 + ptid : wb, in ? 4 : 0);
      }
      cp_async_mbar_arrive(raw_full + st);
    };
    for (int t = 0; t < ntiles; ++t) copy(t);
    cp_async_wait_all();
    return;
  }

  // the consumers
  if constexpr (G::PRODUCERS == 128) wg_setmaxnreg_inc<G::CREGS>();
  const int wg = warp_id >> 2, warp = warp_id & 3, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int i0 = bi * NT + 64 * wg;  // the warpgroup's first row of H
  const bool wg_on = i0 < D.d;       // the same in the whole warpgroup
  // the warp's rows of a: columns 16 warp + gid (+ 8) of the warpgroup's
  // 64 in the staged i-range (the j-range on the diagonal); rows past the
  // range (narrow: past 32) or past d are zero
  const bool a_on = wg_on && 16 * warp < NT && i0 + 16 * warp < D.d;
  const int aoff =
      a_on ? (diag ? 0 : IRLS_TN * G::LDR) + 64 * wg + 16 * warp + gid : 0;

  // x of staged tile t's j-range, each element split once into x_hi and
  // x_lo in split stage t % SS, once the products of tile t - SS are done,
  // by warpgroup t % WGS (the two of a block take turns, so they drift
  // apart); an item is (4-row group kg, column f): four rows of one
  // column, 16-byte stores
  auto split = [&](int t) {
    const int st = t % SS;
    if (t >= SS) mbar_wait(split_empty + st, (t / SS - 1) & 1);
    mbar_wait(raw_full + t % RS, (t / RS) & 1);
    const float* src = raw + (t % RS) * G::RAW;
    float* dst = sb + st * 2 * G::OPS;
#pragma unroll
    for (int i = 0; i < NT * KG / 128; ++i) {
      const int idx = (threadIdx.x & 127) + 128 * i;
      const int kg = idx / NT, f = idx - kg * NT;
      const float* col = src + 4 * kg * G::LDR + f;
      float xh[4], xl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) irls_split(col[j * G::LDR], xh[j], xl[j]);
      float* o = dst + wg_core_off(f, 4 * kg, KG);
      *reinterpret_cast<float4*>(o) = make_float4(xh[0], xh[1], xh[2], xh[3]);
      *reinterpret_cast<float4*>(o + G::OPS) =
          make_float4(xl[0], xl[1], xl[2], xl[3]);
    }
    fence_proxy_async();  // the stores become visible to wgmma
    mbar_arrive(split_full + st);
  };

  // k-step ks of a = w x as the A fragment (tc_common.cuh): a rounded to
  // float32, then split into a_hi and a_lo
  auto form = [&](const float* src, const float* wt, int ks,
                  uint32_t (&ah)[4], uint32_t (&al)[4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 8 * ks + tig + 4 * h;
      const float wk = wt[k];
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const float x = a_on ? src[k * G::LDR + 8 * v] : 0.f;
        tf32_split(__fmul_rn(wk, x), ah[2 * h + v], al[2 * h + v]);
      }
    }
  };

  // the warpgroup's 64 x NT tile as NH column halves of NS, each its own
  // chain of products, so the tensor cores have two independent chains
  // of a warpgroup to overlap (the same sums, entry by entry)
  constexpr int NS = NT > 64 ? 64 : NT, NH = NT / NS;
  float acc[NH][NS / 2], c[NH][NS / 2];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int e = 0; e < NS / 2; ++e) acc[h][e] = c[h][e] = 0.f;
  // x_hi and x_lo in split stage 0: cores 128 bytes apart along K, KG *
  // 128 along N (half h NS / 8 such rows, NS KG descriptor units, further);
  // stage i lies 2 i OPS floats (i OPS / 2 descriptor units) past it
  const uint64_t d_xh = wg_desc(sb, 128, KG * 128),
                 d_xl = wg_desc(sb + G::OPS, 128, KG * 128);

  if (ntiles > 0 && wg == 0) split(0);
  for (int t = 0; t < ntiles; ++t) {
    // c = a^T x over tile t's rows, three TF32 products a k-step, summed
    // from zero; c joins acc with round to nearest (the tensor cores round
    // their float32 sums toward zero, and a chain over a whole slice would
    // drift).  The small cross terms go first: each product's float32 sum
    // rounds toward zero, and with the large hi x hi products last only
    // their own KS sums round at the tile's full size (interleaved, all
    // 3 KS did: three times the bias).  A k-step is two cores along K
    // further: 256 bytes, 16 descriptor units.
    const int rst = t % RS, sst = t % SS;
    mbar_wait(split_full + sst, (t / SS) & 1);
    uint32_t ah[KS][4], al[KS][4];
    if (wg_on) {
      const float* src = raw + rst * G::RAW + aoff;
      const float* wt = ws + rst * IRLS_TN;
      const uint64_t o = (uint64_t)sst * (G::OPS / 2);
#pragma unroll
      for (int h = 0; h < NH; ++h) irls_fence_operand(c[h]);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        form(src, wt, ks, ah[ks], al[ks]);
        wg_fence();  // the fragment's registers are written
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          const uint64_t b = o + 16 * ks + h * NS * KG;
          wgmma_tf32_rs(c[h], al[ks], d_xh + b, ks > 0);
          wgmma_tf32_rs(c[h], ah[ks], d_xl + b, 1);
        }
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int h = 0; h < NH; ++h)
          wgmma_tf32_rs(c[h], ah[ks], d_xh + o + 16 * ks + h * NS * KG, 1);
      wg_commit();
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(raw_empty + rst);  // tile t is read
    if (t + 1 < ntiles && (t + 1) % G::WGS == wg)
      split(t + 1);  // beside the products of tile t
    if (wg_on) {
      wg_wait<0>();
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        irls_fence_operand(c[h]);
#pragma unroll
        for (int e = 0; e < NS / 2; ++e) acc[h][e] += c[h][e];
      }
      irls_fence_frag(ah);
      irls_fence_frag(al);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(split_empty + sst);  // its products are done
  }

  // the warpgroup's part of the packed upper half: (i, j), i <= j, at
  // i d - i (i - 1) / 2 + (j - i)
  if (!wg_on) return;
  const long long npk = (long long)D.d * (D.d + 1) / 2;
  float* Hb = Hp + (((long long)q * D.S + s) * D.NSLG + sl) * npk;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int e = 0; e < NS / 2; ++e) {
      const long long i = i0 + 16 * warp + gid + 8 * ((e >> 1) & 1);
      const long long j =
          (long long)bj * NT + NS * h + 8 * (e >> 2) + 2 * tig + (e & 1);
      if (i <= j && j < D.d)
        Hb[i * D.d - i * (i - 1) / 2 + (j - i)] = acc[h][e];
    }
}

// ------------------------------------------------------- 3. the reduce

#define IRLS_REDUCE_PARAMS                                                 \
  const float *__restrict__ Hp, const double *__restrict__ gp,             \
      const double *__restrict__ sp, float *__restrict__ H,                \
      double *__restrict__ g, double *__restrict__ stats, int QS, int d,   \
      int NSLG, int NSLR, int nstat
#define IRLS_REDUCE_ARGS Hp, gp, sp, H, g, stats, QS, d, NSLG, NSLR, nstat

// slice groups a packed entry of H is summed in: one where there are few
// slices (K5's), up to 8 of at least 8 slices each where there are many
// (K6's ~130), so the reduce keeps enough loads in flight either way
__host__ __device__ __forceinline__ int irls_reduce_groups(int NSLG) {
  return NSLG >= 64 ? 8 : NSLG >= 32 ? 4 : NSLG >= 16 ? 2 : 1;
}

// the reduce's blocks: IRLS_THREADS / groups packed upper-half entries of
// H each, then one thread per entry of every g (none where g == nullptr,
// K6) and per each of the first nstat statistics of every
// (configuration, institution)
static long long irls_reduce_blocks(int QS, int d, int NSLG, bool with_g,
                                    int nstat) {
  const long long per = IRLS_THREADS / irls_reduce_groups(NSLG);
  const long long nH = (long long)QS * ((long long)d * (d + 1) / 2);
  const long long rest = (long long)QS * ((with_g ? d : 0) + nstat);
  return (nH + per - 1) / per + (rest + IRLS_THREADS - 1) / IRLS_THREADS;
}

// The slices' partials summed in a fixed order.  A packed entry of H is
// summed by irls_reduce_groups threads, each over every groups-th slice,
// then across the threads in order, in float64 and rounded once to
// float32 (a sum over ~130 slices, K6's, adds no error of its own); it is
// written to (i, j) and (j, i).  g and the statistics take one thread an
// entry, the statistics written as (nstat, QS): K5's (4, Q, S) block and
// K3's dev (S,) alike.
__device__ __forceinline__ void irls_reduce(IRLS_REDUCE_PARAMS) {
  __shared__ double part[IRLS_THREADS];
  const int rg = irls_reduce_groups(NSLG), per = IRLS_THREADS / rg;
  const long long npk = (long long)d * (d + 1) / 2, nH = (long long)QS * npk;
  const long long hblocks = (nH + per - 1) / per;
  if (blockIdx.x < hblocks) {
    const int le = threadIdx.x % per, grp = threadIdx.x / per;
    const long long e = (long long)blockIdx.x * per + le;
    const long long qs = e / npk, k = e - qs * npk;
    double a = 0.0;
    if (e < nH)
      for (int sl = grp; sl < NSLG; sl += rg)
        a += Hp[(qs * NSLG + sl) * npk + k];
    part[threadIdx.x] = a;
    __syncthreads();
    if (grp != 0 || e >= nH) return;
    for (int r = 1; r < rg; ++r) a += part[r * per + le];
    // row i of packed entry k: i d - i (i - 1) / 2 <= k, from the root,
    // then corrected for rounding
    const double b = 2.0 * d + 1.0;
    long long i = (long long)((b - sqrt(b * b - 8.0 * (double)k)) / 2.0);
    auto start = [d](long long r) { return r * d - r * (r - 1) / 2; };
    while (i > 0 && start(i) > k) --i;
    while (i + 1 < d && start(i + 1) <= k) ++i;
    const long long j = i + (k - start(i));
    float* Hq = H + qs * d * d;
    Hq[i * d + j] = (float)a;
    Hq[j * d + i] = (float)a;
    return;
  }
  const long long e =
      (long long)(blockIdx.x - hblocks) * IRLS_THREADS + threadIdx.x;
  const long long ng = g ? (long long)QS * d : 0, ns = (long long)QS * nstat;
  if (e < ng) {
    const long long qs = e / d, k = e - qs * d;
    double a = 0.0;
    for (int sl = 0; sl < NSLR; ++sl) a += gp[(qs * NSLR + sl) * d + k];
    g[e] = a;
  } else if (e < ng + ns) {
    const long long e3 = e - ng, k = e3 / QS, qs = e3 - k * QS;
    double a = 0.0;
    for (int sl = 0; sl < NSLR; ++sl)
      a += sp[(qs * NSLR + sl) * IRLS_NSTAT + k];
    stats[e3] = a;
  }
}

// ------------------------------------------------- the host side

typedef void (*IrlsRowsFn)(IRLS_ROWS_PARAMS);
typedef void (*IrlsGramFn)(IRLS_GRAM_PARAMS);
typedef void (*IrlsReduceFn)(IRLS_REDUCE_PARAMS);

// one entry's instantiations of the three bodies
struct IrlsKernels {
  IrlsRowsFn rows[4];  // g m-tiles a warp: 2, 4, 8, 16
  IrlsGramFn gram[2];  // warpgroup tile columns: 32, 128
  IrlsReduceFn reduce;
};

// the rows kernel for the dimensions' g m-tiles a warp
static IrlsRowsFn irls_rows_fn(const IrlsKernels& k, const IrlsDims& D) {
  const int mtw = (D.d + 63) / 64;
  return k.rows[mtw <= 2 ? 0 : mtw <= 4 ? 1 : mtw <= 8 ? 2 : 3];
}

// the Gram kernel for the dimensions' tile columns
static IrlsGramFn irls_gram_fn(const IrlsKernels& k, const IrlsDims& D) {
  return k.gram[D.nt == 32 ? 0 : 1];
}

// The plan at dimension d, into out[5]: configurations a rows
// block, the rows kernel's tile rows, the Gram kernel's tile rows, the
// Gram blocks a configuration, and the Gram kernel's blocks an SM
static int irls_plan(const IrlsKernels& k, int d, int* out) {
  if (d < 1 || d > IRLS_MAX_DIM) return (int)cudaErrorInvalidValue;
  const IrlsDims D = irls_dims(d);
  const int tnr = irls_rows_tile(D);
  const int smem = (int)irls_gram_smem(D.nt);
  if (tnr < 0 || smem > IRLS_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const IrlsGramFn gram = irls_gram_fn(k, D);
  cudaError_t err = cudaFuncSetAttribute(
      gram, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gram, irls_gram_threads(D.nt), smem);
  out[0] = IRLS_CB;
  out[1] = tnr;
  out[2] = IRLS_TN;
  out[3] = D.units;
  out[4] = per_sm;
  return (int)err;
}

// The dimensions of one call; Xm and (where the rows kernel runs) X are
// the operands whose alignment picks the copies.
static IrlsDims irls_call_dims(int S, long long n_max, int d, int C,
                               int NSLR, int TNR, int NSLG, const double* X,
                               const float* Xm) {
  IrlsDims D = irls_dims(d);
  D.S = S;
  D.n_max = n_max;
  D.C = C;
  D.NSLR = NSLR;
  D.TNR = TNR;
  D.NSLG = NSLG;
  D.vec_x = (d % 2 == 0) && ((uintptr_t)X % 16 == 0);
  D.vec_m = (d % 4 == 0) && ((uintptr_t)Xm % 16 == 0);
  return D;
}

// Launch the rows kernel (where betas != nullptr; K6 gives the weights
// itself), the Gram and the reduce on one stream.  nstat statistics a
// (configuration, institution) go out, as (nstat, C x S).
static int irls_launch(const IrlsKernels& k, const IrlsDims& D,
                       const double* betas, const double* X, const float* Xm,
                       const double* y, const int* counts,
                       const int* fold_ids, const int* fold_of, float* H,
                       double* g, double* stats, int nstat, float* w,
                       float* Hp, double* gp, double* sp, void* stream) {
  const bool rows_too = betas != nullptr;
  if (D.S < 1 || D.d < 1 || D.d > IRLS_MAX_DIM || D.C < 1 || D.NSLG < 1 ||
      (rows_too && (D.NSLR < 1 || (D.TNR != 8 && D.TNR != 16 &&
                                   D.TNR != 32))))
    return (int)cudaErrorInvalidValue;
  const size_t smem_r = rows_too ? irls_rows_smem(D, D.TNR) : 0;
  const size_t smem_g = irls_gram_smem(D.nt);
  if (smem_r > IRLS_MAX_SMEM || smem_g > IRLS_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (rows_too) {
    const IrlsRowsFn rows = irls_rows_fn(k, D);
    err = cudaFuncSetAttribute(
        rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_r);
    if (err != cudaSuccess) return (int)err;
    dim3 grid_r((unsigned)((D.C + IRLS_CB - 1) / IRLS_CB), (unsigned)D.NSLR,
                (unsigned)D.S);
    rows<<<grid_r, IRLS_THREADS, smem_r, st>>>(betas, X, y, counts, fold_ids,
                                               fold_of, w, gp, sp, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const IrlsGramFn gram = irls_gram_fn(k, D);
  err = cudaFuncSetAttribute(gram, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_g);
  if (err != cudaSuccess) return (int)err;
  dim3 grid_g((unsigned)(D.C * D.units), (unsigned)D.NSLG, (unsigned)D.S);
  gram<<<grid_g, irls_gram_threads(D.nt), smem_g, st>>>(Xm, w, counts, Hp,
                                                        D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int QS = D.C * D.S;
  const unsigned blocks =
      (unsigned)irls_reduce_blocks(QS, D.d, D.NSLG, g != nullptr, nstat);
  const IrlsReduceFn reduce = k.reduce;
  reduce<<<blocks, IRLS_THREADS, 0, st>>>(Hp, gp, sp, H, g, stats, QS, D.d,
                                          D.NSLG, D.NSLR, nstat);
  return (int)cudaGetLastError();
}

// A source's IRLS instantiations (kernel_attributes.cuh), each at the
// largest d it serves: the rows kernel of m m-tiles a warp up to d = 64 m
// with irls_rows_tile's tile, the Gram of each tile width (its shared
// memory depends on the width alone), the reduce (no dynamic shared
// memory).  K6 has no rows kernel.  ``fam`` is "K3", "K5" or "K6".
static int irls_attributes(const IrlsKernels& k, const char* fam,
                           ReproKernelAttr* out, int* err) {
  char name[48];
  int i = 0;
  for (int r = 0; r < 4 && k.rows[r]; ++r, ++i) {
    const int mtw = 2 << r;
    const IrlsDims D = irls_dims(64 * mtw);
    snprintf(name, sizeof(name), "%s rows MTW%d", fam, mtw);
    REPRO_ATTR(i, name, k.rows[r], IRLS_THREADS,
               (int)irls_rows_smem(D, irls_rows_tile(D)));
  }
  for (int g = 0; g < 2; ++g, ++i) {
    const int nt = g ? 128 : 32;
    snprintf(name, sizeof(name), "%s gram N%d", fam, nt);
    REPRO_ATTR(i, name, k.gram[g], irls_gram_threads(nt),
               (int)irls_gram_smem(nt));
  }
  snprintf(name, sizeof(name), "%s reduce", fam);
  REPRO_ATTR(i, name, k.reduce, IRLS_THREADS, 0);
  return i + 1;
}
