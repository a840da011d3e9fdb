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
// 2. irls_gram, the Gram on Hopper's warpgroup products (wgmma, TF32
//    operands in shared memory, float32 sums); what bounds it is the
//    shared memory the split operands pass through (written once, read by
//    every product: ~240 KB a 32-row tile at d = 128) beside the three
//    TF32 products; the read of Xm (4 d bytes a row) is below both.  H is cut
//    into 64 x 64 blocks, of which only those on and above the diagonal
//    are computed (the reduce mirrors the result); a unit is three of
//    them, one per warpgroup of a 384-thread block (at d <= 128 the whole
//    upper half: (0, 0), (0, 1), (1, 1), three quarters of the full
//    product).  The grid is (Q x units, NSLG, S), the configuration the
//    fastest axis, so the blocks that read the same rows of Xm run side
//    by side and share them through L2.  A block streams its slice in
//    tiles of 32 rows through a two-stage cp.async ring (the unit's
//    64-column ranges of Xm and the rows' weights, zero-filled past the
//    slice and past d); all 384 threads split each staged element once
//    into the four K-major operands a_hi, a_lo, x_hi, x_lo (tc_common.cuh's
//    core layout, 16-byte stores); then each warpgroup issues twelve
//    m64n64k8 products (three a k-step, the cross terms first) on its
//    block and adds them to its sum, while the threads split the next
//    tile.
// 3. irls_reduce sums the per-slice partials (the upper half of each H,
//    packed, float32; g and the statistics in float64) in a fixed order,
//    H's in float64 rounded once, and mirrors H; it moves the partials
//    once, a few percent of the Gram.
//
// The launch plan.  irls_plan reports the configurations a rows block, the
// rows kernel's tile rows (the largest of 32, 16, 8 whose shared memory
// lets two blocks share an SM), the Gram's tile rows, the Gram units a
// configuration and the Gram blocks an SM; kernels/fused_irls.py picks
// the slice counts from it: about two rows blocks an SM, and the fewest
// Gram slices from one full wave whose waves are at least 95% full, no
// slice shorter than a tile.
#pragma once

#include "kernel_attributes.cuh"
#include "tc_common.cuh"

#define IRLS_THREADS 256     // the rows and reduce kernels
#define IRLS_WARPS (IRLS_THREADS / 32)
#define IRLS_CB 8            // configurations a rows block (the dmma's n)
#define IRLS_MAX_DIM 1024
#define IRLS_NSTAT 4         // dev_train, dev_val, correct_val, count_val
#define IRLS_QT 64           // H block edge: one warpgroup's 64 x 64
#define IRLS_WGS 3           // warpgroups (H blocks) a Gram block
#define IRLS_GTHREADS (128 * IRLS_WGS)
#define IRLS_RMAX 4          // column ranges a Gram unit stages, at most
#define IRLS_SCH 3           // 16-byte chunks a Gram thread stages a tile
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
  int nq;     // 64-column ranges of H (H blocks a side)
  int nb;     // H blocks on and above the diagonal
  int units;  // Gram units per configuration: IRLS_WGS blocks each
  int nreg;   // column ranges a unit stages, at most (2 or IRLS_RMAX)
  int vec_x;  // X rows start on 16 bytes: 16-byte copies
  int vec_m;  // Xm rows start on 16 bytes
};

static IrlsDims irls_dims(int d) {
  IrlsDims D = {};
  D.d = d;
  D.ldx = (d + 15) / 16 * 16 + 4;
  D.nq = (d + IRLS_QT - 1) / IRLS_QT;
  D.nb = D.nq * (D.nq + 1) / 2;
  D.units = (D.nb + IRLS_WGS - 1) / IRLS_WGS;
  D.nreg = D.nq <= 2 ? D.nq : IRLS_RMAX;
  return D;
}

static size_t irls_rows_smem(const IrlsDims& D, int TNR) {
  return sizeof(double) * ((size_t)2 * TNR * D.ldx + IRLS_CB * D.ldx +
                           64 * IRLS_CB + IRLS_CB * (TNR + 4) + 2 * TNR +
                           IRLS_THREADS * IRLS_NSTAT) +
         sizeof(int) * 2 * TNR;
}

// rows a staged tile of the Gram kernel: 32, or 16 where a unit stages
// four column ranges
static int irls_gram_rows(const IrlsDims& D) { return D.nreg > 2 ? 16 : 32; }

// two stages of the raw ranges and the weights; two buffers of each range
// split into four K-major operands (a_hi, a_lo, x_hi, x_lo)
static size_t irls_gram_smem(const IrlsDims& D) {
  const size_t tn = irls_gram_rows(D);
  return sizeof(float) * (2 * D.nreg * tn * IRLS_QT + 2 * tn +
                          2 * 4 * D.nreg * IRLS_QT * tn);
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

// H block b of the upper triangle, row by row: (qi, qj), qi <= qj
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

// the compiler keeps the accumulator's registers where the asm leaves
// them: no read or write of d moves across this point
__device__ __forceinline__ void irls_fence_operand(float (&d)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

#define IRLS_GRAM_PARAMS                                                \
  const float *__restrict__ Xm, const float *__restrict__ w,            \
      const int *__restrict__ counts, float *__restrict__ Hp, IrlsDims D
#define IRLS_GRAM_ARGS Xm, w, counts, Hp, D

// counts == nullptr: every institution's n_max rows are valid (K6)
template <int TN>
__device__ __forceinline__ void irls_gram(IRLS_GRAM_PARAMS) {
  constexpr int KG = TN / 4;
  constexpr int OPS = IRLS_QT * TN;  // floats of one split operand
  float* sp = (float*)irls_smem;     // 2 buffers of nreg x 4 operands
  float* raw = sp + 2 * 4 * D.nreg * OPS;  // 2 stages of nreg x TN x 64
  float* ws = raw + 2 * D.nreg * TN * IRLS_QT;  // 2 stages of TN weights
  const int buf = 4 * D.nreg * OPS;  // floats of one operand buffer

  const int q = blockIdx.x / D.units, u = blockIdx.x - q * D.units;
  const int sl = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, wq = (tid >> 5) & 3;  // warp in the warpgroup
  const int gid = lane >> 2, tig = lane & 3;

  // the unit's H blocks, one a warpgroup (a unit past the last block
  // repeats its first and stores nothing), and the distinct column ranges
  // they read
  int rq[IRLS_RMAX], nr = 0, ia = 0, ib = 0, qi = 0, qj = 0;
  bool mine = false;
  for (int g = 0; g < IRLS_WGS; ++g) {
    int bi, bj;
    const int b = IRLS_WGS * u + g;
    irls_block(b < D.nb ? b : IRLS_WGS * u, D.nq, bi, bj);
    int xa = 0, xb = 0;
    for (int pass = 0; pass < 2; ++pass) {
      const int v = pass ? bj : bi;
      int at = 0;
      while (at < nr && rq[at] != v) ++at;
      if (at == nr) rq[nr++] = v;
      (pass ? xb : xa) = at;
    }
    if (g == wg) {
      qi = bi, qj = bj, ia = xa, ib = xb;
      mine = b < D.nb;
    }
  }

  long long r_begin, r_end;
  irls_slice(counts ? counts[s] : (int)D.n_max, D.n_max, sl, D.NSLG,
             r_begin, r_end);
  const float* Xmb = Xm + (long long)s * D.n_max * D.d;
  const float* wb = w + ((long long)q * D.S + s) * D.n_max;
  const int ntiles = (int)((r_end - r_begin + TN - 1) / TN);

  // tile t's columns of the unit's ranges and its rows' weights, zero past
  // the slice and past d, into ring slot t % 2 (one commit group a call,
  // empty past the last tile).  With 16-byte rows (d % 4 == 0) a thread
  // copies at most IRLS_SCH chunks a tile, whose offsets are set here once.
  int soff[IRLS_SCH], goff[IRLS_SCH], srow[IRLS_SCH];
  bool sok[IRLS_SCH];
#pragma unroll
  for (int i = 0; i < IRLS_SCH; ++i) {
    const int ch = tid + IRLS_GTHREADS * i;
    const int r = ch / (TN * (IRLS_QT / 4)),
              rem = ch - r * (TN * (IRLS_QT / 4));
    const int row = rem / (IRLS_QT / 4), c = (rem - row * (IRLS_QT / 4)) * 4;
    const int col = (r < nr ? rq[r] : 0) * IRLS_QT + c;
    soff[i] = (r * TN + row) * IRLS_QT + c;
    goff[i] = row * D.d + col;
    srow[i] = row;
    sok[i] = r < nr && col < D.d;  // d % 4 == 0: a chunk is all in or out
  }
  auto stage = [&](int t) {
    if (t < ntiles) {
      const long long r0 = r_begin + (long long)t * TN;
      const int nrows = (int)min((long long)TN, r_end - r0);
      float* dst = raw + (t & 1) * D.nreg * TN * IRLS_QT;
      const float* src = Xmb + r0 * D.d;
      if (D.vec_m) {
#pragma unroll
        for (int i = 0; i < IRLS_SCH; ++i) {
          if (tid + IRLS_GTHREADS * i >= nr * TN * (IRLS_QT / 4)) break;
          const bool in = sok[i] && srow[i] < nrows;
          cp_async16(smem_u32(dst + soff[i]), in ? src + goff[i] : Xmb,
                     in ? 16 : 0);
        }
      } else {
        for (int idx = tid; idx < nr * TN * IRLS_QT; idx += IRLS_GTHREADS) {
          const int r = idx / (TN * IRLS_QT), rem = idx - r * (TN * IRLS_QT);
          const int row = rem / IRLS_QT, col = rq[r] * IRLS_QT + rem % IRLS_QT;
          const bool in = row < nrows && col < D.d;
          cp_async4(smem_u32(dst + idx), in ? src + row * D.d + col : Xmb,
                    in ? 4 : 0);
        }
      }
      if (tid < TN) {
        const bool in = tid < nrows;
        cp_async4(smem_u32(ws + (t & 1) * TN + tid), in ? wb + r0 + tid : wb,
                  in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // split each element of staged tile t once: a = w x and x, each as TF32
  // hi and lo, into operand buffer t % 2; an item is (range r, 4-row group
  // kg, column f): four rows of one column, 16-byte stores
  auto split = [&](int t) {
    const float* src = raw + (t & 1) * D.nreg * TN * IRLS_QT;
    const float* wt = ws + (t & 1) * TN;
    float* dst = sp + (t & 1) * buf;
    for (int idx = tid; idx < nr * IRLS_QT * KG; idx += IRLS_GTHREADS) {
      const int r = idx / (IRLS_QT * KG), rem = idx - r * (IRLS_QT * KG);
      const int kg = rem / IRLS_QT, f = rem - kg * IRLS_QT;
      const float* col = src + r * TN * IRLS_QT + 4 * kg * IRLS_QT + f;
      const float4 w4 = *reinterpret_cast<const float4*>(wt + 4 * kg);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
      float ah[4], al[4], xh[4], xl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = col[j * IRLS_QT];
        irls_split(wv[j] * x, ah[j], al[j]);
        irls_split(x, xh[j], xl[j]);
      }
      float* o = dst + 4 * r * OPS + wg_core_off(f, 4 * kg, KG);
      *reinterpret_cast<float4*>(o) = make_float4(ah[0], ah[1], ah[2], ah[3]);
      *reinterpret_cast<float4*>(o + OPS) =
          make_float4(al[0], al[1], al[2], al[3]);
      *reinterpret_cast<float4*>(o + 2 * OPS) =
          make_float4(xh[0], xh[1], xh[2], xh[3]);
      *reinterpret_cast<float4*>(o + 3 * OPS) =
          make_float4(xl[0], xl[1], xl[2], xl[3]);
    }
    fence_proxy_async();  // the stores become visible to wgmma
  };

  float acc[32], c[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = c[e] = 0.f;
  // the warpgroup's operand descriptors in each buffer: a = w x of range
  // ia, x of range ib; cores 128 bytes apart along K, KG * 128 along rows
  // (buffer 1 lies buf floats, buf / 4 descriptor units, past buffer 0)
  const uint64_t d_ah = wg_desc(sp + (4 * ia + 0) * OPS, 128, KG * 128),
                 d_al = wg_desc(sp + (4 * ia + 1) * OPS, 128, KG * 128),
                 d_xh = wg_desc(sp + (4 * ib + 2) * OPS, 128, KG * 128),
                 d_xl = wg_desc(sp + (4 * ib + 3) * OPS, 128, KG * 128);

  // the pipeline: tile t's products run on the tensor cores while the
  // threads split tile t + 1 and the copies of tile t + 2 are in flight
  stage(0);
  stage(1);
  cp_async_wait<1>();  // tile 0 has landed
  __syncthreads();
  split(0);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    stage(t + 2);  // into ring slot t % 2, which split(t) has read

    // c = a^T x over tile t's rows, three TF32 products a k-step, summed
    // from zero; c joins acc with round to nearest (the tensor cores round
    // their float32 sums toward zero, and a chain over a whole slice would
    // drift)
    const uint64_t bsel = (t & 1) * (uint64_t)(buf / 4);
    irls_fence_operand(c);
    wg_fence();
    // The small cross terms go first: each product's float32 sum rounds
    // toward zero, and with the large hi x hi products last only their
    // own TN / 8 sums round at the tile's full size (interleaved, all
    // 3 TN / 8 did: three times the bias).  A k-step is two cores along K
    // further: 256 bytes, 16 descriptor units.
#pragma unroll
    for (int ks = 0; ks < TN / 8; ++ks) {
      const uint64_t o = bsel + 16 * ks;
      wgmma_tf32_64x64(c, d_al + o, d_xh + o, ks > 0);
      wgmma_tf32_64x64(c, d_ah + o, d_xl + o, 1);
    }
#pragma unroll
    for (int ks = 0; ks < TN / 8; ++ks)
      wgmma_tf32_64x64(c, d_ah + bsel + 16 * ks, d_xh + bsel + 16 * ks, 1);
    wg_commit();
    if (t + 1 < ntiles) {
      cp_async_wait<1>();  // tile t + 1 has landed
      __syncthreads();
      split(t + 1);  // into the other operand buffer, which no product reads
    }
    wg_wait<0>();
    irls_fence_operand(c);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += c[e];
    __syncthreads();  // buffer (t + 1) % 2 is complete; t % 2 is free
  }

  // the block's part of the packed upper half: (i, j), i <= j, at
  // i d - i (i - 1) / 2 + (j - i)
  if (!mine) return;
  const long long npk = (long long)D.d * (D.d + 1) / 2;
  float* Hb = Hp + (((long long)q * D.S + s) * D.NSLG + sl) * npk;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const long long i = qi * IRLS_QT + 16 * wq + gid + 8 * ((e >> 1) & 1);
    const long long j = qj * IRLS_QT + 8 * (e >> 2) + 2 * tig + (e & 1);
    if (i <= j && j < D.d) Hb[i * D.d - i * (i - 1) / 2 + (j - i)] = acc[e];
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
  IrlsGramFn gram[2];  // tile rows: 32, 16
  IrlsReduceFn reduce;
};

// the rows kernel for the dimensions' g m-tiles a warp
static IrlsRowsFn irls_rows_fn(const IrlsKernels& k, const IrlsDims& D) {
  const int mtw = (D.d + 63) / 64;
  return k.rows[mtw <= 2 ? 0 : mtw <= 4 ? 1 : mtw <= 8 ? 2 : 3];
}

// the Gram kernel for the dimensions' tile rows
static IrlsGramFn irls_gram_fn(const IrlsKernels& k, const IrlsDims& D) {
  return k.gram[irls_gram_rows(D) == 32 ? 0 : 1];
}

// The plan at dimension d, into out[5]: configurations a rows
// block, the rows kernel's tile rows, the Gram kernel's tile rows, the
// Gram units a configuration, and the Gram kernel's blocks an SM
static int irls_plan(const IrlsKernels& k, int d, int* out) {
  if (d < 1 || d > IRLS_MAX_DIM) return (int)cudaErrorInvalidValue;
  const IrlsDims D = irls_dims(d);
  const int tnr = irls_rows_tile(D);
  const int smem = (int)irls_gram_smem(D);
  if (tnr < 0 || smem > IRLS_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const IrlsGramFn gram = irls_gram_fn(k, D);
  cudaError_t err = cudaFuncSetAttribute(
      gram, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gram,
                                                      IRLS_GTHREADS, smem);
  out[0] = IRLS_CB;
  out[1] = tnr;
  out[2] = irls_gram_rows(D);
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
  const size_t smem_g = irls_gram_smem(D);
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
  gram<<<grid_g, IRLS_GTHREADS, smem_g, st>>>(Xm, w, counts, Hp, D);
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
// with irls_rows_tile's tile, the 32-row Gram up to d = 128 and the
// 16-row one past it, the reduce (no dynamic shared memory).  K6 has no
// rows kernel.  ``fam`` is "K3", "K5" or "K6".
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
  snprintf(name, sizeof(name), "%s gram TN32", fam);
  REPRO_ATTR(i, name, k.gram[0], IRLS_GTHREADS,
             (int)irls_gram_smem(irls_dims(2 * IRLS_QT)));
  ++i;
  snprintf(name, sizeof(name), "%s gram TN16", fam);
  REPRO_ATTR(i, name, k.gram[1], IRLS_GTHREADS,
             (int)irls_gram_smem(irls_dims(IRLS_MAX_DIM)));
  ++i;
  snprintf(name, sizeof(name), "%s reduce", fam);
  REPRO_ATTR(i, name, k.reduce, IRLS_THREADS, 0);
  return i + 1;
}
