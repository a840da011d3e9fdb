// K5: cross-validated IRLS summaries for every (configuration, institution)
// pair in one call.
//
// Replaces the JAX package's kernels/fused_irls.py::fused_irls_cv_pallas
// (_irls_cv_kernel).  Configuration q carries its own iterate betas[q] and
// held-out fold fold_of[q] (-1: none, a full-data fit).  For institution s
// with counts[s] valid rows, row r is
//
//   valid = r < counts[s],  hold = valid && fold_ids[s, r] == fold_of[q],
//   train = valid && !hold
//
// (the row mask comes first: padding rows carry fold id -1, which equals a
// refit's fold_of; this kernel never reads a row past counts[s]), and
//
//   H[q, s]           = Xm^T diag(w * train) Xm   float32 sums, 3xTF32
//   g[q, s]           = X^T ((y - p) * train)     float64
//   dev_train/dev_val = -2 sum(y z - softplus z) over train / hold rows
//   correct_val       = #hold rows with (z > 0) == (y > 0.5)  (z = 0 is 0)
//   count_val         = #hold rows
//
// with z = X betas[q], p = sigmoid(z), w = p (1 - p), all in float64 but
// the Gram.  That is the JAX fused_irls_cv_sim contract, the same as K3's,
// with the Gram's products taken on the tensor cores: a = (w Xm) rounded
// to float32 as the plain version rounds it, each of a and Xm split into
// two TF32 terms, x = hi + lo with hi = rna(x) and lo = rna(x - hi), and
// H = a_lo^T x_hi + a_hi^T x_lo + a_hi^T x_hi.  The dropped a_lo x_lo term
// and the split's rounding are ~2^-21 of each product.  The tensor cores
// round their float32 sums toward zero, and a chain of such sums over a
// slice of a few thousand rows drifts past the float32 tolerance: so each
// staged tile's products (32 rows) start from zero and are added to the
// running sum in float32 with round to nearest.
//
// What bounds it on the H100: bytes.  One read of X, Xm, y and the fold
// ids is 0.093 ms at the λ path's shape (Q = 5, N = 2e5, d = 128); the
// symmetric Grams as three TF32 products take 0.080 ms at the dense TF32
// peak, the float64 z, g and deviance terms 0.014 ms at the CUDA cores'
// float64 peak.
//
// Three launches, all summed in a fixed order, no float atomics:
//
// 1. irls_cv_rows_kernel, the float64 work: grid (chunks of 8
//    configurations, NSLR row slices, S).  A block reads its rows of X
//    once for its 8 configurations (every configuration of the λ path), in
//    tiles of TNR rows through a two-stage cp.async ring.  z = X betas^T
//    and g += X^T r run on the float64 tensor cores (mma.sync m8n8k4, the
//    8 configurations its n; float64 products and sums, in a fixed order);
//    between them one thread per (configuration, row) computes p, the train
//    weight (written to w, float32, for launch 2), the residual and the
//    held-out statistics, all TNR x 8 epilogues side by side.
// 2. irls_cv_gram_kernel, the Gram on Hopper's warpgroup products (wgmma,
//    TF32 operands in shared memory, float32 sums): H is cut into 64 x 64
//    blocks, of which only those on and above the diagonal are computed
//    (the reduce mirrors the result); a unit is three of them, one per
//    warpgroup of a 384-thread block (at d <= 128 the whole upper half:
//    (0, 0), (0, 1), (1, 1), three quarters of the full product).  The
//    grid is (Q x units, NSLG, S), the configuration the fastest axis, so
//    the blocks that read the same rows of Xm run side by side and share
//    them through L2.  A block streams its slice in tiles of 32 rows
//    through a two-stage cp.async ring (the unit's 64-column ranges of Xm
//    and the rows' weights, zero-filled past the slice and past d); all
//    384 threads split each staged element once into the four K-major
//    operands a_hi, a_lo, x_hi, x_lo (tc_common.cuh's core layout, 16-byte
//    stores); then each warpgroup issues twelve m64n64k8 products (three a
//    k-step) on its block and adds them to its sum.
// 3. irls_cv_reduce_kernel sums the per-slice partials (the upper half of
//    each H, packed, float32; g and the statistics in float64) in slice
//    order and mirrors H.
//
// The wrapper (kernels/fused_irls.py::cv_launch_shape) asks repro_k5_plan
// for the configurations a rows block, the rows kernel's tile rows, the
// Gram units and the Gram kernel's blocks an SM, then picks the slice
// counts.
#include "tc_common.cuh"

#define K5_THREADS 256       // the rows and reduce kernels
#define K5_WARPS (K5_THREADS / 32)
#define K5_CB 8              // configurations a rows block (the dmma's n)
#define K5_MAX_DIM 1024
#define K5_NSTAT 4           // dev_train, dev_val, correct_val, count_val
#define K5_QT 64             // H block edge: one warpgroup's 64 x 64
#define K5_WGS 3             // warpgroups (H blocks) a Gram block
#define K5_GTHREADS (128 * K5_WGS)
#define K5_RMAX 4            // column ranges a Gram unit stages, at most
#define K5_SCH 3             // 16-byte chunks a Gram thread stages a tile
#define K5_TWO_PER_SM (113 * 1024)  // shared memory for two blocks an SM
#define K5_MAX_SMEM (227 * 1024)

struct K5Dims {
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
  int units;  // Gram units per configuration: K5_WGS blocks each
  int nreg;   // column ranges a unit stages, at most (2 or K5_RMAX)
  int vec_x;  // X rows start on 16 bytes: 16-byte copies
  int vec_m;  // Xm rows start on 16 bytes
};

static K5Dims k5_dims(int d) {
  K5Dims D = {};
  D.d = d;
  D.ldx = (d + 15) / 16 * 16 + 4;
  D.nq = (d + K5_QT - 1) / K5_QT;
  D.nb = D.nq * (D.nq + 1) / 2;
  D.units = (D.nb + K5_WGS - 1) / K5_WGS;
  D.nreg = D.nq <= 2 ? D.nq : K5_RMAX;
  return D;
}

static size_t k5_rows_smem(const K5Dims& D, int TNR) {
  return sizeof(double) * ((size_t)2 * TNR * D.ldx + K5_CB * D.ldx +
                           64 * K5_CB + K5_CB * (TNR + 4) + 2 * TNR +
                           K5_THREADS * K5_NSTAT) +
         sizeof(int) * 2 * TNR;
}

// rows a staged tile of the Gram kernel: 32, or 16 where a unit stages
// four column ranges
static int k5_gram_rows(const K5Dims& D) { return D.nreg > 2 ? 16 : 32; }

// two stages of the raw ranges and the weights; two buffers of each range
// split into four K-major operands (a_hi, a_lo, x_hi, x_lo)
static size_t k5_gram_smem(const K5Dims& D) {
  const size_t tn = k5_gram_rows(D);
  return sizeof(float) * (2 * D.nreg * tn * K5_QT + 2 * tn +
                          2 * 4 * D.nreg * K5_QT * tn);
}


// rows [r_begin, r_end) of slice sl of nsl over an institution's count
// valid rows, the count clamped to n_max (an int clamp, as K3's)
__device__ __forceinline__ void k5_slice(int cnt, long long n_max, int sl,
                                         int nsl, long long& r_begin,
                                         long long& r_end) {
  if ((long long)cnt > n_max) cnt = (int)n_max;
  const long long count = cnt;
  const long long chunk = (count + nsl - 1) / nsl;
  r_begin = min(count, (long long)sl * chunk);
  r_end = min(count, r_begin + chunk);
}

// ------------------------------------------------- 1. the float64 rows

// X rows [r0, r0 + TNR) (zero past nrows), their y and fold ids, into one
// ring slot
__device__ __forceinline__ void k5_stage_rows(double* Xs, double* ys, int* fs,
                                              const double* Xb,
                                              const double* yb, const int* fb,
                                              long long r0, int nrows,
                                              const K5Dims& D) {
  const int tid = threadIdx.x;
  if (D.vec_x) {
    const int ch = D.d / 2;  // 16-byte chunks a row (d even)
    for (int idx = tid; idx < D.TNR * ch; idx += K5_THREADS) {
      const int r = idx / ch, c = (idx - r * ch) * 2;
      const bool in = r < nrows;
      cp_async16(smem_u32(Xs + r * D.ldx + c),
                 in ? Xb + (r0 + r) * D.d + c : Xb, in ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < D.TNR * D.d; idx += K5_THREADS) {
      const int r = idx / D.d, c = idx - r * D.d;
      const bool in = r < nrows;
      cp_async8(smem_u32(Xs + r * D.ldx + c),
                in ? Xb + (r0 + r) * D.d + c : Xb, in ? 8 : 0);
    }
  }
  if (tid < D.TNR) {
    const bool in = tid < nrows;
    cp_async8(smem_u32(ys + tid), in ? yb + r0 + tid : yb, in ? 8 : 0);
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

// MTW: 8-column m-tiles of g each warp owns (ceil(d / 64) rounded up to a
// power of two)
template <int MTW>
__global__ void __launch_bounds__(K5_THREADS, 2)
irls_cv_rows_kernel(const double* __restrict__ betas,
                    const double* __restrict__ X,
                    const double* __restrict__ y,
                    const int* __restrict__ counts,
                    const int* __restrict__ fold_ids,
                    const int* __restrict__ fold_of, float* __restrict__ w,
                    double* __restrict__ gp, double* __restrict__ sp,
                    K5Dims D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TN = D.TNR, RS = TN + 4;
  const int MT = TN / 8, KS = K5_WARPS / MT;  // z: m-tiles, K splits
  double* Xs = (double*)smem;             // 2 stages of TN x ldx
  double* bs = Xs + 2 * TN * D.ldx;       // K5_CB x ldx
  double* zp = bs + K5_CB * D.ldx;        // KS x K5_CB x TN partial z
  double* rs = zp + KS * K5_CB * TN;      // K5_CB x RS train residuals
  double* ys = rs + K5_CB * RS;           // 2 stages of TN
  double* red = ys + 2 * TN;              // K5_THREADS x K5_NSTAT
  int* fs = (int*)(red + K5_THREADS * K5_NSTAT);  // 2 stages of TN

  const int c0 = blockIdx.x * K5_CB;
  const int nc = min(K5_CB, D.C - c0);  // configurations of this block
  const int sl = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  long long r_begin, r_end;
  k5_slice(counts[s], D.n_max, sl, D.NSLR, r_begin, r_end);
  const double* Xb = X + (long long)s * D.n_max * D.d;
  const double* yb = y + (long long)s * D.n_max;
  const int* fb = fold_ids + (long long)s * D.n_max;

  // betas (zero past the block's configurations and past d), the X pads
  // past d (never copied), the residuals
  for (int i = tid; i < K5_CB * D.ldx; i += K5_THREADS) {
    const int c = i / D.ldx, k = i - c * D.ldx;
    bs[i] = c < nc && k < D.d ? betas[(long long)(c0 + c) * D.d + k] : 0.0;
  }
  for (int i = tid; i < 2 * TN * D.ldx; i += K5_THREADS)
    if (i % D.ldx >= D.d) Xs[i] = 0.0;
  for (int i = tid; i < K5_CB * RS; i += K5_THREADS) rs[i] = 0.0;

  // the epilogue's thread (configuration ce, row re)
  const int ce = tid / TN, re = tid - ce * TN;
  const bool epi = ce < nc;
  const int fold = epi ? fold_of[c0 + ce] : 0;
  float* wq = w + ((long long)(c0 + (epi ? ce : 0)) * D.S + s) * D.n_max;
  // z: warp (m-tile zm of the tile's rows, K split zk); g: m-tiles warp +
  // 8 i of the columns, for configurations 2 tig and 2 tig + 1
  const int zm = warp % MT, zk = warp / MT;
  const int ksteps = (D.d + 3) / 4;
  double gacc[MTW][2];
#pragma unroll
  for (int i = 0; i < MTW; ++i) gacc[i][0] = gacc[i][1] = 0.0;
  double st[K5_NSTAT] = {0.0, 0.0, 0.0, 0.0};

  const int ntiles = (int)((r_end - r_begin + TN - 1) / TN);
  __syncthreads();
  if (ntiles > 0)
    k5_stage_rows(Xs, ys, fs, Xb, yb, fb, r_begin,
                  (int)min((long long)TN, r_end - r_begin), D);
  cp_async_commit();

  for (int it = 0; it < ntiles; ++it) {
    const int slot = it & 1;
    const long long r0 = r_begin + (long long)it * TN;
    const int nrows = (int)min((long long)TN, r_end - r0);
    if (it + 1 < ntiles) {
      const long long r1 = r0 + TN;
      k5_stage_rows(Xs + (slot ^ 1) * TN * D.ldx, ys + (slot ^ 1) * TN,
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
      double* o = zp + (zk * K5_CB + 2 * tig) * TN + 8 * zm + gid;
      o[0] = zc[0];
      o[TN] = zc[1];
    }
    __syncthreads();  // the partial z are complete

    // p, the weight, the residual and the statistics of (ce, re)
    if (epi) {
      double resid = 0.0;
      if (re < nrows) {  // a valid row: r0 + re < counts[s]
        double z = 0.0;
        for (int k = 0; k < KS; ++k) z += zp[(k * K5_CB + ce) * TN + re];
        const double e = exp(-fabs(z));
        const double p = z >= 0.0 ? 1.0 / (1.0 + e) : e / (1.0 + e);
        const double yr = ys[slot * TN + re];
        const double ll = yr * z - (fmax(z, 0.0) + log1p(e));
        float w32 = 0.f;
        if (fs[slot * TN + re] == fold) {  // held out
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
      const int mt = warp + K5_WARPS * i;
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
    const int col = 8 * (warp + K5_WARPS * i) + gid;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * tig + h;
      if (col < D.d && c < nc)
        gp[(((long long)(c0 + c) * D.S + s) * D.NSLR + sl) * D.d + col] =
            gacc[i][h];
    }
  }
#pragma unroll
  for (int k = 0; k < K5_NSTAT; ++k) red[tid * K5_NSTAT + k] = st[k];
  __syncthreads();
  if (tid < nc * K5_NSTAT) {
    const int c = tid / K5_NSTAT, k = tid - c * K5_NSTAT;
    double tot = 0.0;
    for (int r = 0; r < TN; ++r) tot += red[(c * TN + r) * K5_NSTAT + k];
    // the deviances carry the -2; the counts go out as they are
    sp[(((long long)(c0 + c) * D.S + s) * D.NSLR + sl) * K5_NSTAT + k] =
        k < 2 ? -2.0 * tot : tot;
  }
}

// ------------------------------------------ 2. the Gram, tensor cores

// H block b of the upper triangle, row by row: (qi, qj), qi <= qj
__device__ __forceinline__ void k5_block(int b, int nq, int& qi, int& qj) {
  for (qi = 0; b >= nq - qi; ++qi) b -= nq - qi;
  qj = qi + b;
}

// x as hi + lo, two TF32 terms as floats
__device__ __forceinline__ void k5_split(float x, float& hi, float& lo) {
  uint32_t h, l;
  tf32_split(x, h, l);
  hi = __uint_as_float(h);
  lo = __uint_as_float(l);
}

// the compiler keeps the accumulator's registers where the asm leaves
// them: no read or write of d moves across this point
__device__ __forceinline__ void k5_fence_operand(float (&d)[32]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

template <int TN>
__global__ void __launch_bounds__(K5_GTHREADS, 1)
irls_cv_gram_kernel(const float* __restrict__ Xm, const float* __restrict__ w,
                    const int* __restrict__ counts, float* __restrict__ Hp,
                    K5Dims D) {
  constexpr int KG = TN / 4;
  constexpr int OPS = K5_QT * TN;  // floats of one split operand
  extern __shared__ __align__(128) float smf[];
  float* sp = smf;                         // 2 buffers of nreg x 4 operands
  float* raw = sp + 2 * 4 * D.nreg * OPS;  // 2 stages of nreg x TN x 64
  float* ws = raw + 2 * D.nreg * TN * K5_QT;  // 2 stages of TN weights
  const int buf = 4 * D.nreg * OPS;        // floats of one operand buffer

  const int q = blockIdx.x / D.units, u = blockIdx.x - q * D.units;
  const int sl = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int lane = tid & 31, wq = (tid >> 5) & 3;  // warp in the warpgroup
  const int gid = lane >> 2, tig = lane & 3;

  // the unit's H blocks, one a warpgroup (a unit past the last block
  // repeats its first and stores nothing), and the distinct column ranges
  // they read
  int rq[K5_RMAX], nr = 0, ia = 0, ib = 0, qi = 0, qj = 0;
  bool mine = false;
  for (int g = 0; g < K5_WGS; ++g) {
    int bi, bj;
    const int b = K5_WGS * u + g;
    k5_block(b < D.nb ? b : K5_WGS * u, D.nq, bi, bj);
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
  k5_slice(counts[s], D.n_max, sl, D.NSLG, r_begin, r_end);
  const float* Xmb = Xm + (long long)s * D.n_max * D.d;
  const float* wb = w + ((long long)q * D.S + s) * D.n_max;
  const int ntiles = (int)((r_end - r_begin + TN - 1) / TN);

  // tile t's columns of the unit's ranges and its rows' weights, zero past
  // the slice and past d, into ring slot t % 2 (one commit group a call,
  // empty past the last tile).  With 16-byte rows (d % 4 == 0) a thread
  // copies at most K5_SCH chunks a tile, whose offsets are set here once.
  int soff[K5_SCH], goff[K5_SCH], srow[K5_SCH];
  bool sok[K5_SCH];
#pragma unroll
  for (int i = 0; i < K5_SCH; ++i) {
    const int ch = tid + K5_GTHREADS * i;
    const int r = ch / (TN * (K5_QT / 4)), rem = ch - r * (TN * (K5_QT / 4));
    const int row = rem / (K5_QT / 4), c = (rem - row * (K5_QT / 4)) * 4;
    const int col = (r < nr ? rq[r] : 0) * K5_QT + c;
    soff[i] = (r * TN + row) * K5_QT + c;
    goff[i] = row * D.d + col;
    srow[i] = row;
    sok[i] = r < nr && col < D.d;  // d % 4 == 0: a chunk is all in or out
  }
  auto stage = [&](int t) {
    if (t < ntiles) {
      const long long r0 = r_begin + (long long)t * TN;
      const int nrows = (int)min((long long)TN, r_end - r0);
      float* dst = raw + (t & 1) * D.nreg * TN * K5_QT;
      const float* src = Xmb + r0 * D.d;
      if (D.vec_m) {
#pragma unroll
        for (int i = 0; i < K5_SCH; ++i) {
          if (tid + K5_GTHREADS * i >= nr * TN * (K5_QT / 4)) break;
          const bool in = sok[i] && srow[i] < nrows;
          cp_async16(smem_u32(dst + soff[i]), in ? src + goff[i] : Xmb,
                     in ? 16 : 0);
        }
      } else {
        for (int idx = tid; idx < nr * TN * K5_QT; idx += K5_GTHREADS) {
          const int r = idx / (TN * K5_QT), rem = idx - r * (TN * K5_QT);
          const int row = rem / K5_QT, col = rq[r] * K5_QT + rem % K5_QT;
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
  // hi and lo, into operand buffer t % 2; four rows (k) of one column (f)
  // a thread, 16-byte stores
  // split each element of staged tile t once: a = w x and x, each as TF32
  // hi and lo, into operand buffer t % 2; an item is (range r, 4-row group
  // kg, column f): four rows of one column, 16-byte stores
  auto split = [&](int t) {
    const float* src = raw + (t & 1) * D.nreg * TN * K5_QT;
    const float* wt = ws + (t & 1) * TN;
    float* dst = sp + (t & 1) * buf;
    for (int idx = tid; idx < nr * K5_QT * KG; idx += K5_GTHREADS) {
      const int r = idx / (K5_QT * KG), rem = idx - r * (K5_QT * KG);
      const int kg = rem / K5_QT, f = rem - kg * K5_QT;
      const float* col = src + r * TN * K5_QT + 4 * kg * K5_QT + f;
      const float4 w4 = *reinterpret_cast<const float4*>(wt + 4 * kg);
      const float wv[4] = {w4.x, w4.y, w4.z, w4.w};
      float ah[4], al[4], xh[4], xl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = col[j * K5_QT];
        k5_split(wv[j] * x, ah[j], al[j]);
        k5_split(x, xh[j], xl[j]);
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
    k5_fence_operand(c);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < TN / 8; ++ks) {
      // a k-step is two cores along K further: 256 bytes, 16 descriptor
      // units
      const uint64_t o = bsel + 16 * ks;
      wgmma_tf32_64x64(c, d_al + o, d_xh + o, ks > 0);
      wgmma_tf32_64x64(c, d_ah + o, d_xl + o, 1);
      wgmma_tf32_64x64(c, d_ah + o, d_xh + o, 1);
    }
    wg_commit();
    if (t + 1 < ntiles) {
      cp_async_wait<1>();  // tile t + 1 has landed
      __syncthreads();
      split(t + 1);  // into the other operand buffer, which no product reads
    }
    wg_wait<0>();
    k5_fence_operand(c);
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
    const long long i = qi * K5_QT + 16 * wq + gid + 8 * ((e >> 1) & 1);
    const long long j = qj * K5_QT + 8 * (e >> 2) + 2 * tig + (e & 1);
    if (i <= j && j < D.d) Hb[i * D.d - i * (i - 1) / 2 + (j - i)] = acc[e];
  }
}

// ------------------------------------------------------- 3. the reduce

// One thread per packed upper-half entry of H (read in order, written to
// (i, j) and (j, i)), per entry of g and per statistic.  stats is (4, Q,
// S): dev_train, dev_val, correct_val, count_val.
__global__ void __launch_bounds__(K5_THREADS)
irls_cv_reduce_kernel(const float* __restrict__ Hp,
                      const double* __restrict__ gp,
                      const double* __restrict__ sp, float* __restrict__ H,
                      double* __restrict__ g, double* __restrict__ stats,
                      int QS, int d, int NSLG, int NSLR) {
  const long long e = (long long)blockIdx.x * K5_THREADS + threadIdx.x;
  const long long npk = (long long)d * (d + 1) / 2, nH = (long long)QS * npk;
  const long long ng = (long long)QS * d, ns = (long long)QS * K5_NSTAT;
  if (e < nH) {
    const long long qs = e / npk, k = e - qs * npk;
    // row i of packed entry k: i d - i (i - 1) / 2 <= k, from the root,
    // then corrected for rounding
    const double b = 2.0 * d + 1.0;
    long long i = (long long)((b - sqrt(b * b - 8.0 * (double)k)) / 2.0);
    auto start = [d](long long r) { return r * d - r * (r - 1) / 2; };
    while (i > 0 && start(i) > k) --i;
    while (i + 1 < d && start(i + 1) <= k) ++i;
    const long long j = i + (k - start(i));
    float a = 0.f;
    for (int sl = 0; sl < NSLG; ++sl) a += Hp[(qs * NSLG + sl) * npk + k];
    float* Hq = H + qs * d * d;
    Hq[i * d + j] = a;
    Hq[j * d + i] = a;
  } else if (e < nH + ng) {
    const long long e2 = e - nH, qs = e2 / d, k = e2 - qs * d;
    double a = 0.0;
    for (int sl = 0; sl < NSLR; ++sl) a += gp[(qs * NSLR + sl) * d + k];
    g[e2] = a;
  } else if (e < nH + ng + ns) {
    const long long e3 = e - nH - ng, k = e3 / QS, qs = e3 - k * QS;
    double a = 0.0;
    for (int sl = 0; sl < NSLR; ++sl)
      a += sp[(qs * NSLR + sl) * K5_NSTAT + k];
    stats[e3] = a;
  }
}

// the rows kernel for the dimensions' g m-tiles a warp
static void (*k5_rows_fn(const K5Dims& D))(const double*, const double*,
                                           const double*, const int*,
                                           const int*, const int*, float*,
                                           double*, double*, K5Dims) {
  const int mtw = (D.d + 63) / 64;
  return mtw <= 2   ? irls_cv_rows_kernel<2>
         : mtw <= 4 ? irls_cv_rows_kernel<4>
         : mtw <= 8 ? irls_cv_rows_kernel<8>
                    : irls_cv_rows_kernel<16>;
}

// the Gram kernel for the dimensions' tile rows
static void (*k5_gram_fn(const K5Dims& D))(const float*, const float*,
                                           const int*, float*, K5Dims) {
  return k5_gram_rows(D) == 32 ? irls_cv_gram_kernel<32>
                               : irls_cv_gram_kernel<16>;
}

// the largest of 32, 16, 8 rows whose rows-kernel shared memory lets two
// blocks share an SM, else 8 (one block)
static int k5_rows_tile(const K5Dims& D) {
  for (int tn = 32; tn >= 8; tn /= 2)
    if (k5_rows_smem(D, tn) <= K5_TWO_PER_SM) return tn;
  return k5_rows_smem(D, 8) <= K5_MAX_SMEM ? 8 : -1;
}

// A K5 plan at dimension d: configurations a rows block, the rows
// kernel's tile rows, the Gram units a configuration, and the Gram
// kernel's blocks an SM
extern "C" int repro_k5_plan(int d, int* cb, int* tn_rows, int* units,
                             int* gram_blocks_per_sm) {
  if (d < 1 || d > K5_MAX_DIM) return (int)cudaErrorInvalidValue;
  const K5Dims D = k5_dims(d);
  const int tnr = k5_rows_tile(D);
  const int smem = (int)k5_gram_smem(D);
  if (tnr < 0 || smem > K5_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const auto gram = k5_gram_fn(D);
  cudaError_t err = cudaFuncSetAttribute(
      gram, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      gram_blocks_per_sm, gram, K5_GTHREADS, smem);
  *cb = K5_CB;
  *tn_rows = tnr;
  *units = D.units;
  return (int)err;
}

extern "C" int repro_k5_fused_irls_cv(
    const double* betas, const double* X, const float* Xm, const double* y,
    const int* counts, const int* fold_ids, const int* fold_of, float* H,
    double* g, double* stats, float* w, float* Hp, double* gp, double* sp,
    int S, long long n_max, int d, int C, int NSLR, int TNR, int NSLG,
    void* stream) {
  if (S < 1 || d < 1 || d > K5_MAX_DIM || C < 1 || NSLR < 1 || NSLG < 1 ||
      (TNR != 8 && TNR != 16 && TNR != 32))
    return (int)cudaErrorInvalidValue;
  K5Dims D = k5_dims(d);
  D.S = S;
  D.n_max = n_max;
  D.C = C;
  D.NSLR = NSLR;
  D.TNR = TNR;
  D.NSLG = NSLG;
  D.vec_x = (d % 2 == 0) && ((uintptr_t)X % 16 == 0);
  D.vec_m = (d % 4 == 0) && ((uintptr_t)Xm % 16 == 0);
  const size_t smem_r = k5_rows_smem(D, TNR), smem_g = k5_gram_smem(D);
  if (smem_r > K5_MAX_SMEM || smem_g > K5_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const auto rows = k5_rows_fn(D);
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_r);
  if (err != cudaSuccess) return (int)err;
  const auto gram = k5_gram_fn(D);
  err = cudaFuncSetAttribute(gram, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_g);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid_r((unsigned)((C + K5_CB - 1) / K5_CB), (unsigned)NSLR,
              (unsigned)S);
  rows<<<grid_r, K5_THREADS, smem_r, st>>>(betas, X, y, counts, fold_ids,
                                           fold_of, w, gp, sp, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_g((unsigned)(C * D.units), (unsigned)NSLG, (unsigned)S);
  gram<<<grid_g, K5_GTHREADS, smem_g, st>>>(Xm, w, counts, Hp, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long QS = (long long)C * S;
  const long long total =
      QS * ((long long)d * (d + 1) / 2) + QS * d + QS * K5_NSTAT;
  const unsigned blocks = (unsigned)((total + K5_THREADS - 1) / K5_THREADS);
  irls_cv_reduce_kernel<<<blocks, K5_THREADS, 0, st>>>(
      Hp, gp, sp, H, g, stats, (int)QS, d, NSLG, NSLR);
  return (int)cudaGetLastError();
}
