// K5: cross-validated IRLS summaries for every (configuration, institution)
// pair in one launch pair.
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
//   H[q, s]           = Xm^T diag(w * train) Xm   float32, no TF32
//   g[q, s]           = X^T ((y - p) * train)     float64
//   dev_train/dev_val = -2 sum(y z - softplus z) over train / hold rows
//   correct_val       = #hold rows with (z > 0) == (y > 0.5)  (z = 0 is 0)
//   count_val         = #hold rows
//
// with z = X betas[q], p = sigmoid(z), w = p (1 - p), all in float64 but
// the Gram.  That is the JAX fused_irls_cv_sim contract, the same as K3's.
//
// What bounds it on the H100: the configurations' symmetric Grams,
// Q N d (d + 1) float32 operations on the CUDA cores (16.5 GFLOP, 0.25 ms
// at Q = 5, N = 2e5, d = 128), against one read of X, Xm, y and the fold
// ids (0.09 ms).  This simple kernel computes the full d x d Gram of every
// configuration and re-reads the rows once per configuration.
//
// Design: K3's (csrc/fused_irls.cu), with a configuration axis.  The grid
// is (Q x T, NSL, S): block (q, t, sl, s) owns configuration q, the t-th
// 128 x 128 tile of H (T = 1 for d <= 128), the sl-th contiguous slice of
// institution s's valid rows.  The configuration is the fastest grid axis,
// so the Q blocks that read the same rows run side by side and share them
// through L2.  Each block stages TN-row tiles of X and Xm in shared memory;
// one warp per row computes z, p, the train weight and residual and the
// held-out statistics; every thread accumulates an 8 x 8 strided patch of
// the H tile in float32.  The t = 0 block of each slice also accumulates g
// and the four scalars in float64.  Per-slice partials go to scratch, and a
// second launch sums them in slice order: deterministic, no atomics.  The
// wrapper (kernels/fused_irls.py::cv_launch_shape) picks NSL so the grid's
// waves of one block per SM are nearly full.  K3's kernel is left as it
// is; this file repeats its tile loop.
#include <cuda_runtime.h>

#define K5_THREADS 256
#define K5_WARPS (K5_THREADS / 32)
#define K5_HT 128   // H tile edge: 16 x 16 threads x (8 x 8) strided patch
#define K5_GMAX 4   // gradient columns per thread: d <= 1024
#define K5_NSTAT 4  // dev_train, dev_val, correct_val, count_val

struct K5Dims {
  int S;
  long long n_max;
  int d;
  int dpad;  // d rounded up to K5_HT: shared-memory row stride
  int nt;    // H tiles per edge
  int Q;     // configurations
  int NSL;   // row slices per institution
  int TN;    // rows per staged tile
};

__global__ void __launch_bounds__(K5_THREADS, 1)
irls_cv_partial_kernel(const double* __restrict__ betas,
                       const double* __restrict__ X,
                       const float* __restrict__ Xm,
                       const double* __restrict__ y,
                       const int* __restrict__ counts,
                       const int* __restrict__ fold_ids,
                       const int* __restrict__ fold_of,
                       float* __restrict__ Hp, double* __restrict__ gp,
                       double* __restrict__ sp, K5Dims D) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* Xs = (double*)smem;                 // TN * dpad
  double* bs = Xs + D.TN * D.dpad;            // dpad
  double* rs = bs + D.dpad;                   // TN train residuals
  double* red = rs + D.TN;                    // K5_WARPS * K5_NSTAT
  float* Xms = (float*)(red + K5_WARPS * K5_NSTAT);  // TN * dpad
  float* ws = Xms + D.TN * D.dpad;            // TN train weights

  const int tiles = D.nt * D.nt;
  const int q = blockIdx.x / tiles, t = blockIdx.x - q * tiles;
  const int sl = blockIdx.y, s = blockIdx.z;
  const int ti = t / D.nt, tj = t % D.nt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const bool lead = (t == 0);  // this block also owns g and the scalars
  const int fold = fold_of[q];

  // a count past the batch reads no further than its last row (int clamp,
  // as K3 does)
  int cnt = counts[s];
  if ((long long)cnt > D.n_max) cnt = (int)D.n_max;
  const long long count = cnt;
  const long long chunk = (count + D.NSL - 1) / D.NSL;
  const long long r_begin = min(count, (long long)sl * chunk);
  const long long r_end = min(count, r_begin + chunk);
  const double* Xb = X + (long long)s * D.n_max * D.d;
  const float* Xmb = Xm + (long long)s * D.n_max * D.d;
  const double* yb = y + (long long)s * D.n_max;
  const int* fb = fold_ids + (long long)s * D.n_max;

  for (int k = tid; k < D.dpad; k += K5_THREADS)
    bs[k] = k < D.d ? betas[(long long)q * D.d + k] : 0.0;

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  double gacc[K5_GMAX];
#pragma unroll
  for (int m = 0; m < K5_GMAX; ++m) gacc[m] = 0.0;
  // lane 0 of each warp: dev_train, dev_val, correct_val, count_val
  double st[K5_NSTAT] = {0.0, 0.0, 0.0, 0.0};

  for (long long r0 = r_begin; r0 < r_end; r0 += D.TN) {
    const int nrows = (int)min((long long)D.TN, r_end - r0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < D.TN * D.dpad; idx += K5_THREADS) {
      const int r = idx / D.dpad, k = idx - r * D.dpad;
      const bool in = r < nrows && k < D.d;
      const long long off = (r0 + r) * D.d + k;
      Xs[idx] = in ? Xb[off] : 0.0;
      Xms[idx] = in ? Xmb[off] : 0.f;
    }
    __syncthreads();
    for (int r = warp; r < D.TN; r += K5_WARPS) {
      double zp = 0.0;
      for (int k = lane; k < D.d; k += 32) zp = fma(Xs[r * D.dpad + k], bs[k], zp);
#pragma unroll
      for (int o = 16; o; o >>= 1) zp += __shfl_xor_sync(0xffffffffu, zp, o);
      if (lane == 0) {
        float w32 = 0.f;
        double resid = 0.0;
        if (r < nrows) {  // a valid row: r0 + r < counts[s]
          const double z = zp;
          const double p = 1.0 / (1.0 + exp(-z));
          const double yr = yb[r0 + r];
          const double softplus = fmax(z, 0.0) + log1p(exp(-fabs(z)));
          const double ll = yr * z - softplus;
          if (fb[r0 + r] == fold) {  // held out
            st[1] += ll;
            st[2] += ((z > 0.0) == (yr > 0.5)) ? 1.0 : 0.0;
            st[3] += 1.0;
          } else {  // trains
            w32 = (float)(p * (1.0 - p));
            resid = yr - p;
            st[0] += ll;
          }
        }
        ws[r] = w32;
        rs[r] = resid;
      }
    }
    __syncthreads();
    if (lead) {
#pragma unroll
      for (int m = 0; m < K5_GMAX; ++m) {
        const int col = tid + m * K5_THREADS;
        if (col < D.d) {
          double a = 0.0;
          for (int r = 0; r < nrows; ++r) a = fma(Xs[r * D.dpad + col], rs[r], a);
          gacc[m] += a;
        }
      }
    }
    float part[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) part[a][b] = 0.f;
    const float* Ai = Xms + ti * K5_HT + ty;
    const float* Bj = Xms + tj * K5_HT + tx;
    for (int r = 0; r < nrows; ++r) {
      const float wr = ws[r];
      float av[8], bv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) av[a] = Ai[r * D.dpad + 16 * a] * wr;
#pragma unroll
      for (int b = 0; b < 8; ++b) bv[b] = Bj[r * D.dpad + 16 * b];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) part[a][b] = fmaf(av[a], bv[b], part[a][b]);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] += part[a][b];
  }

  const long long slot = ((long long)q * D.S + s) * D.NSL + sl;
  float* Hb = Hp + slot * D.d * D.d;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = ti * K5_HT + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = tj * K5_HT + tx + 16 * b;
      if (i < D.d && j < D.d) Hb[(long long)i * D.d + j] = acc[a][b];
    }
  }
  if (lead) {
    double* gb = gp + slot * D.d;
#pragma unroll
    for (int m = 0; m < K5_GMAX; ++m) {
      const int col = tid + m * K5_THREADS;
      if (col < D.d) gb[col] = gacc[m];
    }
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < K5_NSTAT; ++k) red[warp * K5_NSTAT + k] = st[k];
    __syncthreads();
    if (tid < K5_NSTAT) {
      double tot = 0.0;
      for (int w = 0; w < K5_WARPS; ++w) tot += red[w * K5_NSTAT + tid];
      // the deviances carry the -2; the counts go out as they are
      sp[slot * K5_NSTAT + tid] = tid < 2 ? -2.0 * tot : tot;
    }
  }
}

// Sum the NSL per-slice partials in slice order.  stats is (4, Q, S):
// dev_train, dev_val, correct_val, count_val.
__global__ void __launch_bounds__(K5_THREADS)
irls_cv_reduce_kernel(const float* __restrict__ Hp,
                      const double* __restrict__ gp,
                      const double* __restrict__ sp, float* __restrict__ H,
                      double* __restrict__ g, double* __restrict__ stats,
                      int QS, int d, int NSL) {
  const long long e = (long long)blockIdx.x * K5_THREADS + threadIdx.x;
  const long long dd = (long long)d * d, nH = (long long)QS * dd,
                  ng = (long long)QS * d, ns = (long long)QS * K5_NSTAT;
  if (e < nH) {
    const long long qs = e / dd, k = e - qs * dd;
    float a = 0.f;
    for (int c = 0; c < NSL; ++c) a += Hp[(qs * NSL + c) * dd + k];
    H[e] = a;
  } else if (e < nH + ng) {
    const long long e2 = e - nH, qs = e2 / d, k = e2 - qs * d;
    double a = 0.0;
    for (int c = 0; c < NSL; ++c) a += gp[(qs * NSL + c) * d + k];
    g[e2] = a;
  } else if (e < nH + ng + ns) {
    const long long e3 = e - nH - ng, k = e3 / QS, qs = e3 - k * QS;
    double a = 0.0;
    for (int c = 0; c < NSL; ++c) a += sp[(qs * NSL + c) * K5_NSTAT + k];
    stats[e3] = a;
  }
}

extern "C" int repro_k5_fused_irls_cv(
    const double* betas, const double* X, const float* Xm, const double* y,
    const int* counts, const int* fold_ids, const int* fold_of, float* H,
    double* g, double* stats, float* Hp, double* gp, double* sp, int S,
    long long n_max, int d, int Q, int NSL, int TN, void* stream) {
  if (S < 1 || d < 1 || d > K5_GMAX * K5_THREADS || Q < 1 || NSL < 1 ||
      TN < 1)
    return (int)cudaErrorInvalidValue;
  K5Dims D;
  D.S = S;
  D.n_max = n_max;
  D.d = d;
  D.dpad = (d + K5_HT - 1) / K5_HT * K5_HT;
  D.nt = D.dpad / K5_HT;
  D.Q = Q;
  D.NSL = NSL;
  D.TN = TN;
  const size_t smem = (size_t)TN * D.dpad * (sizeof(double) + sizeof(float)) +
                      (size_t)D.dpad * sizeof(double) +
                      (size_t)TN * (sizeof(double) + sizeof(float)) +
                      K5_WARPS * K5_NSTAT * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      irls_cv_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)(Q * D.nt * D.nt), (unsigned)NSL, (unsigned)S);
  irls_cv_partial_kernel<<<grid, K5_THREADS, smem, st>>>(
      betas, X, Xm, y, counts, fold_ids, fold_of, Hp, gp, sp, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long QS = (long long)Q * S;
  const long long total = QS * d * d + QS * d + QS * K5_NSTAT;
  const unsigned blocks = (unsigned)((total + K5_THREADS - 1) / K5_THREADS);
  irls_cv_reduce_kernel<<<blocks, K5_THREADS, 0, st>>>(Hp, gp, sp, H, g, stats,
                                                        (int)QS, d, NSL);
  return (int)cudaGetLastError();
}
