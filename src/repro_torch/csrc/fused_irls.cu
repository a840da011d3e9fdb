// K3: every institution's IRLS summaries in one streaming pass over X.
//
// Replaces the JAX package's kernels/fused_irls.py::fused_irls_pallas
// (_irls_kernel).  For institution s with counts[s] valid rows:
//
//   z = X beta,  p = sigmoid(z),  w = p (1 - p)
//   H_s   = Xm^T diag(w) Xm    float32 operand, float32 accumulation
//   g_s   = X^T (y - p)        float64
//   dev_s = -2 sum(y z - softplus z)   float64
//
// Rows >= counts[s] are never read, so the (S, N_max, d) batch needs no
// padding to a tile multiple; a count above N_max reads all N_max rows, as
// the masked plain version and the TPU kernel count them.
//
// What bounds it on the H100: the 12 N d bytes of X (float64) plus Xm
// (float32) it reads once, and, within a factor of two, the symmetric
// Gram's N d (d + 1) float32 operations (CUDA cores, no TF32 anywhere).
// This simple kernel computes the full d x d Gram, twice that work.
//
// Design.  The TPU kernel carried H across a sequential grid; Hopper's
// blocks run in no order.  So the grid is (C, S, T): block (c, s, t) owns
// the c-th contiguous slice of institution s's valid rows and the t-th
// 128 x 128 tile of H (T = 1 for d <= 128).  It stages TN-row tiles of X
// and Xm in shared memory; one warp per row computes z, p, w and the
// residual (w lives only in shared memory, never in device memory, as on
// the TPU); then every thread accumulates an 8 x 8 strided patch of the
// H tile with float32 FMAs into a per-tile partial, which is added into a
// running float32 sum (the TPU kernel adds one partial per block_n rows).
// The t = 0 block of each slice also accumulates g and dev in float64.
// Each block writes its partials to scratch; a second launch sums the C
// partials in a fixed order, so the result is deterministic, needs no
// atomics, and X is read once.  Tensor cores, TMA and wgmma are later work.
#include <cuda_runtime.h>

#define K3_THREADS 256
#define K3_WARPS (K3_THREADS / 32)
#define K3_HT 128   // H tile edge: 16 x 16 threads x (8 x 8) strided patch
#define K3_GMAX 4   // gradient columns per thread: d <= 1024

struct K3Dims {
  int S;
  long long n_max;
  int d;
  int dpad;  // d rounded up to K3_HT: shared-memory row stride
  int nt;    // H tiles per edge
  int C;     // row slices per institution
  int TN;    // rows per staged tile
};

__global__ void __launch_bounds__(K3_THREADS, 1)
irls_partial_kernel(const double* __restrict__ beta,
                    const double* __restrict__ X,
                    const float* __restrict__ Xm,
                    const double* __restrict__ y,
                    const int* __restrict__ counts,
                    float* __restrict__ Hp, double* __restrict__ gp,
                    double* __restrict__ devp, K3Dims D) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* Xs = (double*)smem;              // TN * dpad
  double* betas = Xs + D.TN * D.dpad;      // dpad
  double* rs = betas + D.dpad;             // TN residuals
  double* red = rs + D.TN;                 // K3_WARPS deviance partials
  float* Xms = (float*)(red + K3_WARPS);   // TN * dpad
  float* ws = Xms + D.TN * D.dpad;         // TN IRLS weights

  const int c = blockIdx.x, s = blockIdx.y, t = blockIdx.z;
  const int ti = t / D.nt, tj = t % D.nt;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const bool lead = (t == 0);  // this block also owns g and dev

  // A count past the batch reads no further than its last row.  Clamped
  // as an int: a 64-bit min() in its place made the kernel 11% slower on
  // an H100 (0.68 against 0.61 ms at S=8, N=2e5, d=128).
  int cnt = counts[s];
  if ((long long)cnt > D.n_max) cnt = (int)D.n_max;
  const long long count = cnt;
  const long long chunk = (count + D.C - 1) / D.C;
  const long long r_begin = min(count, (long long)c * chunk);
  const long long r_end = min(count, r_begin + chunk);
  const double* Xb = X + (long long)s * D.n_max * D.d;
  const float* Xmb = Xm + (long long)s * D.n_max * D.d;
  const double* yb = y + (long long)s * D.n_max;

  for (int k = tid; k < D.dpad; k += K3_THREADS)
    betas[k] = k < D.d ? beta[k] : 0.0;

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  double gacc[K3_GMAX];
#pragma unroll
  for (int m = 0; m < K3_GMAX; ++m) gacc[m] = 0.0;
  double devw = 0.0;

  for (long long r0 = r_begin; r0 < r_end; r0 += D.TN) {
    const int nrows = (int)min((long long)D.TN, r_end - r0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < D.TN * D.dpad; idx += K3_THREADS) {
      const int r = idx / D.dpad, k = idx - r * D.dpad;
      const bool in = r < nrows && k < D.d;
      const long long off = (r0 + r) * D.d + k;
      Xs[idx] = in ? Xb[off] : 0.0;
      Xms[idx] = in ? Xmb[off] : 0.f;
    }
    __syncthreads();
    for (int r = warp; r < D.TN; r += K3_WARPS) {
      double zp = 0.0;
      for (int k = lane; k < D.d; k += 32) zp = fma(Xs[r * D.dpad + k], betas[k], zp);
#pragma unroll
      for (int o = 16; o; o >>= 1) zp += __shfl_xor_sync(0xffffffffu, zp, o);
      if (lane == 0) {
        float w32 = 0.f;
        double resid = 0.0;
        if (r < nrows) {
          const double z = zp;
          const double p = 1.0 / (1.0 + exp(-z));
          const double yr = yb[r0 + r];
          w32 = (float)(p * (1.0 - p));
          resid = yr - p;
          const double softplus = fmax(z, 0.0) + log1p(exp(-fabs(z)));
          devw += yr * z - softplus;
        }
        ws[r] = w32;
        rs[r] = resid;
      }
    }
    __syncthreads();
    if (lead) {
#pragma unroll
      for (int m = 0; m < K3_GMAX; ++m) {
        const int col = tid + m * K3_THREADS;
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
    const float* Ai = Xms + ti * K3_HT + ty;
    const float* Bj = Xms + tj * K3_HT + tx;
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

  float* Hb = Hp + ((long long)s * D.C + c) * D.d * D.d;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = ti * K3_HT + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = tj * K3_HT + tx + 16 * b;
      if (i < D.d && j < D.d) Hb[(long long)i * D.d + j] = acc[a][b];
    }
  }
  if (lead) {
    double* gb = gp + ((long long)s * D.C + c) * D.d;
#pragma unroll
    for (int m = 0; m < K3_GMAX; ++m) {
      const int col = tid + m * K3_THREADS;
      if (col < D.d) gb[col] = gacc[m];
    }
    if (lane == 0) red[warp] = devw;
    __syncthreads();
    if (tid == 0) {
      double tot = 0.0;
      for (int w = 0; w < K3_WARPS; ++w) tot += red[w];
      devp[(long long)s * D.C + c] = -2.0 * tot;
    }
  }
}

// Sum the C per-slice partials of H, g and dev in slice order.
__global__ void __launch_bounds__(K3_THREADS)
irls_reduce_kernel(const float* __restrict__ Hp, const double* __restrict__ gp,
                   const double* __restrict__ devp, float* __restrict__ H,
                   double* __restrict__ g, double* __restrict__ dev, int S,
                   int d, int C) {
  const long long e = (long long)blockIdx.x * K3_THREADS + threadIdx.x;
  const long long dd = (long long)d * d, nH = (long long)S * dd,
                  ng = (long long)S * d;
  if (e < nH) {
    const long long s = e / dd, q = e - s * dd;
    float a = 0.f;
    for (int c = 0; c < C; ++c) a += Hp[(s * C + c) * dd + q];
    H[e] = a;
  } else if (e < nH + ng) {
    const long long e2 = e - nH, s = e2 / d, q = e2 - s * d;
    double a = 0.0;
    for (int c = 0; c < C; ++c) a += gp[(s * C + c) * d + q];
    g[e2] = a;
  } else if (e < nH + ng + S) {
    const long long s = e - nH - ng;
    double a = 0.0;
    for (int c = 0; c < C; ++c) a += devp[s * C + c];
    dev[s] = a;
  }
}

extern "C" int repro_k3_fused_irls(const double* beta, const double* X,
                                   const float* Xm, const double* y,
                                   const int* counts, float* H, double* g,
                                   double* dev, float* Hp, double* gp,
                                   double* devp, int S, long long n_max, int d,
                                   int C, int TN, void* stream) {
  if (S < 1 || d < 1 || d > K3_GMAX * K3_THREADS || C < 1 || TN < 1)
    return (int)cudaErrorInvalidValue;
  K3Dims D;
  D.S = S;
  D.n_max = n_max;
  D.d = d;
  D.dpad = (d + K3_HT - 1) / K3_HT * K3_HT;
  D.nt = D.dpad / K3_HT;
  D.C = C;
  D.TN = TN;
  const size_t smem = (size_t)TN * D.dpad * (sizeof(double) + sizeof(float)) +
                      (size_t)D.dpad * sizeof(double) +
                      (size_t)TN * (sizeof(double) + sizeof(float)) +
                      K3_WARPS * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      irls_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)C, (unsigned)S, (unsigned)(D.nt * D.nt));
  irls_partial_kernel<<<grid, K3_THREADS, smem, st>>>(beta, X, Xm, y, counts,
                                                       Hp, gp, devp, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)S * d * d + (long long)S * d + S;
  const unsigned blocks = (unsigned)((total + K3_THREADS - 1) / K3_THREADS);
  irls_reduce_kernel<<<blocks, K3_THREADS, 0, st>>>(Hp, gp, devp, H, g, dev, S,
                                                     d, C);
  return (int)cudaGetLastError();
}
