// K6: the weighted Gram H = X^T diag(w) X for caller-given row weights.
//
// Replaces the JAX package's kernels/fused_irls.py::gram_hessian_pallas
// (_gram_kernel): X (N, d) and w (N,) in float32, H (d, d) float32 with
// float32 accumulation (CUDA cores, no TF32).  Each product is formed as
// the reference forms it, (x_i w) x_j: the weighted operand is rounded to
// float32 first, then fused-multiply-added into the sum.
//
// What bounds it on the H100: operations.  It reads 4 N (d + 1) bytes once
// and needs N d (d + 1) float32 operations for the symmetric Gram; at d =
// 128 the operations take longer than the bytes.  This simple kernel
// computes the full d x d Gram, twice that work.
//
// Design.  The TPU kernel carried H across a sequential grid over row
// blocks; Hopper's blocks run in no order.  So the grid is (C, T): block
// (c, t) owns the c-th contiguous slice of the N rows and the t-th 128 x
// 128 tile of H (T = 1 for d <= 128).  It stages TN-row tiles of X and w
// in shared memory, and each thread accumulates an 8 x 8 strided patch of
// the H tile with float32 FMAs.  Each block writes its tile of the slice's
// partial Gram to scratch; a second launch sums the C partials in slice
// order, so the result is deterministic and needs no atomics.  This is
// K3's Gram loop (csrc/fused_irls.cu) without the IRLS weights.
#include <cuda_runtime.h>

#define K6_THREADS 256
#define K6_HT 128  // H tile edge: 16 x 16 threads x (8 x 8) strided patch

struct K6Dims {
  long long n;
  int d;
  int dpad;  // d rounded up to K6_HT: shared-memory row stride
  int nt;    // H tiles per edge
  int C;     // row slices
  int TN;    // rows per staged tile
};

__global__ void __launch_bounds__(K6_THREADS, 2)
gram_partial_kernel(const float* __restrict__ X, const float* __restrict__ w,
                    float* __restrict__ Hp, K6Dims D) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Xs = (float*)smem;        // TN * dpad
  float* ws = Xs + D.TN * D.dpad;  // TN

  const int c = blockIdx.x, t = blockIdx.y;
  const int ti = t / D.nt, tj = t % D.nt;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long chunk = (D.n + D.C - 1) / D.C;
  const long long r_begin = min(D.n, (long long)c * chunk);
  const long long r_end = min(D.n, r_begin + chunk);

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;

  const float* Ai = Xs + ti * K6_HT + ty;
  const float* Bj = Xs + tj * K6_HT + tx;
  for (long long r0 = r_begin; r0 < r_end; r0 += D.TN) {
    const int nrows = (int)min((long long)D.TN, r_end - r0);
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < nrows * D.dpad; idx += K6_THREADS) {
      const int r = idx / D.dpad, k = idx - r * D.dpad;
      Xs[idx] = k < D.d ? X[(r0 + r) * D.d + k] : 0.f;
    }
    for (int r = tid; r < nrows; r += K6_THREADS) ws[r] = w[r0 + r];
    __syncthreads();
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
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
  }

  float* Hb = Hp + (long long)c * D.d * D.d;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = ti * K6_HT + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int j = tj * K6_HT + tx + 16 * b;
      if (i < D.d && j < D.d) Hb[(long long)i * D.d + j] = acc[a][b];
    }
  }
}

// Sum the C per-slice partials of H in slice order.
__global__ void __launch_bounds__(K6_THREADS)
gram_reduce_kernel(const float* __restrict__ Hp, float* __restrict__ H,
                   long long dd, int C) {
  const long long e = (long long)blockIdx.x * K6_THREADS + threadIdx.x;
  if (e >= dd) return;
  float a = 0.f;
  for (int c = 0; c < C; ++c) a += Hp[(long long)c * dd + e];
  H[e] = a;
}

extern "C" int repro_k6_gram_hessian(const float* X, const float* w, float* H,
                                     float* Hp, long long n, int d, int C,
                                     int TN, void* stream) {
  if (n < 0 || d < 1 || C < 1 || TN < 1) return (int)cudaErrorInvalidValue;
  K6Dims D;
  D.n = n;
  D.d = d;
  D.dpad = (d + K6_HT - 1) / K6_HT * K6_HT;
  D.nt = D.dpad / K6_HT;
  D.C = C;
  D.TN = TN;
  const size_t smem = (size_t)TN * (D.dpad + 1) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gram_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)C, (unsigned)(D.nt * D.nt));
  gram_partial_kernel<<<grid, K6_THREADS, smem, st>>>(X, w, Hp, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long dd = (long long)d * d;
  const unsigned blocks = (unsigned)((dd + K6_THREADS - 1) / K6_THREADS);
  gram_reduce_kernel<<<blocks, K6_THREADS, 0, st>>>(Hp, H, dd, C);
  return (int)cudaGetLastError();
}
