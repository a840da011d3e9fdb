// K6: the weighted Gram H = X^T diag(w) X for caller-given row weights.
//
// Replaces the JAX package's kernels/fused_irls.py::gram_hessian_pallas
// (_gram_kernel): X (N, d) and w (N,) in float32, H (d, d) float32 with
// float32 sums.  It runs the Gram and the reduce of K5 (irls_tc.cuh) for
// one configuration and one institution of N valid rows, the weights read
// from the caller's w: each product is formed as the reference forms it,
// a = (x_i w) rounded to float32, then split with x_j into TF32 hi + lo
// terms for three tensor-core products (upper half only, mirrored by the
// reduce).  Rows past N are never read.
//
// What bounds it on the H100: bytes.  It reads 4 N (d + 1) bytes once,
// 0.031 ms at 200,000 x 128; the symmetric Gram as three TF32 products
// takes 0.020 ms at the dense TF32 peak.  The Gram's two tile regimes and
// what bounds each are irls_tc.cuh's.
#include "irls_tc.cuh"

template <int NT>
__global__ void __launch_bounds__(IrlsGram<NT>::THREADS,
                                  IrlsGram<NT>::MIN_BLOCKS)
k6_gram_kernel(IRLS_GRAM_PARAMS) {
  irls_gram<NT>(IRLS_GRAM_ARGS);
}

__global__ void __launch_bounds__(IRLS_THREADS)
k6_reduce_kernel(IRLS_REDUCE_PARAMS) {
  irls_reduce(IRLS_REDUCE_ARGS);
}

static const IrlsKernels k6_kernels = {
    {nullptr, nullptr, nullptr, nullptr},  // no rows kernel: w is given
    {k6_gram_kernel<32>, k6_gram_kernel<128>},
    k6_reduce_kernel};

// K6's plan at dimension d (irls_plan's five ints; the rows entries are
// the shared rows kernel's, which K6 never launches)
extern "C" int repro_k6_plan(int d, int* out) {
  return irls_plan(k6_kernels, d, out);
}

// scratch: Hp (NSLG, d (d + 1) / 2) packed partial Grams
extern "C" int repro_k6_gram_hessian(const float* X, const float* w, float* H,
                                     float* Hp, long long n, int d, int NSLG,
                                     void* stream) {
  if (n < 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const IrlsDims D = irls_call_dims(1, n, d, 1, 0, 0, NSLG, nullptr, X);
  return irls_launch(k6_kernels, D, nullptr, nullptr, X, nullptr, nullptr,
                     nullptr, nullptr, H, nullptr, nullptr, 0,
                     const_cast<float*>(w), Hp, nullptr, nullptr, stream);
}

int repro_k6_attributes(ReproKernelAttr* out, int* err) {
  return irls_attributes(k6_kernels, "K6", out, err);
}
