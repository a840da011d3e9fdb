// K5: cross-validated IRLS summaries for every (configuration, institution)
// pair in one call.
//
// Replaces the JAX package's kernels/fused_irls.py::fused_irls_cv_pallas
// (_irls_cv_kernel).  The contract, the design and the launch plan are
// irls_tc.cuh's, which K3 and K6 share: configuration q has its own iterate
// betas[q] and held-out fold fold_of[q] (-1: a full-data fit); the outputs
// are H (Q, S, d, d) float32, g (Q, S, d) float64 and the statistics
// (4, Q, S) float64: dev_train, dev_val, correct_val, count_val.
//
// What bounds it on the H100: bytes.  One read of X, Xm, y and the fold
// ids is 0.093 ms at the λ path's shape (Q = 5, N = 2e5, d = 128); the
// symmetric Grams as three TF32 products take 0.080 ms at the dense TF32
// peak, the float64 z, g and deviance terms 0.014 ms at the CUDA cores'
// float64 peak.  The rows kernel reads X once for up to 8 configurations,
// and the Gram blocks of one slice's configurations share its rows of Xm
// through L2.
#include "irls_tc.cuh"

template <int MTW>
__global__ void __launch_bounds__(IRLS_THREADS, 2)
irls_cv_rows_kernel(IRLS_ROWS_PARAMS) {
  irls_rows<MTW>(IRLS_ROWS_ARGS);
}

template <int NT>
__global__ void __launch_bounds__(IrlsGram<NT>::THREADS,
                                  IrlsGram<NT>::MIN_BLOCKS)
irls_cv_gram_kernel(IRLS_GRAM_PARAMS) {
  irls_gram<NT>(IRLS_GRAM_ARGS);
}

__global__ void __launch_bounds__(IRLS_THREADS)
irls_cv_reduce_kernel(IRLS_REDUCE_PARAMS) {
  irls_reduce(IRLS_REDUCE_ARGS);
}

static const IrlsKernels k5_kernels = {
    {irls_cv_rows_kernel<2>, irls_cv_rows_kernel<4>, irls_cv_rows_kernel<8>,
     irls_cv_rows_kernel<16>},
    {irls_cv_gram_kernel<32>, irls_cv_gram_kernel<128>},
    irls_cv_reduce_kernel};

// K5's plan at dimension d (irls_plan's five ints)
extern "C" int repro_k5_plan(int d, int* out) {
  return irls_plan(k5_kernels, d, out);
}

extern "C" int repro_k5_fused_irls_cv(
    const double* betas, const double* X, const float* Xm, const double* y,
    const int* counts, const int* fold_ids, const int* fold_of, float* H,
    double* g, double* stats, float* w, float* Hp, double* gp, double* sp,
    int S, long long n_max, int d, int C, int NSLR, int TNR, int NSLG,
    void* stream) {
  const IrlsDims D = irls_call_dims(S, n_max, d, C, NSLR, TNR, NSLG, X, Xm);
  return irls_launch(k5_kernels, D, betas, X, Xm, y, counts, fold_ids,
                     fold_of, H, g, stats, IRLS_NSTAT, w, Hp, gp, sp, stream);
}

int repro_k5_attributes(ReproKernelAttr* out, int* err) {
  return irls_attributes(k5_kernels, "K5", out, err);
}
