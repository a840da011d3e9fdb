// K3: every institution's IRLS summaries in one call.
//
// Replaces the JAX package's kernels/fused_irls.py::fused_irls_pallas
// (_irls_kernel).  For institution s with counts[s] valid rows (a count
// past N_max reads N_max rows):
//
//   z = X beta,  p = sigmoid(z),  w = p (1 - p)
//   H_s   = Xm^T diag(w) Xm    float32 sums, 3xTF32 on the tensor cores
//   g_s   = X^T (y - p)        float64
//   dev_s = -2 sum(y z - softplus z)   float64
//
// That is K5 with one configuration and no folds, and it runs K5's code
// (irls_tc.cuh): the float64 rows kernel with fold_ids == nullptr (every
// valid row trains; the dmma's n carries the one configuration and seven
// zero columns), the Gram from Xm and the weights it wrote, and the reduce,
// which writes dev_train as dev.  Rows >= counts[s] are never read.
//
// What bounds it on the H100: bytes.  X (float64) and Xm (float32) are read
// once, 12 N d bytes: 0.092 ms at the fit's shape (S = 8, N = 2e5, d =
// 128), against 0.020 ms for the symmetric Gram as three TF32 products.
// The rows kernel reads X, the Gram Xm and the float32 weights (4 N
// bytes written and read once more).
#include "irls_tc.cuh"

template <int MTW>
__global__ void __launch_bounds__(IRLS_THREADS, 2)
k3_rows_kernel(IRLS_ROWS_PARAMS) {
  irls_rows<MTW>(IRLS_ROWS_ARGS);
}

template <int NT>
__global__ void __launch_bounds__(IrlsGram<NT>::THREADS,
                                  IrlsGram<NT>::MIN_BLOCKS)
k3_gram_kernel(IRLS_GRAM_PARAMS) {
  irls_gram<NT>(IRLS_GRAM_ARGS);
}

__global__ void __launch_bounds__(IRLS_THREADS)
k3_reduce_kernel(IRLS_REDUCE_PARAMS) {
  irls_reduce(IRLS_REDUCE_ARGS);
}

static const IrlsKernels k3_kernels = {
    {k3_rows_kernel<2>, k3_rows_kernel<4>, k3_rows_kernel<8>,
     k3_rows_kernel<16>},
    {k3_gram_kernel<32>, k3_gram_kernel<128>},
    k3_reduce_kernel};

// K3's plan at dimension d (irls_plan's five ints)
extern "C" int repro_k3_plan(int d, int* out) {
  return irls_plan(k3_kernels, d, out);
}

// scratch: w (S, n_max) float32 weights, Hp (S, NSLG, d (d + 1) / 2)
// packed partial Grams, gp (S, NSLR, d) and sp (S, NSLR, 4) float64
extern "C" int repro_k3_fused_irls(const double* beta, const double* X,
                                   const float* Xm, const double* y,
                                   const int* counts, float* H, double* g,
                                   double* dev, float* w, float* Hp,
                                   double* gp, double* sp, int S,
                                   long long n_max, int d, int NSLR, int TNR,
                                   int NSLG, void* stream) {
  const IrlsDims D = irls_call_dims(S, n_max, d, 1, NSLR, TNR, NSLG, X, Xm);
  return irls_launch(k3_kernels, D, beta, X, Xm, y, counts, nullptr, nullptr,
                     H, g, dev, 1, w, Hp, gp, sp, stream);
}

int repro_k3_attributes(ReproKernelAttr* out, int* err) {
  return irls_attributes(k3_kernels, "K3", out, err);
}
