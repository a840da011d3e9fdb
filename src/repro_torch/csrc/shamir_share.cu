// K4: leaf-wise Shamir shares of already-encoded field elements.
//
// Replaces the JAX package's kernels/shamir_poly.py::shamir_poly_pallas
// (_kernel).  For residue r with modulus p_r and element i:
//
//   share(j) = q(j) = secret[r, i] + sum_k coeffs[r, k, i] j^(k+1) mod p_r
//
// evaluated with Horner's rule at every public point j = 1..w, written as
// int64 into the holder-leading (w, R, n) layout ShamirScheme returns, so
// no transpose follows the launch.  The TPU kernel runs once per residue;
// this one takes every residue in one launch.
//
// What bounds it on the H100: bytes.  Each (residue, element) reads 8 B of
// secret and (t-1) * 8 B of coefficients and writes w * 8 B of shares;
// the arithmetic is (t-1+1) * w 64-bit multiply/modulo steps.  The design
// is one thread per (residue, element), consecutive threads on consecutive
// elements, so every load and store is coalesced.  The TPU kernel's
// 16-bit-limb mulmod31 existed only because the TPU vector unit has no
// 64-bit integer multiply; Hopper has one, so each step is a plain 64-bit
// multiply and `%` (acc < p < 2^31 and j <= 16 keep acc * j + c < 2^36).
//
// Inputs must be reduced (0 <= value < p_r), as the JAX ops.shamir_shares
// requires; the wrapper checks shapes, types and the static limits below.
#include <cuda_runtime.h>

#define K4_MAX_R 8
#define K4_MAX_TM1 15
#define K4_MAX_POINTS 16
#define K4_THREADS 256

struct K4Params {
  unsigned long long mod[K4_MAX_R];
  int R;
  int tm1;  // t - 1 coefficients per residue
  int w;    // shares: points 1..w
};

__global__ void __launch_bounds__(K4_THREADS)
leafwise_share_kernel(const long long* __restrict__ secret,
                      const long long* __restrict__ coeffs,
                      long long* __restrict__ out, long long n, K4Params P) {
  const long long e = (long long)blockIdx.x * K4_THREADS + threadIdx.x;
  if (e >= (long long)P.R * n) return;
  const int r = (int)(e / n);
  const long long i = e - (long long)r * n;
  const unsigned long long p = P.mod[r];
  const unsigned long long s = (unsigned long long)secret[e];
  unsigned long long c[K4_MAX_TM1];
  for (int k = 0; k < P.tm1; ++k)
    c[k] = (unsigned long long)coeffs[((long long)r * P.tm1 + k) * n + i];
  for (int j = 1; j <= P.w; ++j) {
    const unsigned long long x = (unsigned long long)j;
    unsigned long long acc = 0;
    for (int k = P.tm1 - 1; k >= 0; --k) acc = (acc * x + c[k]) % p;
    out[((long long)(j - 1) * P.R + r) * n + i] =
        (long long)((acc * x + s) % p);
  }
}

extern "C" int repro_k4_share(const long long* secret, const long long* coeffs,
                              long long* out, long long n, int R, int tm1,
                              const long long* moduli, int w, void* stream) {
  if (R < 1 || R > K4_MAX_R || tm1 < 0 || tm1 > K4_MAX_TM1 || w < 1 ||
      w > K4_MAX_POINTS || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  K4Params P;
  for (int r = 0; r < R; ++r) P.mod[r] = (unsigned long long)moduli[r];
  P.R = R;
  P.tm1 = tm1;
  P.w = w;
  const long long total = (long long)R * n;
  const unsigned blocks = (unsigned)((total + K4_THREADS - 1) / K4_THREADS);
  leafwise_share_kernel<<<blocks, K4_THREADS, 0, (cudaStream_t)stream>>>(
      secret, coeffs, out, n, P);
  return (int)cudaGetLastError();
}
