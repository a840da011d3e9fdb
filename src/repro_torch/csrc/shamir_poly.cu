// K1: fused fixed-point encode + Shamir share evaluation on the flat wire.
//
// Replaces the JAX package's kernels/shamir_poly.py::
// shamir_encode_share_pallas (_encode_share_kernel).  Per element of the
// (rows, 128) float payload:
//
//   s = round_half_even(x * 2^frac_bits), clipped to +-max_signed
//   secret_r = s mod p_r (Python sign convention), for each residue r
//   share(j) = Horner evaluation of secret_r + sum_k c_{r,k} j^(k+1) mod p_r
//              at each requested public point j
//
// written as int32 straight into the holder-leading (len(points), R, rows,
// 128) layout the protocol ships, so no transpose follows the launch.
//
// What bounds it on the H100: bytes.  Each element reads 8 B of payload
// and R*(t-1)*4 B of coefficients and writes len(points)*R*4 B of shares;
// the arithmetic is a few 64-bit multiply/modulo steps per share.  The
// design is one thread per element with coalesced loads and stores: the
// TPU kernel's 16-bit-limb mulmod and its float hi/lo split existed only
// because the TPU vector unit has no 64-bit integer multiply, and Hopper
// has one, so |s| mod p is a plain 64-bit `%`.
//
// Bit parity with the JAX kernel: rint() rounds half to even like
// jnp.round (CUDA's round() would round ties away from zero).  An f32
// payload is scaled, rounded and clipped in f32 against (float)lim, as
// jnp.clip(jnp.round(x * scale), -lim, lim) does for f32 x, and only then
// widened.  lim is float(max_signed) from the host, the same double the JAX
// kernel clips against.
#include <cuda_runtime.h>

#define K1_MAX_R 2
#define K1_MAX_TM1 15
#define K1_MAX_POINTS 16
#define K1_THREADS 256

struct K1Params {
  unsigned long long mod[K1_MAX_R];
  int points[K1_MAX_POINTS];
  int npoints;
  int R;
  int tm1;  // t - 1 coefficients per residue
  double lim;
  double scale;
};

__device__ __forceinline__ long long encode_value(double x, const K1Params& P) {
  double s = rint(x * P.scale);
  s = fmin(fmax(s, -P.lim), P.lim);
  return (long long)s;
}

__device__ __forceinline__ long long encode_value(float x, const K1Params& P) {
  const float lim = (float)P.lim;
  float s = rintf(x * (float)P.scale);
  s = fminf(fmaxf(s, -lim), lim);
  return (long long)(double)s;
}

template <typename T>
__global__ void __launch_bounds__(K1_THREADS)
encode_share_kernel(const T* __restrict__ x, const int* __restrict__ coeffs,
                    int* __restrict__ out, long long n, K1Params P) {
  const long long e = (long long)blockIdx.x * K1_THREADS + threadIdx.x;
  if (e >= n) return;
  const long long s = encode_value(x[e], P);
  const bool neg = s < 0;
  const unsigned long long mag =
      neg ? (unsigned long long)(-s) : (unsigned long long)s;
  for (int r = 0; r < P.R; ++r) {
    const unsigned long long p = P.mod[r];
    const unsigned long long m = mag % p;
    const unsigned long long secret = (neg && m) ? p - m : m;
    unsigned long long c[K1_MAX_TM1];
    for (int k = 0; k < P.tm1; ++k)
      c[k] = (unsigned long long)coeffs[(long long)(r * P.tm1 + k) * n + e];
    for (int o = 0; o < P.npoints; ++o) {
      const unsigned long long xj = (unsigned long long)P.points[o];
      unsigned long long acc = 0;
      for (int k = P.tm1 - 1; k >= 0; --k) acc = (acc * xj + c[k]) % p;
      out[(long long)(o * P.R + r) * n + e] = (int)((acc * xj + secret) % p);
    }
  }
}

extern "C" int repro_k1_encode_share(const void* x, int x_is_f64,
                                     const int* coeffs, int* out, long long n,
                                     int R, int tm1, const long long* moduli,
                                     const int* points, int npoints,
                                     double lim, double scale, void* stream) {
  if (R < 1 || R > K1_MAX_R || tm1 < 0 || tm1 > K1_MAX_TM1 || npoints < 1 ||
      npoints > K1_MAX_POINTS || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  K1Params P;
  for (int r = 0; r < R; ++r) P.mod[r] = (unsigned long long)moduli[r];
  for (int o = 0; o < npoints; ++o) P.points[o] = points[o];
  P.npoints = npoints;
  P.R = R;
  P.tm1 = tm1;
  P.lim = lim;
  P.scale = scale;
  const unsigned blocks = (unsigned)((n + K1_THREADS - 1) / K1_THREADS);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_f64)
    encode_share_kernel<double><<<blocks, K1_THREADS, 0, st>>>(
        (const double*)x, coeffs, out, n, P);
  else
    encode_share_kernel<float><<<blocks, K1_THREADS, 0, st>>>(
        (const float*)x, coeffs, out, n, P);
  return (int)cudaGetLastError();
}
