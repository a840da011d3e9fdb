// K2: Lagrange reconstruction at x = 0 + CRT/Garner decode of the flat wire.
//
// Replaces the JAX package's kernels/shamir_reconstruct.py::
// shamir_reconstruct_pallas (_kernel) with garner=True, together with the
// uint64 epilogue of kernels/ops.py::shamir_reveal_flat that ran after it.
// Per element of the (rows, 128) buffer, from k aggregated share slices
// laid out (k, R, rows, 128):
//
//   rec_r = sum_i L_i(0) * share_{i,r} mod p_r            (each residue)
//   decode: kd = (rec_2 - rec_1) * p1^-1 mod p2          (Garner, p1 > p2)
//           x  = rec_1 + p1 * kd                          (< p1 p2 < 2^62)
//           signed = x <= (M-1)/2 ? x : x - M;  out = signed / 2^frac_bits
//
// and emits the (rows, 128) float64 aggregate.  A residues mode instead
// writes the reconstructed residues (R, rows, 128) as int32; it serves
// R = 1 fields and the leaf-wise backend.  The Lagrange weights are
// computed on the host (public points) and arrive as a small argument,
// not as constants baked into the code.
//
// What bounds it on the H100: bytes (k*R*4 B in, 8 B out per element) and,
// at the protocol's size (136 x 128 elements), the launch itself.  One
// thread per element; 64-bit integer multiply and modulo replace the TPU's
// 16-bit-limb mulmod.
#include <cuda_runtime.h>

#define K2_MAX_R 2
#define K2_MAX_K 16
#define K2_THREADS 256

struct K2Params {
  unsigned long long mod[K2_MAX_R];
  unsigned long long lam[K2_MAX_R][K2_MAX_K];
  unsigned long long inv_p1;  // p1^-1 mod p2 (Garner), R == 2 only
  int k;
  int R;
  double scale;
};

__global__ void __launch_bounds__(K2_THREADS)
reconstruct_kernel(const int* __restrict__ shares, void* __restrict__ out,
                   long long n, K2Params P, int decode) {
  const long long e = (long long)blockIdx.x * K2_THREADS + threadIdx.x;
  if (e >= n) return;
  unsigned long long rec[K2_MAX_R];
  for (int r = 0; r < P.R; ++r) {
    const unsigned long long p = P.mod[r];
    unsigned long long acc = 0;
    for (int i = 0; i < P.k; ++i)
      acc = (acc + P.lam[r][i] *
                       (unsigned long long)shares[(long long)(i * P.R + r) * n + e]) % p;
    rec[r] = acc;
  }
  if (!decode) {
    for (int r = 0; r < P.R; ++r) ((int*)out)[(long long)r * n + e] = (int)rec[r];
    return;
  }
  unsigned long long x, M;
  if (P.R == 2) {
    const unsigned long long p1 = P.mod[0], p2 = P.mod[1];
    const unsigned long long diff = (rec[1] + p2 - rec[0] % p2) % p2;
    const unsigned long long kd = diff * P.inv_p1 % p2;
    x = rec[0] + p1 * kd;
    M = p1 * p2;
  } else {
    x = rec[0];
    M = P.mod[0];
  }
  const long long value =
      x <= (M - 1) / 2 ? (long long)x : -(long long)(M - x);
  ((double*)out)[e] = (double)value / P.scale;
}

extern "C" int repro_k2_reconstruct(const int* shares, void* out, long long n,
                                    int k, int R, const long long* lams,
                                    const long long* moduli, int decode,
                                    double scale, void* stream) {
  if (R < 1 || R > K2_MAX_R || k < 1 || k > K2_MAX_K || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  K2Params P;
  for (int r = 0; r < R; ++r) {
    P.mod[r] = (unsigned long long)moduli[r];
    for (int i = 0; i < k; ++i) P.lam[r][i] = (unsigned long long)lams[r * k + i];
  }
  P.inv_p1 = 0;
  if (R == 2) {
    // Fermat inverse of p1 mod p2 (public constant): p1^(p2-2) mod p2
    const unsigned long long p2 = P.mod[1];
    unsigned long long base = P.mod[0] % p2, e = p2 - 2, acc = 1;
    while (e) {
      if (e & 1) acc = acc * base % p2;
      base = base * base % p2;
      e >>= 1;
    }
    P.inv_p1 = acc;
  }
  P.k = k;
  P.R = R;
  P.scale = scale;
  const unsigned blocks = (unsigned)((n + K2_THREADS - 1) / K2_THREADS);
  reconstruct_kernel<<<blocks, K2_THREADS, 0, (cudaStream_t)stream>>>(
      shares, out, n, P, decode);
  return (int)cudaGetLastError();
}
