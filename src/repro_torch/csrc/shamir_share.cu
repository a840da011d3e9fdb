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
// the arithmetic is t-1 + w reductions, each a 64-bit multiply-high and
// two 32-bit multiplies.  Hopper has no integer divider: a 64-bit `%` (or
// `/`) by a run-time value is an emulated sequence (a float reciprocal,
// its refinement and a call to the remainder routine).  Every reduction
// here is Barrett's (csrc/field_arith.cuh), from (mu, p) the host
// computed, and the kernel has no `%` or `/`, its index arithmetic
// included.  The Horner operand acc * j + c stays below 2^62 + 2^31 (acc
// < p < 2^31, j <= w < min(p) < 2^31, c < 2^31), and Barrett is exact for
// any 64-bit operand, so any threshold and any share count work.  The TPU
// kernel's 16-bit-limb mulmod31 existed only because the TPU vector unit
// has no 64-bit integer multiply; Hopper has one.
//
// Design: a thread takes two consecutive elements of every residue row in
// a grid-stride loop whose grid comes from the SM count, so no index is
// divided to find a residue: the residue loop is unrolled and stops at R,
// and each residue's constants are read at a compile-time index (indexing
// the parameter struct at run time would copy it to a stack frame in every
// thread).  The first Horner step, c_{t-2} mod p, does not depend on the
// point and runs once a residue; each later step reads its coefficient row
// in the Horner loop (the L1 cache serves the later points), so no local
// array holds the coefficients.  At t = 2 that loop runs no step.  A
// reduced secret fits 31 bits and is kept in one register.  Two elements
// a thread rather than K1's four keep the registers under the launch
// bounds' limit (eight blocks of 128 an SM) with room to spare.
//
// Rows move as 16-byte accesses.  n is any size, so the last pair of a row
// may hold one element, and row r of a tensor starts at element r n: when
// n is odd, consecutive rows differ in 16-byte alignment.  So each access
// decides from its own address (load2/store2 in field_arith.cuh): one
// 16-byte access where it is 16-byte aligned, else two 8-byte ones.
//
// Inputs must be reduced (0 <= value < p_r), as the JAX ops.shamir_shares
// requires; the wrapper checks shapes, types and the residue limit below
// (a field has at most K4_MAX_R residues).
#include <cuda_runtime.h>

#include "field_arith.cuh"
#include "kernel_attributes.cuh"

#define K4_MAX_R 8
#define K4_THREADS 128

struct K4Params {
  Barrett mod[K4_MAX_R];
  int R;
  int tm1;  // t - 1 coefficients per residue
  int w;    // shares: points 1..w
};

__global__ void __launch_bounds__(K4_THREADS, 8)
leafwise_share_kernel(const long long* __restrict__ secret,
                      const long long* __restrict__ coeffs,
                      long long* __restrict__ out, long long n, K4Params P) {
  const int tm1 = P.tm1;
  const long long pairs = (n + 1) >> 1;
  for (long long g = (long long)blockIdx.x * K4_THREADS + threadIdx.x;
       g < pairs; g += (long long)gridDim.x * K4_THREADS) {
    const long long e = g << 1;
    const int cnt = n - e < 2 ? 1 : 2;  // elements of the pair
#pragma unroll
    for (int r = 0; r < K4_MAX_R; ++r) {
      if (r >= P.R) break;
      const Barrett m = P.mod[r];
      const long long* c = coeffs + (long long)r * tm1 * n + e;
      long long sv[2], ct[2] = {0, 0};  // t = 1: the share is s
      load2(secret + (long long)r * n + e, cnt, sv);
      if (tm1 > 0) load2(c + (long long)(tm1 - 1) * n, cnt, ct);
      const unsigned s[2] = {(unsigned)sv[0], (unsigned)sv[1]};
      const unsigned top[2] = {  // the first Horner step
          barrett_reduce((unsigned long long)ct[0], m),
          barrett_reduce((unsigned long long)ct[1], m)};
      for (int j = 1; j <= P.w; ++j) {
        const unsigned long long x = (unsigned long long)j;
        unsigned acc[2] = {top[0], top[1]};
        for (int k = tm1 - 2; k >= 0; --k) {
          long long ck[2];
          load2(c + (long long)k * n, cnt, ck);
#pragma unroll
          for (int v = 0; v < 2; ++v)
            acc[v] = barrett_reduce(acc[v] * x + (unsigned long long)ck[v],
                                    m);
        }
        long long share[2];
#pragma unroll
        for (int v = 0; v < 2; ++v)
          share[v] = barrett_reduce(acc[v] * x + s[v], m);
        store2(out + ((long long)(j - 1) * P.R + r) * n + e, cnt, share);
      }
    }
  }
}

// barrett: (mu, p) per residue, from kernels/field_consts.py
extern "C" int repro_k4_share(const long long* secret, const long long* coeffs,
                              long long* out, long long n, int R, int tm1,
                              const unsigned long long* barrett, int w,
                              void* stream) {
  if (R < 1 || R > K4_MAX_R || tm1 < 0 || w < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  K4Params P;
  for (int r = 0; r < R; ++r) {
    P.mod[r].mu = barrett[2 * r];
    P.mod[r].p = (unsigned)barrett[2 * r + 1];
  }
  P.R = R;
  P.tm1 = tm1;
  P.w = w;
  static FieldGrid grid;
  const unsigned blocks = grid.blocks((const void*)leafwise_share_kernel,
                                      K4_THREADS, (n + 1) >> 1);
  leafwise_share_kernel<<<blocks, K4_THREADS, 0, (cudaStream_t)stream>>>(
      secret, coeffs, out, n, P);
  return (int)cudaGetLastError();
}

// K4's one instantiation (kernel_attributes.cuh)
int repro_k4_attributes(ReproKernelAttr* out, int* err) {
  REPRO_ATTR(0, "K4", leafwise_share_kernel, K4_THREADS, 0);
  return 1;
}
