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
//           signed = x <= (M-1)/2 ? x : x - M;  out = signed * 2^-frac_bits
//
// and emits the (rows, 128) float64 aggregate.  A residues mode instead
// writes the reconstructed residues (R, rows, 128) as int32; it serves
// R = 1 fields and the leaf-wise backend.  The Lagrange weights, the
// Barrett constants and p1^-1 mod p2 are computed on the host (public
// points and moduli).  The constants arrive in the parameter struct, and
// so do the weights up to k = 16 (the struct path, the protocol's sizes);
// past that the R x k weights arrive as a device table the wrapper uploads
// once per (points, moduli) (the table path), which each block stages into
// dynamic shared memory when it fits the default 48 KB (R k <= 6144) and
// otherwise reads where it lies.  The two paths are two instantiations.
//
// What bounds it on the H100: bytes (k*R*4 B in, 8 B out per element) and,
// at the protocol's size (136 x 128 elements), the launch itself.  The
// arithmetic avoids Hopper's emulated 64-bit `%` (csrc/field_arith.cuh).
// The Lagrange sum stays exact for any k: a weight L_i and a share are
// each at most p - 1 < 2^31 - 1, so a term is at most (2^31 - 2)^2 =
// 2^62 - 2^33 + 4, four terms at most 2^64 - 2^35 + 16, and four terms
// plus the reduced running sum (at most 2^31 - 2) stay below 2^64 - 2^34:
// the sum is reduced (Barrett, exact for any 64-bit operand) after every
// group of four terms, ceil(k / 4) times in all; Garner's rec_1 mod p2 and its
// product kd (< 2^62) are Barrett reductions; and the decode multiplies by
// the exact power of two 2^-frac_bits, which gives the quotient's bits.  A thread takes
// four consecutive elements, so shares and outputs move as 16-byte accesses
// (plain ones when a pointer is not 16-byte aligned), in a grid-stride loop
// whose grid comes from the SM count.
#include <cuda_runtime.h>

#include "field_arith.cuh"
#include "kernel_attributes.cuh"

#define K2_MAX_R 2
#define K2_THREADS 128
// shares a reveal of the struct path takes, their weights in the struct
#define K2_STRUCT_K 16
// weights staged in shared memory: the default dynamic limit, 48 KB
#define K2_STAGE_WEIGHTS 6144

struct K2Params {
  Barrett mod[K2_MAX_R];
  unsigned long long lam[K2_MAX_R][K2_STRUCT_K];  // struct path: L_i(0)
  unsigned long long inv_p1;  // p1^-1 mod p2 (Garner), R == 2 only
  unsigned long long M;       // p1 p2, or p1 when R == 1
  unsigned long long half;    // (M - 1) / 2: the largest positive value
  int k;
  int R;
  int vec;           // every pointer 16-byte aligned
  int stage;         // the R k weights fit shared memory
  double inv_scale;  // 2^-frac_bits
};

// lam_table (the table path): L_i(0) mod p_r at [r k + i]
template <bool kTable>
__global__ void __launch_bounds__(K2_THREADS, 8)
reconstruct_kernel(const int* __restrict__ shares,
                   const unsigned long long* __restrict__ lam_table,
                   void* __restrict__ out, long long n, K2Params P,
                   int decode) {
  extern __shared__ unsigned long long staged_lams[];
  const unsigned long long* lams = lam_table;
  if (kTable && P.stage) {
    for (int i = threadIdx.x; i < P.R * P.k; i += K2_THREADS)
      staged_lams[i] = lam_table[i];
    __syncthreads();
    lams = staged_lams;
  }
  const bool vec = P.vec != 0;
  const long long groups = n >> 2;
  for (long long g = (long long)blockIdx.x * K2_THREADS + threadIdx.x;
       g < groups; g += (long long)gridDim.x * K2_THREADS) {
    const long long e = g << 2;
    unsigned rec[K2_MAX_R][4];
#pragma unroll
    for (int r = 0; r < K2_MAX_R; ++r) {
      if (r >= P.R) break;
      const Barrett m = P.mod[r];
      unsigned acc[4] = {0, 0, 0, 0};
      for (int i0 = 0; i0 < P.k; i0 += 4) {
        // a reduced sum (< 2^31) and four terms (< 2^62 each): < 2^64
        unsigned long long sum[4] = {acc[0], acc[1], acc[2], acc[3]};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u;
          if (i >= P.k) break;
          int sh[4];
          load4(shares + (long long)(i * P.R + r) * n + e, vec, sh);
          const unsigned long long lam =
              kTable ? lams[r * P.k + i] : P.lam[r][i];
#pragma unroll
          for (int v = 0; v < 4; ++v)
            sum[v] += lam * (unsigned long long)(long long)sh[v];
        }
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[v] = barrett_reduce(sum[v], m);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) rec[r][v] = acc[v];
    }
    if (!decode) {
#pragma unroll
      for (int r = 0; r < K2_MAX_R; ++r)
        if (r < P.R) store4((int*)out + (long long)r * n + e, vec, rec[r]);
      continue;
    }
    double val[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      unsigned long long x = rec[0][v];
      if (P.R == 2) {
        const unsigned p2 = P.mod[1].p;
        const unsigned r1 = barrett_reduce(rec[0][v], P.mod[1]);
        const unsigned diff0 = rec[1][v] + p2 - r1;  // < 2 p2 < 2^32
        const unsigned diff = diff0 >= p2 ? diff0 - p2 : diff0;
        const unsigned kd = barrett_reduce(diff * P.inv_p1, P.mod[1]);
        x += (unsigned long long)P.mod[0].p * kd;
      }
      const long long value =
          x <= P.half ? (long long)x : -(long long)(P.M - x);
      val[v] = (double)value * P.inv_scale;
    }
    store4((double*)out + e, vec, val);
  }
}

// lams: L_i(0) mod p_r, (R, k) row-major, on the host (the struct path,
// k <= 16, table null), and beside it the same weights as a device table
// (the table path, any k); barrett: (mu, p) per residue and inv_p1 = p1^-1
// mod p2 (host), all from kernels/field_consts.py and
// kernels/shamir_reconstruct.py
extern "C" int repro_k2_reconstruct(const int* shares, void* out, long long n,
                                    int k, int R,
                                    const unsigned long long* lams,
                                    const unsigned long long* table,
                                    const unsigned long long* barrett,
                                    unsigned long long inv_p1, int decode,
                                    double inv_scale, void* stream) {
  if (R < 1 || R > K2_MAX_R || k < 1 || n < 0 || n % 4 != 0 ||
      (table == nullptr && k > K2_STRUCT_K))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  K2Params P;
  for (int r = 0; r < R; ++r) {
    P.mod[r].mu = barrett[2 * r];
    P.mod[r].p = (unsigned)barrett[2 * r + 1];
    for (int i = 0; i < K2_STRUCT_K; ++i)
      P.lam[r][i] = !table && i < k ? lams[r * k + i] : 0;
  }
  const unsigned long long p1 = P.mod[0].p;
  P.inv_p1 = inv_p1;
  P.M = R == 2 ? p1 * P.mod[1].p : p1;
  P.half = (P.M - 1) / 2;
  P.k = k;
  P.R = R;
  P.vec = aligned16(shares) && aligned16(out);
  P.stage = table && (long long)R * k <= K2_STAGE_WEIGHTS;
  P.inv_scale = inv_scale;
  const size_t smem =
      P.stage ? (size_t)R * k * sizeof(unsigned long long) : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (table) {
    static FieldGrid grid;
    const unsigned blocks = grid.blocks(
        (const void*)reconstruct_kernel<true>, K2_THREADS, n >> 2);
    reconstruct_kernel<true><<<blocks, K2_THREADS, smem, st>>>(
        shares, table, out, n, P, decode);
  } else {
    static FieldGrid grid;
    const unsigned blocks = grid.blocks(
        (const void*)reconstruct_kernel<false>, K2_THREADS, n >> 2);
    reconstruct_kernel<false><<<blocks, K2_THREADS, 0, st>>>(
        shares, nullptr, out, n, P, decode);
  }
  return (int)cudaGetLastError();
}

// K2's instantiations (kernel_attributes.cuh): the table path at the most
// weights it stages
int repro_k2_attributes(ReproKernelAttr* out, int* err) {
  REPRO_ATTR(0, "K2 struct", reconstruct_kernel<false>, K2_THREADS, 0);
  REPRO_ATTR(1, "K2 table", reconstruct_kernel<true>, K2_THREADS,
             K2_STAGE_WEIGHTS * (int)sizeof(unsigned long long));
  return 2;
}
