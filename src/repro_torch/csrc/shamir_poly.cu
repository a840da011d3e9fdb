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
// Any threshold and any number of points.  Up to 16 points travel in the
// parameter struct (the protocol's sizes: the struct path, as fast as a
// launch gets); more arrive as a device table the wrapper uploads once per
// point set (the table path), which each block stages into dynamic shared
// memory when it fits the default 48 KB (12,288 points) and otherwise
// reads where it lies.  The two paths are two instantiations.
//
// What bounds it on the H100: bytes.  Each element reads 8 B of payload
// and R*(t-1)*4 B of coefficients and writes len(points)*R*4 B of shares.
// The arithmetic is a few reductions a share, and every one is a Barrett
// reduction (csrc/field_arith.cuh): Hopper has no integer divider, and the
// 64-bit `%` this kernel used to run was an emulated sequence that left it
// at ~10x its bound.  The operands are |s| <= max_signed < 2^62 for the
// encode and acc * j + c < 2^31 * 2^31 + 2^31 < 2^63 for a Horner step
// (acc and c reduced, each point j <= w < min(p) < 2^31), so every operand
// fits 64 bits whatever t and w are.  The TPU kernel's
// 16-bit-limb mulmod and float hi/lo split existed only because the TPU
// vector unit has no 64-bit integer multiply; Hopper has one.
//
// Design: a thread takes four consecutive elements at a time, so the
// payload, each coefficient row and each share row move as 16-byte
// accesses (plain ones when a pointer is not 16-byte aligned; the element
// count is a multiple of 128, so a group is never cut), in a grid-stride
// loop whose grid comes from the SM count.  The first Horner step, c_{t-2}
// mod p, does not depend on the point and runs once a residue; each later
// step reads its coefficient row in the Horner loop (the L1 cache serves
// the later points), so no dynamically indexed array spills to local
// memory.  At t = 2 (every path of the protocol) that loop runs no step.
//
// Bit parity with the JAX kernel: rint() rounds half to even like
// jnp.round (CUDA's round() would round ties away from zero).  An f32
// payload is scaled, rounded and clipped in f32 against (float)lim, as
// jnp.clip(jnp.round(x * scale), -lim, lim) does for f32 x, and only then
// widened.  lim is float(max_signed) from the host, the same double the JAX
// kernel clips against.
#include <cuda_runtime.h>

#include "field_arith.cuh"
#include "kernel_attributes.cuh"

#define K1_MAX_R 2
#define K1_THREADS 128
// points in the parameter struct (the struct path)
#define K1_STRUCT_POINTS 16
// points staged in shared memory: the default dynamic limit, 48 KB
#define K1_STAGE_POINTS 12288

struct K1Params {
  Barrett mod[K1_MAX_R];
  unsigned points[K1_STRUCT_POINTS];  // the struct path's points
  int npoints;
  int R;
  int tm1;    // t - 1 coefficients per residue
  int vec;    // every pointer 16-byte aligned
  int stage;  // the points fit shared memory
  double lim;
  double scale;
};

__device__ __forceinline__ long long encode_value(double x, double scale,
                                                  double lim) {
  double s = rint(x * scale);
  s = fmin(fmax(s, -lim), lim);
  return (long long)s;
}

__device__ __forceinline__ long long encode_value(float x, double scale,
                                                  double lim) {
  const float flim = (float)lim;
  float s = rintf(x * (float)scale);
  s = fminf(fmaxf(s, -flim), flim);
  return (long long)(double)s;
}

// A coefficient as the field arithmetic takes it (int32 -> 64 bits).
__device__ __forceinline__ unsigned long long coeff64(int c) {
  return (unsigned long long)(long long)c;
}

template <typename T, bool kTable>
__global__ void __launch_bounds__(K1_THREADS, 8)
encode_share_kernel(const T* __restrict__ x, const int* __restrict__ coeffs,
                    const unsigned* __restrict__ point_table,
                    int* __restrict__ out, long long n, K1Params P) {
  // the points in shared memory (the table's when they fit, else read
  // from the table): never a parameter-struct array indexed at run time,
  // which the compiler would copy to a stack frame in every thread
  __shared__ unsigned struct_points[kTable ? 1 : K1_STRUCT_POINTS];
  extern __shared__ unsigned staged_points[];
  const unsigned* points;
  if constexpr (kTable) {
    points = point_table;
    if (P.stage) {
      for (int o = threadIdx.x; o < P.npoints; o += K1_THREADS)
        staged_points[o] = point_table[o];
      __syncthreads();
      points = staged_points;
    }
  } else {
    if (threadIdx.x == 0) {
#pragma unroll
      for (int o = 0; o < K1_STRUCT_POINTS; ++o)
        struct_points[o] = P.points[o];
    }
    __syncthreads();
    points = struct_points;
  }
  const bool vec = P.vec != 0;
  const int tm1 = P.tm1;
  const long long groups = n >> 2;
  for (long long g = (long long)blockIdx.x * K1_THREADS + threadIdx.x;
       g < groups; g += (long long)gridDim.x * K1_THREADS) {
    const long long e = g << 2;
    T xv[4];
    load4(x + e, vec, xv);
    unsigned long long mag[4];
    bool neg[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const long long s = encode_value(xv[v], P.scale, P.lim);
      neg[v] = s < 0;
      mag[v] = neg[v] ? (unsigned long long)(-s) : (unsigned long long)s;
    }
#pragma unroll
    for (int r = 0; r < K1_MAX_R; ++r) {
      if (r >= P.R) break;
      const Barrett m = P.mod[r];
      unsigned secret[4], top[4];
      const int* c = coeffs + (long long)r * tm1 * n + e;
      int ct[4] = {0, 0, 0, 0};  // t = 1: no coefficients, the share is s
      if (tm1 > 0) load4(c + (long long)(tm1 - 1) * n, vec, ct);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const unsigned sm = barrett_reduce(mag[v], m);
        secret[v] = (neg[v] && sm) ? m.p - sm : sm;
        top[v] = barrett_reduce(coeff64(ct[v]), m);  // the first Horner step
      }
      for (int o = 0; o < P.npoints; ++o) {
        const unsigned long long j = points[o];
        unsigned acc[4] = {top[0], top[1], top[2], top[3]};
        for (int k = tm1 - 2; k >= 0; --k) {
          int ck[4];
          load4(c + (long long)k * n, vec, ck);
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[v] = barrett_reduce(acc[v] * j + coeff64(ck[v]), m);
        }
        unsigned share[4];
#pragma unroll
        for (int v = 0; v < 4; ++v)
          share[v] = barrett_reduce(acc[v] * j + secret[v], m);
        store4(out + (long long)(o * P.R + r) * n + e, vec, share);
      }
    }
  }
}

template <typename T, bool kTable>
static int launch(const T* x, const int* coeffs, const unsigned* table,
                  int* out, long long n, const K1Params& P, cudaStream_t st) {
  static FieldGrid grid;
  const unsigned blocks = grid.blocks(
      (const void*)encode_share_kernel<T, kTable>, K1_THREADS, n >> 2);
  const size_t smem = P.stage ? (size_t)P.npoints * sizeof(unsigned) : 0;
  encode_share_kernel<T, kTable><<<blocks, K1_THREADS, smem, st>>>(
      x, coeffs, table, out, n, P);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const T* x, const int* coeffs, const unsigned* table,
                  int* out, long long n, const K1Params& P, cudaStream_t st) {
  return table ? launch<T, true>(x, coeffs, table, out, n, P, st)
               : launch<T, false>(x, coeffs, table, out, n, P, st);
}

// barrett: (mu, p) per residue, from kernels/field_consts.py (host);
// points: npoints public evaluation points, each in [1, min(p)): a host
// array of up to 16 (the struct path, with table null), or beside it the
// same points as a device table (the table path, any count)
extern "C" int repro_k1_encode_share(const void* x, int x_is_f64,
                                     const int* coeffs, int* out, long long n,
                                     int R, int tm1,
                                     const unsigned long long* barrett,
                                     const int* points,
                                     const unsigned* table, int npoints,
                                     double lim, double scale, void* stream) {
  if (R < 1 || R > K1_MAX_R || tm1 < 0 || npoints < 1 || n < 0 ||
      n % 4 != 0 || (table == nullptr && npoints > K1_STRUCT_POINTS))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  K1Params P;
  for (int r = 0; r < R; ++r) {
    P.mod[r].mu = barrett[2 * r];
    P.mod[r].p = (unsigned)barrett[2 * r + 1];
  }
  for (int o = 0; o < K1_STRUCT_POINTS; ++o)
    P.points[o] = !table && o < npoints ? (unsigned)points[o] : 0u;
  P.npoints = npoints;
  P.R = R;
  P.tm1 = tm1;
  P.vec = aligned16(x) && (tm1 == 0 || aligned16(coeffs)) && aligned16(out);
  P.stage = table && npoints <= K1_STAGE_POINTS;
  P.lim = lim;
  P.scale = scale;
  cudaStream_t st = (cudaStream_t)stream;
  return x_is_f64 ? launch((const double*)x, coeffs, table, out, n, P, st)
                  : launch((const float*)x, coeffs, table, out, n, P, st);
}

// K1's instantiations (kernel_attributes.cuh): the table path at the most
// points it stages
int repro_k1_attributes(ReproKernelAttr* out, int* err) {
  constexpr int staged = K1_STAGE_POINTS * (int)sizeof(unsigned);
  REPRO_ATTR(0, "K1 f32 struct", (encode_share_kernel<float, false>),
             K1_THREADS, 0);
  REPRO_ATTR(1, "K1 f32 table", (encode_share_kernel<float, true>),
             K1_THREADS, staged);
  REPRO_ATTR(2, "K1 f64 struct", (encode_share_kernel<double, false>),
             K1_THREADS, 0);
  REPRO_ATTR(3, "K1 f64 table", (encode_share_kernel<double, true>),
             K1_THREADS, staged);
  return 4;
}
