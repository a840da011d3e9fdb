// Field arithmetic of the Shamir kernels: K1 (csrc/shamir_poly.cu), K2
// (csrc/shamir_reconstruct.cu) and K4 (csrc/shamir_share.cu) include it.
//
// Hopper has no integer divider: a 64-bit `%` by a run-time modulus becomes
// a long emulated sequence (a float reciprocal, its refinement and a call
// to the 64-bit remainder routine).  The kernels reduce with Barrett's
// method instead, from two constants a modulus computed on the host
// (kernels/field_consts.py::barrett_constants, passed in each kernel's
// parameter struct), with no `%` and no `/`:
//
//   mu = floor(2^64 / p)                       for 1 < p < 2^31
//   q  = floor(x mu / 2^64)                    (__umul64hi)
//   r  = x - q p,  then r - p if r >= p
//
// For every x < 2^64, q is floor(x / p) or one less: q <= x / p because
// mu <= 2^64 / p, and x mu / 2^64 > x / p - x / 2^64 > x / p - 1, so q >
// floor(x / p) - 2.  So x - q p lies in [0, 2p) and one conditional
// subtraction ends the reduction.  Since 2p <= 2^32, that difference is
// the low 32 bits of x - q p, so it is computed from the low words alone.
// tests/test_torch_field_reduce.py replays these steps on the CPU with the
// same constants, over every operand range the kernels feed in.
//
// Beside the reduction: 16-byte loads and stores of four consecutive
// elements, with plain loads where a pointer is not 16-byte aligned (a
// tensor view may start anywhere), and the grid of a grid-stride
// element-wise kernel sized from the card's SM count.  K4's int64 pairs
// decide from each access's own address and also take a lone element,
// since K4's rows have any length and need not share an alignment.
#pragma once
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

// One modulus p (1 < p < 2^31) and mu = floor(2^64 / p).
struct Barrett {
  unsigned long long mu;
  unsigned p;
};

// x mod p, for any x < 2^64.
__device__ __forceinline__ unsigned barrett_reduce(unsigned long long x,
                                                   const Barrett& m) {
  const unsigned long long q = __umul64hi(x, m.mu);
  const unsigned r = (unsigned)x - (unsigned)q * m.p;  // in [0, 2p)
  return r >= m.p ? r - m.p : r;
}

// -- four consecutive elements: one 16-byte access, or four plain ones ------

__device__ __forceinline__ void load4(const double* p, bool vec,
                                      double v[4]) {
  if (vec) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ void load4(const float* p, bool vec, float v[4]) {
  if (vec) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ void load4(const int* p, bool vec, int v[4]) {
  if (vec) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __ldg(p + i);
  }
}

__device__ __forceinline__ void store4(int* p, bool vec, const unsigned v[4]) {
  if (vec) {
    *reinterpret_cast<int4*>(p) =
        make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = (int)v[i];
  }
}

__device__ __forceinline__ void store4(double* p, bool vec,
                                       const double v[4]) {
  if (vec) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = v[i];
  }
}

__host__ __device__ inline bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

// -- one or two consecutive int64 elements of a row that may start anywhere
// cnt (1 or 2) of them are wanted.  Two move as one 16-byte access where p
// is 16-byte aligned, else as two 8-byte ones; one (a row's ragged tail)
// as one 8-byte access, and the lane past it loads 0.

__device__ __forceinline__ void load2(const long long* p, int cnt,
                                      long long v[2]) {
  if (cnt == 2 && aligned16(p)) {
    const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
    v[0] = a.x; v[1] = a.y;
  } else {
    v[0] = __ldg(p);
    v[1] = cnt == 2 ? __ldg(p + 1) : 0;
  }
}

__device__ __forceinline__ void store2(long long* p, int cnt,
                                       const long long v[2]) {
  if (cnt == 2 && aligned16(p)) {
    *reinterpret_cast<longlong2*>(p) = make_longlong2(v[0], v[1]);
  } else {
    p[0] = v[0];
    if (cnt == 2) p[1] = v[1];
  }
}

// The grid of a grid-stride kernel over `groups` work items, `threads` a
// block: at most as many blocks as the card holds at once (SMs x resident
// blocks an SM), so a small launch fills the card in about one wave and a
// large one loops; the loop's trips are spread evenly (every thread makes
// the same number, give or take one), so no second trip runs with most of
// the card idle.  One FieldGrid a kernel, a static of its launcher: the
// card's capacity for that kernel is read once a device, under a
// std::once_flag, so host threads launching at once read it safely; a
// device index past the table reads it at every launch.
struct FieldGrid {
  static constexpr int kDevices = 64;
  std::once_flag once[kDevices];
  int cap[kDevices] = {};

  static int read_cap(const void* kernel, int threads, int dev) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  0);
    return (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }

  // groups > 0
  unsigned blocks(const void* kernel, int threads, long long groups) {
    int dev = 0;
    cudaGetDevice(&dev);
    int c;
    if (dev >= 0 && dev < kDevices) {
      std::call_once(once[dev],
                     [&] { cap[dev] = read_cap(kernel, threads, dev); });
      c = cap[dev];
    } else {
      c = read_cap(kernel, threads, dev);
    }
    const long long need = (groups + threads - 1) / threads;
    const long long trips = (need + c - 1) / c;
    return (unsigned)((need + trips - 1) / trips);
  }
};
