// What the compiler made of each kernel instantiation, for
// kernels/tuning.py's knob model to be held against.
//
// Each source fills one record an instantiation through its
// <source>_attributes() host function, and kernel_attributes.cu's one C
// export, repro_kernel_attributes, puts them together: the name the model
// keys it by, cudaFuncGetAttributes' registers a thread, static shared
// memory, local memory (stack) and maximum threads a block, the dynamic
// shared memory the instantiation's largest launch asks for (the sources'
// own formulas, as their launches compute it), and the blocks an SM that
// cudaOccupancyMaxActiveBlocksPerMultiprocessor allows at those threads
// and that shared memory.  Host code only: no kernel changes.
#pragma once

#include <cuda_runtime.h>

#include <cstdio>

struct ReproKernelAttr {
  char name[48];
  int registers;
  int static_smem;
  int local_bytes;
  int max_threads;
  int dynamic_smem;
  int blocks_per_sm;
};

// Fill *a for kernel ``fn`` launched with ``threads`` a block and ``dyn``
// bytes of dynamic shared memory; returns a cudaError_t.
static inline int repro_fill_attr(ReproKernelAttr* a, const char* name,
                                  const void* fn, int threads, int dyn) {
  snprintf(a->name, sizeof(a->name), "%s", name);
  cudaFuncAttributes f;
  cudaError_t err = cudaFuncGetAttributes(&f, fn);
  if (err != cudaSuccess) return (int)err;
  a->registers = f.numRegs;
  a->static_smem = (int)f.sharedSizeBytes;
  a->local_bytes = (int)f.localSizeBytes;
  a->max_threads = f.maxThreadsPerBlock;
  a->dynamic_smem = dyn;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dyn);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &a->blocks_per_sm, fn, threads, dyn);
}

// each source's instantiations (out may be null: the count alone)
int repro_flash_fwd_attributes(ReproKernelAttr* out, int* err);
int repro_flash_bwd_attributes(ReproKernelAttr* out, int* err);
int repro_k3_attributes(ReproKernelAttr* out, int* err);
int repro_k5_attributes(ReproKernelAttr* out, int* err);
int repro_k6_attributes(ReproKernelAttr* out, int* err);
int repro_k1_attributes(ReproKernelAttr* out, int* err);
int repro_k2_attributes(ReproKernelAttr* out, int* err);
int repro_k4_attributes(ReproKernelAttr* out, int* err);

// record i of a source's list: fill it where out is given, keep the first
// error
#define REPRO_ATTR(i, name, fn, threads, dyn)                             \
  do {                                                                    \
    if (out) {                                                            \
      const int e_ = repro_fill_attr(out + (i), name, (const void*)(fn),  \
                                     threads, dyn);                       \
      if (e_ && !*err) *err = e_;                                         \
    }                                                                     \
  } while (0)
