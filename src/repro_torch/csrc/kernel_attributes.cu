// The one C export of the compiled kernels' attributes
// (kernel_attributes.cuh): every instantiation of K1-K8b in one array.
#include "kernel_attributes.cuh"

// Write the records into out[0 .. cap) and return how many there are
// (more than cap: nothing written), or a negative cudaError_t.
extern "C" int repro_kernel_attributes(ReproKernelAttr* out, int cap) {
  int (*const sources[])(ReproKernelAttr*, int*) = {
      repro_k1_attributes,        repro_k2_attributes,
      repro_k3_attributes,        repro_k4_attributes,
      repro_k5_attributes,        repro_k6_attributes,
      repro_flash_fwd_attributes, repro_flash_bwd_attributes};
  int total = 0, err = 0;
  for (auto fn : sources) total += fn(nullptr, &err);
  if (out == nullptr || total > cap) return total;
  int at = 0;
  for (auto fn : sources) at += fn(out + at, &err);
  return err ? -err : total;
}
