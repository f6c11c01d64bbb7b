// cudaFuncGetAttributes figures of a source's kernels, for its C entry
// esp_<source>_resources(out, names, cap): four ints a kernel into out
// (registers, local bytes, static shared bytes, the largest block) and
// its name into names, for at most cap kernels.  Returns the number of
// kernels, or minus the CUDA error.

#pragma once

#include <cuda_runtime.h>

inline int kernel_resources(const void* const* fns,
                            const char* const* kernel_names, int k,
                            int* out, const char** names, int cap) {
  if (k > cap) return -(int)cudaErrorInvalidValue;
  for (int i = 0; i < k; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fns[i]);
    if (e != cudaSuccess) return -(int)e;
    out[4 * i + 0] = a.numRegs;
    out[4 * i + 1] = (int)a.localSizeBytes;
    out[4 * i + 2] = (int)a.sharedSizeBytes;
    out[4 * i + 3] = a.maxThreadsPerBlock;
    names[i] = kernel_names[i];
  }
  return k;
}
