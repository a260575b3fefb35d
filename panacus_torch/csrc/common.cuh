// Launch helpers shared by the kernel sources of panacus_torch/csrc.
// Each source is built into its own library, so each gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Blocks for a grid-stride launch over n_units work units of `threads`
// threads each: enough to fill every SM at the occupancy the kernel reaches
// with `smem` bytes of dynamic shared memory, never more than the work.
cudaError_t grid_size(const void* kernel, int threads, size_t smem,
                      int64_t n_units, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) per_sm = 1;
  const int64_t want = (n_units + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * per_sm;
  *blocks = (int)(want < cap ? want : cap);
  return cudaSuccess;
}

// Opt a kernel into `smem` bytes of dynamic shared memory where that is
// more than the 48 KB every kernel gets without asking.
cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// The shared memory a block of the current device may opt into.
cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev);
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
