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

// An asynchronous 16-byte copy from global to shared memory (cp.async);
// with full false it fills the 16 bytes with zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

// Four 8 x 8 b16 matrices from shared memory (ldmatrix): lane l gives the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// d += a * b on the int8 tensor cores: a is the m16 x k32 u8 A fragment
// (row-major), b0 / b1 the k32 x n8 u8 B fragment (column-major), d the
// m16 x n8 int32 accumulator fragment.
__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace

extern "C" const char* pt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
