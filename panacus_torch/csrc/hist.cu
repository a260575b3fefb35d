// Coverage and coverage histogram over the packed membership matrix.
//
// Replaces panacus_tpu/ops/pallas_kernels.py:fused_hist_tpu (the Pallas
// TPU kernel, with _fused_hist_kernel and _coverage_reduce) and the XLA
// program panacus_tpu/ops/engine.py:coverage_from_membership.
//
// M is uint32 [n_words, n_items_pad]: bit g % 32 of M[g / 32, i] is set when
// item i lies on a path of group g. Per item, cov_i = sum_w popcount(M[w, i]).
// Per weight vector v, H_v[b] = sum over items with cov_i == b of W[v, i],
// exact in int64; items whose coverage is >= n_bins are dropped.
//
// What bounds it on Hopper: one read of M from HBM (4 * n_words bytes per
// item) plus 4 bytes per item per weight vector; the popcounts are cheap.
// Each thread takes 4 neighbouring items with 16-byte loads, so a warp
// reads 512 contiguous bytes of a row per word (coalesced).
// - Where the 8 warps' histograms fit in 48 KB (n_vecs * n_bins * 64
//   bytes: up to 384 bins for two vectors; the path's 90 groups take 184),
//   fused_hist_warp_kernel gives every warp its own histograms as 32-bit
//   limb sums (the 16-bit halves of the weights) in shared memory, added
//   with native shared atomics (ATOMS.ADD; an int64 shared atomicAdd is a
//   compare-and-swap loop on Hopper). A thread takes at most 256 steps of
//   the grid stride, so no limb sum leaves 32 bits. The first two weight
//   rows are read beside M, not after the coverage loop: one trip to
//   memory an item in place of two. At three words an item that decides
//   the time, not the atomics: a copy without any atomics runs no faster
//   (PERF.md).
// - Else fused_hist_kernel: one int64 histogram a block in shared
//   memory (shared atomics), or, past the shared memory a block may opt
//   into, the output itself (global atomics).
// A block flushes its non-zero bins into the zeroed int64 output with one
// global atomic each. There is no bin cap and no weight cap: weights are
// int32, sums int64.
//
// Plain C interface (bound with ctypes); every entry point returns the
// cudaError_t of its launch. Kernels run on the caller's stream and
// allocate nothing.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerThread = 4;  // one uint4 / int4 load per row

__device__ __forceinline__ uint4 coverage4(const uint32_t* __restrict__ M,
                                           int64_t n_words, int64_t n_quads,
                                           int64_t q) {
  const uint4* p = reinterpret_cast<const uint4*>(M) + q;
  uint4 c = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t w = 0; w < n_words; ++w) {
    const uint4 m = __ldg(p + w * n_quads);
    c.x += __popc(m.x);
    c.y += __popc(m.y);
    c.z += __popc(m.z);
    c.w += __popc(m.w);
  }
  return c;
}

__global__ void coverage_kernel(const uint32_t* __restrict__ M,
                                int64_t n_words, int64_t n_quads,
                                int32_t* __restrict__ cov) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       q < n_quads; q += step) {
    const uint4 c = coverage4(M, n_words, n_quads, q);
    reinterpret_cast<int4*>(cov)[q] =
        make_int4((int)c.x, (int)c.y, (int)c.z, (int)c.w);
  }
}

constexpr int kWarps = kThreads / 32;
constexpr int kPrivateBytes = 48 * 1024;  // per-warp limb histograms up to this
// grid-stride steps of a thread at most, where warps keep 32-bit limbs: a
// limb then takes at most 32 lanes x 4 items x 256 steps = 2^15 weights
// (each lo limb below 2^16, each hi limb in [-2^15, 2^15)), so neither sum
// leaves 32 bits
constexpr int64_t kMaxSteps = 256;

__device__ __forceinline__ void add_bin(unsigned long long* h, int n_bins,
                                        uint32_t c, int32_t w) {
  if (w != 0 && c < (uint32_t)n_bins) {
    atomicAdd(h + c, (unsigned long long)(long long)w);
  }
}

// One int64 histogram per block in shared memory (shared_hist) or the
// output itself.
__global__ void fused_hist_kernel(const uint32_t* __restrict__ M,
                                  int64_t n_words, int64_t n_quads,
                                  const int32_t* __restrict__ W, int n_vecs,
                                  int n_bins, unsigned long long* out,
                                  int shared_hist) {
  extern __shared__ unsigned long long shist[];
  const int n_acc = n_vecs * n_bins;
  unsigned long long* acc = shared_hist ? shist : out;
  if (shared_hist) {
    for (int k = threadIdx.x; k < n_acc; k += blockDim.x) shist[k] = 0ull;
    __syncthreads();
  }
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       q < n_quads; q += step) {
    const uint4 c = coverage4(M, n_words, n_quads, q);
    for (int v = 0; v < n_vecs; ++v) {
      const int4 w =
          __ldg(reinterpret_cast<const int4*>(W) + (int64_t)v * n_quads + q);
      unsigned long long* h = acc + (int64_t)v * n_bins;
      add_bin(h, n_bins, c.x, w.x);
      add_bin(h, n_bins, c.y, w.y);
      add_bin(h, n_bins, c.z, w.z);
      add_bin(h, n_bins, c.w, w.w);
    }
  }
  if (shared_hist) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
      const unsigned long long s = shist[k];
      if (s != 0ull) atomicAdd(out + k, s);
    }
  }
}

// w = hi * 2^16 + lo into the warp's 32-bit limb sums of bin c: native
// shared atomics, no CAS loop.
__device__ __forceinline__ void add_limbs(uint32_t* lo, int n_acc, int n_bins,
                                          uint32_t c, int32_t w) {
  if (w != 0 && c < (uint32_t)n_bins) {
    atomicAdd(lo + c, (uint32_t)w & 0xFFFFu);
    if (w >> 16) atomicAdd(lo + n_acc + c, (uint32_t)(w >> 16));
  }
}

// Each warp its own limb sums in shared memory: n_acc lo limbs, then n_acc
// hi limbs. At most kMaxSteps grid-stride steps a thread.
__global__ void __launch_bounds__(kThreads)
    fused_hist_warp_kernel(const uint32_t* __restrict__ M, int64_t n_words,
                           int64_t n_quads, const int32_t* __restrict__ W,
                           int n_vecs, int n_bins, unsigned long long* out) {
  extern __shared__ uint32_t limbs[];
  const int n_acc = n_vecs * n_bins;
  for (int k = threadIdx.x; k < 2 * kWarps * n_acc; k += blockDim.x) limbs[k] = 0u;
  __syncthreads();
  uint32_t* lo = limbs + (threadIdx.x >> 5) * 2 * n_acc;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  const int4* W4 = reinterpret_cast<const int4*>(W);
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       q < n_quads; q += step) {
    // the first two weight rows are read beside M, not after it
    const int4 w0 = __ldg(W4 + q);
    const int4 w1 = n_vecs > 1 ? __ldg(W4 + n_quads + q) : make_int4(0, 0, 0, 0);
    const uint4 c = coverage4(M, n_words, n_quads, q);
    for (int v = 0; v < n_vecs; ++v) {
      const int4 w = v == 0 ? w0 : v == 1 ? w1 : __ldg(W4 + (int64_t)v * n_quads + q);
      uint32_t* l = lo + v * n_bins;
      add_limbs(l, n_acc, n_bins, c.x, w.x);
      add_limbs(l, n_acc, n_bins, c.y, w.y);
      add_limbs(l, n_acc, n_bins, c.z, w.z);
      add_limbs(l, n_acc, n_bins, c.w, w.w);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_acc; k += blockDim.x) {
    unsigned long long s = 0ull;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t* l = limbs + w * 2 * n_acc;
      s += (unsigned long long)l[k] +
           ((unsigned long long)(long long)(int32_t)l[n_acc + k] << 16);
    }
    if (s != 0ull) atomicAdd(out + k, s);
  }
}

}  // namespace

extern "C" {

// cov[i] = sum_w popcount(M[w, i]) for every i < n_items_pad.
int pt_coverage(const void* M, long long n_words, long long n_items_pad,
                void* cov, void* stream) {
  if (n_words < 0 || n_items_pad < 0 || n_items_pad % kItemsPerThread != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_quads = n_items_pad / kItemsPerThread;
  if (n_quads == 0) return (int)cudaSuccess;
  int blocks = 0;
  cudaError_t e =
      grid_size((const void*)coverage_kernel, kThreads, 0, n_quads, &blocks);
  if (e != cudaSuccess) return (int)e;
  coverage_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)M, n_words, n_quads, (int32_t*)cov);
  return (int)cudaGetLastError();
}

// out[v, b] += sum over items i with cov_i == b of W[v, i]; out is int64
// [n_vecs, n_bins] and must be zeroed by the caller.
int pt_fused_hist(const void* M, long long n_words, long long n_items_pad,
                  const void* W, int n_vecs, int n_bins, void* out,
                  void* stream) {
  if (n_words < 0 || n_items_pad < 0 || n_items_pad % kItemsPerThread != 0 ||
      n_vecs < 1 || n_bins < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_quads = n_items_pad / kItemsPerThread;
  if (n_quads == 0) return (int)cudaSuccess;
  int optin = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes =
      (size_t)n_vecs * (size_t)n_bins * sizeof(unsigned long long);
  cudaStream_t s = (cudaStream_t)stream;
  int blocks = 0;
  if (kWarps * bytes <= (size_t)kPrivateBytes) {
    // per-warp limbs: two 4-byte sums a bin, the int64 bin's size
    const size_t smem = kWarps * bytes;
    e = grid_size((const void*)fused_hist_warp_kernel, kThreads, smem, n_quads, &blocks);
    if (e != cudaSuccess) return (int)e;
    const int64_t least = (n_quads + kThreads * kMaxSteps - 1) / (kThreads * kMaxSteps);
    if (least > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
    if (blocks < least) blocks = (int)least;
    fused_hist_warp_kernel<<<blocks, kThreads, smem, s>>>(
        (const uint32_t*)M, n_words, n_quads, (const int32_t*)W, n_vecs, n_bins,
        (unsigned long long*)out);
    return (int)cudaGetLastError();
  }
  const int shared_hist = bytes <= (size_t)optin;
  const size_t smem = shared_hist ? bytes : 0;
  e = allow_smem((const void*)fused_hist_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  e = grid_size((const void*)fused_hist_kernel, kThreads, smem, n_quads, &blocks);
  if (e != cudaSuccess) return (int)e;
  fused_hist_kernel<<<blocks, kThreads, smem, s>>>(
      (const uint32_t*)M, n_words, n_quads, (const int32_t*)W, n_vecs, n_bins,
      (unsigned long long*)out, shared_hist);
  return (int)cudaGetLastError();
}

}  // extern "C"
