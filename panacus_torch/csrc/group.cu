// Group-resolved scans over the packed membership matrix: ordered growth
// and pairwise group similarity.
//
// Replaces the XLA programs of panacus_tpu/ops/engine.py:
//   pt_ordered_growth  <- _ordered_growth_all / _ordered_growth_block_body /
//                         ordered_growth (engine.py:212-294)
//   pt_similarity      <- _sim_block_int / _sim_all /
//                         similarity_intersections (engine.py:302-383)
//
// M is uint32 [n_words, n_items_pad]: bit g % 32 of M[g / 32, i] is set when
// item i lies on a path of group g (groups in path order). W is int32
// [n_items_pad] (item weights, 0 for the sentinel and the padding).
//
// Ordered growth: at group position j, item i adds W[i] to out[j] when
//   cum_i(j) >= max(thr[g] over present g <= j)  and  cum_i(j) >= 1
//   and cov_i >= c_min,
// with cum_i(j) the number of present groups <= j and thr[g] =
// ceil((g + 1) * quorum) from the host (never recomputed here in float32).
// Whether item i counts changes only at its present groups, so a thread walks
// the set bits of its item (__ffs) and records each switch as +W / -W in a
// difference array over the groups; a second one-block kernel turns the
// differences into out by a prefix sum. With quorum 0 that is one update per
// item. What bounds it: one read of M (4 * n_words bytes per item, coalesced
// along items) plus one step per set bit; the difference array is int64 in
// shared memory, flushed with one global atomic per non-zero entry, or kept
// in global memory where n_groups * 8 bytes exceed what a block may opt into.
// The TPU version's [G, B] int32 temporaries, block-size policy and group cap
// have no counterpart here.
//
// Similarity: S[g, h] = sum_i W[i] * P[g, i] * P[h, i], exact in int64. A
// word row of M holds exactly 32 groups, so a block of 32 x 32 threads owns
// the tile of the word pair (a, b), a <= b, over one slice of the items.
// Items are staged through shared memory; thread (g, h) adds W[i] when bit g
// of M[a, i] and bit h of M[b, i] are both set. A warp shares g, so the test
// of bit g is uniform across the warp and skips the items group g lacks. Each
// thread ends with one global atomic into S[32a + g, 32b + h] and, off the
// diagonal tiles, one into the mirrored S[32b + h, 32a + g]. What bounds it:
// the integer work, n_words^2 / 2 * n_items * 1024 thread-steps; M is read
// once per tile pair. Exact for weights below 2^31 and totals below 2^63,
// with none of the TPU version's 16-bit weight halves or lo/hi planes.
//
// Plain C interface (bound with ctypes); every entry point returns the
// cudaError_t of its launches. Kernels run on the caller's stream and
// allocate nothing.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr int kTile = 32;               // groups per word: the tile edge
constexpr int kStage = kTile * kTile;   // items staged per step, one a thread

__device__ __forceinline__ void add_signed(unsigned long long* p, int64_t v) {
  atomicAdd(p, (unsigned long long)v);  // two's complement: wraps to v's sum
}

__global__ void ordered_diff_kernel(const uint32_t* __restrict__ M,
                                    int64_t n_words, int64_t n_items_pad,
                                    int n_groups,
                                    const int32_t* __restrict__ W,
                                    const int32_t* __restrict__ thr, int c_min,
                                    unsigned long long* diff,
                                    int shared_diff) {
  extern __shared__ unsigned long long sdiff[];
  unsigned long long* acc = shared_diff ? sdiff : diff;
  if (shared_diff) {
    for (int k = threadIdx.x; k < n_groups; k += blockDim.x) sdiff[k] = 0ull;
    __syncthreads();
  }
  // bits past n_groups in the last word are not groups
  const uint32_t last_mask =
      (n_groups % 32) ? ((1u << (n_groups % 32)) - 1u) : 0xFFFFFFFFu;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_items_pad; i += step) {
    const int32_t w = __ldg(W + i);
    if (w == 0) continue;
    if (c_min > 1) {  // c_min <= 1 is implied by cum >= 1
      int cov = 0;
      for (int64_t wd = 0; wd < n_words; ++wd) {
        uint32_t m = __ldg(M + wd * n_items_pad + i);
        if (wd == n_words - 1) m &= last_mask;
        cov += __popc(m);
      }
      if (cov < c_min) continue;
    }
    int cum = 0, t = -1;
    bool ok = false;
    for (int64_t wd = 0; wd < n_words; ++wd) {
      uint32_t m = __ldg(M + wd * n_items_pad + i);
      if (wd == n_words - 1) m &= last_mask;
      while (m) {
        const int g = (int)(wd * 32) + __ffs(m) - 1;
        m &= m - 1u;
        ++cum;
        t = max(t, __ldg(thr + g));
        const bool now = cum >= t;
        if (now != ok) {
          add_signed(acc + g, now ? (int64_t)w : -(int64_t)w);
          ok = now;
        }
      }
    }
  }
  if (shared_diff) {
    __syncthreads();
    for (int k = threadIdx.x; k < n_groups; k += blockDim.x) {
      const unsigned long long s = sdiff[k];
      if (s != 0ull) atomicAdd(diff + k, s);
    }
  }
}

// out[j] = sum_{g <= j} diff[g], by one block: each thread sums a contiguous
// chunk, the block scans the chunk sums, each thread writes its chunk.
__global__ void __launch_bounds__(kScanThreads)
    prefix_sum_kernel(const unsigned long long* __restrict__ diff, int n,
                      long long* __restrict__ out) {
  __shared__ unsigned long long part[kScanThreads];
  const int chunk = (n + kScanThreads - 1) / kScanThreads;
  const int lo = threadIdx.x * chunk;
  const int hi = min(lo + chunk, n);
  unsigned long long s = 0ull;
  for (int k = lo; k < hi; ++k) s += diff[k];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const unsigned long long v =
        threadIdx.x >= off ? part[threadIdx.x - off] : 0ull;
    __syncthreads();
    part[threadIdx.x] += v;
    __syncthreads();
  }
  unsigned long long run = part[threadIdx.x] - s;  // exclusive prefix
  for (int k = lo; k < hi; ++k) {
    run += diff[k];
    out[k] = (long long)run;
  }
}

__global__ void __launch_bounds__(kStage)
    similarity_kernel(const uint32_t* __restrict__ M, int64_t n_words,
                      int64_t n_items_pad, const int32_t* __restrict__ W,
                      int64_t slice, unsigned long long* out) {
  __shared__ uint4 stage[kStage];  // (M[a, i], M[b, i], W[i], 0)
  // blockIdx.x enumerates the word pairs a <= b row by row
  int64_t a = 0, k = blockIdx.x;
  while (k >= n_words - a) {
    k -= n_words - a;
    ++a;
  }
  const int64_t b = a + k;
  const int g = threadIdx.y, h = threadIdx.x;  // a warp shares g
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int64_t lo = (int64_t)blockIdx.y * slice;
  const int64_t hi = lo + slice < n_items_pad ? lo + slice : n_items_pad;
  const uint32_t* Ma = M + a * n_items_pad;
  const uint32_t* Mb = M + b * n_items_pad;
  long long acc = 0;
  for (int64_t base = lo; base < hi; base += kStage) {
    const int64_t i = base + tid;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i < hi) {
      v.z = (uint32_t)__ldg(W + i);
      if (v.z != 0u) {
        v.x = __ldg(Ma + i);
        v.y = __ldg(Mb + i);
      }
    }
    __syncthreads();  // the previous stage is consumed
    stage[tid] = v;
    __syncthreads();
    const int n_here = hi - base < kStage ? (int)(hi - base) : kStage;
    for (int j = 0; j < n_here; ++j) {
      const uint4 s = stage[j];
      if ((s.x >> g) & 1u) {
        if ((s.y >> h) & 1u) acc += (long long)(int32_t)s.z;
      }
    }
  }
  if (acc != 0) {
    const int64_t gp = n_words * kTile;
    const int64_t r = a * kTile + g, c = b * kTile + h;
    atomicAdd(out + r * gp + c, (unsigned long long)acc);
    if (a != b) atomicAdd(out + c * gp + r, (unsigned long long)acc);
  }
}

}  // namespace

extern "C" {

// out[j] for j < n_groups: the ordered growth of M under the per-position
// thresholds thr (int32 [n_groups]) and coverage floor c_min. diff is int64
// [n_groups] scratch that the caller zeroes; out is int64 [n_groups].
int pt_ordered_growth(const void* M, long long n_words, long long n_items_pad,
                      int n_groups, const void* W, const void* thr, int c_min,
                      void* diff, void* out, void* stream) {
  if (n_groups < 1 || n_words != (n_groups + 31) / 32 || n_items_pad < 0) {
    return (int)cudaErrorInvalidValue;
  }
  int optin = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return (int)e;
  const size_t diff_bytes = (size_t)n_groups * sizeof(unsigned long long);
  const int shared_diff = diff_bytes <= (size_t)optin;
  const size_t smem = shared_diff ? diff_bytes : 0;
  e = allow_smem((const void*)ordered_diff_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_items_pad > 0) {
    int blocks = 0;
    e = grid_size((const void*)ordered_diff_kernel, kThreads, smem,
                  n_items_pad, &blocks);
    if (e != cudaSuccess) return (int)e;
    ordered_diff_kernel<<<blocks, kThreads, smem, s>>>(
        (const uint32_t*)M, n_words, n_items_pad, n_groups, (const int32_t*)W,
        (const int32_t*)thr, c_min, (unsigned long long*)diff, shared_diff);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  prefix_sum_kernel<<<1, kScanThreads, 0, s>>>(
      (const unsigned long long*)diff, n_groups, (long long*)out);
  return (int)cudaGetLastError();
}

// out[g, h] += sum_i W[i] * P[g, i] * P[h, i] for g, h < 32 * n_words; out
// is int64 [32 * n_words, 32 * n_words] and must be zeroed by the caller.
int pt_similarity(const void* M, long long n_words, long long n_items_pad,
                  const void* W, void* out, void* stream) {
  if (n_words < 1 || n_items_pad < 0) return (int)cudaErrorInvalidValue;
  if (n_items_pad == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_pairs = n_words * (n_words + 1) / 2;
  const int64_t n_stages = (n_items_pad + kStage - 1) / kStage;
  // slice the items so that about 8 blocks per SM are in flight overall
  int64_t n_slices = ((int64_t)8 * sms + n_pairs - 1) / n_pairs;
  if (n_slices > n_stages) n_slices = n_stages;
  if (n_slices < 1) n_slices = 1;
  const int64_t slice =
      (n_stages + n_slices - 1) / n_slices * (int64_t)kStage;
  n_slices = (n_items_pad + slice - 1) / slice;
  if (n_pairs > 0x7FFFFFFF || n_slices > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  similarity_kernel<<<dim3((unsigned)n_pairs, (unsigned)n_slices),
                      dim3(kTile, kTile), 0, (cudaStream_t)stream>>>(
      (const uint32_t*)M, n_words, n_items_pad, (const int32_t*)W, slice,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
