// The probe kernels: the raw-read control and the hist-formulation probes.
//
// Replaces the Pallas TPU kernels of the measurement scripts:
//   pt_xor_fold   <- bench.py:_xor_read_bw (its `kern` and `run`), the
//                    raw-read ceiling
//   pt_word_fold  <- scripts/kernel_probe.py: pc_only, pcl_only, pcm_only;
//                    scripts/kernel_interleave.py: _simple(_pc_kernel |
//                    _pcx_kernel | _pcm_kernel)
//   pt_limb_hist  <- scripts/kernel_probe.py: coarse, fh2, fhm;
//                    scripts/kernel_interleave.py: _fh2(n_limbs, mxu_cov)
//
// M is uint32 [n_words, n_items] and W int32 [n_vecs, n_items], both
// row-major with n_items a multiple of 4. Every kernel adds `salt` to each
// weight as it reads it (wrapping), the counterpart of the TPU chain's
// `w + i`, without a separate elementwise pass over W.
//
// The folds. The TPU grid walks M in blocks of 16384 items and keeps one
// accumulator per item slot of a block, so item i lands in slot i % 16384:
//   pt_xor_fold:  slot_j = XOR over i = j of (XOR_w M[w, i]) ^ (W[i] + salt),
//                 out = the int32-wrapping sum of the slots as int32 (added
//                 by the last block of each slot window: one launch);
//   pt_word_fold: slot_j = sum over i = j of (cov_i + ((W[i] + salt) & 1)),
//                 int32-wrapping, cov_i = sum_w popc(M[w, i]) (op popcount)
//                 or sum_w M[w, i] (op cast).
// Both XOR and wrapping addition are order-free, so unsigned atomics give
// the TPU's int32 results bit for bit. What bounds them: one read of M and
// W (the work per byte is an XOR or a popcount and an add). A block owns a
// window of 256 slots and four lane rows of 64 threads, each thread one
// 4-item quad of the window, so a thread's slots never change: it walks the
// item blocks with 16-byte loads (the pattern of hist.cu:coverage4) and
// keeps its sums in registers. The block combines its four rows with
// shared-memory atomics and flushes one global atomic per slot. With
// mma_cov (pt_word_fold, popcount only) the add over words runs on the int8
// tensor cores: the popcounts (<= 32, exact in u8) of 16 items x 32 words
// are the A fragment of mma.sync.m16n8k32.u8 and B is all ones, so each
// int32 accumulator holds an item's coverage. Each lane gathers its
// fragment's words straight from M with 4-byte loads, four times the load
// instructions of the ALU route; the route answers whether the adds cost
// anything, not how fast a tensor-core fold can be.
//
// pt_limb_hist: per weight vector v and byte j of the weights,
//   H[j * n_vecs + v][b] = sum over items with cov_i == b of byte_j(W[v, i] + salt)
// for b < 32 * n_coarse (the TPU kernels' [n_coarse, 32] accumulators,
// flattened; items with larger coverage are dropped), exact in int64. The
// TPU kernels take each limb histogram as a one-hot product on the matrix
// unit, C[coarse, fine] = onehot_coarse x (onehot_fine .* byte) (weight on
// the fine operand, fh2 / fhm) or (onehot_coarse .* byte) x onehot_fine
// (weight on the coarse operand, `coarse`), with bin = 32 coarse + fine.
// Here each block takes a slice of items and, per stage of 128 items,
// copies M and W into shared memory with cp.async (a double buffer: the
// next stage's copies fly while this one computes), takes the coverage
// (popcounts, or the tensor-core route above), then writes the u8 operands
// into shared memory (item-major rows, padded by 16
// bytes so ldmatrix reads fall on distinct banks) and runs the products
// with mma.sync m16n8k32 u8 into int32 registers: at most 255 per term, so
// a slice of up to 2^23 items stays exact (255 * 2^23 < 2^31). A block
// flushes its non-zero sums into the int64 output with one global atomic
// each. The TPU's lo/hi 16-bit planes (a bf16-exactness workaround) have no
// counterpart: the output is the histograms they encode. What bounds it:
// one read of M and W; the products, 2 * 32 n_coarse * n_limbs * n_vecs
// int8 operations per item, are a few percent of the tensor cores' rate.
//
// Plain C interface (bound with ctypes); every entry point returns the
// cudaError_t of its launches. Kernels run on the caller's stream and
// allocate nothing.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 16384;             // items per TPU grid step
constexpr int kSlotQuads = kSlots / 4;
constexpr int kWindow = 256;              // slots per block (== kThreads)
constexpr int kWindowQuads = kWindow / 4;
constexpr int kLaneRows = kThreads / kWindowQuads;  // 4 item blocks at once
constexpr int kFine = 32;

enum FoldOp { kXor = 0, kPopc = 1, kCast = 2 };

template <int kOp>
__device__ __forceinline__ uint32_t word_step(uint32_t v, uint32_t m) {
  if (kOp == kXor) return v ^ m;
  if (kOp == kPopc) return v + (uint32_t)__popc(m);
  return v + m;
}

template <int kOp>
__device__ __forceinline__ uint32_t item_step(uint32_t acc, uint32_t v,
                                              uint32_t w) {
  if (kOp == kXor) return acc ^ v ^ w;
  return acc + v + (w & 1u);
}

template <int kOp>
__device__ __forceinline__ void fold_into(uint32_t* p, uint32_t v) {
  if (kOp == kXor) {
    atomicXor(p, v);
  } else {
    atomicAdd(p, v);
  }
}

// Coverage of the 16 items i0 .. i0 + 15 (rows of an m16 tile) on the int8
// tensor cores, one k32 step per 32 words: lane (gid, tig) packs the
// popcounts of words 4 tig .. 4 tig + 3 and 16 + 4 tig .. of items gid and
// gid + 8 into its A fragment; B is all ones. c[0] / c[1] get the coverage
// of items i0 + gid / i0 + gid + 8. Items at or past `limit` and words past
// n_words count 0. M is in global memory (kGlobal) or shared memory. All 32
// lanes must call it.
template <bool kGlobal>
__device__ __forceinline__ void cov16_mma(const uint32_t* __restrict__ M,
                                          int64_t stride, int64_t limit,
                                          int64_t n_words, int64_t i0,
                                          int lane, int (&c)[2]) {
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t ia = i0 + gid, ib = ia + 8;
  const bool oka = ia < limit, okb = ib < limit;
  int d[4] = {0, 0, 0, 0};
  for (int64_t w0 = 0; w0 < n_words; w0 += 32) {
    uint32_t a[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t pa = 0u, pb = 0u;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int64_t wd = w0 + 16 * h + 4 * tig + k;
        const uint32_t* row = M + wd * stride;
        const uint32_t ma =
            (wd < n_words && oka) ? (kGlobal ? __ldg(row + ia) : row[ia]) : 0u;
        const uint32_t mb =
            (wd < n_words && okb) ? (kGlobal ? __ldg(row + ib) : row[ib]) : 0u;
        pa |= (uint32_t)__popc(ma) << (8 * k);
        pb |= (uint32_t)__popc(mb) << (8 * k);
      }
      a[2 * h] = pa;      // row gid
      a[2 * h + 1] = pb;  // row gid + 8
    }
    mma_u8(d, a, 0x01010101u, 0x01010101u);
  }
  c[0] = d[0];  // row gid (every column holds the same sum)
  c[1] = d[2];  // row gid + 8
}

// Fold with the add (or XOR) over words on the ALU. grid.x: the 64 slot
// windows; grid.y: groups of kLaneRows item blocks.
// For the XOR fold, `done` counts the finished blocks of each window and
// the last one adds the window's slots (int32-wrapping) into *sum: the
// order does not matter, so the read control is one launch.
template <int kOp>
__global__ void __launch_bounds__(kThreads)
    fold_alu_kernel(const uint32_t* __restrict__ M, int64_t n_words,
                    int64_t n_items, const int32_t* __restrict__ W,
                    uint32_t salt, uint32_t* __restrict__ slots,
                    uint32_t* __restrict__ done, uint32_t* __restrict__ sum) {
  __shared__ uint32_t win[kWindow];
  win[threadIdx.x] = 0u;
  __syncthreads();
  const int sq = threadIdx.x % kWindowQuads, row = threadIdx.x / kWindowQuads;
  const int64_t n_quads = n_items / 4;
  const int64_t n_blocks = (n_items + kSlots - 1) / kSlots;
  const int64_t q0 = (int64_t)blockIdx.x * kWindowQuads + sq;
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int64_t kb = (int64_t)blockIdx.y * kLaneRows + row; kb < n_blocks;
       kb += (int64_t)gridDim.y * kLaneRows) {
    const int64_t q = kb * kSlotQuads + q0;
    if (q >= n_quads) break;  // only the last item block is ragged
    const uint4* p = reinterpret_cast<const uint4*>(M) + q;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 8
    for (int64_t wd = 0; wd < n_words; ++wd) {
      const uint4 m = __ldg(p + wd * n_quads);
      v.x = word_step<kOp>(v.x, m.x);
      v.y = word_step<kOp>(v.y, m.y);
      v.z = word_step<kOp>(v.z, m.z);
      v.w = word_step<kOp>(v.w, m.w);
    }
    const int4 w = __ldg(reinterpret_cast<const int4*>(W) + q);
    acc.x = item_step<kOp>(acc.x, v.x, (uint32_t)w.x + salt);
    acc.y = item_step<kOp>(acc.y, v.y, (uint32_t)w.y + salt);
    acc.z = item_step<kOp>(acc.z, v.z, (uint32_t)w.z + salt);
    acc.w = item_step<kOp>(acc.w, v.w, (uint32_t)w.w + salt);
  }
  fold_into<kOp>(&win[4 * sq + 0], acc.x);
  fold_into<kOp>(&win[4 * sq + 1], acc.y);
  fold_into<kOp>(&win[4 * sq + 2], acc.z);
  fold_into<kOp>(&win[4 * sq + 3], acc.w);
  __syncthreads();
  const uint32_t s = win[threadIdx.x];
  uint32_t* slot = slots + blockIdx.x * kWindow + threadIdx.x;
  if (s != 0u) fold_into<kOp>(slot, s);
  if (kOp == kXor) {
    __shared__ bool last;
    __threadfence();  // this block's slot updates before its count
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(done + blockIdx.x, 1u) == gridDim.y - 1;
    __syncthreads();
    if (last) {
      uint32_t v = __ldcg(slot);  // from L2, where the atomics landed
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, o);
      if ((threadIdx.x & 31) == 0) atomicAdd(sum, v);
    }
  }
}

// The popcount fold with the coverage on the tensor cores. Warp k takes
// window items 32 k .. 32 k + 31 as two m16 tiles; in each tile lane tig 0
// keeps item gid and lane tig 1 item gid + 8. grid.y: item blocks.
__global__ void __launch_bounds__(kThreads)
    fold_mma_kernel(const uint32_t* __restrict__ M, int64_t n_words,
                    int64_t n_items, const int32_t* __restrict__ W,
                    uint32_t salt, uint32_t* __restrict__ slots) {
  __shared__ uint32_t win[kWindow];
  win[threadIdx.x] = 0u;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3, own = tig & 1;
  const int off = 32 * warp + gid + 8 * own;  // tile 0; tile 1 at off + 16
  const int64_t n_blocks = (n_items + kSlots - 1) / kSlots;
  uint32_t acc[2] = {0u, 0u};
  for (int64_t kb = blockIdx.y; kb < n_blocks; kb += gridDim.y) {
    const int64_t base = kb * kSlots + (int64_t)blockIdx.x * kWindow + 32 * warp;
    int c[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      cov16_mma<true>(M, n_items, n_items, n_words, base + 16 * t, lane, c[t]);
    }
    if (tig < 2) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int64_t i = base + 16 * t + gid + 8 * own;
        if (i < n_items) {
          acc[t] += (uint32_t)c[t][own] + (((uint32_t)__ldg(W + i) + salt) & 1u);
        }
      }
    }
  }
  if (tig < 2) {
    atomicAdd(&win[off], acc[0]);
    atomicAdd(&win[off + 16], acc[1]);
  }
  __syncthreads();
  const uint32_t s = win[threadIdx.x];
  if (s != 0u) atomicAdd(slots + blockIdx.x * kWindow + threadIdx.x, s);
}

// grid.y of a fold launch: enough 64-block rows to fill the card's resident
// block slots, never more than there are item blocks to walk.
cudaError_t fold_rows(const void* kernel, int64_t n_walks, unsigned* rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (e != cudaSuccess) return e;
  int64_t r = (int64_t)sms * (per_sm < 1 ? 1 : per_sm) / (kSlots / kWindow);
  if (r > n_walks) r = n_walks;
  if (r < 1) r = 1;
  if (r > 65535) r = 65535;
  *rows = (unsigned)r;
  return cudaSuccess;
}

cudaError_t launch_fold(int op, bool mma_cov, const uint32_t* M,
                        int64_t n_words, int64_t n_items, const int32_t* W,
                        uint32_t salt, uint32_t* slots, uint32_t* done,
                        uint32_t* sum, cudaStream_t s) {
  if (n_items == 0) return cudaSuccess;
  const int64_t n_blocks = (n_items + kSlots - 1) / kSlots;
  const void* kernel =
      mma_cov ? (const void*)fold_mma_kernel
      : op == kXor ? (const void*)fold_alu_kernel<kXor>
      : op == kPopc ? (const void*)fold_alu_kernel<kPopc>
                    : (const void*)fold_alu_kernel<kCast>;
  unsigned rows = 0;
  cudaError_t e = fold_rows(
      kernel, mma_cov ? n_blocks : (n_blocks + kLaneRows - 1) / kLaneRows, &rows);
  if (e != cudaSuccess) return e;
  const dim3 grid(kSlots / kWindow, rows);
  if (mma_cov) {
    fold_mma_kernel<<<grid, kThreads, 0, s>>>(M, n_words, n_items, W, salt, slots);
  } else if (op == kXor) {
    fold_alu_kernel<kXor><<<grid, kThreads, 0, s>>>(M, n_words, n_items, W, salt,
                                                     slots, done, sum);
  } else if (op == kPopc) {
    fold_alu_kernel<kPopc><<<grid, kThreads, 0, s>>>(M, n_words, n_items, W, salt,
                                                     slots, done, sum);
  } else {
    fold_alu_kernel<kCast><<<grid, kThreads, 0, s>>>(M, n_words, n_items, W, salt,
                                                     slots, done, sum);
  }
  return cudaGetLastError();
}

// limb histogram tiling
constexpr int kLhK = 128;                 // items per stage
constexpr int kLhQuads = kLhK / 4;
constexpr int kLhRow = kLhK + 16;         // bytes per operand row, padded
constexpr int kLhStageRow = kLhK + 4;     // u32 per staged word row, padded
constexpr int kLhWarps = kThreads / 32;
constexpr int kLhMaxUnits = 6;            // (row, m16 tile, n16 half) per warp
constexpr int kLhMaxCoarsePad = 240;      // coarse bins travel as bytes < 255
constexpr int64_t kLhMaxSlice = (int64_t)1 << 23;

// Shared memory of one block: two stages of M [n_words][kLhStageRow] u32
// and of W [n_vecs][kLhK] int32 (cp.async double buffer), coverage halves
// [2][kLhK] int32, per-quad bytes [2 + n_rows][kLhQuads] u32 (coarse bins,
// fine bins, one row per limb), then the A and B operand rows.
int64_t limb_smem(int64_t n_words, int n_vecs, int n_rows, int coarse_pad,
                  int weight_coarse) {
  const int64_t a_rows = weight_coarse ? (int64_t)n_rows * coarse_pad : coarse_pad;
  const int64_t b_rows = weight_coarse ? kFine : (int64_t)n_rows * kFine;
  return 2 * (n_words * kLhStageRow + (int64_t)n_vecs * kLhK) * 4 +
         2 * kLhK * 4 + (2 + (int64_t)n_rows) * kLhQuads * 4 +
         (a_rows + b_rows) * kLhRow;
}

template <bool kMmaCov>
__global__ void __launch_bounds__(kThreads, 2)
    limb_hist_kernel(const uint32_t* __restrict__ M, int64_t n_words,
                     int64_t n_items, const int32_t* __restrict__ W,
                     int n_vecs, int n_limbs, int n_coarse, int coarse_pad,
                     int weight_coarse, uint32_t salt, int64_t slice,
                     unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_rows = n_limbs * n_vecs;
  uint32_t* m_st = reinterpret_cast<uint32_t*>(smem);  // [2][n_words][row]
  int32_t* w_st = reinterpret_cast<int32_t*>(m_st + 2 * n_words * kLhStageRow);
  int32_t* cov_s = w_st + 2 * n_vecs * kLhK;
  uint32_t* pk = reinterpret_cast<uint32_t*>(cov_s + 2 * kLhK);
  uint8_t(*ta)[kLhRow] =
      reinterpret_cast<uint8_t(*)[kLhRow]>(pk + (2 + n_rows) * kLhQuads);
  uint8_t(*tb)[kLhRow] = ta + (weight_coarse ? n_rows * coarse_pad : coarse_pad);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int64_t lo = (int64_t)blockIdx.x * slice;
  const int64_t hi = lo + slice < n_items ? lo + slice : n_items;
  const int n_mt = coarse_pad / 16;
  const int n_units = n_rows * n_mt * 2;

  int acc[kLhMaxUnits][2][4];
#pragma unroll
  for (int s = 0; s < kLhMaxUnits; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][h][e] = 0;
  if (kMmaCov) {  // one coverage per item: the second half stays 0
    for (int k = t; k < kLhK; k += kThreads) cov_s[kLhK + k] = 0;
  }

  // the copies of the stage at item i0 into buffer buf; items past the
  // slice are zero-filled
  auto stage = [&](int buf, int64_t i0) {
    uint32_t* sm = m_st + buf * n_words * kLhStageRow;
    for (int64_t k = t; k < n_words * kLhQuads; k += kThreads) {
      const int64_t wd = k / kLhQuads, i = i0 + 4 * (k % kLhQuads);
      cp_async16(sm + wd * kLhStageRow + 4 * (k % kLhQuads),
                 i < hi ? M + wd * n_items + i : M, i < hi);
    }
    int32_t* sw = w_st + buf * n_vecs * kLhK;
    for (int k = t; k < n_vecs * kLhQuads; k += kThreads) {
      const int v = k / kLhQuads, q = k % kLhQuads;
      const int64_t i = i0 + 4 * q;
      cp_async16(sw + v * kLhK + 4 * q, i < hi ? W + (int64_t)v * n_items + i : W,
                 i < hi);
    }
  };
  stage(0, lo);
  asm volatile("cp.async.commit_group;\n" ::);
  int buf = 0;
  for (int64_t i0 = lo; i0 < hi; i0 += kLhK, buf ^= 1) {
    // the next stage's copies fly while this one computes; buffer buf ^ 1
    // was last read before the previous stage's third __syncthreads
    if (i0 + kLhK < hi) stage(buf ^ 1, i0 + kLhK);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const uint32_t* sm = m_st + buf * n_words * kLhStageRow;
    const int32_t* sw = w_st + buf * n_vecs * kLhK;
    // 1. the stage's coverage into shared memory
    if (kMmaCov) {
      int c[2];
      cov16_mma<false>(sm, kLhStageRow, kLhK, n_words, 16 * warp, lane, c);
      if (tig < 2) cov_s[16 * warp + gid + 8 * tig] = c[tig];
    } else {
      const int k = t % kLhK, half = t / kLhK;
      int c = 0;
#pragma unroll 4
      for (int64_t wd = half; wd < n_words; wd += 2) {
        c += __popc(sm[wd * kLhStageRow + k]);
      }
      cov_s[half * kLhK + k] = c;
    }
    __syncthreads();
    // 2. per quad, a byte per item: coarse bin (255 past the slice, which
    //    matches no row), fine bin, and each limb of each vector; row kind
    //    k of quad q in thread k * kLhQuads + q
    for (int k = t / kLhQuads; k < 2 + n_rows; k += kThreads / kLhQuads) {
      const int q = t % kLhQuads;
      uint32_t v = 0u;
      if (k < 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = cov_s[4 * q + e] + cov_s[kLhK + 4 * q + e];
          const int b = k == 1 ? (c & (kFine - 1))
                        : i0 + 4 * q + e < hi ? min(c >> 5, 255) : 255;
          v |= (uint32_t)b << (8 * e);
        }
      } else {  // limb row l = j * n_vecs + vec
        const int l = k - 2, j = l / n_vecs;
        const int4 w = reinterpret_cast<const int4*>(sw + (l % n_vecs) * kLhK)[q];
        const unsigned sel = (unsigned)j | ((unsigned)(j + 4) << 4);
        v = __byte_perm(__byte_perm((uint32_t)w.x + salt, (uint32_t)w.y + salt, sel),
                        __byte_perm((uint32_t)w.z + salt, (uint32_t)w.w + salt, sel),
                        0x5410);
      }
      pk[k * kLhQuads + q] = v;
    }
    __syncthreads();
    // 3. the u8 operands, 4 items per store: A rows are coarse bins (per
    //    limb row when the weight rides the coarse side), B rows fine bins;
    //    thread t writes quad t % 32 of every eighth row
    {
      const int q = t % kLhQuads, r0 = t / kLhQuads;
      constexpr int kStep = kThreads / kLhQuads;
      const uint32_t cq = pk[q], fq = pk[kLhQuads + q];
      for (int l = 0; l < (weight_coarse ? n_rows : 1); ++l) {
        const uint32_t sel = weight_coarse ? pk[(2 + l) * kLhQuads + q] : 0x01010101u;
        for (int c = r0; c < coarse_pad; c += kStep) {
          *reinterpret_cast<uint32_t*>(&ta[l * coarse_pad + c][4 * q]) =
              __vcmpeq4(cq, (uint32_t)c * 0x01010101u) & sel;
        }
      }
      for (int l = 0; l < (weight_coarse ? 1 : n_rows); ++l) {
        const uint32_t sel = weight_coarse ? 0x01010101u : pk[(2 + l) * kLhQuads + q];
        for (int f = r0; f < kFine; f += kStep) {
          *reinterpret_cast<uint32_t*>(&tb[l * kFine + f][4 * q]) =
              __vcmpeq4(fq, (uint32_t)f * 0x01010101u) & sel;
        }
      }
    }
    __syncthreads();
    // 4. the products: unit u = (limb row l, m16 tile mt, n16 half nh)
#pragma unroll
    for (int s = 0; s < kLhMaxUnits; ++s) {
      const int u = warp + kLhWarps * s;
      if (u < n_units) {
        const int nh = u & 1, mt = (u >> 1) % n_mt, l = (u >> 1) / n_mt;
        uint8_t(*ua)[kLhRow] = ta + (weight_coarse ? l * coarse_pad : 0) + 16 * mt;
        uint8_t(*ub)[kLhRow] = tb + (weight_coarse ? 0 : l * kFine) + 16 * nh;
#pragma unroll
        for (int kk = 0; kk < kLhK; kk += 32) {
          uint32_t af[4], bf[4];
          ldsm_x4(af, &ua[(lane & 7) + ((lane >> 3) & 1) * 8][kk + (lane >> 4) * 16]);
          ldsm_x4(bf, &ub[(lane & 7) + (lane >> 4) * 8][kk + ((lane >> 3) & 1) * 16]);
          mma_u8(acc[s][0], af, bf[0], bf[1]);
          mma_u8(acc[s][1], af, bf[2], bf[3]);
        }
      }
    }
    // the next stage's copies and step 1 touch neither the operands nor the
    // packed bytes; its first __syncthreads orders the rest
  }

  // accumulator e of n8 tile h: row gid + 8 (e / 2), column 2 tig + e % 2
#pragma unroll
  for (int s = 0; s < kLhMaxUnits; ++s) {
    const int u = warp + kLhWarps * s;
    if (u >= n_units) continue;
    const int nh = u & 1, mt = (u >> 1) % n_mt, l = (u >> 1) / n_mt;
    unsigned long long* o = out + (int64_t)l * n_coarse * kFine;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + gid + 8 * (e >> 1);
        const int col = 16 * nh + 8 * h + 2 * tig + (e & 1);
        const int v = acc[s][h][e];
        if (v != 0 && row < n_coarse) {
          atomicAdd(o + row * kFine + col, (unsigned long long)(long long)v);
        }
      }
  }
}

}  // namespace

extern "C" {

// The raw-read control: the int32-wrapping sum over the slots j < 16384 of
// slot_j = XOR over items i with i % 16384 == j of
// (XOR_w M[w, i]) ^ (W[i] + salt). W is int32 [n_items]; scratch is uint32
// [16384 + 64 + 1] that the caller zeroes: the slots, a count per 256-slot
// window, then the result (as int32) in its last element.
int pt_xor_fold(const void* M, long long n_words, long long n_items,
                const void* W, int salt, void* scratch, void* stream) {
  if (n_words < 0 || n_items < 0 || n_items % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  uint32_t* slots = (uint32_t*)scratch;
  return (int)launch_fold(kXor, false, (const uint32_t*)M, n_words, n_items,
                          (const int32_t*)W, (uint32_t)salt, slots,
                          slots + kSlots, slots + kSlots + kSlots / kWindow,
                          (cudaStream_t)stream);
}

// out[j] (int32 [16384], zeroed by the caller) += sum over items i with
// i % 16384 == j of cov_i + ((W[i] + salt) & 1), wrapping; cov_i is
// sum_w popc(M[w, i]) (op 0) or sum_w M[w, i] (op 1). mma_cov takes the
// popcount coverage on the int8 tensor cores (op 0 only).
int pt_word_fold(const void* M, long long n_words, long long n_items,
                 const void* W, int salt, int op, int mma_cov, void* out,
                 void* stream) {
  if (n_words < 0 || n_items < 0 || n_items % 4 != 0 || op < 0 || op > 1 ||
      (mma_cov && op != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_fold(op == 0 ? kPopc : kCast, mma_cov != 0,
                          (const uint32_t*)M, n_words, n_items,
                          (const int32_t*)W, (uint32_t)salt, (uint32_t*)out,
                          nullptr, nullptr, (cudaStream_t)stream);
}

// out[j * n_vecs + v][b] (int64 [n_limbs * n_vecs, 32 * n_coarse], zeroed by
// the caller) += sum over items with cov_i == b of byte j of W[v, i] + salt.
// W is int32 [n_vecs, n_items]; weight_coarse puts the weight byte on the
// coarse operand of the product (else on the fine one); mma_cov takes the
// coverage on the int8 tensor cores. max_blocks > 0 caps the blocks (their
// slices then grow, up to 2^23 items). M and W are 16-byte aligned.
int pt_limb_hist(const void* M, long long n_words, long long n_items,
                 const void* W, int n_vecs, int n_limbs, int n_coarse,
                 int weight_coarse, int mma_cov, int salt, int max_blocks,
                 void* out, void* stream) {
  const int coarse_pad = (n_coarse + 15) / 16 * 16;
  const int n_rows = n_limbs * n_vecs;
  if (n_words < 0 || n_items < 0 || n_items % 4 != 0 || n_vecs < 1 ||
      n_limbs < 1 || n_limbs > 4 || n_coarse < 1 ||
      coarse_pad > kLhMaxCoarsePad ||
      n_rows * (coarse_pad / 16) * 2 > kLhWarps * kLhMaxUnits ||
      ((uintptr_t)M | (uintptr_t)W) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_items == 0) return (int)cudaSuccess;
  const void* kernel = mma_cov ? (const void*)limb_hist_kernel<true>
                               : (const void*)limb_hist_kernel<false>;
  const size_t smem =
      (size_t)limb_smem(n_words, n_vecs, n_rows, coarse_pad, weight_coarse);
  int optin = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return (int)e;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  // one slice per resident block slot, a whole number of stages, none past
  // kLhMaxSlice items (where the int32 sums stay exact)
  const int64_t stages = (n_items + kLhK - 1) / kLhK;
  int64_t blocks = (int64_t)sms * (per_sm < 1 ? 1 : per_sm);
  if (blocks > stages) blocks = stages;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  const int64_t slice_min = (n_items + kLhMaxSlice - 1) / kLhMaxSlice;
  if (blocks < slice_min) blocks = slice_min;
  const int64_t slice = ((stages + blocks - 1) / blocks) * kLhK;
  blocks = (n_items + slice - 1) / slice;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (mma_cov) {
    limb_hist_kernel<true><<<(unsigned)blocks, kThreads, smem, s>>>(
        (const uint32_t*)M, n_words, n_items, (const int32_t*)W, n_vecs,
        n_limbs, n_coarse, coarse_pad, weight_coarse, (uint32_t)salt, slice,
        (unsigned long long*)out);
  } else {
    limb_hist_kernel<false><<<(unsigned)blocks, kThreads, smem, s>>>(
        (const uint32_t*)M, n_words, n_items, (const int32_t*)W, n_vecs,
        n_limbs, n_coarse, coarse_pad, weight_coarse, (uint32_t)salt, slice,
        (unsigned long long*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
