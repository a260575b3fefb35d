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
// Here each block takes a slice of items in stages of 256, a k32 step of
// 32 items a warp. Writing both one-hot operands as u8 rows into shared
// memory (about 20 KB a 128-item stage at 3 limbs) and reading them back
// with ldmatrix (about 72 KB) came to some 90 KB of shared traffic for
// each 16.5 KB read from HBM, behind four barriers a stage, and held such
// a kernel under half the read. Here the operands never touch shared memory: each fragment
// register of mma.sync m16n8k32 u8 is one byte compare of a packed quad
// (four items' coarse or fine bins) against the row or column of the lane,
// masked to 1 or to the limb's weight bytes, so the only thing the warps
// share is a stage's packed bytes, a few hundred bytes a limb row. The
// coverage: on the ALU routes each lane reads its quad's words straight
// from global memory with 16-byte loads (the next stage's loads go out
// before this stage's products); with mma_cov the word rows arrive by TMA
// bulk copies in a ring of up to 3 stages on mbarriers and cov16_mma reads
// them there. One barrier a stage. A warp's units share their limb row's
// B operands (or, with the weight on the coarse side, all of them), so at 3
// limbs of 48 coarse bins a k32 step builds 20 registers for 12 products,
// not 8 for 2. int32 sums: at most 255 per term, so a slice of up to
// 2^23 items stays exact (255 * 2^23 < 2^31); a block adds its warps' sums
// in shared memory and flushes its non-zero sums into the int64 output
// with one global atomic each. The TPU's lo/hi 16-bit planes (a
// bf16-exactness workaround) have no counterpart: the output is the
// histograms they encode. What bounds it: one read of M and W; the
// products, 2 * 32 n_coarse * n_limbs * n_vecs int8 operations per item,
// are a few percent of the tensor cores' rate. Every tile is multiplied
// whatever the data, so the work does not depend on it.
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
// popcounts of four words of items gid and gid + 8 into each A register
// (any four: B is all ones, so only the sum over the 32 slots counts).
// From global memory (kGlobal) the slots of register h are words 16 h +
// 4 tig + k; from shared memory, whose word rows are `stride` u32 apart
// with stride % 32 == 8, words 16 h + tig + 4 k, so the 32 lanes of a load
// fall on 32 banks. c[0] / c[1] get the coverage of items i0 + gid / i0 +
// gid + 8. Items at or past `limit` and words past n_words count 0. All 32
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
        const int64_t wd = kGlobal ? w0 + 16 * h + 4 * tig + k : w0 + 16 * h + tig + 4 * k;
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
constexpr int kLhStage = 256;             // items per stage: a k32 step a warp
constexpr int kLhQuads = kLhStage / 4;
constexpr int kLhWarps = kThreads / 32;
constexpr int kLhMaxUnits = 3;            // (limb row, m16 tile) per warp
constexpr int kLhMaxCoarsePad = 240;      // coarse bins travel as bytes < 255
constexpr int64_t kLhMaxSlice = (int64_t)1 << 23;
constexpr int kLhPreWords = 8;            // word loads a lane keeps in flight
constexpr int kLhPreVecs = 2;             // weight loads a lane keeps in flight
constexpr int kLhRingRow = kLhStage + 8;  // u32 per staged word row (% 32 == 8)
constexpr int kLhMaxRing = 3;

// A 16-byte load from global memory that the compiler keeps where it is
// written: the next stage's loads go out before this stage's products.
__device__ __forceinline__ uint4 ldg16_now(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Per byte of x: bit 7 set where it differs from the byte of key (key = b
// * 0x01010101); the other bits are garbage. Exact for any bytes, or with
// kSmall (both below 128) one operation shorter: no carry then crosses a
// byte.
template <bool kSmall>
__device__ __forceinline__ uint32_t byte_ne80(uint32_t x, uint32_t key) {
  const uint32_t d = x ^ key;
  return kSmall ? d + 0x7F7F7F7Fu : ((d & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | d;
}

// The one-hot operand bytes: 1 where the byte of x equals the key's.
template <bool kSmall>
__device__ __forceinline__ uint32_t onehot(uint32_t x, uint32_t key) {
  return (~byte_ne80<kSmall>(x, key) >> 7) & 0x01010101u;
}

// The weighted one-hot operand bytes: the byte of sel where the byte of x
// equals the key's, else 0 (prmt's sign mode spreads bit 7 over its byte).
template <bool kSmall>
__device__ __forceinline__ uint32_t onehot_sel(uint32_t x, uint32_t key,
                                               uint32_t sel) {
  uint32_t m;
  asm("prmt.b32 %0, %1, 0, 0xBA98;\n" : "=r"(m) : "r"(byte_ne80<kSmall>(x, key)));
  return sel & ~m;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from global to shared memory, completed on the mbarrier bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The launch shape of pt_limb_hist, kept in this one place. A unit is a
// limb row's m16 tile of coarse bins against all 32 fine bins (four n8
// tiles, 16 int32 registers a lane). n_groups groups of per_group warps
// each (warps past them only take coverage) split the k32 steps of a
// stage, and a group's warps split the units, each a run of up to 3 units
// in row order (so a warp's units mostly share their limb row, whose B
// operands it builds once a k32 step). The plan with the least work on its
// busiest warp wins. With mma_cov, M arrives in a ring of `ring` stages.
struct LhPlan {
  int n_units = 0, n_groups = 1, per_group = 1, ring = 0;
  bool one_row = true;  // every warp's units lie in one limb row
  size_t pk_bytes = 0, big_bytes = 0, smem = 0;
};

LhPlan limb_plan(int64_t n_words, int n_rows, int coarse_pad, bool mma_cov,
                 int optin) {
  LhPlan p;
  p.n_units = n_rows * (coarse_pad / 16);
  int best = 1 << 30;
  for (int per = 1; per <= kLhWarps; ++per) {
    const int per_warp = (p.n_units + per - 1) / per;
    if (per_warp > kLhMaxUnits) continue;
    const int groups = kLhWarps / per;
    const int work = (kLhWarps + groups - 1) / groups * per_warp;
    if (work < best) {
      best = work;
      p.n_groups = groups;
      p.per_group = per;
    }
  }
  const int n_mt = coarse_pad / 16;
  const int per_warp = (p.n_units + p.per_group - 1) / p.per_group;
  for (int w = 0; w < p.per_group; ++w) {
    const int u0 = w * per_warp;
    const int u1 = (u0 + per_warp < p.n_units ? u0 + per_warp : p.n_units) - 1;
    if (u0 < p.n_units && u0 / n_mt != u1 / n_mt) p.one_row = false;
  }
  // the packed bytes, two buffers: coarse bins, fine bins, one row a limb
  p.pk_bytes = 2 * (size_t)(2 + n_rows) * kLhQuads * 4;
  const size_t bars = 2 * kLhMaxRing * sizeof(uint64_t);
  p.big_bytes = (size_t)p.n_units * 512 * 4;  // the block's int32 sums
  if (mma_cov) {
    // as many stages (up to 3) as leave two blocks an SM, else one block
    const size_t stage = (size_t)n_words * kLhRingRow * 4;
    const size_t fixed = p.pk_bytes + bars;
    const size_t two = (size_t)optin / 2 - 1024;
    size_t d = two > fixed ? (two - fixed) / stage : 0;
    if (d < 1 && (size_t)optin > fixed) d = ((size_t)optin - fixed) / stage;
    p.ring = (int)(d > (size_t)kLhMaxRing ? kLhMaxRing : d);
    if (p.ring * stage > p.big_bytes) p.big_bytes = p.ring * stage;
  }
  p.smem = p.pk_bytes + bars + p.big_bytes;
  return p;
}

// The limb histograms of one item slice per block. Per stage of 256 items
// warp w takes items 32 w .. 32 w + 31 (one k32 step): lane (quad gq =
// lane % 8, word group r = lane / 8) takes the coverage of quad gq (from
// its own 16-byte loads of words r, r + 4, ..., added across r by shuffles;
// with mma_cov, from the ring by cov16_mma), and packs a byte an item into
// pk: the coarse bin (255 past the slice, which matches no row), the fine
// bin, and byte j of each vector's salted weight. After the stage's one
// barrier, each warp of a group runs its units over the group's k32 steps:
// every operand register is built in registers from the packed quads, one
// compare a register (A rows gid and gid + 8 of the m16 tile at items 4 tig
// .. 4 tig + 3 and 16 + 4 tig .., B column gid of each n8 tile likewise),
// and goes straight into mma.sync m16n8k32 u8. Without mma_cov each lane
// issues the next stage's loads before the products; with it the ring
// keeps the next stages in flight. Each block adds its warps' int32 sums in
// shared memory and flushes the non-zero ones into the int64 output.
template <bool kMmaCov, bool kWeightCoarse, bool kSmall, bool kOneRow>
__global__ void __launch_bounds__(kThreads, 2)
    limb_hist_kernel(const uint32_t* __restrict__ M, int64_t n_words,
                     int64_t n_items, const int32_t* __restrict__ W,
                     int n_vecs, int n_limbs, int n_coarse, int coarse_pad,
                     uint32_t salt, int64_t slice, int n_groups, int per_group,
                     int ring, unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_rows = n_limbs * n_vecs;
  const int pk_rows = 2 + n_rows;
  uint32_t* pk = reinterpret_cast<uint32_t*>(smem);  // [2][pk_rows][quads]
  uint64_t* full = reinterpret_cast<uint64_t*>(pk + 2 * pk_rows * kLhQuads);
  uint64_t* empty = full + kLhMaxRing;
  uint32_t* big = reinterpret_cast<uint32_t*>(empty + kLhMaxRing);
  const int ring_stage = (int)n_words * kLhRingRow;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gid = lane >> 2, tig = lane & 3, gq = lane & 7, r = lane >> 3;
  const int grp = warp / per_group, iw = warp % per_group;
  const int64_t lo = (int64_t)blockIdx.x * slice;
  const int64_t hi = lo + slice < n_items ? lo + slice : n_items;
  const int n_stages = (int)((hi - lo + kLhStage - 1) / kLhStage);
  const int n_mt = coarse_pad / 16;
  const int n_units = n_rows * n_mt;
  const int per_warp = (n_units + per_group - 1) / per_group;

  // the coarse byte past the slice (and of coverage past 32 * kPast): no
  // row's; with kSmall (coarse_pad <= 112) every byte stays below 128
  constexpr int kPast = kSmall ? 127 : 255;
  // this warp's units, one int each: row key 16 mt + gid, limb row l
  int ukey[kLhMaxUnits];
#pragma unroll
  for (int s = 0; s < kLhMaxUnits; ++s) {
    const int u = iw * per_warp + s;
    ukey[s] = grp < n_groups && s < per_warp && u < n_units
                  ? (16 * (u % n_mt) + gid) | ((u / n_mt) << 16)
                  : -1;
  }
  int acc[kLhMaxUnits][4][4];
#pragma unroll
  for (int s = 0; s < kLhMaxUnits; ++s)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][n][e] = 0;

  // the ring (mma_cov): warp 0 issues stage s into slot s % ring
  auto issue = [&](int s) {
    const int slot = s % ring;
    const int64_t i0 = lo + (int64_t)s * kLhStage;
    const int64_t n = hi - i0 < kLhStage ? hi - i0 : kLhStage;
    const uint32_t bytes = (uint32_t)n * 4u;
    if (lane == 0) mbar_expect(full + slot, bytes * (uint32_t)n_words);
    __syncwarp();
    uint32_t* dst = big + slot * ring_stage;
    for (int wd = lane; wd < n_words; wd += 32) {
      bulk_copy(dst + wd * kLhRingRow, M + wd * n_items + i0, bytes, full + slot);
    }
  };
  if (kMmaCov) {
    if (t == 0) {
      for (int d = 0; d < ring; ++d) {
        mbar_init(full + d, 1);
        mbar_init(empty + d, kLhWarps);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == 0) {
      for (int s = 0; s < ring && s < n_stages; ++s) issue(s);
    }
  }

  // the loads a lane keeps in flight: its quad's words r + 4 k (without
  // mma_cov) and vectors r + 4 k, zero past the slice
  uint4 mv[kMmaCov ? 1 : kLhPreWords];
  uint4 wv[kLhPreVecs];
  auto load = [&](int64_t i0) {
    const int64_t ib = i0 + 32 * warp + 4 * gq;
    const bool in = ib < hi;
    if (!kMmaCov) {
#pragma unroll
      for (int k = 0; k < kLhPreWords; ++k) {
        const int64_t wd = r + 4 * k;
        mv[k] = in && wd < n_words ? ldg16_now(M + wd * n_items + ib)
                                   : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int k = 0; k < kLhPreVecs; ++k) {
      const int v = r + 4 * k;
      wv[k] = in && v < n_vecs ? ldg16_now(W + (int64_t)v * n_items + ib)
                               : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // stage s (its loads issued) into pk buffer s % 2
  auto cover = [&](int s) {
    const int64_t i0 = lo + (int64_t)s * kLhStage;
    const int64_t ib = i0 + 32 * warp + 4 * gq;
    const bool in = ib < hi;
    int c[4] = {0, 0, 0, 0};
    if (kMmaCov) {
      const int slot = s % ring;
      mbar_wait(full + slot, (uint32_t)((s / ring) & 1));
      const uint32_t* sm = big + slot * ring_stage;
      int ct[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cov16_mma<false>(sm, kLhRingRow, hi - i0, n_words, 32 * warp + 16 * h, lane, ct[h]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
      // item j = 4 gq + e of the warp's 32 is ct[j / 16][(j / 8) % 2] of
      // lane 4 (j % 8)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = 4 * gq + e, src = 4 * (j & 7);
        const int v00 = __shfl_sync(0xFFFFFFFFu, ct[0][0], src);
        const int v01 = __shfl_sync(0xFFFFFFFFu, ct[0][1], src);
        const int v10 = __shfl_sync(0xFFFFFFFFu, ct[1][0], src);
        const int v11 = __shfl_sync(0xFFFFFFFFu, ct[1][1], src);
        c[e] = j < 16 ? (j < 8 ? v00 : v01) : (j < 24 ? v10 : v11);
      }
    } else {
      uint4 a4 = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int k = 0; k < (kMmaCov ? 1 : kLhPreWords); ++k) {
        a4.x += __popc(mv[k].x);
        a4.y += __popc(mv[k].y);
        a4.z += __popc(mv[k].z);
        a4.w += __popc(mv[k].w);
      }
      if (in) {
#pragma unroll 4
        for (int64_t wd = r + 4 * kLhPreWords; wd < n_words; wd += 4) {
          const uint4 m = __ldg(reinterpret_cast<const uint4*>(M + wd * n_items + ib));
          a4.x += __popc(m.x);
          a4.y += __popc(m.y);
          a4.z += __popc(m.z);
          a4.w += __popc(m.w);
        }
      }
      c[0] = (int)a4.x;
      c[1] = (int)a4.y;
      c[2] = (int)a4.z;
      c[3] = (int)a4.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        c[e] += __shfl_xor_sync(0xFFFFFFFFu, c[e], 8);
        c[e] += __shfl_xor_sync(0xFFFFFFFFu, c[e], 16);
      }
    }
    uint32_t* pb = pk + (s & 1) * pk_rows * kLhQuads + 8 * warp + gq;
    if (r < 2) {
      uint32_t v = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = r == 1 ? (c[e] & (kFine - 1)) : in ? min(c[e] >> 5, kPast) : kPast;
        v |= (uint32_t)b << (8 * e);
      }
      pb[r * kLhQuads] = v;
    }
    // vector v = r + 4 k: byte j of its salted weights into limb row
    // j * n_vecs + v
    for (int k = 0; r + 4 * k < n_vecs; ++k) {
      const int v = r + 4 * k;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (k < kLhPreVecs) {
#pragma unroll
        for (int p = 0; p < kLhPreVecs; ++p) w = p == k ? wv[p] : w;
      } else if (in) {
        w = __ldg(reinterpret_cast<const uint4*>(W + (int64_t)v * n_items + ib));
      }
      const uint32_t x = w.x + salt, y = w.y + salt, z = w.z + salt, q = w.w + salt;
      for (int j = 0; j < n_limbs; ++j) {
        const unsigned sel = (unsigned)j | ((unsigned)(j + 4) << 4);
        pb[(2 + j * n_vecs + v) * kLhQuads] =
            __byte_perm(__byte_perm(x, y, sel), __byte_perm(z, q, sel), 0x5410);
      }
    }
  };

  // kOneRow: the warp's units share one limb row l0, and run without
  // branches (a unit past the warp's share multiplies a row key that no
  // item has, and its sums are never read); else each unit builds its own
  // operands
  const int l0 = ukey[0] >> 16;

  // the products of stage s's packed bytes over the group's k32 steps
  const uint32_t gkey = (uint32_t)gid * 0x01010101u;
  auto products = [&](int s) {
    if (grp >= n_groups) return;
    const uint32_t* pb = pk + (s & 1) * pk_rows * kLhQuads;
    for (int st = grp; st < kLhWarps; st += n_groups) {
      const int q0 = 8 * st + tig;
      const uint32_t cq0 = pb[q0], cq1 = pb[q0 + 4];
      const uint32_t fq0 = pb[kLhQuads + q0], fq1 = pb[kLhQuads + q0 + 4];
      uint32_t s0 = 0u, s1 = 0u;
      if (kOneRow) {
        s0 = pb[(2 + l0) * kLhQuads + q0];
        s1 = pb[(2 + l0) * kLhQuads + q0 + 4];
      }
      // B of n8 tile n: fine bin 8 n + gid (fine bins are below 32), built
      // once for the warp's units (kWeightCoarse, or one limb row) or for
      // each unit
      uint32_t b[4][2];
      if (kWeightCoarse || kOneRow) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t ck = gkey + 0x08080808u * n;
          b[n][0] = kWeightCoarse ? onehot<true>(fq0, ck) : onehot_sel<true>(fq0, ck, s0);
          b[n][1] = kWeightCoarse ? onehot<true>(fq1, ck) : onehot_sel<true>(fq1, ck, s1);
        }
      }
#pragma unroll
      for (int u = 0; u < kLhMaxUnits; ++u) {
        const int key = ukey[u];
        if (!kOneRow && key < 0) continue;
        const uint32_t rk = (uint32_t)(key & 0xFF) * 0x01010101u;
        const uint32_t rk8 = rk + 0x08080808u;
        if (!kOneRow) {
          const uint32_t* ps = pb + (2 + (key >> 16)) * kLhQuads + q0;
          s0 = ps[0];
          s1 = ps[4];
        }
        uint32_t a[4];
        if (kWeightCoarse) {
          a[0] = onehot_sel<kSmall>(cq0, rk, s0);
          a[1] = onehot_sel<kSmall>(cq0, rk8, s0);
          a[2] = onehot_sel<kSmall>(cq1, rk, s1);
          a[3] = onehot_sel<kSmall>(cq1, rk8, s1);
        } else {
          a[0] = onehot<kSmall>(cq0, rk);
          a[1] = onehot<kSmall>(cq0, rk8);
          a[2] = onehot<kSmall>(cq1, rk);
          a[3] = onehot<kSmall>(cq1, rk8);
          if (!kOneRow) {
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const uint32_t ck = gkey + 0x08080808u * n;
              b[n][0] = onehot_sel<true>(fq0, ck, s0);
              b[n][1] = onehot_sel<true>(fq1, ck, s1);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) mma_u8(acc[u][n], a, b[n][0], b[n][1]);
      }
    }
  };

  if (n_stages > 0) {
    load(lo);
    cover(0);
    __syncthreads();
  }
  for (int s = 0; s < n_stages; ++s) {
    const bool next = s + 1 < n_stages;
    if (kMmaCov && warp == 0 && s + ring < n_stages) {
      // slot s % ring is free once every warp has taken stage s's coverage
      mbar_wait(empty + s % ring, (uint32_t)((s / ring) & 1));
      issue(s + ring);
    }
    if (next) load(lo + (int64_t)(s + 1) * kLhStage);
    products(s);
    // pk buffer (s + 1) % 2 was last read by the products of stage s - 1,
    // before the barrier that ended that stage
    if (next) cover(s + 1);
    __syncthreads();
  }

  // the block's sums in shared memory (over the ring), then one int64
  // atomic per non-zero sum; accumulator e of n8 tile n is row gid + 8 (e /
  // 2), column 8 n + 2 tig + e % 2
  int* red = reinterpret_cast<int*>(big);  // [n_rows][coarse_pad][32]
  const int n_red = n_units * 512;
  for (int k = t; k < n_red; k += kThreads) red[k] = 0;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kLhMaxUnits; ++u) {
    const int key = ukey[u];
    if (key < 0) continue;
    int* o = red + ((key >> 16) * coarse_pad + (key & 0xFF)) * kFine + 2 * tig;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = acc[u][n][e];
        if (v != 0) atomicAdd(o + 8 * (e >> 1) * kFine + 8 * n + (e & 1), v);
      }
  }
  __syncthreads();
  for (int k = t; k < n_red; k += kThreads) {
    const int v = red[k];
    const int l = k / (coarse_pad * kFine), rc = k % (coarse_pad * kFine);
    if (v != 0 && rc < n_coarse * kFine) {
      atomicAdd(out + (int64_t)l * n_coarse * kFine + rc, (unsigned long long)(long long)v);
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
      n_rows * (coarse_pad / 16) > kLhWarps * kLhMaxUnits ||
      ((uintptr_t)M | (uintptr_t)W) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_items == 0) return (int)cudaSuccess;
  int optin = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return (int)e;
  const LhPlan plan = limb_plan(n_words, n_rows, coarse_pad, mma_cov != 0, optin);
  if ((mma_cov && plan.ring < 1) || plan.smem > (size_t)optin) {
    return (int)cudaErrorInvalidValue;
  }
  // [mma_cov][weight_coarse][coarse bins and the past-the-slice byte below
  // 128: the shorter compare][every warp's units in one limb row]
#define PT_LH(c, w, m) (const void*)limb_hist_kernel<c, w, m, false>, \
                       (const void*)limb_hist_kernel<c, w, m, true>
  static const void* const kKernels[2][2][2][2] = {
      {{{PT_LH(false, false, false)}, {PT_LH(false, false, true)}},
       {{PT_LH(false, true, false)}, {PT_LH(false, true, true)}}},
      {{{PT_LH(true, false, false)}, {PT_LH(true, false, true)}},
       {{PT_LH(true, true, false)}, {PT_LH(true, true, true)}}}};
#undef PT_LH
  const void* kernel =
      kKernels[mma_cov != 0][weight_coarse != 0][coarse_pad <= 112][plan.one_row];
  e = allow_smem(kernel, plan.smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, plan.smem);
  if (e != cudaSuccess) return (int)e;
  // one slice per resident block slot, a whole number of stages, none past
  // kLhMaxSlice items (where the int32 sums stay exact)
  const int64_t stages = (n_items + kLhStage - 1) / kLhStage;
  int64_t blocks = (int64_t)sms * (per_sm < 1 ? 1 : per_sm);
  if (blocks > stages) blocks = stages;
  if (max_blocks > 0 && blocks > max_blocks) blocks = max_blocks;
  const int64_t slice_min = (n_items + kLhMaxSlice - 1) / kLhMaxSlice;
  if (blocks < slice_min) blocks = slice_min;
  const int64_t slice = ((stages + blocks - 1) / blocks) * kLhStage;
  blocks = (n_items + slice - 1) / slice;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {(void*)&M, &n_words, &n_items, (void*)&W, &n_vecs, &n_limbs,
                  &n_coarse, (void*)&coarse_pad, &salt, (void*)&slice,
                  (void*)&plan.n_groups, (void*)&plan.per_group, (void*)&plan.ring, &out};
  return (int)cudaLaunchKernel(kernel, dim3((unsigned)blocks), dim3(kThreads), args,
                               plan.smem, (cudaStream_t)stream);
}

}  // extern "C"
