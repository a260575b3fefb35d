// Group-resolved scans over the packed membership matrix: ordered growth
// and pairwise group similarity.
//
// Replaces the XLA programs of panacus_tpu/ops/engine.py:
//   pt_ordered_growth  <- _ordered_growth_all / _ordered_growth_block_body /
//                         ordered_growth (engine.py:212-294)
//   pt_similarity      <- _sim_block_int / _sim_all /
//                         similarity_intersections (engine.py:302-383),
//                         on the int8 tensor cores
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
// Similarity: S[g, h] = sum_i W[i] * P[g, i] * P[h, i], exact in int64,
// where P[g, i] is bit g % 32 of M[g / 32, i]. With the weights cut into
// byte planes, W = sum_p 256^p * B_p and B_p in [0, 255], each plane is an
// integer matrix product S_p = P * diag(B_p) * P^T whose two operands are
// both item-major (K-major): A = P and B = P .* B_p, with the items as the
// reduction axis. That is the layout of Hopper's IMMA units
// (mma.sync.m16n8k32.row.col.s32.u8.u8.s32), and S = sum_p S_p << 8p.
// The TPU version (engine.py:302-383) is the same split at its integer
// unit's width: 16-bit halves into int32 dot_generals.
//
// What bounds it: the tensor-core work, 2 * n_groups^2 / 2 * n_items *
// n_planes int8 operations (1,979 TOPS dense on an H100 SXM) at many
// groups; at tens of groups, one read of M and W. The design:
// - A block owns one 128 x 128 tile pair (a, b), a <= b (the upper
//   triangle only; an off-diagonal tile adds each sum to S[r, c] and to
//   the mirrored S[c, r]), one item slice and one byte plane.
// - The packed words of the tile pair (4 + 4 word rows) and the weights of
//   128 items are staged with cp.async in a double buffer, so the next
//   chunk arrives while the current one multiplies. M stays packed in
//   device memory (32x smaller than an unpacked P).
// - The block unpacks a chunk into u8 tiles in shared memory: byte k of
//   the 4-item column of group g is bit g of item k's word (two byte
//   permutes per 8 groups, a shift and a mask per group); the B tile keeps
//   the weight's plane byte where the bit is set. Rows are padded by 16
//   bytes, so the ldmatrix reads of eight rows fall on distinct banks.
// - Eight warps, each a 64 x 32 corner of the tile, load fragments with
//   ldmatrix and accumulate in int32 registers: a product is at most 255,
//   so a slice of up to 2^23 items stays exact (255 * 2^23 < 2^31).
// - Split-K: the item slices multiply the tile pairs and planes until the
//   grid fills the card's resident block slots in whole waves, so 90
//   groups (a single tile pair) still spread over all 132 SMs.
// - Each block stores its int32 tile to a scratch slot of its own (plain
//   stores, no atomics: 2.4 M int64 atomics at the end of the 90-group
//   run cost 0.25 ms). A second kernel sums each output over the slices
//   and planes in int64, S[r, c] = sum acc_p << 8p, and writes it once,
//   with the mirrored S[c, r] of an off-diagonal tile through a
//   shared-memory transpose, so both writes are coalesced.
// Bits past n_groups in the last word are counted into the padded rows and
// columns of S, which the engine drops. Exact for weights below 2^31 and
// totals below 2^63.
//
// Plain C interface (bound with ctypes); every entry point returns the
// cudaError_t of its launches. Kernels run on the caller's stream and
// allocate nothing: pt_similarity_scratch gives the size of the scratch
// that the caller allocates.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

// similarity tiling
constexpr int kSimWords = 4;               // word rows per tile side
constexpr int kSimTile = 32 * kSimWords;   // 128 groups per tile side
constexpr int kSimK = 128;                 // items per staged chunk
constexpr int kSimRow = kSimK + 16;        // bytes per unpacked row, padded
constexpr int kSimThreads = 256;           // 8 warps: 2 x 4 of 64 x 32
constexpr int64_t kSimMaxSliceChunks = (int64_t)1 << 16;  // 2^23 items
constexpr int kSimTileElems = kSimTile * kSimTile;
constexpr int kSimSub = 32;                // reduce: 32 x 32 sub-tiles

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

// One chunk of kSimK items of the tile pair's packed words and weights.
struct SimChunk {
  uint32_t a[kSimWords][kSimK];
  uint32_t b[kSimWords][kSimK];
  uint32_t w[kSimK];
};

// Issue the copies of the chunk at item i0: 288 pieces of 16 bytes (4 items
// of 4 word rows of tile a, the same of tile b, the 128 weights). Word rows
// past n_words and items past n_items_pad are zero-filled.
__device__ __forceinline__ void sim_load(SimChunk& c, const uint32_t* M,
                                         const int32_t* W, int64_t n_words,
                                         int64_t n_items_pad, int64_t wa,
                                         int64_t wb, int64_t i0) {
  for (int k = threadIdx.x; k < 2 * kSimWords * 32 + 32; k += kSimThreads) {
    const int q = k & 31;  // 4-item quad of the chunk
    const int64_t i = i0 + 4 * q;
    const bool in = i < n_items_pad;
    if (k < 2 * kSimWords * 32) {
      const bool tb = k >= kSimWords * 32;
      const int row = (k >> 5) & (kSimWords - 1);
      const int64_t word = (tb ? wb : wa) + row;
      const bool ok = in && word < n_words;
      cp_async16(tb ? &c.b[row][4 * q] : &c.a[row][4 * q],
                 ok ? M + word * n_items_pad + i : M, ok);
    } else {
      cp_async16(&c.w[4 * q], in ? W + i : W, in);
    }
  }
}

// Unpack a staged chunk into the u8 tiles: thread t takes one word row and
// one 4-item quad (the A tile's rows in threads 0-127, the B tile's in
// 128-255) and writes the 4-byte item columns of the word's 32 groups.
__device__ __forceinline__ void sim_unpack(const SimChunk& c,
                                           uint8_t (*ua)[kSimRow],
                                           uint8_t (*ub)[kSimRow],
                                           int plane) {
  const int t = threadIdx.x;
  const bool tb = t >= kSimWords * 32;  // uniform across a warp
  const int row = (t >> 5) & (kSimWords - 1);
  const int q = t & 31;
  const uint4 x = *reinterpret_cast<const uint4*>(tb ? &c.b[row][4 * q]
                                                     : &c.a[row][4 * q]);
  uint32_t wp = 0u;  // byte k: plane byte of item k's weight
  if (tb) {
    const uint4 w = *reinterpret_cast<const uint4*>(&c.w[4 * q]);
    const unsigned sel = (unsigned)plane | ((unsigned)(plane + 4) << 4);
    wp = __byte_perm(__byte_perm(w.x, w.y, sel), __byte_perm(w.z, w.w, sel),
                     0x5410);
  }
  uint8_t(*u)[kSimRow] = tb ? ub : ua;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // byte j of the four words (groups 8j..8j+7), item k in byte k
    const unsigned sel = (unsigned)j | ((unsigned)(j + 4) << 4);
    const uint32_t col = __byte_perm(__byte_perm(x.x, x.y, sel),
                                     __byte_perm(x.z, x.w, sel), 0x5410);
#pragma unroll
    for (int bit = 0; bit < 8; ++bit) {
      uint32_t v = (col >> bit) & 0x01010101u;
      if (tb) v = (v * 0xFFu) & wp;  // 0x00 / 0xFF bytes select the weight
      *reinterpret_cast<uint32_t*>(&u[32 * row + 8 * j + bit][4 * q]) = v;
    }
  }
}

// The tile pair (a, b), a <= b, of index k in row-by-row order.
__device__ __forceinline__ void tile_pair(int64_t n_tiles, int64_t k,
                                          int64_t* a, int64_t* b) {
  int64_t r = 0;
  while (k >= n_tiles - r) {
    k -= n_tiles - r;
    ++r;
  }
  *a = r;
  *b = r + k;
}

// part: int32 [n_slices, n_planes, n_pairs, kSimTile, kSimTile]; the block
// (pair, slice, plane) writes its slot.
__global__ void __launch_bounds__(kSimThreads, 2)
    similarity_kernel(const uint32_t* __restrict__ M, int64_t n_words,
                      int64_t n_items_pad, const int32_t* __restrict__ W,
                      int64_t slice, int32_t* __restrict__ part) {
  __shared__ __align__(16) SimChunk chunk[2];
  __shared__ __align__(16) uint8_t ua[kSimTile][kSimRow];
  __shared__ __align__(16) uint8_t ub[kSimTile][kSimRow];
  const int64_t n_tiles = (n_words + kSimWords - 1) / kSimWords;
  int64_t a, b;
  tile_pair(n_tiles, blockIdx.x, &a, &b);
  const int plane = blockIdx.z;
  const int64_t lo = (int64_t)blockIdx.y * slice;
  const int64_t hi = lo + slice < n_items_pad ? lo + slice : n_items_pad;
  const int64_t n_chunks = (hi - lo + kSimK - 1) / kSimK;
  const int64_t wa = a * kSimWords, wb = b * kSimWords;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile rows wm*64, cols wn*32
  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  sim_load(chunk[0], M, W, n_words, n_items_pad, wa, wb, lo);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int64_t s = 0; s < n_chunks; ++s) {
    // chunk (s+1)&1 was last unpacked in step s-1, before its second sync
    if (s + 1 < n_chunks) {
      sim_load(chunk[(s + 1) & 1], M, W, n_words, n_items_pad, wa, wb,
               lo + (s + 1) * kSimK);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // chunk s has landed; the tiles of step s-1 are read
    sim_unpack(chunk[s & 1], ua, ub, plane);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSimK; kk += 32) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        // matrices: rows 0-7 / 8-15 of the m16 tile x items 0-15 / 16-31
        ldsm_x4(af[mi], &ua[wm * 64 + mi * 16 + (lane & 7) +
                            ((lane >> 3) & 1) * 8][kk + (lane >> 4) * 16]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        // matrices: n8 tile 2nj items 0-15 / 16-31, then tile 2nj+1
        ldsm_x4(bf[nj], &ub[wn * 32 + nj * 16 + (lane & 7) +
                            (lane >> 4) * 8][kk + ((lane >> 3) & 1) * 16]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_u8(acc[mi][ni], af[mi], bf[ni >> 1][2 * (ni & 1)],
                 bf[ni >> 1][2 * (ni & 1) + 1]);
    }
  }

  // accumulators e, e + 1 of m16n8 tile (mi, ni): row gid + 8 (e / 2),
  // columns 2 tig and 2 tig + 1
  const int gid = lane >> 2, tig = lane & 3;
  int32_t* slot =
      part + (((int64_t)blockIdx.y * gridDim.z + plane) * gridDim.x +
              blockIdx.x) * kSimTileElems;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int r = wm * 64 + mi * 16 + gid + (e >> 1) * 8;
        const int c = wn * 32 + ni * 8 + 2 * tig;
        *reinterpret_cast<int2*>(slot + r * kSimTile + c) =
            make_int2(acc[mi][ni][e], acc[mi][ni][e + 1]);
      }
}

// out[r, c] = sum over slices and planes of part << 8 * plane, for rows
// 8 blockIdx.y .. 8 blockIdx.y + 7 of the 32 x 32 sub-tile blockIdx.x % 16
// of tile pair blockIdx.x / 16; off the diagonal tiles also out[c, r],
// transposed through shared memory. A thread owns one output and sums the
// slices in kSimChains independent chains, so its loads overlap.
constexpr int kSimChains = 8;
__global__ void __launch_bounds__(kSimSub * 8)
    similarity_reduce_kernel(const int32_t* __restrict__ part,
                             int64_t n_words, int n_slices, int n_planes,
                             long long* __restrict__ out) {
  __shared__ long long t[8][kSimSub + 1];
  constexpr int kSubs = kSimTile / kSimSub;
  const int64_t n_tiles = (n_words + kSimWords - 1) / kSimWords;
  const int64_t n_pairs = n_tiles * (n_tiles + 1) / 2;
  const int64_t pair = blockIdx.x / (kSubs * kSubs);
  const int sub = blockIdx.x % (kSubs * kSubs);
  int64_t a, b;
  tile_pair(n_tiles, pair, &a, &b);
  const int r0 = (sub / kSubs) * kSimSub + blockIdx.y * 8;
  const int c0 = (sub % kSubs) * kSimSub;
  const int64_t gp = n_words * 32;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int32_t* src =
      part + pair * kSimTileElems + (int64_t)(r0 + ty) * kSimTile + c0 + tx;
  const int64_t step = n_pairs * kSimTileElems;  // the next (slice, plane)
  long long s = 0;
  for (int p = 0; p < n_planes; ++p) {
    unsigned long long ch[kSimChains] = {};
    int sl = 0;
    for (; sl + kSimChains <= n_slices; sl += kSimChains) {
#pragma unroll
      for (int u = 0; u < kSimChains; ++u) {
        ch[u] += (uint32_t)__ldg(src + ((int64_t)(sl + u) * n_planes + p) * step);
      }
    }
    for (; sl < n_slices; ++sl) {
      ch[0] += (uint32_t)__ldg(src + ((int64_t)sl * n_planes + p) * step);
    }
    unsigned long long sum = 0;
#pragma unroll
    for (int u = 0; u < kSimChains; ++u) sum += ch[u];
    s += (long long)(sum << (8 * p));
  }
  const int64_t r = a * kSimTile + r0 + ty, c = b * kSimTile + c0 + tx;
  if (r < gp && c < gp) out[r * gp + c] = s;
  if (a == b) return;  // a diagonal tile holds both halves already
  t[ty][tx] = s;
  __syncthreads();
  // thread k writes out[c0 + k / 8, r0 + k % 8]: 8 rows run along a column
  const int k = ty * kSimSub + tx;
  const int64_t rc = b * kSimTile + c0 + k / 8, rr = a * kSimTile + r0 + k % 8;
  if (rr < gp && rc < gp) out[rc * gp + rr] = t[k % 8][k / 8];
}

// The launch plan of pt_similarity, kept in this one place: the item slice
// is a whole number of chunks, and the slices are the fewest whose blocks
// (one per tile pair, slice and plane) fill the card's resident block slots
// to at least 85% over whole waves (else the best fill found), with no slice
// past kSimMaxSliceChunks chunks, where the int32 accumulators stay exact.
struct SimPlan {
  int64_t n_pairs = 0, n_chunks = 0, slice_items = 0, n_slices = 0;
  int64_t part_elems = 0;  // int32 scratch: n_slices * n_planes * n_pairs tiles
};

cudaError_t similarity_plan(int64_t n_words, int64_t n_items_pad, int n_planes,
                            SimPlan* plan) {
  if (n_words < 1 || n_items_pad < 0 || n_planes < 1 || n_planes > 4) {
    return cudaErrorInvalidValue;
  }
  const int64_t n_tiles = (n_words + kSimWords - 1) / kSimWords;
  plan->n_pairs = n_tiles * (n_tiles + 1) / 2;
  plan->n_chunks = (n_items_pad + kSimK - 1) / kSimK;
  const int64_t n_chunks = plan->n_chunks;
  if (n_chunks == 0) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, (const void*)similarity_kernel, kSimThreads, 0);
  if (e != cudaSuccess) return e;
  const int64_t resident = (int64_t)sms * (per_sm < 1 ? 1 : per_sm);
  const int64_t per_slice = plan->n_pairs * n_planes;
  const int64_t s_min = (n_chunks + kSimMaxSliceChunks - 1) / kSimMaxSliceChunks;
  int64_t s_max = 8 * ((resident + per_slice - 1) / per_slice);
  if (s_max > n_chunks) s_max = n_chunks;
  if (s_max < s_min) s_max = s_min;
  int64_t best = (n_chunks + s_min - 1) / s_min;
  double best_fill = 0.0;
  for (int64_t s = s_min; s <= s_max; ++s) {
    const int64_t chunks = (n_chunks + s - 1) / s;
    const int64_t blocks = per_slice * ((n_chunks + chunks - 1) / chunks);
    const int64_t waves = (blocks + resident - 1) / resident;
    const double fill = (double)blocks / (double)(waves * resident);
    if (fill > best_fill) {
      best_fill = fill;
      best = chunks;
    }
    if (fill >= 0.85) break;
  }
  // the same number of slices, evened out: no slice grows past best
  plan->n_slices = (n_chunks + best - 1) / best;
  plan->slice_items = (n_chunks + plan->n_slices - 1) / plan->n_slices * kSimK;
  plan->part_elems = plan->n_slices * n_planes * plan->n_pairs * kSimTileElems;
  return cudaSuccess;
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

// The int32 scratch elements that pt_similarity needs for this shape on the
// current device (no launch).
int pt_similarity_scratch(long long n_words, long long n_items_pad,
                          int n_planes, long long* part_elems) {
  SimPlan plan;
  cudaError_t e = similarity_plan(n_words, n_items_pad, n_planes, &plan);
  *part_elems = plan.part_elems;
  return (int)e;
}

// out[g, h] = sum_i W[i] * P[g, i] * P[h, i] for g, h < 32 * n_words; out
// is int64 [32 * n_words, 32 * n_words], every element written. W holds
// weights in [0, 256^n_planes); n_items_pad is a multiple of 4; M and W are
// 16-byte aligned; part is int32 scratch of part_elems elements, at least
// what pt_similarity_scratch gives.
int pt_similarity(const void* M, long long n_words, long long n_items_pad,
                  const void* W, int n_planes, void* part, long long part_elems,
                  void* out, void* stream) {
  if (n_items_pad % 4 != 0 ||
      ((uintptr_t)M | (uintptr_t)W | (uintptr_t)part) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  SimPlan plan;
  cudaError_t e = similarity_plan(n_words, n_items_pad, n_planes, &plan);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan.n_chunks == 0) {
    return (int)cudaMemsetAsync(out, 0, (size_t)(n_words * 32) *
                                            (size_t)(n_words * 32) * 8, s);
  }
  if (plan.part_elems > part_elems) return (int)cudaErrorInvalidValue;
  const int64_t n_subs =
      plan.n_pairs * (kSimTile / kSimSub) * (kSimTile / kSimSub);
  if (plan.n_pairs > 0x7FFFFFFF || plan.n_slices > 65535 ||
      n_subs > 0x7FFFFFFF) {
    return (int)cudaErrorInvalidConfiguration;
  }
  similarity_kernel<<<dim3((unsigned)plan.n_pairs, (unsigned)plan.n_slices,
                           (unsigned)n_planes),
                      kSimThreads, 0, s>>>(
      (const uint32_t*)M, n_words, n_items_pad, (const int32_t*)W,
      plan.slice_items, (int32_t*)part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  similarity_reduce_kernel<<<dim3((unsigned)n_subs, kSimSub / 8),
                             dim3(kSimSub, 8), 0, s>>>(
      (const int32_t*)part, n_words, (int)plan.n_slices, n_planes,
      (long long*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
