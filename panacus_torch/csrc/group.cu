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
// Whether item i counts changes only at its present groups; each change is
// +W / -W in a difference array over the groups, and out is its prefix sum.
// What bounds it: one read of M (4 * n_words bytes an item) and the scan of
// every item over every group. Walking the set bits of one item a thread
// (__ffs) waits at each bit on a dependent load of thr[g]: 0.25-0.32 ms on
// 3.6 M random items of 90 groups, of which shared int64 atomics (CAS
// loops) on the difference array take at most 0.035 ms (H100 80GB HBM3,
// 700 W; PERF.md). So nothing here walks bits. The design:
// - Bit-sliced over items. A warp takes 1024 items a step of its grid
//   stride, a lane 32 of them, 128 apart (eight 16-byte copies a word row,
//   each reading 512 contiguous bytes across the warp), and transposes its
//   32 x 32 bit block in registers (two rounds of byte permutes, three of
//   shifts and masks), so that word b holds group 32 wd + b of its 32
//   items, one bit each. Every counter is kept as bit planes over those 32
//   items.
// - The clamped thresholds step by 0 or 1 (ceil((g + 1) q) for q in
//   [0, 1]; the wrapper rejects others), so an item at a present group
//   counts when dif = cum - thr[g] >= 0: NB + 1 planes in two's complement,
//   moved by p - step with one full adder a step (two logic operations a
//   plane, NB = 7 up to 126 groups), the sign plane read off. No step
//   branches, so the unrolled steps of a word row are one block of code.
//   Thresholds are clamped to [0, n_groups + 1], the same decisions for
//   cum in [1, n_groups].
// - Where the chunks of 1024 items are too few to fill the card (many
//   groups, few items), 2, 4 or 8 warps of a block share a chunk, each
//   scanning a segment of its word rows: each first counts its items'
//   present groups in its rows and the last of them, leaves both in its
//   buffer, and after a barrier starts from the counts of the segments
//   before its own (dif, and whether the item counted at its last present
//   group); every segment's counts give the coverage.
// - Each step leaves a lane's switches at its group in the warp's buffer
//   in shared memory: with one weight on all the warp's items (unit
//   counts), the count switched on less off; else the masks of the items
//   switched on and off. After a word row lane l sums column l (each lane
//   starting at its own column: no bank conflicts), weighing the switched
//   items with the weights the warp keeps in shared memory, exact in
//   int64, into the warp's own difference array in shared memory, no
//   atomic. Up to 768 groups every warp has its own array; up to what a
//   block may opt into, one block array takes the warps' sums with shared
//   atomics; past that they go to global memory. Each block adds its sums
//   to the global difference array.
// - One launch: the last block to finish (a counter after __threadfence)
//   takes the prefix sum into out and leaves the difference array and the
//   counter zero for the next call.
// On 3.6 M random items of 90 groups (H100 80GB HBM3, 700 W; PERF.md) it
// takes about 0.057 ms at every quorum: some 0.030 reading M and the
// weights, 0.020 the scan steps (at 128 registers a thread, two blocks of
// 256 an SM), 0.003 the column sums, 0.002 the end; a coverage floor
// above 1 adds 0.008 (a second read of M for the coverage).
// Counts past 65,534 groups take the NB = 31 instantiation (counts and
// the last present group as two ints an item in the exchange, one coverage
// word an item); the 16-plane one keeps its packed 16-bit counts below.
// The TPU version's [G, B] int32 temporaries and block-size policy have no
// counterpart here.
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

// similarity tiling
constexpr int kSimWords = 4;               // word rows per tile side
constexpr int kSimTile = 32 * kSimWords;   // 128 groups per tile side
constexpr int kSimK = 128;                 // items per staged chunk
constexpr int kSimRow = kSimK + 16;        // bytes per unpacked row, padded
constexpr int kSimThreads = 256;           // 8 warps: 2 x 4 of 64 x 32
constexpr int64_t kSimMaxSliceChunks = (int64_t)1 << 16;  // 2^23 items
constexpr int kSimTileElems = kSimTile * kSimTile;
constexpr int kSimSub = 32;                // reduce: 32 x 32 sub-tiles

// ordered growth
constexpr int kOgThreads = 256;
constexpr int kOgWarps = kOgThreads / 32;
constexpr int kOgPrivateBytes = 48 * 1024;  // per-warp arrays up to 768 groups
constexpr unsigned kFull = 0xFFFFFFFFu;
// the largest group count: 32 n_words and n_groups + 1 stay int32
constexpr int kOgMaxGroups = 0x7FFFFFFF - 32;
// per warp in shared memory: its switches of one word row (32 groups x
// 32 lanes x on, off), its lanes' weights (32 rows of 32, padded to 33),
// each lane's one weight
constexpr int kOgBufInts = 32 * 64;
constexpr int kOgWInts = 32 * 33;
constexpr size_t kOgBufBytes = kOgWarps * (kOgBufInts + kOgWInts + 32) * sizeof(int);

// Where the warps' sums go: each warp's own shared array, one block-shared
// array (shared atomics), or the global difference array (atomics).
enum OgTier { kOgPrivate = 0, kOgBlock = 1, kOgGlobal = 2 };

// The 32 x 32 bit block x transposed in place: afterwards bit k of x[b] is
// what bit b of x[k] was.
__device__ __forceinline__ void transpose32(uint32_t (&x)[32]) {
  // rounds 16 and 8 swap half words and bytes: one byte permute a word
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const uint32_t a = x[k], b = x[k + 16];
    x[k] = __byte_perm(a, b, 0x5410);
    x[k + 16] = __byte_perm(a, b, 0x7632);
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if ((k & 8) == 0) {
      const uint32_t a = x[k], b = x[k + 8];
      x[k] = __byte_perm(a, b, 0x6240);
      x[k + 8] = __byte_perm(a, b, 0x7351);
    }
  }
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const int j = 4 >> l;
    const uint32_t m = j == 4 ? 0x0F0F0F0Fu : j == 2 ? 0x33333333u : 0x55555555u;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if ((k & j) == 0) {
        const uint32_t t = ((x[k] >> j) ^ x[k + j]) & m;
        x[k] ^= t << j;
        x[k + j] ^= t;
      }
    }
  }
}

// The 32 words of word row `row` of a lane's items: quads q0 + 32 j for j
// < 8 (so each load of the warp reads 512 contiguous bytes), zero past the
// last quad. Bit k = 4 j + s of the lane's masks is item 4 (q0 + 32 j) + s.
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ row,
                                           int64_t q0, int64_t n_quads,
                                           uint32_t (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + 32 * j < n_quads) {
      v = __ldg(reinterpret_cast<const uint4*>(row) + q0 + 32 * j);
    }
    x[4 * j] = v.x;
    x[4 * j + 1] = v.y;
    x[4 * j + 2] = v.z;
    x[4 * j + 3] = v.w;
  }
}

__device__ __forceinline__ int clamp_thr(int32_t t, int n_groups) {
  return t < 0 ? 0 : t > n_groups ? n_groups + 1 : t;
}

// The 32 scan steps of one word row (groups g0 .. g0 + gn - 1) of a
// lane's items: x holds the transposed words, bit b of `one` says that the
// clamped threshold steps by 1 into group g0 + b (else by 0). dif = cum -
// thr[g] in NB + 1 planes moves by p - step with one full adder, and an
// item at a present group counts when dif >= 0. Each step leaves the
// lane's switches at its group in the warp's buffer: with one weight on
// all the warp's items (kUni), the count of items switched on less those
// switched off (buf[b * 32 + lane]); else the masks of the items switched
// on and off (buf[b * 64 + lane], buf[b * 64 + 32 + lane]), which the
// column sums weigh. No step branches.
template <int NB, bool kUni>
__device__ __forceinline__ void scan_word(const uint32_t (&x)[32], int gn,
                                          uint32_t E, uint32_t one,
                                          uint32_t (&dif)[NB + 1], uint32_t& ok,
                                          int* buf) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    if (b < gn) {  // the same across the warp; bits past n_groups skipped
      const uint32_t p = x[b] & E;
      // dif += a, a = p - step: bit 0 of a is p ^ step, the bits above
      // are step & ~p (a = -1 where the step is 1 and p is 0)
      const uint32_t dm = (one >> b) & 1u ? kFull : 0u;
      const uint32_t a = dm & ~p;
      uint32_t carry = dif[0] & (p ^ dm);
      dif[0] ^= p ^ dm;
#pragma unroll
      for (int i = 1; i <= NB; ++i) {
        const uint32_t n = (dif[i] & a) | (carry & (dif[i] | a));
        dif[i] ^= a ^ carry;
        carry = n;
      }
      const uint32_t now = (ok & ~p) | (~dif[NB] & p);
      const uint32_t sw = now ^ ok;
      ok = now;
      if constexpr (kUni) {
        buf[b * 32 + lane] = __popc(sw & now) - __popc(sw & ~now);
      } else {
        buf[b * 64 + lane] = (int)(sw & now);
        buf[b * 64 + 32 + lane] = (int)(sw & ~now);
      }
    }
  }
}

// Segment seg's part of the exchange: what a lane's items hold in word
// rows [r0, r1). Up to 65,534 groups (kWide false) one int an item,
// buf[k * 32 + lane] for item k: bits 16-31 the number of present groups,
// bits 0-15 one past the last of them (0: none). Past that (kWide) two:
// the count in buf[k * 32 + lane], one past the last in buf[1024 + k * 32 +
// lane] (the warp's buffer holds 2048 ints).
template <bool kWide>
__device__ __forceinline__ void seg_counts(const uint32_t* __restrict__ M,
                                           int64_t r0, int64_t r1,
                                           int64_t n_words, int64_t n_items_pad,
                                           int64_t q0, uint32_t last_mask,
                                           int* buf) {
  const int lane = threadIdx.x & 31;
  const int64_t n_quads = n_items_pad / 4;
  uint32_t st[32];
  uint32_t lst[kWide ? 32 : 1];
#pragma unroll
  for (int k = 0; k < 32; ++k) st[k] = 0u;
#pragma unroll
  for (int k = 0; k < (kWide ? 32 : 1); ++k) lst[k] = 0u;
  for (int64_t wd = r0; wd < r1; ++wd) {
    uint32_t x[32];
    load_words(M + wd * n_items_pad, q0, n_quads, x);
    const uint32_t m = wd == n_words - 1 ? last_mask : kFull;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const uint32_t v = x[k] & m;
      if (v) {
        const uint32_t last = (uint32_t)(32 * wd + 32 - __clz(v));
        if constexpr (kWide) {
          st[k] += __popc(v);
          lst[k] = last;
        } else {
          st[k] = (((st[k] >> 16) + __popc(v)) << 16) | last;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    buf[k * 32 + lane] = (int)st[k];
    if constexpr (kWide) buf[1024 + k * 32 + lane] = (int)lst[k];
  }
}

// The scan state of a lane's items where segment seg starts (word row r0),
// from the exchange of the chunk's n_seg segments (segment s's buffer at
// seg0 + s * stride): dif = cum - thr[32 r0 - 1] in planes, with cum the
// present groups before r0; ok where the item counted at the last of
// them. The items whose coverage (every segment's count) is below c_min
// leave E.
template <int NB>
__device__ __forceinline__ void seg_start(const int* seg0, int stride, int seg,
                                          int n_seg, int64_t r0, int n_groups,
                                          const int32_t* __restrict__ thr,
                                          int c_min, uint32_t& E,
                                          uint32_t (&dif)[NB + 1],
                                          uint32_t& ok) {
  const int lane = threadIdx.x & 31;
  const int t_prev = r0 > 0 ? clamp_thr(__ldg(thr + 32 * r0 - 1), n_groups) : 0;
  for (int k = 0; k < 32; ++k) {
    int cum = 0, last = 0, cov = 0;
    for (int s = 0; s < n_seg; ++s) {
      const int* b = seg0 + s * stride + k * 32 + lane;
      int n, l;
      if constexpr (NB > 16) {
        n = b[0];
        l = b[1024];
      } else {
        n = (int)((uint32_t)b[0] >> 16);
        l = b[0] & 0xFFFF;
      }
      if (s < seg) {
        cum += n;
        last = l ? l : last;  // later segments hold later groups
      }
      cov += n;
    }
    if (cov < c_min) E &= ~(1u << k);
    const int d = cum - t_prev;  // two's complement in NB + 1 bits
#pragma unroll
    for (int i = 0; i <= NB; ++i) dif[i] |= (uint32_t)((d >> i) & 1) << k;
    if (last > 0 && cum >= clamp_thr(__ldg(thr + last - 1), n_groups)) {
      ok |= 1u << k;
    }
  }
  ok &= E;
}

// The scan of the grid's chunks of 1024 items (32 a lane) over the
// groups; each warp adds its per-group sums into acc. Each chunk's word
// rows are split between n_seg warps of one block (n_seg = 1, 2, 4 or 8):
// segment seg scans rows [r0, r1) after an exchange through the warps'
// buffers gives it the state at r0.
template <int NB>
__device__ __forceinline__ void ordered_scan(
    const uint32_t* __restrict__ M, int64_t n_words, int64_t n_items_pad,
    int n_groups, const int32_t* __restrict__ W, const int32_t* __restrict__ thr,
    int c_min, int n_seg, int tier, unsigned long long* acc, int* buf,
    int* wts, int* wus, int stride) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t n_quads = n_items_pad / 4;
  const int64_t n_chunks = (n_quads + 255) / 256;
  const uint32_t last_mask =
      (n_groups % 32) ? ((1u << (n_groups % 32)) - 1u) : kFull;
  const int seg = warp % n_seg, per_block = kOgWarps / n_seg;
  const int64_t r0 = seg * n_words / n_seg, r1 = (seg + 1) * n_words / n_seg;
  int* seg0 = buf - seg * stride;  // the buffer of the chunk's segment 0
  // c is the same across the block, chunk across the warp
  for (int64_t c = (int64_t)blockIdx.x * per_block; c < n_chunks;
       c += (int64_t)gridDim.x * per_block) {
    const int64_t chunk = c + warp / n_seg;
    const int64_t q0 = chunk * 256 + lane;  // past n_quads for no chunk
    // E: the items that can count (weight != 0); uni: they share weight wu
    uint32_t E = 0u;
    int32_t wu = 0;
    bool uni = true;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (q0 + 32 * j < n_quads) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(W) + q0 + 32 * j);
        const int32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          wts[lane * 33 + 4 * j + s] = ws[s];
          if (ws[s] != 0) {
            E |= 1u << (4 * j + s);
            uni = uni && (wu == 0 || wu == ws[s]);
            wu = ws[s];
          }
        }
      }
    }
    uint32_t dif[NB + 1];
#pragma unroll
    for (int i = 0; i <= NB; ++i) dif[i] = 0u;
    uint32_t ok = 0u;
    // a chunk's segments share its items, so E is the same across them
    const bool live = __any_sync(kFull, E);
    if (n_seg > 1) {  // the same across the block
      if (live) seg_counts<(NB > 16)>(M, r0, r1, n_words, n_items_pad, q0, last_mask, buf);
      __syncthreads();
      if (live) {
        seg_start<NB>(seg0, stride, seg, n_seg, r0, n_groups, thr, c_min, E,
                      dif, ok);
      }
      __syncthreads();  // every exchange read before a buffer is reused
    } else if (c_min > 1 && live) {  // c_min <= 1 is implied by cum >= 1
      // the coverage of item k: up to 65,534 groups, items 2 h and 2 h + 1
      // in the 16-bit halves of cov[h]; past that, one word an item
      constexpr int kCov = NB > 16 ? 32 : 16;
      uint32_t cov[kCov];
#pragma unroll
      for (int h = 0; h < kCov; ++h) cov[h] = 0u;
      for (int64_t wd = 0; wd < n_words; ++wd) {
        uint32_t x[32];
        load_words(M + wd * n_items_pad, q0, n_quads, x);
        const uint32_t m = wd == n_words - 1 ? last_mask : kFull;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          if constexpr (NB > 16) {
            cov[k] += __popc(x[k] & m);
          } else {
            cov[k / 2] += __popc(x[k] & m) << (16 * (k & 1));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const uint32_t ck =
            NB > 16 ? cov[k % kCov] : (cov[k / 2] >> (16 * (k & 1))) & 0xFFFFu;
        if (ck < (uint32_t)c_min) E &= ~(1u << k);
      }
    }
    if (!__any_sync(kFull, E)) continue;
    const bool all_uni = __all_sync(kFull, uni);
    wus[lane] = wu;
    // the clamped threshold of the group before the segment
    int t_last = r0 > 0 ? clamp_thr(__ldg(thr + 32 * r0 - 1), n_groups) : 0;
    for (int64_t wd = r0; wd < r1; ++wd) {
      uint32_t x[32];
      load_words(M + wd * n_items_pad, q0, n_quads, x);
      transpose32(x);
      const int g0 = (int)wd * 32;
      const int gn = n_groups - g0 < 32 ? n_groups - g0 : 32;
      // lane b: the clamped threshold of group g0 + b; `one`: the groups
      // whose threshold steps by 1 from the group before
      const int t_lane =
          lane < gn ? clamp_thr(__ldg(thr + g0 + lane), n_groups) : 0;
      const int t_prev = __shfl_up_sync(kFull, t_lane, 1);
      const uint32_t one =
          __ballot_sync(kFull, t_lane - (lane == 0 ? t_last : t_prev) == 1);
      t_last = __shfl_sync(kFull, t_lane, gn - 1);
      if (all_uni) {
        scan_word<NB, true>(x, gn, E, one, dif, ok, buf);
      } else {
        scan_word<NB, false>(x, gn, E, one, dif, ok, buf);
      }
      __syncwarp();
      if (lane < gn) {
        // lane l sums group g0 + l over the 32 lanes, each lane starting
        // at its own column (no bank conflicts): counts times the lanes'
        // weights, or the weights of the switched items
        long long s = 0;
        if (all_uni) {
#pragma unroll 8
          for (int j = 0; j < 32; ++j) {
            const int r = (j + lane) & 31;
            s += (long long)wus[r] * buf[lane * 32 + r];
          }
        } else {
          for (int j = 0; j < 32; ++j) {
            const int r = (j + lane) & 31;
            const uint32_t on = buf[lane * 64 + r], off = buf[lane * 64 + 32 + r];
            for (uint32_t m = on | off; m; m &= m - 1u) {
              const int k = __ffs(m) - 1;
              const long long wk = wts[r * 33 + k];
              s += (on >> k) & 1u ? wk : -wk;
            }
          }
        }
        if (s != 0) {
          unsigned long long* a = acc + g0 + lane;
          if (tier == kOgPrivate) {
            *a += (unsigned long long)s;
          } else {
            atomicAdd(a, (unsigned long long)s);  // two's complement
          }
        }
      }
      __syncwarp();  // the buffer is read before the next word row
    }
  }
}

// diff: int64 [n_groups + 1], zero on entry (the last entry is the block
// counter); the last block leaves it zero again.
template <int NB>
__global__ void __launch_bounds__(kOgThreads)
    ordered_growth_kernel(const uint32_t* __restrict__ M, int64_t n_words,
                          int64_t n_items_pad, int n_groups,
                          const int32_t* __restrict__ W,
                          const int32_t* __restrict__ thr, int c_min, int n_seg,
                          int tier, unsigned long long* diff,
                          long long* __restrict__ out) {
  // dynamic shared memory: the difference arrays, then each warp's
  // switch buffer, lane weights and one weight a lane
  extern __shared__ unsigned long long sdiff[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_shared =
      tier == kOgPrivate ? kOgWarps * n_groups : tier == kOgBlock ? n_groups : 0;
  int* buf = reinterpret_cast<int*>(sdiff + n_shared) +
             warp * (kOgBufInts + kOgWInts + 32);
  int* wts = buf + kOgBufInts;
  int* wus = wts + kOgWInts;
  __shared__ unsigned long long wsum[kOgWarps];
  __shared__ bool last;
  for (int k = threadIdx.x; k < n_shared; k += blockDim.x) sdiff[k] = 0ull;
  __syncthreads();
  unsigned long long* acc = tier == kOgPrivate ? sdiff + warp * n_groups
                            : tier == kOgBlock ? sdiff
                                               : diff;
  ordered_scan<NB>(M, n_words, n_items_pad, n_groups, W, thr, c_min, n_seg,
                   tier, acc, buf, wts, wus, kOgBufInts + kOgWInts + 32);
  __syncthreads();
  if (tier != kOgGlobal) {
    for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
      unsigned long long s = sdiff[g];
      if (tier == kOgPrivate) {
        for (int w = 1; w < kOgWarps; ++w) s += sdiff[w * n_groups + g];
      }
      if (s != 0ull) atomicAdd(diff + g, s);
    }
  }
  __threadfence();  // this block's sums before its count
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(diff + n_groups, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // out[j] = sum_{g <= j} diff[g]: each thread a contiguous chunk, the
  // chunk sums scanned across the block
  const int chunk = (n_groups + blockDim.x - 1) / blockDim.x;
  const int lo = threadIdx.x * chunk;
  const int hi = lo + chunk < n_groups ? lo + chunk : n_groups;
  unsigned long long s = 0ull;
  for (int g = lo; g < hi; ++g) s += __ldcg(diff + g);  // from L2
  unsigned long long incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  unsigned long long run = incl - s;
  for (int w = 0; w < warp; ++w) run += wsum[w];
  for (int g = lo; g < hi; ++g) {
    run += __ldcg(diff + g);
    out[g] = (long long)run;
    diff[g] = 0ull;
  }
  if (threadIdx.x == 0) diff[n_groups] = 0ull;
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
// thresholds thr (int32 [n_groups] whose values clamped to [0, n_groups +
// 1] step by 0 or 1 from 0; others give undefined results) and coverage
// floor c_min, for 1 to kOgMaxGroups groups; n_items_pad is a multiple of 4
// and M and W are 16-byte aligned. diff is int64 scratch of n_groups + 1
// entries, zero on entry; the kernel leaves it zero. out is int64
// [n_groups]. One launch.
int pt_ordered_growth(const void* M, long long n_words, long long n_items_pad,
                      int n_groups, const void* W, const void* thr, int c_min,
                      void* diff, void* out, void* stream) {
  if (n_groups < 1 || n_groups > kOgMaxGroups || n_words != (n_groups + 31) / 32 ||
      n_items_pad < 0 || n_items_pad % 4 != 0 ||
      ((uintptr_t)M | (uintptr_t)W) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  int optin = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return (int)e;
  const size_t bytes = (size_t)n_groups * sizeof(unsigned long long);
  const int tier = kOgWarps * bytes <= (size_t)kOgPrivateBytes ? kOgPrivate
                   : bytes + kOgBufBytes <= (size_t)optin      ? kOgBlock
                                                               : kOgGlobal;
  const size_t smem = kOgBufBytes + (tier == kOgPrivate ? kOgWarps * bytes
                                     : tier == kOgBlock ? bytes
                                                        : 0);
  // bit planes for counts up to n_groups + 1 (NB = 31: any int32 count)
  const void* kernel = n_groups < 127     ? (const void*)ordered_growth_kernel<7>
                       : n_groups < 2047  ? (const void*)ordered_growth_kernel<11>
                       : n_groups < 65535 ? (const void*)ordered_growth_kernel<16>
                                          : (const void*)ordered_growth_kernel<31>;
  e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // the blocks resident at once; a chunk of 1024 items is a warp's work
  int resident = 0;
  e = grid_size(kernel, kOgThreads, smem, INT64_MAX / 2, &resident);
  if (e != cudaSuccess) return (int)e;
  const int64_t n_chunks = (n_items_pad / 4 + 255) / 256;
  // split each chunk's word rows between 2, 4 or 8 warps while the split
  // chunks still fit in the resident warps at once and every segment keeps
  // at least 4 word rows (its exchange costs about one)
  int n_seg = 1;
  while (n_seg < kOgWarps && n_chunks * 2 * n_seg <= (int64_t)resident * kOgWarps &&
         n_words >= 8 * n_seg) {
    n_seg *= 2;
  }
  const int64_t want = (n_chunks * n_seg + kOgWarps - 1) / kOgWarps;
  int blocks = (int)(want < resident ? want : resident);
  if (blocks < 1) blocks = 1;  // no items: the one block writes zeros
  void* args[] = {(void*)&M, &n_words, &n_items_pad, &n_groups, (void*)&W,
                  (void*)&thr, &c_min, &n_seg, (void*)&tier, &diff, &out};
  return (int)cudaLaunchKernel(kernel, dim3(blocks), dim3(kOgThreads), args, smem,
                               (cudaStream_t)stream);
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
