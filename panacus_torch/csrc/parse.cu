// Parse of GFA step lists into node membership rows, on the card.
//
// Replaces no TPU kernel: panacus_tpu parses every P/W line on the host
// (native/gfa_scan.c:pt_tokenize_pack, ported unchanged) and uploads the
// packed rows. For builds that count no edges nothing reads the host's ids
// afterwards, so panacus_torch/stream.py uploads the GFA's bytes from the
// first step list to the last in one copy, and this kernel turns them into
// M's rows.
//
// Each step list has a descriptor {begin, end, span, bit | walk << 8 | word
// << 16} in the text, ascending. Each thread owns kWindow bytes of the text
// and parses every token that its bytes start: a list's first token, the
// token after each ',' of a P list, the token at each '>'/'<' of a W list;
// it skips the bytes between lists (the rest of the GFA's lines). A token
// is checked exactly as the host tokenizer checks it (digits, then '+'/'-'
// followed by ',' or the list's end; or '>'/'<' then digits followed by
// '>'/'<' or the list's end; an id in 1..n_items, the value wrapping mod
// 2^64 as the host's does), and may run past the thread's window up to its
// list's end. A good token ORs its group bit into M[word, id] (word < 0: a
// path in no group, counted only) and adds to its span's token count and
// bp, the node_lens sum: per thread while its window stays in one list,
// then a segmented sum over the warp and one atomic per span per warp. A
// bad token puts its span into the error slot (the least such span), and
// the host discards the build.
//
// What bounds it on Hopper: one read of the text (the steps' bytes) plus a
// random 4-byte read of node_lens and an atomic OR per step, both in L2 (a
// node row is 2.5 MB at 634,000 nodes). The upload over the host link is
// slower than the kernel by an order of magnitude, so it is kept simple:
// byte loads through L1, no shared memory.
//
// Plain C interface (bound with ctypes); the entry point returns the
// cudaError_t of its launch. The kernel runs on the caller's stream and
// allocates nothing.

#include <limits.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWindow = 32;  // text bytes a thread owns
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool is_orient_w(uint8_t c) {
  return c == '>' || c == '<';
}

// The id of the P token at s[q, ...) in a list ending at e, or 0.
__device__ __forceinline__ int64_t token_p(const uint8_t* __restrict__ s,
                                           int64_t q, int64_t e,
                                           int64_t n_items) {
  uint64_t v = 0;
  int64_t i = q;
  for (; i < e; ++i) {
    const unsigned d = (unsigned)s[i] - '0';
    if (d > 9) break;
    v = v * 10 + d;
  }
  if (i == q || i >= e) return 0;  // no digit, or no orientation
  if (s[i] != '+' && s[i] != '-') return 0;
  if (i + 1 < e && s[i + 1] != ',') return 0;
  const int64_t id = (int64_t)v;
  return id >= 1 && id <= n_items ? id : 0;
}

// The id of the W token whose orientation byte is s[q], or 0.
__device__ __forceinline__ int64_t token_w(const uint8_t* __restrict__ s,
                                           int64_t q, int64_t e,
                                           int64_t n_items) {
  if (!is_orient_w(s[q])) return 0;
  uint64_t v = 0;
  int64_t i = q + 1;
  for (; i < e; ++i) {
    const unsigned d = (unsigned)s[i] - '0';
    if (d > 9) break;
    v = v * 10 + d;
  }
  if (i == q + 1) return 0;
  if (i < e && !is_orient_w(s[i])) return 0;
  const int64_t id = (int64_t)v;
  return id >= 1 && id <= n_items ? id : 0;
}

struct Span {
  int64_t begin, end, span, meta;
};

__device__ __forceinline__ Span load_span(const long long* __restrict__ descs,
                                          int64_t d) {
  const long long* x = descs + 4 * d;
  return Span{x[0], x[1], x[2], x[3]};
}

__global__ void parse_pack_kernel(const uint8_t* __restrict__ text,
                                  int64_t n_bytes,
                                  const long long* __restrict__ descs,
                                  int64_t n_descs, uint32_t* __restrict__ M,
                                  int64_t row_stride,
                                  const uint32_t* __restrict__ node_lens,
                                  int64_t n_items, long long* __restrict__ acc,
                                  int64_t n_spans) {
  const int64_t w0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * (int64_t)kWindow;
  int64_t key = -1;  // the descriptor whose sums the thread holds
  long long cnt = 0, bp = 0;
  int64_t span = 0;
  if (w0 < n_bytes) {
    const int64_t w1 = w0 + kWindow < n_bytes ? w0 + kWindow : n_bytes;
    int64_t lo = 0, hi = n_descs - 1;  // the last list starting at or before w0
    while (lo < hi) {
      const int64_t mid = (lo + hi + 1) >> 1;
      if (descs[4 * mid] <= w0) lo = mid; else hi = mid - 1;
    }
    int64_t d = lo;
    Span sp = load_span(descs, d);
    key = d;
    span = sp.span;
    for (int64_t p = w0; p < w1; ++p) {
      if (p >= sp.end) {  // the window runs past this list
        if (cnt || bp) {
          atomicAdd((unsigned long long*)&acc[1 + span], (unsigned long long)cnt);
          atomicAdd((unsigned long long*)&acc[1 + n_spans + span],
                    (unsigned long long)bp);
        }
        cnt = bp = 0;
        do ++d; while (d < n_descs && descs[4 * d + 1] <= p);
        if (d >= n_descs) break;
        sp = load_span(descs, d);
        key = d;
        span = sp.span;
      }
      if (p < sp.begin) {  // bytes between two lists
        p = sp.begin - 1;
        continue;
      }
      const uint8_t c = text[p];
      const bool walk = (sp.meta >> 8) & 1;
      // up to two tokens start here: a list's first, and the one after a ','
      int64_t q[2];
      int n_tok = 0;
      if (walk) {
        if (p == sp.begin || is_orient_w(c)) q[n_tok++] = p;
      } else {
        if (p == sp.begin) q[n_tok++] = p;
        if (c == ',') q[n_tok++] = p + 1;
      }
      for (int j = 0; j < n_tok; ++j) {
        const int64_t id = walk ? token_w(text, q[j], sp.end, n_items)
                                : token_p(text, q[j], sp.end, n_items);
        if (id == 0) {
          atomicMin(&acc[0], (long long)span);
          continue;
        }
        const int64_t word = sp.meta >> 16;
        if (word >= 0)
          atomicOr(&M[word * row_stride + id], 1u << (sp.meta & 31));
        cnt += 1;
        bp += node_lens[id];
      }
    }
  }
  // Windows of neighbouring lanes are neighbours in the text, so equal keys
  // form runs: a segmented sum from the right leaves each run's total in its
  // first lane.
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t k2 = __shfl_down_sync(kFull, key, off);
    const long long c2 = __shfl_down_sync(kFull, cnt, off);
    const long long b2 = __shfl_down_sync(kFull, bp, off);
    if (lane + off < 32 && k2 == key) {
      cnt += c2;
      bp += b2;
    }
  }
  const int64_t before = __shfl_up_sync(kFull, key, 1);
  if ((lane == 0 || before != key) && key >= 0 && (cnt || bp)) {
    atomicAdd((unsigned long long*)&acc[1 + span], (unsigned long long)cnt);
    atomicAdd((unsigned long long*)&acc[1 + n_spans + span], (unsigned long long)bp);
  }
}

}  // namespace

extern "C" {

// text: n_bytes bytes holding the step lists; descs: int64 [n_descs, 4], one
// row a non-empty list {begin, end, span, bit | walk << 8 | word << 16}, in
// text, ascending and not overlapping; M: uint32 [n_words, row_stride], rows
// ORed in place; node_lens: uint32 [n_items + 1]; acc: int64 [1 + 2 *
// n_spans], the error slot (LLONG_MAX while no token failed), then each
// span's token count, then each span's bp, all added to.
int pt_parse_pack(const uint8_t* text, int64_t n_bytes, const long long* descs,
                  int64_t n_descs, uint32_t* M, int64_t row_stride,
                  const uint32_t* node_lens, int64_t n_items, long long* acc,
                  int64_t n_spans, cudaStream_t stream) {
  if (n_descs < 1) return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)kThreads * kWindow;
  const int64_t blocks = (n_bytes + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  parse_pack_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      text, n_bytes, descs, n_descs, M, row_stride, node_lens, n_items, acc,
      n_spans);
  return (int)cudaGetLastError();
}

}  // extern "C"
