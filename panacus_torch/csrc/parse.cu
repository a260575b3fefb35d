// Parse of GFA step lists into node and edge membership rows, on the card.
//
// Replaces no TPU kernel: panacus_tpu parses every P/W line on the host
// (native/gfa_scan.c:pt_tokenize_pack, ported unchanged) and uploads the
// packed rows. Nothing reads the host's ids afterwards, so
// panacus_torch/stream.py uploads the GFA's bytes from the first step list
// to the last in one copy, and these kernels turn them into M's rows:
// pt_parse_pack the node rows, pt_parse_pack_edges the edge rows.
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
// Both kernels walk the windows with one template (walk_window) and differ
// in what they do at each token. The edge kernel parses each token with the
// same checks, and also the token after it in the same list (no pair
// crosses a list's end). It forms the pair's canonical key as the
// host's edge_canonical_key does (gfa_scan.c; orientation 1 for '-' and
// '<'), looks it up in the L lines' CSR adjacency (row_off, adj_ent of
// native.build_edge_adj: row u holds (vkey << 32) | eid sorted by vkey) as
// edge_adj_get does, and ORs the group bit into the edge M at [word, eid].
// A bad token or a pair with no L line puts its span into the error slot.
//
// What bounds them on Hopper: one read of the text (the steps' bytes) plus
// a random 4-byte read of node_lens (nodes) or of the 12.8 MB adjacency
// (edges) and an atomic OR per step, all in L2 (a node row is 2.5 MB, an
// edge row 3.8 MB at 634,000 nodes). The upload over the host link is
// slower than either kernel by an order of magnitude, so they are kept
// simple: byte loads through L1, no shared memory.
//
// Plain C interface (bound with ctypes); each entry point returns the
// cudaError_t of its launch. The kernels run on the caller's stream and
// allocate nothing.

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

// One step of a list ending at e: its id (0 where the token fails the
// checks of token_p / token_w), its orientation (1 for '-' or '<') and
// where the next token of the list starts (e where none does).
struct Step {
  int64_t id;
  uint64_t o;
  int64_t next;
};

__device__ __forceinline__ Step step_p(const uint8_t* __restrict__ s,
                                       int64_t q, int64_t e, int64_t n_items) {
  Step t{token_p(s, q, e, n_items), 0, e};
  if (t.id == 0) return t;
  int64_t i = q;
  while ((unsigned)s[i] - '0' <= 9) ++i;  // the orientation byte
  t.o = s[i] == '-';
  if (i + 1 < e) t.next = i + 2;  // after the ','
  return t;
}

__device__ __forceinline__ Step step_w(const uint8_t* __restrict__ s,
                                       int64_t q, int64_t e, int64_t n_items) {
  Step t{token_w(s, q, e, n_items), 0, e};
  if (t.id == 0) return t;
  int64_t i = q + 1;
  while (i < e && (unsigned)s[i] - '0' <= 9) ++i;
  t.o = s[q] == '<';
  t.next = i;  // the next '>'/'<', or e
  return t;
}

// The edge id of the pair (u, o1) -> (v, o2) in the CSR adjacency, or 0:
// canonical as edge_canonical_key (flip where u > v, or u == v and o1 is
// backward), then row cu searched for vkey as edge_adj_get searches it.
__device__ __forceinline__ int64_t edge_id(const long long* __restrict__ row_off,
                                           const unsigned long long* __restrict__ adj_ent,
                                           int64_t u, uint64_t o1, int64_t v,
                                           uint64_t o2) {
  const bool swap = u > v || (u == v && o1);
  const int64_t cu = swap ? v : u;
  const uint64_t cv = (uint64_t)(swap ? u : v);
  const uint64_t p1 = swap ? (o2 ^ 1u) : o1;
  const uint64_t p2 = swap ? (o1 ^ 1u) : o2;
  const uint64_t vkey = (cv << 2) | (p1 << 1) | p2;
  int64_t a = row_off[cu], b = row_off[cu + 1];
  if (b - a <= 8) {  // rows are canonical-unique: at most one entry matches
    int64_t eid = 0;
    for (int64_t i = a; i < b; ++i) {
      const uint64_t ent = adj_ent[i];
      if ((ent >> 32) == vkey) eid = (int64_t)(ent & 0xffffffffu);
    }
    return eid;
  }
  const int64_t end = b;
  while (a < b) {
    const int64_t mid = (a + b) >> 1;
    if ((adj_ent[mid] >> 32) < vkey) a = mid + 1; else b = mid;
  }
  return a < end && (adj_ent[a] >> 32) == vkey
             ? (int64_t)(adj_ent[a] & 0xffffffffu)
             : 0;
}

struct Span {
  int64_t begin, end, span, meta;
};

__device__ __forceinline__ Span load_span(const long long* __restrict__ descs,
                                          int64_t d) {
  const long long* x = descs + 4 * d;
  return Span{x[0], x[1], x[2], x[3]};
}

// Walks the window of kWindow bytes at w0 (< n_bytes): f.enter(d, sp) as
// it reaches each list d it touches, then f.token(sp, walk, q) for each
// token of that list that starts in the window, at q.
template <class F>
__device__ __forceinline__ void walk_window(const uint8_t* __restrict__ text,
                                            int64_t n_bytes,
                                            const long long* __restrict__ descs,
                                            int64_t n_descs, int64_t w0, F& f) {
  const int64_t w1 = w0 + kWindow < n_bytes ? w0 + kWindow : n_bytes;
  int64_t lo = 0, hi = n_descs - 1;  // the last list starting at or before w0
  while (lo < hi) {
    const int64_t mid = (lo + hi + 1) >> 1;
    if (descs[4 * mid] <= w0) lo = mid; else hi = mid - 1;
  }
  int64_t d = lo;
  Span sp = load_span(descs, d);
  f.enter(d, sp);
  for (int64_t p = w0; p < w1; ++p) {
    if (p >= sp.end) {  // the window runs past this list
      do ++d; while (d < n_descs && descs[4 * d + 1] <= p);
      if (d >= n_descs) break;
      sp = load_span(descs, d);
      f.enter(d, sp);
    }
    if (p < sp.begin) {  // bytes between two lists
      p = sp.begin - 1;
      continue;
    }
    const uint8_t c = text[p];
    const bool walk = (sp.meta >> 8) & 1;
    // up to two tokens start here: a list's first, and the one after a ','
    if (walk) {
      if (p == sp.begin || is_orient_w(c)) f.token(sp, walk, p);
    } else {
      if (p == sp.begin) f.token(sp, walk, p);
      if (c == ',') f.token(sp, walk, p + 1);
    }
  }
}

// The node pass: ORs each token's group bit into M at its id and sums the
// tokens and their bp of the list the thread is in (`key`, its descriptor).
struct NodeRows {
  const uint8_t* __restrict__ text;
  uint32_t* __restrict__ M;
  int64_t row_stride;
  const uint32_t* __restrict__ node_lens;
  int64_t n_items;
  long long* __restrict__ acc;
  int64_t n_spans;
  int64_t key = -1;
  int64_t span = 0;
  long long cnt = 0, bp = 0;

  __device__ void flush() {
    if (cnt || bp) {
      atomicAdd((unsigned long long*)&acc[1 + span], (unsigned long long)cnt);
      atomicAdd((unsigned long long*)&acc[1 + n_spans + span], (unsigned long long)bp);
    }
  }
  __device__ void enter(int64_t d, const Span& sp) {
    flush();
    cnt = bp = 0;
    key = d;
    span = sp.span;
  }
  __device__ void token(const Span& sp, bool walk, int64_t q) {
    const int64_t id = walk ? token_w(text, q, sp.end, n_items)
                            : token_p(text, q, sp.end, n_items);
    if (id == 0) {
      atomicMin(&acc[0], (long long)span);
      return;
    }
    const int64_t word = sp.meta >> 16;
    if (word >= 0) atomicOr(&M[word * row_stride + id], 1u << (sp.meta & 31));
    cnt += 1;
    bp += node_lens[id];
  }
};

// The edge pass: for each token, the pair it forms with the next token of
// its list, looked up in the adjacency, its group bit ORed into M at the
// edge id.
struct EdgeRows {
  const uint8_t* __restrict__ text;
  uint32_t* __restrict__ M;
  int64_t row_stride;
  const long long* __restrict__ row_off;
  const unsigned long long* __restrict__ adj_ent;
  int64_t n_items;
  long long* __restrict__ err;

  __device__ void enter(int64_t, const Span&) {}
  __device__ void token(const Span& sp, bool walk, int64_t q) {
    const Step a = walk ? step_w(text, q, sp.end, n_items)
                        : step_p(text, q, sp.end, n_items);
    if (a.id == 0) {
      atomicMin(err, (long long)sp.span);
      return;
    }
    if (a.next >= sp.end) return;  // the list's last step
    const Step b = walk ? step_w(text, a.next, sp.end, n_items)
                        : step_p(text, a.next, sp.end, n_items);
    if (b.id == 0) return;  // its own thread reports it
    const int64_t eid = edge_id(row_off, adj_ent, a.id, a.o, b.id, b.o);
    if (eid == 0) {
      atomicMin(err, (long long)sp.span);
      return;
    }
    const int64_t word = sp.meta >> 16;
    if (word >= 0) atomicOr(&M[word * row_stride + eid], 1u << (sp.meta & 31));
  }
};

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
  NodeRows f{text, M, row_stride, node_lens, n_items, acc, n_spans};
  if (w0 < n_bytes) walk_window(text, n_bytes, descs, n_descs, w0, f);
  // Windows of neighbouring lanes are neighbours in the text, so equal keys
  // form runs: a segmented sum from the right leaves each run's total in its
  // first lane.
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int64_t k2 = __shfl_down_sync(kFull, f.key, off);
    const long long c2 = __shfl_down_sync(kFull, f.cnt, off);
    const long long b2 = __shfl_down_sync(kFull, f.bp, off);
    if (lane + off < 32 && k2 == f.key) {
      f.cnt += c2;
      f.bp += b2;
    }
  }
  const int64_t before = __shfl_up_sync(kFull, f.key, 1);
  if ((lane == 0 || before != f.key) && f.key >= 0) f.flush();
}

__global__ void parse_pack_edges_kernel(
    const uint8_t* __restrict__ text, int64_t n_bytes,
    const long long* __restrict__ descs, int64_t n_descs,
    uint32_t* __restrict__ M, int64_t row_stride,
    const long long* __restrict__ row_off,
    const unsigned long long* __restrict__ adj_ent, int64_t n_items,
    long long* __restrict__ err) {
  const int64_t w0 =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * (int64_t)kWindow;
  EdgeRows f{text, M, row_stride, row_off, adj_ent, n_items, err};
  if (w0 < n_bytes) walk_window(text, n_bytes, descs, n_descs, w0, f);
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

// text, descs: as pt_parse_pack's; M: uint32 [n_words, row_stride], the
// edge rows, ORed in place (row_stride > the largest edge id); row_off:
// int64 [n_items + 2], adj_ent: uint64 [E], the CSR adjacency of
// native.build_edge_adj; err: one int64, the error slot (LLONG_MAX while no
// token failed and every pair had its edge), lowered to the least failing
// span.
int pt_parse_pack_edges(const uint8_t* text, int64_t n_bytes,
                        const long long* descs, int64_t n_descs, uint32_t* M,
                        int64_t row_stride, const long long* row_off,
                        const unsigned long long* adj_ent, int64_t n_items,
                        long long* err, cudaStream_t stream) {
  if (n_descs < 1) return (int)cudaErrorInvalidValue;
  const int64_t per_block = (int64_t)kThreads * kWindow;
  const int64_t blocks = (n_bytes + per_block - 1) / per_block;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  parse_pack_edges_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      text, n_bytes, descs, n_descs, M, row_stride, row_off, adj_ent, n_items,
      err);
  return (int)cudaGetLastError();
}

}  // extern "C"
