// Tag kernel for Hopper (sm_90a): the lean --predict-tags pass.
//
// Replaces the XLA body of the JAX package's
// Predictor.serve_tags_traced_fn (vaporetto_tpu/predictor.py:692-855; the
// JAX package has no Pallas kernel for it). It runs after the boundary
// kernel's full epilogue on the same batch and reads what that wrote: the
// padded int32 scores and the per-position char and type match ids. Per
// text row:
//   1. gaps: score > 0, same-type wsconst suppression, g < len - 1; span
//      gaps add the gaps beside codepoint 0 (padding, packed separators);
//   2. at each span end, the token id: a reversed-surface double-array
//      trie walk over cps[e], cps[e-1], ... as deep as the span (a token
//      only if the span is at most max_tok_len long and the node at that
//      depth holds one);
//   3. bias plus, for each (side, rel) probe table, the weight row of the
//      (tid, match[e + rel]) key, found by linear probing from slot
//      (tid*M1 + state*M2 mod 2^32) >> shift within probe_len slots;
//   4. per tag slot, the first maximum over the slot's classes;
//   5. outputs: the column-major gap bits (gap g at bit g / W8 of byte
//      g % W8), then the fused uint16 word (tid + 1) | (choice_s + 1) <<
//      (7 + 4s), or the tid at its narrow width and the int8 choices.
// Every value equals the plain version's (ops/tags.py serve_tags_plain)
// bit for bit; integer adds wrap as int32.
//
// What bounds it on this card: the work of its scattered gathers, not the
// bytes the function must move (it reads 4 B of score and 2 B of codepoint
// a position and a few match ids a token, and writes 2-4 B a position). A
// token is a chain of dependent gathers: trie walk rows, one a char (each
// needs the previous row's base) -> a match id -> its probe run -> the
// hit's row index -> the weight row; and every live char gathers its
// symbol. With 32 warps on an SM these gathers, and the instructions
// around them, keep the SM's load and issue pipes busy: a row's time
// follows how many gathers and instructions it takes, as much as how many
// round trips it waits for. So the design cuts both, and shrinks the
// tables so that the gathers hit the caches:
//
// 1. A warp per row, persistent blocks. Each warp takes its next row from
//    a global counter, fetched one row ahead, so ragged rows balance
//    across the card and no block waits on its slowest row; only
//    __syncwarp orders a row's phases. The last warp to finish zeroes the
//    counter for the next launch on the stream. The host picks the warps
//    per block from the shared memory a row needs, under a budget that
//    leaves the L1 room for the gathered tables (ops/tags.py
//    launch_geometry, SMEM_BUDGET), so every serve shape runs the same
//    code.
// 2. One pass over the text. The lanes read 32 gaps at a time (TEXT
//    windows in flight); a ballot keeps each window's gap bits and
//    span-gap bits as one word each; each live char's symbol is gathered
//    once and kept in shared memory; and the same pass lists the span
//    ends short enough to be tokens (ballot, popc), a span's length being
//    the distance to the last span gap below it in the window's word, or
//    the run of positions since the last span gap of the windows before.
//    The bits are written from the gap words; the outputs where no token
//    ends are written with 16-byte stores.
// 3. Walks before probes. All of a row's listed span ends are walked
//    first, WALKS a lane in lock step (each step issues every live walk's
//    row gather before it waits on any), and the token ends are compacted
//    in place to the front of the list, each token id kept in its end's
//    symbol slot (a walk reads only its own span's symbols, and spans do
//    not overlap). A row of random text lists about 85 span ends and finds
//    about 4 tokens, so the probes, sums and argmax run once a row, not
//    once per group of walks. A row holds up to L tokens; they go on in
//    groups of GROUP.
// 4. Token-parallel probes. The lanes take a group's (token, table) pairs,
//    PROBES each at once, so all its probe runs are in flight together
//    rather than one table after another. A probe stops at its key, at the
//    first empty slot, or after probe_len slots. Stopping at an empty slot
//    is exact: compile/tagdev.py _build_hash inserts round by round and
//    never frees a slot, so every slot from a key's home to its place is
//    occupied, and an empty slot on the run proves the key absent. Most
//    pairs miss, so this cuts the slots read from about 45 to about 9 a
//    token on chip_smoke's tagged 50k model.
// 5. Narrow probe records. A slot is an 8-byte (tid, state) key, 4 to a
//    sector; its row index sits in a separate array read only on a hit;
//    every weight row sits once in one (n_rows, C) array. The tagged 50k
//    model's tag tables take 25 MB this way, against 74 MB of inline
//    14-int rows, so with the boundary tables (16 MB) they fit the 50 MB
//    L2. The plain version keeps the JAX package's layouts.
// 6. Class scores in shared memory. The lanes take (row, class) pairs of
//    the group's bias rows and hit rows and add them with shared-memory
//    atomics; wrapping int32 adds commute, so any order gives the plain
//    version's sums. Then a lane per token takes each slot's first
//    maximum, starting from INT32_MIN with class 0, as the plain argmax
//    does. No thread keeps a per-table or per-class array, and no loop
//    divides: pair / n_tok is a multiply-high, the (row, class) index
//    steps by 32.
// 7. Registers: __launch_bounds__(MAX_THREADS, 1) caps a thread at 64
//    registers so that 32 warps fit one SM; WALKS, PROBES, SUMS and TEXT
//    are the widest batches at which ptxas reports no stack frame and no
//    spills (chip_smoke.py prints its report).
//
// Tensor cores, TMA and wgmma have nothing to do here: no matrices, and
// the reads are gathers, not tiles. What Hopper offers this kernel is many
// warps in flight, warp ballots, shared memory and shared-memory atomics,
// an L1 beside the shared memory, and an L2 large enough to hold the
// narrowed tables.

#include <cstdint>
#include <cuda_runtime.h>

// Mirrored field for field by ops/tags.py (_Args): every field is 8 bytes
// wide, so the layout has no padding.
struct VtTagsArgs {
  const void* cps;         // (B, L) uint16 or int32 codepoints
  const void* cts;         // (B, L) uint8 or int32 char types, or null
  const int32_t* lengths;  // (B,)
  int64_t B, L, cps_u16, cts_kind;  // cts_kind: 0 classify, 1 uint8, 2 int32
  const int32_t* scores;   // (B, S_pad) the boundary kernel's full epilogue
  int64_t S_pad, pad_left;
  const int32_t* char_match;  // (B, L) match ids, or null
  const int32_t* type_match;  // (B, L) match ids, or null
  int64_t ws_mask;            // bit t: wsconst on char type t
  const int2* rev_hash2;      // (P,) (key codepoint or -1, symbol)
  int64_t rev_mul, rev_shift;
  const int4* rev_walk;       // (n + 1,) (check, base, value, 0), dead last
  int64_t rev_slots, rev_root_base, max_tok_len;
  int64_t C, S;
  const int32_t* bias;        // (n_tokens, C)
  const int32_t* slot2;       // (n_tokens, 2S): slot offsets, then counts
  const int32_t* desc;        // (n_tabs, 8) probe table descriptors
  int64_t n_tabs;
  const int2* keys;           // every table's (tid, state) slots; tid -2 empty
  const int32_t* rows;        // each slot's weight row index
  const int32_t* w_rows;      // (n_rows, C)
  uint8_t* bits;              // (B, W8)
  int64_t W8, out_kind;       // 0: uint16 word; 1/2/3: int8/16/32 tid
  void* tid_out;              // (B, L)
  int8_t* choice_out;         // (B, L, S), null with the word
  int64_t row_bytes;          // a warp's working set in shared memory
  uint32_t* sched;            // (2,) next row, finished warps; 0 between
                              // launches
};

namespace {

using Args = VtTagsArgs;

constexpr int MAX_THREADS = 1024;
constexpr int DESC_W = 8;  // side, rel, shift, probe_len, size, first, 0, 0
constexpr int GROUP = 32;  // tokens whose probes and scores go together
constexpr int WALKS = 2;   // trie walks a lane advances together
constexpr int PROBES = 2;  // (token, table) pairs a lane probes together
constexpr int SUMS = 4;    // (row, class) adds a lane gathers together
constexpr int TEXT = 4;    // windows of 32 positions a lane loads together
constexpr int EMPTY = -2;  // compile/tagdev.py: ver_tid of an empty slot
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t M1 = 0x9E3779B1u;  // compile/tagdev.py _M1, _M2
constexpr uint32_t M2 = 0x85EBCA77u;

__host__ __device__ constexpr int64_t align16(int64_t n) {
  return (n + 15) & ~int64_t{15};
}

__device__ __forceinline__ bool in(int32_t c, int32_t lo, int32_t hi) {
  return c >= lo && c <= hi;
}

// Char type of a codepoint (reference sentence.rs:50-67; ops/match.py
// classify_types): digit 1, roman 2, hiragana 3, katakana 4, kanji 5,
// other 6; codepoint 0 (padding, separators) reads 0.
__device__ int32_t char_type(int32_t c) {
  if (c == 0) return 0;
  if (c >= 0x10000)
    return (in(c, 0x20000, 0x2A6DF) || in(c, 0x2A700, 0x2B73F) ||
            in(c, 0x2B740, 0x2B81F) || in(c, 0x2B820, 0x2CEAF) ||
            in(c, 0x2F800, 0x2FA1F))
               ? 5
               : 6;
  if (in(c, 0x30, 0x39) || in(c, 0xFF10, 0xFF19)) return 1;
  if (in(c, 0x41, 0x5A) || in(c, 0x61, 0x7A) || in(c, 0xFF21, 0xFF3A) ||
      in(c, 0xFF41, 0xFF5A))
    return 2;
  if (in(c, 0x3040, 0x3096)) return 3;
  if (in(c, 0x30A0, 0x30FA) || in(c, 0x30FC, 0x30FF) || in(c, 0xFF66, 0xFF9F))
    return 4;
  if (in(c, 0x3400, 0x4DBF) || in(c, 0x4E00, 0x9FFF) || in(c, 0xF900, 0xFAFF))
    return 5;
  return 6;
}

__device__ __forceinline__ int32_t load_ct(const Args& a, int64_t i) {
  if (a.cts_kind == 1) return __ldg(static_cast<const uint8_t*>(a.cts) + i);
  return __ldg(static_cast<const int32_t*>(a.cts) + i);
}

// Length of the span that ends at e: e minus the last span gap before e
// (-1 when there is none), or max_k + 1 once it is known to be longer
// than max_k.
__device__ __forceinline__ int span_len(const uint32_t* spanw, int e,
                                        int max_k) {
  int w = e >> 5;
  uint32_t m = spanw[w] & ((1u << (e & 31)) - 1u);
  for (;;) {
    if (m) return e - (w * 32 + 31 - __clz(m));
    if (w == 0) return e + 1;
    if (e - w * 32 + 1 > max_k) return max_k + 1;
    m = spanw[--w];
  }
}

// The working set of one warp's row in shared memory (ops/tags.py
// row_bytes lays it out the same way).
struct Row {
  uint32_t* gapw;   // (NW,) gap bits, 32 gaps a word
  uint32_t* spanw;  // (NW,) span-gap bits
  int32_t* sym;     // (L,) symbol of each live char; after the walks, the
                    // token id at each token end
  int32_t* list;    // (L,) span ends, then the token ends among them
  int2* tok;        // (GROUP,) a group's tokens (e, tid)
  uint32_t* hits;   // (GROUP * n_tabs,) hit weight row * GROUP + token
  int32_t* sc;      // (GROUP, C) class scores
};

__device__ __forceinline__ Row row_at(unsigned char* base, int L,
                                      int n_tabs) {
  const int NW = (L + 31) >> 5;
  Row w;
  w.gapw = reinterpret_cast<uint32_t*>(base);
  w.spanw = w.gapw + NW;
  base += align16(8 * int64_t{NW});
  w.sym = reinterpret_cast<int32_t*>(base);
  base += align16(4 * int64_t{L});
  w.list = reinterpret_cast<int32_t*>(base);
  base += align16(4 * int64_t{L});
  w.tok = reinterpret_cast<int2*>(base);
  w.hits = reinterpret_cast<uint32_t*>(w.tok + GROUP);
  w.sc = reinterpret_cast<int32_t*>(
      reinterpret_cast<unsigned char*>(w.hits) +
      align16(4 * int64_t{GROUP} * n_tabs));
  return w;
}

// Gap and span-gap words, the symbols of the live chars and the row's gap
// bits; and the list of span ends short enough to be tokens (w.list),
// whose count it returns. A span end's length comes from the ballot word
// of its window (the last span gap below it) or, when there is none, from
// the run of positions since the last span gap of the windows before.
template <typename CP>
__device__ __forceinline__ int gap_words(const Args& a, const Row& w,
                                         const CP* cps, int64_t r,
                                         int64_t row0, int len, int lane) {
  const int L = static_cast<int>(a.L);
  const int NW = (L + 31) >> 5;
  const int max_k = static_cast<int>(a.max_tok_len);
  const int32_t* scr = a.scores + r * a.S_pad + a.pad_left;
  const uint32_t mul = static_cast<uint32_t>(a.rev_mul);
  const uint32_t shift = static_cast<uint32_t>(a.rev_shift);
  const bool ws = a.ws_mask != 0, host_ct = a.cts_kind != 0;
  const unsigned lt = (1u << lane) - 1u;
  int n_c = 0;
  int run = 0;  // positions since the last span gap before this window
  for (int w0 = 0; w0 < NW; w0 += TEXT) {
    if (w0 * 32 >= len) {  // nothing live from here on
      for (int i = w0 + lane; i < NW; i += 32) {
        w.gapw[i] = 0;
        w.spanw[i] = 0;
      }
      break;
    }
    int32_t cp[TEXT], cp1[TEXT], sv[TEXT], c0[TEXT], c1[TEXT];
#pragma unroll
    for (int k = 0; k < TEXT; ++k) {  // all loads first: one round trip
      const int t = (w0 + k) * 32 + lane;
      cp[k] = cp1[k] = sv[k] = c0[k] = c1[k] = 0;
      if (t < len) cp[k] = static_cast<int32_t>(__ldg(cps + t));
      if (t + 1 < len) {
        cp1[k] = static_cast<int32_t>(__ldg(cps + t + 1));
        sv[k] = __ldg(scr + t);
        if (ws && host_ct) {
          c0[k] = load_ct(a, row0 + t);
          c1[k] = load_ct(a, row0 + t + 1);
        }
      }
    }
    int2 hs[TEXT];
#pragma unroll
    for (int k = 0; k < TEXT; ++k) {
      const int t = (w0 + k) * 32 + lane;
      hs[k] = make_int2(-1, 0);
      if (t < len)
        hs[k] = __ldg(a.rev_hash2 +
                      ((static_cast<uint32_t>(cp[k]) * mul) >> shift));
    }
#pragma unroll
    for (int k = 0; k < TEXT; ++k) {
      const int t = (w0 + k) * 32 + lane;
      bool gap = false, span = false;
      if (t + 1 < len) {  // gap t lies in the line
        gap = sv[k] > 0;
        if (gap && ws) {
          const int32_t t0 = host_ct ? c0[k] : char_type(cp[k]);
          const int32_t t1 = host_ct ? c1[k] : char_type(cp1[k]);
          if (t0 == t1 && t0 >= 0 && t0 < 63 && ((a.ws_mask >> t0) & 1))
            gap = false;
        }
        span = gap || cp[k] == 0 || cp1[k] == 0;
      }
      const unsigned gb = __ballot_sync(FULL, gap);
      const unsigned sb = __ballot_sync(FULL, span);
      if (lane == 0 && w0 + k < NW) {
        w.gapw[w0 + k] = gb;
        w.spanw[w0 + k] = sb;
      }
      if (t < len) w.sym[t] = hs[k].x == cp[k] ? hs[k].y : 0;
      // a span end: the last live char, or the char before a span gap
      const unsigned below = sb & lt;
      const int k_len = below ? lane - (31 - __clz(below)) : lane + 1 + run;
      const bool is_c = t < len && (span || t == len - 1) && k_len <= max_k;
      const unsigned cm = __ballot_sync(FULL, is_c);
      if (is_c) w.list[n_c + __popc(cm & lt)] = t;
      n_c += __popc(cm);
      run = sb ? __clz(sb) : min(run + 32, max_k + 1);
    }
  }
  __syncwarp();
  const int W8 = static_cast<int>(a.W8);
  const int G = L - 1;
  for (int i = lane; i < W8; i += 32) {
    unsigned v = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int g = j * W8 + i;
      if (g < G) v |= ((w.gapw[g >> 5] >> (g & 31)) & 1u) << j;
    }
    a.bits[r * W8 + i] = static_cast<uint8_t>(v);
  }
  return n_c;
}

// n bytes of value v from p: 16-byte stores when p and n allow them.
__device__ __forceinline__ void fill_bytes(uint8_t* p, int64_t n, uint8_t v,
                                           int lane) {
  if (((reinterpret_cast<uintptr_t>(p) | static_cast<uintptr_t>(n)) & 15) ==
      0) {
    const uint32_t v4 = 0x01010101u * v;
    const uint4 q = make_uint4(v4, v4, v4, v4);
    for (int64_t i = lane; i < n / 16; i += 32)
      reinterpret_cast<uint4*>(p)[i] = q;
  } else {
    for (int64_t i = lane; i < n; i += 32) p[i] = v;
  }
}

// The trie walks of the row's n_c span ends (w.list[0, n_c)), WALKS a
// lane in lock step: each step issues every live walk's row gather before
// it waits on any. A walk stops at its first dead transition or at its
// span's length. The token ends are compacted in place to the front of
// the list, each with its token id in w.sym[e] (a walk reads only the
// symbols of its own span, and spans do not overlap, so no later walk
// reads that slot). Returns the tokens found.
__device__ __forceinline__ int walk_spans(const Args& a, const Row& w,
                                          int n_c, int lane) {
  const int max_k = static_cast<int>(a.max_tok_len);
  const int last = static_cast<int>(a.rev_slots) - 1;
  const unsigned lt = (1u << lane) - 1u;
  int n_tok = 0;
  for (int i0 = 0; i0 < n_c; i0 += 32 * WALKS) {
    int e[WALKS], k[WALKS], node[WALKS], base[WALKS], tid[WALKS];
    bool live[WALKS];
#pragma unroll
    for (int q = 0; q < WALKS; ++q) {
      const int i = i0 + 32 * q + lane;
      live[q] = i < n_c;
      e[q] = live[q] ? w.list[i] : 0;
      k[q] = live[q] ? span_len(w.spanw, e[q], max_k) : 0;
      node[q] = 0;
      base[q] = static_cast<int>(a.rev_root_base);
      tid[q] = -1;
    }
    for (int j = 0;; ++j) {
      int c[WALKS];
      int4 t[WALKS];
#pragma unroll
      for (int q = 0; q < WALKS; ++q) {
        if (!live[q]) continue;
        c[q] = base[q] + w.sym[e[q] - j];
        // the plain version's gather clamps out-of-range slots, as XLA's
        t[q] = __ldg(a.rev_walk +
                     (c[q] < 0 ? 0 : (c[q] > last ? last : c[q])));
      }
      bool more = false;
#pragma unroll
      for (int q = 0; q < WALKS; ++q) {
        if (!live[q]) continue;
        if (t[q].x != node[q]) {  // dead: no token of this depth
          tid[q] = -1;
          live[q] = false;
          continue;
        }
        node[q] = c[q];
        base[q] = t[q].y;
        tid[q] = t[q].z;
        live[q] = j + 1 < k[q];
        more |= live[q];
      }
      if (!__any_sync(FULL, more)) break;
    }
    __syncwarp();  // every walk has read its span end and its symbols
#pragma unroll
    for (int q = 0; q < WALKS; ++q) {
      const bool is_tok = tid[q] >= 0;
      const unsigned m = __ballot_sync(FULL, is_tok);
      if (is_tok) {
        w.list[n_tok + __popc(m & lt)] = e[q];
        w.sym[e[q]] = tid[q];
      }
      n_tok += __popc(m);
    }
  }
  __syncwarp();
  return n_tok;
}

// One group of n <= GROUP tokens (token ends w.list[g0, g0 + n), their
// ids in w.sym): their probes, their class scores and their outputs.
__device__ __forceinline__ void token_group(const Args& a, const Row& w,
                                            const int32_t* desc, int g0,
                                            int n_tok, int64_t row0,
                                            int lane) {
  const int L = static_cast<int>(a.L), C = static_cast<int>(a.C);
  const int S = static_cast<int>(a.S), n_tabs = static_cast<int>(a.n_tabs);
  const unsigned lt = (1u << lane) - 1u;
  if (lane < n_tok) {
    const int e = w.list[g0 + lane];
    w.tok[lane] = make_int2(e, w.sym[e]);
  }
  for (int i = lane; i < n_tok * C; i += 32) w.sc[i] = 0;
  __syncwarp();

  // ---- probes: (token, table) pairs, table-major ----------------------
  int n_hits = 0;
  const int n_pairs = n_tok * n_tabs;
  // pair / n_tok as a multiply-high: exact for pair * n_tok < 2^32
  const uint32_t inv = n_tok > 1 ? 0xFFFFFFFFu / n_tok + 1u : 0u;
  for (int p0 = 0; p0 < n_pairs; p0 += 32 * PROBES) {
    int tab[PROBES], tok_j[PROBES], st[PROBES];
    uint32_t slot[PROBES];
    bool act[PROBES];
#pragma unroll
    for (int q = 0; q < PROBES; ++q) {  // match ids: one round trip
      const int pair = p0 + 32 * q + lane;
      act[q] = false;
      tab[q] = tok_j[q] = st[q] = 0;
      if (pair >= n_pairs) continue;
      tab[q] = n_tok > 1 ? static_cast<int>(__umulhi(pair, inv)) : pair;
      tok_j[q] = pair - tab[q] * n_tok;
      const int32_t* d = desc + tab[q] * DESC_W;
      const int32_t* m = d[0] ? a.type_match : a.char_match;
      if (m == nullptr || d[3] <= 0) continue;
      const int pos = w.tok[tok_j[q]].x + d[1];
      st[q] = pos < L ? __ldg(m + row0 + pos) : -1;
      act[q] = true;
    }
#pragma unroll
    for (int q = 0; q < PROBES; ++q) {
      const uint32_t t = static_cast<uint32_t>(w.tok[tok_j[q]].y);
      slot[q] = (t * M1 + static_cast<uint32_t>(st[q]) * M2) >>
                static_cast<uint32_t>(desc[tab[q] * DESC_W + 2]);
    }
    int hit[PROBES];  // the hit's slot in keys/rows, or -1
#pragma unroll
    for (int q = 0; q < PROBES; ++q) hit[q] = -1;
    for (int p = 0;; ++p) {
      int at[PROBES];
      int2 key[PROBES];
#pragma unroll
      for (int q = 0; q < PROBES; ++q) {  // the next slot of every run
        if (!act[q]) continue;
        const int32_t* d = desc + tab[q] * DESC_W;
        at[q] = d[5] + static_cast<int>((slot[q] + p) &
                                        (static_cast<uint32_t>(d[4]) - 1u));
        key[q] = __ldg(a.keys + at[q]);
      }
      bool more = false;
#pragma unroll
      for (int q = 0; q < PROBES; ++q) {
        if (!act[q]) continue;
        if (key[q].x == w.tok[tok_j[q]].y && key[q].y == st[q]) {
          hit[q] = at[q];
          act[q] = false;
        } else if (key[q].x == EMPTY || p + 1 >= desc[tab[q] * DESC_W + 3]) {
          act[q] = false;  // an empty slot, or the end of the run: a miss
        }
        more |= act[q];
      }
      if (!__any_sync(FULL, more)) break;
    }
    int row[PROBES];
#pragma unroll
    for (int q = 0; q < PROBES; ++q)
      row[q] = hit[q] >= 0 ? __ldg(a.rows + hit[q]) : 0;
#pragma unroll
    for (int q = 0; q < PROBES; ++q) {
      const unsigned hm = __ballot_sync(FULL, hit[q] >= 0);
      if (hit[q] >= 0)
        w.hits[n_hits + __popc(hm & lt)] =
            static_cast<uint32_t>(row[q]) * GROUP + tok_j[q];
      n_hits += __popc(hm);
    }
  }
  __syncwarp();

  // ---- class scores: the bias rows, then the hit rows, as (row, class)
  // pairs; wrapping int32 adds in any order give the plain sums ---------
  const int n_adds = (n_tok + n_hits) * C;
  int it = lane / C, c = lane - it * C;  // the row and class of pair i
  for (int i0 = 0; i0 < n_adds; i0 += 32 * SUMS) {
    int v[SUMS], at[SUMS];
#pragma unroll
    for (int q = 0; q < SUMS; ++q) {
      const int i = i0 + 32 * q + lane;
      at[q] = -1;
      v[q] = 0;
      if (i < n_adds && it < n_tok) {
        at[q] = it * C + c;
        v[q] = __ldg(a.bias + static_cast<int64_t>(w.tok[it].y) * C + c);
      } else if (i < n_adds) {
        const uint32_t h = w.hits[it - n_tok];
        at[q] = static_cast<int>(h % GROUP) * C + c;
        v[q] = __ldg(a.w_rows + static_cast<int64_t>(h / GROUP) * C + c);
      }
      for (c += 32; c >= C; c -= C) ++it;  // on to pair i + 32
    }
#pragma unroll
    for (int q = 0; q < SUMS; ++q)
      if (at[q] >= 0) atomicAdd(w.sc + at[q], v[q]);
  }
  __syncwarp();

  // ---- per slot, the first maximum; outputs ---------------------------
  if (lane < n_tok) {
    const int2 tk = w.tok[lane];
    const int32_t* sc = w.sc + lane * C;
    const int32_t* oc = a.slot2 + static_cast<int64_t>(tk.y) * 2 * S;
    const int64_t at = row0 + tk.x;
    uint32_t word = static_cast<uint32_t>(tk.y + 1);
    for (int s = 0; s < S; ++s) {
      const int32_t o = __ldg(oc + s), cnt = __ldg(oc + S + s);
      int32_t ch = -1;
      if (cnt >= 2) {
        // the first maximum over all C classes, those outside [o, o + cnt)
        // reading INT32_MIN: class 0 when nothing in range beats that
        int best_c = 0;
        int32_t best = INT32_MIN;
        const int hi = o + cnt < C ? o + cnt : C;
        for (int c = o < 0 ? 0 : o; c < hi; ++c) {
          if (sc[c] > best) {
            best = sc[c];
            best_c = c;
          }
        }
        ch = best_c - o;
      }
      if (a.choice_out) a.choice_out[at * S + s] = static_cast<int8_t>(ch);
      if (a.out_kind == 0)  // the word holds S <= 2 slots
        word |= static_cast<uint32_t>(ch + 1) << (7 + 4 * s);
    }
    switch (a.out_kind) {
      case 0:
        static_cast<uint16_t*>(a.tid_out)[at] =
            static_cast<uint16_t>(word & 0xFFFFu);
        break;
      case 1:
        static_cast<int8_t*>(a.tid_out)[at] = static_cast<int8_t>(tk.y);
        break;
      case 2:
        static_cast<int16_t*>(a.tid_out)[at] = static_cast<int16_t>(tk.y);
        break;
      default:
        static_cast<int32_t*>(a.tid_out)[at] = tk.y;
    }
  }
  __syncwarp();  // the next group reuses the token slots and the scores
}

template <typename CP>
__global__ void __launch_bounds__(MAX_THREADS, 1) tags_kernel(const Args a) {
  // the probe table descriptors, then each warp's row working set
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int L = static_cast<int>(a.L), S = static_cast<int>(a.S);
  const int n_tabs = static_cast<int>(a.n_tabs);
  int32_t* desc = reinterpret_cast<int32_t*>(smem);
  for (int i = threadIdx.x; i < n_tabs * DESC_W; i += blockDim.x)
    desc[i] = a.desc[i];
  const Row w = row_at(smem + align16(4 * int64_t{DESC_W} * n_tabs) +
                           static_cast<int64_t>(warp) * a.row_bytes,
                       L, n_tabs);

  // rows come from the counter; the next row's index and length are
  // fetched while this row is worked on
  auto next_row = [&]() {
    int r = 0;
    if (lane == 0) r = static_cast<int>(atomicAdd(&a.sched[0], 1u));
    return __shfl_sync(FULL, r, 0);
  };
  int r = next_row();
  int len_r = r < a.B ? a.lengths[r] : 0;
  __syncthreads();  // the descriptors
  while (r < a.B) {
    const int len = len_r < 0 ? 0 : (len_r > L ? L : len_r);
    const int64_t row0 = static_cast<int64_t>(r) * L;
    const int r_next = next_row();
    const int len_next = r_next < a.B ? a.lengths[r_next] : 0;

    // ---- outputs where no token ends: tid -1 (the word 0), choices -1 ----
    const int tid_bytes = a.out_kind == 0 ? 2 : 1 << (a.out_kind - 1);
    fill_bytes(static_cast<uint8_t*>(a.tid_out) + row0 * tid_bytes,
               int64_t{L} * tid_bytes, a.out_kind == 0 ? 0 : 0xFF, lane);
    if (a.choice_out)
      fill_bytes(reinterpret_cast<uint8_t*>(a.choice_out) + row0 * S,
                 int64_t{L} * S, 0xFF, lane);

    // ---- gap words, symbols, bits, span ends; walks; token groups ------
    const int n_c = gap_words(a, w, static_cast<const CP*>(a.cps) + row0, r,
                              row0, len, lane);
    __syncwarp();  // the list, and the defaults before any token's output
    const int n_tok = walk_spans(a, w, n_c, lane);
    for (int g0 = 0; g0 < n_tok; g0 += GROUP)
      token_group(a, w, desc, g0, n_tok - g0 < GROUP ? n_tok - g0 : GROUP,
                  row0, lane);
    __syncwarp();  // the next row reuses this warp's working set
    r = r_next;
    len_r = len_next;
  }

  // the last warp to finish leaves the row counter at 0 for the next launch
  if (lane == 0) {
    __threadfence();
    const unsigned total = gridDim.x * static_cast<unsigned>(n_warps);
    if (atomicAdd(&a.sched[1], 1u) == total - 1) {
      atomicExch(&a.sched[0], 0u);
      atomicExch(&a.sched[1], 0u);
    }
  }
}

const void* pick(int cps_u16) {
  return cps_u16 ? reinterpret_cast<const void*>(tags_kernel<uint16_t>)
                 : reinterpret_cast<const void*>(tags_kernel<int32_t>);
}

cudaError_t allow_smem(int cps_u16, int device) {
  int limit = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(pick(cps_u16),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              limit);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of `device` with `blocks` blocks of
// `threads` threads and `smem_bytes` of dynamic shared memory (the probe
// table descriptors, then a.row_bytes per warp). Returns
// cudaGetLastError() (0 = ok).
int vt_tags(const VtTagsArgs* a, int blocks, int threads, int64_t smem_bytes,
            void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cps_u16 = static_cast<int>(a->cps_u16);
  if (smem_bytes > 48 * 1024) {
    e = allow_smem(cps_u16, device);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  void* params[] = {const_cast<VtTagsArgs*>(a)};
  e = cudaLaunchKernel(pick(cps_u16), dim3(blocks), dim3(threads), params,
                       static_cast<size_t>(smem_bytes),
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Largest dynamic shared memory a block may opt into on `device`, or -1.
int vt_tags_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Blocks of `threads` threads with `smem_bytes` of dynamic shared memory
// that one SM holds at once, or minus the CUDA error.
int vt_tags_occupancy(int cps_u16, int threads, int64_t smem_bytes,
                      int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  e = allow_smem(cps_u16, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, pick(cps_u16), threads, static_cast<size_t>(smem_bytes));
  if (e != cudaSuccess) return -static_cast<int>(e);
  return n;
}

// Most threads a block of this kernel may have (its __launch_bounds__).
int vt_tags_max_threads() { return MAX_THREADS; }

}  // extern "C"
