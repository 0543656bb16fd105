// Fused boundary-scoring kernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel ops/pallas_fused.py::build_fused_fn
// (pl.pallas_call at :242): per text row, codepoint -> symbol projection,
// the windowed double-array walk to the longest pattern id ending at each
// position, the shifted adds of the matched 8-wide weight chunks into a
// bias-initialised padded score row, and the type window scores (8^(2w)
// cache table, or a type-trie walk with its own chunk adds). Two epilogues:
//   full  - the padded int32 score row plus char/type match ids;
//   serve - score > 0, same-type wsconst suppression, the t < len-1 mask and
//           the column-major bit pack (gap g at bit g / W8 of byte g % W8).
// Either epilogue can also write the row's gap scores, the (B, L-1) int32
// slice sc[pad_left + g] of the padded score row (template GAP): the
// serve epilogue's --scores output, and the full epilogue's for the rich
// tag combinations. Without GAP the instantiation is the same code.
//
// What bounds it on this card: the latency of dependent table gathers, and
// how many of them are in flight. The bytes it must move are small (serve:
// 3 B per char in, 1 bit per gap out; about 2 us for an (8192, 256) batch at
// 3.35 TB/s). Every live position runs a chain of gathers, each waiting on
// the one before: hash slot -> root child row -> deeper walk rows (each
// needs the previous row's base) -> the matched pattern's record -> its
// weight chunks. The tables (50k-word model: 3.7 MB of walk rows, 1.9 MB of
// weight rows, the 1 MB type cache) stay in the 50 MB L2, so each link is an
// L2 round trip, not an HBM one; a warp's row is a sequence of such round
// trips. The design keeps many independent chains in flight and removes the
// links and the work it can:
//
// 1. A warp per row, persistent blocks. A block holds up to 32 warps (one
//    block per SM: the staged tables of point 4 are then loaded once per
//    SM); each warp takes its next row from a global counter, fetched one
//    row ahead, so ragged rows balance across the card and no block waits
//    on its slowest row. Inside a row only __syncwarp orders the phases;
//    the one block-wide barrier follows the staging. The host picks the
//    warps per block from the shared memory a row needs (ops/boundary.py
//    launch_geometry), so the packed (<=4096, 512) and the (8192, 128)
//    serving shapes run the same code. A row whose working set exceeds
//    shared memory runs the same code on a global scratch slice of its warp
//    (template SCRATCH; with SCRATCH false the compiler knows the working
//    set is in shared memory and emits shared-memory atomics). The row
//    counter resets itself: the last warp to finish zeroes it for the next
//    launch on the stream.
// 2. Overlapped walks, longest match without atomics. Lanes take the start
//    positions round robin (lane l: l, l + 32, ...; consecutive lanes read
//    consecutive symbols, so shared-memory reads have no bank conflicts)
//    and each lane advances WALKS walks together, issuing step j's row
//    gathers for all of them before it waits on any; the type-window
//    gathers of the same positions go out with the first step. Each walk
//    stops at its first dead transition (trie paths are prefix-closed) and
//    at the row's length. Each alive window [s, e] stores its node's
//    Aho-Corasick output link into best[e], and the longest window must
//    win: the chunks of starts run from the last to the first and the warp
//    takes the steps of a chunk together, so for every end position the
//    windows arrive shortest first and a plain int32 store keeps the JAX
//    walk's answer. (A 64-bit atomicMin on (start, link) compiles to a
//    compare-and-swap loop on shared memory and doubles the row's working
//    set.) The match adds batch their pattern-record and weight-chunk
//    gathers the same way (ADDS, ADD_LOADS per lane).
// 3. No work on padding, text on chip once. Positions at or past the row's
//    length are neither projected nor walked (padding holds codepoint 0,
//    whose symbol 0 has no transition, so the plain version finds no match
//    there either: the full epilogue writes -1). Each live char is read
//    once from global memory, TEXT chars per lane in flight (a warp reads
//    64 contiguous bytes of uint16 codepoints per instruction), projected,
//    typed, and kept in shared memory as its symbol and its uint8 type; the
//    type window, the type trie and wsconst read that copy. 16-byte vector
//    loads would save instructions, not round trips, and rows are not
//    16-byte aligned for every L, so they are not used.
// 4. Hot tables in shared memory. Every live position reads a hash slot and
//    then its root child row. Each block copies the hash table (P slots x
//    8 B; 64 KB for the 50k model) and a root-child record per symbol
//    (base, output link; 8 B) into shared memory once, with asynchronous
//    copies (cp.async) that are waited for only after the first row has
//    been fetched; the first two links of every chain are then shared-
//    memory reads. A model whose staged tables exceed the host's budget
//    (STAGE_BUDGET) reads the same records from global memory (template
//    STAGED false); the rows then get more of the shared memory.
// 5. Table records of one sector. Walk rows are padded to 16 B (check,
//    base, inherit, 0), so one aligned load fetches a row; a pattern's
//    (first weight row, row count, offset of the first row) is one 16-byte
//    record (the chunks of a pattern sit 8 slots apart, so one offset
//    places them all); a weight chunk is 32 B. The plain version keeps
//    reading the unpacked arrays.
// 6. Registers: __launch_bounds__(MAX_THREADS, 1) caps a thread at 64
//    registers so that 32 warps fit one SM; WALKS, ADDS, ADD_LOADS, TEXT
//    and SLOTS are the widest batches with which ptxas reports no spills
//    (the build log keeps its report; chip_smoke.py prints it).
//
// 7. The JAX package's variants, chosen per model by its switches when the
//    host builds the tables (ops/boundary.py boundary_tables), run by the
//    instantiations with VARIANTS; the others compile the walk and the type
//    cache alone. (Compiled into every instantiation, the probes made all of
//    them spill, and the small tables' code, never run by the default
//    model, cost its walk 3-5%: see PERF.md.)
//    - the CHD hash matcher (JAX ops/hashmatch.py) in place of the walk on
//      a side whose tables build (hash_row). Each lane takes end
//      positions t < len and looks pattern lengths k up directly, all
//      lanes at the same length: the window's rolling hash, grown one
//      symbol a length from the row's symbols in shared memory, picks a
//      bucket, and the bucket's record (2 or 4 bytes, staged with the hot
//      tables and read by shared-memory loads) holds its displacement and
//      a fingerprint mask of its patterns' hashes. A window whose
//      fingerprint bit is clear equals none of them, so most lengths end
//      there, in shared memory; the others (a true match, or a false pass
//      of the filter) take the displacement to the entry row, whose
//      pattern symbols are compared with the window's and whose last int
//      is the pattern id. The loads of SLOTS lengths go out before any is
//      waited on. A window holding symbol 0 (padding, separator, OOV, or
//      before the row start) ends a position's lengths, since pattern
//      symbols are >= 1. Lengths go ascending and a later match
//      overwrites, so the longest wins, and best[t] holds what the walk
//      stores there. (Filtering by the symbols a length's patterns end or
//      start with would skip almost nothing on a large vocabulary: on the
//      50k model nearly every symbol ends a pattern of every length. Two
//      positions a lane, or SLOTS 3, spilled at the 64-register cap.) The
//      type window score is gathered with the pattern records in
//      add_matches.
//    - the type window score from the 8^(2w) cache (global memory), from
//      2w per-offset tables of 8^M entries, or from left, crossing and right
//      tables (the mode a warp-uniform runtime argument). The cache is
//      gathered inside the walk (or the probes), where its latency hides.
//      The small tables are read in the row's bias store (bias_small),
//      after the text pass and before any match is added: the store that
//      writes the bias writes bias + type score, so they take no pass and
//      no atomic of their own, and the walk's registers stay as they were.
//      Each (mode, window, M or maxn) the compiler builds has its own code
//      (bias_small_row), in which a gap's shifts, masks and table offsets
//      are constants. A lane takes two adjacent gaps (SMALL_RUN), whose
//      windows of 2w+M-1 (split: 2w) types share all but one: the run's
//      types are loaded together, tested against the row's ends only
//      within that many chars of them, and each gap's 2w (split: 3)
//      lookups go out before any of them is added.
//      Tables within the host's budget (SMALL_STAGE_BUDGET) are staged and
//      read by shared-memory loads (a pointer built from the shared-memory
//      base); larger ones (per-offset at M = 4: 98 KB) by __ldg. Staging
//      costs the packed shape two or three warps of rows, and is still the
//      faster of the two there (see PERF.md).
//
// Tensor cores, wgmma and TMA tiles have nothing to work on here: the
// kernel multiplies no matrices and its reads are gathers, not tiles. What
// Hopper offers this kernel is shared memory (227 KB a block), asynchronous
// copies into it, many warps in flight, and int32 shared-memory atomics;
// scores accumulate with int32 atomicAdd, exact and independent of order
// for wrapping integers.

#include <atomic>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// Mirrored field for field by ops/boundary.py (_Args): every field is
// 8 bytes wide, so the layout has no padding. Declared outside the
// anonymous namespace so the extern "C" entry taking it keeps external
// linkage.
struct VtBoundaryArgs {
  const void* cps;          // (B, L) uint16 or int32 codepoints
  const void* cts;          // (B, L) uint8 or int32 char types, or null
  const int32_t* lengths;   // (B,)
  int64_t B, L, cps_u16, cts_kind;  // cts_kind: 0 classify, 1 uint8, 2 int32
  // char side (hash2 == null: no char matcher)
  const int2* hash2;        // (P,) (key codepoint or -1, symbol)
  int64_t hash_mul, hash_shift, hash_slots;
  const int2* c_root;       // (R,) root child on symbol s: (base, inherit),
  int64_t c_root_n;         //      inherit == NO_CHILD: no child
  const int4* c_walk;       // (n_slots,) (check, base, inherit, 0)
  int64_t c_slots, c_root_base, c_max_len;
  const int4* c_ids;        // (n_ids,) (first row, row count, offset, 0)
  const int4* c_w8;         // (n_rows, 2): 8 int32 weights per row
  // type cache (null: none)
  const int32_t* t_cache;   // (8^(2w),); null unless t_mode is 1
  int64_t t_window;
  // type trie (null: none)
  const int4* t_walk;
  int64_t t_slots, t_root_base, t_max_len;
  const int4* t_ids;
  const int4* t_w8;
  int64_t bias, pad_left, S;
  // full epilogue (scores non-null)
  int32_t* scores;          // (B, S)
  int32_t* char_match;      // (B, L) or null
  int32_t* type_match;      // (B, L) or null
  // serve epilogue (bits non-null)
  uint8_t* bits;            // (B, W8)
  int64_t W8, ws_mask;      // ws_mask bit c: wsconst on char type c
  // gap scores, either epilogue (null: none)
  int32_t* gap_scores;      // (B, gap_stride), gap_stride = L - 1
  int64_t gap_stride;
  // a warp's row working set: shared memory, or a global scratch slice of
  // row_bytes per warp when scratch is non-null
  uint8_t* scratch;
  int64_t row_bytes;
  uint32_t* sched;          // (2,) next row, finished warps; 0 between
                            // launches
  // (the variants' fields last: the fields above keep their offsets)
  // hash matcher of the char side / of the type trie (rows null: the walk)
  const int4* c_hm_rows;    // entry rows: pairs, -1, the id last
  const void* c_hm_rec;     // bucket records, c_hm_rec_bytes each
  int64_t c_hm_rec_bytes, c_hm_rec_size;  // 2 or 4; bytes, a multiple of 16
  const int* c_hm_meta;     // (kmax, 8) length records
  int64_t c_hm_kmax, c_hm_base;
  const int4* t_hm_rows;
  const void* t_hm_rec;
  int64_t t_hm_rec_bytes, t_hm_rec_size;
  const int* t_hm_meta;
  int64_t t_hm_kmax, t_hm_base;
  // type table: 0 none, 1 cache (t_cache), 2 per-offset, 3 split (t_small)
  int64_t t_mode;
  const int32_t* t_small;   // 2w tables of 8^M, or left | crossing | right
  int64_t t_small_size, t_m;  // bytes (a multiple of 16); M, or maxn
  // byte offsets into dynamic shared memory (-1: read from global memory)
  int64_t sm_c_rec, sm_t_rec, sm_small, sm_c_meta, sm_t_meta, sm_rows;
};

namespace {

using Args = VtBoundaryArgs;

constexpr int MAX_THREADS = 1024;
// Batch widths, as measured on an H100 (PERF.md): wider batches keep more
// gathers in flight per lane but spill at the 64-register cap of 32 warps
// per SM, and spilled registers then make round trips of their own.
constexpr int WALKS = 2;      // walks a lane advances together
constexpr int ADDS = 2;       // pattern records a lane gathers together
constexpr int ADD_LOADS = 2;  // first weight chunks gathered together
constexpr int TEXT = 4;       // chars a lane loads together
constexpr int SLOTS = 2;      // hash lengths a lane probes together
constexpr int NO_CHILD = -2;  // below every output link (>= -1)
constexpr uint32_t HASH_C1 = 0x9E3779B1u;  // the CHD bucket multiplier
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int64_t align16(int64_t n) {
  return (n + 15) & ~int64_t{15};
}

// Reference CharacterType::get_type ranges (sentence.rs:50-67), as in
// native/common.h; codepoint 0 (padding, packed separator) reads as 0.
__device__ __forceinline__ int char_type(uint32_t c) {
  if (c == 0) return 0;
  if ((c >= 0x30 && c <= 0x39) || (c >= 0xFF10 && c <= 0xFF19)) return 1;
  if ((c >= 0x41 && c <= 0x5A) || (c >= 0x61 && c <= 0x7A) ||
      (c >= 0xFF21 && c <= 0xFF3A) || (c >= 0xFF41 && c <= 0xFF5A))
    return 2;
  if (c >= 0x3040 && c <= 0x3096) return 3;
  if ((c >= 0x30A0 && c <= 0x30FA) || (c >= 0x30FC && c <= 0x30FF) ||
      (c >= 0xFF66 && c <= 0xFF9F))
    return 4;
  if ((c >= 0x3400 && c <= 0x4DBF) || (c >= 0x4E00 && c <= 0x9FFF) ||
      (c >= 0xF900 && c <= 0xFAFF) || (c >= 0x20000 && c <= 0x2A6DF) ||
      (c >= 0x2A700 && c <= 0x2B73F) || (c >= 0x2B740 && c <= 0x2B81F) ||
      (c >= 0x2B820 && c <= 0x2CEAF) || (c >= 0x2F800 && c <= 0x2FA1F))
    return 5;
  return 6;
}

// A record of a table that is staged in shared memory (STAGED) or read
// from global memory through the read-only path.
template <bool STAGED>
__device__ __forceinline__ int2 table_ld(const int2* p) {
  if (STAGED) return *p;
  return __ldg(p);
}

// The n types from char t-w+1 on, 3 bits each, the first highest;
// positions outside the line read type 0. n = 2w is gap t's window.
__device__ __forceinline__ uint32_t type_window(const uint8_t* ty, int t,
                                                int len, int w, int n) {
  uint32_t seq = 0;
  for (int i = 0; i < n; ++i) {
    const int j = t + i - (w - 1);
    seq = (seq << 3) | ((j >= 0 && j < len) ? ty[j] : 0u);
  }
  return seq;
}

// The small type tables (t_mode 2 per-offset, 3 split), for a window W and
// MM (per-offset: M, the types a table's code reads; split: maxn) fixed at
// compile time: every shift, mask and table offset below is a constant,
// and the loops unroll.
constexpr int TYPE_POS = 2;
constexpr int TYPE_SPLIT = 3;

// The types of a run of adjacent gaps from g on: the N types from char
// g-W+1 on, 3 bits each, the first highest, chars outside the line reading
// type 0 (for a run of K gaps whose windows hold N-K+1 types each, gap
// g+k's window is the N-K+1 from the k-th on). The N loads go out
// together; only a run within N chars of an end of the line tests them.
template <int N, int W>
__device__ __forceinline__ uint32_t window_code(const uint8_t* ty, int g,
                                                int len) {
  uint32_t v[N];
  if (g >= W - 1 && g + N - W < len) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = ty[g - (W - 1) + i];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = g - (W - 1) + i;
      v[i] = static_cast<unsigned>(j) < static_cast<unsigned>(len) ? ty[j]
                                                                   : 0u;
    }
  }
  uint32_t seq = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) seq = (seq << 3) | v[i];
  return seq;
}

// An entry of a small table: staged (a pointer built from the shared-
// memory base, so a shared-memory load) or read through the read-only
// path.
template <bool SMEM>
__device__ __forceinline__ uint32_t small_ld(const int32_t* t, uint32_t i) {
  return static_cast<uint32_t>(SMEM ? t[i] : __ldg(t + i));
}

// Gap code seq's type window score from the small tables; the sum wraps.
// Per-offset: table j (of 8^MM entries) at the code of the MM types from
// window position j on (types past the window too; the tables ignore
// them), the 2W lookups issued before any is added. Split: the left half
// (8^W entries), the crossing middle (positions W-MM+1 .. W+MM-2; 8^(2MM-2)
// entries, at least 8) and the right half.
template <int MODE, int W, int MM, bool SMEM>
__device__ __forceinline__ uint32_t small_sum(uint32_t seq,
                                              const int32_t* tab) {
  if constexpr (MODE == TYPE_POS) {
    constexpr int N = 2 * W + MM - 1;
    constexpr uint32_t NC = 1u << (3 * MM);
    uint32_t v[2 * W];
#pragma unroll
    for (int j = 0; j < 2 * W; ++j)
      v[j] = small_ld<SMEM>(tab + j * NC, (seq >> (3 * (N - MM - j))) &
                                              (NC - 1));
    uint32_t s = 0;
#pragma unroll
    for (int j = 0; j < 2 * W; ++j) s += v[j];
    return s;
  } else {
    constexpr int MID = 2 * MM - 2;
    constexpr uint32_t NS = 1u << (3 * W);
    constexpr uint32_t NM = 1u << (3 * (MID > 0 ? MID : 1));
    const uint32_t l = small_ld<SMEM>(tab, seq >> (3 * W));
    const uint32_t m = small_ld<SMEM>(
        tab + NS, (seq >> (3 * (W - MM + 1))) & ((1u << (3 * MID)) - 1));
    const uint32_t r = small_ld<SMEM>(tab + NS + NM, seq & (NS - 1));
    return l + m + r;
  }
}

// The forward walks of one row: from every start s < len, advance through
// the trie until the first dead transition or the row's end; each alive
// window [s, e] stores its node's output link into best[e]. The longest
// window must win, and it is written last: the starts are taken in chunks
// of 32 * WALKS from the last chunk to the first, and within a chunk the
// warp takes the steps together (__syncwarp between steps), so for every
// end position the windows arrive shortest first. Plain int32 stores then
// keep the JAX walk's answer exactly, with no atomics.
//
// With ROOT the first step reads the root-child record of the start's
// symbol; without it, the first step is a walk row like any other. With a
// type cache (cache non-null), the type window score of gap s is gathered
// before the walk steps and added after them, so its latency hides behind
// theirs.
template <bool STAGED, bool ROOT>
__device__ __forceinline__ void walk_row(
    const int32_t* sym, int32_t* best, int len, int lane,
    const int4* __restrict__ walk, int n_slots, int root_base, int max_len,
    const int2* root, const uint8_t* ty, const int32_t* __restrict__ cache,
    int w, int* sc, int pad_left) {
  constexpr int SPAN = 32 * WALKS;
  for (int chunk = (len + SPAN - 1) / SPAN - 1; chunk >= 0; --chunk) {
    const int s0 = chunk * SPAN + lane;
    int node[WALKS], nbase[WALKS], tv[WALKS];
#pragma unroll
    for (int k = 0; k < WALKS; ++k) {
      const int s = s0 + 32 * k;
      node[k] = -1;
      nbase[k] = 0;
      tv[k] = 0;
      if (s >= len) continue;
      if (cache != nullptr && s < len - 1)
        tv[k] = __ldg(cache + type_window(ty, s, len, w, 2 * w));
      if (ROOT) {
        const int sy = sym[s];
        const int2 c = table_ld<STAGED>(root + sy);
        if (c.y != NO_CHILD) {
          node[k] = root_base + sy;
          nbase[k] = c.x;
          best[s] = c.y;
        }
      } else {
        node[k] = 0;
        nbase[k] = root_base;
      }
    }
    __syncwarp();
    for (int j = ROOT ? 1 : 0; j < max_len; ++j) {
      int cand[WALKS];
      int4 row[WALKS];
#pragma unroll
      for (int k = 0; k < WALKS; ++k) {
        const int s = s0 + 32 * k;
        if (node[k] >= 0 && s + j < len) {
          int64_t c = static_cast<int64_t>(nbase[k]) + sym[s + j];
          // out-of-range candidates read the last row (the dead slot), as
          // the reference's clamped gathers do; its check names no node
          c = c < 0 ? 0 : (c >= n_slots ? n_slots - 1 : c);
          cand[k] = static_cast<int>(c);
          row[k] = __ldg(walk + c);
        } else {
          node[k] = -1;
        }
      }
      bool alive = false;
#pragma unroll
      for (int k = 0; k < WALKS; ++k) {
        if (node[k] < 0) continue;
        if (row[k].x != node[k]) {
          node[k] = -1;
          continue;
        }
        node[k] = cand[k];
        nbase[k] = row[k].y;
        best[s0 + 32 * k + j] = row[k].z;
        alive = true;
      }
      if (!__any_sync(FULL, alive)) break;
      __syncwarp();
    }
    __syncwarp();
    if (cache != nullptr) {
#pragma unroll
      for (int k = 0; k < WALKS; ++k)
        if (s0 + 32 * k < len - 1)
          atomicAdd(&sc[pad_left + s0 + 32 * k], tv[k]);
    }
  }
}

// One hash matcher side, as the kernel reads it.
struct HashSide {
  const int4* rows;   // entry rows (global memory)
  const void* rec;    // bucket records (shared or global memory)
  int rec_bytes;      // 2 (1-byte displacement, 8-bit mask) or 4 (16, 16)
  const int* meta;    // length k's record at 8 (k - 1) (shared memory):
                      // region, slot_shift, mask, c2, first bucket (-1:
                      // no pattern of length k), d_shift
  int kmax;
  uint32_t base;
};

// Compares entry row r (the first part of a length-k pattern's row, at
// int4 offset a) with the window of k symbols ending at t, and stores
// the row's id in best[t] if they are equal. Part q holds pairs
// 4q..4q+3 (pair j: symbols 2j and 2j+1 from the end) and the id is the
// last part's last int; the other parts are read only when the first
// part's eight symbols match.
__device__ __forceinline__ void hash_compare(const int32_t* sym,
                                             int32_t* best, int t, int k,
                                             const int4* rows, int a,
                                             int4 r) {
  const int parts = ((k + 1) / 2 + 4) / 4;
  bool ok = true;
  for (int q = 0;; ++q) {
    const int c[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = 4 * q + u;
      if (2 * j >= k) break;
      const int hi = 2 * j + 1 < k ? sym[t - 2 * j - 1] : 0;
      ok = ok && c[u] == (sym[t - 2 * j] | (hi << 16));
    }
    if (!ok || q + 1 == parts) break;
    r = __ldg(rows + a + q + 1);
  }
  if (ok) best[t] = r.w;
}

// The longest pattern id ending at every position t < len, by the CHD
// tables, into best[t] (which holds -1 before); lane l takes t = l,
// l + 32, ..., and all lanes take the lengths together, ascending: each
// grows its window's rolling hash by one symbol (the length's record then
// read alike by every lane), stops at a window that holds symbol 0, and
// reads the bucket's record. Only a window whose fingerprint bit is set
// there can equal a pattern: its entry row is loaded. The loads of SLOTS
// lengths go out before any is waited on; then they are compared, in
// length order, so a later match is longer and overwrites. A group of
// lengths in which no lane of the warp loads costs no round trip.
__device__ __forceinline__ void hash_row(const int32_t* sym, int32_t* best,
                                         int len, int lane,
                                         const HashSide& hs) {
  const int fbits = hs.rec_bytes == 2 ? 3 : 4;
  const int half = 4 * hs.rec_bytes;  // bits of the displacement
  for (int t = lane; t < len + lane; t += 32) {
    uint32_t h = 0, p = 1;  // the window's hash, base^e
    bool live = t < len;
    for (int e0 = 0; e0 < hs.kmax && __any_sync(FULL, live); e0 += SLOTS) {
      int at[SLOTS];  // entry row offsets (-1: no load)
      int4 row[SLOTS];
#pragma unroll
      for (int w = 0; w < SLOTS; ++w) {  // every load of the group first
        const int e = e0 + w;
        at[w] = -1;
        if (e >= hs.kmax) continue;
        const int* m = hs.meta + 8 * e;
        const int2 bk = *reinterpret_cast<const int2*>(m + 4);
        const int sy = live && t - e >= 0 ? sym[t - e] : 0;
        live = sy != 0;
        h += static_cast<uint32_t>(sy) * p;
        p *= hs.base;
        if (!live || bk.x < 0) continue;  // no pattern of this length
        const uint32_t hc = h * HASH_C1;
        const uint32_t b = static_cast<uint32_t>(bk.x) + (hc >> bk.y);
        const uint32_t rec =
            hs.rec_bytes == 2 ? static_cast<const uint16_t*>(hs.rec)[b]
                              : static_cast<const uint32_t*>(hs.rec)[b];
        const uint32_t f = (hc >> (bk.y - fbits)) & ((1u << fbits) - 1);
        if (!((rec >> (half + f)) & 1u)) continue;  // no such pattern
        const int4 q = *reinterpret_cast<const int4*>(m);
        const uint32_t slot =
            (((h * static_cast<uint32_t>(q.w)) >> q.y) +
             (rec & ((1u << half) - 1))) &
            static_cast<uint32_t>(q.z);
        at[w] = q.x + static_cast<int>(slot) * (((e + 2) / 2 + 4) / 4);
        row[w] = __ldg(hs.rows + at[w]);
      }
#pragma unroll
      for (int w = 0; w < SLOTS; ++w)
        if (at[w] >= 0)
          hash_compare(sym, best, t, e0 + w + 1, hs.rows, at[w], row[w]);
    }
  }
}

__device__ __forceinline__ void add_chunk(int* sc, int S, int p0, int4 lo,
                                          int4 hi) {
  const int w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = p0 + j;
    // padding from the model keeps p in [0, S); anything else is dropped
    if (w[j] != 0 && static_cast<unsigned>(p) < static_cast<unsigned>(S))
      atomicAdd(&sc[p], w[j]);
  }
}

// Reads the longest match of every end position t < len out of best[],
// writes it to out[t] (when out is non-null) and adds its weight chunks:
// the pattern records of ADDS positions are gathered together, then their
// first chunks ADD_LOADS at a time. With CACHE and a type cache (cache
// non-null), gap t's type window score is gathered with t's pattern record
// and added with it (hash_row's probes have no gather of their own to hide
// it behind, as walk_row's steps do).
template <bool CACHE>
__device__ __forceinline__ void add_matches(
    const int32_t* best, int len, int lane, int* sc, int S,
    int pad_left, const int4* __restrict__ ids, const int4* __restrict__ w8,
    int32_t* out, const uint8_t* ty = nullptr,
    const int32_t* __restrict__ cache = nullptr, int w = 0) {
  for (int t0 = lane; t0 < len; t0 += 32 * ADDS) {
    int first[ADDS], cnt[ADDS], p0[ADDS], tv[ADDS];
#pragma unroll
    for (int k = 0; k < ADDS; ++k) {
      const int t = t0 + 32 * k;
      const int m = t < len ? best[t] : -1;
      if (out != nullptr && t < len) out[t] = m;
      cnt[k] = 0;
      if (CACHE)
        tv[k] = cache != nullptr && t < len - 1
                    ? __ldg(cache + type_window(ty, t, len, w, 2 * w))
                    : 0;
      if (m >= 0) {
        const int4 id = __ldg(ids + m);
        first[k] = id.x;
        cnt[k] = id.y;
        p0[k] = t + pad_left + id.z;
      }
    }
    if (CACHE) {
#pragma unroll
      for (int k = 0; k < ADDS; ++k)
        if (tv[k] != 0) atomicAdd(&sc[pad_left + t0 + 32 * k], tv[k]);
    }
#pragma unroll
    for (int k0 = 0; k0 < ADDS; k0 += ADD_LOADS) {
      int4 lo[ADD_LOADS], hi[ADD_LOADS];
#pragma unroll
      for (int i = 0; i < ADD_LOADS; ++i) {
        if (cnt[k0 + i] > 0) {
          lo[i] = __ldg(w8 + 2 * static_cast<int64_t>(first[k0 + i]));
          hi[i] = __ldg(w8 + 2 * static_cast<int64_t>(first[k0 + i]) + 1);
        }
      }
#pragma unroll
      for (int i = 0; i < ADD_LOADS; ++i) {
        const int k = k0 + i;
        if (cnt[k] <= 0) continue;
        add_chunk(sc, S, p0[k], lo[i], hi[i]);
        for (int c = 1; c < cnt[k]; ++c) {
          const int64_t r = static_cast<int64_t>(first[k]) + c;
          add_chunk(sc, S, p0[k] + 8 * c, __ldg(w8 + 2 * r),
                    __ldg(w8 + 2 * r + 1));
        }
      }
    }
  }
}

// Type window scores of the in-line gaps t < len - 1, for a model without a
// char side (walk_row, or add_matches after hash_row, adds them
// otherwise).
__device__ __forceinline__ void add_type_cache(
    const uint8_t* ty, int len, int lane, int* sc, int pad_left,
    const int32_t* __restrict__ cache, int w) {
  for (int t0 = lane; t0 < len - 1; t0 += 32 * ADDS) {
    int v[ADDS];
#pragma unroll
    for (int k = 0; k < ADDS; ++k) {
      const int t = t0 + 32 * k;
      v[k] = t < len - 1 ? __ldg(cache + type_window(ty, t, len, w, 2 * w))
                         : 0;
    }
#pragma unroll
    for (int k = 0; k < ADDS; ++k) {
      const int t = t0 + 32 * k;
      if (t < len - 1) atomicAdd(&sc[pad_left + t], v[k]);
    }
  }
}

// Adjacent columns a lane takes in the bias store of the small tables: a
// run's gaps share all but one type of their windows, so one window of
// SMALL_RUN - 1 more types gives every code of the run. (Runs of 4 spilled
// at the 64-register cap and were slower: see PERF.md.)
constexpr int SMALL_RUN = 2;

// The bias row of a model with small type tables, each in-line gap's type
// score added in the same store (after the text pass, before any match is
// added): no atomic and no pass of its own. Lane l takes the SMALL_RUN
// adjacent columns from SMALL_RUN * l on, 32 runs a step (a last run past
// S writes into the padding of the 16-byte aligned score row).
template <int MODE, int W, int MM, bool SMEM>
__device__ __forceinline__ void bias_small_row(const uint8_t* ty, int len,
                                               int lane, int* sc, int S,
                                               int pad_left, uint32_t bias,
                                               const int32_t* tab) {
  constexpr int K = SMALL_RUN;
  constexpr int N = MODE == TYPE_POS ? 2 * W + MM - 1 : 2 * W;
  static_assert(3 * (N + K - 1) <= 32, "a run's window fits 32 bits");
  for (int i = K * lane; i < S; i += 32 * K) {
    const int g = i - pad_left;
    uint32_t v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = bias;
    if (g + K - 1 >= 0 && g < len - 1) {
      const uint32_t seq = window_code<N + K - 1, W>(ty, g, len);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t s = small_sum<MODE, W, MM, SMEM>(
            (seq >> (3 * (K - 1 - k))) & ((1u << (3 * N)) - 1), tab);
        if (g + k >= 0 && g + k < len - 1) v[k] += s;
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) sc[i + k] = static_cast<int>(v[k]);
  }
}

// Copies `bytes` (a multiple of 16) from src to smem + off (off < 0 or no
// src: nothing), asynchronously; the caller commits and waits.
__device__ __forceinline__ void stage_async(unsigned char* smem, int64_t off,
                                            const void* src, int64_t bytes) {
  if (off < 0 || src == nullptr) return;
  for (int64_t i = threadIdx.x; 16 * i < bytes; i += blockDim.x)
    __pipeline_memcpy_async(smem + off + 16 * i,
                            static_cast<const unsigned char*>(src) + 16 * i,
                            16);
}

// The views below are built where they are used, from the kernel's
// parameters (constant memory), so that no register holds them across the
// row loop.

// A hash side's tables as hash_row reads them. The length records are
// always staged; the bucket records are staged with the hot tables, so
// with STAGED both are built from the shared-memory base itself, and the
// compiler reads them with shared-memory loads (a table that may be in
// either space would take generic loads).
template <bool STAGED>
__device__ __forceinline__ HashSide char_hash(const Args& a,
                                              unsigned char* smem) {
  return {a.c_hm_rows,
          STAGED ? static_cast<const void*>(smem + a.sm_c_rec) : a.c_hm_rec,
          static_cast<int>(a.c_hm_rec_bytes),
          reinterpret_cast<const int*>(smem + a.sm_c_meta),
          static_cast<int>(a.c_hm_kmax),
          static_cast<uint32_t>(a.c_hm_base)};
}

template <bool STAGED>
__device__ __forceinline__ HashSide type_hash(const Args& a,
                                              unsigned char* smem) {
  return {a.t_hm_rows,
          STAGED ? static_cast<const void*>(smem + a.sm_t_rec) : a.t_hm_rec,
          static_cast<int>(a.t_hm_rec_bytes),
          reinterpret_cast<const int*>(smem + a.sm_t_meta),
          static_cast<int>(a.t_hm_kmax),
          static_cast<uint32_t>(a.t_hm_base)};
}

// The host stages the small tables when they take at most this many bytes
// (ops/boundary.py SMALL_STAGE_BUDGET, the same number), so whether a
// layout's tables are in shared memory follows from its shape.
constexpr int64_t SMALL_STAGE_BUDGET = 32 * 1024;

// The bytes of a layout's tables as the host uploads them (one flat int32
// array, padded to 16 B): 2W tables of 8^MM entries, or 8^W + 8^(2MM-2)
// (at least 8) + 8^W.
template <int MODE, int W, int MM>
__host__ __device__ constexpr int64_t small_bytes() {
  return align16(4 * (MODE == TYPE_POS
                          ? (int64_t{2 * W} << (3 * MM))
                          : (int64_t{2} << (3 * W)) +
                                (int64_t{1} << (3 * (MM > 1 ? 2 * MM - 2
                                                            : 1)))));
}

// bias_small_row at the model's (t_mode, window, M or maxn), each
// combination the host builds (ops/boundary.py SMALL_SHAPES): from shared
// memory when the layout's tables fit the staging budget, else from global
// memory.
__device__ __forceinline__ void bias_small(const Args& a, unsigned char* smem,
                                           const uint8_t* ty, int len,
                                           int lane, int* sc, int S,
                                           int pad_left) {
  const uint32_t bias = static_cast<uint32_t>(a.bias);
  const int32_t* sm = reinterpret_cast<const int32_t*>(smem + a.sm_small);
#define VT_SMALL(MODE, W, MM)                                             \
  case MODE * 100 + W * 10 + MM: {                                        \
    constexpr bool SMEM = small_bytes<MODE, W, MM>() <= SMALL_STAGE_BUDGET; \
    bias_small_row<MODE, W, MM, SMEM>(ty, len, lane, sc, S, pad_left, bias, \
                                      SMEM ? sm : a.t_small);             \
    return;                                                               \
  }
  switch (a.t_mode * 100 + a.t_window * 10 + a.t_m) {
    VT_SMALL(TYPE_POS, 1, 1)
    VT_SMALL(TYPE_POS, 1, 2)
    VT_SMALL(TYPE_POS, 2, 1)
    VT_SMALL(TYPE_POS, 2, 2)
    VT_SMALL(TYPE_POS, 2, 3)
    VT_SMALL(TYPE_POS, 2, 4)
    VT_SMALL(TYPE_POS, 3, 1)
    VT_SMALL(TYPE_POS, 3, 2)
    VT_SMALL(TYPE_POS, 3, 3)
    VT_SMALL(TYPE_POS, 3, 4)
    VT_SMALL(TYPE_SPLIT, 1, 1)
    VT_SMALL(TYPE_SPLIT, 2, 1)
    VT_SMALL(TYPE_SPLIT, 2, 2)
    VT_SMALL(TYPE_SPLIT, 3, 1)
    VT_SMALL(TYPE_SPLIT, 3, 2)
    VT_SMALL(TYPE_SPLIT, 3, 3)
    default:  // none other is built (the host refuses it): the bias alone
      for (int i = lane; i < S; i += 32) sc[i] = static_cast<int>(bias);
  }
#undef VT_SMALL
}

template <typename CP, bool STAGED, bool SCRATCH, bool GAP, bool VARIANTS>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    boundary_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int L = static_cast<int>(a.L);
  const int S = static_cast<int>(a.S);
  const int pad_left = static_cast<int>(a.pad_left);
  const bool char_side = a.hash2 != nullptr;

  // ---- staged tables, once per block: asynchronous copies, waited for
  // after the first row has been fetched ------------------------------
  const int2* hash = a.hash2;
  const int2* root = a.c_root;
  unsigned char* rows = smem;
  if (STAGED) {  // the hash table and the root-child records
    int2* h = reinterpret_cast<int2*>(smem);
    const int P = static_cast<int>(a.hash_slots);  // a power of two >= 16
    const int R = static_cast<int>(a.c_root_n);
    for (int i = threadIdx.x; 2 * i < P; i += blockDim.x)
      __pipeline_memcpy_async(h + 2 * i, a.hash2 + 2 * i, 16);
    for (int i = threadIdx.x; i < R; i += blockDim.x)
      __pipeline_memcpy_async(h + P + i, a.c_root + i, 8);
    __pipeline_commit();
    hash = h;
    root = h + P;
    rows += align16(8 * static_cast<int64_t>(P + R));
  }
  if (VARIANTS) {
    // the bucket records, the small type tables and the length records,
    // each a multiple of 16 bytes, where the host placed them (-1: not
    // staged)
    stage_async(smem, a.sm_c_rec, a.c_hm_rec, a.c_hm_rec_size);
    stage_async(smem, a.sm_c_meta, a.c_hm_meta, a.c_hm_kmax * 32);
    stage_async(smem, a.sm_t_rec, a.t_hm_rec, a.t_hm_rec_size);
    stage_async(smem, a.sm_t_meta, a.t_hm_meta, a.t_hm_kmax * 32);
    stage_async(smem, a.sm_small, a.t_small, a.t_small_size);
    __pipeline_commit();
    rows = smem + a.sm_rows;
  }

  // ---- this warp's row working set -----------------------------------
  // (a template parameter, so that a shared-memory working set is known to
  // be one and its atomics compile to shared-memory atomics)
  unsigned char* base =
      SCRATCH ? a.scratch + (static_cast<int64_t>(blockIdx.x) * n_warps +
                             warp) * a.row_bytes
              : rows + static_cast<int64_t>(warp) * a.row_bytes;
  int32_t* best = reinterpret_cast<int32_t*>(base);
  int32_t* sym = best + align16(4 * int64_t{L}) / 4;
  int* sc = sym + align16(4 * int64_t{L}) / 4;
  uint8_t* ty = reinterpret_cast<uint8_t*>(sc + align16(4 * int64_t{S}) / 4);
  const uint32_t mul = static_cast<uint32_t>(a.hash_mul);
  const int shift = static_cast<int>(a.hash_shift);

  // rows come from the counter; the next row's index and length are
  // fetched while this row is worked on
  auto next_row = [&]() {
    int r = 0;
    if (lane == 0) r = static_cast<int>(atomicAdd(&a.sched[0], 1u));
    return __shfl_sync(FULL, r, 0);
  };
  int r = next_row();
  int len_r = r < a.B ? a.lengths[r] : 0;
  if (STAGED || VARIANTS) {
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  for (; r < a.B;) {
    const int len = min(max(len_r, 0), L);
    const int64_t row0 = static_cast<int64_t>(r) * L;
    const int r_next = next_row();
    const int len_next = r_next < a.B ? a.lengths[r_next] : 0;
    const CP* cps = static_cast<const CP*>(a.cps) + row0;

    // ---- bias row; symbols, types and empty matches of live chars ------
    // (with small type tables, the bias row follows the text pass)
    const bool small_tabs = VARIANTS && a.t_mode > 1;
    if (!small_tabs)
      for (int i = lane; i < S; i += 32) sc[i] = static_cast<int>(a.bias);
    for (int t0 = lane; t0 < len; t0 += 32 * TEXT) {
      uint32_t cp[TEXT];
      int c[TEXT];
#pragma unroll
      for (int k = 0; k < TEXT; ++k) {  // all loads first: one round trip
        const int t = t0 + 32 * k;
        cp[k] = 0;
        c[k] = 0;
        if (t >= len) continue;
        cp[k] = static_cast<uint32_t>(__ldg(cps + t));
        if (a.cts_kind == 1)
          c[k] = __ldg(static_cast<const uint8_t*>(a.cts) + row0 + t);
        else if (a.cts_kind == 2)
          c[k] = __ldg(static_cast<const int32_t*>(a.cts) + row0 + t);
      }
#pragma unroll
      for (int k = 0; k < TEXT; ++k) {
        const int t = t0 + 32 * k;
        if (t >= len) continue;
        ty[t] = static_cast<uint8_t>(a.cts_kind == 0 ? char_type(cp[k])
                                                     : c[k]);
        if (char_side) {
          const int2 kv = table_ld<STAGED>(hash + ((cp[k] * mul) >> shift));
          sym[t] = kv.x == static_cast<int>(cp[k]) ? kv.y : 0;
          best[t] = -1;
        }
      }
    }
    __syncwarp();
    if (small_tabs) {
      bias_small(a, smem, ty, len, lane, sc, S, pad_left);
      __syncwarp();
    }

    // ---- char side: walks or hash probes, then chunk adds; the type
    // table ----------------------------------------------------------------
    // (t_cache is null unless the type table is the cache)
    if (char_side) {
      if (VARIANTS && a.c_hm_rows) {
        hash_row(sym, best, len, lane, char_hash<STAGED>(a, smem));
        __syncwarp();
        add_matches<true>(best, len, lane, sc, S, pad_left, a.c_ids, a.c_w8,
                          a.char_match ? a.char_match + row0 : nullptr, ty,
                          a.t_cache, static_cast<int>(a.t_window));
      } else {
        walk_row<STAGED, true>(sym, best, len, lane, a.c_walk,
                               static_cast<int>(a.c_slots),
                               static_cast<int>(a.c_root_base),
                               static_cast<int>(a.c_max_len), root, ty,
                               a.t_cache, static_cast<int>(a.t_window), sc,
                               pad_left);
        __syncwarp();
        add_matches<false>(best, len, lane, sc, S, pad_left, a.c_ids, a.c_w8,
                           a.char_match ? a.char_match + row0 : nullptr);
      }
    } else if (a.t_cache) {
      add_type_cache(ty, len, lane, sc, pad_left, a.t_cache,
                     static_cast<int>(a.t_window));
    }

    // ---- type trie side -----------------------------------------------
    if (a.t_walk) {
      __syncwarp();  // every char match has been read out of best[]
      for (int t = lane; t < len; t += 32) {
        sym[t] = ty[t];
        best[t] = -1;
      }
      __syncwarp();
      if (VARIANTS && a.t_hm_rows)
        hash_row(sym, best, len, lane, type_hash<STAGED>(a, smem));
      else
        walk_row<STAGED, false>(sym, best, len, lane, a.t_walk,
                                static_cast<int>(a.t_slots),
                                static_cast<int>(a.t_root_base),
                                static_cast<int>(a.t_max_len), nullptr, ty,
                                nullptr, 0, sc, pad_left);
      __syncwarp();
      add_matches<false>(best, len, lane, sc, S, pad_left, a.t_ids, a.t_w8,
                         a.type_match ? a.type_match + row0 : nullptr);
    }
    __syncwarp();

    // ---- epilogues ------------------------------------------------------
    if (a.scores) {
      int32_t* out = a.scores + static_cast<int64_t>(r) * S;
      for (int i = lane; i < S; i += 32) out[i] = sc[i];
      for (int t = len + lane; t < L; t += 32) {
        if (a.char_match) a.char_match[row0 + t] = -1;
        if (a.type_match) a.type_match[row0 + t] = -1;
      }
    }
    if (a.bits) {
      const int W8 = static_cast<int>(a.W8);
      const int G = min(L - 1, len - 1);
      for (int i = lane; i < W8; i += 32) {
        unsigned v = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int g = j * W8 + i;
          if (g < G && sc[pad_left + g] > 0) {
            bool gap = true;
            if (a.ws_mask) {
              const int c0 = ty[g], c1 = ty[g + 1];
              if (c0 == c1 && c0 < 32 && ((a.ws_mask >> c0) & 1)) gap = false;
            }
            v |= static_cast<unsigned>(gap) << j;
          }
        }
        a.bits[static_cast<int64_t>(r) * W8 + i] = static_cast<uint8_t>(v);
      }
    }
    if (GAP) {  // every column, padding included, as the padded row holds it
      int32_t* out = a.gap_scores + static_cast<int64_t>(r) * a.gap_stride;
      for (int g = lane; g < L - 1; g += 32) out[g] = sc[pad_left + g];
    }
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

template <typename CP, bool STAGED, bool SCRATCH, bool GAP>
const void* kernel_of(bool variants) {
  return variants ? reinterpret_cast<const void*>(
                        boundary_kernel<CP, STAGED, SCRATCH, GAP, true>)
                  : reinterpret_cast<const void*>(
                        boundary_kernel<CP, STAGED, SCRATCH, GAP, false>);
}

template <typename CP, bool STAGED, bool SCRATCH>
const void* kernel_of(bool gap, bool variants) {
  return gap ? kernel_of<CP, STAGED, SCRATCH, true>(variants)
             : kernel_of<CP, STAGED, SCRATCH, false>(variants);
}

template <typename CP, bool STAGED>
const void* kernel_of(bool scratch, bool gap, bool variants) {
  return scratch ? kernel_of<CP, STAGED, true>(gap, variants)
                 : kernel_of<CP, STAGED, false>(gap, variants);
}

const void* pick(int cps_u16, int staged, int scratch, int gap,
                 int variants) {
  if (cps_u16)
    return staged ? kernel_of<uint16_t, true>(scratch, gap, variants)
                  : kernel_of<uint16_t, false>(scratch, gap, variants);
  return staged ? kernel_of<int32_t, true>(scratch, gap, variants)
                : kernel_of<int32_t, false>(scratch, gap, variants);
}

// Lets an instantiation take the device's whole opt-in dynamic shared
// memory, once per instantiation and device: later launches and occupancy
// queries then make no cudaFuncSetAttribute call. (The attribute is only a
// ceiling; each launch still asks for its own smem_bytes.)
constexpr int MAX_DEVICES = 64;
std::atomic<bool> smem_allowed[32][MAX_DEVICES];

cudaError_t allow_smem(int cps_u16, int staged, int scratch, int gap,
                       int variants, int device) {
  const int k = (variants ? 16 : 0) + (gap ? 8 : 0) + (cps_u16 ? 4 : 0) +
                (staged ? 2 : 0) + (scratch ? 1 : 0);
  const bool cached = device >= 0 && device < MAX_DEVICES;
  if (cached && smem_allowed[k][device].load(std::memory_order_acquire))
    return cudaSuccess;
  int limit = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(pick(cps_u16, staged, scratch, gap, variants),
                           cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (e == cudaSuccess && cached)
    smem_allowed[k][device].store(true, std::memory_order_release);
  return e;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of `device` with `blocks` blocks of
// `threads` threads and `smem_bytes` of dynamic shared memory (the staged
// tables, then the rows' working sets unless a.scratch is set). Returns
// cudaGetLastError() (0 = ok). This library carries its own CUDA runtime,
// so the caller's current device is passed in rather than assumed.
int vt_boundary(const VtBoundaryArgs* a, int staged, int blocks, int threads,
                int64_t smem_bytes, void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int cps_u16 = static_cast<int>(a->cps_u16);
  const int scratch = a->scratch != nullptr;
  const int gap = a->gap_scores != nullptr;
  const int variants = a->c_hm_rows != nullptr ||
                       a->t_hm_rows != nullptr || a->t_mode > 1;
  e = allow_smem(cps_u16, staged, scratch, gap, variants, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* kern = pick(cps_u16, staged, scratch, gap, variants);
  void* params[] = {const_cast<VtBoundaryArgs*>(a)};
  e = cudaLaunchKernel(kern, dim3(blocks), dim3(threads), params,
                       static_cast<size_t>(smem_bytes),
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Largest dynamic shared memory a block may opt into on `device`, or -1.
int vt_boundary_smem_limit(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// Blocks of `threads` threads with `smem_bytes` of dynamic shared memory
// that one SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus the CUDA error.
int vt_boundary_occupancy(int cps_u16, int staged, int scratch, int gap,
                          int variants, int threads, int64_t smem_bytes,
                          int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  e = allow_smem(cps_u16, staged, scratch, gap, variants, device);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int n = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, pick(cps_u16, staged, scratch, gap, variants), threads,
      static_cast<size_t>(smem_bytes));
  if (e != cudaSuccess) return -static_cast<int>(e);
  return n;
}

// Most threads a block of this kernel may have (its __launch_bounds__).
int vt_boundary_max_threads() { return MAX_THREADS; }

}  // extern "C"
