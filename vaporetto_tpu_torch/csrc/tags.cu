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
//      first (tid, match[e + rel]) hit among probe_len linear probes from
//      slot (tid*M1 + state*M2 mod 2^32) >> shift;
//   4. per tag slot, the first maximum over the slot's classes;
//   5. outputs: the column-major gap bits (gap g at bit g / W8 of byte
//      g % W8), then the fused uint16 word (tid + 1) | (choice_s + 1) <<
//      (7 + 4s), or the tid at its narrow width and the int8 choices.
// Every value equals the plain version's (ops/tags.py serve_tags_plain)
// bit for bit; integer adds wrap as int32.
//
// What bounds it on this card: like the boundary kernel, the latency of
// dependent gathers (hash slot -> walk rows, one per char of the token ->
// probe rows -> weight rows), not bytes: it reads 4 B of score and 9 B of
// codepoint, type and match ids per position and writes 2-4 B. The design
// is the simple one, right first:
//   * a block per row, its threads taking the row's positions round robin;
//   * the row's gap flags built once in shared memory (bit 0 gap, bit 1
//     span gap) and the bits written from them;
//   * then each thread, at each of its positions before the row's length,
//     finds its span length by scanning back at most max_tok_len + 1 gap
//     flags, walks the reversed trie that deep, keeps the weight-row
//     offset of each probe table's hit, and computes each class score when
//     a slot's argmax asks for it (no per-thread array of C scores, so
//     wide-class models run the same code);
//   * positions at or past the row's length do no work: they hold no
//     token (tid -1, choices -1), as the plain version finds there.
// Tensor cores, TMA and wgmma have nothing to do here: no matrices, and
// the reads are gathers, not tiles.

#include <cstdint>
#include <cuda_runtime.h>

// Mirrored field for field by ops/tags.py (_Args): every field is 8 bytes
// wide, so the layout has no padding.
struct VtTagsArgs {
  const void* cps;         // (B, L) uint16 or int32 codepoints
  const void* cts;         // (B, L) uint8 or int32 char types, or null
  const int32_t* lengths;  // (B,)
  int64_t L, cps_u16, cts_kind;  // cts_kind: 0 classify, 1 uint8, 2 int32
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
  const int32_t* probe;       // every probe table's rows
  const int32_t* w_rows;      // (n_rows, C) when rows hold a row index
  uint8_t* bits;              // (B, W8)
  int64_t W8, out_kind;       // 0: uint16 word; 1/2/3: int8/16/32 tid
  void* tid_out;              // (B, L)
  int8_t* choice_out;         // (B, L, S), null with the word
};

namespace {

constexpr int MAX_TABLES = 32;  // ops/tags.py MAX_TABLES
constexpr int DESC_W = 8;  // side, rel, shift, probe_len, size, first, width
constexpr uint32_t M1 = 0x9E3779B1u;  // compile/tagdev.py _M1, _M2
constexpr uint32_t M2 = 0x85EBCA77u;

__device__ __forceinline__ int32_t load_cp(const VtTagsArgs& a, int64_t i) {
  return a.cps_u16 ? static_cast<int32_t>(
                         static_cast<const uint16_t*>(a.cps)[i])
                   : static_cast<const int32_t*>(a.cps)[i];
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

__device__ __forceinline__ int32_t load_ct(const VtTagsArgs& a, int64_t i,
                                           int32_t cp) {
  if (a.cts_kind == 1) return static_cast<const uint8_t*>(a.cts)[i];
  if (a.cts_kind == 2) return static_cast<const int32_t*>(a.cts)[i];
  return char_type(cp);
}

__device__ __forceinline__ bool span_gap(const uint8_t* flags, int g) {
  return (flags[g] >> 1) & 1;
}

// The token id ending at e (e < len), or -1.
__device__ int32_t token_at(const VtTagsArgs& a, const uint8_t* flags,
                            int64_t row, int e, int len) {
  if (e != len - 1 && !span_gap(flags, e)) return -1;  // not a span end
  // span length k: back to the previous span gap, or to column 0
  const int max_k = static_cast<int>(a.max_tok_len);
  int k = 1;
  while (k <= max_k && e - k >= 0 && !span_gap(flags, e - k)) ++k;
  if (k > max_k) return -1;
  const int32_t last = static_cast<int32_t>(a.rev_slots) - 1;
  int32_t node = 0, base = static_cast<int32_t>(a.rev_root_base), value = -1;
  for (int j = 0; j < k; ++j) {
    const int32_t cp = load_cp(a, row + e - j);
    const uint32_t h = (static_cast<uint32_t>(cp) *
                        static_cast<uint32_t>(a.rev_mul)) >>
                       static_cast<uint32_t>(a.rev_shift);
    const int2 hs = a.rev_hash2[h];
    const int32_t cand = base + (hs.x == cp ? hs.y : 0);
    // the plain version's gather clamps out-of-range slots, as XLA's does
    const int4 t = a.rev_walk[cand < 0 ? 0 : (cand > last ? last : cand)];
    if (t.x != node) return -1;  // dead: no token of this depth
    node = cand;
    base = t.y;
    value = t.z;
  }
  return value;
}

__global__ void __launch_bounds__(256) tags_kernel(const VtTagsArgs a) {
  extern __shared__ uint8_t flags[];  // per gap: bit 0 gap, bit 1 span gap
  __shared__ int32_t desc[MAX_TABLES * DESC_W];
  const int64_t r = blockIdx.x;
  const int L = static_cast<int>(a.L);
  const int G = L - 1;
  int len = a.lengths[r];
  len = len < 0 ? 0 : (len > L ? L : len);
  const int64_t row = r * a.L;
  const int n_tabs = static_cast<int>(a.n_tabs);
  for (int i = threadIdx.x; i < n_tabs * DESC_W; i += blockDim.x)
    desc[i] = a.desc[i];

  // 1. gap flags. Past len - 1 they are 0: no gap is a boundary there, and
  //    no position before the row's length reads them.
  const int32_t* sc = a.scores + r * a.S_pad + a.pad_left;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    uint8_t f = 0;
    if (g < len - 1) {
      const int32_t c0 = load_cp(a, row + g), c1 = load_cp(a, row + g + 1);
      bool gap = sc[g] > 0;
      if (gap && a.ws_mask) {
        const int32_t t0 = load_ct(a, row + g, c0);
        const int32_t t1 = load_ct(a, row + g + 1, c1);
        if (t0 == t1 && t0 >= 0 && t0 < 63 && ((a.ws_mask >> t0) & 1))
          gap = false;
      }
      f = static_cast<uint8_t>((gap ? 1 : 0) |
                               ((gap || c0 == 0 || c1 == 0) ? 2 : 0));
    }
    flags[g] = f;
  }
  __syncthreads();

  // 2. the gap bits, column-major
  const int W8 = static_cast<int>(a.W8);
  for (int i = threadIdx.x; i < W8; i += blockDim.x) {
    unsigned v = 0;
    for (int j = 0; j < 8; ++j) {
      const int g = j * W8 + i;
      if (g < G) v |= (flags[g] & 1u) << j;
    }
    a.bits[r * W8 + i] = static_cast<uint8_t>(v);
  }

  // 3. token id, class scores and choices per position
  const int C = static_cast<int>(a.C), S = static_cast<int>(a.S);
  for (int e = threadIdx.x; e < L; e += blockDim.x) {
    const int32_t tid = e < len ? token_at(a, flags, row, e, len) : -1;
    uint32_t word = static_cast<uint32_t>(tid + 1);
    int8_t* crow = a.choice_out ? a.choice_out + (row + e) * S : nullptr;
    if (tid < 0) {
      if (crow)
        for (int s = 0; s < S; ++s) crow[s] = -1;
    } else {
      // the weight row of each probe table's first hit (misses add 0)
      const int32_t* hit_w[MAX_TABLES];
      int n_hit = 0;
      for (int j = 0; j < n_tabs; ++j) {
        const int32_t* d = desc + j * DESC_W;
        const int32_t* m = d[0] ? a.type_match : a.char_match;
        if (!m) continue;
        const int pos = e + d[1];
        const int32_t st = pos < L ? m[row + pos] : -1;
        const uint32_t slot0 =
            (static_cast<uint32_t>(tid) * M1 + static_cast<uint32_t>(st) * M2) >>
            static_cast<uint32_t>(d[2]);
        const uint32_t mask = static_cast<uint32_t>(d[4]) - 1;
        for (int p = 0; p < d[3]; ++p) {
          const int32_t* pr =
              a.probe + d[5] + static_cast<int64_t>((slot0 + p) & mask) * d[6];
          if (pr[0] == tid && pr[1] == st) {
            hit_w[n_hit++] = a.w_rows ? a.w_rows + static_cast<int64_t>(pr[2]) * C
                                      : pr + 2;
            break;
          }
        }
      }
      const int32_t* brow = a.bias + static_cast<int64_t>(tid) * C;
      const int32_t* oc = a.slot2 + static_cast<int64_t>(tid) * 2 * S;
      for (int s = 0; s < S; ++s) {
        const int32_t o = oc[s], n = oc[S + s];
        int32_t ch = -1;
        if (n >= 2) {
          // the first maximum over all C classes, those outside [o, o + n)
          // reading INT32_MIN: class 0 when nothing in range beats that
          int best_c = 0;
          int32_t best = INT32_MIN;
          const int hi = o + n < C ? o + n : C;
          for (int c = o < 0 ? 0 : o; c < hi; ++c) {
            uint32_t v = static_cast<uint32_t>(brow[c]);
            for (int j = 0; j < n_hit; ++j)
              v += static_cast<uint32_t>(hit_w[j][c]);
            if (static_cast<int32_t>(v) > best) {
              best = static_cast<int32_t>(v);
              best_c = c;
            }
          }
          ch = best_c - o;
        }
        if (crow) crow[s] = static_cast<int8_t>(ch);
        if (a.out_kind == 0)  // the word holds S <= 2 slots
          word |= static_cast<uint32_t>(ch + 1) << (7 + 4 * s);
      }
    }
    const int64_t at = row + e;
    switch (a.out_kind) {
      case 0:
        static_cast<uint16_t*>(a.tid_out)[at] =
            static_cast<uint16_t>(word & 0xFFFFu);
        break;
      case 1:
        static_cast<int8_t*>(a.tid_out)[at] = static_cast<int8_t>(tid);
        break;
      case 2:
        static_cast<int16_t*>(a.tid_out)[at] = static_cast<int16_t>(tid);
        break;
      default:
        static_cast<int32_t*>(a.tid_out)[at] = tid;
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` of `device`: one block of `threads`
// threads per row, `smem_bytes` of dynamic shared memory (the row's gap
// flags). Returns cudaGetLastError() (0 = ok).
int vt_tags(const VtTagsArgs* a, int blocks, int threads, int64_t smem_bytes,
            void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem_bytes > 48 * 1024) {  // rows wider than 48 KB of flags opt in
    e = cudaFuncSetAttribute(tags_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  void* params[] = {const_cast<VtTagsArgs*>(a)};
  e = cudaLaunchKernel(reinterpret_cast<const void*>(tags_kernel),
                       dim3(blocks), dim3(threads), params,
                       static_cast<size_t>(smem_bytes),
                       static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `threads` threads with `smem_bytes` of dynamic shared memory
// that one SM of `device` holds at once, into *blocks. Returns the CUDA
// error (0 = ok).
int vt_tags_occupancy(int threads, int64_t smem_bytes, int device,
                      int* blocks) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, tags_kernel, threads, static_cast<size_t>(smem_bytes)));
}

}  // extern "C"
