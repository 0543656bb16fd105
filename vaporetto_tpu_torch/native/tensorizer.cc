// Batch UTF-8 tensorizer and detokenizers — the lean serving path's host
// stages. Decodes UTF-8 lines into padded (B, L) uint16 codepoint and
// uint8 char-type arrays in one pass (the host-side input pipeline feeding
// the device), and writes the tokenized bytes back from the boundary bits
// (and, on the tag path, the token ids and tag choices), with the --scores
// and --tag-scores blocks when asked.
// Char-type classification matches the reference Unicode ranges
// (sentence.rs:50-67) exactly.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "common.h"

namespace {

inline uint8_t char_type(uint32_t c) { return vt::char_type(c); }

}  // namespace

extern "C" {

// ABI version marker: vt_tensorize16* carry the uint8 types output.
int vt_abi_version() { return 5; }

// The general path's int32 tensorizer (parallel/data.py batched_lines):
// decode n_lines UTF-8 lines (byte ranges given by line_offsets, length
// n_lines+1) into row-major (n_lines, L) codepoints (int32, 0-padded) and
// char types (uint8, 0-padded); lengths receives the char count per line
// (clipped at L). Returns 0 on success, 1 on invalid UTF-8.
int vt_tensorize(const uint8_t* utf8, const int64_t* line_offsets,
                 int64_t n_lines, int32_t L, int32_t* cps, uint8_t* types,
                 int32_t* lengths) {
  for (int64_t row = 0; row < n_lines; ++row) {
    const uint8_t* p = utf8 + line_offsets[row];
    const uint8_t* end = utf8 + line_offsets[row + 1];
    int32_t* cp_row = cps + row * L;
    uint8_t* ty_row = types + row * L;
    int32_t n = 0;
    while (p < end) {
      uint32_t c;
      uint8_t b0 = *p;
      if (b0 < 0x80) {
        c = b0;
        p += 1;
      } else if ((b0 >> 5) == 0x6) {
        if (end - p < 2 || b0 < 0xC2 || (p[1] & 0xC0) != 0x80) return 1;
        c = ((b0 & 0x1F) << 6) | (p[1] & 0x3F);
        p += 2;
      } else if ((b0 >> 4) == 0xE) {
        if (end - p < 3 || (p[1] & 0xC0) != 0x80 || (p[2] & 0xC0) != 0x80)
          return 1;
        if ((b0 == 0xE0 && p[1] < 0xA0) || (b0 == 0xED && p[1] >= 0xA0))
          return 1;
        c = ((b0 & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
        p += 3;
      } else if ((b0 >> 3) == 0x1E) {
        if (end - p < 4 || (p[1] & 0xC0) != 0x80 || (p[2] & 0xC0) != 0x80 ||
            (p[3] & 0xC0) != 0x80)
          return 1;
        // overlong (F0 80..8F) / beyond U+10FFFF (F4 90.. / F5..)
        if ((b0 == 0xF0 && p[1] < 0x90) || b0 > 0xF4 ||
            (b0 == 0xF4 && p[1] >= 0x90))
          return 1;
        c = ((b0 & 0x07) << 18) | ((p[1] & 0x3F) << 12) |
            ((p[2] & 0x3F) << 6) | (p[3] & 0x3F);
        p += 4;
      } else {
        return 1;
      }
      if (n < L) {
        cp_row[n] = static_cast<int32_t>(c);
        ty_row[n] = char_type(c);
      }
      ++n;
    }
    lengths[row] = n < L ? n : L;
  }
  return 0;
}

// Lean-serving tensorizer: decode + (optional) 1:1 normalization into a
// (n_lines, L) uint16 codepoint batch — the HBM-lean input form of
// Predictor.serve_boundaries_fn (char types are classified on device).
// map_bmp (nullable): uint16[65536] codepoint map applied during decode —
// the CLI passes the KyTea fullwidth normalization table
// (kytea_fullwidth.rs:13-118 analogue) so boundaries predicted on the
// normalized text can be re-applied byte-wise onto the ORIGINAL line by
// vt_detok (the map is 1 char to 1 char).
// Lines are given as (starts, ends) byte ranges into utf8 — they need not
// be contiguous, so callers can point straight into a newline-delimited
// input chunk without compaction.
// Returns 0 ok; 1 invalid UTF-8; 2 astral codepoint present (caller falls
// back to the int32 path); 3 a line exceeds L chars (caller falls back).
namespace {

int tensorize16_rows(const uint8_t* utf8, const int64_t* starts,
                     const int64_t* ends, int64_t row_lo, int64_t row_hi,
                     int32_t L, const uint16_t* map_bmp, uint16_t* cps,
                     int32_t* lengths, uint8_t* types) {
  for (int64_t row = row_lo; row < row_hi; ++row) {
    const uint8_t* p = utf8 + starts[row];
    const uint8_t* end = utf8 + ends[row];
    uint16_t* cp_row = cps + row * L;
    uint8_t* ty_row = types ? types + row * L : nullptr;
    int32_t n = 0;
    while (p < end) {
      uint32_t c;
      uint8_t b0 = *p;
      if (b0 < 0x80) {
        c = b0;
        p += 1;
      } else if ((b0 >> 5) == 0x6) {
        // b0 < 0xC2 rejects overlong 2-byte forms (strict-decoder parity)
        if (end - p < 2 || b0 < 0xC2 || (p[1] & 0xC0) != 0x80) return 1;
        c = ((b0 & 0x1F) << 6) | (p[1] & 0x3F);
        p += 2;
      } else if ((b0 >> 4) == 0xE) {
        if (end - p < 3 || (p[1] & 0xC0) != 0x80 || (p[2] & 0xC0) != 0x80)
          return 1;
        // overlong (E0 80..9F) and UTF-16 surrogates (ED A0..BF) are
        // invalid — Python's strict decoder (the general path) rejects
        // them, so the lean path must not silently accept them
        if ((b0 == 0xE0 && p[1] < 0xA0) || (b0 == 0xED && p[1] >= 0xA0))
          return 1;
        c = ((b0 & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
        p += 3;
      } else if ((b0 >> 3) == 0x1E) {
        return 2;  // astral plane: route to the int32 path
      } else {
        return 1;
      }
      if (c == 0) return 4;  // NUL: general path must reject the line
      if (n >= L) return 3;
      uint16_t mc = map_bmp ? map_bmp[c] : static_cast<uint16_t>(c);
      // char type of the NORMALIZED codepoint (what the device kernel
      // classifies); padding stays 0 ("no char")
      if (ty_row) ty_row[n] = char_type(mc);
      cp_row[n++] = mc;
    }
    lengths[row] = n;
    std::memset(cp_row + n, 0, sizeof(uint16_t) * (L - n));
    if (ty_row) std::memset(ty_row + n, 0, L - n);
  }
  return 0;
}

// Packed variant: line i is decoded at (rows[i], cols[i]) of a
// PRE-ZEROED (B, L) batch — the short-line packing layout (many lines
// per device row, separator gaps of codepoint 0 between them). The
// caller guarantees cols[i] + chars(i) <= L; exceeding it returns 3.
int tensorize16_packed_rows(const uint8_t* utf8, const int64_t* starts,
                            const int64_t* ends, const int32_t* rows_of,
                            const int32_t* cols_of, int64_t line_lo,
                            int64_t line_hi, int32_t L,
                            const uint16_t* map_bmp, uint16_t* cps,
                            uint8_t* types) {
  for (int64_t i = line_lo; i < line_hi; ++i) {
    const uint8_t* p = utf8 + starts[i];
    const uint8_t* end = utf8 + ends[i];
    int64_t off = static_cast<int64_t>(rows_of[i]) * L + cols_of[i];
    uint16_t* dst = cps + off;
    uint8_t* ty_dst = types ? types + off : nullptr;
    int32_t room = L - cols_of[i];
    int32_t n = 0;
    while (p < end) {
      uint32_t c;
      uint8_t b0 = *p;
      if (b0 < 0x80) {
        c = b0;
        p += 1;
      } else if ((b0 >> 5) == 0x6) {
        if (end - p < 2 || b0 < 0xC2 || (p[1] & 0xC0) != 0x80) return 1;
        c = ((b0 & 0x1F) << 6) | (p[1] & 0x3F);
        p += 2;
      } else if ((b0 >> 4) == 0xE) {
        if (end - p < 3 || (p[1] & 0xC0) != 0x80 || (p[2] & 0xC0) != 0x80)
          return 1;
        if ((b0 == 0xE0 && p[1] < 0xA0) || (b0 == 0xED && p[1] >= 0xA0))
          return 1;
        c = ((b0 & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
        p += 3;
      } else if ((b0 >> 3) == 0x1E) {
        return 2;  // astral plane
      } else {
        return 1;
      }
      if (c == 0) return 4;  // NUL would alias the separator
      if (n >= room) return 3;
      uint16_t mc = map_bmp ? map_bmp[c] : static_cast<uint16_t>(c);
      if (ty_dst) ty_dst[n] = char_type(mc);
      dst[n++] = mc;
    }
  }
  return 0;
}

}  // namespace

// types (nullable): uint8 (B, L) char types of the normalized
// codepoints at the same placement (separators/padding 0), so the
// serve kernels can take host-computed types instead of classifying
// on device (the reference engine computes types inline on CPU too,
// sentence.rs:264-283).
int vt_tensorize16_packed(const uint8_t* utf8, const int64_t* starts,
                          const int64_t* ends, int64_t n_lines,
                          const int32_t* rows_of, const int32_t* cols_of,
                          int64_t B, int32_t L, const uint16_t* map_bmp,
                          uint16_t* cps, uint8_t* types,
                          int32_t n_threads) {
  std::memset(cps, 0, sizeof(uint16_t) * B * L);
  if (types) std::memset(types, 0, B * L);
  std::atomic<int> rc{0};
  vt::parallel_rows(n_lines, n_threads, 1024,
                    [&](int64_t lo, int64_t hi) {
                      int r = tensorize16_packed_rows(
                          utf8, starts, ends, rows_of, cols_of, lo, hi, L,
                          map_bmp, cps, types);
                      if (r != 0) {
                        int expected = 0;
                        rc.compare_exchange_strong(expected, r);
                      }
                    });
  return rc.load();
}

// n_threads <= 0 picks hardware concurrency (vt::parallel_rows), giving
// callers (e.g. a CLI already running its own worker threads) control
// over the fan-out like every other batched entry point.
int vt_tensorize16(const uint8_t* utf8, const int64_t* starts,
                   const int64_t* ends, int64_t n_lines, int32_t L,
                   const uint16_t* map_bmp, uint16_t* cps,
                   int32_t* lengths, uint8_t* types, int32_t n_threads) {
  std::atomic<int> rc{0};
  vt::parallel_rows(n_lines, n_threads, 1024,
                    [&](int64_t lo, int64_t hi) {
                      int r = tensorize16_rows(utf8, starts, ends, lo, hi,
                                               L, map_bmp, cps, lengths,
                                               types);
                      if (r != 0) {
                        int expected = 0;
                        rc.compare_exchange_strong(expected, r);
                      }
                    });
  return rc.load();
}

// Newline positions in a byte chunk via memchr (SIMD-optimized libc):
// the lean server's line splitter, replacing a numpy compare +
// flatnonzero that cost ~2 passes + a 1 byte/char boolean temp.
// Two-call protocol: out == NULL returns the count; otherwise fills out
// (caller sizes it from the count call) and returns the number written.
int64_t vt_find_newlines(const uint8_t* buf, int64_t n, int64_t* out) {
  int64_t k = 0;
  const uint8_t* p = buf;
  const uint8_t* end = buf + n;
  while (p < end) {
    const uint8_t* q =
        static_cast<const uint8_t*>(memchr(p, '\n', end - p));
    if (!q) break;
    if (out) out[k] = q - buf;
    ++k;
    p = q + 1;
  }
  return k;
}

// Per-line UTF-8 char counts (number of non-continuation bytes in each
// [start, end) range) — the lean server's bucketing input, replacing a
// full-chunk numpy cumsum that profiled as the host pipeline's hottest
// stage.
void vt_count_chars(const uint8_t* utf8, const int64_t* starts,
                    const int64_t* ends, int64_t n_lines,
                    int32_t* counts, int32_t n_threads) {
  vt::parallel_rows(n_lines, n_threads, 1024,
                    [&](int64_t lo, int64_t hi) {
                      for (int64_t row = lo; row < hi; ++row) {
                        const uint8_t* p = utf8 + starts[row];
                        const uint8_t* end = utf8 + ends[row];
                        int32_t n = 0;
                        for (; p < end; ++p) n += (*p & 0xC0) != 0x80;
                        counts[row] = n;
                      }
                    });
}

// Detokenize: insert spaces into the ORIGINAL UTF-8 lines at predicted
// word boundaries, escaping ' ', '/', '\\' with '\\' exactly like the
// tokenized writer (reference sentence.rs:850-886), one output line per
// input line. bnd: (n_lines, Lm1) int8 row-major, gap i between chars
// i/i+1 (1 = WordBoundary). Escape/space bytes are all ASCII and UTF-8
// continuation bytes are recognizable by their top bits, so this is a
// byte-level pass — no decode. Lines given as (starts, ends) ranges (see
// vt_tensorize16). Returns bytes written, or -1 if out_cap would be
// exceeded (caller sizes out to 2*total_bytes + n_lines*(Lm1+1), which
// can never overflow).
int64_t vt_detok(const uint8_t* utf8, const int64_t* starts,
                 const int64_t* ends, int64_t n_lines, const int8_t* bnd,
                 int32_t Lm1, uint8_t* out, int64_t out_cap,
                 int32_t n_threads) {
  // per-line output upper bound lets lines be emitted independently and
  // compacted, so the pass parallelizes across a thread pool
  std::vector<int64_t> out_len(n_lines, 0);
  std::vector<int64_t> out_start(n_lines + 1, 0);
  for (int64_t row = 0; row < n_lines; ++row) {
    int64_t nbytes = ends[row] - starts[row];
    out_start[row + 1] = out_start[row] + 2 * nbytes + Lm1 + 1;
  }
  if (out_start[n_lines] > out_cap) return -1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t row = lo; row < hi; ++row) {
      const uint8_t* p = utf8 + starts[row];
      const uint8_t* end = utf8 + ends[row];
      const int8_t* b = bnd + row * Lm1;
      uint8_t* o = out + out_start[row];
      uint8_t* o0 = o;
      int32_t ci = 0;  // char index of the char starting at p
      while (p < end) {
        uint8_t byte = *p;
        if ((byte & 0xC0) != 0x80) {  // char start
          if (ci > 0 && ci <= Lm1 && b[ci - 1] == 1) *o++ = ' ';
          ++ci;
          if (byte == ' ' || byte == '/' || byte == '\\') *o++ = '\\';
        }
        *o++ = byte;
        ++p;
      }
      *o++ = '\n';
      out_len[row] = o - o0;
    }
  };
  vt::parallel_rows(n_lines, n_threads, 256, work);
  int64_t w = 0;
  for (int64_t row = 0; row < n_lines; ++row) {
    if (w != out_start[row])
      std::memmove(out + w, out + out_start[row], out_len[row]);
    w += out_len[row];
  }
  return w;
}

// Bit-packed detokenizer: boundaries arrive as COLUMN-MAJOR bit rows
// (8 gaps per byte; gap g = bit g / bytes_per_row of byte
// g % bytes_per_row — the layout the device packs with contiguous
// slices, see predictor._pack_gap_bits), and each line's gaps may
// start at an arbitrary (row, col) of the packed batch — the
// short-line packing layout. rows/cols NULL means line i's gaps start
// at (i, 0) (the unpacked lean path).
int64_t vt_detok_bits(const uint8_t* utf8, const int64_t* starts,
                      const int64_t* ends, int64_t n_lines,
                      const uint8_t* bits, int32_t bytes_per_row,
                      const int32_t* rows_of, const int32_t* cols_of,
                      int64_t max_gaps, uint8_t* out, int64_t out_cap,
                      int32_t n_threads) {
  std::vector<int64_t> out_len(n_lines, 0);
  std::vector<int64_t> out_start(n_lines + 1, 0);
  for (int64_t row = 0; row < n_lines; ++row) {
    int64_t nbytes = ends[row] - starts[row];
    out_start[row + 1] = out_start[row] + 2 * nbytes + max_gaps + 1;
  }
  if (out_start[n_lines] > out_cap) return -1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t line = lo; line < hi; ++line) {
      const uint8_t* p = utf8 + starts[line];
      const uint8_t* end = utf8 + ends[line];
      int64_t row = rows_of ? rows_of[line] : line;
      int64_t base = cols_of ? cols_of[line] : 0;
      const uint8_t* brow = bits + row * bytes_per_row;
      uint8_t* o = out + out_start[line];
      uint8_t* o0 = o;
      int32_t ci = 0;
      while (p < end) {
        uint8_t byte = *p;
        if ((byte & 0xC0) != 0x80) {  // char start
          if (ci > 0 && ci <= max_gaps) {
            int64_t pos = base + ci - 1;
            if ((brow[pos % bytes_per_row] >> (pos / bytes_per_row)) & 1)
              *o++ = ' ';
          }
          ++ci;
          if (byte == ' ' || byte == '/' || byte == '\\') *o++ = '\\';
        }
        *o++ = byte;
        ++p;
      }
      *o++ = '\n';
      out_len[line] = o - o0;
    }
  };
  vt::parallel_rows(n_lines, n_threads, 256, work);
  int64_t w = 0;
  for (int64_t row = 0; row < n_lines; ++row) {
    if (w != out_start[row])
      std::memmove(out + w, out + out_start[row], out_len[row]);
    w += out_len[row];
  }
  return w;
}

namespace {

// column-major gap bits (ops/boundary.pack_gap_bits): gap pos lives in
// byte pos % W at bit pos / W, W = bytes per packed row
inline int bit_at(const uint8_t* brow, int64_t pos, int32_t W) {
  return (brow[pos % W] >> (pos / W)) & 1;
}

// append a codepoint (BMP) as UTF-8
inline uint8_t* put_utf8(uint8_t* o, uint32_t c) {
  if (c < 0x80) {
    *o++ = static_cast<uint8_t>(c);
  } else if (c < 0x800) {
    *o++ = static_cast<uint8_t>(0xC0 | (c >> 6));
    *o++ = static_cast<uint8_t>(0x80 | (c & 0x3F));
  } else {
    *o++ = static_cast<uint8_t>(0xE0 | (c >> 12));
    *o++ = static_cast<uint8_t>(0x80 | ((c >> 6) & 0x3F));
    *o++ = static_cast<uint8_t>(0x80 | (c & 0x3F));
  }
  return o;
}

inline uint8_t* put_int(uint8_t* o, int64_t v) {
  if (v < 0) {
    *o++ = '-';
    v = -v;
  }
  uint8_t tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<uint8_t>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *o++ = tmp[--n];
  return o;
}

// bytes of one "i:AB score\n" line of a --scores block at most: a gap index
// and a score of up to 11 chars each, two 3-byte chars, ':', ' ', '\n'
constexpr int64_t PER_GAP = 30;

}  // namespace

// The v1 writers, kept for the native module's detok_scores_native and
// detok_tags_native (the JAX package's entry points of the same names):
// one line per row at column 0, boundaries one int8 a gap, int32 token ids.
//
// Scores-printing detokenizer: per line, the tokenized text (vt_detok
// semantics), then one "i:AB score" line per gap of the NORMALIZED text
// (reference predict/src/main.rs:66-75 prints scores of the normalized
// sentence), then a blank line. cps16: the normalized (n_lines, L) uint16
// codepoints the kernel consumed;
// scores: (n_lines, Lm1) int32 raw gap scores. Returns bytes written,
// -1 if out_cap is insufficient.
int64_t vt_detok_scores(const uint8_t* utf8, const int64_t* starts,
                        const int64_t* ends, int64_t n_lines,
                        const int8_t* bnd, int32_t Lm1,
                        const uint16_t* cps16, const int32_t* lengths,
                        const int32_t* scores, uint8_t* out,
                        int64_t out_cap, int32_t n_threads) {
  const int32_t L = Lm1 + 1;
  std::vector<int64_t> out_len(n_lines, 0);
  std::vector<int64_t> out_start(n_lines + 1, 0);
  for (int64_t row = 0; row < n_lines; ++row) {
    int64_t nbytes = ends[row] - starts[row];
    out_start[row + 1] =
        out_start[row] + 2 * nbytes + Lm1 + 2 + Lm1 * PER_GAP;
  }
  if (out_start[n_lines] > out_cap) return -1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t row = lo; row < hi; ++row) {
      const uint8_t* p = utf8 + starts[row];
      const uint8_t* end = utf8 + ends[row];
      const int8_t* b = bnd + row * Lm1;
      uint8_t* o = out + out_start[row];
      uint8_t* o0 = o;
      int32_t ci = 0;
      while (p < end) {
        uint8_t byte = *p;
        if ((byte & 0xC0) != 0x80) {
          if (ci > 0 && ci <= Lm1 && b[ci - 1] == 1) *o++ = ' ';
          ++ci;
          if (byte == ' ' || byte == '/' || byte == '\\') *o++ = '\\';
        }
        *o++ = byte;
        ++p;
      }
      *o++ = '\n';
      const uint16_t* cp = cps16 + row * L;
      const int32_t* sc = scores + row * Lm1;
      int32_t n = lengths[row];
      if (n > 0) {  // empty lines have no Sentence -> no score block
        for (int32_t i = 0; i + 1 < n; ++i) {
          o = put_int(o, i);
          *o++ = ':';
          o = put_utf8(o, cp[i]);
          o = put_utf8(o, cp[i + 1]);
          *o++ = ' ';
          o = put_int(o, sc[i]);
          *o++ = '\n';
        }
        *o++ = '\n';
      }
      out_len[row] = o - o0;
    }
  };
  vt::parallel_rows(n_lines, n_threads, 256, work);
  int64_t w = 0;
  for (int64_t row = 0; row < n_lines; ++row) {
    if (w != out_start[row])
      std::memmove(out + w, out + out_start[row], out_len[row]);
    w += out_len[row];
  }
  return w;
}

// Tag-aware detokenizer: like vt_detok, but after each token's (escaped)
// surface it appends the token's tags resolved from the tag pass's outputs
// (reference tokenized writer sentence.rs:850-886: '/'-joined tags with
// trailing-None truncation; the truncation point is static per token id
// and precomputed into the emission plan).
//
//   tid:    (n_lines, L) int32 — token id at each token's LAST char
//           (-1 = unrecognized).
//   choice: (n_lines, L, n_slots) int8 — winning candidate per slot for
//           multi-candidate slots (-1 otherwise).
//   Emission plan per token id (host-built from the model's tag lists):
//     ent_start[tid]..ent_start[tid+1]: one entry per emitted slot, in
//     slot order ("/"-separated). ent_base = candidate-pool index of the
//     slot's first candidate (-1 = empty slot: bare "/"); ent_ccol = the
//     choice column to add (-1 = single candidate, use base directly).
//   pool: concatenated PRE-ESCAPED UTF-8 tag strings; pool_off has
//     n_pool + 1 offsets.
//
// Returns bytes written, or -1 when out_cap is insufficient.
int64_t vt_detok_tags(const uint8_t* utf8, const int64_t* starts,
                      const int64_t* ends, int64_t n_lines,
                      const int8_t* bnd, int32_t Lm1, const int32_t* tid,
                      const int8_t* choice, int32_t n_slots,
                      const int64_t* ent_start, const int32_t* ent_base,
                      const int32_t* ent_ccol, const uint8_t* pool,
                      const int64_t* pool_off, int64_t max_tag_bytes,
                      uint8_t* out, int64_t out_cap, int32_t n_threads) {
  const int32_t L = Lm1 + 1;
  std::vector<int64_t> out_len(n_lines, 0);
  std::vector<int64_t> out_start(n_lines + 1, 0);
  for (int64_t row = 0; row < n_lines; ++row) {
    int64_t nbytes = ends[row] - starts[row];
    const int8_t* b = bnd + row * Lm1;
    int64_t ntok = 1;  // one tag block per token
    for (int32_t i = 0; i < Lm1; ++i) ntok += b[i] == 1;
    out_start[row + 1] =
        out_start[row] + 2 * nbytes + Lm1 + 1 + ntok * max_tag_bytes;
  }
  if (out_start[n_lines] > out_cap) return -1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t row = lo; row < hi; ++row) {
      const uint8_t* p = utf8 + starts[row];
      const uint8_t* end = utf8 + ends[row];
      const int8_t* b = bnd + row * Lm1;
      const int32_t* trow = tid + row * L;
      const int8_t* crow = choice + row * L * n_slots;
      uint8_t* o = out + out_start[row];
      uint8_t* o0 = o;
      int32_t ci = 0;  // char index of the char starting at p
      auto emit_tags = [&](int32_t last_char) {
        int32_t t = trow[last_char];
        if (t < 0) return;
        for (int64_t ei = ent_start[t]; ei < ent_start[t + 1]; ++ei) {
          *o++ = '/';
          int32_t base = ent_base[ei];
          if (base < 0) continue;  // empty-candidate slot: bare '/'
          int32_t ccol = ent_ccol[ei];
          int64_t k = base;
          if (ccol >= 0) {
            int8_t ch = crow[static_cast<int64_t>(last_char) * n_slots + ccol];
            if (ch > 0) k += ch;
          }
          int64_t plo = pool_off[k], phi = pool_off[k + 1];
          std::memcpy(o, pool + plo, phi - plo);
          o += phi - plo;
        }
      };
      while (p < end) {
        uint8_t byte = *p;
        if ((byte & 0xC0) != 0x80) {  // char start
          if (ci > 0 && ci <= Lm1 && b[ci - 1] == 1) {
            emit_tags(ci - 1);  // close the token ending at char ci-1
            *o++ = ' ';
          }
          ++ci;
          if (byte == ' ' || byte == '/' || byte == '\\') *o++ = '\\';
        }
        *o++ = byte;
        ++p;
      }
      if (ci > 0) emit_tags(ci - 1);  // final token
      *o++ = '\n';
      out_len[row] = o - o0;
    }
  };
  vt::parallel_rows(n_lines, n_threads, 256, work);
  int64_t w = 0;
  for (int64_t row = 0; row < n_lines; ++row) {
    if (w != out_start[row])
      std::memmove(out + w, out + out_start[row], out_len[row]);
    w += out_len[row];
  }
  return w;
}

// Scores writer for the lean --scores path: per line, the tokenized text
// (vt_detok_bits semantics), then one "i:AB score" line per gap of the
// NORMALIZED text (reference predict/src/main.rs:66-75 prints the scores of
// the normalized sentence), then a blank line. Boundaries arrive as bit
// rows at per-line (row, col) placement (NULL = line i at (i, 0)); counts
// are the per-line char counts; cps16 (B, L) and scores (B, Lm1) are the
// device rows, line i reading columns col .. col + count - 1. Empty lines
// (count 0) have no Sentence on the general path and get no block. Returns
// the bytes written, or -1 when out_cap is below the per-line bound
// 2 * bytes + chars + 2 + chars * PER_GAP.
int64_t vt_detok_scores2(const uint8_t* utf8, const int64_t* starts,
                         const int64_t* ends, int64_t n_lines,
                         const uint8_t* bits, int32_t bytes_per_row,
                         const int32_t* rows_of, const int32_t* cols_of,
                         const int32_t* counts, const uint16_t* cps16,
                         int32_t L, const int32_t* scores, int32_t Lm1,
                         uint8_t* out, int64_t out_cap, int32_t n_threads) {
  std::vector<int64_t> out_len(n_lines, 0);
  std::vector<int64_t> out_start(n_lines + 1, 0);
  for (int64_t line = 0; line < n_lines; ++line) {
    int64_t nbytes = ends[line] - starts[line];
    int64_t n = counts[line];
    out_start[line + 1] = out_start[line] + 2 * nbytes + n + 2 + n * PER_GAP;
  }
  if (out_start[n_lines] > out_cap) return -1;
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t line = lo; line < hi; ++line) {
      const uint8_t* p = utf8 + starts[line];
      const uint8_t* end = utf8 + ends[line];
      int64_t row = rows_of ? rows_of[line] : line;
      int64_t base = cols_of ? cols_of[line] : 0;
      const uint8_t* brow = bits + row * bytes_per_row;
      int32_t n = counts[line];
      uint8_t* o = out + out_start[line];
      uint8_t* o0 = o;
      int32_t ci = 0;
      while (p < end) {
        uint8_t byte = *p;
        if ((byte & 0xC0) != 0x80) {  // char start
          if (ci > 0 && ci < n && bit_at(brow, base + ci - 1, bytes_per_row))
            *o++ = ' ';
          ++ci;
          if (byte == ' ' || byte == '/' || byte == '\\') *o++ = '\\';
        }
        *o++ = byte;
        ++p;
      }
      *o++ = '\n';
      if (n > 0) {
        const uint16_t* cp = cps16 + row * L + base;
        const int32_t* sc = scores + row * Lm1 + base;
        for (int32_t i = 0; i + 1 < n; ++i) {
          o = put_int(o, i);
          *o++ = ':';
          o = put_utf8(o, cp[i]);
          o = put_utf8(o, cp[i + 1]);
          *o++ = ' ';
          o = put_int(o, sc[i]);
          *o++ = '\n';
        }
        *o++ = '\n';
      }
      out_len[line] = o - o0;
    }
  };
  vt::parallel_rows(n_lines, n_threads, 256, work);
  int64_t w = 0;
  for (int64_t line = 0; line < n_lines; ++line) {
    if (w != out_start[line])
      std::memmove(out + w, out + out_start[line], out_len[line]);
    w += out_len[line];
  }
  return w;
}

// Tag-aware detokenizer for the lean --predict-tags path: like
// vt_detok_bits, but after each token's (escaped) surface it appends the
// token's tags resolved from the tag kernel's outputs (reference tokenized
// writer sentence.rs:850-886: '/'-joined tags with trailing-None
// truncation, static per token id and precomputed into the emission plan).
//   tid:    (B, L) token id at each token's LAST char (-1 = unrecognized),
//           at its native width (tid_kind 0/1/2 = int32/int16/int8);
//   choice: (B, L, n_slots) int8 winning candidate per multi-candidate
//           slot (-1 otherwise).
//   Emission plan per token id (native.TagEmitPlan):
//     ent_start[tid]..ent_start[tid+1]: one entry per emitted slot, in
//     slot order ("/"-separated). ent_base = candidate-pool index of the
//     slot's first candidate (-1 = empty slot: bare "/"); ent_ccol = the
//     choice column to add (-1 = single candidate, use base directly).
//   pool: concatenated PRE-ESCAPED UTF-8 tag strings; pool_off has
//     n_pool + 1 offsets.
// The optional diagnostic blocks of the rich --predict-tags combinations
// follow each line (reference print_scores / print_tag_scores,
// predict/src/main.rs:65-91):
//   * gap_scores != NULL: the --scores block of vt_detok_scores2 (one
//     "i:AB score" line per gap of the normalized line, then a blank line),
//     gap_scores (B, Lm1) and cps16 (B, L) at the line's placement;
//   * tag_scores != NULL: the --tag-scores block (one line per token: the
//     normalized surface, then per slot a tab and either "cand:0" for a
//     single-candidate slot or "cand:score,..." over the token's (B, L, C)
//     class-concatenated score row; a blank line after), from the plan
//     (native.TagScoresPlan):
//       ts_start[tid]..ts_start[tid+1]: one entry per slot (every slot);
//       ts_base = UNESCAPED candidate pool index of the slot's first
//       candidate; ts_cnt = candidate count; ts_koff = the slot's score
//       column (prefix sum of the counts of multi-candidate slots).
// Boundaries arrive as bit rows at per-line (row, col) placement (NULL =
// line i at (i, 0)); counts are the per-line char counts. Empty lines
// (count 0) emit a bare line and no blocks (the general path's
// from_raw("") error semantics). Returns the bytes written, or -1 when
// out_cap is below the sum of the per-line bounds: 2 * bytes + chars + 1 +
// tokens * max_tag_bytes, plus chars * PER_GAP + 2 with gap scores, plus
// 3 * chars + tokens * (ts_max_bytes + 1) + 2 with tag scores.
int64_t vt_detok_tags2(
    const uint8_t* utf8, const int64_t* starts, const int64_t* ends,
    int64_t n_lines, const uint8_t* bits, int32_t bytes_per_row,
    const int32_t* rows_of, const int32_t* cols_of, const int32_t* counts,
    const void* tid, int32_t tid_kind, int64_t L, const int8_t* choice,
    int32_t n_slots, const int64_t* ent_start, const int32_t* ent_base,
    const int32_t* ent_ccol, const uint8_t* pool, const int64_t* pool_off,
    int64_t max_tag_bytes, const uint16_t* cps16, const int32_t* gap_scores,
    int32_t Lm1, const int32_t* tag_scores, int32_t C,
    const int64_t* ts_start, const int32_t* ts_base, const int32_t* ts_cnt,
    const int32_t* ts_koff, const uint8_t* ts_pool,
    const int64_t* ts_pool_off, int64_t ts_max_bytes, uint8_t* out,
    int64_t out_cap, int32_t n_threads) {
  std::vector<int64_t> out_len(n_lines, 0);
  std::vector<int64_t> out_start(n_lines + 1, 0);
  for (int64_t line = 0; line < n_lines; ++line) {
    int64_t nbytes = ends[line] - starts[line];
    int64_t n = counts[line];
    int64_t row = rows_of ? rows_of[line] : line;
    int64_t base = cols_of ? cols_of[line] : 0;
    const uint8_t* brow = bits + row * bytes_per_row;
    int64_t ntok = 1;
    for (int64_t g = 0; g + 1 < n; ++g) ntok += bit_at(brow, base + g, bytes_per_row);
    int64_t cap = 2 * nbytes + n + 1 + ntok * max_tag_bytes;
    if (gap_scores) cap += n * PER_GAP + 2;
    if (tag_scores)  // surfaces print NORMALIZED codepoints (<= 3 B a char)
      cap += 3 * n + ntok * (ts_max_bytes + 1) + 2;
    out_start[line + 1] = out_start[line] + cap;
  }
  if (out_start[n_lines] > out_cap) return -1;
  auto tid_at = [&](int64_t row, int64_t col) -> int32_t {
    int64_t idx = row * L + col;
    switch (tid_kind) {
      case 1:
        return static_cast<const int16_t*>(tid)[idx];
      case 2:
        return static_cast<const int8_t*>(tid)[idx];
      default:
        return static_cast<const int32_t*>(tid)[idx];
    }
  };
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t line = lo; line < hi; ++line) {
      const uint8_t* p = utf8 + starts[line];
      const uint8_t* end = utf8 + ends[line];
      int64_t row = rows_of ? rows_of[line] : line;
      int64_t base = cols_of ? cols_of[line] : 0;
      const uint8_t* brow = bits + row * bytes_per_row;
      int32_t n = counts[line];
      uint8_t* o = out + out_start[line];
      uint8_t* o0 = o;
      int32_t ci = 0;
      auto emit_tags = [&](int32_t last_char) {
        int32_t t = tid_at(row, base + last_char);
        if (t < 0) return;
        for (int64_t ei = ent_start[t]; ei < ent_start[t + 1]; ++ei) {
          *o++ = '/';
          int32_t eb = ent_base[ei];
          if (eb < 0) continue;  // empty-candidate slot: bare '/'
          int32_t ccol = ent_ccol[ei];
          int64_t k = eb;
          if (ccol >= 0) {
            int8_t ch =
                choice[(row * L + base + last_char) * n_slots + ccol];
            if (ch > 0) k += ch;
          }
          int64_t plo = pool_off[k], phi = pool_off[k + 1];
          std::memcpy(o, pool + plo, phi - plo);
          o += phi - plo;
        }
      };
      while (p < end) {
        uint8_t byte = *p;
        if ((byte & 0xC0) != 0x80) {  // char start
          if (ci > 0 && ci < n && bit_at(brow, base + ci - 1, bytes_per_row)) {
            emit_tags(ci - 1);
            *o++ = ' ';
          }
          ++ci;
          if (byte == ' ' || byte == '/' || byte == '\\') *o++ = '\\';
        }
        *o++ = byte;
        ++p;
      }
      if (ci > 0) emit_tags(ci - 1);
      *o++ = '\n';
      if (n > 0 && gap_scores) {
        const uint16_t* cp = cps16 + row * L + base;
        const int32_t* sc = gap_scores + row * Lm1 + base;
        for (int32_t i = 0; i + 1 < n; ++i) {
          o = put_int(o, i);
          *o++ = ':';
          o = put_utf8(o, cp[i]);
          o = put_utf8(o, cp[i + 1]);
          *o++ = ' ';
          o = put_int(o, sc[i]);
          *o++ = '\n';
        }
        *o++ = '\n';
      }
      if (n > 0 && tag_scores) {
        const uint16_t* cp = cps16 + row * L + base;
        int32_t st = 0;
        for (int32_t e = 0; e < n; ++e) {
          if (e != n - 1 && !bit_at(brow, base + e, bytes_per_row)) continue;
          for (int32_t i = st; i <= e; ++i) o = put_utf8(o, cp[i]);
          int32_t t = tid_at(row, base + e);
          if (t >= 0) {
            const int32_t* srow = tag_scores + (row * L + base + e) * C;
            for (int64_t ei = ts_start[t]; ei < ts_start[t + 1]; ++ei) {
              *o++ = '\t';
              int32_t cnt = ts_cnt[ei];
              int64_t pb = ts_base[ei];
              if (cnt == 1) {
                int64_t plo = ts_pool_off[pb], phi = ts_pool_off[pb + 1];
                std::memcpy(o, ts_pool + plo, phi - plo);
                o += phi - plo;
                *o++ = ':';
                *o++ = '0';
              } else {
                int32_t k = ts_koff[ei];
                for (int32_t j = 0; j < cnt; ++j) {
                  if (j) *o++ = ',';
                  int64_t plo = ts_pool_off[pb + j];
                  int64_t phi = ts_pool_off[pb + j + 1];
                  std::memcpy(o, ts_pool + plo, phi - plo);
                  o += phi - plo;
                  *o++ = ':';
                  o = put_int(o, srow[k + j]);
                }
              }
            }
          }
          *o++ = '\n';
          st = e + 1;
        }
        *o++ = '\n';
      }
      out_len[line] = o - o0;
    }
  };
  vt::parallel_rows(n_lines, n_threads, 256, work);
  int64_t w = 0;
  for (int64_t line = 0; line < n_lines; ++line) {
    if (w != out_start[line])
      std::memmove(out + w, out + out_start[line], out_len[line]);
    w += out_len[line];
  }
  return w;
}

}  // extern "C"
