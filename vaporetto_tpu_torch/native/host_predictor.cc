// Native host predictor: evaluates a compiled model (the same packed
// double-array + fixed-8 weight tables the device kernels consume) on CPU.
//
// This is the framework's low-latency serving path and the analogue of the
// reference's zero-copy predictor used by its WASM/embedded targets
// (reference predictor.rs:639-664, examples/embedded_device/): device
// dispatch latency dominates single-sentence requests, so production
// serving routes small batches here and large batches to the TPU. Results
// are bit-identical to the device pipeline (same tables, same int32
// wrapping arithmetic, same padding scheme).
//
// The device matcher walks windows in parallel and needs no failure links;
// the host scan is sequential, so failure links are reconstructed from
// base/check at load time (BFS over the trie) and the scan is a classic
// Aho-Corasick pass emitting, per position, the deepest state's resolved
// output (`inherit`) — exactly the device's longest-match stream
// (reference char_scorer/boundary_scorer.rs:91-113 semantics).

#include "common.h"
#include <cstdint>
#include <cstring>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Matcher {
  std::vector<int32_t> base, check, inherit, fail;
  std::vector<int32_t> rows_first, rows_cnt, w8, off;
  int64_t n_slots = 0;
  bool present = false;

  void set_tables(const int32_t* b, const int32_t* c, const int32_t* inh,
                  int64_t slots, const int32_t* rf, const int32_t* rc,
                  int64_t n_ids, const int32_t* w, const int32_t* o,
                  int64_t n_rows) {
    n_slots = slots;
    base.assign(b, b + slots);
    check.assign(c, c + slots);
    inherit.assign(inh, inh + slots);
    rows_first.assign(rf, rf + n_ids);
    rows_cnt.assign(rc, rc + n_ids);
    w8.assign(w, w + n_rows * 8);
    off.assign(o, o + n_rows);
    build_fail();
    present = true;
  }

  // Reconstruct Aho-Corasick failure links from the packed double array:
  // child slots carry their parent in `check`, so a counting sort groups
  // children per parent and a BFS assigns fail[] top-down.
  void build_fail() {
    fail.assign(n_slots, 0);
    std::vector<int64_t> cnt(n_slots + 1, 0);
    for (int64_t t = 1; t < n_slots; ++t) {
      int32_t p = check[t];
      if (p >= 0 && p != t) cnt[p + 1]++;
    }
    for (int64_t i = 0; i < n_slots; ++i) cnt[i + 1] += cnt[i];
    std::vector<int32_t> kids(cnt[n_slots]);
    std::vector<int64_t> fill(cnt.begin(), cnt.end() - 1);
    for (int64_t t = 1; t < n_slots; ++t) {
      int32_t p = check[t];
      if (p >= 0 && p != t) kids[fill[p]++] = static_cast<int32_t>(t);
    }
    std::queue<int32_t> q;
    q.push(0);
    while (!q.empty()) {
      int32_t u = q.front();
      q.pop();
      for (int64_t i = cnt[u]; i < cnt[u + 1]; ++i) {
        int32_t v = kids[i];
        int32_t a = v - base[u];  // the symbol leading u -> v
        if (u == 0) {
          fail[v] = 0;
        } else {
          int32_t f = fail[u];
          while (true) {
            int64_t t2 = static_cast<int64_t>(base[f]) + a;
            if (t2 >= 0 && t2 < n_slots && check[t2] == f) {
              fail[v] = static_cast<int32_t>(t2);
              break;
            }
            if (f == 0) {
              fail[v] = 0;
              break;
            }
            f = fail[f];
          }
        }
        q.push(v);
      }
    }
  }

  inline int32_t step(int32_t s, int32_t a) const {
    while (true) {
      int64_t t = static_cast<int64_t>(base[s]) + a;
      if (t >= 0 && t < n_slots && check[t] == s)
        return static_cast<int32_t>(t);
      if (s == 0) return 0;
      s = fail[s];
    }
  }

  // scores[t + pad_left + off] += w8 row (int32 wrapping, like the device)
  void add_scores(const int32_t* match, int64_t n, int32_t pad_left,
                  int32_t* scores) const {
    for (int64_t t = 0; t < n; ++t) {
      int32_t m = match[t];
      if (m < 0) continue;
      int32_t first = rows_first[m];
      int32_t c = rows_cnt[m];
      for (int32_t k = 0; k < c; ++k) {
        const int32_t* w = &w8[static_cast<int64_t>(first + k) * 8];
        int32_t* dst = scores + t + pad_left + off[first + k];
        for (int j = 0; j < 8; ++j)
          dst[j] = static_cast<int32_t>(static_cast<uint32_t>(dst[j]) +
                                        static_cast<uint32_t>(w[j]));
      }
    }
  }
};

struct HostPredictor {
  int32_t bias = 0, pad_left = 0, pad_right = 0;
  Matcher chr, typ;
  std::vector<int32_t> sym_table;  // dense codepoint -> symbol (0 = OOV)
  std::vector<int32_t> type_cache;
  int32_t type_window = 0;
};

}  // namespace

extern "C" {

void* vt_host_new(int32_t bias, int32_t pad_left, int32_t pad_right) {
  auto* h = new HostPredictor();
  h->bias = bias;
  h->pad_left = pad_left;
  h->pad_right = pad_right;
  return h;
}

void vt_host_free(void* hp) { delete static_cast<HostPredictor*>(hp); }

int vt_host_set_char(void* hp, const int32_t* base, const int32_t* check,
                     const int32_t* inherit, int64_t n_slots,
                     const int32_t* rf, const int32_t* rc, int64_t n_ids,
                     const int32_t* w8, const int32_t* off, int64_t n_rows,
                     const int32_t* sym_table, int64_t sym_size) {
  auto* h = static_cast<HostPredictor*>(hp);
  h->chr.set_tables(base, check, inherit, n_slots, rf, rc, n_ids, w8, off,
                    n_rows);
  h->sym_table.assign(sym_table, sym_table + sym_size);
  return 0;
}

int vt_host_set_type_cache(void* hp, const int32_t* table, int64_t size,
                           int32_t window) {
  auto* h = static_cast<HostPredictor*>(hp);
  h->type_cache.assign(table, table + size);
  h->type_window = window;
  return 0;
}

int vt_host_set_type_trie(void* hp, const int32_t* base, const int32_t* check,
                          const int32_t* inherit, int64_t n_slots,
                          const int32_t* rf, const int32_t* rc, int64_t n_ids,
                          const int32_t* w8, const int32_t* off,
                          int64_t n_rows) {
  auto* h = static_cast<HostPredictor*>(hp);
  h->typ.set_tables(base, check, inherit, n_slots, rf, rc, n_ids, w8, off,
                    n_rows);
  return 0;
}

// Predict one sentence. scores must hold pad_left + max(n-1, 0) + pad_right
// int32s; char_match / type_match must hold n int32s each (filled with -1
// when the corresponding matcher is absent).
int vt_host_predict(void* hp, const int32_t* cps, const uint8_t* cts,
                    int64_t n, int32_t* scores, int32_t* char_match,
                    int32_t* type_match) {
  auto* h = static_cast<HostPredictor*>(hp);
  int64_t gaps = n > 0 ? n - 1 : 0;
  int64_t S = h->pad_left + gaps + h->pad_right;
  for (int64_t i = 0; i < S; ++i) scores[i] = h->bias;

  if (h->chr.present) {
    int64_t sym_size = static_cast<int64_t>(h->sym_table.size());
    int32_t s = 0;
    for (int64_t t = 0; t < n; ++t) {
      int32_t cp = cps[t];
      int32_t a =
          (cp >= 0 && cp < sym_size) ? h->sym_table[cp] : 0;
      if (a <= 0) {
        s = 0;
        char_match[t] = -1;
      } else {
        s = h->chr.step(s, a);
        char_match[t] = h->chr.inherit[s];
      }
    }
    h->chr.add_scores(char_match, n, h->pad_left, scores);
  } else {
    for (int64_t t = 0; t < n; ++t) char_match[t] = -1;
  }

  if (!h->type_cache.empty()) {
    int32_t w = h->type_window;
    int32_t bits = 3 * 2 * w;
    int32_t mask = (1 << bits) - 1;
    // rolling window id: gap i sees chars i-w+1 .. i+w
    // (reference type_scorer/boundary_scorer_cache.rs:58-110)
    int32_t seqid = 0;
    for (int64_t j = -w + 1; j < w; ++j) {
      int32_t c = (j >= 0 && j < n) ? cts[j] : 0;
      seqid = ((seqid << 3) | c) & mask;
    }
    for (int64_t i = 0; i + 1 < n; ++i) {
      int64_t j = i + w;
      int32_t c = (j < n) ? cts[j] : 0;
      seqid = ((seqid << 3) | c) & mask;
      scores[h->pad_left + i] = static_cast<int32_t>(
          static_cast<uint32_t>(scores[h->pad_left + i]) +
          static_cast<uint32_t>(h->type_cache[seqid]));
    }
    for (int64_t t = 0; t < n; ++t) type_match[t] = -1;
  } else if (h->typ.present) {
    int32_t s = 0;
    for (int64_t t = 0; t < n; ++t) {
      int32_t a = cts[t];
      if (a <= 0) {
        s = 0;
        type_match[t] = -1;
      } else {
        s = h->typ.step(s, a);
        type_match[t] = h->typ.inherit[s];
      }
    }
    h->typ.add_scores(type_match, n, h->pad_left, scores);
  } else {
    for (int64_t t = 0; t < n; ++t) type_match[t] = -1;
  }
  return 0;
}

namespace {

inline uint8_t serve_char_type(uint32_t c) { return vt::char_type(c); }

}  // namespace

// Lean HOST serving in one call: padded (B, L) uint16 codepoints +
// lengths -> int8 gap labels (B, L-1) with wsconst fused, optionally the
// raw int32 gap scores. Per row: widen, classify char types, run the
// sequential predictor, threshold — the C++ twin of the device serve
// kernel for `--backend host` (no numpy glue on the hot path).
int vt_host_serve_padded(void* hp, const uint16_t* cps,
                         const int32_t* lengths, int64_t B, int32_t L,
                         const int32_t* ws_types, int32_t n_ws,
                         int8_t* out_bnd, int32_t* out_scores,
                         int32_t* out_cm, int32_t* out_tm,
                         int32_t n_threads) {
  auto* h = static_cast<HostPredictor*>(hp);
  const int32_t Lm1 = L - 1;
  auto work = [&](int64_t lo, int64_t hi) {
    std::vector<int32_t> cps32(L), cm_buf(L), tm_buf(L);
    std::vector<int32_t> scores(h->pad_left + (L > 0 ? L - 1 : 0) +
                                h->pad_right + 8);
    std::vector<uint8_t> cts(L);
    for (int64_t row = lo; row < hi; ++row) {
      int32_t n = lengths[row];
      if (n > L) n = L;
      const uint16_t* src = cps + row * L;
      for (int32_t i = 0; i < n; ++i) {
        cps32[i] = src[i];
        cts[i] = serve_char_type(src[i]);
      }
      // per-position match states go straight to the caller's padded
      // rows when requested (the lean host tag path consumes them)
      int32_t* cm = out_cm ? out_cm + row * L : cm_buf.data();
      int32_t* tm = out_tm ? out_tm + row * L : tm_buf.data();
      vt_host_predict(hp, cps32.data(), cts.data(), n, scores.data(),
                      cm, tm);
      if (out_cm)
        for (int32_t i = n; i < L; ++i) cm[i] = -1;
      if (out_tm)
        for (int32_t i = n; i < L; ++i) tm[i] = -1;
      int8_t* bnd = out_bnd + row * Lm1;
      int32_t* sc = out_scores ? out_scores + row * Lm1 : nullptr;
      int32_t i = 0;
      for (; i + 1 < n; ++i) {
        int32_t v = scores[h->pad_left + i];
        int8_t b = v > 0;
        if (b && n_ws) {
          for (int32_t k = 0; k < n_ws; ++k) {
            if (cts[i] == ws_types[k] && cts[i + 1] == ws_types[k]) {
              b = 0;
              break;
            }
          }
        }
        bnd[i] = b;
        if (sc) sc[i] = v;
      }
      for (; i < Lm1; ++i) {
        bnd[i] = 0;
        if (sc) sc[i] = 0;
      }
    }
  };
  vt::parallel_rows(B, n_threads, 2, work);
  return 0;
}

// Batched prediction: all lines in flat arrays, one call. `offsets` has
// n_lines+1 entries delimiting each line's codepoints/char-types;
// `score_offsets` (n_lines+1) delimits each line's
// pad_left + max(len-1, 0) + pad_right score slots. char/type match slots
// share `offsets`. Lines are distributed over `n_threads` worker threads
// (0 = hardware concurrency) — each line is independent.
int vt_host_predict_batch(void* hp, const int32_t* cps_flat,
                          const uint8_t* cts_flat, const int64_t* offsets,
                          int64_t n_lines, const int64_t* score_offsets,
                          int32_t* scores_flat, int32_t* char_match_flat,
                          int32_t* type_match_flat, int32_t n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      vt_host_predict(hp, cps_flat + offsets[i], cts_flat + offsets[i],
                      offsets[i + 1] - offsets[i],
                      scores_flat + score_offsets[i],
                      char_match_flat + offsets[i],
                      type_match_flat + offsets[i]);
    }
  };

  vt::parallel_rows(n_lines, n_threads, 2, work);
  return 0;
}

}  // extern "C"
