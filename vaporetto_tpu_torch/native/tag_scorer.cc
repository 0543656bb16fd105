// Native tag scorer: the full --predict-tags pass over a batch in one
// call: token-span enumeration from predicted boundaries, token-surface
// lookup (open-addressed hash over codepoint sequences), per-token score
// accumulation from the cached per-position match states, and per-slot
// argmax.
//
// The reference walks recognized tokens and, per token, sums bias +
// char-side + type-side tag weights looked up by (PMA state, relative
// position), then argmaxes per tag slot (reference predictor.rs:546-637,
// char_scorer/boundary_tag_scorer.rs:153-174, TagPredictor::predict
// predictor.rs:286-304). The round-1 Python implementation did this walk
// per token with dict lookups — this file moves the whole pass into C++
// over flat packed tables; Python keeps only the final candidate-string
// assignment.
//
// Weight tables are packed per (token_id, rel_position) group with states
// sorted inside each group, so a state lookup is one binary search (the
// reference uses SplitMix64 hash maps; sorted arrays are equivalent and
// deterministic). All arithmetic is int32 with wrapping adds, identical to
// the Python path and the reference.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct TagMatcherPack {
  int32_t n_rel = 0;
  std::vector<int64_t> grp_first;  // n_tokens * n_rel + 1
  std::vector<int32_t> states;     // sorted within each group
  std::vector<int64_t> w_off;      // per entry: offset into w_flat
  std::vector<int32_t> w_len;      // per entry
  std::vector<int32_t> w_flat;
  bool present = false;
};

struct TagScorer {
  int32_t n_tokens = 0, n_tags = 0, max_cap = 8;
  std::vector<int64_t> bias_off;  // n_tokens + 1
  std::vector<int32_t> bias_flat;
  std::vector<int64_t> cand_off;  // n_tokens + 1
  std::vector<int32_t> cand_cnt;  // flat per-slot candidate counts
  TagMatcherPack chr, typ;
  // token surface lookup: open-addressed hash over codepoint sequences
  std::vector<int32_t> tok_cps;
  std::vector<int64_t> tok_offs;  // n_tokens + 1
  std::vector<int32_t> slots;     // hash slots -> token_id or -1
  uint64_t slot_mask = 0;
  // assignment plan: per token_id, the tag-slot entries to emit. Each
  // entry resolves to a candidate-pool index: base + choice[ccol] for
  // multi-candidate slots, base for single-candidate ones (ccol = -1).
  std::vector<int64_t> ent_start;  // n_tokens + 1
  std::vector<int32_t> ent_slot, ent_base, ent_ccol;
  bool has_assign = false;
};

inline uint64_t fnv1a(const int32_t* cps, int64_t n) {
  uint64_t h = 1469598103934665603ull;
  for (int64_t i = 0; i < n; ++i) {
    h ^= static_cast<uint32_t>(cps[i]);
    h *= 1099511628211ull;
  }
  return h;
}

inline int32_t lookup_token(const TagScorer& h, const int32_t* cps,
                            int64_t n) {
  if (h.slots.empty() || n <= 0) return -1;
  uint64_t slot = fnv1a(cps, n) & h.slot_mask;
  while (true) {
    int32_t tid = h.slots[slot];
    if (tid < 0) return -1;
    int64_t lo = h.tok_offs[tid], hi = h.tok_offs[tid + 1];
    if (hi - lo == n &&
        std::memcmp(&h.tok_cps[lo], cps, sizeof(int32_t) * n) == 0)
      return tid;
    slot = (slot + 1) & h.slot_mask;
  }
}

inline void add_pack_scores(const TagMatcherPack& p, const int32_t* states,
                            int64_t n, int32_t tid, int32_t pos, int32_t cap,
                            int32_t* sc) {
  if (!p.present) return;
  for (int32_t j = 0; j < p.n_rel; ++j) {
    int64_t at = static_cast<int64_t>(pos) + j;
    if (at >= n) break;
    int32_t st = states[at];
    if (st < 0) continue;
    int64_t g = static_cast<int64_t>(tid) * p.n_rel + j;
    int64_t lo = p.grp_first[g], hi = p.grp_first[g + 1];
    while (lo < hi) {
      int64_t mid = (lo + hi) / 2;
      if (p.states[mid] < st)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < p.grp_first[g + 1] && p.states[lo] == st) {
      int32_t k = p.w_len[lo];
      if (k > cap) k = cap;
      const int32_t* w = &p.w_flat[p.w_off[lo]];
      for (int32_t i = 0; i < k; ++i)
        sc[i] = static_cast<int32_t>(static_cast<uint32_t>(sc[i]) +
                                     static_cast<uint32_t>(w[i]));
    }
  }
}

// Score one token: bias + char/type contributions into sc, then per-slot
// argmax into choice (n_tags entries; -1 where the slot is single/empty-
// candidate or beyond the token's slot count — the caller resolves those
// without scores). cs/ts point at the sentence's state streams (nullable),
// n = sentence length in chars.
inline void score_token(const TagScorer& h, int32_t tid, int32_t pos,
                        const int32_t* cs, const int32_t* ts, int64_t n,
                        int32_t* sc, int32_t* choice) {
  int64_t bl = h.bias_off[tid + 1] - h.bias_off[tid];
  int32_t cap = bl > 8 ? static_cast<int32_t>(bl) : 8;
  std::memset(sc, 0, sizeof(int32_t) * cap);
  std::memcpy(sc, &h.bias_flat[h.bias_off[tid]], sizeof(int32_t) * bl);
  if (cs) add_pack_scores(h.chr, cs, n, tid, pos, cap, sc);
  if (ts) add_pack_scores(h.typ, ts, n, tid, pos, cap, sc);
  // argmax per multi-candidate slot; strict > = first maximum wins
  // (reference predictor.rs:286-304)
  int64_t n_slots = h.cand_off[tid + 1] - h.cand_off[tid];
  if (n_slots > h.n_tags) n_slots = h.n_tags;
  int32_t offset = 0;
  for (int32_t s = 0; s < h.n_tags; ++s) choice[s] = -1;
  for (int64_t s = 0; s < n_slots; ++s) {
    int32_t cnt = h.cand_cnt[h.cand_off[tid] + s];
    if (cnt >= 2) {
      int32_t idx = 0;
      int32_t best = sc[offset];
      for (int32_t i = 1; i < cnt; ++i) {
        if (sc[offset + i] > best) {
          best = sc[offset + i];
          idx = i;
        }
      }
      choice[s] = idx;
      offset += cnt;
    }
  }
}

}  // namespace

extern "C" {

void* vt_tag_new(int32_t n_tokens, int32_t n_tags, int32_t max_cap,
                 const int64_t* bias_off, const int32_t* bias_flat,
                 const int64_t* cand_off, const int32_t* cand_cnt) {
  auto* h = new TagScorer();
  h->n_tokens = n_tokens;
  h->n_tags = n_tags;
  h->max_cap = max_cap < 8 ? 8 : max_cap;
  h->bias_off.assign(bias_off, bias_off + n_tokens + 1);
  h->bias_flat.assign(bias_flat, bias_flat + bias_off[n_tokens]);
  h->cand_off.assign(cand_off, cand_off + n_tokens + 1);
  h->cand_cnt.assign(cand_cnt, cand_cnt + cand_off[n_tokens]);
  return h;
}

void vt_tag_free(void* hp) { delete static_cast<TagScorer*>(hp); }

int vt_tag_set_matcher(void* hp, int32_t which, int32_t n_rel,
                       const int64_t* grp_first, const int32_t* states,
                       const int64_t* w_off, const int32_t* w_len,
                       int64_t n_entries, const int32_t* w_flat,
                       int64_t flat_len) {
  auto* h = static_cast<TagScorer*>(hp);
  TagMatcherPack& p = which == 0 ? h->chr : h->typ;
  p.n_rel = n_rel;
  int64_t n_groups = static_cast<int64_t>(h->n_tokens) * n_rel;
  p.grp_first.assign(grp_first, grp_first + n_groups + 1);
  p.states.assign(states, states + n_entries);
  p.w_off.assign(w_off, w_off + n_entries);
  p.w_len.assign(w_len, w_len + n_entries);
  p.w_flat.assign(w_flat, w_flat + flat_len);
  p.present = true;
  return 0;
}

// Register token surfaces (codepoint sequences, token_id order) and build
// the lookup hash. tok_offs: n_tokens + 1 prefix offsets into tok_cps.
int vt_tag_set_tokens(void* hp, const int32_t* tok_cps,
                      const int64_t* tok_offs) {
  auto* h = static_cast<TagScorer*>(hp);
  h->tok_offs.assign(tok_offs, tok_offs + h->n_tokens + 1);
  h->tok_cps.assign(tok_cps, tok_cps + tok_offs[h->n_tokens]);
  uint64_t cap = 8;
  while (cap < static_cast<uint64_t>(h->n_tokens) * 2) cap <<= 1;
  h->slots.assign(cap, -1);
  h->slot_mask = cap - 1;
  for (int32_t tid = 0; tid < h->n_tokens; ++tid) {
    int64_t lo = h->tok_offs[tid], n = h->tok_offs[tid + 1] - lo;
    uint64_t slot = fnv1a(&h->tok_cps[lo], n) & h->slot_mask;
    while (h->slots[slot] >= 0) slot = (slot + 1) & h->slot_mask;
    h->slots[slot] = tid;
  }
  return 0;
}

// Register the tag-slot assignment plan (see TagScorer::ent_*).
int vt_tag_set_assign(void* hp, const int64_t* ent_start,
                      const int32_t* ent_slot, const int32_t* ent_base,
                      const int32_t* ent_ccol) {
  auto* h = static_cast<TagScorer*>(hp);
  h->ent_start.assign(ent_start, ent_start + h->n_tokens + 1);
  int64_t n = ent_start[h->n_tokens];
  h->ent_slot.assign(ent_slot, ent_slot + n);
  h->ent_base.assign(ent_base, ent_base + n);
  h->ent_ccol.assign(ent_ccol, ent_ccol + n);
  h->has_assign = true;
  return 0;
}

// Full tag pass over a batch: for each sentence, enumerate token spans
// from the boundary labels, look up each span's surface, and score+argmax
// every recognized token.
//
//   cps / char_states / type_states: flattened per-sentence streams;
//   sentence i occupies [sent_off[i], sent_off[i+1]). State streams may be
//   nullptr when the corresponding side is absent. bnds holds the n-1 gap
//   labels (0=NotWordBoundary, 1=WordBoundary, 2=Unknown) per sentence,
//   packed contiguously: sentence i's labels start at sent_off[i] - i.
//
//   Span semantics mirror the reference gap walk (predictor.rs:546-571):
//   spans between consecutive break gaps (label != 0), emitted only when
//   neither delimiting break is Unknown.
//
//   Outputs (capacity >= total chars; at most one token per char):
//   out_tid/out_pos/out_sent per recognized token (pos = end - 1), choices
//   n_tok * n_tags, scores (optional, want_scores) n_tok * max_cap.
//   When an assignment plan is set (vt_tag_set_assign), also emits one
//   (out_gpos, out_pool) pair per resolved tag slot — global flat tag
//   position (char_index * n_tags + slot) and candidate-pool index — with
//   capacity total_chars * n_tags; *n_entries_out receives the count.
//   Returns the number of recognized tokens.
int64_t vt_tag_predict_batch(void* hp, const int32_t* cps,
                             const uint8_t* bnds, const int64_t* sent_off,
                             int64_t n_sents, const int32_t* char_states,
                             const int32_t* type_states, int32_t* out_tid,
                             int32_t* out_pos, int32_t* out_sent,
                             int32_t* out_choice, int32_t* out_scores,
                             int64_t* out_gpos, int32_t* out_pool,
                             int64_t* n_entries_out, int32_t want_scores,
                             int32_t n_threads) {
  auto* h = static_cast<TagScorer*>(hp);
  const int32_t n_tags = h->n_tags;
  const int32_t cap = h->max_cap;
  const bool assign = h->has_assign && out_gpos && out_pool;
  std::vector<int64_t> counts(n_sents, 0), ent_counts(n_sents, 0);
  auto work = [&](int64_t lo_s, int64_t hi_s) {
    std::vector<int32_t> sc(cap);
    for (int64_t si = lo_s; si < hi_s; ++si) {
      int64_t base = sent_off[si];
      int64_t n = sent_off[si + 1] - base;
      const int32_t* scps = cps + base;
      const uint8_t* sb = bnds + base - si;
      const int32_t* cs = char_states ? char_states + base : nullptr;
      const int32_t* ts = type_states ? type_states + base : nullptr;
      int64_t w = base;  // per-sentence output region [base, base + n)
      int64_t we = base * n_tags;  // entry region [base*n_tags, ...)
      int64_t start = 0;
      bool prev_unk = false;
      auto emit = [&](int64_t s, int64_t e) {
        int32_t tid = lookup_token(*h, scps + s, e - s);
        if (tid < 0) return;
        int32_t pos = static_cast<int32_t>(e - 1);
        out_tid[w] = tid;
        out_pos[w] = pos;
        out_sent[w] = static_cast<int32_t>(si);
        int32_t* choice = out_choice + w * n_tags;
        score_token(*h, tid, pos, cs, ts, n,
                    want_scores ? out_scores + w * cap : sc.data(), choice);
        if (assign) {
          int64_t gchar = base + pos;
          for (int64_t ei = h->ent_start[tid]; ei < h->ent_start[tid + 1];
               ++ei) {
            int32_t ccol = h->ent_ccol[ei];
            out_pool[we] =
                h->ent_base[ei] + (ccol >= 0 ? choice[ccol] : 0);
            out_gpos[we] = gchar * n_tags + h->ent_slot[ei];
            ++we;
          }
        }
        ++w;
      };
      for (int64_t i = 0; i < n - 1; ++i) {
        uint8_t v = sb[i];
        if (v) {
          if (!prev_unk && v == 1) emit(start, i + 1);
          prev_unk = v == 2;
          start = i + 1;
        }
      }
      if (!prev_unk && n > 0) emit(start, n);
      counts[si] = w - base;
      ent_counts[si] = we - base * n_tags;
    }
  };
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > n_sents) n_threads = static_cast<int32_t>(n_sents);
  if (n_threads <= 1 || n_sents < 64) {
    work(0, n_sents);
  } else {
    std::vector<std::thread> threads;
    int64_t per = (n_sents + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
      int64_t lo = t * per;
      int64_t hi = lo + per < n_sents ? lo + per : n_sents;
      if (lo >= hi) break;
      threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  // compact the per-sentence regions in order (w only moves forward past
  // already-consumed slots, so in-place forward copies are safe)
  int64_t w = 0, we = 0;
  for (int64_t si = 0; si < n_sents; ++si) {
    int64_t r = sent_off[si];
    int64_t c = counts[si];
    if (w != r && c) {
      std::memmove(out_tid + w, out_tid + r, sizeof(int32_t) * c);
      std::memmove(out_pos + w, out_pos + r, sizeof(int32_t) * c);
      std::memmove(out_sent + w, out_sent + r, sizeof(int32_t) * c);
      std::memmove(out_choice + w * n_tags, out_choice + r * n_tags,
                   sizeof(int32_t) * c * n_tags);
      if (want_scores)
        std::memmove(out_scores + w * cap, out_scores + r * cap,
                     sizeof(int32_t) * c * cap);
    }
    w += c;
    if (assign) {
      int64_t re = r * n_tags;
      int64_t ce = ent_counts[si];
      if (we != re && ce) {
        std::memmove(out_gpos + we, out_gpos + re, sizeof(int64_t) * ce);
        std::memmove(out_pool + we, out_pool + re, sizeof(int32_t) * ce);
      }
      we += ce;
    }
  }
  if (n_entries_out) *n_entries_out = we;
  return w;
}

}  // extern "C"
