// Boundary-feature extractor — native trainer front end.
//
// Replicates the reference trainer's per-gap feature generation
// (trainer.rs:260-318) and feature-id interning (trainer.rs:320-339) in
// C++: char/type n-grams within the +-window tagged with rel_position,
// dictionary L/I/R x capped-length features from overlapping dictionary
// matches, and per-example (id, count) sparse vectors. The trainer
// (train/trainer.py) uses this unless VAPORETTO_TPU_PY_EXTRACTOR=1 picks
// its pure-Python extractor, and decodes the exported feature keys for
// model assembly.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Feature keys are byte blobs:
//   0x01 | n*int32 codepoints | int32 rel   (char n-gram)
//   0x02 | n*uint8 types      | int32 rel   (type n-gram)
//   0x03/0x04/0x05 | int32 len             (dict left/inside/right)
struct BlobHash {
  size_t operator()(const std::string& s) const {
    size_t h = 1469598103934665603ull;
    for (unsigned char c : s) {
      h ^= c;
      h *= 1099511628211ull;
    }
    return h;
  }
};

// Aho-Corasick automaton over the dictionary (reference builds one and
// scans training text with overlapping matches, trainer.rs:227,296-317).
// O(n + matches) per sentence vs the previous hash-set substring probe's
// O(n * max_word_len) — the asymptotics that matter for long-word
// dictionaries.
struct DictAC {
  std::vector<std::unordered_map<char32_t, int32_t>> next{1};
  std::vector<int32_t> fail{0};
  std::vector<int32_t> out_len{0};   // word length ending here (0 = none)
  std::vector<int32_t> out_link{0};  // nearest terminal suffix node

  void insert(const std::u32string& w) {
    int32_t s = 0;
    for (char32_t c : w) {
      auto it = next[s].find(c);
      if (it == next[s].end()) {
        int32_t v = static_cast<int32_t>(next.size());
        next[s][c] = v;
        next.emplace_back();
        fail.push_back(0);
        out_len.push_back(0);
        out_link.push_back(0);
        s = v;
      } else {
        s = it->second;
      }
    }
    out_len[s] = static_cast<int32_t>(w.size());
  }

  void build() {
    std::vector<int32_t> queue;
    for (auto& kv : next[0]) queue.push_back(kv.second);
    for (size_t qi = 0; qi < queue.size(); ++qi) {
      int32_t u = queue[qi];
      for (auto& kv : next[u]) {
        char32_t c = kv.first;
        int32_t v = kv.second;
        int32_t f = fail[u];
        while (f && !next[f].count(c)) f = fail[f];
        auto it = next[f].find(c);
        fail[v] = (it != next[f].end() && it->second != v) ? it->second : 0;
        out_link[v] =
            out_len[fail[v]] ? fail[v] : out_link[fail[v]];
        queue.push_back(v);
      }
    }
  }

  int32_t step(int32_t s, char32_t c) const {
    while (true) {
      auto it = next[s].find(c);
      if (it != next[s].end()) return it->second;
      if (s == 0) return 0;
      s = fail[s];
    }
  }
};

struct Extractor {
  int charw, charn, typew, typen, dictn;
  DictAC dict_ac;
  bool has_dict = false;
  std::unordered_map<std::string, uint32_t, BlobHash> feature_ids;
  std::vector<std::string> keys_in_order;
  // examples: flattened (fid, count) pairs + offsets + labels
  std::vector<uint32_t> ex_fids;
  std::vector<float> ex_counts;
  std::vector<int64_t> ex_offsets{0};
  std::vector<int32_t> ex_labels;
  int64_t max_nnz = 0;

  // lookup by const ref: the key buffer is reused by the caller and
  // only copied on first insertion
  uint32_t intern(const std::string& key) {
    auto it = feature_ids.find(key);
    if (it != feature_ids.end()) return it->second;
    uint32_t id = static_cast<uint32_t>(feature_ids.size() + 1);
    keys_in_order.push_back(key);
    feature_ids.emplace(key, id);
    return id;
  }
};

inline void push_i32(std::string& s, int32_t v) {
  s.append(reinterpret_cast<const char*>(&v), 4);
}

}  // namespace

extern "C" {

void* vt_extr_new(int charw, int charn, int typew, int typen, int dictn,
                  const int32_t* dict_data, const int64_t* dict_offsets,
                  int64_t n_words) {
  auto* e = new Extractor();
  e->charw = charw;
  e->charn = charn;
  e->typew = typew;
  e->typen = typen;
  e->dictn = dictn;
  for (int64_t i = 0; i < n_words; ++i) {
    std::u32string w;
    for (int64_t j = dict_offsets[i]; j < dict_offsets[i + 1]; ++j) {
      w.push_back(static_cast<char32_t>(dict_data[j]));
    }
    if (!w.empty()) {
      e->dict_ac.insert(w);
      e->has_dict = true;
    }
  }
  if (e->has_dict) e->dict_ac.build();
  return e;
}

int vt_extr_add(void* h, const int32_t* cps, const uint8_t* types,
                const uint8_t* bounds, int64_t n) {
  auto* e = static_cast<Extractor*>(h);
  if (n < 2) return 0;
  int64_t n_gaps = n - 1;
  // per-gap (feature-id -> count) accumulators
  std::vector<std::unordered_map<uint32_t, float>> gap_feats(n_gaps);
  std::string key;
  for (int64_t i = 0; i < n_gaps; ++i) {
    auto& fv = gap_feats[i];
    // char n-grams (trainer.rs:268-279)
    for (int ng = 0; ng < e->charn; ++ng) {
      int64_t lo = std::max<int64_t>(i + 1 - e->charw, 0);
      int64_t hi = std::max<int64_t>(
          std::min<int64_t>(i + 1 + e->charw, n) - ng, 0);
      for (int64_t j = lo; j < hi; ++j) {
        key.clear();
        key.push_back(0x01);
        for (int m = 0; m <= ng; ++m) push_i32(key, cps[j + m]);
        push_i32(key, static_cast<int32_t>(j - i - 1));
        fv[e->intern(key)] += 1.0f;
      }
    }
    // type n-grams (trainer.rs:281-292)
    for (int ng = 0; ng < e->typen; ++ng) {
      int64_t lo = std::max<int64_t>(i + 1 - e->typew, 0);
      int64_t hi = std::max<int64_t>(
          std::min<int64_t>(i + 1 + e->typew, n) - ng, 0);
      for (int64_t j = lo; j < hi; ++j) {
        key.clear();
        key.push_back(0x02);
        for (int m = 0; m <= ng; ++m) key.push_back((char)types[j + m]);
        push_i32(key, static_cast<int32_t>(j - i - 1));
        fv[e->intern(key)] += 1.0f;
      }
    }
  }
  // dictionary features from overlapping AC matches (trainer.rs:296-317)
  if (e->has_dict) {
    const DictAC& ac = e->dict_ac;
    int32_t state = 0;
    for (int64_t pos = 0; pos < n; ++pos) {
      state = ac.step(state, static_cast<char32_t>(cps[pos]));
      int64_t end = pos + 1;
      for (int32_t t = ac.out_len[state] ? state : ac.out_link[state];
           t; t = ac.out_link[t]) {
        int64_t k = ac.out_len[t];
        int64_t start = end - k;
        int len = static_cast<int>(std::min<int64_t>(k, e->dictn));
        if (start != 0) {
          key.clear();
          key.push_back(0x03);
          push_i32(key, len);
          gap_feats[start - 1][e->intern(key)] += 1.0f;
        }
        for (int64_t g = start; g < end - 1; ++g) {
          key.clear();
          key.push_back(0x04);
          push_i32(key, len);
          gap_feats[g][e->intern(key)] += 1.0f;
        }
        if (end != n) {
          key.clear();
          key.push_back(0x05);
          push_i32(key, len);
          gap_feats[end - 1][e->intern(key)] += 1.0f;
        }
      }
    }
  }
  // flush examples in gap order with labels
  for (int64_t i = 0; i < n_gaps; ++i) {
    auto& fv = gap_feats[i];
    // deterministic order within an example (sorted by fid)
    std::vector<std::pair<uint32_t, float>> items(fv.begin(), fv.end());
    std::sort(items.begin(), items.end());
    for (auto& kv : items) {
      e->ex_fids.push_back(kv.first);
      e->ex_counts.push_back(kv.second);
    }
    e->ex_offsets.push_back(static_cast<int64_t>(e->ex_fids.size()));
    e->max_nnz = std::max<int64_t>(e->max_nnz, (int64_t)items.size());
    e->ex_labels.push_back(bounds[i]);
  }
  return 0;
}

int64_t vt_extr_n_features(void* h) {
  return static_cast<Extractor*>(h)->feature_ids.size();
}
int64_t vt_extr_n_examples(void* h) {
  return static_cast<Extractor*>(h)->ex_labels.size();
}
int64_t vt_extr_max_nnz(void* h) {
  return static_cast<Extractor*>(h)->max_nnz;
}

// Export padded (n_examples, K) idx/val and labels.
int vt_extr_export(void* h, int64_t K, int32_t* idx, float* val,
                   int32_t* y) {
  auto* e = static_cast<Extractor*>(h);
  int64_t n = e->ex_labels.size();
  for (int64_t r = 0; r < n; ++r) {
    int64_t b = e->ex_offsets[r], len = e->ex_offsets[r + 1] - b;
    if (len > K) return 1;
    for (int64_t c = 0; c < len; ++c) {
      idx[r * K + c] = static_cast<int32_t>(e->ex_fids[b + c]);
      val[r * K + c] = e->ex_counts[b + c];
    }
    for (int64_t c = len; c < K; ++c) {
      idx[r * K + c] = 0;
      val[r * K + c] = 0.0f;
    }
    y[r] = e->ex_labels[r];
  }
  return 0;
}

// Feature-key blobs, concatenated in id order (id = index + 1).
int64_t vt_extr_keys_size(void* h) {
  auto* e = static_cast<Extractor*>(h);
  int64_t total = 0;
  for (auto& k : e->keys_in_order) total += (int64_t)k.size();
  return total;
}

void vt_extr_export_keys(void* h, uint8_t* blob, int64_t* offsets) {
  auto* e = static_cast<Extractor*>(h);
  int64_t pos = 0;
  int64_t i = 0;
  offsets[0] = 0;
  for (auto& k : e->keys_in_order) {
    memcpy(blob + pos, k.data(), k.size());
    pos += (int64_t)k.size();
    offsets[++i] = pos;
  }
}

void vt_extr_free(void* h) { delete static_cast<Extractor*>(h); }

}  // extern "C"
