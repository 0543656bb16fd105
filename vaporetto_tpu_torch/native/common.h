// Shared helpers for the native host components.
#ifndef VAPORETTO_NATIVE_COMMON_H_
#define VAPORETTO_NATIVE_COMMON_H_

#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace vt {

// Reference CharacterType::get_type Unicode ranges (sentence.rs:50-67) —
// the ONE definition shared by the tensorizer and the host serve path
// (and mirrored by Python's _CHAR_TYPE_TABLE_SMALL, pinned equal by
// tests/test_sentence.py's char-type table cases).
inline uint8_t char_type(uint32_t c) {
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

// Worker threads parallel_rows has started in this process (one library,
// one counter: an inline variable has one definition across the sources;
// read through vt_threads_started).
inline std::atomic<int64_t> threads_started{0};

// Run fn(lo, hi) over [0, n) split across worker threads. n_threads <= 0
// picks hardware concurrency; small inputs run inline. The one fan-out
// loop every batched native entry point shares.
template <typename Fn>
inline void parallel_rows(int64_t n, int32_t n_threads, int64_t min_rows,
                          Fn&& fn) {
  if (n_threads <= 0) {
    n_threads = static_cast<int32_t>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > 16) n_threads = 16;
  if (n_threads > n) n_threads = static_cast<int32_t>(n);
  if (n_threads <= 1 || n < min_rows) {
    fn(static_cast<int64_t>(0), n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = lo + per < n ? lo + per : n;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  threads_started.fetch_add(static_cast<int64_t>(threads.size()),
                            std::memory_order_relaxed);
  for (auto& th : threads) th.join();
}

}  // namespace vt

#endif  // VAPORETTO_NATIVE_COMMON_H_
