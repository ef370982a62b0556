// Native host-side LMS + induced k-ordered suffix sorter for kiss-tpu.
//
// This is the one reference core algorithm whose work-reduction shape
// (sort only the ~n/3 LMS suffixes, induce the rest with two bucket
// scans) is not expressed as device dataflow: the induced passes are
// per-position sequential chains and the key extraction is
// random-index gathers (an on-device version is not measured on the
// H100; ROADMAP queue 1 item 9). The reference runs
// it as host C++ (reference: include/biovoltron/algo/sort/
// kiss_common.hpp:40-579 get_lms/put_lms_suffix/induced_sort,
// kiss1_core.hpp:23-145 LMS direct k-ordered sort); here it is likewise
// a native HOST strategy (`-s LMS_INDUCED`), complementing the
// on-device PARALLEL_SORTING / PREFIX_DOUBLING strategies -- written
// from the classic SA-IS induction scheme, not translated from the
// reference.
//
// Ordering contract (the reference's own, weaker than the device
// strategies'): suffixes grouped and ordered by their first k
// characters, a suffix ending inside the window sorting first; the
// order WITHIN an equal-k-prefix tie group is unspecified (the
// reference's two strategies disagree there too -- conformance is
// tie-group-level, tests/test_golden.py). With k = -1 the output is the
// unique fully sorted suffix array, bit-identical to every other
// strategy. SA[0] = n (empty suffix) always.
//
// Build: make -C csrc   (part of build/libkiss_io.so)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#include <parallel/algorithm>
#endif

namespace {

constexpr uint8_t kL = 0;
constexpr uint8_t kS = 1;

// Sort the LMS positions by the first-k-characters contract above.
// Positions tie-break the comparator so the result is deterministic;
// that determinism is an implementation detail, not part of the
// contract (see header note).
void sort_lms(std::vector<int64_t>& lms, const uint8_t* c, int64_t n,
              int64_t k) {
  auto cmp = [c, n, k](int64_t a, int64_t b) {
    int64_t la = n - a, lb = n - b;
    int64_t lim = la < lb ? la : lb;
    if (k >= 0 && k < lim) lim = k;
    int r = memcmp(c + a, c + b, static_cast<size_t>(lim));
    if (r != 0) return r < 0;
    if (k >= 0 && lim == k) return a < b;  // both reach k: tie
    if (la != lb) return la < lb;          // ends-inside sorts first
    return a < b;
  };
#if defined(_OPENMP)
  __gnu_parallel::sort(lms.begin(), lms.end(), cmp);
#else
  std::sort(lms.begin(), lms.end(), cmp);
#endif
}

}  // namespace

extern "C" {

// OpenMP thread cap for the LMS sort stage (the reference's -t knob,
// reference: src/main.cpp:22-26). No-op when built without OpenMP.
void ki_set_threads(int n) {
#if defined(_OPENMP)
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

// text: n codes (any byte alphabet, compared as unsigned).
// k: sort depth; -1 = unbounded (full suffix array).
// sa: caller-allocated n+1 slots, filled with the k-ordered SA.
// Returns 0 on success, -1 on invalid arguments.
int ki_lms_induced_sort(const int8_t* text, int64_t n, int64_t k,
                        int64_t* sa) {
  if (n < 0 || (k != -1 && k < 1)) return -1;
  const uint8_t* c = reinterpret_cast<const uint8_t*>(text);
  if (n == 0) {
    sa[0] = 0;
    return 0;
  }

  // Suffix types, right to left. The empty suffix (position n) is
  // S-type and smaller than everything; position n-1 is therefore L.
  std::vector<uint8_t> t(static_cast<size_t>(n) + 1);
  t[n] = kS;
  t[n - 1] = kL;
  for (int64_t i = n - 2; i >= 0; --i)
    t[i] = (c[i] < c[i + 1] || (c[i] == c[i + 1] && t[i + 1] == kS)) ? kS
                                                                     : kL;

  // LMS positions (S preceded by L). Position n always qualifies but is
  // the sentinel, placed directly at sa[0] below.
  std::vector<int64_t> lms;
  lms.reserve(static_cast<size_t>(n) / 3 + 1);
  for (int64_t i = 1; i < n; ++i)
    if (t[i] == kS && t[i - 1] == kL) lms.push_back(i);

  sort_lms(lms, c, n, k);

  // Character buckets over sa[1..n]; slot 0 is the sentinel's.
  int64_t cnt[256] = {0};
  for (int64_t i = 0; i < n; ++i) ++cnt[c[i]];
  int64_t head[256], tail[256];
  {
    int64_t acc = 1;
    for (int i = 0; i < 256; ++i) {
      head[i] = acc;
      acc += cnt[i];
      tail[i] = acc - 1;
    }
  }

  std::fill(sa, sa + n + 1, int64_t{-1});
  sa[0] = n;

  // Seed: sorted LMS at their bucket tails (reverse order so the
  // largest lands deepest).
  for (size_t i = lms.size(); i-- > 0;) {
    int64_t p = lms[i];
    sa[tail[c[p]]--] = p;
  }

  // Induce L-types, left to right: each placed suffix j says where
  // c[j-1] + suffix(j) belongs when j-1 is L.
  for (int64_t i = 0; i <= n; ++i) {
    int64_t j = sa[i];
    if (j > 0 && t[j - 1] == kL) sa[head[c[j - 1]]++] = j - 1;
  }

  // Induce S-types, right to left, overwriting the seeded LMS entries
  // with their induced (final) placements.
  {
    int64_t acc = 1;
    for (int i = 0; i < 256; ++i) {
      acc += cnt[i];
      tail[i] = acc - 1;
    }
  }
  for (int64_t i = n; i >= 0; --i) {
    int64_t j = sa[i];
    if (j > 0 && t[j - 1] == kS) sa[tail[c[j - 1]]--] = j - 1;
  }

  return 0;
}

}  // extern "C"
