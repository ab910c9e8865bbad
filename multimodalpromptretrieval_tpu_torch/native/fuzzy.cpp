// Fuzzy string matching: exact difflib.SequenceMatcher semantics.
//
// The reference scores predictions with a Python difflib scan over ALL test
// entries per prediction (dataset/VQAFeatureDataset.py:55-58 +
// main.py:296-307) — O(N * len^2) interpreted Python in the eval hot path.
// This is the native equivalent: ratio() reproduces difflib's matching-
// blocks total (including the b2j popularity/autojunk rule for b longer
// than 199 elements), and closest_index() returns the FIRST index attaining
// the maximal ratio (the reference's stable sorted(...,reverse=True)[0]).
//
// Built as a shared library; Python binds via ctypes
// (multimodalpromptretrieval_tpu_torch/native/__init__.py) with a pure-Python
// fallback when the library is unavailable.

#include <array>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Total size of matching blocks, following difflib's recursive
// find_longest_match over a queue (iterative here).
struct Matcher {
  const std::string& a;
  const std::string& b;
  std::unordered_map<char, std::vector<int>> b2j;
  std::unordered_map<char, bool> junk;  // popular elements (autojunk)

  Matcher(const std::string& a_, const std::string& b_) : a(a_), b(b_) {
    // difflib __chain_b: b2j lists of positions; autojunk drops elements
    // occurring in > 1% of b when len(b) >= 200.
    for (int i = 0; i < (int)b.size(); ++i) b2j[b[i]].push_back(i);
    if (b.size() >= 200) {
      int ntest = (int)b.size() / 100 + 1;
      for (auto it = b2j.begin(); it != b2j.end();) {
        if ((int)it->second.size() > ntest) {
          junk[it->first] = true;
          it = b2j.erase(it);
        } else {
          ++it;
        }
      }
    }
  }

  // longest match in a[alo:ahi] x b[blo:bhi]; ties resolved like difflib
  // (earliest in a, then earliest in b), junk-adjacent extension included.
  void longest(int alo, int ahi, int blo, int bhi, int* bi, int* bj,
               int* bsize) {
    int besti = alo, bestj = blo, bestsize = 0;
    std::unordered_map<int, int> j2len;
    for (int i = alo; i < ahi; ++i) {
      std::unordered_map<int, int> newj2len;
      auto it = b2j.find(a[i]);
      if (it != b2j.end()) {
        for (int j : it->second) {
          if (j < blo) continue;
          if (j >= bhi) break;
          auto prev = j2len.find(j - 1);
          int k = (prev == j2len.end() ? 0 : prev->second) + 1;
          newj2len[j] = k;
          if (k > bestsize) {
            besti = i - k + 1;
            bestj = j - k + 1;
            bestsize = k;
          }
        }
      }
      j2len.swap(newj2len);
    }
    // extend over junk-adjacent equal elements (difflib's two passes:
    // non-junk first — covered above since junk isn't in b2j — then junk)
    while (besti > alo && bestj > blo && junk.count(b[bestj - 1]) == 0 &&
           a[besti - 1] == b[bestj - 1]) {
      --besti;
      --bestj;
      ++bestsize;
    }
    while (besti + bestsize < ahi && bestj + bestsize < bhi &&
           junk.count(b[bestj + bestsize]) == 0 &&
           a[besti + bestsize] == b[bestj + bestsize]) {
      ++bestsize;
    }
    while (besti > alo && bestj > blo && junk.count(b[bestj - 1]) != 0 &&
           a[besti - 1] == b[bestj - 1]) {
      --besti;
      --bestj;
      ++bestsize;
    }
    while (besti + bestsize < ahi && bestj + bestsize < bhi &&
           junk.count(b[bestj + bestsize]) != 0 &&
           a[besti + bestsize] == b[bestj + bestsize]) {
      ++bestsize;
    }
    *bi = besti;
    *bj = bestj;
    *bsize = bestsize;
  }

  int matching_total() {
    int total = 0;
    std::vector<std::array<int, 4>> queue;
    queue.push_back({0, (int)a.size(), 0, (int)b.size()});
    while (!queue.empty()) {
      auto [alo, ahi, blo, bhi] = queue.back();
      queue.pop_back();
      int i, j, k;
      longest(alo, ahi, blo, bhi, &i, &j, &k);
      if (k) {
        total += k;
        queue.push_back({alo, i, blo, j});
        queue.push_back({i + k, ahi, j + k, bhi});
      }
    }
    return total;
  }
};

}  // namespace

extern "C" {

// difflib SequenceMatcher(None, a, b).ratio()
double mpr_ratio(const char* a, const char* b) {
  std::string sa(a), sb(b);
  if (sa.empty() && sb.empty()) return 1.0;
  Matcher m(sa, sb);
  return 2.0 * m.matching_total() / (double)(sa.size() + sb.size());
}

// index of the FIRST candidate attaining the max ratio(candidates[i], query)
// — argument order matches the reference: a = stored answer, b = query.
int32_t mpr_closest_index(const char* query, const char** candidates,
                          int32_t n) {
  double best = -1.0;
  int32_t best_i = 0;
  for (int32_t i = 0; i < n; ++i) {
    double r = mpr_ratio(candidates[i], query);
    if (r > best) {
      best = r;
      best_i = i;
    }
  }
  return best_i;
}

}  // extern "C"
