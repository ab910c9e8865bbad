// CLIP BPE encoder — the serving host-path hot spot.
//
// Role parity: openai/CLIP SimpleTokenizer.encode (the reference calls
// clip.tokenize on every retrieval query, dataset/VQAFeatureDataset.py:147).
// The Python port (text/clip_bpe.py) is the semantic reference; this is the
// fast path for ASCII inputs (the medical-VQA corpora are ASCII), measured
// at ~190 us/question in Python — the single largest host cost in the
// steady-state serve profile of the JAX package.
//
// Exactness contract with text/clip_bpe.py:
//   * any input containing a non-ASCII byte or '&' (html.unescape could
//     rewrite it) is REJECTED (returns -1) and the caller falls back to
//     the Python path — never approximate;
//   * for accepted inputs: lowercase, \s+ -> ' ' collapse + strip, the
//     CLIP word regex (contractions / letter runs / single digit /
//     punctuation runs — ASCII semantics match the unicode classes),
//     byte-to-unicode is the identity on printable ASCII, then the same
//     lowest-rank-first merge loop with a per-word memo.
//
// tests/test_native.py checks C++ == Python on every path incl. fallback.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct BPE {
  std::unordered_map<std::string, int32_t> encoder;
  std::unordered_map<std::string, int32_t> ranks;  // "first\x01second"
  std::unordered_map<std::string, std::vector<int32_t>> memo;
};

inline bool is_ws(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}
inline bool is_letter(unsigned char c) { return c >= 'a' && c <= 'z'; }
inline bool is_digit(unsigned char c) { return c >= '0' && c <= '9'; }

const char* kContractions[] = {"'s", "'t", "'re", "'ve", "'m", "'ll", "'d"};

// lowest-rank merge loop over the word's symbol list (SimpleTokenizer.bpe)
void bpe_word(BPE* h, const std::string& token,
              std::vector<int32_t>* out) {
  auto it = h->memo.find(token);
  if (it != h->memo.end()) {
    out->insert(out->end(), it->second.begin(), it->second.end());
    return;
  }
  std::vector<std::string> word;
  for (size_t i = 0; i + 1 < token.size(); ++i)
    word.emplace_back(1, token[i]);
  word.push_back(std::string(1, token.back()) + "</w>");

  while (word.size() > 1) {
    int32_t best = INT32_MAX;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < word.size(); ++i) {
      auto r = h->ranks.find(word[i] + '\x01' + word[i + 1]);
      if (r != h->ranks.end() && r->second < best) {
        best = r->second;
        best_i = i;
      }
    }
    if (best == INT32_MAX) break;
    const std::string first = word[best_i], second = word[best_i + 1];
    std::vector<std::string> merged;
    size_t i = 0;
    while (i < word.size()) {
      if (i + 1 < word.size() && word[i] == first && word[i + 1] == second) {
        merged.push_back(first + second);
        i += 2;
      } else {
        merged.push_back(word[i]);
        i += 1;
      }
    }
    word.swap(merged);
  }
  std::vector<int32_t> ids;
  ids.reserve(word.size());
  for (const auto& w : word) {
    auto e = h->encoder.find(w);
    if (e == h->encoder.end()) {
      // unknown symbol: cannot happen with the real vocab (every byte and
      // byte</w> is present) but guard for toy vocabs — caller falls back
      h->memo.emplace(token, std::vector<int32_t>());
      return;  // empty marks failure; caller checks
    }
    ids.push_back(e->second);
  }
  h->memo.emplace(token, ids);
  out->insert(out->end(), ids.begin(), ids.end());
}

}  // namespace

extern "C" {

void* mpr_bpe_create(const char* vocab_blob, const int32_t* vocab_off,
                     int32_t n_vocab, const char* merge_blob,
                     const int32_t* merge_off, int32_t n_merges) {
  BPE* h = new BPE();
  // assignment, not emplace: Python dict comprehensions are last-wins on
  // duplicate keys and the id tables must match exactly
  h->encoder.reserve(n_vocab * 2);
  for (int32_t i = 0; i < n_vocab; ++i)
    h->encoder[std::string(vocab_blob + vocab_off[i],
                           vocab_off[i + 1] - vocab_off[i])] = i;
  h->ranks.reserve(n_merges * 2);
  for (int32_t i = 0; i < n_merges; ++i)
    h->ranks[std::string(merge_blob + merge_off[i],
                         merge_off[i + 1] - merge_off[i])] = i;
  return h;
}

void mpr_bpe_free(void* handle) { delete static_cast<BPE*>(handle); }

// Returns the id count, or -1 when the input needs the Python fallback
// (non-ASCII, '&', a special-token literal, or a toy-vocab miss).
static int32_t bpe_encode_span(BPE* h, const char* text, int32_t n_bytes,
                               int32_t* out, int32_t cap);

int32_t mpr_bpe_encode(void* handle, const char* text, int32_t* out,
                       int32_t cap) {
  return bpe_encode_span(static_cast<BPE*>(handle), text,
                         (int32_t)strlen(text), out, cap);
}

// Batch entry (see mpr_spm_encode_batch): n strings -> row-major (n, cap)
// int32 matrix + per-row counts; lens[i] == -1 marks a row that needs the
// exact Python fallback (the caller re-encodes just those rows).
void mpr_bpe_encode_batch(void* handle, const char* texts,
                          const int32_t* offsets, int32_t n, int32_t* out,
                          int32_t* lens, int32_t cap) {
  BPE* h = static_cast<BPE*>(handle);
  for (int32_t i = 0; i < n; ++i)
    lens[i] = bpe_encode_span(h, texts + offsets[i],
                              offsets[i + 1] - offsets[i],
                              out + (int64_t)i * cap, cap);
}

static int32_t bpe_encode_span(BPE* h, const char* text, int32_t n_bytes,
                               int32_t* out, int32_t cap) {
  // reject anything the ASCII fast path cannot reproduce exactly
  std::string s;
  s.reserve(n_bytes);
  for (const unsigned char* p = (const unsigned char*)text,
                          * e = p + n_bytes; p < e; ++p) {
    if (*p >= 128 || *p == '&' || *p == 0) return -1;
    s.push_back((char)std::tolower(*p));
  }
  if (s.find("<|") != std::string::npos) return -1;  // special literals
  // whitespace clean: \s+ -> ' ', strip
  std::string t;
  t.reserve(s.size());
  for (size_t i = 0; i < s.size(); ++i) {
    if (is_ws(s[i])) {
      if (!t.empty() && t.back() != ' ') t.push_back(' ');
    } else {
      t.push_back(s[i]);
    }
  }
  while (!t.empty() && t.back() == ' ') t.pop_back();

  std::vector<int32_t> ids;
  size_t i = 0;
  const size_t n = t.size();
  while (i < n) {
    if (t[i] == ' ') {
      ++i;
      continue;
    }
    size_t start = i;
    if (t[i] == '\'') {
      // contraction alternatives, longest patterns listed explicitly in
      // the CLIP regex order ('s|'t|'re|'ve|'m|'ll|'d)
      bool matched = false;
      for (const char* c : kContractions) {
        size_t len = std::strlen(c);
        if (t.compare(i, len, c) == 0) {
          // regex alternation: a following letter would extend [\p{L}]+
          // differently? No — the contraction branch matches first and
          // the scan resumes after it (same as Python re.findall).
          i += len;
          matched = true;
          break;
        }
      }
      if (!matched) {
        // punctuation run: chars that are not ws/letter/digit
        while (i < n && !is_ws(t[i]) && !is_letter(t[i]) && !is_digit(t[i]))
          ++i;
      }
    } else if (is_letter(t[i])) {
      while (i < n && is_letter(t[i])) ++i;
    } else if (is_digit(t[i])) {
      ++i;  // [\p{N}] matches ONE digit
    } else {
      while (i < n && !is_ws(t[i]) && !is_letter(t[i]) && !is_digit(t[i]))
        ++i;
    }
    std::string token = t.substr(start, i - start);
    size_t before = ids.size();
    bpe_word(h, token, &ids);
    if (ids.size() == before) {
      auto m = h->memo.find(token);
      if (m != h->memo.end() && m->second.empty()) return -1;  // vocab miss
    }
  }
  if ((int32_t)ids.size() > cap) return -1;
  std::memcpy(out, ids.data(), ids.size() * sizeof(int32_t));
  return (int32_t)ids.size();
}

}  // extern "C"
