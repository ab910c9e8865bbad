// Unigram-LM Viterbi tokenizer encoder (sentencepiece's C++ role).
//
// The reference tokenizes through HF T5Tokenizer -> the sentencepiece C++
// library (architectures/T5VisionModel.py:57,161-167). Our Python Viterbi
// (text/spm.py) is the reference implementation; this native encoder is the
// production path for corpus-scale tokenization: a byte-trie over the
// piece table + Viterbi DP over character starts, bit-identical output to
// text/spm.viterbi_encode (tests/test_native.py cross-checks).
//
// C API (ctypes-friendly): create a model from flat piece arrays, encode
// UTF-8 strings into int32 ids.

#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <string>
#include <vector>

namespace {

constexpr int kPieceNormal = 1;
constexpr int kPieceUnknown = 2;

struct TrieNode {
  // byte-indexed children; sparse via sorted vector (pieces are short)
  std::vector<std::pair<uint8_t, std::unique_ptr<TrieNode>>> kids;
  int32_t piece_id = -1;

  TrieNode* child(uint8_t c) const {
    for (auto& kv : kids)
      if (kv.first == c) return kv.second.get();
    return nullptr;
  }
  TrieNode* ensure(uint8_t c) {
    for (auto& kv : kids)
      if (kv.first == c) return kv.second.get();
    kids.emplace_back(c, std::make_unique<TrieNode>());
    return kids.back().second.get();
  }
};

struct Model {
  TrieNode root;
  std::vector<float> scores;
  int32_t unk_id = 2;
  float unk_score = -22.0f;
};

inline bool is_char_start(uint8_t b) { return (b & 0xC0) != 0x80; }

}  // namespace

extern "C" {

// pieces: concatenated UTF-8 piece strings; offsets: n+1 byte offsets;
// scores: per-piece log-probs; types: sentencepiece piece types.
void* mpr_spm_create(const char* pieces, const int32_t* offsets,
                     const float* scores, const int32_t* types, int32_t n,
                     float unk_penalty) {
  auto* m = new Model();
  m->scores.assign(scores, scores + n);
  float min_normal = std::numeric_limits<float>::max();
  bool any_normal = false;
  for (int32_t i = 0; i < n; ++i) {
    if (types[i] == kPieceUnknown) m->unk_id = i;
    if (types[i] == kPieceNormal) {
      any_normal = true;
      if (scores[i] < min_normal) min_normal = scores[i];
    }
    // control/unknown/unused pieces are not matchable (spm.py trie rule)
    if (types[i] == kPieceUnknown || types[i] == 3 || types[i] == 5)
      continue;
    TrieNode* node = &m->root;
    for (int32_t p = offsets[i]; p < offsets[i + 1]; ++p)
      node = node->ensure((uint8_t)pieces[p]);
    if (node->piece_id < 0) node->piece_id = i;  // first id wins (setdefault)
  }
  m->unk_score = (any_normal ? min_normal : -10.0f) - unk_penalty;
  return m;
}

void mpr_spm_free(void* handle) { delete (Model*)handle; }

// Viterbi over char starts; returns number of ids written (<= max_out).
static int32_t spm_encode_span(const Model* m, const char* text, int n,
                               int32_t* out, int32_t max_out);

int32_t mpr_spm_encode(void* handle, const char* text, int32_t* out,
                       int32_t max_out) {
  return spm_encode_span((const Model*)handle, text, (int)strlen(text),
                         out, max_out);
}

// Length-explicit single-string entry: unlike mpr_spm_encode (strlen),
// this handles embedded NUL bytes, keeping encode() == encode_rows()
// for any input (the batch entry below is span-based too).
int32_t mpr_spm_encode_span(void* handle, const char* text, int32_t n,
                            int32_t* out, int32_t max_out) {
  return spm_encode_span((const Model*)handle, text, n, out, max_out);
}

// Batch entry: encode n strings in ONE call, writing straight into a
// caller-owned row-major (n, cap) int32 matrix — the serving host path
// tokenizes 512 prompts per chunk, and the per-call ctypes + Python
// list-building overhead of the single-string entry dominates there
// (measured ~2x the DP itself). texts: concatenated UTF-8 bytes (not
// nul-terminated); offsets: n+1 byte offsets; lens[i] = ids written for
// row i. Bit-identical rows to mpr_spm_encode.
void mpr_spm_encode_batch(void* handle, const char* texts,
                          const int32_t* offsets, int32_t n, int32_t* out,
                          int32_t* lens, int32_t cap) {
  const Model* m = (const Model*)handle;
  for (int32_t i = 0; i < n; ++i)
    lens[i] = spm_encode_span(m, texts + offsets[i],
                              offsets[i + 1] - offsets[i],
                              out + (int64_t)i * cap, cap);
}

static int32_t spm_encode_span(const Model* m, const char* text, int n,
                               int32_t* out, int32_t max_out) {
  if (n == 0) return 0;
  const float NEG = -std::numeric_limits<float>::infinity();
  std::vector<float> best(n + 1, NEG);
  std::vector<int32_t> back_pos(n + 1, -1), back_id(n + 1, -1);
  best[0] = 0.0f;
  for (int i = 0; i < n; ++i) {
    if (best[i] == NEG || !is_char_start((uint8_t)text[i])) continue;
    const TrieNode* node = &m->root;
    for (int j = i; j < n; ++j) {
      node = node->child((uint8_t)text[j]);
      if (!node) break;
      int end = j + 1;
      // only segment at character boundaries
      if (end < n && !is_char_start((uint8_t)text[end])) continue;
      if (node->piece_id >= 0) {
        float sc = best[i] + m->scores[node->piece_id];
        if (sc > best[end]) {
          best[end] = sc;
          back_pos[end] = i;
          back_id[end] = node->piece_id;
        }
      }
    }
    // unk fallback: one full character
    int end = i + 1;
    while (end < n && !is_char_start((uint8_t)text[end])) ++end;
    float sc = best[i] + m->unk_score;
    if (sc > best[end]) {
      best[end] = sc;
      back_pos[end] = i;
      back_id[end] = m->unk_id;
    }
  }
  // backtrack; contiguous unk pieces fuse into one id (sentencepiece
  // unigram_model.cc post-Viterbi merge — see text/spm.py viterbi_encode)
  std::vector<int32_t> rev;
  int j = n;
  while (j > 0 && back_pos[j] >= 0) {
    int32_t id = back_id[j];
    if (!(id == m->unk_id && !rev.empty() && rev.back() == m->unk_id))
      rev.push_back(id);
    j = back_pos[j];
  }
  int32_t cnt = 0;
  for (auto it = rev.rbegin(); it != rev.rend() && cnt < max_out; ++it)
    out[cnt++] = *it;
  return cnt;
}

}  // extern "C"
