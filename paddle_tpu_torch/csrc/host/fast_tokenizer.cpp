// Fast BPE tokenizer core (upstream analogue: PaddleNLP's
// faster_tokenizer C++ lib), host code: the port's own copy of the JAX
// package's csrc/fast_tokenizer.cpp. Implements the hot path of
// paddle_tpu_torch.nlp.tokenizer.BPETokenizer.tokenize — whitespace split,
// per-word greedy lowest-rank merge loop, vocab lookup with byte
// fallback — as a ctypes-bound shared library so batch encoding does not
// pay the Python interpreter per merge step.
//
// Semantics mirror the python implementation exactly:
//   symbols = utf8_codepoints(word) + ["</w>"]
//   repeat: merge the adjacent pair with the LOWEST merge rank
//   per final symbol: vocab id, else per-byte <0xNN> fallback, else unk.
//
// Build: g++ -O3 -fPIC -shared (see paddle_tpu_torch/nlp/fast_tokenizer.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    std::hash<std::string> h;
    return h(p.first) * 1000003u ^ h(p.second);
  }
};

struct BPE {
  std::unordered_map<std::string, int> vocab;
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash>
      ranks;
  int unk_id = 0;
  std::string word_end = "</w>";
};

const int kNoRank = INT32_MAX;

// split a UTF-8 string into code points (mirrors python list(word))
void utf8_split(const std::string& s, std::vector<std::string>* out) {
  size_t i = 0;
  while (i < s.size()) {
    unsigned char c = s[i];
    size_t n = 1;
    if ((c & 0x80) == 0) n = 1;
    else if ((c & 0xE0) == 0xC0) n = 2;
    else if ((c & 0xF0) == 0xE0) n = 3;
    else if ((c & 0xF8) == 0xF0) n = 4;
    if (i + n > s.size()) n = 1;  // truncated sequence: take the byte
    out->push_back(s.substr(i, n));
    i += n;
  }
}

void emit_symbol(const BPE* t, const std::string& sym,
                 std::vector<int>* out) {
  auto it = t->vocab.find(sym);
  if (it != t->vocab.end()) {
    out->push_back(it->second);
    return;
  }
  // byte fallback: <0xNN> per utf-8 byte
  char buf[8];
  for (unsigned char b : sym) {
    snprintf(buf, sizeof(buf), "<0x%02X>", b);
    auto bit = t->vocab.find(buf);
    out->push_back(bit != t->vocab.end() ? bit->second : t->unk_id);
  }
}

void bpe_word(const BPE* t, const std::string& word,
              std::vector<int>* out) {
  std::vector<std::string> syms;
  utf8_split(word, &syms);
  syms.push_back(t->word_end);
  while (syms.size() > 1) {
    int best_rank = kNoRank;
    size_t best_i = 0;
    for (size_t i = 0; i + 1 < syms.size(); ++i) {
      auto it = t->ranks.find({syms[i], syms[i + 1]});
      if (it != t->ranks.end() && it->second < best_rank) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank == kNoRank) break;
    syms[best_i] += syms[best_i + 1];
    syms.erase(syms.begin() + best_i + 1);
  }
  for (const auto& s : syms) emit_symbol(t, s, out);
}

}  // namespace

extern "C" {

void* bpe_create() { return new BPE(); }

void bpe_destroy(void* h) { delete static_cast<BPE*>(h); }

void bpe_set_unk(void* h, int unk_id) {
  static_cast<BPE*>(h)->unk_id = unk_id;
}

void bpe_add_token(void* h, const char* tok, int id) {
  static_cast<BPE*>(h)->vocab.emplace(tok, id);
}

// A pair listed twice keeps its last rank, as the python rank dict does.
void bpe_add_merge(void* h, const char* a, const char* b, int rank) {
  static_cast<BPE*>(h)->ranks[std::make_pair(std::string(a),
                                             std::string(b))] = rank;
}

// Encode whitespace-split `text` of `text_len` bytes (explicit length:
// embedded NUL bytes are word bytes, matching python str semantics — the
// python wrapper pre-normalizes unicode whitespace to ' ' so only ASCII
// separators appear here); writes up to max_out ids, returns the number
// of ids the full encoding needs (caller re-calls with a larger buffer
// when the return value exceeds max_out).
int bpe_encode(void* h, const char* text, int32_t text_len, int32_t* out_ids,
               int max_out) {
  const BPE* t = static_cast<BPE*>(h);
  std::vector<int> ids;
  std::string word;
  for (int32_t i = 0; i <= text_len; ++i) {
    char c = (i < text_len) ? text[i] : ' ';
    if (c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
        c == '\v') {
      if (!word.empty()) {
        bpe_word(t, word, &ids);
        word.clear();
      }
    } else {
      word.push_back(c);
    }
  }
  int n = static_cast<int>(ids.size());
  for (int i = 0; i < n && i < max_out; ++i) out_ids[i] = ids[i];
  return n;
}

}  // extern "C"
