// ctclm: native n-gram language-model runtime.
//
// This is the framework's own replacement for the role KenLM (C++) plays in
// the reference (ref language_model.py:28-34, 306-360): parse ARPA text
// models fast, hold the n-gram tables in flat memory, and answer
// BaseScore-equivalent queries. The table layout is bit-identical to the
// device tables built in models/device_tables.py (open-addressing linear
// probing, FNV-1a over int32 word ids, float32 log10 probs/backoffs), so a
// natively-parsed model can be exported straight into device HBM arrays
// without touching Python dicts.
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in the
// image). All functions are thread-compatible: one handle per model, no
// globals.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <charconv>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;
constexpr int kMinTable = 8;
// lookups pay the table's max displacement on every probe window; cap it
// and grow the table instead (matches models/device_tables.py)
constexpr int kMaxProbes = 8;

inline uint32_t fnv1a(const int32_t* ids, int n) {
  uint32_t h = kFnvOffset;
  for (int i = 0; i < n; i++) {
    h ^= static_cast<uint32_t>(ids[i]);
    h *= kFnvPrime;
  }
  return h;
}

struct Table {
  int n = 0;            // key width (order)
  int64_t size = 0;     // power of two
  int64_t mask = 0;
  int max_probes = 1;
  int64_t count = 0;
  std::vector<int32_t> keys;  // size*n, -1 == empty
  std::vector<float> probs;
  std::vector<float> backoffs;
  std::vector<int32_t> disp;  // robin-hood displacement per slot

  // real keys always end in a word id >= 0 (left -1 padding only), so the
  // last column is the occupancy marker
  bool empty_slot(int64_t slot) const { return keys[slot * n + n - 1] == -1; }

  void init(int width, int64_t slots) {
    n = width;
    size = slots;
    mask = size - 1;
    keys.assign(size * n, -1);
    probs.assign(size, 0.f);
    backoffs.assign(size, 0.f);
    disp.assign(size, 0);
    max_probes = 1;
    count = 0;
  }

  // robin-hood insertion: evict shallower residents so the worst-case
  // displacement (== every lookup's probe-window width) stays small.
  // Returns false when displacement explodes (caller grows + reinserts).
  bool insert(const int32_t* key, float prob, float backoff) {
    int32_t cur[16];
    memcpy(cur, key, n * sizeof(int32_t));
    float p = prob, b = backoff;
    int64_t slot = fnv1a(cur, n) & mask;
    int d = 0;
    while (true) {
      if (empty_slot(slot)) {
        memcpy(&keys[slot * n], cur, n * sizeof(int32_t));
        probs[slot] = p;
        backoffs[slot] = b;
        disp[slot] = d;
        if (d + 1 > max_probes) max_probes = d + 1;
        count++;
        return true;
      }
      if (!memcmp(&keys[slot * n], cur, n * sizeof(int32_t))) {
        probs[slot] = p;  // duplicate entry: last wins (matches dict)
        backoffs[slot] = b;
        return true;
      }
      if (disp[slot] < d) {  // swap with the shallower resident
        int32_t tmp[16];
        memcpy(tmp, &keys[slot * n], n * sizeof(int32_t));
        memcpy(&keys[slot * n], cur, n * sizeof(int32_t));
        memcpy(cur, tmp, n * sizeof(int32_t));
        std::swap(p, probs[slot]);
        std::swap(b, backoffs[slot]);
        std::swap(d, disp[slot]);
        if (disp[slot] + 1 > max_probes) max_probes = disp[slot] + 1;
      }
      slot = (slot + 1) & mask;
      if (++d >= kMaxProbes) return false;
    }
  }

  bool lookup(const int32_t* key, float* prob, float* backoff) const {
    if (count == 0) return false;
    int64_t slot = fnv1a(key, n) & mask;
    for (int p = 0; p < max_probes; p++) {
      const int32_t* k = &keys[slot * n];
      if (k[n - 1] == -1) return false;  // empty stops a linear-probe chain
      if (!memcmp(k, key, n * sizeof(int32_t))) {
        if (prob) *prob = probs[slot];
        if (backoff) *backoff = backoffs[slot];
        return true;
      }
      slot = (slot + 1) & mask;
    }
    return false;
  }
};

struct Model {
  int order = 0;
  std::unordered_map<std::string, int32_t> vocab;
  std::vector<std::string> id2word;
  std::vector<Table> tables;  // index n-1
  Table unified;  // all orders, keys left-padded with -1 to `order` width
  int32_t unk_id = 0;
  int32_t bos_id = -1;
  int32_t eos_id = -1;
  float unk_prob10 = -99.f;
  std::string error;
};

int32_t intern(Model& m, const char* word, size_t len) {
  std::string w(word, len);
  auto it = m.vocab.find(w);
  if (it != m.vocab.end()) return it->second;
  int32_t id = static_cast<int32_t>(m.id2word.size());
  m.vocab.emplace(std::move(w), id);
  m.id2word.emplace_back(word, len);
  return id;
}

struct Entry {
  std::vector<int32_t> ids;
  float prob;
  float backoff;
};

void build_table(Table& t, int width, const std::vector<Entry>& entries) {
  int64_t slots = kMinTable;  // load factor <= 0.5
  while (slots / 2 < static_cast<int64_t>(entries.size())) slots *= 2;
  for (;;) {
    t.init(width, slots);
    bool ok = true;
    for (const Entry& e : entries) {
      if (!t.insert(e.ids.data(), e.prob, e.backoff)) {
        ok = false;
        break;
      }
    }
    if (ok) return;
    slots *= 2;  // pathological displacement: rebuild sparser
  }
}

}  // namespace

extern "C" {

void* ctclm_load_arpa(const char* path) {
  auto* m = new Model();
  FILE* fh = fopen(path, "r");
  if (!fh) {
    m->error = "cannot open file";
    return m;
  }
  m->unk_id = intern(*m, "<unk>", 5);

  std::vector<std::vector<Entry>> raw;  // per order
  char* line = nullptr;
  size_t cap = 0;
  int current_n = 0;
  int section = 0;  // 0 header, 1 counts, 2 ngrams
  while (getline(&line, &cap, fh) != -1) {
    // strip
    char* s = line;
    while (*s == ' ' || *s == '\t') s++;
    size_t len = strlen(s);
    while (len && (s[len - 1] == '\n' || s[len - 1] == '\r' || s[len - 1] == ' '))
      len--;
    s[len] = 0;
    if (!len) continue;
    if (!strcmp(s, "\\data\\")) {
      section = 1;
      continue;
    }
    if (!strcmp(s, "\\end\\")) break;
    if (s[0] == '\\') {
      char* dash = strstr(s, "-grams:");
      if (dash) {
        current_n = atoi(s + 1);
        if (current_n > m->order) m->order = current_n;
        if (static_cast<int>(raw.size()) < current_n) raw.resize(current_n);
        section = 2;
      }
      continue;
    }
    if (section == 1) {
      // "ngram N=COUNT"
      if (!strncmp(s, "ngram ", 6)) {
        int n = atoi(s + 6);
        if (n > m->order) m->order = n;
      }
      continue;
    }
    if (section != 2 || current_n == 0) continue;
    // prob \t w1 .. wN [\t backoff]
    char* save = nullptr;
    char* tok = strtok_r(s, " \t", &save);
    if (!tok) continue;
    // std::from_chars: locale-independent (strtof honors LC_NUMERIC, so a
    // comma-decimal host locale would silently truncate "-0.5" at the dot)
    float prob = 0.f;
    std::from_chars(tok, tok + strlen(tok), prob);
    Entry e;
    e.prob = prob;
    e.backoff = 0.f;
    e.ids.reserve(current_n);
    bool bad = false;
    for (int i = 0; i < current_n; i++) {
      tok = strtok_r(nullptr, " \t", &save);
      if (!tok) {
        bad = true;
        break;
      }
      e.ids.push_back(intern(*m, tok, strlen(tok)));
    }
    if (bad) continue;
    tok = strtok_r(nullptr, " \t", &save);
    if (tok) std::from_chars(tok, tok + strlen(tok), e.backoff);
    raw[current_n - 1].push_back(std::move(e));
  }
  free(line);
  fclose(fh);

  if (m->order == 0 || raw.empty() || raw[0].empty()) {
    m->error = "no n-grams found";
    return m;
  }
  // Table::insert copies keys into fixed int32_t[16] stack buffers; bail out
  // BEFORE building any table so an over-wide ARPA can never overflow them.
  if (m->order > 15) {
    m->error = "n-gram order exceeds native limit (15)";
    return m;
  }
  raw.resize(m->order);
  m->tables.resize(m->order);
  for (int n = 1; n <= m->order; n++) build_table(m->tables[n - 1], n, raw[n - 1]);
  // NOTE: the unified all-orders table is built lazily on first use
  // (ensure_unified) — nothing on the hot load path consumes it, and it
  // doubled table-build time + resident memory for every ARPA load.

  auto bos = m->vocab.find("<s>");
  if (bos != m->vocab.end()) m->bos_id = bos->second;
  auto eos = m->vocab.find("</s>");
  if (eos != m->vocab.end()) m->eos_id = eos->second;
  float p;
  if (m->tables[0].lookup(&m->unk_id, &p, nullptr)) m->unk_prob10 = p;
  return m;
}

const char* ctclm_error(void* h) {
  auto* m = static_cast<Model*>(h);
  return m->error.empty() ? nullptr : m->error.c_str();
}

void ctclm_free(void* h) { delete static_cast<Model*>(h); }

int ctclm_order(void* h) { return static_cast<Model*>(h)->order; }
int ctclm_vocab_size(void* h) {
  return static_cast<int>(static_cast<Model*>(h)->id2word.size());
}
int ctclm_unk_id(void* h) { return static_cast<Model*>(h)->unk_id; }
int ctclm_bos_id(void* h) { return static_cast<Model*>(h)->bos_id; }
int ctclm_eos_id(void* h) { return static_cast<Model*>(h)->eos_id; }
float ctclm_unk_prob10(void* h) { return static_cast<Model*>(h)->unk_prob10; }

int ctclm_word_id(void* h, const char* word) {
  auto* m = static_cast<Model*>(h);
  auto it = m->vocab.find(word);
  return it == m->vocab.end() ? -1 : it->second;
}

// copies the '\n'-joined vocabulary (id order) into buf; returns bytes needed
int64_t ctclm_vocab_bytes(void* h) {
  auto* m = static_cast<Model*>(h);
  int64_t total = 0;
  for (const auto& w : m->id2word) total += static_cast<int64_t>(w.size()) + 1;
  return total;
}
void ctclm_export_vocab(void* h, char* buf) {
  auto* m = static_cast<Model*>(h);
  char* p = buf;
  for (size_t i = 0; i < m->id2word.size(); i++) {
    memcpy(p, m->id2word[i].data(), m->id2word[i].size());
    p += m->id2word[i].size();
    *p++ = (i + 1 == m->id2word.size()) ? '\0' : '\n';
  }
}

// hash-table export (layout-compatible with models/device_tables.HashTable)
int64_t ctclm_table_slots(void* h, int n) {
  return static_cast<Model*>(h)->tables[n - 1].size;
}
int64_t ctclm_table_count(void* h, int n) {
  return static_cast<Model*>(h)->tables[n - 1].count;
}
int ctclm_table_max_probes(void* h, int n) {
  return static_cast<Model*>(h)->tables[n - 1].max_probes;
}
void ctclm_export_table(void* h, int n, int32_t* keys, float* probs,
                        float* backoffs) {
  const Table& t = static_cast<Model*>(h)->tables[n - 1];
  memcpy(keys, t.keys.data(), t.keys.size() * sizeof(int32_t));
  memcpy(probs, t.probs.data(), t.probs.size() * sizeof(float));
  memcpy(backoffs, t.backoffs.data(), t.backoffs.size() * sizeof(float));
}

static void ensure_unified(Model* m) {
  // all-orders padded-key table, built on demand (every n-gram keyed at
  // full width, -1-left-padded — the layout a single batched probe wants)
  if (m->unified.size != 0) return;
  std::vector<Entry> all;
  int64_t total = 0;
  for (int n = 1; n <= m->order; n++) {
    const Table& t = m->tables[n - 1];
    total += t.count;
  }
  all.reserve(total);
  for (int n = 1; n <= m->order; n++) {
    const Table& t = m->tables[n - 1];
    for (int64_t s = 0; s < t.size; s++) {
      // last key column is the occupancy marker (real ids are >= 0)
      if (t.keys[s * n + (n - 1)] < 0) continue;
      Entry padded;
      padded.prob = t.probs[s];
      padded.backoff = t.backoffs[s];
      padded.ids.assign(m->order, -1);
      for (int i = 0; i < n; i++)
        padded.ids[m->order - n + i] = t.keys[s * n + i];
      all.push_back(std::move(padded));
    }
  }
  build_table(m->unified, m->order, all);
}

int64_t ctclm_unified_slots(void* h) {
  Model* m = static_cast<Model*>(h);
  ensure_unified(m);
  return m->unified.size;
}
int ctclm_unified_max_probes(void* h) {
  Model* m = static_cast<Model*>(h);
  ensure_unified(m);
  return m->unified.max_probes;
}
void ctclm_export_unified(void* h, int32_t* keys, float* probs,
                          float* backoffs) {
  const Table& t = static_cast<Model*>(h)->unified;
  memcpy(keys, t.keys.data(), t.keys.size() * sizeof(int32_t));
  memcpy(probs, t.probs.data(), t.probs.size() * sizeof(float));
  memcpy(backoffs, t.backoffs.data(), t.backoffs.size() * sizeof(float));
}

// KenLM-BaseScore-equivalent scoring, semantics identical to the Python
// reference scorer (models/ngram.py NGramTables.raw_score): longest-match
// probability plus unmatched-context backoffs (f32 accumulation, ascending),
// outgoing state = longest suffix present, capped at order-1.
//
// ctx: right-aligned [order-1] with -1 padding. Batched variant below.
float ctclm_score(void* h, const int32_t* ctx, int ctx_len, int32_t wid,
                  int32_t* out_ctx, int32_t* out_len) {
  auto* m = static_cast<Model*>(h);
  const int order = m->order;
  int32_t full[16];
  int k = ctx_len;
  if (k > order - 1) k = order - 1;
  const int width = order > 1 ? order - 1 : 1;
  for (int i = 0; i < k; i++) full[i] = ctx[width - k + i];
  full[k] = wid;
  const int flen = k + 1;

  int matched = 0;
  float prob = 0.f;
  for (int n = flen; n >= 1; n--) {
    if (m->tables[n - 1].lookup(full + flen - n, &prob, nullptr)) {
      matched = n;
      break;
    }
  }
  if (matched == 0) {
    prob = m->unk_prob10;
    matched = 1;
  }
  float score = prob;
  for (int j = matched; j <= k; j++) {
    float bo;
    if (m->tables[j - 1].lookup(full + flen - 1 - j, nullptr, &bo))
      score = static_cast<float>(score + bo);
  }
  int out_n = 0;
  int cap = flen < order - 1 ? flen : order - 1;
  for (int n = cap; n >= 1; n--) {
    if (m->tables[n - 1].lookup(full + flen - n, nullptr, nullptr)) {
      out_n = n;
      break;
    }
  }
  if (out_ctx) {
    for (int i = 0; i < width; i++) out_ctx[i] = -1;
    for (int i = 0; i < out_n; i++)
      out_ctx[width - out_n + i] = full[flen - out_n + i];
  }
  if (out_len) *out_len = out_n;
  return score;
}

void ctclm_score_batch(void* h, int64_t count, const int32_t* ctx,
                       const int32_t* ctx_len, const int32_t* wids,
                       float* out_scores, int32_t* out_ctx,
                       int32_t* out_len) {
  auto* m = static_cast<Model*>(h);
  const int width = m->order > 1 ? m->order - 1 : 1;
  for (int64_t i = 0; i < count; i++) {
    out_scores[i] =
        ctclm_score(h, ctx + i * width, ctx_len[i], wids[i],
                    out_ctx ? out_ctx + i * width : nullptr,
                    out_len ? out_len + i : nullptr);
  }
}

}  // extern "C"
