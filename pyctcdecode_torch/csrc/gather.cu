// Row reads of the decode step's LM tables: a row gather with a slot select,
// the n-gram bucket probe fused with its readout, and the step's whole word
// commit around that probe.
//
// Both replace the DMA-pipelined Pallas row gather of the JAX reference
// (scripts/pallas_gather_probe.py, gather_kernel): there, scalar-prefetched
// indices drive single-row HBM->VMEM async copies, 16 in flight, 128 queries
// per grid step, staged through a VMEM scratch block, and XLA ops around it
// hash the queries and read the rows out. None of that structure is carried
// over.
//
// What bounds them on the H100: bytes by the roofline (each row read once,
// each result written once, no arithmetic to speak of), but at a decode
// step's size (a few thousand rows) a launch costs more than the copy, and
// what a plain gather writes is read again by a chain of small kernels. So
// the design is about launches and about not writing rows at all:
//
// * gather_rows_kernel: out[q, :width] = table[idx[q], slot[q] * stride :
//   slot[q] * stride + width]. A flat stream of units (16-byte vectors where
//   the row width, stride and width allow, 4-byte words otherwise): thread t
//   moves unit t % upo of output row t / upo, so neighbouring lanes read
//   neighbouring addresses of one table row and write neighbouring addresses
//   of the output; a grid-stride loop covers any query count. With no slot
//   it is the whole-row copy. The trie fetch passes node / pack, node % pack
//   and writes only the node's own words of the packed row.
// * probe_rows_kernel: one launch probes every n-gram order >= 2 of a
//   scoring call. One warp per (query, order): each lane computes the
//   query's three hashes in uint32 (base hash and the two clamped
//   fingerprint lanes) in its table's mode: FNV-1a over the ids (tables of
//   ARPA models), or KenLM's 64-bit chain over the ids (tables read from a
//   KenLM binary, which stores only each n-gram's chain hash). In the KenLM
//   mode the base hash mixes both halves of the chain (mix32_pair) and
//   each fingerprint lane mixes one half, so the lanes keep all 64 bits.
//   The JAX reference spells the chain's 64-bit multiplies in 16-bit pieces
//   (its TPU has no 64-bit integers); here each is one native uint64_t
//   multiply, a few 32-bit IMADs. The mode is per table, and a table is one
//   blockIdx.y, so a warp never diverges on it.
//   Then lane l loads 16-byte vector l of the one 512-byte
//   bucket row h % size, so the warp holds the whole row in registers (two
//   sub-blocks of 16 lanes: 4 lanes of fp_lo, 4 of fp_hi, 4 of prob, 4 of
//   backoff), compares its four words, and shuffles and ballots find the one
//   slot whose 64-bit fingerprint matches (residents of a bucket have
//   distinct fingerprints). It writes found, prob and backoff: 9 bytes per
//   query and order in place of a 512-byte row written and read again.
//   A table may be a row window of a larger one (rows [row0, row0 + rows)
//   of a bucket plane row-sharded over processes, parallel/batch.py): the
//   base slot is still h % size over the whole table, and a query whose
//   slot lies outside the window answers found = 0, prob = backoff = 0
//   without reading a row (one compare, uniform over the warp), so the
//   windows' answers sum to the whole table's. The default window is the
//   whole table.
// * commit_words_kernel: the decode step's word commit, every LM member in
//   one launch (ops/commit.py; its plain twin is the PyTorch composition
//   the engine ran before, about 90 kernels a step). For each beam: the
//   word it would commit (the trie row's word id, or <unk>) and its order-1
//   probe off the row, every order >= 2 of every member probed as
//   probe_rows_kernel probes (the same hashing and readout functions), the
//   longest match, the backoff sum, the member's fused score alpha * raw10
//   * ln 10 + beta with the OOV offset, the members' mean, the hotword gain,
//   the out-state (context, length, suffix backoffs) and the committed
//   text hash; a beam with no partial word keeps its state. The probes
//   never leave registers. Every f32 operation rounds as PyTorch's separate
//   kernels round it (__fadd_rn / __fmul_rn / __fdiv_rn, in the
//   composition's order: nvcc would contract an unmarked a * b + c), and the
//   hashing is uint32, so it equals the composition on the card to the bit.
//   Neither row-sharded tables (their probe is collective) nor order-1
//   members come here.
//
// Indices must lie in range (idx in [0, rows), slot in [0, row / stride)):
// nothing is clamped or checked here.
//
// Every launch function returns the error of its launch (cudaSuccess = 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132LL * 16;  // a few waves of the card's SMs; the loops stride

// U: the unit moved (int4 or int32). upr / ups / upo: units per table row,
// per slot and per output row.
template <typename U>
__global__ void gather_rows_kernel(const U* __restrict__ table, const int64_t* __restrict__ idx,
                                   const int64_t* __restrict__ slot, U* __restrict__ out,
                                   long long n_units, int upr, int ups, int upo) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n_units; t += step) {
    const long long q = t / upo;
    const int c = (int)(t - q * upo);
    const long long at = idx[q] * (long long)upr + (slot ? slot[q] * (long long)ups : 0LL) + c;
    out[t] = __ldg(table + at);
  }
}

template <typename U>
int launch_gather(const void* table, const int64_t* idx, const int64_t* slot, void* out,
                  long long n_query, int row_words, int stride, int width, cudaStream_t stream) {
  const int per = sizeof(U) / 4;
  const long long n_units = n_query * (width / per);
  long long blocks = (n_units + THREADS - 1) / THREADS;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  gather_rows_kernel<U><<<(unsigned)blocks, THREADS, 0, stream>>>(
      reinterpret_cast<const U*>(table), idx, slot, reinterpret_cast<U*>(out), n_units,
      row_words / per, stride / per, width / per);
  return (int)cudaGetLastError();
}

constexpr int MAX_TABLES = 8;
constexpr int BUCKET_SLOTS = 16;  // the one bucket geometry the probe kernel takes:
constexpr int SUB_WIDTH = 64;     // a 128-word row of two sub-blocks
constexpr int BUCKET_WIDTH = 128;
constexpr uint32_t FNV_OFFSET = 2166136261u;
constexpr uint32_t FNV_PRIME = 16777619u;
constexpr uint32_t FP_MAX = 0xFFFFFFFEu;  // 0xFFFFFFFF marks an empty slot
constexpr uint32_t MODE_FNV = 0, MODE_KENLM64 = 1;  // ops/gather.py HASH_MODES
constexpr uint64_t KENLM_MUL_A = 8978948897894561157ULL;  // kenlm CombineWordHash
constexpr uint64_t KENLM_MUL_B = 17894857484156487943ULL;
constexpr uint32_t KENLM_BASE_SEED = 0x243F6A88u;

struct ProbeTables {  // table t holds the (t + 2)-grams
  const int4* bucket[MAX_TABLES];
  uint32_t size[MAX_TABLES];  // rows of the whole table: the base slot is h % size
  uint32_t row0[MAX_TABLES];  // the window held in bucket: rows [row0, row0 + rows)
  uint32_t rows[MAX_TABLES];
  uint32_t seed_lo[MAX_TABLES];
  uint32_t seed_hi[MAX_TABLES];
  uint32_t mode[MAX_TABLES];  // MODE_FNV or MODE_KENLM64
};

// Seeded 32-bit mix of a 64-bit key's halves (murmur3 finalizer core),
// ops/hashing.py mix32_pair.
__device__ __forceinline__ uint32_t mix32_pair(uint32_t lo, uint32_t hi, uint32_t seed) {
  uint32_t h = lo ^ (hi * 0x85EBCA6Bu) ^ seed;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ int word_of(const int4& v, int j) {
  return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// Table t's three hashes of an n-gram key, ids(0) the oldest id and ids(n - 1)
// the newest: the base hash h and the two clamped fingerprint lanes, in the
// table's mode.
template <typename Ids>
__device__ __forceinline__ void key_hashes(const ProbeTables& tabs, int t, int n, Ids ids,
                                           uint32_t& h, uint32_t& lo, uint32_t& hi) {
  h = FNV_OFFSET;
  lo = tabs.seed_lo[t];
  hi = tabs.seed_hi[t];
  if (tabs.mode[t] == MODE_KENLM64) {
    // newest word first, then the context nearest to oldest; w + 1 in
    // uint32 (ops/hashing.py kenlm_chain)
    uint64_t c = (uint64_t)(uint32_t)ids(n - 1);
    for (int j = n - 2; j >= 0; --j)
      c = (c * KENLM_MUL_A) ^ ((uint64_t)((uint32_t)ids(j) + 1u) * KENLM_MUL_B);
    const uint32_t c_lo = (uint32_t)c, c_hi = (uint32_t)(c >> 32);
    h = mix32_pair(c_lo, c_hi, KENLM_BASE_SEED);
    lo = mix32_pair(c_lo, 0u, lo);
    hi = mix32_pair(c_hi, 0u, hi);
  } else {
    for (int j = 0; j < n; ++j) {
      const uint32_t id = (uint32_t)ids(j);
      h = (h ^ id) * FNV_PRIME;
      lo = (lo ^ id) * FNV_PRIME;
      hi = (hi ^ id) * FNV_PRIME;
    }
  }
  lo = min(lo, FP_MAX);
  hi = min(hi, FP_MAX);
}

// The warp's readout of one bucket row, lane l holding its 16-byte vector l:
// whether a slot's fingerprint is (lo, hi), and that slot's prob and backoff
// bits (0 without a match), in every lane. All 32 lanes call it.
__device__ __forceinline__ bool bucket_match(const int4& v, int lane, uint32_t lo, uint32_t hi,
                                             int& p_bits, int& b_bits) {
  // lane = 16 * sub-block + 4 * field + j4; the lane's words are slots
  // 4 * j4 .. 4 * j4 + 3 of its field (0 fp_lo, 1 fp_hi, 2 prob, 3 backoff)
  const int field = (lane >> 2) & 3;
  const uint32_t want = field == 0 ? lo : hi;
  const uint32_t eq = (uint32_t)((uint32_t)v.x == want) | ((uint32_t)((uint32_t)v.y == want) << 1) |
                      ((uint32_t)((uint32_t)v.z == want) << 2) |
                      ((uint32_t)((uint32_t)v.w == want) << 3);
  const int lo_lane = (lane & 16) | (lane & 3);
  const uint32_t hit = __shfl_sync(0xffffffffu, eq, lo_lane) &
                       __shfl_sync(0xffffffffu, eq, lo_lane | 4);
  const int mine = hit ? word_of(v, __ffs(hit) - 1) : 0;
  // at most one slot of the row matches: its prob lane, and 4 lanes on its backoff lane
  const uint32_t at = __ballot_sync(0xffffffffu, hit != 0 && field == 2);
  const int src = at ? __ffs(at) - 1 : 0;
  p_bits = __shfl_sync(0xffffffffu, mine, src);
  b_bits = __shfl_sync(0xffffffffu, mine, src + 4);
  if (!at) p_bits = b_bits = 0;
  return at != 0;
}

// full: [n_query, order] ids, right-aligned (-1 pad); table t's key is the
// last t + 2 ids. found u8 / prob f32 / backoff f32: [order - 1, n_query].
__global__ void probe_rows_kernel(ProbeTables tabs, const int64_t* __restrict__ full,
                                  const int64_t* __restrict__ ctx_len,
                                  uint8_t* __restrict__ found, float* __restrict__ prob,
                                  float* __restrict__ backoff, long long n_query, int order) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.y;
  const int n = t + 2;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long q = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); q < n_query;
       q += warps) {
    const int64_t* key = full + q * order + (order - n);
    uint32_t h, lo, hi;
    key_hashes(tabs, t, n, [&](int j) { return key[j]; }, h, lo, hi);
    const bool valid = ctx_len[q] + 1 >= n;
    const long long o = (long long)t * n_query + q;
    const uint32_t local = h % tabs.size[t] - tabs.row0[t];  // wraps above rows below the window
    if (local >= tabs.rows[t]) {  // another window's row: the same answer for the whole warp
      if (lane == 0) {
        found[o] = 0;
        prob[o] = 0.0f;
        backoff[o] = 0.0f;
      }
      continue;
    }
    const int4 v = __ldg(tabs.bucket[t] + (long long)local * 32 + lane);
    int p_bits, b_bits;
    const bool hit = bucket_match(v, lane, lo, hi, p_bits, b_bits);
    if (lane == 0) {
      const bool ok = valid && hit;
      found[o] = ok ? 1 : 0;
      prob[o] = ok ? __int_as_float(p_bits) : 0.0f;
      backoff[o] = ok ? __int_as_float(b_bits) : 0.0f;
    }
  }
}

// ---------------------------------------------------------------------------
// commit_words: the decode step's word commit, every LM member in one launch.

constexpr int COMMIT_MAX_MEMBERS = 8;  // ops/commit.py MAX_MEMBERS
constexpr uint32_t TXT_A = 2654435761u, TXT_B = 40503u, TXT_SALT = 0x9E3779B9u;  // ops/hashing.py

// Where a query's ids come from: a member's context planes and the word it
// commits. [NB] planes, ctx / ctx_bo [NB, w] (right-aligned, -1 pad),
// trie_row [NB, row_w], whose last four words are the word's unigram prob
// and backoff bits, its order-1 flag and its word id. n: the table's order
// (the member's own key leaves it 0).
struct CommitKey {
  const int64_t* ctx;
  const int64_t* ctx_len;
  const float* ctx_bo;
  const int64_t* p_flags;
  const int32_t* trie_row;
  int64_t unk_id;
  int w, row_w, n;
};

// One LM member: its key, <unk>'s unigram row, its scalars (a device f32, or
// null: the *_v value), its outputs ([NB] and [NB, w]; hits [order, NB] or
// null), its order and its first table in the launch's tables (the bigrams).
struct CommitMember {
  CommitKey key;
  const float* uni_unk_row;
  const float* alpha;
  const float* beta;
  const float* unk_offset;
  int64_t* o_ctx;
  int64_t* o_ctx_len;
  float* o_ctx_bo;
  uint8_t* o_hits;
  float alpha_v, beta_v, unk_offset_v, unk_prob10;
  int order, t0, has_unigrams;
};

// Field for field the ctypes struct _CommitArgs of ops/commit.py. Table t of
// tabs holds keys[t].n-grams of the member whose key keys[t] copies.
struct CommitArgs {
  ProbeTables tabs;
  CommitKey keys[MAX_TABLES];
  CommitMember m[COMMIT_MAX_MEMBERS];
  const int64_t* text_lo;
  const int64_t* text_hi;
  const int64_t* p_lo;
  const int64_t* p_hi;
  const int64_t* p_len;
  const int64_t* h_bits;    // null without hotwords
  const float* hot_weight;  // device f32, or null: hot_weight_v
  int64_t* o_text_lo;
  int64_t* o_text_hi;
  float* o_word_fused;
  int64_t bit_in_vocab, bit_uni_word, hot_word_bit;
  float hot_weight_v, ln10;
  long long nb;
  int n_lms, n_tables, stats;
};

__device__ __forceinline__ float scalar(const float* dev, float v) { return dev ? __ldg(dev) : v; }

// The word a beam commits: its trie node's word id where the node is a
// vocabulary word, else <unk>.
__device__ __forceinline__ int64_t committed_word(const CommitKey& k, long long q, int64_t bit_in_vocab,
                                                  bool& in_model) {
  in_model = (__ldg(&k.p_flags[q]) & bit_in_vocab) != 0;
  return in_model ? (int64_t)__ldg(&k.trie_row[q * k.row_w + k.row_w - 1]) : k.unk_id;
}

// One warp a beam, in a grid-stride loop. Every lane hashes every table's
// key and loads its vector of each table's bucket row, all loads issued
// before any row is read; lane t keeps table t's answer, which the member
// arithmetic takes with a shuffle. The arithmetic runs in every lane (the
// control flow is the beam's, uniform over the warp); lane 0 writes the
// beam's scalars and lane c each member's context column c.
__global__ void __launch_bounds__(THREADS) commit_words_kernel(const CommitArgs a) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long q = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); q < a.nb; q += warps) {
    const bool commit = __ldg(&a.p_len[q]) > 0;
    // without a commit nothing but the hit counters reads the probes
    const bool probe = commit || a.stats;

    int4 v[MAX_TABLES];
    uint32_t lo[MAX_TABLES], hi[MAX_TABLES];
    bool read[MAX_TABLES];  // the query is valid and its row lies in the window: the row was loaded
#pragma unroll
    for (int t = 0; t < MAX_TABLES; ++t) {  // unrolled: constant offsets into the launch struct
      read[t] = false;
      if (t >= a.n_tables || !probe) continue;
      const CommitKey k = a.keys[t];
      const int n = k.n;
      bool in_model;
      const int64_t wid = committed_word(k, q, a.bit_in_vocab, in_model);
      const int64_t* ctx = k.ctx + q * k.w + (k.w - (n - 1));
      uint32_t h;
      key_hashes(a.tabs, t, n, [&](int j) { return j < n - 1 ? __ldg(&ctx[j]) : wid; }, h, lo[t], hi[t]);
      const uint32_t local = h % a.tabs.size[t] - a.tabs.row0[t];
      read[t] = __ldg(&k.ctx_len[q]) + 1 >= n && local < a.tabs.rows[t];
      if (read[t]) v[t] = __ldg(a.tabs.bucket[t] + (long long)local * 32 + lane);
    }
    int my_found = 0, my_p = 0, my_b = 0;  // lane t: table t's answer
#pragma unroll
    for (int t = 0; t < MAX_TABLES; ++t) {
      if (!read[t]) continue;  // uniform over the warp
      int p_bits, b_bits;
      const bool hit = bucket_match(v[t], lane, lo[t], hi[t], p_bits, b_bits);
      if (lane == t) {
        my_found = hit;
        my_p = p_bits;
        my_b = b_bits;
      }
    }

    // the members' fused word scores, summed in member order, and their new contexts
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < COMMIT_MAX_MEMBERS; ++i) {
      if (i >= a.n_lms) break;
      const CommitKey k = a.m[i].key;
      const int w = k.w, order = a.m[i].order, t0 = a.m[i].t0;
      const long long cq = q * w;
      const int64_t klen = __ldg(&k.ctx_len[q]);
      if (!probe) {  // the state passes through
        if (lane < w) {
          a.m[i].o_ctx[cq + lane] = __ldg(&k.ctx[cq + lane]);
          a.m[i].o_ctx_bo[cq + lane] = __ldg(&k.ctx_bo[cq + lane]);
        }
        if (lane == 0) a.m[i].o_ctx_len[q] = klen;
        continue;
      }
      bool in_model;
      const int64_t wid = committed_word(k, q, a.bit_in_vocab, in_model);
      const int32_t* row = k.trie_row + q * k.row_w + k.row_w - 4;
      const float* unk = a.m[i].uni_unk_row;
      const bool f1 = in_model ? __ldg(&row[2]) != 0 : __ldg(&unk[2]) > 0.5f;
      const float p1 = f1 ? (in_model ? __int_as_float(__ldg(&row[0])) : __ldg(&unk[0])) : 0.0f;
      const float b1 = f1 ? (in_model ? __int_as_float(__ldg(&row[1])) : __ldg(&unk[1])) : 0.0f;
      const bool oov = !in_model || (a.m[i].has_unigrams && (__ldg(&k.p_flags[q]) & a.bit_uni_word) == 0);

      // longest match over the full suffixes, and the out-state's length (capped at order - 1)
      int matched = 0, out_n = 0;
      float best = 0.0f;
      for (int n = 1; n <= order; ++n) {
        bool f = f1;
        float p = p1;
        if (n > 1) {
          f = __shfl_sync(0xffffffffu, my_found, t0 + n - 2) != 0;
          p = __int_as_float(__shfl_sync(0xffffffffu, my_p, t0 + n - 2));
        }
        if (f) {
          matched = n;
          best = p;
          if (n < order) out_n = n;
        }
        if (a.m[i].o_hits != nullptr && lane == 0) a.m[i].o_hits[(n - 1) * a.nb + q] = f;
      }
      float score = best;
      if (matched == 0) {
        score = a.m[i].unk_prob10;
        matched = 1;
      }
      // backoffs of the unmatched context suffixes, ascending j, one rounding each
      for (int j = 1; j < order; ++j)
        if (j >= matched && j <= klen) score = __fadd_rn(score, __ldg(&k.ctx_bo[cq + w - j]));
      const float raw = __fadd_rn(
          score, __fmul_rn(scalar(a.m[i].unk_offset, a.m[i].unk_offset_v), oov ? 1.0f : 0.0f));
      const float fused = __fadd_rn(
          __fmul_rn(__fmul_rn(scalar(a.m[i].alpha, a.m[i].alpha_v), raw), a.ln10),
          scalar(a.m[i].beta, a.m[i].beta_v));
      sum = i == 0 ? fused : __fadd_rn(sum, fused);

      // the out-state: column w - j holds the suffix's j-th newest id and backoff
      for (int j = 1; j <= w; ++j) {
        bool f = f1;
        int b_bits = __float_as_int(b1);
        if (j > 1) {
          f = __shfl_sync(0xffffffffu, my_found, t0 + j - 2) != 0;
          b_bits = __shfl_sync(0xffffffffu, my_b, t0 + j - 2);
        }
        if (lane != w - j) continue;
        const long long at = cq + lane;
        const int64_t id = j > out_n ? -1 : (j > 1 ? __ldg(&k.ctx[at + 1]) : wid);
        const float bo = j <= out_n && f ? __int_as_float(b_bits) : 0.0f;
        a.m[i].o_ctx[at] = commit ? id : __ldg(&k.ctx[at]);
        a.m[i].o_ctx_bo[at] = commit ? bo : __ldg(&k.ctx_bo[at]);
      }
      if (lane == 0) a.m[i].o_ctx_len[q] = commit ? out_n : klen;
    }

    if (lane == 0) {
      const int64_t t_lo = __ldg(&a.text_lo[q]), t_hi = __ldg(&a.text_hi[q]);
      a.o_text_lo[q] = commit ? (int64_t)((uint32_t)t_lo * TXT_A + ((uint32_t)__ldg(&a.p_lo[q]) ^ TXT_SALT)) : t_lo;
      a.o_text_hi[q] = commit ? (int64_t)((uint32_t)t_hi * TXT_B + ((uint32_t)__ldg(&a.p_hi[q]) ^ TXT_SALT)) : t_hi;
      // PyTorch's CUDA true division by a host scalar multiplies by its f32 reciprocal
      float wf = 0.0f;
      if (commit && a.n_lms > 0) wf = a.n_lms > 1 ? __fmul_rn(sum, __fdiv_rn(1.0f, (float)a.n_lms)) : sum;
      if (a.h_bits != nullptr) {
        const bool hot = commit && (__ldg(&a.h_bits[q]) & a.hot_word_bit) != 0;
        wf = __fadd_rn(wf, __fmul_rn(scalar(a.hot_weight, a.hot_weight_v), hot ? 1.0f : 0.0f));
      }
      a.o_word_fused[q] = wf;
    }
  }
}

}  // namespace

// table: int32 [rows, row_words]; idx: int64 [n_query]; slot: int64
// [n_query] or null (slot 0); out: int32 [n_query, width]. Moves 16-byte
// vectors when row_words, stride and width are multiples of 4 words and
// table and out are 16-byte aligned, 4-byte words otherwise.
extern "C" int gather_rows_launch(const void* table, const int64_t* idx, const int64_t* slot,
                                  void* out, long long n_query, int row_words, int stride,
                                  int width, void* stream) {
  const bool vec = row_words % 4 == 0 && stride % 4 == 0 && width % 4 == 0 &&
                   (uintptr_t)table % 16 == 0 && (uintptr_t)out % 16 == 0;
  if (vec)
    return launch_gather<int4>(table, idx, slot, out, n_query, row_words, stride, width,
                               (cudaStream_t)stream);
  return launch_gather<int32_t>(table, idx, slot, out, n_query, row_words, stride, width,
                                (cudaStream_t)stream);
}

// buckets / sizes / row0s / rows / seeds_lo / seeds_hi / modes: host arrays
// of order - 1 entries, table t for the (t + 2)-grams, each bucket int32
// [rows, 128] on the device, 16-byte aligned, holding rows [row0, row0 +
// rows) of a table of size rows (row0 = 0, rows = size: the whole table);
// modes[t] is MODE_FNV or MODE_KENLM64. Refuses any other bucket geometry,
// order or mode, and an empty window.
extern "C" int probe_rows_launch(const void* const* buckets, const uint32_t* sizes,
                                 const uint32_t* row0s, const uint32_t* rows,
                                 const uint32_t* seeds_lo, const uint32_t* seeds_hi,
                                 const uint32_t* modes, const int64_t* full,
                                 const int64_t* ctx_len, uint8_t* found, float* prob,
                                 float* backoff, long long n_query, int order,
                                 int slots, int sub_width, int bucket_width, void* stream) {
  if (slots != BUCKET_SLOTS || sub_width != SUB_WIDTH || bucket_width != BUCKET_WIDTH ||
      order < 2 || order - 1 > MAX_TABLES)
    return (int)cudaErrorInvalidValue;
  ProbeTables tabs;
  for (int t = 0; t < order - 1; ++t) {
    if ((uintptr_t)buckets[t] % 16 != 0 || sizes[t] == 0 || rows[t] == 0 ||
        (modes[t] != MODE_FNV && modes[t] != MODE_KENLM64))
      return (int)cudaErrorInvalidValue;
    tabs.bucket[t] = reinterpret_cast<const int4*>(buckets[t]);
    tabs.size[t] = sizes[t];
    tabs.row0[t] = row0s[t];
    tabs.rows[t] = rows[t];
    tabs.seed_lo[t] = seeds_lo[t];
    tabs.seed_hi[t] = seeds_hi[t];
    tabs.mode[t] = modes[t];
  }
  const int warps = THREADS / 32;
  long long blocks = (n_query + warps - 1) / warps;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  probe_rows_kernel<<<dim3((unsigned)blocks, (unsigned)(order - 1)), THREADS, 0,
                      (cudaStream_t)stream>>>(tabs, full, ctx_len, found, prob, backoff, n_query,
                                              order);
  return (int)cudaGetLastError();
}

// sizeof(CommitArgs), for the wrapper to check its ctypes mirror against.
extern "C" int commit_args_size() { return (int)sizeof(CommitArgs); }

// args: the launch struct (CommitArgs) on the host; every plane on the
// stream's device, contiguous, shaped as CommitArgs says; tables as
// probe_rows_launch takes them. Refuses more than COMMIT_MAX_MEMBERS members,
// more than MAX_TABLES tables, a member of order below 2 or whose tables are
// not the launch's t0 .. t0 + order - 2, and a trie row of fewer than 4 words.
extern "C" int commit_words_launch(const void* args, void* stream) {
  const CommitArgs& a = *static_cast<const CommitArgs*>(args);
  if (a.nb < 1 || a.n_lms < 0 || a.n_lms > COMMIT_MAX_MEMBERS || a.n_tables < 0 ||
      a.n_tables > MAX_TABLES)
    return (int)cudaErrorInvalidValue;
  int next = 0;
  for (int i = 0; i < a.n_lms; ++i) {
    const CommitMember& m = a.m[i];
    if (m.order < 2 || m.key.w != m.order - 1 || m.key.row_w < 4 || m.t0 != next)
      return (int)cudaErrorInvalidValue;
    for (int n = 2; n <= m.order; ++n, ++next) {
      if (next >= a.n_tables || a.keys[next].n != n || a.keys[next].w != m.key.w)
        return (int)cudaErrorInvalidValue;
    }
  }
  if (next != a.n_tables) return (int)cudaErrorInvalidValue;
  for (int t = 0; t < a.n_tables; ++t) {
    if ((uintptr_t)a.tabs.bucket[t] % 16 != 0 || a.tabs.size[t] == 0 || a.tabs.rows[t] == 0 ||
        (a.tabs.mode[t] != MODE_FNV && a.tabs.mode[t] != MODE_KENLM64))
      return (int)cudaErrorInvalidValue;
  }
  const int warps = THREADS / 32;
  long long blocks = (a.nb + warps - 1) / warps;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  commit_words_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
