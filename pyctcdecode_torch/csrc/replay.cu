// The engine step's winner replay: from the step's top-B ranking to the new
// beam state and the step's backpointers, in one launch.
//
// Per utterance n and new beam slot j: resolve the winner (a dense step's
// sorted candidate index gives its token column and parent; a timeline
// step hands its pooled winners as planes), replay the transition from the
// parent's row and the token's table entries (stay / boundary, the text and
// partial-word hashes, word count, fused score, history ring, the members'
// contexts, trie entries and the hot entry), kill dead lanes and, with
// prune_history, beams whose history key a lower slot of the utterance
// holds; then gate the padded steps, whose rows keep their state and emit
// the identity parent with token -3 (active: a timeline's non-final chunk)
// or -1. The plain twin is ops/replay.py replay_winners_ref; the two agree
// to the bit (integer arithmetic and one float32 add, fused + word score at
// a boundary, in the same order).
//
// No Pallas kernel of the JAX reference computes this: there it is XLA's
// lowering of the step's tail (its engine.py:1290-1535) and of
// _select_fields_mxu (:597), the one-hot matmul selection a TPU needs. The
// port ran it as ~115 small PyTorch launches a step.
//
// What bounds it on the H100: launch latency and one pass over the state,
// not arithmetic. A 32 x 100 step reads and writes well under 1 MB (under
// 0.5 us at 3.35 TB/s), and the work is a few hundred integer operations a
// beam. The design: one block per utterance, one thread per beam (B <=
// 1024). A thread reads its winner's parent row and token entries, which
// sit in L2 within a step, and writes its row of every output plane once;
// the only exchange inside a block is the history keys, in shared memory.
// The per-member planes and the optional ones (hot entries, pooled winners,
// the stats flags) come in one launch struct of plane pointers and widths;
// a null pointer turns its part off.
//
// Hash lanes are int64 holding uint32 values (the port's lane convention);
// the hash arithmetic is uint32 with wraparound, and values the replay only
// moves are copied as the int64 they are.
//
// The launch function returns the error of its launch (cudaSuccess = 0).

#include <cuda_runtime.h>
#include <stdint.h>

#define DEAD (-1.0e30f)
#define DEAD_THRESH (-1.0e29f)

constexpr int MAX_MEMBERS = 8;  // ops/replay.py MAX_MEMBERS

// One LM member's planes: state in, the commit's (cm) planes, the winners'
// packed trie entries, state out. ctx / ctx_bo are [N, B, w], the rest [N, B].
struct Member {
  const int64_t* p_node;
  const int64_t* p_flags;
  const int64_t* ctx;
  const int64_t* ctx_len;
  const float* ctx_bo;
  const int64_t* cm_ctx;
  const int64_t* cm_ctx_len;
  const float* cm_ctx_bo;
  const int64_t* ent;  // dense: [N, B, K] by (parent, column); pooled: [N, B]
  int64_t* o_p_node;
  int64_t* o_p_flags;
  int64_t* o_ctx;
  int64_t* o_ctx_len;
  float* o_ctx_bo;
  int w;
};

// Field for field the ctypes struct _ReplayArgs of ops/replay.py.
struct ReplayArgs {
  // beam state in, [N, B] (rings [N, B, ring]); h_node / h_bits null without hotwords
  const int64_t* text_lo;
  const int64_t* text_hi;
  const int64_t* p_lo;
  const int64_t* p_hi;
  const int64_t* p_len;
  const int64_t* last_tok;
  const int64_t* n_words;
  const int64_t* ring_lo;
  const int64_t* ring_hi;
  const int64_t* h_node;
  const int64_t* h_bits;
  const uint8_t* force;
  const float* logit;
  const float* fused;
  const float* cm_wfused;  // the commit's word score of each parent beam
  // beam state out, shaped as in
  int64_t* o_text_lo;
  int64_t* o_text_hi;
  int64_t* o_p_lo;
  int64_t* o_p_hi;
  int64_t* o_p_len;
  int64_t* o_last_tok;
  int64_t* o_n_words;
  int64_t* o_ring_lo;
  int64_t* o_ring_hi;
  int64_t* o_h_node;
  int64_t* o_h_bits;
  uint8_t* o_force;
  float* o_logit;
  float* o_fused;
  // token tables [V] (raw_chars [V, lmax], -1 past a label's end)
  const int64_t* kind;
  const int64_t* piece_len;
  const int64_t* raw_chars;
  const int64_t* raw_len;
  const int64_t* seed_lo;
  const int64_t* seed_hi;
  const int32_t* right_bound;
  // dense winners: order / score [N, m_stride] (first B read), src / merged
  // [N, K, B], toks [N, K]; or pooled winners (order null): w_* [N, B], score [N, B]
  const int64_t* order;
  const float* score;
  const int32_t* src;
  const float* merged;
  const int64_t* toks;
  const int64_t* w_parent;
  const int64_t* w_bp;
  const int64_t* w_tok;
  const float* w_logit;
  const int64_t* h_ent;  // shaped as a member's ent; null without hotwords
  // rows [N]: gate (the row advances), active (not a padded step)
  const uint8_t* gate;
  const uint8_t* active;
  void* parent_out;  // [N, B], par_bytes (1, 2 or 4) each
  void* token_out;   // [N, B], tok_bytes each
  int32_t* flags;    // [N, B] FLAG_* bits, or null
  Member m[MAX_MEMBERS];
  int64_t node_mask;
  int64_t hot_node_mask;
  int n, b, k, m_stride, lmax, ring, n_lms, is_bpe, prune_history, par_bytes, tok_bytes;
};

namespace {

constexpr int MAX_THREADS = 1024;  // one thread a beam: ops/merge.py MAX_BEAM
constexpr int64_t KIND_BLANK = 0, KIND_BOUNDARY = 1;  // ops/tokens.py
constexpr uint32_t CH_A = 31u, CH_B = 1000003u;       // ops/hashing.py
constexpr uint32_t TXT_A = 2654435761u, TXT_B = 40503u, TXT_SALT = 0x9E3779B9u;
constexpr uint32_t MIX_PRIME = 0x01000193u;
constexpr int32_t FLAG_BND = 1, FLAG_COMMIT = 2, FLAG_ALIVE = 4, FLAG_DUP = 8;  // ops/replay.py

__device__ __forceinline__ uint32_t mix4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  uint32_t h = (a * MIX_PRIME) ^ b;
  h = (h * MIX_PRIME) ^ c;
  return (h * MIX_PRIME) ^ d;
}

// the backpointer logs' narrow types (ops/backtrace.py LOG_DTYPES)
__device__ __forceinline__ void store(void* base, int bytes, size_t i, int64_t v) {
  switch (bytes) {
    case 1: static_cast<int8_t*>(base)[i] = (int8_t)v; break;
    case 2: static_cast<int16_t*>(base)[i] = (int16_t)v; break;
    default: static_cast<int32_t*>(base)[i] = (int32_t)v;
  }
}

// Input planes are read through the read-only path (__ldg): nothing the
// kernel writes aliases them, so the loads may be issued ahead of the stores.
// MAXT bounds the block: 256 threads leave the registers a thread needs,
// 1024 (beams past 256) cap them at 64.
template <int MAXT>
__global__ void __launch_bounds__(MAXT) replay_winners_kernel(const ReplayArgs a) {
  extern __shared__ uint32_t s_key[];  // [2, blockDim.x]: history keys (prune_history)
  const int n = blockIdx.x;
  const int j = threadIdx.x;
  const int b = a.b;
  const bool live = j < b;
  const size_t row = (size_t)n * b + j;
  const bool gate = __ldg(&a.gate[n]) != 0;

  // ---- the winner: parent row, backtrace parent, token, logit, entry offset
  int par = 0;
  int64_t bp = 0, tok = 0;
  float logit = DEAD, score = DEAD;
  size_t ent_at = 0;
  if (live) {
    if (a.order != nullptr) {
      const size_t r = (size_t)n * a.m_stride + j;
      const int64_t idx = __ldg(&a.order[r]);
      const int64_t col = idx / b;
      par = (int)(idx % b);
      score = __ldg(&a.score[r]);
      const size_t cand = (size_t)n * a.k * b + idx;
      bp = (int64_t)__ldg(&a.src[cand]) % b;
      logit = __ldg(&a.merged[cand]);
      tok = __ldg(&a.toks[(size_t)n * a.k + col]);
      ent_at = ((size_t)n * b + par) * a.k + col;
    } else {
      par = (int)__ldg(&a.w_parent[row]);
      bp = __ldg(&a.w_bp[row]);
      const int64_t t = __ldg(&a.w_tok[row]);
      tok = t < 0 ? 0 : t;
      logit = __ldg(&a.w_logit[row]);
      score = __ldg(&a.score[row]);
      ent_at = row;
    }
  }
  const bool alive = score > DEAD_THRESH;
  const size_t prow = (size_t)n * b + par;

  // ---- the transition from (parent, token)
  bool bnd = false, commit = false, dup = false;
  int64_t p_lo_n = 0, p_hi_n = 0, p_len_n = 0, text_lo_n = 0, text_hi_n = 0, n_words_n = 0, last_n = 0;
  bool force_n = false;
  float fused_n = 0.0f, logit_n = DEAD;
  if (live) {
    const int64_t t_lo = __ldg(&a.text_lo[prow]), t_hi = __ldg(&a.text_hi[prow]);
    const int64_t p_lo = __ldg(&a.p_lo[prow]), p_hi = __ldg(&a.p_hi[prow]), p_len = __ldg(&a.p_len[prow]);
    const bool force = __ldg(&a.force[prow]) != 0;
    const int64_t kind = __ldg(&a.kind[tok]);
    commit = p_len > 0;
    const bool stay = kind == KIND_BLANK || __ldg(&a.last_tok[prow]) == tok;
    const bool boundary = kind == KIND_BOUNDARY;
    bnd = !stay && (a.is_bpe ? (boundary || force) : boundary);
    uint32_t e_lo = (uint32_t)p_lo, e_hi = (uint32_t)p_hi;
    for (int l = 0; l < a.lmax; ++l) {
      const int64_t c = __ldg(&a.raw_chars[(size_t)tok * a.lmax + l]);
      if (c >= 0) {
        e_lo = e_lo * CH_A + (uint32_t)c + 1u;
        e_hi = e_hi * CH_B + (uint32_t)c + 1u;
      }
    }
    p_lo_n = stay ? p_lo : (bnd ? __ldg(&a.seed_lo[tok]) : (int64_t)e_lo);
    p_hi_n = stay ? p_hi : (bnd ? __ldg(&a.seed_hi[tok]) : (int64_t)e_hi);
    p_len_n = stay ? p_len : (bnd ? __ldg(&a.piece_len[tok]) : p_len + __ldg(&a.raw_len[tok]));
    const int64_t mt_lo = (int64_t)((uint32_t)t_lo * TXT_A + ((uint32_t)p_lo ^ TXT_SALT));
    const int64_t mt_hi = (int64_t)((uint32_t)t_hi * TXT_B + ((uint32_t)p_hi ^ TXT_SALT));
    text_lo_n = bnd && commit ? mt_lo : t_lo;
    text_hi_n = bnd && commit ? mt_hi : t_hi;
    fused_n = __ldg(&a.fused[prow]) + (bnd ? __ldg(&a.cm_wfused[prow]) : 0.0f);
    n_words_n = __ldg(&a.n_words[prow]) + (bnd && commit ? 1 : 0);
    force_n = bnd ? __ldg(&a.right_bound[tok]) != 0 : force;
    logit_n = alive ? logit : DEAD;
    last_n = alive ? tok : -2 - (int64_t)j;
  }
  const bool shift = bnd && commit;  // the ring takes the committed word

  if (a.prune_history) {
    // (partial, last token, word count, ring) into two mixed lanes; a lower
    // slot holding the same key kills this one: the older beam survives
    if (live) {
      const uint32_t last_u = (uint32_t)last_n;
      const uint32_t nw_cap =
          (uint32_t)(n_words_n < a.ring ? n_words_n : (int64_t)a.ring) | ((uint32_t)force_n << 16);
      uint32_t hk_lo = mix4((uint32_t)p_lo_n, (uint32_t)p_hi_n, last_u, nw_cap);
      uint32_t hk_hi = mix4((uint32_t)p_hi_n, (uint32_t)p_lo_n, nw_cap, last_u ^ 0x9E3779B9u);
      for (int r = 0; r < a.ring; ++r) {
        const bool from_word = shift && r + 1 == a.ring;
        const size_t at = prow * a.ring + (shift ? r + 1 : r);
        const uint32_t rl = (uint32_t)(from_word ? __ldg(&a.p_lo[prow]) : __ldg(&a.ring_lo[at]));
        const uint32_t rh = (uint32_t)(from_word ? __ldg(&a.p_hi[prow]) : __ldg(&a.ring_hi[at]));
        hk_lo = mix4(hk_lo, rl, rh, 2u * r + 1u);
        hk_hi = mix4(hk_hi, rh, rl, 2u * r + 2u);
      }
      s_key[j] = hk_lo;
      s_key[blockDim.x + j] = hk_hi;
    }
    __syncthreads();
    if (live) {
      const uint32_t lo = s_key[j], hi = s_key[blockDim.x + j];
      for (int i = 0; i < j && !dup; ++i) dup = s_key[i] == lo && s_key[blockDim.x + i] == hi;
      if (dup) {
        logit_n = DEAD;
        last_n = -2 - (int64_t)j;
      }
    }
  }
  if (!live) return;

  if (a.flags != nullptr)
    a.flags[row] = (bnd ? FLAG_BND : 0) | (commit ? FLAG_COMMIT : 0) | (alive ? FLAG_ALIVE : 0) |
                   (dup ? FLAG_DUP : 0);
  const bool act = __ldg(&a.active[n]) != 0;
  store(a.parent_out, a.par_bytes, row, gate ? bp : (int64_t)j);
  store(a.token_out, a.tok_bytes, row, gate ? tok : (act ? -3 : -1));

  // ---- write the row: the replayed values, or on a gated row its own
  if (!gate) {
    a.o_text_lo[row] = __ldg(&a.text_lo[row]);
    a.o_text_hi[row] = __ldg(&a.text_hi[row]);
    a.o_p_lo[row] = __ldg(&a.p_lo[row]);
    a.o_p_hi[row] = __ldg(&a.p_hi[row]);
    a.o_p_len[row] = __ldg(&a.p_len[row]);
    a.o_last_tok[row] = __ldg(&a.last_tok[row]);
    a.o_n_words[row] = __ldg(&a.n_words[row]);
    a.o_force[row] = __ldg(&a.force[row]);
    a.o_logit[row] = __ldg(&a.logit[row]);
    a.o_fused[row] = __ldg(&a.fused[row]);
    for (int r = 0; r < a.ring; ++r) {
      a.o_ring_lo[row * a.ring + r] = __ldg(&a.ring_lo[row * a.ring + r]);
      a.o_ring_hi[row * a.ring + r] = __ldg(&a.ring_hi[row * a.ring + r]);
    }
    if (a.h_node != nullptr) {
      a.o_h_node[row] = __ldg(&a.h_node[row]);
      a.o_h_bits[row] = __ldg(&a.h_bits[row]);
    }
#pragma unroll
    for (int i = 0; i < MAX_MEMBERS; ++i) {  // unrolled: constant offsets into the launch struct
      if (i >= a.n_lms) break;
      const int w = a.m[i].w;
      a.m[i].o_p_node[row] = __ldg(&a.m[i].p_node[row]);
      a.m[i].o_p_flags[row] = __ldg(&a.m[i].p_flags[row]);
      a.m[i].o_ctx_len[row] = __ldg(&a.m[i].ctx_len[row]);
      for (int c = 0; c < w; ++c) {
        a.m[i].o_ctx[row * w + c] = __ldg(&a.m[i].ctx[row * w + c]);
        a.m[i].o_ctx_bo[row * w + c] = __ldg(&a.m[i].ctx_bo[row * w + c]);
      }
    }
    return;
  }
  a.o_text_lo[row] = text_lo_n;
  a.o_text_hi[row] = text_hi_n;
  a.o_p_lo[row] = p_lo_n;
  a.o_p_hi[row] = p_hi_n;
  a.o_p_len[row] = p_len_n;
  a.o_last_tok[row] = last_n;
  a.o_n_words[row] = n_words_n;
  a.o_force[row] = force_n ? 1 : 0;
  a.o_logit[row] = logit_n;
  a.o_fused[row] = fused_n;
  for (int r = 0; r < a.ring; ++r) {
    const bool from_word = shift && r + 1 == a.ring;
    const size_t at = prow * a.ring + (shift ? r + 1 : r);
    a.o_ring_lo[row * a.ring + r] = from_word ? __ldg(&a.p_lo[prow]) : __ldg(&a.ring_lo[at]);
    a.o_ring_hi[row * a.ring + r] = from_word ? __ldg(&a.p_hi[prow]) : __ldg(&a.ring_hi[at]);
  }
  if (a.h_ent != nullptr) {
    const int64_t h = __ldg(&a.h_ent[ent_at]);
    a.o_h_node[row] = h & a.hot_node_mask;
    a.o_h_bits[row] = h & ~a.hot_node_mask;
  }
#pragma unroll
  for (int i = 0; i < MAX_MEMBERS; ++i) {
    if (i >= a.n_lms) break;
    const int w = a.m[i].w;
    const int64_t e = __ldg(&a.m[i].ent[ent_at]);
    a.m[i].o_p_node[row] = e & a.node_mask;
    a.m[i].o_p_flags[row] = e & ~a.node_mask;
    // a boundary takes the commit's context, any other token keeps the parent's
    const int64_t* ctx = bnd ? a.m[i].cm_ctx : a.m[i].ctx;
    const float* ctx_bo = bnd ? a.m[i].cm_ctx_bo : a.m[i].ctx_bo;
    a.m[i].o_ctx_len[row] = bnd ? __ldg(&a.m[i].cm_ctx_len[prow]) : __ldg(&a.m[i].ctx_len[prow]);
    for (int c = 0; c < w; ++c) {
      a.m[i].o_ctx[row * w + c] = __ldg(&ctx[prow * w + c]);
      a.m[i].o_ctx_bo[row * w + c] = __ldg(&ctx_bo[prow * w + c]);
    }
  }
}

inline bool out_bytes_ok(int bytes) { return bytes == 1 || bytes == 2 || bytes == 4; }

}  // namespace

// sizeof(ReplayArgs), for the wrapper to check its ctypes mirror against.
extern "C" int replay_args_size() { return (int)sizeof(ReplayArgs); }

// args: the launch struct on the host; every plane on the stream's device,
// contiguous, shaped as ReplayArgs says. Refuses B outside [1, 1024], more
// than MAX_MEMBERS members and an output width other than 1, 2 or 4 bytes.
extern "C" int replay_winners_launch(const ReplayArgs* args, void* stream) {
  const ReplayArgs& a = *args;
  if (a.n < 1 || a.b < 1 || a.b > MAX_THREADS || a.k < 1 || a.m_stride < a.b || a.lmax < 0 ||
      a.ring < 1 || a.n_lms < 0 || a.n_lms > MAX_MEMBERS || !out_bytes_ok(a.par_bytes) ||
      !out_bytes_ok(a.tok_bytes))
    return (int)cudaErrorInvalidValue;
  const int threads = (a.b + 31) / 32 * 32;
  const size_t smem = a.prune_history ? 2 * (size_t)threads * sizeof(uint32_t) : 0;
  if (threads <= 256)
    replay_winners_kernel<256><<<a.n, threads, smem, (cudaStream_t)stream>>>(a);
  else
    replay_winners_kernel<MAX_THREADS><<<a.n, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
