// The engine step's trie walk and partial score: every candidate's trie
// entries and partial-word score, in one launch.
//
// Per candidate (utterance n, beam b, token column k): the transition class
// (a blank or a repeat of the beam's last token stays; a boundary token,
// or with a BPE alphabet any token after a right-bounded piece, starts a
// word), the packed entry (node | flag bits) each LM member's trie and the
// hotword trie reach (the beam's own where it stays, the token's piece seed
// at a boundary, else the beam's node walked over the label's letters: the
// first from the beam's fetched trie row, each later one from the trie
// plane), the partial word's length and its score (score_partial_token:
// the hotword completion score on a hotword prefix, else the members'
// averaged unknown-prefix penalty, scaled past AVG_TOKEN_LEN letters). The
// plain twin is ops/walk.py walk_partial_ref; the two agree to the bit:
// integer work, and the f32 operations rounded one by one (__fmul_rn,
// __fadd_rn, __fdiv_rn: no FMA contraction) in the order PyTorch's CUDA
// kernels run the twin's. PyTorch's CUDA true division by a host scalar
// multiplies by the scalar's f32 reciprocal (the AVG_TOKEN_LEN scaling and
// the members' mean); a division of two tensors divides (the hotword score).
//
// No Pallas kernel of the JAX reference computes this: there it is XLA's
// lowering of _make_step's partial-word extension walk (its engine.py:946
// onward), of _decode_trie_cells (:730) and of _partial_score (:794). The
// port ran it as ~40 small PyTorch launches a step for one-letter labels,
// and ~30 more for each further letter a label can have.
//
// What bounds it on the H100: launch latency and the chain of dependent
// loads a letter adds (the node a letter reaches is the next letter's
// address), not bytes. The design: one thread a candidate; a block is 32
// beam rows (a warp's lanes) by 8 token columns (its warps), so a warp
// walks one token over 32 beams: the letters and the loop bound are the
// token's own (a one-letter label stops after one level) and uniform over
// the warp, and the token's table entries are one broadcast load. Each
// level issues every member's and the hot trie's loads before reading any.
// The scores are written straight from the lanes ([N, K, B]: 32 consecutive
// beams); the entry planes ([N, B, K]) go through shared memory, so each
// beam row's 8 columns are written as one run. The member count is a
// template bound (1, 2, 4 or 8), so a one-member decode keeps one member's
// registers.
//
// Each member's slot geometry (its trie_pack: rank bits, cells a word, slots
// a plane row, slot stride) comes in the launch struct.
//
// The launch function returns the error of its launch (cudaSuccess = 0).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int MAX_MEMBERS = 8;  // ops/walk.py MAX_MEMBERS

// One LM member's planes and geometry. row: the beams' fetched trie slots
// [NB, row_w] (word 0 the first child, words 1.. the packed cells); plane:
// the trie plane [rows, plane_w], pack slots of stride words a row.
struct WalkMember {
  const int32_t* row;
  const int32_t* plane;
  const int64_t* p_node;   // [NB]
  const int64_t* p_flags;  // [NB]
  const int64_t* seed;     // [V]: the packed entry each token's piece seeds
  const float* unk_offset;  // device f32, or null: unk_offset_v
  int64_t* o_ent;          // [NB, K]
  int64_t dead;            // the dead node id
  float unk_offset_v;
  int row_w, plane_w, rb, cpw, pack, stride;
};

// Field for field the ctypes struct _WalkArgs of ops/walk.py.
struct WalkArgs {
  WalkMember m[MAX_MEMBERS];
  const int64_t* toks;      // [N, K]
  const int64_t* last_tok;  // [NB]
  const uint8_t* force;     // [NB]
  const int64_t* p_len;     // [NB]
  const int64_t* h_node;    // [NB], null without hotwords
  const int64_t* h_bits;    // [NB]
  const int64_t* hot_next;  // [hot nodes, hot_c]: packed hot entries
  const int64_t* hot_seed;  // [V]
  const float* hot_weight;  // device f32, or null: hot_weight_v
  // token tables [V] (raw_chars [V, lmax], -1 past a label's end)
  const int64_t* kind;
  const int64_t* piece_len;
  const int64_t* raw_len;
  const int64_t* raw_chars;
  int64_t* o_h_ent;  // [NB, K], null without hotwords
  float* o_pscore;   // [N, K, B]
  int64_t node_mask, hot_node_mask, hot_dead, bit_uni_prefix;
  float hot_weight_v;
  int n, b, k, lmax, hot_c, n_lms, is_bpe;
};

namespace {

constexpr int TILE_R = 32;  // beam rows a block: a warp's lanes
constexpr int TILE_K = 8;   // token columns a block: its warps
constexpr int64_t KIND_BLANK = 0, KIND_BOUNDARY = 1;  // ops/tokens.py
constexpr int64_t AVG_TOKEN_LEN = 6;                 // constants.py
constexpr int HOT_MINCOMP_SHIFT = 20;                // models/device_tables.py
constexpr int64_t HOT_MINCOMP_MAX = 1023;

__device__ __forceinline__ float scalar(const float* dev, float v) { return dev ? __ldg(dev) : v; }

// A packed trie cell -> the packed child entry (first_child + rank | flags
// << 28), or the dead node where the rank is all ones (no child).
__device__ __forceinline__ int64_t child_entry(const WalkMember& m, int32_t fc, int32_t word, uint32_t cid) {
  const int bpc = m.rb + 3;
  const uint64_t cell = ((uint64_t)(uint32_t)word >> ((cid % (uint32_t)m.cpw) * bpc)) & ((1ull << bpc) - 1ull);
  const int64_t none = (int64_t)((1ull << m.rb) - 1ull);
  const int64_t rank = (int64_t)cell & none;
  const int64_t flags3 = (int64_t)(cell >> m.rb) & 7;
  return rank == none ? m.dead : (((int64_t)fc + rank) | (flags3 << 28));
}

// Input planes are read through the read-only path (__ldg): nothing the
// kernel writes aliases them. Index arithmetic divides in 32 bits (node ids
// are below 2^28, beam rows below 2^31): a 64-bit division is a call, and
// its spills would cost the 8-member instance its registers.
template <int NM>
__global__ void __launch_bounds__(TILE_R * TILE_K) walk_partial_kernel(const WalkArgs a) {
  __shared__ int64_t s_ent[NM + 1][TILE_R][TILE_K + 1];  // the hot entries last; +1: no bank conflicts
  const int x = threadIdx.x, y = threadIdx.y;
  const long long nb = (long long)a.n * a.b;
  const long long r = (long long)blockIdx.x * TILE_R + x;  // beam row n * B + b
  const int kc = blockIdx.y * TILE_K + y;                  // token column
  const bool hot = a.h_node != nullptr;

  if (r < nb && kc < a.k) {
    const long long n = (unsigned)r / (unsigned)a.b;
    const int64_t tok = __ldg(&a.toks[n * a.k + kc]);
    const int64_t kind = __ldg(&a.kind[tok]);
    const int64_t p_len = __ldg(&a.p_len[r]);
    const bool stay = kind == KIND_BLANK || __ldg(&a.last_tok[r]) == tok;
    const bool bnd = !stay && (kind == KIND_BOUNDARY || (a.is_bpe && __ldg(&a.force[r]) != 0));

    int64_t ent[NM];
    int64_t h = 0;
    int64_t plen;
#pragma unroll
    for (int i = 0; i < NM; ++i) {  // unrolled: constant offsets into the launch struct
      if (i >= a.n_lms) break;
      ent[i] = bnd ? __ldg(&a.m[i].seed[tok]) : (__ldg(&a.m[i].p_node[r]) | __ldg(&a.m[i].p_flags[r]));
    }
    if (hot) h = bnd ? __ldg(&a.hot_seed[tok]) : (__ldg(&a.h_node[r]) | __ldg(&a.h_bits[r]));
    if (stay) {
      plen = p_len;
    } else if (bnd) {
      plen = __ldg(&a.piece_len[tok]);
    } else {
      // the extension walk over the label's letters; an entry stays put past the label's end
      const int64_t raw_len = __ldg(&a.raw_len[tok]);
      plen = p_len + raw_len;
      const int len = raw_len < a.lmax ? (int)raw_len : a.lmax;
      for (int l = 0; l < len; ++l) {
        const int64_t c = __ldg(&a.raw_chars[tok * a.lmax + l]);
        if (c < 0) continue;
        const uint32_t cid = (uint32_t)c;
        int32_t fc[NM], word[NM];
        int64_t hv = 0;
#pragma unroll
        for (int i = 0; i < NM; ++i) {  // every load of the level issued before any is read
          if (i >= a.n_lms) break;
          const WalkMember& m = a.m[i];
          const int32_t* slot;
          if (l == 0) {  // the first letter from the beam's own fetched slot
            slot = m.row + r * m.row_w;
          } else {
            const uint32_t node = (uint32_t)(ent[i] & a.node_mask);
            const uint32_t pack = (uint32_t)m.pack;
            slot = m.plane + (long long)(node / pack) * m.plane_w + (node % pack) * (uint32_t)m.stride;
          }
          fc[i] = __ldg(slot);
          word[i] = __ldg(slot + 1 + cid / (uint32_t)m.cpw);
        }
        if (hot) {
          const int64_t hn = l == 0 ? __ldg(&a.h_node[r]) : (h & a.hot_node_mask);
          hv = __ldg(&a.hot_next[hn * a.hot_c + (int64_t)cid]);
        }
#pragma unroll
        for (int i = 0; i < NM; ++i) {
          if (i >= a.n_lms) break;
          ent[i] = child_entry(a.m[i], fc[i], word[i], cid);
        }
        if (hot) h = hv;
      }
    }

    // the partial score, rounded as the twin's PyTorch kernels round it
    const float plen_f = (float)plen;
    float score = 0.0f;
    if (a.n_lms > 0) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        if (i >= a.n_lms) break;
        const bool pref = (ent[i] & a.bit_uni_prefix) != 0;
        float punk = __fmul_rn(scalar(a.m[i].unk_offset, a.m[i].unk_offset_v), pref ? 0.0f : 1.0f);
        if (plen > AVG_TOKEN_LEN)
          punk = __fmul_rn(__fmul_rn(punk, plen_f), __fdiv_rn(1.0f, (float)AVG_TOKEN_LEN));
        acc = i == 0 ? punk : __fadd_rn(acc, punk);
      }
      if (a.n_lms > 1) acc = __fmul_rn(acc, __fdiv_rn(1.0f, (float)a.n_lms));
      score = plen > 0 ? acc : 0.0f;
    }
    if (hot && (h & a.hot_node_mask) != a.hot_dead && plen > 0) {
      int64_t min_comp = (h >> HOT_MINCOMP_SHIFT) & HOT_MINCOMP_MAX;
      if (min_comp < 1) min_comp = 1;
      score = __fdiv_rn(__fmul_rn(scalar(a.hot_weight, a.hot_weight_v), plen_f), (float)min_comp);
    }
    a.o_pscore[(n * a.k + kc) * a.b + (r - n * a.b)] = score;
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      if (i >= a.n_lms) break;
      s_ent[i][x][y] = ent[i];
    }
    if (hot) s_ent[NM][x][y] = h;
  }
  __syncthreads();

  // the entry planes, each beam row's TILE_K columns in one run
  const int t = y * TILE_R + x;
  const int xr = t / TILE_K, yk = t % TILE_K;
  const long long r2 = (long long)blockIdx.x * TILE_R + xr;
  const int k2 = blockIdx.y * TILE_K + yk;
  if (r2 >= nb || k2 >= a.k) return;
  const long long at = r2 * a.k + k2;
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    if (i >= a.n_lms) break;
    a.m[i].o_ent[at] = s_ent[i][xr][yk];
  }
  if (hot) a.o_h_ent[at] = s_ent[NM][xr][yk];
}

template <int NM>
void launch(const WalkArgs& a, cudaStream_t stream) {
  const long long nb = (long long)a.n * a.b;
  const dim3 grid((unsigned)((nb + TILE_R - 1) / TILE_R), (unsigned)((a.k + TILE_K - 1) / TILE_K));
  walk_partial_kernel<NM><<<grid, dim3(TILE_R, TILE_K), 0, stream>>>(a);
}

}  // namespace

// sizeof(WalkArgs), for the wrapper to check its ctypes mirror against.
extern "C" int walk_args_size() { return (int)sizeof(WalkArgs); }

// args: the launch struct on the host; every plane on the stream's device,
// contiguous, shaped as WalkArgs says. Refuses an empty step, 2^31 beam rows
// or more, more than MAX_MEMBERS members, a slot geometry that cannot be a
// trie_pack's, more token columns than the grid holds, and hotwords without
// a hot trie.
extern "C" int walk_partial_launch(const WalkArgs* args, void* stream) {
  const WalkArgs& a = *args;
  if (a.n < 1 || a.b < 1 || a.k < 1 || a.k > 65535 * TILE_K || a.lmax < 1 || a.n_lms < 0 ||
      a.n_lms > MAX_MEMBERS || (long long)a.n * a.b > 0x7fffffffLL - TILE_R)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < a.n_lms; ++i) {
    const WalkMember& m = a.m[i];
    if (m.rb < 1 || m.rb > 28 || m.cpw < 1 || m.pack < 1 || m.stride < 2 || m.row_w < 2 ||
        m.plane_w < m.pack * m.stride)
      return (int)cudaErrorInvalidValue;
  }
  if (a.h_node != nullptr && (a.hot_next == nullptr || a.hot_c < 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (a.n_lms <= 1)
    launch<1>(a, s);
  else if (a.n_lms <= 2)
    launch<2>(a, s);
  else if (a.n_lms <= 4)
    launch<4>(a, s);
  else
    launch<MAX_MEMBERS>(a, s);
  return (int)cudaGetLastError();
}
