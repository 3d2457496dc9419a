// Block-diagonal candidate merge + window prune for the CTC beam-search step.
//
// Two kernels over one shared column merge:
//
// * merge_prune_kernel — the merge of pre-keyed candidates [N, K, B]
//   (replaces the Pallas kernel behind merge_score_pallas);
// * expand_merge_prune_kernel — builds each candidate (k, i) from the [B]
//   parent planes and [K] token planes in registers (the 4-way CTC
//   transition, partial-word hash extension, merge keys, logits) and then
//   runs the same merge (replaces expand_merge_score_pallas). Candidate
//   planes never reach global memory.
//
// What bounds them on the H100: neither bytes nor arithmetic (both bounds
// are about a microsecond at the decode shapes) but how much of the card a
// launch occupies and how long one column's collision scan takes. The
// design spreads the columns and shortens the scan:
//
// * The work unit is one (utterance, token column): columns never interact
//   in the merge. The blocks of one utterance form a thread-block cluster
//   (1, 2, 4 or 8 blocks, picked from K); block r owns columns r, r + C,
//   r + 2C, ... and merges up to 1024 / B of them at once, one group of
//   warps per column (32 x 8 blocks of 4 columns at N = 32, K = 29,
//   B = 100, where the first design ran 32 blocks of one column).
// * Per column the group stages each candidate's two 32-bit keys as one
//   64-bit word, its logit, and a ballot bitmask of the valid candidates.
//   Thread i scans 32 candidates at a time: one broadcast shared-memory
//   load and one compare each, collected into a hit bitmask that is kept
//   (in shared memory) for the second sweep. Group max, first and newest
//   member, and the sum of exp(l_j - max) then visit set bits only, the sum
//   in ascending candidate order by the one thread that owns the member, so
//   the result is deterministic. No float atomics, no fast math.
// * The only value shared across an utterance is the max score behind the
//   window prune. Each block reduces its own with warp shuffles, publishes
//   it in its shared memory, and reads the other blocks' through
//   distributed shared memory after a cluster barrier; a max is exact in
//   any order. Scores wait for it in a shared-memory stash, so score,
//   merged and src are each written once and nothing is read back from
//   global memory. (A shape whose stash does not fit beside the staging
//   buffers, far above the decode's, stashes in the score output itself and
//   rewrites the pruned entries.)
// * Tensor cores have no work here: there is no product, only compares, a
//   max and a short sum. Asynchronous copies have none at the decode
//   shapes either: a block merges all its columns in one pass, so there is
//   no next column to stage behind the current one, and every input is
//   read exactly once, coalesced, straight into registers.
//
// Hash lanes arrive as int64 holding uint32 values (the PyTorch port's lane
// convention); all hash arithmetic is uint32 with wraparound. Built without
// fast math: expf/logf must track PyTorch's within the stated tolerance.
//
// Every launch function returns the error of its launch (cudaSuccess = 0).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define DEAD (-1.0e30f)
#define DEAD_THRESH (-1.0e29f)

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
// dynamic shared memory a block may ask for (227 KB opt-in), less the
// kernels' static arrays
constexpr size_t SMEM_LIMIT = 232448 - 1024;

__device__ __forceinline__ uint32_t mix4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  const uint32_t p = 0x01000193u;
  uint32_t h = (a * p) ^ b;
  h = (h * p) ^ c;
  return (h * p) ^ d;
}

// How a launch cuts [N, K, B] into clusters, blocks and warp groups.
struct Plan {
  int k_cols;
  int b;
  int bt;              // B rounded up to whole warps: threads of one column group
  int groups;          // column groups of a block (columns merged at once)
  int cols_per_block;  // columns a block owns (the last ones may not exist)
  int stash_global;    // the score stash does not fit in shared memory
};

// One candidate as the column merge sees it.
struct Candidate {
  uint64_t key = 0;
  bool valid = false;
  float logit = DEAD;
  float extra = 0.0f;
};

// Candidates already keyed in global memory, [N, K, B] (merge_prune).
struct KeyedSource {
  const int64_t* kl;
  const int64_t* kh;
  const int32_t* valid;
  const float* logit;
  const float* extra;

  __device__ __forceinline__ void init(int, int, int) {}

  __device__ __forceinline__ Candidate load(size_t off, int, int, int) const {
    Candidate c;
    c.key = ((uint64_t)(uint32_t)kh[off] << 32) | (uint64_t)(uint32_t)kl[off];
    c.valid = valid[off] != 0;
    c.logit = logit[off];
    c.extra = extra[off];
    return c;
  }
};

struct BeamPlanes {  // [N, B]
  const int64_t* text_lo;
  const int64_t* text_hi;
  const int64_t* cm_text_lo;
  const int64_t* cm_text_hi;
  const int64_t* p_lo;
  const int64_t* p_hi;
  const int32_t* force;
  const float* fused;
  const float* wfused;
  const float* logit;
  const int32_t* last_tok;
};

struct TokPlanes {  // [N, K]
  const int32_t* tok;
  const int32_t* blank;
  const int32_t* boundary;
  const int32_t* right;
  const int64_t* seed_lo;
  const int64_t* seed_hi;
  const float* tok_logp;
  const int32_t* admit;
  const int32_t* cids;  // [lmax, N, K], -1 past the label's end
};

// Candidates built from parent beam i (held in registers across the
// thread's columns) and token column k (expand_merge_prune).
struct ExpandSource {
  BeamPlanes beam;
  TokPlanes tok;
  const float* pscore;  // [N, K, B]
  int n_utts;
  int lmax;
  int is_bpe;

  uint32_t t_lo = 0, t_hi = 0, c_lo = 0, c_hi = 0, p_lo = 0, p_hi = 0;
  int32_t force_p = 0, last = 0;
  float fused = 0.0f, wfused = 0.0f, logit_p = DEAD;

  __device__ __forceinline__ void init(int n, int i, int b) {
    const size_t ob = (size_t)n * b + i;
    t_lo = (uint32_t)beam.text_lo[ob];
    t_hi = (uint32_t)beam.text_hi[ob];
    c_lo = (uint32_t)beam.cm_text_lo[ob];
    c_hi = (uint32_t)beam.cm_text_hi[ob];
    p_lo = (uint32_t)beam.p_lo[ob];
    p_hi = (uint32_t)beam.p_hi[ob];
    force_p = beam.force[ob];
    fused = beam.fused[ob];
    wfused = beam.wfused[ob];
    logit_p = beam.logit[ob];
    last = beam.last_tok[ob];
  }

  __device__ __forceinline__ Candidate load(size_t off, int n, int k, int k_cols) const {
    const size_t ok = (size_t)n * k_cols + k;
    const bool alive = logit_p > DEAD_THRESH;
    const bool stay = tok.blank[ok] != 0 || last == tok.tok[ok];
    const bool bnd_tok = tok.boundary[ok] != 0;
    const bool bnd = !stay && (is_bpe ? (bnd_tok || force_p != 0) : bnd_tok);
    uint32_t ext_lo = p_lo, ext_hi = p_hi;
    for (int l = 0; l < lmax; ++l) {
      const int32_t cid = tok.cids[((size_t)l * n_utts + n) * k_cols + k];
      if (cid >= 0) {
        ext_lo = ext_lo * 31u + (uint32_t)cid + 1u;
        ext_hi = ext_hi * 1000003u + (uint32_t)cid + 1u;
      }
    }
    const uint32_t p_lo_n = stay ? p_lo : (bnd ? (uint32_t)tok.seed_lo[ok] : ext_lo);
    const uint32_t p_hi_n = stay ? p_hi : (bnd ? (uint32_t)tok.seed_hi[ok] : ext_hi);
    const uint32_t text_lo_n = bnd ? c_lo : t_lo;
    const uint32_t text_hi_n = bnd ? c_hi : t_hi;
    const uint32_t force_n = (uint32_t)(bnd ? tok.right[ok] : force_p);
    Candidate c;
    c.key = ((uint64_t)mix4(text_hi_n, p_hi_n, p_lo_n, force_n) << 32) |
            (uint64_t)mix4(text_lo_n, p_lo_n, p_hi_n, force_n);
    c.valid = alive && tok.admit[ok] != 0;
    c.logit = alive ? logit_p + tok.tok_logp[ok] : DEAD;
    // (fused + word score at a boundary) + partial score: the engine's order
    c.extra = (fused + (bnd ? wfused : 0.0f)) + pscore[off];
    return c;
  }
};

// Hit bitmask of candidates [32 w, 32 w + 32) of a staged column against
// ``key``: one broadcast load and one compare per candidate.
__device__ __forceinline__ uint32_t scan_word(const uint64_t* keys, int w, uint64_t key) {
  const uint64_t* base = keys + (w << 5);
  uint32_t hit = 0;
#pragma unroll
  for (int t = 0; t < 32; ++t) hit |= (uint32_t)(base[t] == key) << t;
  return hit;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int n_warps = (blockDim.x + 31) >> 5;
  if (warp == 0) {
    v = lane < n_warps ? red[lane] : -INFINITY;
    for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// The body of both kernels. Grid: N clusters of ``C`` blocks; block ``rank``
// of utterance ``n`` owns columns rank + c * C, c < cols_per_block; its
// thread (g, i) merges candidate i of the column that group g holds in the
// current pass. Shared memory: per group the staged keys, logits and valid
// bitmask; per thread its hit words; the block's score stash.
template <class Source>
__device__ __forceinline__ void merge_columns(Source& cand, const float* __restrict__ prune,
                                              float* __restrict__ score,
                                              float* __restrict__ merged,
                                              int32_t* __restrict__ src, const Plan& plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  __shared__ float block_mx;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n = blockIdx.x / csize;
  const int b = plan.b, bt = plan.bt, k_cols = plan.k_cols;
  const int nw = bt >> 5;
  const int g = threadIdx.x / bt;
  const int i = threadIdx.x - g * bt;
  const size_t base = (size_t)n * k_cols * b;

  // carve (launch() sizes the same layout): keys u64 [groups][bt], logits
  // f32 [groups][bt], valid words u32 [groups][nw], hit words u32
  // [nw][threads], stash f32 [cols_per_block][bt]
  const size_t n_thr = blockDim.x;
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem) + (size_t)g * bt;
  float* logits = reinterpret_cast<float*>(smem + n_thr * 8) + (size_t)g * bt;
  uint32_t* vmask_all = reinterpret_cast<uint32_t*>(smem + n_thr * 12);
  uint32_t* vmask = vmask_all + g * nw;
  uint32_t* hits = vmask_all + plan.groups * nw + threadIdx.x;  // word w at hits[w * n_thr]
  float* stash = reinterpret_cast<float*>(vmask_all + plan.groups * nw + n_thr * nw);
  size_t stash_stride = bt;
  if (plan.stash_global) {
    stash = score + base + (size_t)rank * b;
    stash_stride = (size_t)csize * b;
  }

  if (i < b) cand.init(n, i, b);
  float run_max = -INFINITY;
  for (int c0 = 0; c0 < plan.cols_per_block; c0 += plan.groups) {
    const int c = c0 + g;
    const int k = rank + c * csize;
    const bool mine = c < plan.cols_per_block && k < k_cols && i < b;
    const size_t off = base + (size_t)k * b + i;
    Candidate me;
    if (mine) me = cand.load(off, n, k, k_cols);
    keys[i] = me.key;
    logits[i] = me.logit;
    const uint32_t ballot = __ballot_sync(0xffffffffu, me.valid);
    if ((i & 31) == 0) vmask[i >> 5] = ballot;
    __syncthreads();
    if (mine) {
      // invalid candidates join no group: merged = -inf, donor = 0, not a duplicate
      float mrg = -INFINITY;
      int donor = 0;
      bool dup = false;
      if (me.valid) {
        float m = -INFINITY;
        int first = i;
        for (int w = 0; w < nw; ++w) {
          const uint32_t live = vmask[w];
          uint32_t hit = live ? (scan_word(keys, w, me.key) & live) : 0u;
          hits[(size_t)w * n_thr] = hit;
          if (hit) {
            first = min(first, (w << 5) + __ffs(hit) - 1);
            donor = (w << 5) + 31 - __clz(hit);  // newest member: the last set bit so far
            for (; hit; hit &= hit - 1) m = fmaxf(m, logits[(w << 5) + __ffs(hit) - 1]);
          }
        }
        float tot = 0.0f;
        for (int w = 0; w < nw; ++w) {
          for (uint32_t hit = hits[(size_t)w * n_thr]; hit; hit &= hit - 1)
            tot += expf(logits[(w << 5) + __ffs(hit) - 1] - m);
        }
        mrg = m + logf(tot);
        dup = first < i;
      }
      const float sc = (me.valid && !dup) ? mrg + me.extra : DEAD;
      merged[off] = mrg;
      src[off] = k * b + donor;
      stash[(size_t)c * stash_stride + i] = sc;
      run_max = fmaxf(run_max, sc);
    }
    __syncthreads();  // the next pass restages the group's column
  }

  // the utterance's max: this block's, then the cluster's through
  // distributed shared memory
  float mx = block_max(run_max, red);
  if (csize > 1) {
    if (threadIdx.x == 0) block_mx = mx;
    cluster.sync();
    for (int r = 0; r < csize; ++r) mx = fmaxf(mx, *cluster.map_shared_rank(&block_mx, r));
  }
  const float thresh = mx + prune[n];
  for (int c0 = 0; c0 < plan.cols_per_block; c0 += plan.groups) {
    const int c = c0 + g;
    const int k = rank + c * csize;
    if (c < plan.cols_per_block && k < k_cols && i < b) {
      const float sc = stash[(size_t)c * stash_stride + i];
      if (!plan.stash_global)
        score[base + (size_t)k * b + i] = sc >= thresh ? sc : DEAD;
      else if (!(sc >= thresh))
        score[base + (size_t)k * b + i] = DEAD;
    }
  }
  // no block may exit while another still reads its shared memory
  if (csize > 1) cluster.sync();
}

__global__ void __launch_bounds__(MAX_THREADS)
    merge_prune_kernel(KeyedSource cand, const float* __restrict__ prune,
                       float* __restrict__ score, float* __restrict__ merged,
                       int32_t* __restrict__ src, Plan plan) {
  merge_columns(cand, prune, score, merged, src, plan);
}

__global__ void __launch_bounds__(MAX_THREADS)
    expand_merge_prune_kernel(ExpandSource cand, const float* __restrict__ prune,
                              float* __restrict__ score, float* __restrict__ merged,
                              int32_t* __restrict__ src, Plan plan) {
  merge_columns(cand, prune, score, merged, src, plan);
}

// Cluster size for K columns: the smallest of 1, 2, 4, 8 that gives every
// column a block of its own, 8 from K = 5 up.
inline int pick_cluster(int k) {
  int c = 1;
  while (c < k && c < MAX_CLUSTER) c <<= 1;
  return c;
}

template <class Source>
int launch(void (*kernel)(Source, const float*, float*, float*, int32_t*, Plan), Source cand,
           const float* prune, float* score, float* merged, int32_t* src, int n, int k, int b,
           int cluster, cudaStream_t stream) {
  if (cluster == 0) cluster = pick_cluster(k);
  if (b < 1 || b > MAX_THREADS || (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.k_cols = k;
  plan.b = b;
  plan.bt = ((b + 31) / 32) * 32;
  plan.cols_per_block = (k + cluster - 1) / cluster;
  plan.groups = MAX_THREADS / plan.bt;
  if (plan.groups > plan.cols_per_block) plan.groups = plan.cols_per_block;
  const int threads = plan.groups * plan.bt;
  const int nw = plan.bt / 32;
  size_t bytes = (size_t)threads * 12 + (size_t)plan.groups * nw * 4 + (size_t)threads * nw * 4;
  const size_t stash = (size_t)plan.cols_per_block * plan.bt * 4;
  plan.stash_global = bytes + stash > SMEM_LIMIT;
  if (!plan.stash_global) bytes += stash;
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, cand, prune, score, merged, src, plan);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// ``cluster``: blocks per utterance, 1, 2, 4 or 8; 0 picks it from K.
extern "C" int merge_prune_launch(const int64_t* kl, const int64_t* kh, const int32_t* valid,
                                  const float* logit, const float* extra, const float* prune,
                                  float* score, float* merged, int32_t* src, int n, int k, int b,
                                  int cluster, void* stream) {
  KeyedSource cand = {kl, kh, valid, logit, extra};
  return launch(merge_prune_kernel, cand, prune, score, merged, src, n, k, b, cluster,
                (cudaStream_t)stream);
}

extern "C" int expand_merge_prune_launch(
    const int64_t* text_lo, const int64_t* text_hi, const int64_t* cm_text_lo,
    const int64_t* cm_text_hi, const int64_t* p_lo, const int64_t* p_hi, const int32_t* force,
    const float* fused, const float* wfused, const float* logit, const int32_t* last_tok,
    const int32_t* tok, const int32_t* blank, const int32_t* boundary, const int32_t* right,
    const int64_t* seed_lo, const int64_t* seed_hi, const float* tok_logp, const int32_t* admit,
    const int32_t* cids, const float* pscore, const float* prune, float* score, float* merged,
    int32_t* src, int n, int k, int b, int lmax, int is_bpe, int cluster, void* stream) {
  ExpandSource cand;
  cand.beam = {text_lo, text_hi, cm_text_lo, cm_text_hi, p_lo,    p_hi,
               force,   fused,   wfused,     logit,      last_tok};
  cand.tok = {tok, blank, boundary, right, seed_lo, seed_hi, tok_logp, admit, cids};
  cand.pscore = pscore;
  cand.n_utts = n;
  cand.lmax = lmax;
  cand.is_bpe = is_bpe;
  return launch(expand_merge_prune_kernel, cand, prune, score, merged, src, n, k, b, cluster,
                (cudaStream_t)stream);
}
