// Block-diagonal candidate merge + window prune for the CTC beam-search step.
//
// Two kernels, both one thread block per utterance:
//
// * merge_prune_kernel — the merge of pre-keyed candidates [N, K, B]
//   (replaces the Pallas kernel behind merge_score_pallas);
// * expand_merge_prune_kernel — builds each candidate (k, i) from the [B]
//   parent planes and [K] token planes in registers (the 4-way CTC
//   transition, partial-word hash extension, merge keys, logits) and then
//   runs the same merge (replaces expand_merge_score_pallas). Candidate
//   planes never reach global memory.
//
// Per token column k the block stages the column's keys, validity and
// logits in shared memory; thread i scans the column for its collision
// group: group max, sum of exp(l_j - max), lowest member (first) and
// highest member (donor). A group-first member carries the group
// logsumexp plus its extra score, every other member is DEAD. After all
// columns the block reduces the utterance's max score and a second sweep
// over the thread's own outputs applies the window prune
// (score >= max + prune, else DEAD).
//
// Hash lanes arrive as int64 holding uint32 values (the PyTorch port's lane
// convention); all hash arithmetic is uint32 with wraparound. Built without
// fast math: expf/logf must track PyTorch's within the stated tolerance.
//
// Every launch function returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define DEAD (-1.0e30f)
#define DEAD_THRESH (-1.0e29f)

namespace {

__device__ __forceinline__ uint32_t mix4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  const uint32_t p = 0x01000193u;
  uint32_t h = (a * p) ^ b;
  h = (h * p) ^ c;
  return (h * p) ^ d;
}

struct Column {
  uint32_t* kl;
  uint32_t* kh;
  int* valid;
  float* logit;
};

__device__ __forceinline__ Column column_smem(unsigned char* smem, int b) {
  Column col;
  col.kl = reinterpret_cast<uint32_t*>(smem);
  col.kh = col.kl + b;
  col.valid = reinterpret_cast<int*>(col.kh + b);
  col.logit = reinterpret_cast<float*>(col.valid + b);
  return col;
}

// Merge result of candidate i of the staged column (caller: i < b, after a
// barrier that published the column). Invalid candidates join no group:
// merged = -inf, donor = 0, not a duplicate.
__device__ __forceinline__ void merge_member(const Column& col, int b, int i, float* merged,
                                             int* donor, bool* dup) {
  const bool vi = col.valid[i] != 0;
  if (!vi) {
    *merged = -INFINITY;
    *donor = 0;
    *dup = false;
    return;
  }
  const uint32_t ki = col.kl[i];
  const uint32_t hi = col.kh[i];
  float m = -INFINITY;
  int first = b;
  int last = -1;
  for (int j = 0; j < b; ++j) {
    if (col.valid[j] != 0 && col.kl[j] == ki && col.kh[j] == hi) {
      m = fmaxf(m, col.logit[j]);
      first = min(first, j);
      last = j;
    }
  }
  float tot = 0.0f;
  for (int j = 0; j < b; ++j) {
    if (col.valid[j] != 0 && col.kl[j] == ki && col.kh[j] == hi) {
      tot += expf(col.logit[j] - m);
    }
  }
  *merged = m + logf(tot);
  *donor = last;  // >= i: the candidate is its own group member
  *dup = first < i;
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

// Merge the staged column k, write its outputs and fold the thread's score
// into its running max. ``extra`` is candidate (k, i)'s extra score.
__device__ __forceinline__ void merge_column(const Column& col, int b, int k, size_t off,
                                             float extra, float* score, float* merged_out,
                                             int32_t* src, float* run_max) {
  const int i = threadIdx.x;
  if (i < b) {
    float merged;
    int donor;
    bool dup;
    merge_member(col, b, i, &merged, &donor, &dup);
    const bool rep = col.valid[i] != 0 && !dup;
    const float sc = rep ? merged + extra : DEAD;
    score[off] = sc;
    merged_out[off] = merged;
    src[off] = k * b + donor;
    *run_max = fmaxf(*run_max, sc);
  }
}

// Window prune over the thread's own outputs of utterance n.
__device__ __forceinline__ void window_prune(float run_max, float prune, float* red,
                                             float* score, size_t base, int k_cols, int b) {
  const float mx = block_max(run_max, red);
  const float thresh = mx + prune;
  const int i = threadIdx.x;
  if (i < b) {
    for (int k = 0; k < k_cols; ++k) {
      const size_t off = base + (size_t)k * b + i;
      if (!(score[off] >= thresh)) score[off] = DEAD;
    }
  }
}

__global__ void merge_prune_kernel(const int64_t* __restrict__ kl, const int64_t* __restrict__ kh,
                                   const int32_t* __restrict__ valid,
                                   const float* __restrict__ logit,
                                   const float* __restrict__ extra,
                                   const float* __restrict__ prune, float* __restrict__ score,
                                   float* __restrict__ merged, int32_t* __restrict__ src,
                                   int k_cols, int b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Column col = column_smem(smem, b);
  float* red = reinterpret_cast<float*>(smem + (size_t)b * 16);
  const int n = blockIdx.x;
  const int i = threadIdx.x;
  const size_t base = (size_t)n * k_cols * b;
  float run_max = -INFINITY;
  for (int k = 0; k < k_cols; ++k) {
    const size_t off = base + (size_t)k * b + i;
    float ex = 0.0f;
    if (i < b) {
      col.kl[i] = (uint32_t)kl[off];
      col.kh[i] = (uint32_t)kh[off];
      col.valid[i] = valid[off];
      col.logit[i] = logit[off];
      ex = extra[off];
    }
    __syncthreads();
    merge_column(col, b, k, off, ex, score, merged, src, &run_max);
    __syncthreads();
  }
  window_prune(run_max, prune[n], red, score, base, k_cols, b);
}

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

__global__ void expand_merge_prune_kernel(BeamPlanes beam, TokPlanes tok,
                                          const float* __restrict__ pscore,
                                          const float* __restrict__ prune,
                                          float* __restrict__ score, float* __restrict__ merged,
                                          int32_t* __restrict__ src, int n_utts, int k_cols,
                                          int b, int lmax, int is_bpe) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Column col = column_smem(smem, b);
  float* red = reinterpret_cast<float*>(smem + (size_t)b * 16);
  const int n = blockIdx.x;
  const int i = threadIdx.x;
  const size_t base = (size_t)n * k_cols * b;

  // parent beam i, held in registers across every token column
  uint32_t t_lo = 0, t_hi = 0, c_lo = 0, c_hi = 0, p_lo = 0, p_hi = 0;
  int32_t force_p = 0, last = 0;
  float fused = 0.0f, wfused = 0.0f, logit_p = DEAD;
  if (i < b) {
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
  const bool alive = logit_p > DEAD_THRESH;

  float run_max = -INFINITY;
  for (int k = 0; k < k_cols; ++k) {
    const size_t off = base + (size_t)k * b + i;
    const size_t ok = (size_t)n * k_cols + k;
    float ex = 0.0f;
    if (i < b) {
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
      col.kl[i] = mix4(text_lo_n, p_lo_n, p_hi_n, force_n);
      col.kh[i] = mix4(text_hi_n, p_hi_n, p_lo_n, force_n);
      col.valid[i] = (alive && tok.admit[ok] != 0) ? 1 : 0;
      col.logit[i] = alive ? logit_p + tok.tok_logp[ok] : DEAD;
      // (fused + word score at a boundary) + partial score: the engine's order
      ex = (fused + (bnd ? wfused : 0.0f)) + pscore[off];
    }
    __syncthreads();
    merge_column(col, b, k, off, ex, score, merged, src, &run_max);
    __syncthreads();
  }
  window_prune(run_max, prune[n], red, score, base, k_cols, b);
}

inline int block_threads(int b) { return ((b + 31) / 32) * 32; }

inline size_t smem_bytes(int b) { return (size_t)b * 16 + 32 * sizeof(float); }

}  // namespace

extern "C" int merge_prune_launch(const int64_t* kl, const int64_t* kh, const int32_t* valid,
                                  const float* logit, const float* extra, const float* prune,
                                  float* score, float* merged, int32_t* src, int n, int k, int b,
                                  void* stream) {
  merge_prune_kernel<<<n, block_threads(b), smem_bytes(b), (cudaStream_t)stream>>>(
      kl, kh, valid, logit, extra, prune, score, merged, src, k, b);
  return (int)cudaGetLastError();
}

extern "C" int expand_merge_prune_launch(
    const int64_t* text_lo, const int64_t* text_hi, const int64_t* cm_text_lo,
    const int64_t* cm_text_hi, const int64_t* p_lo, const int64_t* p_hi, const int32_t* force,
    const float* fused, const float* wfused, const float* logit, const int32_t* last_tok,
    const int32_t* tok, const int32_t* blank, const int32_t* boundary, const int32_t* right,
    const int64_t* seed_lo, const int64_t* seed_hi, const float* tok_logp, const int32_t* admit,
    const int32_t* cids, const float* pscore, const float* prune, float* score, float* merged,
    int32_t* src, int n, int k, int b, int lmax, int is_bpe, void* stream) {
  BeamPlanes beam = {text_lo, text_hi, cm_text_lo, cm_text_hi, p_lo,    p_hi,
                     force,   fused,   wfused,     logit,      last_tok};
  TokPlanes tk = {tok, blank, boundary, right, seed_lo, seed_hi, tok_logp, admit, cids};
  expand_merge_prune_kernel<<<n, block_threads(b), smem_bytes(b), (cudaStream_t)stream>>>(
      beam, tk, pscore, prune, score, merged, src, n, k, b, lmax, is_bpe);
  return (int)cudaGetLastError();
}
