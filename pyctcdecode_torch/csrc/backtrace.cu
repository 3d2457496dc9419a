// The batch decode's device backtrace: each ranked beam's token path, from
// the last frame back to the first, through the decode's backpointer logs.
//
//   cur = src[n, r];  for t = T-1 .. 0:  paths[n, r, t] = trace[n, t, cur];
//                                          cur = parents[n, t, cur]
//
// No Pallas kernel of the JAX reference computes this: there it is a
// lax.scan(back, ..., reverse=True) inside the compiled finalize program
// (its engine.py, make_segment_decode_fns' fin_fn), which XLA lowers. The
// port's finalize is a captured CUDA graph of a fixed shape, but the logs'
// length T changes with every batch, so the backtrace is one launch of this
// kernel after the finalize's replay (four small launches a frame before).
//
// What bounds it on the H100: by the roofline, bytes (the logs read once,
// the paths written once: a few MB at the decode's shapes, about a
// microsecond); in fact the chain's latency. Each frame's index depends on
// the last frame's read, so a thread makes T dependent reads, and reading
// them from device memory would cost T memory latencies. The design: one
// block per utterance, one thread per ranked beam (chain), at least 256
// threads. The block stages a tile of TT frames of both logs ([TT, B] each)
// into shared memory with coalesced loads (16-byte vectors where the tile's
// address and size allow, else 4-byte words, else bytes), walks every chain
// through the tile in shared memory, stages the tile's paths [R, TT] there
// too, and writes them out row by row, coalesced. So the chain pays one
// memory latency a tile, not a frame. TT is picked by the host to fit 48 KB
// of shared memory.
//
// Values are copied as they are: -1 at padded and inactive frames, and the
// timeline's -3 carry marker (whose parents are the identity). Parents and
// paths keep the engine's narrow types (int8 / int16 / int32 each, one
// instantiation a pair). src is int64 [N, R], every entry in [0, B).
//
// The launch function returns the error of its launch (cudaSuccess = 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TILE = 64;            // frames a tile
constexpr int SMEM_BYTES = 48 * 1024;   // static-size limit: no attribute call needed
constexpr int MAX_THREADS = 1024;
constexpr int MIN_THREADS = 256;  // the tiles' loaders, whatever the number of chains

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// Copy `bytes` from device memory to shared memory (`dst` 16-byte aligned)
// with the widest unit the source address and the size allow.
__device__ inline void stage(unsigned char* dst, const unsigned char* src, size_t bytes) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(src);
  if (at % 16 == 0 && bytes % 16 == 0) {
    for (size_t i = threadIdx.x; i < bytes / 16; i += blockDim.x)
      reinterpret_cast<int4*>(dst)[i] = reinterpret_cast<const int4*>(src)[i];
  } else if (at % 4 == 0 && bytes % 4 == 0) {
    for (size_t i = threadIdx.x; i < bytes / 4; i += blockDim.x)
      reinterpret_cast<int*>(dst)[i] = reinterpret_cast<const int*>(src)[i];
  } else {
    for (size_t i = threadIdx.x; i < bytes; i += blockDim.x) dst[i] = src[i];
  }
}

template <typename P, typename Q>
__global__ void backtrace_paths_kernel(const P* __restrict__ parents, const Q* __restrict__ trace,
                                       const int64_t* __restrict__ src, Q* __restrict__ paths,
                                       int t_max, int b, int r_max, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  P* s_par = reinterpret_cast<P*>(smem);                                         // [tile, b]
  Q* s_tok = reinterpret_cast<Q*>(smem + align16(sizeof(P) * tile * b));         // [tile, b]
  Q* s_out = reinterpret_cast<Q*>(reinterpret_cast<unsigned char*>(s_tok) +
                                  align16(sizeof(Q) * tile * b));                // [r_max, ostride]
  // a chain's row of the tile's paths, padded by one 4-byte word: an odd
  // word stride, so the chains' writes fall in distinct banks
  const int ostride = tile + 4 / (int)sizeof(Q);
  const int n = blockIdx.x;
  const int r = threadIdx.x;
  const size_t log_base = (size_t)n * t_max * b;
  Q* out_n = paths + (size_t)n * r_max * t_max;
  int cur = r < r_max ? (int)src[(size_t)n * r_max + r] : 0;
  for (int end = t_max; end > 0; end -= tile) {
    const int t0 = end > tile ? end - tile : 0;
    const int len = end - t0;
    const size_t base = log_base + (size_t)t0 * b;
    __syncthreads();  // the last tile's readers and writers are done
    stage(reinterpret_cast<unsigned char*>(s_par), reinterpret_cast<const unsigned char*>(parents + base),
          sizeof(P) * (size_t)len * b);
    stage(reinterpret_cast<unsigned char*>(s_tok), reinterpret_cast<const unsigned char*>(trace + base),
          sizeof(Q) * (size_t)len * b);
    __syncthreads();
    if (r < r_max) {
      for (int j = len - 1; j >= 0; --j) {
        s_out[r * ostride + j] = s_tok[j * b + cur];
        cur = (int)s_par[j * b + cur];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < r_max * len; i += blockDim.x) {
      const int rr = i / len, j = i - rr * len;
      out_n[(size_t)rr * t_max + t0 + j] = s_out[rr * ostride + j];
    }
  }
}

template <typename P, typename Q>
int launch(const void* parents, const void* trace, const int64_t* src, void* paths, int n, int t_max,
           int b, int r_max, cudaStream_t stream) {
  const size_t per_frame = (size_t)b * (sizeof(P) + sizeof(Q)) + (size_t)r_max * sizeof(Q);
  int tile = (int)((SMEM_BYTES - 64 - 4 * (size_t)r_max) / per_frame);
  if (tile > MAX_TILE) tile = MAX_TILE;
  if (tile < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = align16(sizeof(P) * tile * b) + align16(sizeof(Q) * tile * b) +
                      sizeof(Q) * (size_t)r_max * tile + 4 * (size_t)r_max;
  int threads = ((r_max > MIN_THREADS ? r_max : MIN_THREADS) + 31) / 32 * 32;
  if (threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
  backtrace_paths_kernel<P, Q><<<n, threads, smem, stream>>>(
      static_cast<const P*>(parents), static_cast<const Q*>(trace), src, static_cast<Q*>(paths),
      t_max, b, r_max, tile);
  return (int)cudaGetLastError();
}

template <typename P>
int launch_tok(int tok_bytes, const void* parents, const void* trace, const int64_t* src, void* paths,
               int n, int t_max, int b, int r_max, cudaStream_t stream) {
  switch (tok_bytes) {
    case 1: return launch<P, int8_t>(parents, trace, src, paths, n, t_max, b, r_max, stream);
    case 2: return launch<P, int16_t>(parents, trace, src, paths, n, t_max, b, r_max, stream);
    case 4: return launch<P, int32_t>(parents, trace, src, paths, n, t_max, b, r_max, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// parents: int{8,16,32} [n, t_max, b] (par_bytes each); trace and paths:
// int{8,16,32} (tok_bytes each), trace [n, t_max, b], paths [n, r_max,
// t_max]; src: int64 [n, r_max]. All contiguous on the stream's device.
extern "C" int backtrace_paths_launch(const void* parents, const void* trace, const int64_t* src,
                                      void* paths, int n, int t_max, int b, int r_max, int par_bytes,
                                      int tok_bytes, void* stream) {
  if (n <= 0 || t_max <= 0 || r_max <= 0 || b <= 0 || r_max > b) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (par_bytes) {
    case 1: return launch_tok<int8_t>(tok_bytes, parents, trace, src, paths, n, t_max, b, r_max, s);
    case 2: return launch_tok<int16_t>(tok_bytes, parents, trace, src, paths, n, t_max, b, r_max, s);
    case 4: return launch_tok<int32_t>(tok_bytes, parents, trace, src, paths, n, t_max, b, r_max, s);
  }
  return (int)cudaErrorInvalidValue;
}
