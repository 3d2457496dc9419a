// Row reads of the decode step's LM tables: a row gather with a slot select,
// and the n-gram bucket probe fused with its readout.
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
    uint32_t h = FNV_OFFSET, lo = tabs.seed_lo[t], hi = tabs.seed_hi[t];
    const int64_t* key = full + q * order + (order - n);
    if (tabs.mode[t] == MODE_KENLM64) {
      // newest word first, then the context nearest to oldest; w + 1 in
      // uint32 (ops/hashing.py kenlm_chain)
      uint64_t c = (uint64_t)(uint32_t)key[n - 1];
      for (int j = n - 2; j >= 0; --j)
        c = (c * KENLM_MUL_A) ^ ((uint64_t)((uint32_t)key[j] + 1u) * KENLM_MUL_B);
      const uint32_t c_lo = (uint32_t)c, c_hi = (uint32_t)(c >> 32);
      h = mix32_pair(c_lo, c_hi, KENLM_BASE_SEED);
      lo = mix32_pair(c_lo, 0u, lo);
      hi = mix32_pair(c_hi, 0u, hi);
    } else {
      for (int j = 0; j < n; ++j) {
        const uint32_t id = (uint32_t)key[j];
        h = (h ^ id) * FNV_PRIME;
        lo = (lo ^ id) * FNV_PRIME;
        hi = (hi ^ id) * FNV_PRIME;
      }
    }
    lo = min(lo, FP_MAX);
    hi = min(hi, FP_MAX);
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
    const int p_bits = __shfl_sync(0xffffffffu, mine, src);
    const int b_bits = __shfl_sync(0xffffffffu, mine, src + 4);
    if (lane == 0) {
      const bool ok = valid && at != 0;
      found[o] = ok ? 1 : 0;
      prob[o] = ok ? __int_as_float(p_bits) : 0.0f;
      backoff[o] = ok ? __int_as_float(b_bits) : 0.0f;
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
