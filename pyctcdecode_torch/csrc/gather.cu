// Row gather: out[q, :] = table[idx[q], :] for int32 rows.
//
// Replaces the DMA-pipelined Pallas row gather of the JAX reference
// (scripts/pallas_gather_probe.py, gather_kernel): there, scalar-prefetched
// indices drive single-row HBM->VMEM async copies, 16 in flight, 128 queries
// per grid step, staged through a VMEM scratch block. None of that structure
// is carried over. On this card the work is a flat stream of 16-byte vectors:
// thread t moves vector t of the output, i.e. vector (t % vpr) of row
// idx[t / vpr], where vpr = row bytes / 16. Neighbouring lanes read
// neighbouring addresses of one table row (a 256-byte row is half a warp, a
// 512-byte row a whole warp) and write neighbouring addresses of the output,
// so both sides coalesce; a grid-stride loop covers any query count.
//
// What bounds it: bytes. Each gathered row is read once and written once and
// each index read once; there is no arithmetic beyond the address. At the
// decode step's sizes (a few thousand rows) the launch itself outweighs the
// copy. Indices must lie in [0, rows): nothing is clamped or checked here.
//
// The launch function returns cudaGetLastError() of its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_rows_kernel(const int4* __restrict__ table,
                                   const int64_t* __restrict__ idx, int4* __restrict__ out,
                                   long long n_vec, int vpr) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n_vec; t += stride) {
    const long long q = t / vpr;
    const int c = (int)(t - q * vpr);
    out[t] = __ldg(table + idx[q] * (long long)vpr + c);
  }
}

}  // namespace

// table: int32 [rows, vpr * 4] (16-byte aligned), idx: int64 [n_query],
// out: int32 [n_query, vpr * 4] (16-byte aligned).
extern "C" int gather_rows_launch(const void* table, const int64_t* idx, void* out,
                                  long long n_query, int vpr, void* stream) {
  const long long n_vec = n_query * vpr;
  const int threads = 256;
  long long blocks = (n_vec + threads - 1) / threads;
  const long long max_blocks = 132LL * 16;  // a few waves of the card's SMs; the loop strides
  if (blocks > max_blocks) blocks = max_blocks;
  gather_rows_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const int4*>(table), idx, reinterpret_cast<int4*>(out), n_vec, vpr);
  return (int)cudaGetLastError();
}
