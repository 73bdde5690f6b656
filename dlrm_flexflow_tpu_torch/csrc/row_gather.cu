// Row gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_dma_gather_kernel`
// (scripts/bench_gather_probe.py:78, launched by `dma_gather` at :119), the
// forward-gather probe's per-row DMA gather:
//   out[i, :] = table[rows[i], :]   for i in [0, K)
// an exact copy in the table's dtype (f32 or bf16; only the bits move).
// The TPU kernel takes a [P, 128] table and K a multiple of its 2048-row
// tile, and has no contract for an index outside [0, P) (the probe makes
// none). Here: any K, any row width W with W * itemsize % 16 == 0 (the
// probe's narrow [V, 16] tables too), and an index < 0 or >= P gives a
// NaN row, as the embedding-bag kernel (K4) does; the kernel never reads
// outside the table.
//
// Bound. Nothing is computed, so bytes bound it: at the probe's shape (K =
// 65536 rows of a [125952, 128] f32 table) the function reads the indices
// (256 KB) and the distinct rows they name (about 26 MB of 512-byte rows)
// and writes 33.5 MB: about 0.018 ms at 3.35 TB/s, half that in bf16. What
// stands between a gather and that rate is the latency of the dependent
// index -> row load chain, the reason the TPU kernel keeps `depth` row DMAs
// in flight.
//
// Design (simple first). The output is a flat run of 16-byte chunks, row i
// holding chunks [i * C, (i + 1) * C) with C = W * itemsize / 16. A warp
// owns `kDepth` consecutive slices of 32 chunks: each lane loads its
// chunk's row index (lanes of one row share the address, one transaction),
// then the chunk of that row with one 16-byte load, for every slice, before
// it stores any: kDepth * 512 bytes in flight a warp, the counterpart of the
// probe's DMA depth. An f32 row of 128 is one slice (32 lanes x 16 bytes);
// a bf16 row is half a slice, so a warp moves two at a time; a narrow f32
// row of 16 is 4 chunks, 8 rows a slice. Stores are coalesced 512-byte
// runs. No shared memory: Hopper's TMA copies tiles, not a list of rows
// (one row each would be a TMA operation of its own), and the loads need no
// staging. Instances: kDepth in {1, 2, 4, 8}, and a shift or a divide to
// find the row of a chunk (C a power of two or not).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int kDepth, bool kPow2>
__global__ void __launch_bounds__(kThreads) row_gather_kernel(
    const uint4* __restrict__ table, const int* __restrict__ rows, uint4* __restrict__ out,
    unsigned n_chunks, unsigned chunks_per_row, unsigned shift, long long P, uint4 nan_chunk) {
  const unsigned warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const unsigned lane = threadIdx.x & 31;
  const unsigned base = warp * (32u * kDepth);
  uint4 v[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const unsigned j = base + 32u * d + lane;
    if (j < n_chunks) {
      const unsigned i = kPow2 ? (j >> shift) : (j / chunks_per_row);
      const unsigned c = j - i * chunks_per_row;
      const int r = __ldg(rows + i);
      v[d] = (r >= 0 && r < P) ? __ldg(table + (long long)r * chunks_per_row + c) : nan_chunk;
    }
  }
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    const unsigned j = base + 32u * d + lane;
    if (j < n_chunks) out[j] = v[d];
  }
}

template <int kDepth>
cudaError_t launch(const void* table, const int* rows, void* out, unsigned n_chunks, unsigned cpr,
                   long long P, uint4 nan_chunk, cudaStream_t stream) {
  const unsigned per_block = 32u * kDepth * kWarps;
  const unsigned blocks = (n_chunks + per_block - 1) / per_block;
  unsigned shift = 0;
  while ((1u << shift) < cpr) ++shift;
  const uint4* t = static_cast<const uint4*>(table);
  uint4* o = static_cast<uint4*>(out);
  if ((cpr & (cpr - 1)) == 0) {
    row_gather_kernel<kDepth, true><<<blocks, kThreads, 0, stream>>>(t, rows, o, n_chunks, cpr, shift,
                                                                     P, nan_chunk);
  } else {
    row_gather_kernel<kDepth, false><<<blocks, kThreads, 0, stream>>>(t, rows, o, n_chunks, cpr,
                                                                      shift, P, nan_chunk);
  }
  return cudaGetLastError();
}

}  // namespace

// table [P, W] (row_bytes = W * itemsize, a multiple of 16), rows [K] int32,
// out [K, W]; K * row_bytes / 16 < 2^31; table and out 16-byte aligned.
extern "C" int row_gather(const void* table, const void* rows, void* out, long long K, long long P,
                          long long row_bytes, int table_is_bf16, int depth, void* stream) {
  if (K < 1 || P < 1 || P >= (1LL << 31) || row_bytes < 16 || row_bytes % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_chunks = K * (row_bytes / 16);
  if (n_chunks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(table) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const unsigned w = table_is_bf16 ? 0x7fc07fc0u : 0x7fc00000u;  // the canonical NaN, every element
  const uint4 nan_chunk = make_uint4(w, w, w, w);
  const int* r = static_cast<const int*>(rows);
  const unsigned n = (unsigned)n_chunks, cpr = (unsigned)(row_bytes / 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (depth) {
    case 1: return (int)launch<1>(table, r, out, n, cpr, P, nan_chunk, s);
    case 2: return (int)launch<2>(table, r, out, n, cpr, P, nan_chunk, s);
    case 4: return (int)launch<4>(table, r, out, n, cpr, P, nan_chunk, s);
    case 8: return (int)launch<8>(table, r, out, n, cpr, P, nan_chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
