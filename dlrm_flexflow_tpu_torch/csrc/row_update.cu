// Sparse embedding row update for Hopper (sm_90a): table[rows] += deltas.
//
// Replaces both Pallas TPU update kernels of
// dlrm_flexflow_tpu/ops/pallas/packed_update.py: `_update_kernel` (with
// `_stream_accumulate`, :487/:561, launched by `_packed_apply` :921) and
// its sparse-regime twin `_update_kernel_manual` (:750, launched by
// `_packed_apply_manual` :987). Both add a row-sorted stream of deltas to
// a table, duplicate rows summed in f32, rows out of range dropped; the
// second only skips chunks that receive no entries. This kernel does one
// read-modify-write per touched row, so its cost already follows the rows
// the stream touches and one kernel serves both regimes.
//
// What it computes, for one table [V, D] (f32 or bf16), from a stream that
// the caller sorted stably by row (rows dropped by the caller's prep carry
// the sentinel V and sort last):
//   delta_j[d] = round_s(scale * src[order[j] / h, d])   (f32 product)
//   acc[r, d]  = sum of delta_j[d] over the run of j with rows_sorted[j] == r,
//                in sorted order, in f32
//   f32 table:  t[r, d] = t[r, d] + acc[r, d]
//   bf16 table: t[r, d] = bf16(f32(t[r, d]) + f32(bf16(acc[r, d])))
// round_s rounds to the stream dtype (bf16 by default, or f32: identity),
// as the JAX package casts the payload stream before its kernel sums it
// (`_prep_streams`, :448); the bf16 epilogue is its `tp + acc.astype(tp)`
// (:558). src is the unexpanded pooled gradient (h = bag size; h = 1 for
// a [K, D] payload), so the [K, D] expansion is never made.
//
// Bound. The function must read the stream (rows and order, K * 8 B), the
// payload it reads (B * D * 4 B), and read and write each touched row once
// (U * D * 2 * itemsize). At the kaggle training shape (K = 65536, D = 16,
// bf16 table of 10.1M rows, U ~ K) that is 0.5 + 4.2 + 4.2 MB: about 3 us
// at 3.35 TB/s. The arithmetic is K * D multiply-adds, nothing. So it is
// bound by bytes, and in practice by the latency of its dependent loads
// (row -> order -> payload -> table).
//
// Design (simple first).
//   - A group of D threads owns one sorted position k; thread d owns lane
//     d. Position k heads a run when rows_sorted[k] < V and differs from
//     rows_sorted[k - 1]; other groups exit at once. The head's group walks
//     its run in sorted order and sums in f32. Runs do not overlap, so no
//     atomics are needed and the result is the same bits on every run.
//   - The walk loads 8 positions at a time (rows, then order, then the
//     payload, each an independent load), so a long run of duplicates
//     (a Zipf-hot row) waits one load chain per 8 entries, not per entry.
//     The sum still adds them one by one in sorted order.
//   - The group reads D consecutive payload values and D consecutive
//     table values: coalesced runs of D * itemsize bytes.
//   - The product scale * src is taken with __fmul_rn so that nvcc cannot
//     fuse it with the add into an FMA: the f32 stream rounds the product
//     first, as the plain version does.
//   - A block holds floor(256 / D) groups (D <= 128). The first-occurrence
//     flag that lazy Adam and momentum will need is the head test above;
//     it shares no bits with the row value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_sum(float* p, float acc) { *p = *p + acc; }
__device__ __forceinline__ void store_sum(__nv_bfloat16* p, float acc) {
  const float a = __bfloat162float(__float2bfloat16_rn(acc));
  *p = __float2bfloat16_rn(__bfloat162float(*p) + a);
}

template <typename TT, bool kStreamBf16>
__global__ void row_update_kernel(TT* __restrict__ table, const int* __restrict__ rows,
                                  const int* __restrict__ order, const float* __restrict__ src,
                                  const float* __restrict__ scale_ptr, long long K, int V,
                                  int D, int h, int groups_per_block) {
  const int g = threadIdx.x / D;
  const int d = threadIdx.x - g * D;
  if (g >= groups_per_block) return;
  const long long k = (long long)blockIdx.x * groups_per_block + g;
  if (k >= K) return;
  const int row = rows[k];
  if (row < 0 || row >= V) return;
  if (k > 0 && rows[k - 1] == row) return;  // not the head of its run

  const float scale = *scale_ptr;
  float acc = 0.0f;
  for (long long j = k;; j += kUnroll) {
    bool hit[kUnroll];
    int o[kUnroll];
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) hit[u] = j + u < K && rows[j + u] == row;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) o[u] = hit[u] ? order[j + u] : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = 0.0f;
      if (hit[u]) {
        float x = __fmul_rn(scale, src[(long long)(o[u] / h) * D + d]);
        if (kStreamBf16) x = __bfloat162float(__float2bfloat16_rn(x));
        v[u] = x;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (hit[u]) acc += v[u];
    // sorted: the run's positions are contiguous, so a miss ends it
    if (!hit[kUnroll - 1]) break;
  }
  store_sum(table + (long long)row * D + d, acc);
}

template <typename TT>
cudaError_t launch(void* table, const int* rows, const int* order, const float* src,
                   const float* scale, long long K, int V, int D, int h, int stream_bf16,
                   cudaStream_t stream) {
  const int groups = kThreads / D;
  const long long blocks = (K + groups - 1) / groups;
  if (stream_bf16) {
    row_update_kernel<TT, true><<<(unsigned)blocks, groups * D, 0, stream>>>(
        (TT*)table, rows, order, src, scale, K, V, D, h, groups);
  } else {
    row_update_kernel<TT, false><<<(unsigned)blocks, groups * D, 0, stream>>>(
        (TT*)table, rows, order, src, scale, K, V, D, h, groups);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// table [V, D] (f32, or bf16 when table_bf16), updated in place; rows and
// order [K] int32 (rows sorted, dropped rows = V); src f32 rows of D; scale
// one f32 on the device. Returns a cudaError_t (0 = launched).
int row_update(void* table, int table_bf16, const void* rows, const void* order,
               const void* src, const void* scale, long long K, int V, int D, int h,
               int stream_bf16, void* stream) {
  if (K <= 0) return 0;
  if (D < 1 || D > 128 || h < 1) return (int)cudaErrorInvalidValue;
  const int* r = (const int*)rows;
  const int* o = (const int*)order;
  const float* s = (const float*)src;
  const float* sc = (const float*)scale;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = table_bf16
      ? launch<__nv_bfloat16>(table, r, o, s, sc, K, V, D, h, stream_bf16, st)
      : launch<float>(table, r, o, s, sc, K, V, D, h, stream_bf16, st);
  return (int)err;
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
