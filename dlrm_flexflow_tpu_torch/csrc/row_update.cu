// Sparse embedding row updates for Hopper (sm_90a): table[rows] += deltas,
// and the lazy momentum, lazy Adam and row-wise AdaGrad rules on the same
// row-sorted stream.
//
// Replaces both Pallas TPU update kernels of
// dlrm_flexflow_tpu/ops/pallas/packed_update.py: `_update_kernel` (with
// `_stream_accumulate`, :487/:561, launched by `_packed_apply` :921) and
// its sparse-regime twin `_update_kernel_manual` (:750, launched by
// `_packed_apply_manual` :987). Both add a row-sorted stream of deltas to
// a table, duplicate rows summed in f32, rows out of range dropped; the
// second only skips chunks that receive no entries. These kernels do one
// read-modify-write per touched row, so their cost already follows the
// rows the stream touches and one kernel serves both regimes.
//
// SGD (`row_update`), for one table [V, D] (f32 or bf16), from a stream
// that the caller sorted stably by row (rows dropped by the caller's prep
// carry the sentinel V and sort last):
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
// The optimizer modes compute, per touched row r and lane d, in f32, what
// the JAX package computes in three passes per table (the m pass and the
// v pass in K1's decay mode, `out = chunk * (1 - decay * first) + acc`,
// :551-556, then a weight pass fed by gathers of the new pools,
// `packed_lazy_adam_batched` :1069-1151, `packed_lazy_momentum_batched`
// :1162-1227), and what its AdaGrad branch computes in two
// (`sparse_engine.py:160-199`, the second with a per-entry scale, :343-351).
// Here the head of a run owns its row, so one launch reads and writes the
// table row and its pool rows once. With g_k = src_k + dec, where dec is
// the weight decay term wd * t[r] taken in the table's dtype (JAX's weakly
// typed `weight_decay * rows`; 0 without weight decay), bf16() rounding
// to bf16, and keep = 1 - (1 - beta) in f32 (the epilogue's
// `1.0 - decay * 1.0`):
//   momentum: vel' = vel * keep + sum_k bf16(g_k)
//             step = vel' (plain) or (vel' - mu * vel) + mu * vel' (nesterov,
//                    the packed formula :1215)
//             t    = t (+) bf16(-lr * step)
//   Adam:     m'   = m * keep1 + sum_k bf16(c1 * g_k)        (c1 = f32(1 - beta1))
//             v'   = v * keep2 + sum_k bf16(c2 * (g_k * g_k)) (c2 = f32(1 - beta2))
//             t    = t (+) bf16((-alpha_t * m') / (sqrt(v') + eps))
//   AdaGrad:  a'   = a + sum_k mean_d(src_k^2)   (an f32 stream, never rounded)
//             s    = -lr * rsqrt(a' + eps)       (the accumulator after the update)
//             t    = t (+) bf16(sum_k bf16(src_k * s))
// where (+) is the table's epilogue above. Every operation is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn,
// __frsqrt_rn), so nvcc fuses nothing into an FMA and the reciprocal
// square root is the correctly rounded one, not the approximate rsqrtf.
// mean_d sums the D squares of a payload row in lane order, then divides.
//
// Bound. The function must read the stream (rows and order, K * 8 B), the
// payload (B * D * 4 B), and read and write each touched row once: the
// table (2 * D * itemsize) and, per rule, the pools (momentum 2 * D * 4,
// Adam 4 * D * 4, AdaGrad 2 * 4). At the kaggle training shape (K = 65536,
// D = 16, bf16 table of 10.1M rows, U ~ K touched rows) that is 4.7 MB of
// stream and payload plus 4.2 (SGD), 12.6 (momentum), 21.0 (Adam) or 4.7
// (AdaGrad) MB of rows: 2.7 to 7.7 us at 3.35 TB/s. The arithmetic is a few
// operations per entry and lane, nothing. So they are bound by bytes, and
// in practice by the latency of their dependent loads (row -> order ->
// payload -> table).
//
// Design (simple first).
//   - A group of D threads owns one sorted position k; thread d owns lane
//     d. Position k heads a run when rows_sorted[k] < V and differs from
//     rows_sorted[k - 1]; other groups exit at once. The head's group walks
//     its run in sorted order and sums in f32. Runs do not overlap, so no
//     atomics are needed and the result is the same bits on every run.
//     The head test is the first-occurrence flag of the lazy rules: it
//     shares no bits with the row value.
//   - The walk loads 8 positions at a time (rows, then order, then the
//     payload, each an independent load), so a long run of duplicates
//     (a Zipf-hot row) waits one load chain per 8 entries, not per entry.
//     The sum still adds them one by one in sorted order.
//   - The group reads D consecutive payload values and D consecutive
//     table and pool values: coalesced runs of D * itemsize bytes. AdaGrad
//     walks its run twice (the scale needs the whole run's sum first), and
//     each thread reads the whole payload row for mean_d, from L1.
//   - A block holds floor(256 / D) groups (D <= 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the table's epilogue: t + acc (f32), or bf16(t + f32(bf16(acc)))
__device__ __forceinline__ void store_sum(float* p, float t, float acc) {
  *p = __fadd_rn(t, acc);
}
__device__ __forceinline__ void store_sum(__nv_bfloat16* p, float t, float acc) {
  *p = __float2bfloat16_rn(__fadd_rn(t, bf16r(acc)));
}

// wd * t in the table's dtype: f32, or bf16(bf16(wd) * t)
__device__ __forceinline__ float decay_term(const float*, float wd, float t) {
  return __fmul_rn(wd, t);
}
__device__ __forceinline__ float decay_term(const __nv_bfloat16*, float wd, float t) {
  return bf16r(__fmul_rn(bf16r(wd), t));
}

// The sorted position this thread's group owns, if it heads the run of a
// row in [0, V): returns that row, else -1.
__device__ __forceinline__ int run_head(const int* __restrict__ rows, long long K, int V, int D,
                                        int groups_per_block, long long* k_out, int* d_out) {
  const int g = threadIdx.x / D;
  const int d = threadIdx.x - g * D;
  if (g >= groups_per_block) return -1;
  const long long k = (long long)blockIdx.x * groups_per_block + g;
  if (k >= K) return -1;
  const int row = rows[k];
  if (row < 0 || row >= V) return -1;
  if (k > 0 && rows[k - 1] == row) return -1;  // not the head of its run
  *k_out = k;
  *d_out = d;
  return row;
}

// Calls f(x, b) for every entry of the run of `row` headed at k, in sorted
// order: b = order[j] / h is the entry's payload row, x = src[b, d].
template <typename F>
__device__ __forceinline__ void for_run(const int* __restrict__ rows, const int* __restrict__ order,
                                        const float* __restrict__ src, long long K, long long k,
                                        int row, int D, int d, int h, F&& f) {
  for (long long j = k;; j += kUnroll) {
    bool hit[kUnroll];
    int b[kUnroll];
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) hit[u] = j + u < K && rows[j + u] == row;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) b[u] = hit[u] ? order[j + u] / h : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = hit[u] ? src[(long long)b[u] * D + d] : 0.0f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (hit[u]) f(x[u], b[u]);
    // sorted: the run's positions are contiguous, so a miss ends it
    if (!hit[kUnroll - 1]) break;
  }
}

template <typename TT, bool kStreamBf16>
__global__ void row_update_kernel(TT* __restrict__ table, const int* __restrict__ rows,
                                  const int* __restrict__ order, const float* __restrict__ src,
                                  const float* __restrict__ scale_ptr, long long K, int V,
                                  int D, int h, int groups_per_block) {
  long long k;
  int d;
  const int row = run_head(rows, K, V, D, groups_per_block, &k, &d);
  if (row < 0) return;
  const float scale = *scale_ptr;
  float acc = 0.0f;
  for_run(rows, order, src, K, k, row, D, d, h, [&](float x, int) {
    x = __fmul_rn(scale, x);
    if (kStreamBf16) x = bf16r(x);
    acc = __fadd_rn(acc, x);
  });
  TT* p = table + (long long)row * D + d;
  store_sum(p, load_f32(p), acc);
}

template <typename TT>
__global__ void row_update_momentum_kernel(
    TT* __restrict__ table, float* __restrict__ vel, const int* __restrict__ rows,
    const int* __restrict__ order, const float* __restrict__ src, const float* __restrict__ lr_ptr,
    float keep, float mu, float wd, int nesterov, long long K, int V, int D, int h,
    int groups_per_block) {
  long long k;
  int d;
  const int row = run_head(rows, K, V, D, groups_per_block, &k, &d);
  if (row < 0) return;
  const long long at = (long long)row * D + d;
  const float t = load_f32(table + at);
  const float dec = wd != 0.0f ? decay_term(table, wd, t) : 0.0f;
  float acc = 0.0f;
  for_run(rows, order, src, K, k, row, D, d, h, [&](float x, int) {
    if (wd != 0.0f) x = __fadd_rn(x, dec);
    acc = __fadd_rn(acc, bf16r(x));
  });
  const float v_old = vel[at];
  const float v_new = __fadd_rn(__fmul_rn(v_old, keep), acc);
  float step = v_new;
  if (nesterov) step = __fadd_rn(__fsub_rn(v_new, __fmul_rn(mu, v_old)), __fmul_rn(mu, v_new));
  vel[at] = v_new;
  store_sum(table + at, t, bf16r(__fmul_rn(-*lr_ptr, step)));
}

template <typename TT>
__global__ void row_update_adam_kernel(
    TT* __restrict__ table, float* __restrict__ m, float* __restrict__ v,
    const int* __restrict__ rows, const int* __restrict__ order, const float* __restrict__ src,
    const float* __restrict__ alpha_ptr, float c1, float c2, float keep1, float keep2, float eps,
    float wd, long long K, int V, int D, int h, int groups_per_block) {
  long long k;
  int d;
  const int row = run_head(rows, K, V, D, groups_per_block, &k, &d);
  if (row < 0) return;
  const long long at = (long long)row * D + d;
  const float t = load_f32(table + at);
  const float dec = wd != 0.0f ? decay_term(table, wd, t) : 0.0f;
  float acc_m = 0.0f, acc_v = 0.0f;
  for_run(rows, order, src, K, k, row, D, d, h, [&](float x, int) {
    if (wd != 0.0f) x = __fadd_rn(x, dec);
    acc_m = __fadd_rn(acc_m, bf16r(__fmul_rn(c1, x)));
    acc_v = __fadd_rn(acc_v, bf16r(__fmul_rn(c2, __fmul_rn(x, x))));
  });
  const float m_new = __fadd_rn(__fmul_rn(m[at], keep1), acc_m);
  const float v_new = __fadd_rn(__fmul_rn(v[at], keep2), acc_v);
  m[at] = m_new;
  v[at] = v_new;
  const float dw = __fdiv_rn(__fmul_rn(-*alpha_ptr, m_new), __fadd_rn(__fsqrt_rn(v_new), eps));
  store_sum(table + at, t, bf16r(dw));
}

template <typename TT>
__global__ void row_update_adagrad_kernel(
    TT* __restrict__ table, float* __restrict__ accum, const int* __restrict__ rows,
    const int* __restrict__ order, const float* __restrict__ src, const float* __restrict__ lr_ptr,
    float eps, long long K, int V, int D, int h, int groups_per_block) {
  long long k = 0;
  int d = 0;
  const int row = run_head(rows, K, V, D, groups_per_block, &k, &d);
  // every lane of a group reads the row's accumulator and lane 0 writes it:
  // the block's reads all happen before any write (a group of D = 64 or 128
  // spans warps)
  const float a_old = row >= 0 ? accum[row] : 0.0f;
  __syncthreads();
  if (row < 0) return;
  const float fd = (float)D;
  float gsq = 0.0f;
  for_run(rows, order, src, K, k, row, D, d, h, [&](float, int b) {
    const float* s = src + (long long)b * D;
    float sq = 0.0f;
    for (int e = 0; e < D; ++e) sq = __fadd_rn(sq, __fmul_rn(s[e], s[e]));
    gsq = __fadd_rn(gsq, __fdiv_rn(sq, fd));
  });
  const float a_new = __fadd_rn(a_old, gsq);
  const float scale = __fmul_rn(-*lr_ptr, __frsqrt_rn(__fadd_rn(a_new, eps)));
  float acc = 0.0f;
  for_run(rows, order, src, K, k, row, D, d, h, [&](float x, int) {
    acc = __fadd_rn(acc, bf16r(__fmul_rn(x, scale)));
  });
  if (d == 0) accum[row] = a_new;
  const long long at = (long long)row * D + d;
  store_sum(table + at, load_f32(table + at), acc);
}

inline unsigned blocks_for(long long K, int D) {
  const int groups = kThreads / D;
  return (unsigned)((K + groups - 1) / groups);
}

bool bad_shape(long long K, int D, int h) { return D < 1 || D > 128 || h < 1 || K >= (1LL << 31); }

}  // namespace

extern "C" {

// table [V, D] (f32, or bf16 when table_bf16), updated in place; rows and
// order [K] int32 (rows sorted, dropped rows = V); src f32 rows of D; scale
// one f32 on the device. Returns a cudaError_t (0 = launched).
int row_update(void* table, int table_bf16, const void* rows, const void* order,
               const void* src, const void* scale, long long K, int V, int D, int h,
               int stream_bf16, void* stream) {
  if (K <= 0) return 0;
  if (bad_shape(K, D, h)) return (int)cudaErrorInvalidValue;
  const int* r = (const int*)rows;
  const int* o = (const int*)order;
  const float* s = (const float*)src;
  const float* sc = (const float*)scale;
  cudaStream_t st = (cudaStream_t)stream;
  const int groups = kThreads / D;
  const unsigned blocks = blocks_for(K, D);
  if (table_bf16) {
    if (stream_bf16)
      row_update_kernel<__nv_bfloat16, true><<<blocks, groups * D, 0, st>>>(
          (__nv_bfloat16*)table, r, o, s, sc, K, V, D, h, groups);
    else
      row_update_kernel<__nv_bfloat16, false><<<blocks, groups * D, 0, st>>>(
          (__nv_bfloat16*)table, r, o, s, sc, K, V, D, h, groups);
  } else {
    if (stream_bf16)
      row_update_kernel<float, true><<<blocks, groups * D, 0, st>>>(
          (float*)table, r, o, s, sc, K, V, D, h, groups);
    else
      row_update_kernel<float, false><<<blocks, groups * D, 0, st>>>(
          (float*)table, r, o, s, sc, K, V, D, h, groups);
  }
  return (int)cudaGetLastError();
}

// Lazy momentum: vel [V, D] f32 in place; lr one f32 on the device; keep =
// f32(1 - f32(1 - mu)).
int row_update_momentum(void* table, int table_bf16, void* vel, const void* rows,
                        const void* order, const void* src, const void* lr, float keep, float mu,
                        float wd, int nesterov, long long K, int V, int D, int h, void* stream) {
  if (K <= 0) return 0;
  if (bad_shape(K, D, h)) return (int)cudaErrorInvalidValue;
  const int groups = kThreads / D;
  cudaStream_t st = (cudaStream_t)stream;
  if (table_bf16)
    row_update_momentum_kernel<__nv_bfloat16><<<blocks_for(K, D), groups * D, 0, st>>>(
        (__nv_bfloat16*)table, (float*)vel, (const int*)rows, (const int*)order,
        (const float*)src, (const float*)lr, keep, mu, wd, nesterov, K, V, D, h, groups);
  else
    row_update_momentum_kernel<float><<<blocks_for(K, D), groups * D, 0, st>>>(
        (float*)table, (float*)vel, (const int*)rows, (const int*)order, (const float*)src,
        (const float*)lr, keep, mu, wd, nesterov, K, V, D, h, groups);
  return (int)cudaGetLastError();
}

// Lazy Adam: m and v [V, D] f32 in place; alpha one f32 on the device (the
// bias-corrected alpha_t); c = f32(1 - beta), keep = f32(1 - c).
int row_update_adam(void* table, int table_bf16, void* m, void* v, const void* rows,
                    const void* order, const void* src, const void* alpha, float c1, float c2,
                    float keep1, float keep2, float eps, float wd, long long K, int V, int D,
                    int h, void* stream) {
  if (K <= 0) return 0;
  if (bad_shape(K, D, h)) return (int)cudaErrorInvalidValue;
  const int groups = kThreads / D;
  cudaStream_t st = (cudaStream_t)stream;
  if (table_bf16)
    row_update_adam_kernel<__nv_bfloat16><<<blocks_for(K, D), groups * D, 0, st>>>(
        (__nv_bfloat16*)table, (float*)m, (float*)v, (const int*)rows, (const int*)order,
        (const float*)src, (const float*)alpha, c1, c2, keep1, keep2, eps, wd, K, V, D, h,
        groups);
  else
    row_update_adam_kernel<float><<<blocks_for(K, D), groups * D, 0, st>>>(
        (float*)table, (float*)m, (float*)v, (const int*)rows, (const int*)order,
        (const float*)src, (const float*)alpha, c1, c2, keep1, keep2, eps, wd, K, V, D, h,
        groups);
  return (int)cudaGetLastError();
}

// Row-wise AdaGrad: accum [V] f32 in place; lr one f32 on the device.
int row_update_adagrad(void* table, int table_bf16, void* accum, const void* rows,
                       const void* order, const void* src, const void* lr, float eps, long long K,
                       int V, int D, int h, void* stream) {
  if (K <= 0) return 0;
  if (bad_shape(K, D, h)) return (int)cudaErrorInvalidValue;
  const int groups = kThreads / D;
  cudaStream_t st = (cudaStream_t)stream;
  if (table_bf16)
    row_update_adagrad_kernel<__nv_bfloat16><<<blocks_for(K, D), groups * D, 0, st>>>(
        (__nv_bfloat16*)table, (float*)accum, (const int*)rows, (const int*)order,
        (const float*)src, (const float*)lr, eps, K, V, D, h, groups);
  else
    row_update_adagrad_kernel<float><<<blocks_for(K, D), groups * D, 0, st>>>(
        (float*)table, (float*)accum, (const int*)rows, (const int*)order, (const float*)src,
        (const float*)lr, eps, K, V, D, h, groups);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
