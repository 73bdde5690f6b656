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
// rows the stream touches and one design serves both regimes.
//
// SGD (`row_update`), for one table [V, D] (f32 or bf16), from a stream
// that the caller sorted stably by row (rows dropped by the caller's prep
// carry the sentinel V and sort last):
//   delta_j[d] = round_s(scale * src[order[j] / h, d])   (f32 product)
//   acc[r, d]  = sum of delta_j[d] over the run of j with rows_sorted[j] == r
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
// With g_k = src_k + dec, where dec is the weight decay term wd * t[r]
// taken in the table's dtype (JAX's weakly typed `weight_decay * rows`; 0
// without weight decay), bf16() rounding to bf16, and keep = 1 - (1 - beta)
// in f32 (the epilogue's `1.0 - decay * 1.0`):
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
// mean_d sums the four squares a thread owns in lane order, then combines
// the threads of a row by a butterfly of warp shuffles (the same tree, so
// the same bits, on every lane and every run), then divides by D.
//
// Bound. The function must read the stream (rows and order, K * 8 B), the
// payload (B * D * 4 B), and read and write each touched row once: the
// table (2 * D * itemsize) and, per rule, the pools (momentum 2 * D * 4,
// Adam 4 * D * 4, AdaGrad 2 * 4). At the kaggle training shape (K = 65536,
// D = 16, bf16 table of 10.1M rows, U ~ K touched rows) that is 4.7 MB of
// stream and payload plus 4.2 (SGD), 12.6 (momentum), 21.0 (Adam) or 4.7
// (AdaGrad) MB of rows: 2.7 to 7.7 us at 3.35 TB/s; a Zipf(1.05) stream
// touches 27,270 rows, about 2 us. The arithmetic is a few operations per
// entry and lane, nothing. So they are bound by bytes, and in practice by
// the latency of their dependent loads (rows -> order -> payload, rows ->
// table) and by how evenly the runs spread over the card.
//
// Design: fixed chunks, so that a hot row's run is summed by many blocks.
//   - Pass 1, one block of 256 threads per chunk of kChunk = 64 sorted
//     positions. The block stages the chunk's rows (and the row before and
//     after it) and its payload rows in shared memory, one coalesced load
//     each, 16 bytes a thread where D % 4 == 0. A row's lanes belong to a
//     group of Lp threads (Lp = ceil(D / 4) rounded up to a power of two,
//     at most 32, so a group lies in one warp), four lanes a thread; at
//     D = 16 a block holds 64 groups, one per position. The group of a
//     position that heads a piece of a run (the chunk's first position, or
//     a change of row) issues its table and pool loads before the staging
//     barrier, so they overlap the payload's, then sums the piece's entries
//     from shared memory in sorted order.
//     - A run wholly inside the chunk is finished here: its row and pool
//       rows are read and written once.
//     - A piece that touches a chunk edge and whose run goes on past it
//       writes its sums to a scratch of [n_chunks, 2, n_acc, D] f32: slot 0
//       for the piece that runs on into the next chunk (the whole chunk,
//       if the run covers it), slot 1 for the piece that ends a run begun
//       in an earlier chunk.
//   - Pass 2, one warp per chunk edge: where a run crosses the edge and
//     this is its first crossing, the warp reads whether the run goes on
//     across the next 32 edges (one load a lane, a ballot), then adds its
//     pieces' sums in chunk order, 16 loads in flight, and applies the
//     rule once. So the order of every sum is fixed by K and kChunk alone:
//     sorted order within a piece, chunk order across pieces. No float
//     atomics; every run gives the same bits; a stream sorted on the host
//     in the same order gives the same bits as one sorted on the card.
//   - AdaGrad's per-entry term bf16(src_k * s) needs the run's scale
//     first, so its spanning runs take two more passes: pass 2 sums the
//     pieces' mean-square partials in chunk order, writes the accumulator
//     and leaves the scale s beside each piece's slot; pass 3 (one block a
//     chunk, which leaves at once unless a run crosses one of its edges)
//     sums each edge piece's bf16(src_k * s) in sorted order; pass 4 adds
//     those in chunk order into the table, as pass 2 of SGD does.
//   - Launches per table: SGD, momentum and Adam 2 (1 when K <= kChunk),
//     AdaGrad 4 (1 when K <= kChunk). Pass 2's grid is one warp an edge,
//     so on a uniform stream, where almost no run crosses an edge, it
//     reads two rows an edge and ends.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;  // sorted positions a chunk: the wrapper's CHUNK
constexpr int kEdgeBatch = 16;  // pass 2's loads in flight
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// ---------------------------------------------------------------- lanes
// A thread owns the four lanes d0 .. d0 + 3 of a row (n <= 4 of them lie
// inside D). kVec: D % 4 == 0 and 16-byte aligned bases, so the four are
// one vector access.
__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// (n == 0: a lane past D, which reads and writes nothing)
template <bool kVec>
__device__ __forceinline__ void load4(const float* p, int n, float (&v)[4]) {
  if (kVec && n > 0) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? p[e] : 0.0f;
  }
}
template <bool kVec>
__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, float (&v)[4]) {
  if (kVec && n > 0) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo); v[2] = __low2float(hi); v[3] = __high2float(hi);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? __bfloat162float(p[e]) : 0.0f;
  }
}
template <bool kVec>
__device__ __forceinline__ void store4(float* p, int n, const float (&v)[4]) {
  if (kVec && n > 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[e] = v[e];
  }
}
template <bool kVec>
__device__ __forceinline__ void store4(__nv_bfloat16* p, int n, const float (&v)[4]) {
  if (kVec && n > 0) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<uint32_t*>(&lo);
    q.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[e] = __float2bfloat16_rn(v[e]);
  }
}

// the table's epilogue before its store: t + acc (f32), or t + f32(bf16(acc))
// (bf16, rounded to bf16 by the store)
__device__ __forceinline__ float epilogue(const float*, float t, float acc) { return __fadd_rn(t, acc); }
__device__ __forceinline__ float epilogue(const __nv_bfloat16*, float t, float acc) {
  return __fadd_rn(t, bf16r(acc));
}
__device__ __forceinline__ float round_table(const float*, float x) { return x; }
__device__ __forceinline__ float round_table(const __nv_bfloat16*, float x) { return bf16r(x); }

// wd * t in the table's dtype: f32, or bf16(bf16(wd) * t)
template <typename TT>
__device__ __forceinline__ float decay_term(float wd, float t) {
  const TT* tag = nullptr;
  return round_table(tag, __fmul_rn(round_table(tag, wd), t));
}

// ---------------------------------------------------------------- rules
// A rule sums kAcc f32 accumulators a lane over a run's entries (`entry`)
// and then updates the table value and its kPools pool values of the lane
// (`apply`, which returns the table's new value before the table's
// epilogue rounding).

struct Sgd {
  static constexpr int kAcc = 1, kPools = 0;
  const float* scale_ptr;
  int stream_bf16;
  float scale;
  float* pools[1];
  __device__ void start() { scale = *scale_ptr; }
  __device__ __forceinline__ void entry(float x, float, float (&acc)[kAcc]) const {
    float y = __fmul_rn(scale, x);
    if (stream_bf16) y = bf16r(y);
    acc[0] = __fadd_rn(acc[0], y);
  }
  template <typename TT>
  __device__ __forceinline__ float apply(const TT* tag, float t, float*, const float (&acc)[kAcc]) const {
    return epilogue(tag, t, acc[0]);
  }
};

// AdaGrad's last pass: the run's summed bf16(src_k * s) into the table
struct AddSum {
  static constexpr int kAcc = 1, kPools = 0;
  float* pools[1];
  __device__ void start() {}
  __device__ __forceinline__ void entry(float x, float, float (&acc)[kAcc]) const {
    acc[0] = __fadd_rn(acc[0], x);
  }
  template <typename TT>
  __device__ __forceinline__ float apply(const TT* tag, float t, float*, const float (&acc)[kAcc]) const {
    return epilogue(tag, t, acc[0]);
  }
};

template <typename TT>
struct Momentum {
  static constexpr int kAcc = 1, kPools = 1;
  float* pools[1];
  const float* lr_ptr;
  float keep, mu, wd;
  int nesterov;
  float neg_lr;
  __device__ void start() { neg_lr = -*lr_ptr; }
  __device__ __forceinline__ void entry(float x, float t, float (&acc)[kAcc]) const {
    if (wd != 0.0f) x = __fadd_rn(x, decay_term<TT>(wd, t));
    acc[0] = __fadd_rn(acc[0], bf16r(x));
  }
  __device__ __forceinline__ float apply(const TT* tag, float t, float* p, const float (&acc)[kAcc]) const {
    const float v_old = p[0];
    const float v_new = __fadd_rn(__fmul_rn(v_old, keep), acc[0]);
    float step = v_new;
    if (nesterov) step = __fadd_rn(__fsub_rn(v_new, __fmul_rn(mu, v_old)), __fmul_rn(mu, v_new));
    p[0] = v_new;
    return epilogue(tag, t, bf16r(__fmul_rn(neg_lr, step)));
  }
};

template <typename TT>
struct Adam {
  static constexpr int kAcc = 2, kPools = 2;
  float* pools[2];
  const float* alpha_ptr;
  float c1, c2, keep1, keep2, eps, wd;
  float neg_alpha;
  __device__ void start() { neg_alpha = -*alpha_ptr; }
  __device__ __forceinline__ void entry(float x, float t, float (&acc)[kAcc]) const {
    if (wd != 0.0f) x = __fadd_rn(x, decay_term<TT>(wd, t));
    acc[0] = __fadd_rn(acc[0], bf16r(__fmul_rn(c1, x)));
    acc[1] = __fadd_rn(acc[1], bf16r(__fmul_rn(c2, __fmul_rn(x, x))));
  }
  __device__ __forceinline__ float apply(const TT* tag, float t, float* p, const float (&acc)[kAcc]) const {
    const float m_new = __fadd_rn(__fmul_rn(p[0], keep1), acc[0]);
    const float v_new = __fadd_rn(__fmul_rn(p[1], keep2), acc[1]);
    p[0] = m_new;
    p[1] = v_new;
    return epilogue(tag, t, bf16r(__fdiv_rn(__fmul_rn(neg_alpha, m_new), __fadd_rn(__fsqrt_rn(v_new), eps))));
  }
};

template <typename Rule>
struct Pools {  // kPools pool arrays, or none
  static constexpr int kN = Rule::kPools > 0 ? Rule::kPools : 1;
};

// ---------------------------------------------------------------- the stream
struct Stream {
  const int* rows;   // [K] sorted; rows outside [0, V) are dropped
  const int* order;  // [K] each position's entry
  const float* src;  // [B, D]: entry k reads row k / h
  long long K;
  int V, D, h;
};

__device__ __forceinline__ bool valid_row(int row, int V) { return row >= 0 && row < V; }

// A thread's place in its group: the group of Lp = 1 << lanes_log2 threads
// owns one row; this thread its lanes d0 .. d0 + n - 1.
struct Lane {
  int g, groups, lt, d0, n;
  unsigned mask;  // the group's threads in this warp
  __device__ Lane(int lanes_log2, int D) {
    const int lp = 1 << lanes_log2;
    g = threadIdx.x >> lanes_log2;
    groups = kThreads >> lanes_log2;
    lt = threadIdx.x & (lp - 1);
    d0 = lt * 4;
    n = max(0, min(4, D - d0));
    const int base = (threadIdx.x & 31) & ~(lp - 1);
    mask = lp == 32 ? kFull : ((1u << lp) - 1u) << base;
  }
};

// mean over D of the squares of a row's entry, the same bits on every lane
// of the group: the thread's four in lane order, then a butterfly
__device__ __forceinline__ float mean_sq(const float (&x)[4], const Lane& ln, int lanes_log2, float fd) {
  float s = 0.0f;
#pragma unroll
  for (int e = 0; e < 4; ++e) s = __fadd_rn(s, __fmul_rn(x[e], x[e]));
  for (int m = 1; m < (1 << lanes_log2); m <<= 1) s = __fadd_rn(s, __shfl_xor_sync(ln.mask, s, m));
  return __fdiv_rn(s, fd);
}

// Stages chunk [c0, c0 + n_pos) in shared memory: s_rows[i] is the row of
// position c0 - 1 + i (i = 0 .. n_pos + 1; -1 outside [0, K)), s_x[i * D +
// d] the payload of position c0 + i at lane d (kept positions only).
// Ends with the block's barrier.
template <bool kVec>
__device__ __forceinline__ void stage_chunk(const Stream& s, long long c0, int n_pos, int* s_rows,
                                            float* s_x) {
  for (int i = threadIdx.x; i < n_pos + 2; i += kThreads) {
    const long long j = c0 - 1 + i;
    s_rows[i] = (j >= 0 && j < s.K) ? s.rows[j] : -1;
  }
  const int per = kVec ? s.D / 4 : s.D;  // accesses a position
  for (int idx = threadIdx.x; idx < n_pos * per; idx += kThreads) {
    const int i = idx / per;
    const int q = idx - i * per;
    const long long j = c0 + i;
    if (!valid_row(s.rows[j], s.V)) continue;
    const float* p = s.src + (long long)(s.order[j] / s.h) * s.D;
    if (kVec) {
      *reinterpret_cast<float4*>(s_x + i * s.D + q * 4) = *reinterpret_cast<const float4*>(p + q * 4);
    } else {
      s_x[i * s.D + q] = p[q];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float* slot_ptr(float* part, long long c, int slot, int n_acc, int a, int D) {
  return part + ((c * 2 + slot) * n_acc + a) * (long long)D;
}

// ---------------------------------------------------------------- pass 1
template <typename TT, bool kVec, typename Rule>
__global__ void __launch_bounds__(kThreads)
    row_update_chunk_kernel(TT* __restrict__ table, Stream s, Rule rule, float* __restrict__ part, int lanes_log2) {
  extern __shared__ __align__(16) float s_x[];
  __shared__ int s_rows[kChunk + 2];
  constexpr int kP = Pools<Rule>::kN;
  const long long c0 = (long long)blockIdx.x * kChunk;
  const int n_pos = (int)min((long long)kChunk, s.K - c0);
  const Lane ln(lanes_log2, s.D);
  rule.start();

  // the group's first position: its head test and its row's loads go out
  // before the staging barrier
  int i = ln.g;
  int row = -1;
  float t[4] = {0.f, 0.f, 0.f, 0.f}, p[kP][4] = {};
  if (i < n_pos) {
    row = s.rows[c0 + i];
    if (!valid_row(row, s.V) || (i > 0 && s.rows[c0 + i - 1] == row)) row = -1;
    if (row >= 0 && ln.n > 0) {
      const long long at = (long long)row * s.D + ln.d0;
      load4<kVec>(table + at, ln.n, t);
#pragma unroll
      for (int k = 0; k < Rule::kPools; ++k) load4<kVec>(rule.pools[k] + at, ln.n, p[k]);
    }
  }
  stage_chunk<kVec>(s, c0, n_pos, s_rows, s_x);

  for (; i < n_pos; i += ln.groups) {
    if (i != ln.g) {
      row = s_rows[i + 1];
      if (!valid_row(row, s.V) || (i > 0 && s_rows[i] == row)) continue;
      if (ln.n > 0) {
        const long long at = (long long)row * s.D + ln.d0;
        load4<kVec>(table + at, ln.n, t);
#pragma unroll
        for (int k = 0; k < Rule::kPools; ++k) load4<kVec>(rule.pools[k] + at, ln.n, p[k]);
      }
    }
    if (row < 0) continue;
    int end = i + 1;
    while (end < n_pos && s_rows[end + 1] == row) ++end;
    float acc[4][Rule::kAcc] = {};
    for (int e = i; e < end; ++e) {
      float x[4];
      load4<kVec>(s_x + e * s.D + ln.d0, ln.n, x);
#pragma unroll
      for (int d = 0; d < 4; ++d) rule.entry(x[d], t[d], acc[d]);
    }
    const bool cont_in = i == 0 && c0 > 0 && s_rows[0] == row;
    const bool cont_out = end == n_pos && c0 + n_pos < s.K && s_rows[n_pos + 1] == row;
    if (ln.n == 0) continue;
    const long long at = (long long)row * s.D + ln.d0;
    if (!cont_in && !cont_out) {
      float out[4], pl[kP];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
#pragma unroll
        for (int k = 0; k < Rule::kPools; ++k) pl[k] = p[k][d];
        out[d] = rule.apply(table, t[d], pl, acc[d]);
#pragma unroll
        for (int k = 0; k < Rule::kPools; ++k) p[k][d] = pl[k];
      }
      store4<kVec>(table + at, ln.n, out);
#pragma unroll
      for (int k = 0; k < Rule::kPools; ++k) store4<kVec>(rule.pools[k] + at, ln.n, p[k]);
    } else {
#pragma unroll
      for (int a = 0; a < Rule::kAcc; ++a) {
        float v[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) v[d] = acc[d][a];
        store4<kVec>(slot_ptr(part, blockIdx.x, cont_out ? 0 : 1, Rule::kAcc, a, s.D) + ln.d0, ln.n, v);
      }
    }
  }
}

// ---------------------------------------------------------------- pass 2
// The run of `row` crosses edge c (positions c * kChunk - 1 and c *
// kChunk) for the first time. Calls f(u, chunk, slot) for its pieces in
// chunk order: the slot-0 piece of chunk c - 1, the whole chunks after it,
// the slot-1 piece of the chunk where it ends; u counts them. Each round
// reads the next 32 edges, one a lane, and lets f see up to 32 pieces.
template <typename F>
__device__ __forceinline__ void for_pieces(const int* __restrict__ rows, long long K, int row, long long c,
                                           F&& f) {
  const int lane = threadIdx.x & 31;
  f(c - 1, 0);
  for (long long cc = c;; cc += 32) {
    const long long edge = (cc + lane + 1) * kChunk;  // does the run go on past chunk cc + lane?
    const bool on = edge < K && rows[edge] == row;
    const unsigned m = __ballot_sync(kFull, on);
    const int stop = m == kFull ? 32 : __ffs(~m) - 1;  // the run ends in chunk cc + stop
    for (int u0 = 0; u0 < min(stop + 1, 32); u0 += kEdgeBatch) {
      f.batch(cc + u0, min(kEdgeBatch, min(stop + 1, 32) - u0), stop - u0);
    }
    if (stop < 32) break;
  }
}

// Whether edge c (c >= 1) is the first edge its run crosses; the row, or -1.
__device__ __forceinline__ int first_crossing(const int* __restrict__ rows, long long K, int V, long long c) {
  const long long b = c * kChunk;
  const int row = rows[b];
  if (!valid_row(row, V) || rows[b - 1] != row) return -1;
  if (c >= 2 && rows[b - kChunk - 1] == row) return -1;  // the run began before chunk c - 1
  return row;
}

// Sums, per lane of the warp's D lanes (lane d + 32 e), the kAcc partials
// of the run's pieces in chunk order, kEdgeBatch loads in flight.
template <int kAcc, int kE>
struct EdgeSum {
  const float* part;
  int D;
  float acc[kE][kAcc];
  __device__ void operator()(long long chunk, int slot) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = lane + 32 * e;
#pragma unroll
      for (int a = 0; a < kAcc; ++a)
        acc[e][a] = d < D ? part[((chunk * 2 + slot) * kAcc + a) * (long long)D + d] : 0.0f;
    }
  }
  // pieces of chunks c .. c + n - 1, the one at index last (if < n) in slot 1
  __device__ void batch(long long c, int n, int last) {
    const int lane = threadIdx.x & 31;
    float v[kEdgeBatch][kE][kAcc];
#pragma unroll
    for (int u = 0; u < kEdgeBatch; ++u) {
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const int d = lane + 32 * e;
#pragma unroll
        for (int a = 0; a < kAcc; ++a)
          v[u][e][a] = (u < n && d < D)
                           ? part[(((c + u) * 2 + (u == last ? 1 : 0)) * kAcc + a) * (long long)D + d]
                           : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kEdgeBatch; ++u)
      if (u < n) {
#pragma unroll
        for (int e = 0; e < kE; ++e)
#pragma unroll
          for (int a = 0; a < kAcc; ++a) acc[e][a] = __fadd_rn(acc[e][a], v[u][e][a]);
      }
  }
};

template <typename TT, typename Rule, int kE>
__global__ void __launch_bounds__(kThreads)
    row_update_edge_kernel(TT* __restrict__ table, const int* __restrict__ rows, long long K, int V, int D, Rule rule,
                           const float* __restrict__ part, long long n_chunks) {
  const long long c = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32 + 1;
  if (c >= n_chunks) return;
  const int row = first_crossing(rows, K, V, c);
  if (row < 0) return;
  rule.start();
  EdgeSum<Rule::kAcc, kE> sum{part, D};
  for_pieces(rows, K, row, c, sum);
  const int lane = threadIdx.x & 31;
  constexpr int kP = Pools<Rule>::kN;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int d = lane + 32 * e;
    if (d >= D) continue;
    const long long at = (long long)row * D + d;
    float pl[kP];
#pragma unroll
    for (int k = 0; k < Rule::kPools; ++k) pl[k] = rule.pools[k][at];
    // pass 1 took the entries' decay terms from the same, unchanged t
    store1(table + at, rule.apply(table, load1(table + at), pl, sum.acc[e]));
#pragma unroll
    for (int k = 0; k < Rule::kPools; ++k) rule.pools[k][at] = pl[k];
  }
}

// ---------------------------------------------------------------- AdaGrad
// Pass 1 (mode 0): every piece sums its entries' mean squares; a run
// wholly inside the chunk is finished; an edge piece leaves its sum in
// gsq[chunk * 2 + slot]. Pass 3 (mode 1): only chunks with an edge
// piece; each edge piece sums bf16(src_k * s) with its run's scale s from
// scale[chunk * 2 + slot] and leaves it in part[chunk, slot, 0, :].
template <typename TT, bool kVec>
__global__ void __launch_bounds__(kThreads) row_update_adagrad_chunk_kernel(
    TT* __restrict__ table, float* __restrict__ accum, Stream s, const float* __restrict__ lr_ptr, float eps,
    float* __restrict__ part, float* __restrict__ gsq, const float* __restrict__ scale, int lanes_log2,
    int mode) {
  extern __shared__ __align__(16) float s_x[];
  __shared__ int s_rows[kChunk + 2];
  const long long c0 = (long long)blockIdx.x * kChunk;
  const int n_pos = (int)min((long long)kChunk, s.K - c0);
  if (mode == 1) {  // leave unless a run crosses one of the chunk's edges
    const long long c1 = c0 + n_pos;
    const int first = s.rows[c0], last = s.rows[c1 - 1];
    const bool in = c0 > 0 && valid_row(first, s.V) && s.rows[c0 - 1] == first;
    const bool out = c1 < s.K && valid_row(last, s.V) && s.rows[c1] == last;
    if (!in && !out) return;
  }
  const Lane ln(lanes_log2, s.D);
  const float fd = (float)s.D;
  const float neg_lr = -*lr_ptr;
  int i = ln.g;
  int row = -1;
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  float a_old = 0.0f;
  if (mode == 0 && i < n_pos) {
    row = s.rows[c0 + i];
    if (!valid_row(row, s.V) || (i > 0 && s.rows[c0 + i - 1] == row)) row = -1;
    if (row >= 0) {
      if (ln.n > 0) load4<kVec>(table + (long long)row * s.D + ln.d0, ln.n, t);
      if (ln.lt == 0) a_old = accum[row];
    }
  }
  stage_chunk<kVec>(s, c0, n_pos, s_rows, s_x);

  for (; i < n_pos; i += ln.groups) {
    if (mode == 1 || i != ln.g) {
      row = s_rows[i + 1];
      if (!valid_row(row, s.V) || (i > 0 && s_rows[i] == row)) continue;
    }
    if (row < 0) continue;
    int end = i + 1;
    while (end < n_pos && s_rows[end + 1] == row) ++end;
    const bool cont_in = i == 0 && c0 > 0 && s_rows[0] == row;
    const bool cont_out = end == n_pos && c0 + n_pos < s.K && s_rows[n_pos + 1] == row;
    const bool edge = cont_in || cont_out;
    const long long slot = blockIdx.x * 2LL + (cont_out ? 0 : 1);
    float sc;
    if (mode == 0) {
      float g = 0.0f;
      for (int e = i; e < end; ++e) {
        float x[4];
        load4<kVec>(s_x + e * s.D + ln.d0, ln.n, x);
        g = __fadd_rn(g, mean_sq(x, ln, lanes_log2, fd));
      }
      if (edge) {
        if (ln.lt == 0) gsq[slot] = g;
        continue;
      }
      if (i != ln.g) {
        if (ln.n > 0) load4<kVec>(table + (long long)row * s.D + ln.d0, ln.n, t);
        if (ln.lt == 0) a_old = accum[row];
      }
      a_old = __shfl_sync(ln.mask, a_old, (threadIdx.x & 31) & ~((1 << lanes_log2) - 1));
      const float a_new = __fadd_rn(a_old, g);
      sc = __fmul_rn(neg_lr, __frsqrt_rn(__fadd_rn(a_new, eps)));
      if (ln.lt == 0) accum[row] = a_new;
    } else {
      if (!edge) continue;
      sc = scale[slot];
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int e = i; e < end; ++e) {
      float x[4];
      load4<kVec>(s_x + e * s.D + ln.d0, ln.n, x);
#pragma unroll
      for (int d = 0; d < 4; ++d) acc[d] = __fadd_rn(acc[d], bf16r(__fmul_rn(x[d], sc)));
    }
    if (ln.n == 0) continue;
    if (mode == 1) {
      store4<kVec>(slot_ptr(part, blockIdx.x, cont_out ? 0 : 1, 1, 0, s.D) + ln.d0, ln.n, acc);
    } else {
      float out[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) out[d] = epilogue(table, t[d], acc[d]);
      store4<kVec>(table + (long long)row * s.D + ln.d0, ln.n, out);
    }
  }
}

// AdaGrad pass 2: a warp per first crossing sums the run's mean-square
// partials in chunk order, writes the accumulator and leaves the scale
// beside every piece's slot.
__global__ void __launch_bounds__(kThreads) row_update_adagrad_scale_kernel(
    const int* __restrict__ rows, long long K, int V, float* __restrict__ accum, const float* __restrict__ lr_ptr,
    float eps, const float* __restrict__ gsq, float* __restrict__ scale, long long n_chunks) {
  const long long c = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32 + 1;
  if (c >= n_chunks) return;
  const int row = first_crossing(rows, K, V, c);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  // the pieces: slot 0 of chunks c - 1 .. end - 1, slot 1 of chunk end;
  // lane u of a round reads the partial of chunk cc + u
  float total = gsq[(c - 1) * 2];
  long long end = -1;
  for (long long cc = c; end < 0; cc += 32) {
    const long long edge = (cc + lane + 1) * kChunk;
    const bool on = edge < K && rows[edge] == row;
    const unsigned m = __ballot_sync(kFull, on);
    const int stop = m == kFull ? 32 : __ffs(~m) - 1;
    const float g = lane <= stop && lane < 32 ? gsq[(cc + lane) * 2 + (lane == stop ? 1 : 0)] : 0.0f;
    for (int u = 0; u < min(stop + 1, 32); ++u) total = __fadd_rn(total, __shfl_sync(kFull, g, u));
    if (stop < 32) end = cc + stop;
  }
  const float a_new = __fadd_rn(accum[row], total);
  const float sc = __fmul_rn(-*lr_ptr, __frsqrt_rn(__fadd_rn(a_new, eps)));
  __syncwarp();
  if (lane == 0) accum[row] = a_new;
  for (long long cc = c - 1 + lane; cc <= end; cc += 32) scale[cc * 2 + (cc == end ? 1 : 0)] = sc;
}

// ---------------------------------------------------------------- launch
int lanes_log2_for(int D) {
  const int lanes = (D + 3) / 4;
  int l = 0;
  while ((1 << l) < lanes) ++l;
  return l;
}

bool vec_ok(int D, std::initializer_list<const void*> ptrs) {
  if (D % 4 != 0) return false;
  for (const void* p : ptrs)
    if (p != nullptr && reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

bool bad_shape(long long K, int D, int h) { return D < 1 || D > 128 || h < 1 || K >= (1LL << 31); }

long long chunks_of(long long K) { return (K + kChunk - 1) / kChunk; }

// pass 1 and, if a run can cross an edge, pass 2 of one rule
template <typename TT, typename Rule>
cudaError_t launch_rule(TT* table, const Stream& s, const Rule& rule, float* part, cudaStream_t st,
                        std::initializer_list<const void*> ptrs) {
  const long long n = chunks_of(s.K);
  const int ll = lanes_log2_for(s.D);
  const size_t smem = (size_t)kChunk * s.D * sizeof(float);
  if (vec_ok(s.D, ptrs))
    row_update_chunk_kernel<TT, true, Rule><<<(unsigned)n, kThreads, smem, st>>>(table, s, rule, part, ll);
  else
    row_update_chunk_kernel<TT, false, Rule><<<(unsigned)n, kThreads, smem, st>>>(table, s, rule, part, ll);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n < 2) return err;
  const unsigned blocks = (unsigned)((n - 1 + kThreads / 32 - 1) / (kThreads / 32));
  if (s.D <= 32)
    row_update_edge_kernel<TT, Rule, 1><<<blocks, kThreads, 0, st>>>(table, s.rows, s.K, s.V, s.D, rule, part, n);
  else
    row_update_edge_kernel<TT, Rule, 4><<<blocks, kThreads, 0, st>>>(table, s.rows, s.K, s.V, s.D, rule, part, n);
  return cudaGetLastError();
}

template <typename TT>
cudaError_t launch_adagrad(TT* table, float* accum, const Stream& s, const float* lr, float eps, float* part,
                           cudaStream_t st) {
  const long long n = chunks_of(s.K);
  const int ll = lanes_log2_for(s.D);
  const size_t smem = (size_t)kChunk * s.D * sizeof(float);
  // scratch: part [n, 2, 1, D], then gsq [n, 2], then scale [n, 2]
  float* gsq = part + n * 2 * s.D;
  float* scale = gsq + n * 2;
  const bool vec = vec_ok(s.D, {table, s.src});
  for (int mode = 0; mode < 2; ++mode) {
    if (mode == 1) {
      if (n < 2) break;
      const unsigned blocks = (unsigned)((n - 1 + kThreads / 32 - 1) / (kThreads / 32));
      row_update_adagrad_scale_kernel<<<blocks, kThreads, 0, st>>>(s.rows, s.K, s.V, accum, lr, eps, gsq, scale, n);
      cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    if (vec)
      row_update_adagrad_chunk_kernel<TT, true>
          <<<(unsigned)n, kThreads, smem, st>>>(table, accum, s, lr, eps, part, gsq, scale, ll, mode);
    else
      row_update_adagrad_chunk_kernel<TT, false>
          <<<(unsigned)n, kThreads, smem, st>>>(table, accum, s, lr, eps, part, gsq, scale, ll, mode);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n < 2) return cudaSuccess;
  const unsigned blocks = (unsigned)((n - 1 + kThreads / 32 - 1) / (kThreads / 32));
  const AddSum add{};
  if (s.D <= 32)
    row_update_edge_kernel<TT, AddSum, 1><<<blocks, kThreads, 0, st>>>(table, s.rows, s.K, s.V, s.D, add, part, n);
  else
    row_update_edge_kernel<TT, AddSum, 4><<<blocks, kThreads, 0, st>>>(table, s.rows, s.K, s.V, s.D, add, part, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry point takes the sorted stream (rows_sorted and order [K]
// int32, dropped rows = V; src f32 rows of D, entry k reading row k / h),
// the scratch the wrapper allocated (`scratch_floats` floats, at least
// what `row_update_scratch_floats` asks; `chunk` must be kChunk) and the
// stream; each returns a cudaError_t (0 = launched).

// Floats of scratch a launch needs: n_chunks * 2 * n_acc * D, and for
// AdaGrad (n_acc = 1) n_chunks * 4 more.
long long row_update_scratch_floats(long long K, int D, int n_acc, int adagrad) {
  const long long n = chunks_of(K);
  return n * 2 * n_acc * D + (adagrad ? n * 4 : 0);
}

static bool bad_call(long long K, int D, int h, int chunk, long long have, long long need) {
  return bad_shape(K, D, h) || chunk != kChunk || have < need;
}

// table [V, D] (f32, or bf16 when table_bf16), updated in place; scale one
// f32 on the device.
int row_update(void* table, int table_bf16, const void* rows, const void* order, const void* src,
               const void* scale, long long K, int V, int D, int h, int stream_bf16, void* scratch,
               long long scratch_floats, int chunk, void* stream) {
  if (K <= 0) return 0;
  if (bad_call(K, D, h, chunk, scratch_floats, row_update_scratch_floats(K, D, 1, 0)))
    return (int)cudaErrorInvalidValue;
  const Stream s{(const int*)rows, (const int*)order, (const float*)src, K, V, D, h};
  Sgd rule{(const float*)scale, stream_bf16, 0.0f};
  cudaStream_t st = (cudaStream_t)stream;
  float* part = (float*)scratch;
  if (table_bf16) return (int)launch_rule((__nv_bfloat16*)table, s, rule, part, st, {table, src});
  return (int)launch_rule((float*)table, s, rule, part, st, {table, src});
}

// Lazy momentum: vel [V, D] f32 in place; lr one f32 on the device; keep =
// f32(1 - f32(1 - mu)).
int row_update_momentum(void* table, int table_bf16, void* vel, const void* rows, const void* order,
                        const void* src, const void* lr, float keep, float mu, float wd, int nesterov,
                        long long K, int V, int D, int h, void* scratch, long long scratch_floats, int chunk,
                        void* stream) {
  if (K <= 0) return 0;
  if (bad_call(K, D, h, chunk, scratch_floats, row_update_scratch_floats(K, D, 1, 0)))
    return (int)cudaErrorInvalidValue;
  const Stream s{(const int*)rows, (const int*)order, (const float*)src, K, V, D, h};
  cudaStream_t st = (cudaStream_t)stream;
  float* part = (float*)scratch;
  if (table_bf16) {
    Momentum<__nv_bfloat16> rule{{(float*)vel}, (const float*)lr, keep, mu, wd, nesterov, 0.0f};
    return (int)launch_rule((__nv_bfloat16*)table, s, rule, part, st, {table, src, vel});
  }
  Momentum<float> rule{{(float*)vel}, (const float*)lr, keep, mu, wd, nesterov, 0.0f};
  return (int)launch_rule((float*)table, s, rule, part, st, {table, src, vel});
}

// Lazy Adam: m and v [V, D] f32 in place; alpha one f32 on the device (the
// bias-corrected alpha_t); c = f32(1 - beta), keep = f32(1 - c).
int row_update_adam(void* table, int table_bf16, void* m, void* v, const void* rows, const void* order,
                    const void* src, const void* alpha, float c1, float c2, float keep1, float keep2, float eps,
                    float wd, long long K, int V, int D, int h, void* scratch, long long scratch_floats,
                    int chunk, void* stream) {
  if (K <= 0) return 0;
  if (bad_call(K, D, h, chunk, scratch_floats, row_update_scratch_floats(K, D, 2, 0)))
    return (int)cudaErrorInvalidValue;
  const Stream s{(const int*)rows, (const int*)order, (const float*)src, K, V, D, h};
  cudaStream_t st = (cudaStream_t)stream;
  float* part = (float*)scratch;
  if (table_bf16) {
    Adam<__nv_bfloat16> rule{{(float*)m, (float*)v}, (const float*)alpha, c1, c2, keep1, keep2, eps, wd, 0.0f};
    return (int)launch_rule((__nv_bfloat16*)table, s, rule, part, st, {table, src, m, v});
  }
  Adam<float> rule{{(float*)m, (float*)v}, (const float*)alpha, c1, c2, keep1, keep2, eps, wd, 0.0f};
  return (int)launch_rule((float*)table, s, rule, part, st, {table, src, m, v});
}

// Row-wise AdaGrad: accum [V] f32 in place; lr one f32 on the device.
int row_update_adagrad(void* table, int table_bf16, void* accum, const void* rows, const void* order,
                       const void* src, const void* lr, float eps, long long K, int V, int D, int h,
                       void* scratch, long long scratch_floats, int chunk, void* stream) {
  if (K <= 0) return 0;
  if (bad_call(K, D, h, chunk, scratch_floats, row_update_scratch_floats(K, D, 1, 1)))
    return (int)cudaErrorInvalidValue;
  const Stream s{(const int*)rows, (const int*)order, (const float*)src, K, V, D, h};
  cudaStream_t st = (cudaStream_t)stream;
  float* part = (float*)scratch;
  if (table_bf16)
    return (int)launch_adagrad((__nv_bfloat16*)table, (float*)accum, s, (const float*)lr, eps, part, st);
  return (int)launch_adagrad((float*)table, (float*)accum, s, (const float*)lr, eps, part, st);
}

const char* cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
