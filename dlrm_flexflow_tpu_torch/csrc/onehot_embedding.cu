// Small-vocabulary pooled lookup for Hopper (sm_90a): the forward of the
// one-hot embedding.
//
// Replaces the Pallas TPU kernel `_fwd_kernel`
// (dlrm_flexflow_tpu/ops/pallas/onehot_embedding.py:55, launched by
// `_onehot_fwd` at :104), which the JAX package runs under
// use_pallas="on" for a pooled table of at most
// `onehot_embedding_threshold` rows (ops/embedding.py:132-146). The TPU
// kernel multiplies a pooled one-hot matrix [B, V], cast to the compute
// dtype cdt, by the table cast to cdt, with an f32 accumulator, and writes
// the table's dtype (`_pooled_onehot`, :40-52). A one-hot product selects
// rows exactly, so for bag b of idx [B, H] into table [V, D] it is
//   out[b, :] = T(sum over distinct r in [0, V) of the bag of
//                 w_r * f32(cdt(table[r, :])))            (f32 sum)
//   w_r = cdt(n_r)                          SUM
//   w_r = cdt(f32(n_r) / max(cnt, 1))       AVG
// with n_r the multiplicity of r in the bag and cnt the number of entries
// >= 0. Note the AVG weight: it is rounded to cdt per distinct row, so with
// bf16 and n_r = 3 it differs from "sum, then divide". An index < 0 is
// padding; an index >= V matches no one-hot column and adds nothing, but it
// counts in cnt. Each product w_r * cdt(row) is exact in f32 for cdt = bf16.
//
// Bound. At mlperf-lite's serving shape (B = 16384, H = 1, D = 128, f32
// tables of 3 to 7,424 rows, 3.8 MB at most, which stay in the 50 MB L2)
// the function must read the indices (128 KB) and the distinct rows they
// name (at most the table) and write 8 MB: 3-4 us at 3.35 TB/s. The MXU's
// onehot[B, V] @ table exists to fill TPU lanes; here the same function is
// a gather, so it is bound by bytes, not by 2*B*V*D operations.
//
// Design (simple first).
//   - One warp per bag, lane l owns columns 4l + 128j (16-byte loads of an
//     f32 row, 8-byte of bf16; scalar loads when D % 4 != 0).
//   - Duplicates: the warp compares each member with the bag's earlier
//     members (O(H^2) index reads from L1; H is small) and adds a row only
//     at its first occurrence, with its multiplicity's weight.
//   - 8 bags a 256-thread block; no shared memory.
//
// The backward, `onehot_embedding_backward`, replaces the Pallas TPU kernel
// `_bwd_kernel` (:62, launched by `_onehot_bwd` at :138), the VJP of
// `onehot_embedding_pallas`. The TPU kernel accumulates dT += onehot^T @
// cdt(g) over batch tiles in VMEM and writes dT [V, D] f32. Here, for the
// gradient g [B, D] (f32 or bf16) of the pooled output,
//   dT[r, :] = sum over the bags b that hold r of w_{b,r} * f32(cdt(g[b, :]))
// with the forward's weight w_{b,r} (cdt(n_r), or cdt(n_r / max(cnt, 1))
// for AVG), each product rounded to f32 (exact for cdt = bf16), summed in
// f32; rows no bag holds are 0.
//
// Bound. At mlperf-lite's largest small table (V = 7424, D = 128, B =
// 16384, H = 1) the function must read the indices (64 KB) and g (8.4 MB
// f32) and write dT (3.8 MB): about 3.7 us at 3.35 TB/s. The TPU's dense
// one-hot product would be 2 * B * V * D = 31 GFLOP, which the card need
// not do: the function is a segmented sum.
//
// Design (simple first). The wrapper maps every member (b, j) of the bags
// to its row, or to the sentinel V (padding, rows >= V), and sorts the B * H
// keys stably (torch). One warp owns one output row r: it finds the run of
// r in the sorted keys by binary search, walks it in sorted order (bag
// order), keeps each bag's first occurrence of r with the bag's weight for
// r (O(H) index reads), and sums w * cdt(g[b]) over the run, lane l owning
// columns 4l + 128j as in the forward. Every row is written once, by its
// warp, zeros included: no atomics, the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(lo); v[1] = __high2float(lo);
  v[2] = __low2float(hi); v[3] = __high2float(hi);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&lo);
  q.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <bool kBf16>
__device__ __forceinline__ float round_cdt(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <typename T, typename TI, bool kVec, bool kCdtBf16>
__global__ void __launch_bounds__(kThreads) onehot_embedding_kernel(
    const T* __restrict__ table, const TI* __restrict__ idx, T* __restrict__ out, long long B,
    int H, long long V, int D, int avg) {
  const long long bag = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (bag >= B) return;
  const int lane = threadIdx.x & 31;
  const TI* bi = idx + bag * H;
  int cnt = 0;
  for (int h = 0; h < H; ++h) cnt += bi[h] >= 0;
  const float den = (float)max(cnt, 1);
  for (int d0 = lane * 4; d0 < D; d0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int h = 0; h < H; ++h) {
      const long long r = (long long)bi[h];
      if (r < 0 || r >= V) continue;
      bool first = true;
      for (int j = 0; j < h; ++j) first = first && (long long)bi[j] != r;
      if (!first) continue;
      int n = 1;
      for (int j = h + 1; j < H; ++j) n += (long long)bi[j] == r;
      const float w = round_cdt<kCdtBf16>(avg ? (float)n / den : (float)n);
      const T* p = table + r * D + d0;
      float v[4];
      if constexpr (kVec) {
        load4(p, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = d0 + e < D ? to_f32(p[e]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = fmaf(w, round_cdt<kCdtBf16>(v[e]), acc[e]);
    }
    T* o = out + bag * D + d0;
    if constexpr (kVec) {
      store4(o, acc);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < D) store1(o + e, acc[e]);
    }
  }
}

template <typename T, typename TI, bool kCdtBf16>
cudaError_t launch(const void* table, const void* idx, void* out, long long B, int H, long long V,
                   int D, int avg, cudaStream_t stream) {
  const long long blocks = (B + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* t = static_cast<const T*>(table);
  const TI* ix = static_cast<const TI*>(idx);
  T* o = static_cast<T*>(out);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(table) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  if (vec) {
    onehot_embedding_kernel<T, TI, true, kCdtBf16>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(t, ix, o, B, H, V, D, avg);
  } else {
    onehot_embedding_kernel<T, TI, false, kCdtBf16>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(t, ix, o, B, H, V, D, avg);
  }
  return cudaGetLastError();
}

template <typename T, typename TI>
cudaError_t launch_cdt(const void* table, const void* idx, void* out, long long B, int H,
                       long long V, int D, int avg, int cdt_bf16, cudaStream_t stream) {
  return cdt_bf16 ? launch<T, TI, true>(table, idx, out, B, H, V, D, avg, stream)
                  : launch<T, TI, false>(table, idx, out, B, H, V, D, avg, stream);
}

}  // namespace

extern "C" int onehot_embedding_forward(const void* table, const void* idx, void* out, long long B,
                                        int H, long long V, int D, int table_is_bf16,
                                        int idx_is_i64, int avg, int cdt_bf16, void* stream) {
  if (B < 1 || H < 1 || V < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (table_is_bf16) {
    err = idx_is_i64
              ? launch_cdt<__nv_bfloat16, long long>(table, idx, out, B, H, V, D, avg, cdt_bf16, s)
              : launch_cdt<__nv_bfloat16, int>(table, idx, out, B, H, V, D, avg, cdt_bf16, s);
  } else {
    err = idx_is_i64 ? launch_cdt<float, long long>(table, idx, out, B, H, V, D, avg, cdt_bf16, s)
                     : launch_cdt<float, int>(table, idx, out, B, H, V, D, avg, cdt_bf16, s);
  }
  return (int)err;
}

namespace {

template <typename TG, typename TI, bool kVec, bool kCdtBf16>
__global__ void __launch_bounds__(kThreads) onehot_embedding_backward_kernel(
    const int* __restrict__ keys, const int* __restrict__ order, const TI* __restrict__ idx,
    const TG* __restrict__ g, float* __restrict__ dt, long long N, int H, int V, int D, int avg) {
  const int r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= V) return;
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = N;  // the first sorted key >= r
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (keys[mid] < r) lo = mid + 1; else hi = mid;
  }
  for (int d0 = lane * 4; d0 < D; d0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (long long j = lo; j < N && keys[j] == r; ++j) {
      const int o = order[j];
      const long long b = o / H;
      const int pos = o - (int)b * H;
      const TI* bi = idx + b * H;
      bool first = true;
      int n = 0, cnt = 0;
      for (int e = 0; e < H; ++e) {
        const long long x = (long long)bi[e];
        const bool same = x == (long long)r;
        first = first && !(same && e < pos);
        n += same;
        cnt += x >= 0;
      }
      if (!first) continue;
      const float w =
          round_cdt<kCdtBf16>(avg ? __fdiv_rn((float)n, (float)max(cnt, 1)) : (float)n);
      const TG* p = g + b * D + d0;
      float v[4];
      if constexpr (kVec) {
        load4(p, v);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = d0 + e < D ? to_f32(p[e]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(w, round_cdt<kCdtBf16>(v[e])));
    }
    float* out = dt + (long long)r * D + d0;
    if constexpr (kVec) {
      store4(out, acc);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < D) out[e] = acc[e];
    }
  }
}

template <typename TG, typename TI, bool kCdtBf16>
cudaError_t launch_backward(const int* keys, const int* order, const void* idx, const void* g,
                            float* dt, long long N, int H, int V, int D, int avg,
                            cudaStream_t stream) {
  const unsigned blocks = (unsigned)((V + kThreads / 32 - 1) / (kThreads / 32));
  const TI* ix = static_cast<const TI*>(idx);
  const TG* gg = static_cast<const TG*>(g);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(g) % (4 * sizeof(TG)) == 0 &&
                   reinterpret_cast<uintptr_t>(dt) % 16 == 0;
  if (vec) {
    onehot_embedding_backward_kernel<TG, TI, true, kCdtBf16>
        <<<blocks, kThreads, 0, stream>>>(keys, order, ix, gg, dt, N, H, V, D, avg);
  } else {
    onehot_embedding_backward_kernel<TG, TI, false, kCdtBf16>
        <<<blocks, kThreads, 0, stream>>>(keys, order, ix, gg, dt, N, H, V, D, avg);
  }
  return cudaGetLastError();
}

template <typename TG, typename TI>
cudaError_t launch_backward_cdt(const int* keys, const int* order, const void* idx, const void* g,
                                float* dt, long long N, int H, int V, int D, int avg, int cdt_bf16,
                                cudaStream_t stream) {
  return cdt_bf16
             ? launch_backward<TG, TI, true>(keys, order, idx, g, dt, N, H, V, D, avg, stream)
             : launch_backward<TG, TI, false>(keys, order, idx, g, dt, N, H, V, D, avg, stream);
}

}  // namespace

// dt [V, D] f32, every row written; keys and order [B * H] int32: the
// members' rows (V for padding and rows >= V) sorted stably, and each
// sorted member's position b * H + j; idx [B, H]; g [B, D].
extern "C" int onehot_embedding_backward(const void* keys, const void* order, const void* idx,
                                         const void* g, void* dt, long long B, int H, int V, int D,
                                         int g_is_bf16, int idx_is_i64, int avg, int cdt_bf16,
                                         void* stream) {
  if (B < 1 || H < 1 || V < 1 || D < 1 || B * H >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* k = static_cast<const int*>(keys);
  const int* o = static_cast<const int*>(order);
  float* out = static_cast<float*>(dt);
  const long long n = B * H;
  cudaError_t err;
  if (g_is_bf16) {
    err = idx_is_i64 ? launch_backward_cdt<__nv_bfloat16, long long>(k, o, idx, g, out, n, H, V,
                                                                     D, avg, cdt_bf16, s)
                     : launch_backward_cdt<__nv_bfloat16, int>(k, o, idx, g, out, n, H, V, D,
                                                               avg, cdt_bf16, s);
  } else {
    err = idx_is_i64
              ? launch_backward_cdt<float, long long>(k, o, idx, g, out, n, H, V, D, avg, cdt_bf16, s)
              : launch_backward_cdt<float, int>(k, o, idx, g, out, n, H, V, D, avg, cdt_bf16, s);
  }
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
