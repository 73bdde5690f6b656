// Pooled embedding-bag lookup for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bag_kernel`
// (dlrm_flexflow_tpu/ops/pallas/embedding_bag.py:38, launched by `_bag_fwd`
// at :90), which the JAX package runs under use_pallas="on" for a pooled
// table with D % 128 == 0 (ops/embedding.py:155-162). For bag m of
// idx [M, H] into table [R, D] (f32, bf16, or f16 after
// quantize_embeddings("float16")):
//   out[m, :] = T(sum over h with idx[m, h] >= 0 of f32(table[idx[m, h], :]))
// summed in f32 in bag order; AVG divides the sum by max(#(idx >= 0), 1).
// idx < 0 is padding. An index >= R gives a NaN row (the port's plain
// gather fills such a row with NaN, as `jnp.take` does); the kernel never
// reads outside the table. out is [M, D] in the table's dtype.
//
// Bound. At mlperf-lite's serving shape (M = 16384, H = 1, D = 128, f32
// tables of up to 2M rows) the function must read the indices (128 KB of
// int64) and the rows they name (at most 8 MB) and write 8 MB: about
// 5 us at 3.35 TB/s. It adds nothing worth counting. So it is bound by
// bytes, and by the latency of the index -> row load chain: the TPU kernel
// double-buffers its row DMAs across bags for the same reason.
//
// Design (simple first).
//   - One warp per bag; lane l owns columns 4l + 128j. A row of 128 f32 is
//     one 16-byte load per lane (8 bytes for bf16), coalesced into 512
//     contiguous bytes. D % 4 != 0 falls back to scalar loads.
//   - The bag is walked 4 members at a time: the 4 indices first, then the 4
//     row loads, then the 4 adds, so up to 4 rows per warp are in flight;
//     with 64 warps resident on an SM, thousands of rows are in flight on
//     the card. The adds keep bag order.
//   - 8 bags a 256-thread block; no shared memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

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
__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __half2 lo = *reinterpret_cast<const __half2*>(&q.x);
  const __half2 hi = *reinterpret_cast<const __half2*>(&q.y);
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
__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  __half2 lo = __floats2half2_rn(v[0], v[1]);
  __half2 hi = __floats2half2_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&lo);
  q.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = q;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(__half* p, float v) { *p = __float2half_rn(v); }

template <typename T, typename TI, bool kVec>
__global__ void __launch_bounds__(kThreads) embedding_bag_kernel(
    const T* __restrict__ table, const TI* __restrict__ idx, T* __restrict__ out, long long M,
    int H, long long R, int D, int avg) {
  const long long bag = (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (bag >= M) return;
  const int lane = threadIdx.x & 31;
  const TI* bi = idx + bag * H;
  for (int d0 = lane * 4; d0 < D; d0 += 128) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    int cnt = 0;
    bool nan_row = false;
    for (int h0 = 0; h0 < H; h0 += kUnroll) {
      long long r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) r[u] = h0 + u < H ? (long long)bi[h0 + u] : -1;
      float v[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool in = r[u] >= 0 && r[u] < R;
        const T* p = table + (in ? r[u] : 0) * D + d0;
        if constexpr (kVec) {
          if (in) {
            load4(p, v[u]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) v[u][e] = 0.f;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) v[u][e] = (in && d0 + e < D) ? to_f32(p[e]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r[u] < 0) continue;
        ++cnt;
        if (r[u] >= R) {
          nan_row = true;
          continue;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += v[u][e];
      }
    }
    const float den = avg ? (float)max(cnt, 1) : 1.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[e] = nan_row ? __int_as_float(0x7fc00000) : acc[e];
      if (avg) acc[e] = acc[e] / den;
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

template <typename T, typename TI>
cudaError_t launch(const void* table, const void* idx, void* out, long long M, int H, long long R,
                   int D, int avg, cudaStream_t stream) {
  const long long blocks = (M + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* t = static_cast<const T*>(table);
  const TI* ix = static_cast<const TI*>(idx);
  T* o = static_cast<T*>(out);
  // whole 4-element groups in 16-byte (f32) or 8-byte (bf16) loads
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(table) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  if (vec) {
    embedding_bag_kernel<T, TI, true><<<(unsigned)blocks, kThreads, 0, stream>>>(t, ix, o, M, H, R,
                                                                                D, avg);
  } else {
    embedding_bag_kernel<T, TI, false><<<(unsigned)blocks, kThreads, 0, stream>>>(t, ix, o, M, H, R,
                                                                                 D, avg);
  }
  return cudaGetLastError();
}

}  // namespace

// table_dtype: 0 float32, 1 bfloat16, 2 float16 (the table's, and the output's)
extern "C" int embedding_bag_forward(const void* table, const void* idx, void* out, long long M,
                                     int H, long long R, int D, int table_dtype, int idx_is_i64,
                                     int avg, void* stream) {
  if (M < 1 || H < 1 || R < 1 || D < 1 || table_dtype < 0 || table_dtype > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (table_dtype == 1) {
    err = idx_is_i64 ? launch<__nv_bfloat16, long long>(table, idx, out, M, H, R, D, avg, s)
                     : launch<__nv_bfloat16, int>(table, idx, out, M, H, R, D, avg, s);
  } else if (table_dtype == 2) {
    err = idx_is_i64 ? launch<__half, long long>(table, idx, out, M, H, R, D, avg, s)
                     : launch<__half, int>(table, idx, out, M, H, R, D, avg, s);
  } else {
    err = idx_is_i64 ? launch<float, long long>(table, idx, out, M, H, R, D, avg, s)
                     : launch<float, int>(table, idx, out, M, H, R, D, avg, s);
  }
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
