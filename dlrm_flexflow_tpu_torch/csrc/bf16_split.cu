// The exact three-way bf16 split of an f32 matrix, for the Dense backward.
//
// Replaces no TPU kernel: the JAX package leaves the Dense products to XLA.
// It was added so that the port's Dense backward can multiply the f32
// cotangent g [M, N] on the bf16 tensor cores without rounding it
// (ops/dense.py `Bf16Product`). g is split as
//     hi = bf16(g),  mid = bf16(g - hi),  lo = bf16(g - hi - mid)
// (round to nearest even each time, and both differences exact in f32), so
// hi + mid + lo == g bit for bit: three 8-bit significands cover f32's 24.
// That holds for every finite g that is a multiple of 2^-133, bf16's
// smallest step (every |g| >= 2^-110); below, lo is g's tail rounded to
// that step. Each part's product with a bf16 value is exact in f32, so
// dX = G3 @ [w; w; w] and dW = sum of the blocks of G3^T @ x are the f32
// sums of the f32 products in another order.
//
// The parts go side by side into one bf16 buffer G3 [M, 3 * Np]: row m is
// [hi | mid | lo], each Np wide (N rounded up to 8, zeros past N), so every
// row of G3 and of each part is a whole number of 16-byte units, as the
// tensor-core products want. Where hi is infinite (an infinite g, or one
// past bf16's largest finite value) mid = lo = 0, so the parts sum to hi.
//
// Bound: memory. 4 bytes read and 6 written a element (plus the padding's
// zeros): at kaggle's largest cotangent [65536, 512], 134.2 MB read and
// 201.3 MB written, 0.100 ms at 3.35 TB/s. The arithmetic is a few
// instructions a value.
//
// Design: one pass, every byte touched once, nothing staged. Where N is a
// multiple of 8 (and both bases 16-byte aligned) a thread takes 8
// consecutive values of a row: two 16-byte loads and three 16-byte stores,
// one a part, neighbouring threads on neighbouring addresses. Otherwise
// (the narrow layers, N = 1) a thread takes one (row, column < Np) pair and
// writes three 2-byte values.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void split3(float v, __nv_bfloat16& hi, __nv_bfloat16& mid, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  const float h = __bfloat162float(hi);
  const float r = isinf(h) ? 0.0f : v - h;
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(a)) | (static_cast<unsigned>(__bfloat16_as_ushort(b)) << 16);
}

// N a multiple of 8: thread t takes values [8t, 8t + 8) of g.
__global__ void split_bf16x3_vec8_kernel(const float4* __restrict__ g, __nv_bfloat16* __restrict__ out,
                                         long long vectors, int n) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= vectors) return;
  const long long e = t * 8;
  const long long m = e / n;
  const long long j = e - m * n;
  const float4 a = g[2 * t];
  const float4 b = g[2 * t + 1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  __nv_bfloat16 hi[8], mid[8], lo[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) split3(v[i], hi[i], mid[i], lo[i]);
  uint4* row = reinterpret_cast<uint4*>(out + m * 3 * n + j);
  const long long part = n / 8;  // one part's width in 16-byte units
  row[0] = make_uint4(pack2(hi[0], hi[1]), pack2(hi[2], hi[3]), pack2(hi[4], hi[5]), pack2(hi[6], hi[7]));
  row[part] = make_uint4(pack2(mid[0], mid[1]), pack2(mid[2], mid[3]), pack2(mid[4], mid[5]), pack2(mid[6], mid[7]));
  row[2 * part] = make_uint4(pack2(lo[0], lo[1]), pack2(lo[2], lo[3]), pack2(lo[4], lo[5]), pack2(lo[6], lo[7]));
}

// Any N: thread t takes (row t / np, column t % np), zero past n.
__global__ void split_bf16x3_kernel(const float* __restrict__ g, __nv_bfloat16* __restrict__ out,
                                    long long total, int n, int np) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long m = t / np;
  const long long j = t - m * np;
  const float v = j < n ? g[m * n + j] : 0.0f;
  __nv_bfloat16 hi, mid, lo;
  split3(v, hi, mid, lo);
  __nv_bfloat16* row = out + m * 3 * np + j;
  row[0] = hi;
  row[np] = mid;
  row[2 * np] = lo;
}

}  // namespace

// g: f32 [M, N] contiguous; out: bf16 [M, 3 * np] contiguous, np >= N a
// multiple of 8. Launches on `stream`; returns cudaGetLastError().
extern "C" int split_bf16x3(const void* g, void* out, long long M, int N, int np, void* stream) {
  if (M <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  const bool vec = N == np && N % 8 == 0 && reinterpret_cast<std::uintptr_t>(g) % 16 == 0 &&
                   reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  if (vec) {
    const long long vectors = M * N / 8;
    const long long blocks = (vectors + kThreads - 1) / kThreads;
    split_bf16x3_vec8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float4*>(g), static_cast<__nv_bfloat16*>(out), vectors, N);
  } else {
    const long long total = M * np;
    const long long blocks = (total + kThreads - 1) / kThreads;
    split_bf16x3_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<__nv_bfloat16*>(out), total, N, np);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
