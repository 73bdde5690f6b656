// The DCN-V2 cross network's f32 epilogue, forward and backward, one pass each.
//
// Replaces no TPU kernel: the JAX package leaves the cross network to XLA,
// which fuses the elementwise work around the products itself. The port
// (ops/cross.py `FusedCrossNet`) keeps the six products of a layer
//     x_{l+1} = x0 * (W (V x_l) + b) + x_l
// on cuBLAS's bf16 tensor cores with f32 sums, and does all the work between
// them here, over f32 [M, d] tensors:
//
//   cross_forward   p = W v (f32, no bias), b, x0, x_l  ->  x_{l+1} = x0 * (p + b) + x_l
//                   and, in the same pass, bf16(x_{l+1}), the next V product's operand;
//   cross_backward  G_{l+2}, dxV (the f32 V-input gradient of layer l + 1), p, b, x0
//                   ->  G_{l+1} = G_{l+2} + bf16(dxV)          (the residual stream's gradient)
//                       gx0 (+)= G_{l+1} * (p + b)              (x0's running gradient, in place)
//                       G3 = split3(G_{l+1} * x0)               (the W product's cotangent, [hi | mid | lo])
//                       partial[block] = sum over the block's rows of G_{l+1} * x0   (for b's gradient);
//   cross_bias_sum  b's gradient: the partials summed in block order;
//   cross_fold      x0's gradient: gx0 + (G_1 + bf16(dxV_0)).
//
// Every product and sum is rounded to f32 once, in the order PyTorch's
// separate passes take (no contraction into fma but x0 * u + x_l, which
// PyTorch's addcmul rounds once), so each output equals those passes' bit
// for bit but for b's gradient, whose sum over rows runs in another fixed
// order: run to run it repeats bit for bit (no atomics).
// The split is bf16_split.cu's: hi = bf16(g), mid = bf16(g - hi),
// lo = bf16(g - hi - mid), so hi + mid + lo == g.
//
// Bound: memory. At d = 3456, M = 65536 one f32 [M, d] tensor F is 906 MB.
// The forward reads 3 F and writes 1.5 F (x_{l+1} and its bf16 copy); the
// backward reads 5 F (G_{l+2}, dxV, p, x0, gx0) and writes 3.5 F (G_{l+1},
// gx0, G3 at 1.5 F); the fold reads 3 F and writes 1 F.
//
// Design: a block is 32 x 8 threads over 256 columns and kRows rows; a
// thread takes 8 consecutive columns (two 16-byte loads of each f32
// operand, neighbouring threads on neighbouring addresses) and walks its
// rows, so b is read once a thread. The backward keeps its 8 columns'
// partial sums of G * x0 in registers, sums the 8 row groups of its block
// through shared memory in a fixed order, and writes one row of partials a
// block; cross_bias_sum adds those rows in order. The last layer's
// backward has no dxV: it takes the incoming gradient as G and writes no G.
// d is a multiple of 8 and every base 16-byte aligned (the wrapper checks
// both).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kColThreads = 32;   // threads across a block's columns, 8 columns each
constexpr int kRowThreads = 8;    // row groups of a block
constexpr int kRows = 256;        // rows a block
constexpr int kBlockCols = kColThreads * 8;

struct F8 {
  float v[8];
};

__device__ __forceinline__ F8 load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return {{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store8(float* p, const F8& x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x.v[4], x.v[5], x.v[6], x.v[7]);
}

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<unsigned>(__bfloat16_as_ushort(a)) | (static_cast<unsigned>(__bfloat16_as_ushort(b)) << 16);
}

__device__ __forceinline__ uint4 pack8(const __nv_bfloat16* h) {
  return make_uint4(pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[4], h[5]), pack2(h[6], h[7]));
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ void split3(float v, __nv_bfloat16& hi, __nv_bfloat16& mid, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  const float h = __bfloat162float(hi);
  const float r = isinf(h) ? 0.0f : __fsub_rn(v, h);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(mid)));
}

// x_out = x0 * (p + b) + x; x_bf16 (if not null) = bf16(x_out).
// x_out may be x (the same element is read before it is written).
__global__ void __launch_bounds__(kColThreads* kRowThreads)
    cross_forward_kernel(const float* __restrict__ p, const float* __restrict__ bias, const float* __restrict__ x0,
                         const float* x, float* x_out, __nv_bfloat16* __restrict__ x_bf16, long long m, int d) {
  const int col = (blockIdx.y * kColThreads + threadIdx.x) * 8;
  if (col >= d) return;
  const F8 b = load8(bias + col);
  const long long row_end = min(m, static_cast<long long>(blockIdx.x + 1) * kRows);
  for (long long row = static_cast<long long>(blockIdx.x) * kRows + threadIdx.y; row < row_end; row += kRowThreads) {
    const long long e = row * d + col;
    const F8 pv = load8(p + e), x0v = load8(x0 + e), xv = load8(x + e);
    F8 out;
    __nv_bfloat16 h[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      out.v[i] = __fmaf_rn(x0v.v[i], __fadd_rn(pv.v[i], b.v[i]), xv.v[i]);  // as addcmul rounds it
      h[i] = __float2bfloat16_rn(out.v[i]);
    }
    store8(x_out + e, out);
    if (x_bf16 != nullptr) *reinterpret_cast<uint4*>(x_bf16 + e) = pack8(h);
  }
}

// G = g_in + bf16(dxv) (dxv null: G = g_in), written to g_out where given
// (g_out may be g_in); gx0 = G * (p + b) (first) or gx0 + G * (p + b);
// g3 row m = [hi | mid | lo] of G * x0, each d wide; partial[blockIdx.x] =
// the block's sum over its rows of G * x0, by column.
__global__ void __launch_bounds__(kColThreads* kRowThreads)
    cross_backward_kernel(const float* g_in, const float* __restrict__ dxv, const float* __restrict__ p,
                          const float* __restrict__ bias, const float* __restrict__ x0, float* __restrict__ gx0,
                          float* g_out, __nv_bfloat16* __restrict__ g3, float* __restrict__ partial, long long m,
                          int d, int first) {
  __shared__ float sums[kRowThreads][kBlockCols];
  const int col = (blockIdx.y * kColThreads + threadIdx.x) * 8;
  const bool live = col < d;
  F8 acc = {{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
  if (live) {
    const F8 b = load8(bias + col);
    const long long row_end = min(m, static_cast<long long>(blockIdx.x + 1) * kRows);
    for (long long row = static_cast<long long>(blockIdx.x) * kRows + threadIdx.y; row < row_end;
         row += kRowThreads) {
      const long long e = row * d + col;
      F8 g = load8(g_in + e);
      const F8 pv = load8(p + e), x0v = load8(x0 + e);
      const F8 acc0 = first ? F8{} : load8(gx0 + e);
      if (dxv != nullptr) {
        const F8 dv = load8(dxv + e);
#pragma unroll
        for (int i = 0; i < 8; ++i) g.v[i] = __fadd_rn(g.v[i], round_bf16(dv.v[i]));
        if (g_out != nullptr) store8(g_out + e, g);
      }
      F8 gx;
      __nv_bfloat16 hi[8], mid[8], lo[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = __fmul_rn(g.v[i], __fadd_rn(pv.v[i], b.v[i]));
        gx.v[i] = first ? t : __fadd_rn(acc0.v[i], t);
        const float gy = __fmul_rn(g.v[i], x0v.v[i]);
        split3(gy, hi[i], mid[i], lo[i]);
        acc.v[i] = __fadd_rn(acc.v[i], gy);
      }
      store8(gx0 + e, gx);
      uint4* out = reinterpret_cast<uint4*>(g3 + row * 3 * d + col);
      const int part = d / 8;  // one part's width in 16-byte units
      out[0] = pack8(hi);
      out[part] = pack8(mid);
      out[2 * part] = pack8(lo);
    }
  }
  float* mine = &sums[threadIdx.y][threadIdx.x * 8];
  reinterpret_cast<float4*>(mine)[0] = make_float4(acc.v[0], acc.v[1], acc.v[2], acc.v[3]);
  reinterpret_cast<float4*>(mine)[1] = make_float4(acc.v[4], acc.v[5], acc.v[6], acc.v[7]);
  __syncthreads();
  // thread k of the block sums column k of the block over its row groups, in order
  const int k = threadIdx.y * kColThreads + threadIdx.x;
  const int c = blockIdx.y * kBlockCols + k;
  if (c < d) {
    float s = sums[0][k];
#pragma unroll
    for (int r = 1; r < kRowThreads; ++r) s = __fadd_rn(s, sums[r][k]);
    partial[static_cast<long long>(blockIdx.x) * d + c] = s;
  }
}

// out[c] = sum over blocks r = 0, 1, ... of partial[r][c], in that order.
__global__ void cross_bias_sum_kernel(const float* __restrict__ partial, float* __restrict__ out, int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = partial[c];
  for (int r = 1; r < blocks; ++r) s = __fadd_rn(s, partial[static_cast<long long>(r) * d + c]);
  out[c] = s;
}

// gx0 = gx0 + (g + bf16(dxv)), 8 values a thread.
__global__ void cross_fold_kernel(float* __restrict__ gx0, const float* __restrict__ g,
                                  const float* __restrict__ dxv, long long vectors) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= vectors) return;
  const long long e = t * 8;
  const F8 a = load8(gx0 + e), gv = load8(g + e), dv = load8(dxv + e);
  F8 r;
#pragma unroll
  for (int i = 0; i < 8; ++i) r.v[i] = __fadd_rn(a.v[i], __fadd_rn(gv.v[i], round_bf16(dv.v[i])));
  store8(gx0 + e, r);
}

dim3 grid_of(long long m, int d) {
  return dim3(static_cast<unsigned>((m + kRows - 1) / kRows), static_cast<unsigned>((d + kBlockCols - 1) / kBlockCols));
}

}  // namespace

extern "C" {

// The row blocks of the backward's bias partials for M rows: the partials
// buffer is [cross_row_blocks(M), d] f32.
long long cross_row_blocks(long long m) { return (m + kRows - 1) / kRows; }

// The most f32 additions a term of b's gradient passes through for M rows:
// its thread's rows, its block's row groups, then the row blocks. The sum's
// error is at most this many roundings of the sum of the terms' magnitudes.
long long cross_sum_depth(long long m) { return kRows / kRowThreads + kRowThreads + cross_row_blocks(m); }

// p, x0, x, x_out: f32 [M, d]; bias f32 [d]; x_bf16 bf16 [M, d] or null.
int cross_forward(const void* p, const void* bias, const void* x0, const void* x, void* x_out, void* x_bf16,
                  long long m, int d, void* stream) {
  if (m <= 0) return 0;
  cross_forward_kernel<<<grid_of(m, d), dim3(kColThreads, kRowThreads), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(bias), static_cast<const float*>(x0),
      static_cast<const float*>(x), static_cast<float*>(x_out), static_cast<__nv_bfloat16*>(x_bf16), m, d);
  return static_cast<int>(cudaGetLastError());
}

// g_in, p, x0, gx0: f32 [M, d]; dxv and g_out f32 [M, d] or null; bias f32
// [d]; g3 bf16 [M, 3d]; partial f32 [cross_row_blocks(M), d]; bias_grad f32 [d].
int cross_backward(const void* g_in, const void* dxv, const void* p, const void* bias, const void* x0, void* gx0,
                   void* g_out, void* g3, void* partial, void* bias_grad, long long m, int d, int first,
                   void* stream) {
  if (m <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  cross_backward_kernel<<<grid_of(m, d), dim3(kColThreads, kRowThreads), 0, s>>>(
      static_cast<const float*>(g_in), static_cast<const float*>(dxv), static_cast<const float*>(p),
      static_cast<const float*>(bias), static_cast<const float*>(x0), static_cast<float*>(gx0),
      static_cast<float*>(g_out), static_cast<__nv_bfloat16*>(g3), static_cast<float*>(partial), m, d, first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cross_bias_sum_kernel<<<(d + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial),
                                                         static_cast<float*>(bias_grad),
                                                         static_cast<int>(cross_row_blocks(m)), d);
  return static_cast<int>(cudaGetLastError());
}

// gx0 (in place), g, dxv: f32 [M, d], M * d = n a multiple of 8.
int cross_fold(void* gx0, const void* g, const void* dxv, long long n, void* stream) {
  const long long vectors = n / 8;
  if (vectors <= 0) return 0;
  cross_fold_kernel<<<static_cast<unsigned>((vectors + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(gx0), static_cast<const float*>(g), static_cast<const float*>(dxv), vectors);
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
