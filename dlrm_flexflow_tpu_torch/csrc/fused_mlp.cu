// Fused dense layer for Hopper (sm_90a): out = cdt(act(x @ w^T + b)).
//
// Replaces the Pallas TPU kernel `_dense_kernel`
// (dlrm_flexflow_tpu/ops/pallas/fused_mlp.py:31, launched by `dense_pallas`
// at :105) as the JAX package calls it under use_pallas="on"
// (ops/dense.py:58-67): operands cast to the compute dtype cdt, an f32
// accumulator, the bias cast to cdt and added in f32, the activation in
// f32, the result cast to cdt and then back to the input's dtype:
//   out[m, n] = cdt(act(sum_k f32(cdt(x[m, k])) * f32(cdt(w[n, k]))
//                       + f32(cdt(b[n]))))
// x is [M, K] f32 or bf16, w the Dense parameter [N, K] = [out, in] f32 (the
// JAX package hands `dense_pallas` its transpose), b [N] f32 or none; out is
// [M, N] in x's dtype and holds values already rounded to cdt. cdt is bf16
// or f32; act is none, relu, sigmoid, tanh or gelu (tanh form).
//
// Bound. At mlperf-lite's largest layer (M = 16384, K = N = 1024) the
// function must read x (64 MB f32) and w (4 MB) and write out (64 MB):
// 40 us at 3.35 TB/s; it does 2*M*N*K = 34.4 GFLOP, 35 us at 989 TFLOP/s
// bf16. The eight mlperf-lite layers sit near that balance, so both the
// tensor cores and the bytes matter; a plain cast-then-matmul pipeline
// writes and reads the bf16 copies of x and w again and rounds the output
// in a further pass.
//
// Design (simple first; wgmma and TMA are later work).
//   - cdt = bf16: tensor cores through `mma.sync.m16n8k16` bf16 with f32
//     accumulators. A product of two bf16 values is exact in f32, so this is
//     XLA's arithmetic up to the order of the f32 sum. A 256-thread block
//     owns a 128 x 128 output tile; 8 warps of 64 x 32 each hold 4 x 4 mma
//     tiles (64 f32 accumulators a thread). K is walked in steps of 32.
//   - The casts are fused: each step's x and w tiles are read from global
//     memory as f32 (16-byte loads where K % 4 == 0, scalar loads otherwise),
//     rounded to bf16 in registers and stored to shared memory; the next
//     step's loads are issued before this step's mma, so they overlap. Two
//     shared buffers of 2 x 128 x 40 bf16 (the row padded from 32 to 40
//     elements so that the fragment loads of a warp fall on distinct banks),
//     40 KB in all.
//   - Ragged edges: rows past M or N and columns past K load as zero, and
//     the epilogue stores only inside [M, N]. So M = 1000, K = 13 or 479
//     and N = 1 need no padded copies.
//   - The epilogue adds f32(bf16(b)), applies the activation, rounds to bf16
//     and stores in x's dtype.
//   - cdt = f32: the same function with f32 FMAs on the CUDA cores (never
//     TF32): a 64 x 64 tile a block, 4 x 4 outputs a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3, kGelu = 4 };

__device__ __forceinline__ float activate(float y, int act) {
  switch (act) {
    case kRelu:
      return y < 0.f ? 0.f : y;  // keeps NaN, as torch.relu and jnp.maximum do
    case kSigmoid:
      return 1.f / (1.f + expf(-y));
    case kTanh:
      return tanhf(y);
    case kGelu: {
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * y * (1.f + tanhf(k * (y + 0.044715f * y * y * y)));
    }
    default:
      return y;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------- bf16 path
constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kPitch = kBK + 8;  // bf16 elements a shared row
constexpr int kGroups = kBM * kBK / 4 / kThreads;  // 4-column groups a thread loads per tile

// Loads this thread's share of rows [r0, r0 + 128) x columns [k0, k0 + 32)
// of a row-major [rows, K] matrix as f32, zero outside the matrix. Group i
// of thread t is tile row (t + 256 i) / 8, columns 4 * ((t + 256 i) % 8)
// onward.
template <typename T, bool kVec>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int rows, int K, int r0, int k0,
                                          float (&reg)[kGroups][4]) {
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = threadIdx.x + i * kThreads;
    const int r = r0 + g / (kBK / 4);
    const int c = k0 + (g % (kBK / 4)) * 4;
    const T* p = src + (long long)r * K + c;
    if constexpr (kVec) {
      // K % 4 == 0: a group lies wholly inside or wholly outside the matrix
      if (r < rows && c < K) {
        if constexpr (std::is_same<T, float>::value) {
          const float4 v = *reinterpret_cast<const float4*>(p);
          reg[i][0] = v.x; reg[i][1] = v.y; reg[i][2] = v.z; reg[i][3] = v.w;
        } else {
          const uint2 v = *reinterpret_cast<const uint2*>(p);
          const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
          const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
          reg[i][0] = __low2float(lo); reg[i][1] = __high2float(lo);
          reg[i][2] = __low2float(hi); reg[i][3] = __high2float(hi);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) reg[i][j] = 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) reg[i][j] = (r < rows && c + j < K) ? to_f32(p[j]) : 0.f;
    }
  }
}

// Rounds the loaded groups to bf16 and stores them as tile [128][kPitch].
__device__ __forceinline__ void store_tile(__nv_bfloat16* tile, const float (&reg)[kGroups][4]) {
#pragma unroll
  for (int i = 0; i < kGroups; ++i) {
    const int g = threadIdx.x + i * kThreads;
    const int r = g / (kBK / 4);
    const int c = (g % (kBK / 4)) * 4;
    uint2 packed;
    __nv_bfloat162 lo = __floats2bfloat162_rn(reg[i][0], reg[i][1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(reg[i][2], reg[i][3]);
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(tile + r * kPitch + c) = packed;
  }
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <typename TX, bool kVec>
__global__ void __launch_bounds__(kThreads) dense_bf16_kernel(
    const TX* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    TX* __restrict__ out, int M, int N, int K, int act, int n_tiles_n) {
  __shared__ __align__(16) __nv_bfloat16 sa[2][kBM * kPitch];
  __shared__ __align__(16) __nv_bfloat16 sb[2][kBN * kPitch];

  const int m0 = (blockIdx.x / n_tiles_n) * kBM;
  const int n0 = (blockIdx.x % n_tiles_n) * kBN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64;  // the warp's rows in the tile
  const int wn = (warp & 3) * 32;   // and its columns
  const int grp = lane >> 2;        // mma fragment row / column group
  const int tig = lane & 3;         // thread in group

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  float ra[kGroups][4], rb[kGroups][4];
  const int n_k = (K + kBK - 1) / kBK;
  load_tile<TX, kVec>(x, M, K, m0, 0, ra);
  load_tile<float, kVec>(w, N, K, n0, 0, rb);
  store_tile(sa[0], ra);
  store_tile(sb[0], rb);
  __syncthreads();

  for (int kt = 0; kt < n_k; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_k) {  // next step's loads in flight during this step's mma
      load_tile<TX, kVec>(x, M, K, m0, (kt + 1) * kBK, ra);
      load_tile<float, kVec>(w, N, K, n0, (kt + 1) * kBK, rb);
    }
    const __nv_bfloat16* ta = sa[cur];
    const __nv_bfloat16* tb = sb[cur];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t af[4][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const __nv_bfloat16* p = ta + (wm + i * 16 + grp) * kPitch + ks + tig * 2;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * kPitch);
        af[i][2] = lds32(p + 8);
        af[i][3] = lds32(p + 8 * kPitch + 8);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat16* p = tb + (wn + j * 8 + grp) * kPitch + ks + tig * 2;
        bf[j][0] = lds32(p);
        bf[j][1] = lds32(p + 8);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < n_k) {
      // the buffer written here was last read in step kt - 1, before the
      // barrier that ended it
      store_tile(sa[cur ^ 1], ra);
      store_tile(sb[cur ^ 1], rb);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at (grp, 2 tig + {0, 1}); c2, c3 eight rows below
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + wn + j * 8 + tig * 2;
    float bias[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) bias[e] = (b != nullptr && n + e < N) ? round_bf16(b[n + e]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + grp + h * 8;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (n + e < N) {
            const float y = activate(acc[i][j][h * 2 + e] + bias[e], act);
            store(out + (long long)m * N + n + e, round_bf16(y));
          }
        }
      }
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int kFT = 64, kFK = 16;

template <typename TX>
__global__ void __launch_bounds__(kThreads) dense_f32_kernel(
    const TX* __restrict__ x, const float* __restrict__ w, const float* __restrict__ b,
    TX* __restrict__ out, int M, int N, int K, int act, int n_tiles_n) {
  __shared__ float sa[kFK][kFT + 4];  // [k][m]
  __shared__ float sb[kFK][kFT + 4];  // [k][n]
  const int m0 = (blockIdx.x / n_tiles_n) * kFT;
  const int n0 = (blockIdx.x % n_tiles_n) * kFT;
  const int tm = (threadIdx.x / 16) * 4;
  const int tn = (threadIdx.x % 16) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
    for (int i = 0; i < kFT * kFK / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kFK;
      const int c = e % kFK;
      const int k = k0 + c;
      sa[c][r] = (m0 + r < M && k < K) ? to_f32(x[(long long)(m0 + r) * K + k]) : 0.f;
      sb[c][r] = (n0 + r < N && k < K) ? w[(long long)(n0 + r) * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], c[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = sa[k][tm + u];
        c[u] = sb[k][tn + u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], c[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m0 + tm + u;
    if (m >= M) continue;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int n = n0 + tn + v;
      if (n < N) {
        const float bias = b != nullptr ? b[n] : 0.f;
        store(out + (long long)m * N + n, activate(acc[u][v] + bias, act));
      }
    }
  }
}

template <typename TX>
cudaError_t launch(const void* x, const float* w, const float* b, void* out, int M, int N, int K,
                   int act, int cdt_bf16, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  TX* op = static_cast<TX*>(out);
  if (cdt_bf16) {
    const int tn = (N + kBN - 1) / kBN;
    const long long blocks = (long long)((M + kBM - 1) / kBM) * tn;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    // 16-byte (f32) or 8-byte (bf16) row loads need K % 4 == 0 and aligned bases
    const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TX)) == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (vec) {
      dense_bf16_kernel<TX, true><<<(unsigned)blocks, kThreads, 0, stream>>>(xp, w, b, op, M, N, K,
                                                                           act, tn);
    } else {
      dense_bf16_kernel<TX, false><<<(unsigned)blocks, kThreads, 0, stream>>>(xp, w, b, op, M, N, K,
                                                                            act, tn);
    }
  } else {
    const int tn = (N + kFT - 1) / kFT;
    const long long blocks = (long long)((M + kFT - 1) / kFT) * tn;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    dense_f32_kernel<TX><<<(unsigned)blocks, kThreads, 0, stream>>>(xp, w, b, op, M, N, K, act, tn);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_dense_forward(const void* x, const void* w, const void* b, void* out, int M,
                                   int N, int K, int act, int x_is_bf16, int cdt_bf16,
                                   void* stream) {
  if (M < 1 || N < 1 || K < 1 || act < kNone || act > kGelu) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  const cudaError_t err =
      x_is_bf16 ? launch<__nv_bfloat16>(x, wp, bp, out, M, N, K, act, cdt_bf16, s)
                : launch<float>(x, wp, bp, out, M, N, K, act, cdt_bf16, s);
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
