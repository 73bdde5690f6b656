// Pairwise dot-product feature interaction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_interaction_kernel`
// (dlrm_flexflow_tpu/ops/pallas/dot_interaction.py:42, launched by
// `_interaction_fwd` at :77). It computes
//     out[b, p] = sum_d x[b, r_p, d] * x[b, c_p, d]        (f32)
// over the pair list np.tril_indices(F, -1) (or (F, 0) with self
// interaction), row-major: pair (i, j) sits at i*(i-1)/2 + j
// (i*(i+1)/2 + j with the diagonal). x is [B, F, D] contiguous, f32 or bf16
// (read as f32); out is [B, P] f32. Any B, 1 <= F <= 64, any D.
//
// Bound. At the mlperf-lite serving shape x = [16384, 27, 128] f32 the
// kernel must read 16384*27*128*4 B = 226.5 MB and write 16384*351*4 B =
// 23.0 MB: 249.5 MB, 74.5 us at 3.35 TB/s. The useful work is
// 2*16384*351*128 = 1.47 GFLOP of f32, 22 us at 67 TFLOP/s. So it is
// memory-bound: the design reads x once, coalesced, and never writes the
// [B, F, F] Gram matrix that a bmm would.
//
// Design (simple first; wgmma/TMA are later work).
//   - A block takes `rows` consecutive batch rows. It stages them in shared
//     memory as f32, one warp per (row, feature) line of D values, so every
//     global read is a contiguous run. f32 input is copied with cp.async:
//     loads through registers let ptxas place each shared store right
//     after its load, leaving one load latency per line exposed (measured
//     1.5x slower at the serving shape). bf16 input is widened through
//     registers. D is staged in chunks of kChunkD columns, so any D fits;
//     the sums stay in registers across chunks.
//   - The Gram matrix of one row is cut into 4x4 tiles over (i, j); only
//     tiles on or below the diagonal exist. One thread owns one tile: per
//     d it reads 4 + 4 values from shared memory and does 16 FMAs. The line
//     stride is min(D, kChunkD) + 1 floats (129 at D = 128), so the lines a
//     warp reads at one d fall on different banks.
//   - The results go to shared memory in pair order and leave as one
//     contiguous run of rows*P floats.
//   - `rows` is set so that a block uses at most 48 KB of shared memory and
//     256 threads; several blocks share an SM, so one block's loads overlap
//     another's arithmetic.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kTile = 4;           // a thread owns a kTile x kTile block of Z
constexpr int kChunkD = 128;       // D columns staged per pass
constexpr int kMaxF = 64;
constexpr int kMaxThreads = 256;
constexpr int kSmemBudget = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void dot_interaction_kernel(const T* __restrict__ x, float* __restrict__ out,
                                       int B, int F, int D, int P, int self_interaction,
                                       int rows_per_block, int tiles_per_row, int stride) {
  extern __shared__ float smem[];
  const long long b0 = (long long)blockIdx.x * rows_per_block;
  const int nb = (int)min((long long)rows_per_block, (long long)B - b0);

  // this thread's tile: batch row r of the block, tile t of the lower
  // triangle of tiles, row-major: t -> (ti, tj) with tj <= ti
  const int r = threadIdx.x / tiles_per_row;
  const int t = threadIdx.x - r * tiles_per_row;
  const bool active = r < nb;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  // line offsets in shared memory; lines past F are clamped (their sums
  // are computed and dropped)
  int oi[kTile], oj[kTile];
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    oi[k] = (r * F + min(i0 + k, F - 1)) * stride;
    oj[k] = (r * F + min(j0 + k, F - 1)) * stride;
  }

  float acc[kTile][kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int c = 0; c < kTile; ++c) acc[a][c] = 0.f;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_lines = nb * F;
  const T* xb = x + b0 * F * (long long)D;

  for (int d0 = 0; d0 < D; d0 += kChunkD) {
    const int dc = min(kChunkD, D - d0);
    __syncthreads();  // the previous chunk has been consumed
    // one warp per (row, feature) line; f32 lines go global -> shared by
    // cp.async, so a warp keeps all its copies in flight at once
    for (int q = warp; q < n_lines; q += n_warps) {
      const T* src = xb + (long long)q * D + d0;
      float* dst = smem + q * stride;
      for (int d = lane; d < dc; d += 32) {
        if constexpr (std::is_same<T, float>::value) {
          __pipeline_memcpy_async(dst + d, src + d, sizeof(float));
        } else {
          dst[d] = to_f32(src[d]);
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (active) {
      for (int d = 0; d < dc; ++d) {
        float a[kTile], c[kTile];
#pragma unroll
        for (int k = 0; k < kTile; ++k) {
          a[k] = smem[oi[k] + d];
          c[k] = smem[oj[k] + d];
        }
#pragma unroll
        for (int u = 0; u < kTile; ++u)
#pragma unroll
          for (int v = 0; v < kTile; ++v) acc[u][v] = fmaf(a[u], c[v], acc[u][v]);
      }
    }
  }

  __syncthreads();  // all reads of the staged x are done: reuse it for out
  if (active) {
    float* so = smem + r * P;
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      const int i = i0 + u;
#pragma unroll
      for (int v = 0; v < kTile; ++v) {
        const int j = j0 + v;
        const bool keep = i < F && (self_interaction ? j <= i : j < i);
        if (keep) {
          const int p = (self_interaction ? i * (i + 1) / 2 : i * (i - 1) / 2) + j;
          so[p] = acc[u][v];
        }
      }
    }
  }
  __syncthreads();
  float* dst = out + b0 * P;
  for (int e = threadIdx.x; e < nb * P; e += blockDim.x) dst[e] = smem[e];
}

template <typename T>
cudaError_t launch(const void* x, void* out, int B, int F, int D, int self_interaction,
                   cudaStream_t stream) {
  const int P = self_interaction ? F * (F + 1) / 2 : F * (F - 1) / 2;
  const int nt = (F + kTile - 1) / kTile;
  const int tiles = nt * (nt + 1) / 2;
  const int stride = std::min(D, kChunkD) + 1;
  const int line_floats = std::max(F * stride, P);
  const int rows = std::max(
      1, std::min({kSmemBudget / (line_floats * (int)sizeof(float)), kMaxThreads / tiles, B}));
  const int threads = (rows * tiles + 31) / 32 * 32;
  const size_t smem = (size_t)rows * line_floats * sizeof(float);
  const long long blocks = ((long long)B + rows - 1) / rows;
  dot_interaction_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(out), B, F, D, P, self_interaction, rows,
      tiles, stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dot_interaction_forward(const void* x, void* out, int B, int F, int D,
                                       int self_interaction, int x_is_bf16, void* stream) {
  if (B < 1 || F < 1 || F > kMaxF || D < 1) return (int)cudaErrorInvalidValue;
  if (!self_interaction && F < 2) return (int)cudaErrorInvalidValue;  // no pairs
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_bf16 ? launch<__nv_bfloat16>(x, out, B, F, D, self_interaction, s)
                : launch<float>(x, out, B, F, D, self_interaction, s);
  return (int)err;
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
