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
// bf16. The eight mlperf-lite layers sit near that balance (0.155 ms of
// bytes, 0.078 ms of bf16 work in all), so the kernel must keep the tensor
// cores fed from few bytes: x read from device memory once, few re-reads
// from L2, no copies of x or w that the function does not need.
//
// Design for cdt = bf16 (`dense_wgmma_kernel`):
//   - w is rounded to bf16 once per call by a prologue kernel into a
//     scratch [N, Kw] (Kw = K rounded up to 8, zero padded), which the
//     wrapper allocates; so no block rounds w again.
//   - x arrives by TMA, as it lies, where its row pitch K * itemsize is a
//     multiple of 16 bytes and its base is 16-byte aligned (f32 tiles of
//     [128 rows, 32 columns], two a k-step; bf16 tiles of [128, 64]). TMA
//     cannot describe a pitch of 52 B (K = 13) or 1916 B (K = 479): such x
//     goes through a second prologue that rounds it to bf16 into [M, Kx]
//     (Kx = K rounded up to 8, zero padded), which TMA then reads. At the
//     479 -> 1024 layer that writes and reads 16 MB more than the 31 MB of
//     x (about 10 us of bytes, against cp.async's 4-byte copies of every
//     f32 element); at 13 -> 512, 0.5 MB.
//   - w tiles of [BN, 64] bf16 arrive by TMA with the 128-byte swizzle,
//     which the wgmma descriptor of B names; x tiles with the same
//     swizzle, read back by the consumers with the swizzle undone.
//   - A block of 384 threads: warpgroup 0 is the producer (one thread
//     issues every TMA copy; its registers drop to 40), warpgroups 1 and 2
//     are consumers (232 registers), each owning 64 rows of a 128-row
//     tile. A ring of 3 or 4 stages in shared memory, each with a `full`
//     mbarrier (the producer's expected bytes, completed by TMA) and an
//     `empty` one (every consumer thread arrives when the stage's products
//     are done).
//   - The consumers read their rows of the x tile from shared memory (f32:
//     8-byte loads, rounded to bf16 pairs; bf16: 4-byte loads) into the
//     register fragments of A, and run `wgmma.mma_async` m64nBNk16 bf16 ->
//     f32 with B from the swizzled w tile: a product of two bf16 values is
//     exact in f32, so this is XLA's arithmetic up to the order of the f32
//     sum.
//   - The grid is persistent, one block an SM; tiles go N fastest, so the
//     blocks in flight at once share x's 128-row strip (x is the large
//     operand: it is read from device memory about once and re-read from
//     L2 N / BN times, at most N / 256), and w (at most 2 MB in bf16) stays
//     in L2.
//   - Tile widths: BN = 256 where N > 128, 128 where 8 < N <= 128, 8 where
//     N <= 8 (the 256 -> 1 layer takes an m64n8 tile, not a 128-wide one).
//   - Epilogue from the accumulators: f32(bf16(b)), the activation in f32,
//     the bf16 rounding, stored as pairs (8 bytes in f32, 4 in bf16; a
//     quad of threads writes 32 contiguous bytes of a row). Ragged rows and
//     columns: TMA fills what lies past M, N and K with zeros and the
//     epilogue stores only inside [M, N].
//   - Launches per call: 1 to 2 prologues (w; x where TMA cannot read it)
//     and the product.
//   - What bounds it. At 1024 -> 1024 a block spends about 1.9 us a k-step
//     against 0.56 us of tensor-core work, and moves 64 KB a k-step through
//     L2 (512 MB in all, about 4.5 TB/s). A block of 384 threads compiles to
//     at most 168 registers a thread, and BN = 256 keeps 128 accumulators a
//     consumer thread, so there is no room for more in flight. Variants
//     measured on an H100 (chip_smoke.py's fused_dense phase, the eight
//     mlperf-lite layers summed, against 0.413 ms for this design): the next
//     k-step's A fragments loaded under the running products, 0.695 ms (340
//     to 504 bytes spilled); the epilogue staged in shared memory and
//     written by TMA stores, 0.549 ms (spills); pairs of blocks in a cluster
//     sharing x by TMA multicast, 0.467 ms (up to 108 bytes spilled, and a
//     ring that waits on both blocks). Each stays out.
// cdt = f32: the same function with f32 FMAs on the CUDA cores (never
// TF32): a 64 x 64 tile a block, 4 x 4 outputs a thread.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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
__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// ------------------------------------------------------------ prologues
// dst[r, c] = bf16(src[r, c]) for c < K, 0 for K <= c < Kp (Kp % 8 == 0);
// a thread writes 8 columns (16 bytes).
template <typename T>
__global__ void __launch_bounds__(256) round_pad_kernel(const T* __restrict__ src, long long rows, int K,
                                                        __nv_bfloat16* __restrict__ dst, int Kp) {
  const int groups = Kp / 8;
  const long long total = rows * groups;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / groups;
    const int c0 = (int)(i - r * groups) * 8;
    const T* p = src + r * K;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __float2bfloat16_rn(c0 + e < K ? to_f32(p[c0 + e]) : 0.f);
    *reinterpret_cast<uint4*>(dst + r * Kp + c0) = *reinterpret_cast<const uint4*>(v);
  }
}

// ------------------------------------------------------------ Hopper primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred P1;\nmbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\nselp.b32 %0, 1, 0, P1;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// waits until the phase of the given parity has completed; a wait that
// never ends (a lost arrival) fails the launch rather than hold the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (unsigned spins = 0; !mbar_try_wait(bar, parity);)
    if (++spins == (1u << 24)) __trap();
}
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }
// keeps the compiler from moving a register across the asynchronous product
__device__ __forceinline__ void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void fence_reg(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// descriptor of a K-major bf16 tile of 128-byte rows in the 128-byte
// swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B): 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_m64n8(float (&d)[4], const uint32_t (&a)[4], uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}


template <int BN>
__device__ __forceinline__ void wgmma_bn(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  if constexpr (BN == 8) wgmma_m64n8(d, a, desc, scale_d);
  else if constexpr (BN == 128) wgmma_m64n128(d, a, desc, scale_d);
  else wgmma_m64n256(d, a, desc, scale_d);
}

// The A fragment of rows r and r + 8, columns c, c + 1 and c + 8, c + 9 of
// a swizzled x tile (f32: two [128][32] halves; bf16: one [128][64])
__device__ __forceinline__ uint32_t pair_at(const unsigned char* xs, const float*, int r, int c) {
  const int sub = c >> 5, cc = c & 31;
  const float2 v = *reinterpret_cast<const float2*>(
      xs + sub * 16384 + r * 128 + ((((cc * 4) >> 4) ^ (r & 7)) << 4) + ((cc * 4) & 15));
  __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pair_at(const unsigned char* xs, const __nv_bfloat16*, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(xs + r * 128 + ((((c * 2) >> 4) ^ (r & 7)) << 4) + ((c * 2) & 15));
}

constexpr int kBM = 128, kBK = 64, kWgThreads = 128;

// TA: the x tile's type in shared memory (what TMA reads); TO: the output's
template <typename TA, int BN>
struct Tile {
  static constexpr int kXBytes = kBM * kBK * (int)sizeof(TA);
  static constexpr int kWBytes = BN * kBK * 2;
  static constexpr int kStageBytes = kXBytes + kWBytes;
  static constexpr int kStages = kStageBytes > 48 * 1024 ? 3 : 4;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStages * 8 + 1024;  // 1024: alignment
};

template <typename TA, typename TO, int BN>
__global__ void __launch_bounds__(3 * kWgThreads, 1) dense_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_w,
    const float* __restrict__ b, TO* __restrict__ out, int M, int N, int K, int act) {
  using T = Tile<TA, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::kStages * T::kStageBytes);
  uint64_t* empty = full + T::kStages;
  const int wg = threadIdx.x / kWgThreads;
  const int n_tiles = (N + BN - 1) / BN;
  const int tiles = ((M + kBM - 1) / kBM) * n_tiles;
  const int k_steps = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;
        for (int kt = 0; kt < k_steps; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* xs = smem + stage * T::kStageBytes;
          mbar_expect_tx(&full[stage], T::kStageBytes);
          if constexpr (sizeof(TA) == 4) {
            tma_load_2d(xs, &map_x, kt * kBK, m0, &full[stage]);
            tma_load_2d(xs + T::kXBytes / 2, &map_x, kt * kBK + kBK / 2, m0, &full[stage]);
          } else {
            tma_load_2d(xs, &map_x, kt * kBK, m0, &full[stage]);
          }
          tma_load_2d(xs + T::kXBytes, &map_w, kt * kBK, n0, &full[stage]);
          if (++stage == T::kStages) { stage = 0; phase ^= 1; }
        }
      }
    }
  } else {  // consumers: 64 rows of the tile each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int t = threadIdx.x - kWgThreads;
    const int warp = (t % kWgThreads) / 32, lane = t % 32;
    const int r_lo = (t / kWgThreads) * 64 + warp * 16 + lane / 4;  // rows r_lo and r_lo + 8
    const int kq = (lane % 4) * 2;
    const TA* tag = nullptr;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * BN;
      for (int kt = 0; kt < k_steps; ++kt) {
        mbar_wait(&full[stage], phase);
        const unsigned char* xs = smem + stage * T::kStageBytes;
        const unsigned char* ws = xs + T::kXBytes;
        uint32_t a[4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const int c = ks * 16 + kq;
          a[ks][0] = pair_at(xs, tag, r_lo, c);
          a[ks][1] = pair_at(xs, tag, r_lo + 8, c);
          a[ks][2] = pair_at(xs, tag, r_lo, c + 8);
          a[ks][3] = pair_at(xs, tag, r_lo + 8, c + 8);
        }
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_bn<BN>(acc, a[ks], desc_sw128(ws + ks * 32), (kt > 0 || ks > 0) ? 1 : 0);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_reg(acc[i]);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q) fence_reg(a[ks][q]);
        mbar_arrive(&empty[stage]);
        if (++stage == T::kStages) { stage = 0; phase ^= 1; }
      }
      // epilogue: acc[j * 4 + h * 2 + e] is row r_lo + 8 h, column j * 8 + kq + e
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + j * 8 + kq;
        if (n >= N) continue;
        const float b0 = b != nullptr ? round_bf16(b[n]) : 0.f;
        const float b1 = (b != nullptr && n + 1 < N) ? round_bf16(b[n + 1]) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r_lo + 8 * h;
          if (m >= M) continue;
          const float y0 = round_bf16(activate(acc[j * 4 + h * 2] + b0, act));
          const float y1 = round_bf16(activate(acc[j * 4 + h * 2 + 1] + b1, act));
          TO* p = out + (long long)m * N + n;
          if (n + 1 < N && (N & 1) == 0) {
            store2(p, y0, y1);
          } else {
            store(p, y0);
            if (n + 1 < N) store(p + 1, y1);
          }
        }
      }
    }
  }
}

// ----------------------------------------------------------------- f32 path
constexpr int kThreads = 256;
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

// ----------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime, so the library needs no -lcuda
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows, cols] matrix (pitch bytes a row) in boxes of [box_rows,
// box_cols], 128-byte swizzle, zeros past its edges
bool tensor_map(CUtensorMap* map, const void* base, CUtensorMapDataType dt, long long rows, long long cols,
                long long pitch, int box_rows, int box_cols) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, dt, 2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

unsigned prologue_blocks(long long items) {
  const long long b = (items + 255) / 256;
  return (unsigned)(b < 132LL * 16 ? (b < 1 ? 1 : b) : 132LL * 16);
}

template <typename TA, typename TO, int BN>
cudaError_t launch_wgmma(const CUtensorMap& mx, const CUtensorMap& mw, const float* b, void* out, int M, int N,
                         int K, int act, cudaStream_t stream) {
  using T = Tile<TA, BN>;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(dense_wgmma_kernel<TA, TO, BN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  const unsigned grid = (unsigned)(tiles < sm_count() ? tiles : sm_count());
  dense_wgmma_kernel<TA, TO, BN><<<grid, 3 * kWgThreads, T::kSmem, stream>>>(mx, mw, b, static_cast<TO*>(out), M,
                                                                           N, K, act);
  return cudaGetLastError();
}

template <typename TA, typename TO>
cudaError_t launch_tiles(const CUtensorMap& mx, const CUtensorMap& mw, const float* b, void* out, int M, int N,
                         int K, int act, cudaStream_t stream) {
  if (N <= 8) return launch_wgmma<TA, TO, 8>(mx, mw, b, out, M, N, K, act, stream);
  if (N <= 128) return launch_wgmma<TA, TO, 128>(mx, mw, b, out, M, N, K, act, stream);
  return launch_wgmma<TA, TO, 256>(mx, mw, b, out, M, N, K, act, stream);
}

}  // namespace

extern "C" {

// x [M, K] (f32, or bf16 when x_is_bf16), w [N, K] f32, b [N] f32 or NULL,
// out [M, N] in x's dtype. For cdt = bf16 the wrapper passes the scratch:
// w_bf16 [N, Kp] and, where x cannot go to TMA as it lies (its pitch K *
// itemsize not a multiple of 16, or a base not 16-byte aligned; see
// `fused_dense_x_direct`), x_bf16 [M, Kp], with Kp = K rounded up to 8.
// Returns a cudaError_t (0 = launched).
int fused_dense_x_direct(const void* x, int K, int x_is_bf16) {
  const int itemsize = x_is_bf16 ? 2 : 4;
  return (K * itemsize) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

int fused_dense_forward(const void* x, const void* w, const void* b, void* out, int M, int N, int K, int act,
                        int x_is_bf16, int cdt_bf16, void* w_bf16, void* x_bf16, int Kp, void* stream) {
  if (M < 1 || N < 1 || K < 1 || act < kNone || act > kGelu) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  if (!cdt_bf16) {
    const int tn = (N + kFT - 1) / kFT;
    const long long blocks = (long long)((M + kFT - 1) / kFT) * tn;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (x_is_bf16)
      dense_f32_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), wp, bp, static_cast<__nv_bfloat16*>(out), M, N, K, act, tn);
    else
      dense_f32_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(static_cast<const float*>(x), wp, bp,
                                                                     static_cast<float*>(out), M, N, K, act, tn);
    return (int)cudaGetLastError();
  }
  const bool direct = fused_dense_x_direct(x, K, x_is_bf16);
  if (Kp != (K + 7) / 8 * 8 || w_bf16 == nullptr || (!direct && x_bf16 == nullptr))
    return (int)cudaErrorInvalidValue;
  round_pad_kernel<float><<<prologue_blocks((long long)N * Kp / 8), 256, 0, s>>>(
      wp, N, K, static_cast<__nv_bfloat16*>(w_bf16), Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mx, mw;
  if (!tensor_map(&mw, w_bf16, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, N, Kp, (long long)Kp * 2,
                  N <= 8 ? 8 : (N <= 128 ? 128 : 256), kBK))
    return (int)cudaErrorInvalidValue;
  if (direct) {
    if (x_is_bf16) {
      if (!tensor_map(&mx, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, K, (long long)K * 2, kBM, kBK))
        return (int)cudaErrorInvalidValue;
    } else if (!tensor_map(&mx, x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, M, K, (long long)K * 4, kBM, kBK / 2)) {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    if (x_is_bf16)
      round_pad_kernel<__nv_bfloat16><<<prologue_blocks((long long)M * Kp / 8), 256, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), M, K, static_cast<__nv_bfloat16*>(x_bf16), Kp);
    else
      round_pad_kernel<float><<<prologue_blocks((long long)M * Kp / 8), 256, 0, s>>>(
          static_cast<const float*>(x), M, K, static_cast<__nv_bfloat16*>(x_bf16), Kp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (!tensor_map(&mx, x_bf16, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, M, Kp, (long long)Kp * 2, kBM, kBK))
      return (int)cudaErrorInvalidValue;
  }
  const int Ke = direct ? K : Kp;  // the columns the product walks
  if (direct && !x_is_bf16) return (int)launch_tiles<float, float>(mx, mw, bp, out, M, N, Ke, act, s);
  if (x_is_bf16) return (int)launch_tiles<__nv_bfloat16, __nv_bfloat16>(mx, mw, bp, out, M, N, Ke, act, s);
  return (int)launch_tiles<__nv_bfloat16, float>(mx, mw, bp, out, M, N, Ke, act, s);
}

const char* cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
