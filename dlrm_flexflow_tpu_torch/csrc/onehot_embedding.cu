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
// Design: no sort, hot rows split across blocks. The members of the bags
// are the B * H entries in the order m = b * H + j, read as they lie (int32
// or int64). The grid is (row tile t, column slice c) x member segment s: a
// tile holds R = min(kTileRows, V) rows, a slice kCols columns (lane l owns
// columns 4l..4l+3 of it), a segment a fixed run of whole bags. Block
// (t, c, s) walks its segment in rounds of at most kRoundMax members, each
// warp a fixed contiguous share of the round:
//   - pick: the warp keeps (ballot, then a popc prefix) the members whose row
//     lies in tile t, in its list in shared memory, in member order;
//   - rows regime (R > kSplitRows): warp w adds into rows [w * rpw, (w + 1)
//     * rpw) of the tile, rpw = ceil(R / kWarps) <= kOwnRows; the lists'
//     picks are sorted stably by owner warp (counts, bases, then each list
//     placed by ballots), so warp w reads its picks in member order as one
//     run of shared memory;
//   - split regime (R <= kSplitRows and S > 1, so V <= 8 and every row is
//     hot): warp w adds its own list into all R rows, and at the end the
//     eight warps' sums of a row are added in warp order;
//   - add: kDepth g rows of a warp's picks are loaded before they are added,
//     each into its row's accumulator in registers (kOwnRows rows of 4
//     columns a lane). A pick whose row came earlier in its bag adds
//     nothing; its weight comes from the bag, which the warp reads 32
//     entries at a time (H = 1: the weight is 1).
// With one segment (S = 1) the block writes its tile of dT, zero rows
// included, in one launch. With S > 1 it writes the segment's partial
// [V, D] f32 into the scratch, and a second launch adds each element's S
// partials in segment order. So every sum's order is fixed by the shapes and
// the plan (R, S): no atomics, the same bits on every run. In the rows
// regime with S = 1 a row's terms are added in member order into 0, as the
// plain version's index_add_ adds them on the CPU: the two agree bit for bit.
// The split regime and each depth of the second launch are faster on their
// own shapes than the path that would take them otherwise: at V = 3 and 4
// the rows regime takes about twice as long, one depth of 64 costs 3-7 us
// at S = 4-9 and one of 8 costs 2.4-3.1 us at S = 132 (PERF.md).
//
// The plan (the wrapper's `backward_plan`; this file checks it and derives
// the rest): S is the least count that leaves the busiest warp about
// WARP_PICKS = 256 picks of a uniform stream and, where the tiles alone would
// fill fewer than half of the card's 132 SMs, gives 132 blocks; then
// S * V <= max(B * H, V), so the partials hold no more rows than the stream
// has members. mlperf-lite at B = 16384, H = 1: V = 7424 and 7122 take S = 1
// (116 and 112 tiles, one launch, each block scanning the 128 KB of int64
// indices from L2); V = 3 to 2209 take S = 4 to 132 and two launches. The
// order depends on the shapes, not on the data: at large V a row that the
// stream makes hot is summed by one warp of one block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
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

constexpr int kBwdThreads = 256;
constexpr int kWarps = kBwdThreads / 32;
constexpr int kTileRows = 64;      // rows a tile at most: the wrapper's TILE_ROWS
constexpr int kCols = 128;         // columns a slice, 4 a lane: the wrapper's COLS
constexpr int kSplitRows = 8;      // tiles of at most this many rows take the split regime
constexpr int kRoundMax = 16384;   // members a round at most: the wrapper's ROUND_MAX
constexpr int kScan = 16;          // index loads a lane has in flight while picking
constexpr int kDepth = 8;          // g rows a warp loads before adding them
constexpr int kOwnRows = 8;        // rows a warp adds into, in registers
constexpr int kSumThreads = 64;    // the second launch: one element a thread
constexpr int kSumDepth = 64;      // partials a thread loads before adding them, S >= kSumDeep
constexpr int kSumShallow = 8;     // the same, S < kSumDeep
constexpr int kSumDeep = 32;
constexpr int kSmemMax = kRoundMax * 8;  // the lists, then the sorted picks or the split sums
static_assert(kWarps * kSplitRows * kCols * 4 <= kRoundMax * 4, "the split sums fit kSmemMax");
static_assert(kTileRows <= kWarps * kOwnRows && kSplitRows <= kOwnRows, "a warp's rows fit its registers");
static_assert(kTileRows <= 256 && kRoundMax <= (1 << 24), "a pick packs its row in 8 bits");
static_assert(kWarps * kWarps == 64, "the bases are one warp's scan of two counts a lane");

// What a launch derives from (B, H, V, D) and the wrapper's (R, S).
struct BwdPlan {
  long long B, V;
  int H, D;
  int R, tiles, slices, S;
  long long bags;   // bags a segment
  int round;        // members a round: a multiple of kWarps
  bool split;
  int smem;         // dynamic shared memory: the lists, then the sorted picks or the split sums
};

BwdPlan bwd_plan(long long B, int H, long long V, int D, int R, int S) {
  BwdPlan p{};
  p.B = B; p.H = H; p.V = V; p.D = D; p.R = R; p.S = S;
  p.tiles = (int)((V + R - 1) / R);
  p.slices = (D + kCols - 1) / kCols;
  p.bags = (B + S - 1) / S;
  const long long members = p.bags * H;
  p.round = (int)std::min<long long>(kRoundMax, (members + kWarps - 1) / kWarps * kWarps);
  p.split = R <= kSplitRows && S > 1;
  p.smem = p.round * 4 + (p.split ? kWarps * kSplitRows * kCols * 4 : p.round * 4);
  return p;
}

template <bool kVec>
__device__ __forceinline__ void store_row(float* o, int d0, int D, const float (&v)[4]) {
  if constexpr (kVec) {
    store4(o, v);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (d0 + e < D) o[e] = v[e];
  }
}

template <bool kVec, typename TG>
__device__ __forceinline__ void load_g(const TG* row, int d0, int D, float (&v)[4]) {
  if constexpr (kVec) {
    if (d0 < D) {
      load4(row + d0, v);
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = d0 + e < D ? to_f32(row[d0 + e]) : 0.f;
  }
}

// The weight w_{b,r} of pick (member m of row r), or -1 where r came earlier
// in the bag: the warp reads the bag 32 entries at a time.
template <bool kCdtBf16, typename TI>
__device__ __noinline__ float bag_weight(const TI* __restrict__ idx, long long m, int H, long long r,
                                         int avg, int lane) {
  const long long b = m / H;
  const int pos = (int)(m - b * H);
  const TI* bi = idx + b * H;
  bool first = true;
  int n = 0, cnt = 0;
  for (int e0 = 0; e0 < H; e0 += 32) {
    const int e = e0 + lane;
    const long long x = e < H ? (long long)bi[e] : -1LL;
    const unsigned same = __ballot_sync(0xffffffffu, x == r);
    cnt += __popc(__ballot_sync(0xffffffffu, x >= 0));
    n += __popc(same);
    const int before = pos - e0;  // entries of this chunk before the member
    first = first && (before <= 0 || (same & (before >= 32 ? 0xffffffffu : (1u << before) - 1u)) == 0);
  }
  return first ? round_cdt<kCdtBf16>(avg ? __fdiv_rn((float)n, (float)max(cnt, 1)) : (float)n) : -1.f;
}

// Block (tile, slice) x segment; dst is dT (S = 1) or the partials [S, V, D].
template <typename TG, typename TI, bool kVec, bool kCdtBf16>
__global__ void __launch_bounds__(kBwdThreads) onehot_backward_tiles(
    const TI* __restrict__ idx, const TG* __restrict__ g, float* __restrict__ dst, const BwdPlan p,
    int avg) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_cnt[kWarps][kWarps];   // picks of list l owned by warp o
  __shared__ int s_base[kWarps][kWarps];  // where they go in the sorted picks: by owner, then list
  const int cap = p.round / kWarps;       // picks a list holds: its warp's share of a round
  unsigned* s_list = reinterpret_cast<unsigned*>(smem);  // [kWarps][cap]: member << 8 | row
  unsigned* s_sorted = s_list + kWarps * cap;            // rows regime: [round], by owner
  float* s_comb = reinterpret_cast<float*>(s_sorted);    // split regime: [kWarps][kSplitRows][kCols]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const int t = (int)(blockIdx.x % (unsigned)p.tiles);
  const int d0 = (int)(blockIdx.x / (unsigned)p.tiles) * kCols + lane * 4;
  const long long r0 = (long long)t * p.R;
  const int rt = (int)min((long long)p.R, p.V - r0);
  const int rpw = p.split ? rt : (rt + kWarps - 1) / kWarps;  // rows a warp adds into, <= kOwnRows
  const int own0 = p.split ? 0 : warp * rpw;                 // the first of them
  const int H = p.H;
  const long long m0 = (long long)blockIdx.y * p.bags * H;
  const long long m1 = min(p.B, ((long long)blockIdx.y + 1) * p.bags) * H;
  unsigned* list = s_list + warp * cap;
  float acc[kOwnRows][4];
#pragma unroll
  for (int x = 0; x < kOwnRows; ++x) acc[x][0] = acc[x][1] = acc[x][2] = acc[x][3] = 0.f;
  for (long long q0 = m0; q0 < m1; q0 += p.round) {
    const int len = (int)min((long long)p.round, m1 - q0);
    const int per = (len + kWarps - 1) / kWarps;
    const int i_end = min(len, (warp + 1) * per);
    // Pick: the warp's share of the round, the members whose row is in the tile.
    int kept = 0;
    for (int i0 = warp * per; i0 < i_end; i0 += 32 * kScan) {
      TI rk[kScan];
#pragma unroll
      for (int k = 0; k < kScan; ++k) {
        const int i = i0 + k * 32 + lane;
        rk[k] = i < i_end ? idx[q0 + i] : TI(-1);  // -1 lies in no tile
      }
#pragma unroll
      for (int k = 0; k < kScan; ++k) {
        if (i0 + k * 32 >= i_end) break;
        const long long r = (long long)rk[k];
        const bool keep = r >= r0 && r < r0 + rt;
        const unsigned ball = __ballot_sync(0xffffffffu, keep);
        if (keep) list[kept + __popc(ball & lt)] = ((unsigned)(i0 + k * 32 + lane) << 8) | (unsigned)(r - r0);
        kept += __popc(ball);
      }
    }
    const unsigned* stream = list;
    int n_stream = kept;
    if (p.split) {
      __syncwarp();
    } else {
      // Sort the lists' picks stably by owner warp: counts, bases, places.
      int mine = 0;  // lane o < kWarps: this list's picks of owner o
      for (int j0 = 0; j0 < kept; j0 += 32) {
        const int j = j0 + lane;
        const int o = j < kept ? (int)(list[j] & 0xffu) / rpw : kWarps;
#pragma unroll
        for (int x = 0; x < kWarps; ++x) {
          const unsigned mx = __ballot_sync(0xffffffffu, o == x);
          if (lane == x) mine += __popc(mx);
        }
      }
      if (lane < kWarps) s_cnt[warp][lane] = mine;
      __syncthreads();
      if (warp == 0) {  // exclusive scan of the counts in (owner, list) order, two a lane
        const int i = 2 * lane;
        const int c0 = s_cnt[i % kWarps][i / kWarps], c1 = s_cnt[(i + 1) % kWarps][(i + 1) / kWarps];
        int sum = c0 + c1;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, sum, d);
          if (lane >= d) sum += y;
        }
        s_base[i % kWarps][i / kWarps] = sum - c0 - c1;
        s_base[(i + 1) % kWarps][(i + 1) / kWarps] = sum - c1;
      }
      __syncthreads();
      int next = lane < kWarps ? s_base[warp][lane] : 0;  // lane o: the next slot of owner o
      stream = s_sorted + s_base[0][warp];
      n_stream = s_base[kWarps - 1][warp] + s_cnt[kWarps - 1][warp] - s_base[0][warp];
      for (int j0 = 0; j0 < kept; j0 += 32) {
        const int j = j0 + lane;
        const unsigned e = j < kept ? list[j] : 0u;
        const int o = j < kept ? (int)(e & 0xffu) / rpw : kWarps;
#pragma unroll
        for (int x = 0; x < kWarps; ++x) {
          const unsigned mx = __ballot_sync(0xffffffffu, o == x);
          const int at = __shfl_sync(0xffffffffu, next, x);
          if (o == x) s_sorted[at + __popc(mx & lt)] = e;
          if (lane == x) next += __popc(mx);
        }
      }
      __syncthreads();
    }
    // Add the warp's picks in member order, kDepth g rows in flight.
    for (int q = 0; q < n_stream; q += kDepth) {
      float v[kDepth][4];
      unsigned ent[kDepth];
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        if (q + k < n_stream) {
          ent[k] = stream[q + k];
          const long long m = q0 + (ent[k] >> 8);
          load_g<kVec>(g + (H == 1 ? m : m / H) * p.D, d0, p.D, v[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        if (q + k >= n_stream) break;
        const int lr = (int)(ent[k] & 0xffu);
        // a bag of one member: its weight is 1 (n = cnt = 1)
        const float w = H == 1 ? 1.f : bag_weight<kCdtBf16>(idx, q0 + (ent[k] >> 8), H, r0 + lr, avg, lane);
        if (w < 0.f) continue;
        const int x = lr - own0;
#pragma unroll
        for (int y = 0; y < kOwnRows; ++y) {
          if (y == x) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[y][e] = __fadd_rn(acc[y][e], __fmul_rn(w, round_cdt<kCdtBf16>(v[k][e])));
          }
        }
      }
    }
  }
  float* out = dst + (p.S > 1 ? (long long)blockIdx.y * p.V * p.D : 0LL) + r0 * p.D + d0;
  if (p.split) {  // the warps' sums of each row, added in warp order
#pragma unroll
    for (int y = 0; y < kOwnRows; ++y)
      if (y < rt)
        *reinterpret_cast<float4*>(s_comb + (warp * kSplitRows + y) * kCols + lane * 4) =
            make_float4(acc[y][0], acc[y][1], acc[y][2], acc[y][3]);
    __syncthreads();
    if (warp >= rt || d0 >= p.D) return;
    float s4[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < kWarps; ++k) {
      const float4 q = *reinterpret_cast<const float4*>(s_comb + (k * kSplitRows + warp) * kCols + lane * 4);
      s4[0] = __fadd_rn(s4[0], q.x);
      s4[1] = __fadd_rn(s4[1], q.y);
      s4[2] = __fadd_rn(s4[2], q.z);
      s4[3] = __fadd_rn(s4[3], q.w);
    }
    store_row<kVec>(out + (long long)warp * p.D, d0, p.D, s4);
    return;
  }
  if (d0 >= p.D) return;
#pragma unroll
  for (int y = 0; y < kOwnRows; ++y)
    if (y < rpw && own0 + y < rt) store_row<kVec>(out + (long long)(own0 + y) * p.D, d0, p.D, acc[y]);
}

// The second launch: dT[e] = the S partials of element e added in segment
// order, kN loads in flight (the +0 past S leaves the sum, which starts at +0
// and so is never -0, as it is).
template <int kN>
__global__ void __launch_bounds__(kSumThreads) onehot_backward_sum_segments(
    const float* __restrict__ part, float* __restrict__ dt, long long E, int S) {
  const long long e = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;
  for (int s = 0; s < S; s += kN) {
    float v[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = s + k < S ? part[(long long)(s + k) * E + e] : 0.f;
#pragma unroll
    for (int k = 0; k < kN; ++k) acc = __fadd_rn(acc, v[k]);
  }
  dt[e] = acc;
}

template <typename TG, typename TI, bool kVec, bool kCdtBf16>
cudaError_t launch_tiles(const void* idx, const void* g, float* dst, const BwdPlan& p, int avg,
                         cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err =
        cudaFuncSetAttribute(onehot_backward_tiles<TG, TI, kVec, kCdtBf16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  const dim3 grid((unsigned)((long long)p.tiles * p.slices), (unsigned)p.S);
  onehot_backward_tiles<TG, TI, kVec, kCdtBf16><<<grid, kBwdThreads, p.smem, stream>>>(
      static_cast<const TI*>(idx), static_cast<const TG*>(g), dst, p, avg);
  return cudaGetLastError();
}

template <typename TG, typename TI, bool kCdtBf16>
cudaError_t launch_backward(const void* idx, const void* g, float* dst, const BwdPlan& p, int avg,
                            cudaStream_t stream) {
  const bool vec = p.D % 4 == 0 && reinterpret_cast<uintptr_t>(g) % (4 * sizeof(TG)) == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  return vec ? launch_tiles<TG, TI, true, kCdtBf16>(idx, g, dst, p, avg, stream)
             : launch_tiles<TG, TI, false, kCdtBf16>(idx, g, dst, p, avg, stream);
}

template <typename TG, typename TI>
cudaError_t launch_backward_cdt(const void* idx, const void* g, float* dst, const BwdPlan& p,
                                int avg, int cdt_bf16, cudaStream_t stream) {
  return cdt_bf16 ? launch_backward<TG, TI, true>(idx, g, dst, p, avg, stream)
                  : launch_backward<TG, TI, false>(idx, g, dst, p, avg, stream);
}

}  // namespace

// Floats of scratch a launch needs: the S partials [S, V, D] when S > 1.
extern "C" long long onehot_embedding_backward_scratch_floats(long long V, int D, int S) {
  return S > 1 ? (long long)S * V * D : 0;
}

// dt [V, D] f32, every row written; idx [B, H] int32 or int64; g [B, D] f32
// or bf16; R and S the wrapper's plan (rows a tile, member segments) and
// scratch its `scratch_floats` floats (NULL when S = 1). Returns a
// cudaError_t (0 = launched): 1 launch when S = 1, else 2.
extern "C" int onehot_embedding_backward(const void* idx, const void* g, void* dt, void* scratch,
                                         long long scratch_floats, long long B, int H, long long V,
                                         int D, int R, int S, int g_is_bf16, int idx_is_i64, int avg,
                                         int cdt_bf16, void* stream) {
  if (B < 1 || H < 1 || V < 1 || V >= 0x7fffffffLL - 1 || D < 1 || B * H >= (1LL << 31) ||
      R < 1 || R > kTileRows || R > V || S < 1 || S > 65535 || S > B ||
      (long long)S * V > std::max(B * H, V))
    return (int)cudaErrorInvalidValue;
  const BwdPlan p = bwd_plan(B, H, V, D, R, S);
  const long long blocks = (long long)p.tiles * p.slices;
  const long long sum_blocks = (V * D + kSumThreads - 1) / kSumThreads;
  if (blocks > 0x7fffffffLL || (S > 1 && (scratch == nullptr || sum_blocks > 0x7fffffffLL ||
                                          scratch_floats < onehot_embedding_backward_scratch_floats(V, D, S))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dst = static_cast<float*>(S > 1 ? scratch : dt);
  cudaError_t err;
  if (g_is_bf16) {
    err = idx_is_i64 ? launch_backward_cdt<__nv_bfloat16, long long>(idx, g, dst, p, avg, cdt_bf16, s)
                     : launch_backward_cdt<__nv_bfloat16, int>(idx, g, dst, p, avg, cdt_bf16, s);
  } else {
    err = idx_is_i64 ? launch_backward_cdt<float, long long>(idx, g, dst, p, avg, cdt_bf16, s)
                     : launch_backward_cdt<float, int>(idx, g, dst, p, avg, cdt_bf16, s);
  }
  if (err != cudaSuccess || S == 1) return (int)err;
  // few partials of many elements: few loads a thread; many partials (hot rows): many
  const float* part = static_cast<const float*>(scratch);
  if (S >= kSumDeep) {
    onehot_backward_sum_segments<kSumDepth><<<(unsigned)sum_blocks, kSumThreads, 0, s>>>(
        part, static_cast<float*>(dt), V * D, S);
  } else {
    onehot_backward_sum_segments<kSumShallow><<<(unsigned)sum_blocks, kSumThreads, 0, s>>>(
        part, static_cast<float*>(dt), V * D, S);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
