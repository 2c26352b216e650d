// Device helpers shared by the hand-written kernels of csrc/*.cu.
//
// Each .cu file is compiled on its own (one nvcc per source, in
// parallel) and includes this header; everything here is inline device
// code in an anonymous namespace, so no symbol crosses files.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// IEEE f32 -> f16 bit pattern, round-to-nearest-even, mirroring
// orbitanalysis_tpu/ops/pallas_label.py f16_bits_rne for every finite
// x >= 0: values above the f16 range (and inf/NaN) clamp to 0x7BFF
// instead of 0x7C00, which __float2half_rn would give.
__device__ __forceinline__ uint32_t f16_bits_rne(float x) {
  const int32_t u = __float_as_int(x);
  const int32_t e = u >> 23;  // biased exponent (sign bit is clear here)
  if (e >= 113) {
    // normal f16: RNE folded into one add; carries run from the
    // mantissa into the exponent as IEEE requires
    const uint32_t rn =
        static_cast<uint32_t>(u) + 0x0FFFu + ((static_cast<uint32_t>(u) >> 13) & 1u);
    const int32_t h = static_cast<int32_t>(rn - 0x38000000u) >> 13;
    return static_cast<uint32_t>(min(h, 0x7BFF));
  }
  // subnormal f16: RNE(x * 2^24), an exact scale then round half even
  return static_cast<uint32_t>(__float2int_rn(fminf(x * 16777216.0f, 2e9f)));
}

// Cephes asinf polynomial, operation for operation as
// orbitanalysis_tpu/ops/pallas_step.py _acos_f32 (and the plain torch
// sorted_step._acos_f32): with --fmad=false every product and sum rounds
// on its own, and sqrtf is the IEEE root.
__device__ __forceinline__ float asin_poly(float v, float w) {
  float p = static_cast<float>(4.2163199048e-2);
  p = p * w + static_cast<float>(2.4181311049e-2);
  p = p * w + static_cast<float>(4.5470025998e-2);
  p = p * w + static_cast<float>(7.4953002686e-2);
  p = p * w + static_cast<float>(1.6666752422e-1);
  return p * w * v + v;
}

__device__ __forceinline__ float acos_f32(float x) {
  const float pi = static_cast<float>(3.141592653589793);
  const float ax = fabsf(x);
  const float t = 0.5f * (1.0f - ax);
  const float big = 2.0f * asin_poly(sqrtf(t), t);
  const float acos_big = x < 0.0f ? pi - big : big;
  const float acos_small = static_cast<float>(1.5707963267948966) - asin_poly(x, x * x);
  return ax > 0.5f ? acos_big : acos_small;
}

// ---------------------------------------------------------------------
// Ordered multi-block compaction by decoupled look-back.
//
// A row is cut into tiles and each block takes one tile, in the order
// the blocks arrive: claim_tile reads an atomic counter instead of
// blockIdx, because the card does not promise to start blocks in index
// order, and a block that waits on a tile no running block holds would
// wait forever.  The block ranks its selected entries (tile_ranks:
// ballot + popc inside a warp, one warp scans the warp counts), then
// lookback_prefix publishes the tile's count in a 64-bit status word
// (flag in the high half, count in the low half), sums the earlier
// tiles of its row back to the nearest inclusive prefix, 32 tiles a
// round, and publishes its own inclusive prefix.  The caller writes its
// entries at prefix + rank (where that is below the row's length) from
// registers or shared memory; the row's last tile writes the exact
// count and zero-fills the rest of the row (finish_row).
//
// Scratch: one zeroed int64 word for the tile counter, then one status
// word a tile, [rows, tiles a row]; the entry point zeroes it on the
// caller's stream before each launch, so nothing carries over from one
// call to the next and concurrent calls on two streams need two buffers.
constexpr unsigned long long kStatusAggregate = 1ull << 32;
constexpr unsigned long long kStatusPrefix = 2ull << 32;

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// The next tile in arrival order, the same value in every thread.  Ends
// with a barrier; *slot is free again after the caller's next barrier.
__device__ __forceinline__ int claim_tile(unsigned long long* scratch, int* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd(reinterpret_cast<int*>(scratch), 1);
  __syncthreads();
  return *slot;
}

// Ranks of the selected entries of a tile of kVT * kThreads entries, the
// entry v * kThreads + threadIdx.x held by this thread as take[v]:
// rank[v] counts the selected entries before it in tile order.  Returns
// the tile's total.  counts: shared [kVT * kThreads / 32 + 1].  Ends with
// a barrier; the caller must pass another before counts is rewritten.
template <int kThreads, int kVT>
__device__ __forceinline__ int tile_ranks(const bool (&take)[kVT], int (&rank)[kVT],
                                          int* counts) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kN = kVT * kWarps;
  constexpr int kPer = (kN + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint32_t ballot[kVT];
#pragma unroll
  for (int v = 0; v < kVT; ++v) {
    ballot[v] = __ballot_sync(0xffffffffu, take[v]);
    if (lane == 0) counts[v * kWarps + warp] = __popc(ballot[v]);
  }
  __syncthreads();
  if (warp == 0) {
    // lane l scans counts [l * kPer, l * kPer + kPer) in (v, warp) order
    int c[kPer];
    int sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = lane * kPer + q;
      c[q] = i < kN ? counts[i] : 0;
      sum += c[q];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += n;
    }
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int i = lane * kPer + q;
      if (i < kN) counts[i] = run;
      run += c[q];
    }
    if (lane == 31) counts[kN] = incl;
  }
  __syncthreads();
  const uint32_t below = (1u << lane) - 1u;
#pragma unroll
  for (int v = 0; v < kVT; ++v) {
    rank[v] = counts[v * kWarps + warp] + __popc(ballot[v] & below);
  }
  return counts[kN];
}

// Tile t of a row (status: the row's status words) publishes its total,
// looks back to the nearest inclusive prefix and publishes its own; one
// whole warp calls it, lane being the thread's lane.  Returns the
// selected entries of the row's earlier tiles, the same value in every
// lane.
__device__ __forceinline__ int lookback_warp(unsigned long long* status, int t,
                                             int total, int lane) {
  int before = 0;
  if (t == 0) {
    if (lane == 0) store_status(status, kStatusPrefix | static_cast<uint32_t>(total));
  } else {
    if (lane == 0) {
      store_status(status + t, kStatusAggregate | static_cast<uint32_t>(total));
    }
    for (int end = t;; end -= 32) {
      // lane l reads tile end - 1 - l; tile 0 always holds a prefix, so
      // a lane past it is never summed
      const int j = end - 1 - lane;
      unsigned long long w = j >= 0 ? load_status(status + j) : kStatusPrefix;
      while (__any_sync(0xffffffffu, (w >> 32) == 0)) {
        if ((w >> 32) == 0) w = load_status(status + j);
      }
      const uint32_t prefix = __ballot_sync(0xffffffffu, (w >> 32) == 2);
      const int stop = prefix ? __ffs(prefix) - 1 : 31;
      int v = lane <= stop ? static_cast<int>(static_cast<uint32_t>(w)) : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
      before += v;
      if (prefix) break;
    }
    if (lane == 0) {
      store_status(status + t, kStatusPrefix | static_cast<uint32_t>(before + total));
    }
  }
  return before;
}

// lookback_warp run by warp 0 for the block: the count of the row's
// earlier tiles, the same value in every thread.  The other warps wait at
// the closing barrier; *slot is free again after the caller's next
// barrier.
__device__ __forceinline__ int lookback_prefix(unsigned long long* status, int t,
                                               int total, int* slot) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int before = lookback_warp(status, t, total, lane);
    if (lane == 0) *slot = before;
  }
  __syncthreads();
  return *slot;
}

// The row's last tile: the row's exact count n, and zeros in
// [min(n, len), len) of its three output rows.
__device__ __forceinline__ void finish_row(uint32_t* a, uint32_t* b, uint32_t* c,
                                           int len, int n, int32_t* count) {
  if (threadIdx.x == 0) *count = n;
  for (int j = min(n, len) + threadIdx.x; j < len; j += blockDim.x) {
    a[j] = 0u;
    b[j] = 0u;
    c[j] = 0u;
  }
}

// The one-output-row form: the row's exact count n where count is set,
// and zeros in [min(n, len), len) of its output row.
__device__ __forceinline__ void finish_row(uint32_t* a, int len, int n, int32_t* count) {
  if (count != nullptr && threadIdx.x == 0) *count = n;
  for (int j = min(n, len) + threadIdx.x; j < len; j += blockDim.x) a[j] = 0u;
}

// Status words a launch of tiles_per_row tiles over H rows needs, with
// the tile counter.
inline long long lookback_words(int H, int tiles_per_row) {
  return 1 + static_cast<long long>(H) * tiles_per_row;
}

// Channels a merge (K15) or a compaction group (K19) moves together.
constexpr int kMaxStreams = 6;

}  // namespace
