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

// Exclusive offset of this warp's selected entries within a tile of
// kWarps * 32 entries, and the tile's total, from each warp's count.
// Ends with a barrier, so the caller may read both results; the caller
// must pass a barrier before the next call rewrites the shared arrays.
template <int kWarps>
__device__ __forceinline__ void tile_offsets(int warp_count, int* warp_off,
                                             int* tile_total, int& before,
                                             int& total) {
  static_assert(kWarps <= 32, "one warp scans the warp totals");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_off[warp] = warp_count;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < kWarps ? warp_off[lane] : 0;
    int incl = t;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += n;
    }
    if (lane < kWarps) warp_off[lane] = incl - t;
    if (lane == kWarps - 1) *tile_total = incl;
  }
  __syncthreads();
  before = warp_off[warp];
  total = *tile_total;
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

// Ordered multi-stream compaction (K18): up to kMaxStreams uint32
// streams of an [H, N] row move together, unchanged and in position
// order, to the front of an [H, len] row wherever the selection word has
// a bit of sel_mask set; the outputs past the row's count are written as
// zero.  The scan stops once the len outputs are full.
constexpr int kMaxStreams = 6;
constexpr int kStreamThreads = 1024;
constexpr int kStreamWarps = kStreamThreads / 32;

struct StreamGroup {
  const uint32_t* sel;
  uint32_t sel_mask;
  const uint32_t* in[kMaxStreams];
  uint32_t* out[kMaxStreams];
  int n_streams;
  int len;
};

// One block per row (blockIdx.x), walking the row in tiles of
// kStreamThreads entries: ballot + popc ranks inside a warp, one warp
// scans the warp totals, a running base carries the count across tiles.
// kN (>= n_streams) bounds the unrolled stream loops, so every stream's
// pointer is a fixed field of the kernel's arguments.
template <int kN>
__global__ void __launch_bounds__(kStreamThreads)
compact_streams_kernel(StreamGroup g, int N) {
  __shared__ int warp_off[kStreamWarps];
  __shared__ int tile_total;
  const size_t row = blockIdx.x;
  const uint32_t* sel = g.sel + row * N;
  const int lane = threadIdx.x & 31;
  const uint32_t lanes_below = (1u << lane) - 1u;
  int base = 0;  // selected entries in earlier tiles: uniform in the block
  for (int start = 0; start < N && base < g.len; start += kStreamThreads) {
    const int i = start + threadIdx.x;
    const bool take = i < N && (__ldg(sel + i) & g.sel_mask) != 0u;
    // the payload loads are issued before the scan's barriers, so their
    // latency overlaps the scan instead of following it
    uint32_t v[kN];
    if (take) {
#pragma unroll
      for (int c = 0; c < kN; ++c) {
        if (c < g.n_streams) v[c] = __ldg(g.in[c] + row * N + i);
      }
    }
    const uint32_t ballot = __ballot_sync(0xffffffffu, take);
    int before, total;
    tile_offsets<kStreamWarps>(__popc(ballot), warp_off, &tile_total, before, total);
    if (take) {
      const int off = base + before + __popc(ballot & lanes_below);
      if (off < g.len) {
#pragma unroll
        for (int c = 0; c < kN; ++c) {
          if (c < g.n_streams) g.out[c][row * g.len + off] = v[c];
        }
      }
    }
    base += total;
    __syncthreads();  // warp_off / tile_total are rewritten next tile
  }
  for (int j = min(base, g.len) + threadIdx.x; j < g.len; j += kStreamThreads) {
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      if (c < g.n_streams) g.out[c][row * g.len + j] = 0u;
    }
  }
}

// Launch compact_streams_kernel over H rows of length N; returns
// cudaGetLastError().
inline int launch_compact_streams(const StreamGroup& g, int H, int N,
                                  cudaStream_t stream) {
  if (H > 0) {
    if (g.n_streams <= 1) {
      compact_streams_kernel<1><<<H, kStreamThreads, 0, stream>>>(g, N);
    } else if (g.n_streams <= 2) {
      compact_streams_kernel<2><<<H, kStreamThreads, 0, stream>>>(g, N);
    } else if (g.n_streams <= 3) {
      compact_streams_kernel<3><<<H, kStreamThreads, 0, stream>>>(g, N);
    } else {
      compact_streams_kernel<kMaxStreams><<<H, kStreamThreads, 0, stream>>>(g, N);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
