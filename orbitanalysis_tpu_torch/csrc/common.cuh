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

}  // namespace
