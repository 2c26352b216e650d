// Blocked direct-summation N-body forces, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of orbitanalysis_tpu/ops/pallas_nbody.py:
//   K14 _force_kernel (call :130, entry direct_forces_pallas)
//       -> direct_forces_kernel below
//
// For each target i of pos [N, 3] f32 and mass [N] f32:
//   a_i = G * sum_j m_j * d_ij * r^-3,  d_ij = x_j - x_i,
//   r^2 = max(dx*dx + dy*dy + dz*dz + eps^2, 1e-18),
// with the minimum image d - box * rint(d * inv_box) when a box is given
// (rintf rounds half to even, as jnp.round; the reciprocal of the box is
// the wrapper's float32 1/box, multiplied, never divided).  r^-3 is
// rsqrtf(r^2) cubed, (inv * inv) * inv: rsqrtf is the card's
// approximate reciprocal root (within 2 ulp), where the plain version
// (ops/nbody.py direct_forces_blocked_torch) takes torch.rsqrt and the
// JAX kernel rsqrt(d2) / d2.  The self pair has d = 0 and adds nothing;
// so does a zero-mass source.  acc [N, 3] f32 is G times the sum.
//
// The TPU kernel tiled targets by 256 and sources by 1024 VMEM lanes
// and padded N to 1024 with zero-mass sources.  Here it is the classic
// all-pairs tiling: one thread owns one target and keeps its three sums
// in registers; a block of kThreads threads stages one tile of kThreads
// sources at a time in shared memory as float4 (x, y, z, m) and every
// thread walks the tile.  The ragged edge is masked: a source past N is
// staged with mass 0, a target past N computes and is not written.  No
// atomics: each target adds its sources in index order, so the result
// is the same bits on every run.
//
// Bound on the H100: operations, not bytes (N^2 pairs on 16 N bytes).
// A pair costs one rsqrtf on the special-function unit (16 a clock per
// SM: 4.2e12/s on 132 SMs at 1.98 GHz) and 19 float32 operations free
// (3 subtracts, 3 squares and 3 adds for r^2, the clamp, 2 multiplies
// for r^-3, 1 for the mass, 3 multiply-adds as 6 operations), 31
// periodic (4 more per component).  The library-wide --fmad=false keeps
// every multiply and add apart, so the float32 pipe (128 lanes a clock
// per SM) issues 19 or 31 instructions a pair where FMAs would issue 14
// or 23: at 67 TFLOP/s the float32 work is the bound, the SFU's 1/16
// clock a pair below it.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <bool kPeriodic>
__global__ void __launch_bounds__(kThreads)
direct_forces_kernel(const float* __restrict__ pos,
                     const float* __restrict__ mass, float* __restrict__ acc,
                     int n, float eps2, float G, float box, float inv_box) {
  __shared__ float4 tile[kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float xt = live ? pos[3 * i] : 0.0f;
  const float yt = live ? pos[3 * i + 1] : 0.0f;
  const float zt = live ? pos[3 * i + 2] : 0.0f;
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int s0 = 0; s0 < n; s0 += kThreads) {
    const int j = s0 + threadIdx.x;
    tile[threadIdx.x] =
        j < n ? make_float4(pos[3 * j], pos[3 * j + 1], pos[3 * j + 2], mass[j])
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kThreads; ++k) {
      const float4 s = tile[k];
      float dx = s.x - xt, dy = s.y - yt, dz = s.z - zt;
      if (kPeriodic) {
        dx = dx - box * rintf(dx * inv_box);
        dy = dy - box * rintf(dy * inv_box);
        dz = dz - box * rintf(dz * inv_box);
      }
      float d2 = dx * dx + dy * dy + dz * dz + eps2;
      d2 = fmaxf(d2, 1e-18f);
      const float inv = rsqrtf(d2);
      const float w = s.w * (inv * inv * inv);
      ax = ax + w * dx;
      ay = ay + w * dy;
      az = az + w * dz;
    }
    __syncthreads();
  }
  if (live) {
    acc[3 * i] = G * ax;
    acc[3 * i + 1] = G * ay;
    acc[3 * i + 2] = G * az;
  }
}

}  // namespace

// pos [n, 3] f32, mass [n] f32 -> acc [n, 3] f32 (written whole).
extern "C" int direct_forces(const void* pos, const void* mass, void* acc,
                             int n, float eps2, float G, int periodic,
                             float box, float inv_box, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    const float* p = static_cast<const float*>(pos);
    const float* m = static_cast<const float*>(mass);
    float* a = static_cast<float*>(acc);
    if (periodic) {
      direct_forces_kernel<true><<<blocks, kThreads, 0, s>>>(
          p, m, a, n, eps2, G, box, inv_box);
    } else {
      direct_forces_kernel<false><<<blocks, kThreads, 0, s>>>(
          p, m, a, n, eps2, G, box, inv_box);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
