// Blocked direct-summation N-body forces, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel of orbitanalysis_tpu/ops/pallas_nbody.py:
//   K14 _force_kernel (call :130, entry direct_forces_pallas)
//       -> direct_forces_kernel (+ add_splits_kernel) below
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
// and padded N to 1024 with zero-mass sources.  Here a block of kThreads
// threads owns kThreads * kTargets targets, kTargets a thread (strided by
// kThreads, so loads coalesce), with their sums in registers, and walks
// its sources in tiles of kThreads staged in shared memory as float4
// (x, y, z, m): one shared load feeds kTargets independent pairs, which
// also gives the float32 pipe kTargets chains to interleave.  Where the
// target blocks alone would leave the card short of work (the wrapper's
// direct_force_split: fewer than 4 blocks an SM), the sources are split
// into `splits` contiguous chunks, one block for each (target block,
// chunk); each writes its chunk's partial sums, and add_splits_kernel adds
// them per target in chunk order and scales by G.  The ragged edge is
// masked: a source past its chunk is staged with mass 0, a target past N
// computes and is not written.  No atomics: every sum has a fixed order,
// so the result is the same bits on every run.
//
// Bound on the H100: operations, not bytes (N^2 pairs on 16 N bytes).
// Its FMAs are written out (fmaf), which the library's --fmad=false
// leaves alone (nothing else here has an a*b+c to contract), so a pair
// issues 12 float32 instructions free (3 subtracts, r^2 as 3 FMAs from
// eps^2, 2 multiplies for r^-3 and 1 for the mass, 3 FMAs into the sums;
// and the clamp where the softening is below 1e-9) and 21 periodic (a
// multiply, a round and an FMA more per component), on a pipe that issues
// 128 a clock per SM; and one MUFU.RSQ on the special-function unit, 16 a
// clock per SM (rsqrt_approx: rsqrtf without the three instructions of
// its subnormal guard).  So the float32 pipe binds: the SFU needs 8/12 of
// its time free, 8/21 periodic.  The plain version rounds each product
// and sum on its own; the two agree to the JAX test's tolerance
// (ops/nbody.py).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTargets = 4;

// rsqrtf's MUFU.RSQ without its guard for subnormal inputs: d2 >= 1e-18
// is never subnormal, so the result is rsqrtf's.
__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kClamp: clamp r^2 at 1e-18.  Without it where eps^2 >= 1e-18, which
// leaves r^2 >= eps^2 >= 1e-18 (each FMA adds a square and rounds
// monotonically), so the clamp could change nothing.
template <bool kPeriodic, bool kClamp>
__global__ void __launch_bounds__(kThreads)
direct_forces_kernel(const float* __restrict__ pos,
                     const float* __restrict__ mass, float* __restrict__ acc,
                     int n, int chunk, float eps2, float G, float box,
                     float inv_box) {
  __shared__ float4 tile[kThreads];
  const int first = blockIdx.x * kThreads * kTargets + threadIdx.x;
  float xt[kTargets], yt[kTargets], zt[kTargets];
  float ax[kTargets], ay[kTargets], az[kTargets];
#pragma unroll
  for (int k = 0; k < kTargets; ++k) {
    const int i = first + k * kThreads;
    const bool live = i < n;
    xt[k] = live ? pos[3 * i] : 0.0f;
    yt[k] = live ? pos[3 * i + 1] : 0.0f;
    zt[k] = live ? pos[3 * i + 2] : 0.0f;
    ax[k] = ay[k] = az[k] = 0.0f;
  }
  const int begin = blockIdx.y * chunk;
  const int end = min(n, begin + chunk);
  for (int s0 = begin; s0 < end; s0 += kThreads) {
    const int j = s0 + threadIdx.x;
    tile[threadIdx.x] = j < end ? make_float4(pos[3 * j], pos[3 * j + 1],
                                              pos[3 * j + 2], mass[j])
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kThreads; ++t) {
      const float4 s = tile[t];
#pragma unroll
      for (int k = 0; k < kTargets; ++k) {
        float dx = s.x - xt[k], dy = s.y - yt[k], dz = s.z - zt[k];
        if (kPeriodic) {
          dx = fmaf(-box, rintf(dx * inv_box), dx);
          dy = fmaf(-box, rintf(dy * inv_box), dy);
          dz = fmaf(-box, rintf(dz * inv_box), dz);
        }
        float d2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
        if (kClamp) d2 = fmaxf(d2, 1e-18f);
        const float inv = rsqrt_approx(d2);
        const float w = s.w * (inv * inv * inv);
        ax[k] = fmaf(w, dx, ax[k]);
        ay[k] = fmaf(w, dy, ay[k]);
        az[k] = fmaf(w, dz, az[k]);
      }
    }
    __syncthreads();
  }
  // one chunk: the sums scaled by G; else this chunk's partial sums, at
  // [blockIdx.y, i, c]
  const bool whole = gridDim.y == 1;
  float* dst = acc + static_cast<size_t>(blockIdx.y) * 3 * n;
  const float scale = whole ? G : 1.0f;
#pragma unroll
  for (int k = 0; k < kTargets; ++k) {
    const int i = first + k * kThreads;
    if (i < n) {
      dst[3 * i] = scale * ax[k];
      dst[3 * i + 1] = scale * ay[k];
      dst[3 * i + 2] = scale * az[k];
    }
  }
}

// acc[e] = G * (partial[0][e] + partial[1][e] + ...), in chunk order.
__global__ void __launch_bounds__(256)
add_splits_kernel(const float* __restrict__ partial, float* __restrict__ acc,
                  int n3, int splits, float G) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= n3) return;
  float sum = partial[e];
  for (int s = 1; s < splits; ++s) {
    sum = sum + partial[static_cast<size_t>(s) * n3 + e];
  }
  acc[e] = G * sum;
}

}  // namespace

// pos [n, 3] f32, mass [n] f32 -> acc [n, 3] f32 (written whole); with
// splits > 1, partial [splits, n, 3] f32 scratch and sources in chunks of
// `chunk` (splits * chunk >= n).
extern "C" int direct_forces(const void* pos, const void* mass, void* acc,
                             void* partial, int n, int splits, int chunk,
                             float eps2, float G, int periodic, float box,
                             float inv_box, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const dim3 grid((n + kThreads * kTargets - 1) / (kThreads * kTargets),
                    splits);
    const float* p = static_cast<const float*>(pos);
    const float* m = static_cast<const float*>(mass);
    float* out = static_cast<float*>(splits > 1 ? partial : acc);
    const bool clamp = !(eps2 >= 1e-18f);
    const auto kernel =
        periodic ? (clamp ? direct_forces_kernel<true, true>
                          : direct_forces_kernel<true, false>)
                 : (clamp ? direct_forces_kernel<false, true>
                          : direct_forces_kernel<false, false>);
    kernel<<<grid, kThreads, 0, s>>>(p, m, out, n, chunk, eps2, G, box,
                                     inv_box);
    if (splits > 1) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      add_splits_kernel<<<(3 * n + 255) / 256, 256, 0, s>>>(
          static_cast<const float*>(partial), static_cast<float*>(acc), 3 * n,
          splits, G);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
