// Halo frame kernels of the label-native detector, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of orbitanalysis_tpu/ops/pallas_frames.py:
//   K6  _frame_rows_bf16x3_kernel      (call :184, entry frame_rows_bf16x3)
//       -> frame_rows below
//   K7  _segment_moments_bf16x3_kernel (call :259, entry
//       segment_moments_bf16x3) -> segment_moments below
//
// frame_rows: out[c, i] = table[label[i], c], and 0 where label[i] is
// outside [0, H); table [H, C] f32, label [N] i32, out [C, N] f32 (SoA,
// the layout the detector reads).  The TPU made this gather exact and
// fast as one bf16x3 one-hot MXU pass; on the card it is a direct
// gather, exact by construction: every output is a copy of a table
// entry.  Bound on the H100: bytes (4 B in, 4 C B out per particle;
// the table stays in L1/L2).  One thread per particle, grid-stride,
// coalesced label reads and plane writes.
//
// segment_moments: the per-halo [sum m vx, sum m vy, sum m vz, sum m]
// over particles whose label is in [0, H) (m = 1 without masses);
// label [N] i32, vel [3, N] f32, mass [N] f32 or null -> out [H, 4].
// The order of every sum is fixed by N and H alone, so the result is
// the same bits on every run (no float atomics): a run-to-run change in
// a bulk velocity would move radial-velocity signs at knife edges.  The
// products m v are float32, as on the TPU; they are summed in float64
// and rounded to float32 once, so the result is the float32 rounding of
// nearly the exact sum (a float32 sum of ~3e4 random-sign terms drifts
// by tens of ulps of its result, and differently in every order).
//   pass 1: block b owns the fixed chunk [b * chunk, (b + 1) * chunk).
//     Each warp owns 512 consecutive particles (16 tiles of 32, loaded
//     4 tiles at a time) and a private [H, 4] float64 histogram in
//     shared memory.  Labels of real pools come in runs, so the tracked
//     particles of most tiles share one label: while consecutive tiles
//     keep one label, each lane adds its particle to float64 registers,
//     and when the run ends a fixed xor-butterfly adds the lanes into
//     the histogram.  A tile with several labels groups its lanes with
//     __match_any_sync, and the lowest lane of each group adds the group
//     in lane order: on the H100 that path is ~7x slower, which is why
//     untracked lanes (label -1) do not break a run.  The
//     block then adds its warps' histograms in warp order into
//     partial[b, H, 4] (float64).
//   pass 2: one warp per output sums the block partials, each lane a
//     fixed stride, then a fixed xor-butterfly, and rounds to float32.
// Bound on the H100: bytes (16 B per particle without masses, 20 with).
//
// Floats are only copied (frame_rows), or multiplied once and added in
// the fixed orders above; the build passes --fmad=false all the same.

#include "common.cuh"

namespace {

constexpr int kRowsThreads = 256;
constexpr int kMomTilesPerWarp = 16;  // 16 x 32 = 512 particles a warp
constexpr int kMomBatch = 4;          // tiles loaded at once
constexpr int kMomMaxWarps = 8;

__global__ void __launch_bounds__(kRowsThreads)
frame_rows_kernel(const float* __restrict__ table,
                  const int32_t* __restrict__ label, float* __restrict__ out,
                  int H, int C, long long N) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < N; i += stride) {
    const int l = label[i];
    const bool ok = l >= 0 && l < H;
    const float* row = table + static_cast<size_t>(ok ? l : 0) * C;
    for (int c = 0; c < C; ++c) out[static_cast<size_t>(c) * N + i] = ok ? __ldg(row + c) : 0.0f;
  }
}

// Adds a warp's per-lane run sums into its histogram row `label` (a
// fixed xor-butterfly, lane 0 writes) and clears them.
__device__ __forceinline__ void flush_run(double (&acc)[4], int label,
                                          double* hist) {
  if (label < 0) return;  // warp-uniform
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    double a = acc[c];
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) a += __shfl_xor_sync(0xffffffffu, a, d);
    if ((threadIdx.x & 31) == 0) hist[label * 4 + c] += a;
    acc[c] = 0.0;
  }
}

__global__ void __launch_bounds__(kMomMaxWarps * 32)
segment_moments_partial_kernel(const int32_t* __restrict__ label,
                               const float* __restrict__ vel,
                               const float* __restrict__ mass,
                               double* __restrict__ partial, int H,
                               long long N, int chunk) {
  extern __shared__ double hist[];  // [warps][H][4]
  __shared__ float stage[kMomMaxWarps][4][32];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  double* mine = hist + static_cast<size_t>(warp) * H * 4;
  for (int j = lane; j < H * 4; j += 32) mine[j] = 0.0;
  __syncwarp();
  const long long first = static_cast<long long>(blockIdx.x) * chunk +
                          static_cast<long long>(warp) * (kMomTilesPerWarp * 32);
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  int cur = -1;  // the label of the current run (warp-uniform), -1 none
  for (int t0 = 0; t0 < kMomTilesPerWarp; t0 += kMomBatch) {
    int l[kMomBatch];
    float v[kMomBatch][4];
#pragma unroll
    for (int b = 0; b < kMomBatch; ++b) {
      const long long i = first + (t0 + b) * 32 + lane;
      l[b] = -1;
      v[b][0] = v[b][1] = v[b][2] = v[b][3] = 0.0f;
      if (i < N) {
        l[b] = label[i];
        const float w = mass ? mass[i] : 1.0f;
        v[b][0] = vel[i] * w;
        v[b][1] = vel[N + i] * w;
        v[b][2] = vel[2 * N + i] * w;
        v[b][3] = w;
      }
      if (l[b] < 0 || l[b] >= H) l[b] = -1;
    }
#pragma unroll
    for (int b = 0; b < kMomBatch; ++b) {
      const unsigned valid = __ballot_sync(full, l[b] >= 0);
      if (valid == 0u) continue;  // nothing to add; the run goes on
      const int l0 = __shfl_sync(full, l[b], __ffs(valid) - 1);
      if (__all_sync(full, l[b] < 0 || l[b] == l0)) {
        // the tile's tracked particles share one label
        if (l0 != cur) {
          flush_run(acc, cur, mine);
          cur = l0;
        }
        if (l[b] >= 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[c] += v[b][c];
        }
        continue;
      }
      flush_run(acc, cur, mine);
      cur = -1;
      const unsigned peers = __match_any_sync(full, l[b]);
#pragma unroll
      for (int c = 0; c < 4; ++c) stage[warp][c][lane] = v[b][c];
      __syncwarp();
      if (l[b] >= 0 && lane == __ffs(peers) - 1) {
        double a[4] = {0.0, 0.0, 0.0, 0.0};
        for (unsigned m = peers; m; m &= m - 1) {
          const int j = __ffs(m) - 1;
#pragma unroll
          for (int c = 0; c < 4; ++c) a[c] += stage[warp][c][j];
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) mine[l[b] * 4 + c] += a[c];
      }
      __syncwarp();
    }
  }
  flush_run(acc, cur, mine);
  __syncthreads();
  double* out = partial + static_cast<size_t>(blockIdx.x) * H * 4;
  for (int j = threadIdx.x; j < H * 4; j += blockDim.x) {
    double s = hist[j];
    for (int w = 1; w < warps; ++w) s += hist[static_cast<size_t>(w) * H * 4 + j];
    out[j] = s;
  }
}

__global__ void __launch_bounds__(256)
segment_moments_final_kernel(const double* __restrict__ partial,
                             float* __restrict__ out, int n_blocks, int n_out) {
  const int j = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (j >= n_out) return;  // whole warps leave together
  double s = 0.0;
  for (int b = lane; b < n_blocks; b += 32) s += partial[static_cast<size_t>(b) * n_out + j];
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
  if (lane == 0) out[j] = static_cast<float>(s);
}

}  // namespace

// Entry points: launch on the caller's stream, return cudaGetLastError()
// (0 = launched).  Pointers are device pointers to C-contiguous arrays.

extern "C" int frame_rows(const void* table, const void* label, void* out,
                          int H, int C, long long N, void* stream) {
  if (N > 0) {
    const long long want = (N + kRowsThreads - 1) / kRowsThreads;
    const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
    frame_rows_kernel<<<blocks, kRowsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int32_t*>(label),
        static_cast<float*>(out), H, C, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// Scratch and launch geometry of segment_moments, for the wrapper to
// size the partials buffer: warps per block (0 when H is too large for
// one warp's histogram) and particles per block.
extern "C" int segment_moments_geometry(int H, int max_smem, int* warps,
                                        int* chunk) {
  const long long per_warp = static_cast<long long>(H) * 4 * sizeof(double);
  long long w = per_warp > 0 ? max_smem / per_warp : kMomMaxWarps;
  if (w > kMomMaxWarps) w = kMomMaxWarps;
  *warps = static_cast<int>(w);
  *chunk = static_cast<int>(w) * kMomTilesPerWarp * 32;
  return 0;
}

// partial: [n_blocks, H, 4] f64 scratch, n_blocks = ceil(N / chunk).
extern "C" int segment_moments(const void* label, const void* vel,
                               const void* mass, void* partial, void* out,
                               int H, long long N, int warps, int chunk,
                               int n_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = warps * H * 4 * static_cast<int>(sizeof(double));
  cudaError_t err = cudaFuncSetAttribute(
      segment_moments_partial_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_blocks > 0) {
    segment_moments_partial_kernel<<<n_blocks, warps * 32, smem, s>>>(
        static_cast<const int32_t*>(label), static_cast<const float*>(vel),
        static_cast<const float*>(mass), static_cast<double*>(partial), H, N,
        chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int n_out = H * 4;
  if (n_out > 0) {
    segment_moments_final_kernel<<<(n_out + 7) / 8, 256, 0, s>>>(
        static_cast<const double*>(partial), static_cast<float*>(out),
        n_blocks, n_out);
  }
  return static_cast<int>(cudaGetLastError());
}
