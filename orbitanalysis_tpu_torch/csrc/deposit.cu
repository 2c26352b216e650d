// Sorted-stream cloud-in-cell mass deposit, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of orbitanalysis_tpu/ops/pallas_deposit.py:
//   K13 _deposit_kernel (call :217 in _deposit_call; entries
//       cic_deposit_sorted :286, cic_deposit_sorted_slabs :326)
//       -> run_sums_kernel + gather_cells_kernel below
//
// Input: a stream of n entries sorted by base-cell key k = bx*sx + by*sy
// + bz on the virtual (G+1)^3 grid (sx = (G+1)^2, sy = G+1), keys [n]
// i32 ascending, fracs [4, n] f32 (fx, fy, fz, m).  Output: out [V] f32,
// the flat virtual grid: each entry adds its 8 trilinear weights to the
// cells k + {0, 1, sy, sy+1, sx, sx+1, sx+sy, sx+sy+1}.  The weights are
// wx0 = (1 - fx) * m, wx1 = fx * m, times wy = (1 - fy, fy), times
// wz = (1 - fz, fz), in the corner order (dx, dy, dz) lexicographic, dz
// minor, each product left to right (pallas_deposit.py:156-169).  The
// stream's sort and the fold of the three == G faces stay plain torch
// (ops/deposit.py).
//
// The TPU kernel kept the whole virtual grid VMEM-resident, consumed the
// stream in 2048-entry chunks through a data-dependent 512-cell window
// loop and reduced each window with a one-hot MXU matmul; grids past the
// VMEM budget took an X-slab scan.  None of that carries over.  Here the
// grid lies in device memory (0.54 GB at 512^3), and the deposit is two
// passes with no atomics, so it is the same bits on every run:
//   pass 1 (run_sums_kernel), one thread an entry: the thread that heads
//     a run of equal keys adds the run's 8 corner weights in stream
//     order (acc = 0, then acc += w) and writes them to r8[corner][key].
//     The stream is sorted, so a run is contiguous and each key has one
//     writer; r8 [8, V] is zeroed first (cudaMemsetAsync).
//   pass 2 (gather_cells_kernel), one thread a virtual cell c:
//     out[c] = sum over corners, in corner order from 0, of
//     r8[corner][c - offset(corner)] where c >= offset.
// The plain version (ops/deposit.py deposit_stream_torch) adds in the
// same orders and equals the kernel bit for bit.
//
// Bound on the H100: bytes.  The function reads 20 bytes an entry and
// writes 4 a cell (0.095 ms for 12.6M entries onto 257^3 at 3.35 TB/s);
// the two passes also zero, write and read the 32 bytes a cell of r8,
// ~3.4x that traffic at ~0.75 entries a cell.  A key outside [0, V) is
// skipped (the wrapper's callers build keys in range).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
run_sums_kernel(const int32_t* __restrict__ keys,
                const float* __restrict__ fracs, float* __restrict__ r8,
                int n, long long v) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int32_t k = keys[i];
  if ((i > 0 && keys[i - 1] == k) || k < 0 || k >= v) return;
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = i; j < n && keys[j] == k; ++j) {
    const float fx = fracs[j];
    const float fy = fracs[static_cast<size_t>(n) + j];
    const float fz = fracs[2 * static_cast<size_t>(n) + j];
    const float m = fracs[3 * static_cast<size_t>(n) + j];
    const float wx0 = (1.0f - fx) * m, wx1 = fx * m;
    const float wy0 = 1.0f - fy, wy1 = fy;
    const float wz0 = 1.0f - fz, wz1 = fz;
    acc[0] = acc[0] + wx0 * wy0 * wz0;
    acc[1] = acc[1] + wx0 * wy0 * wz1;
    acc[2] = acc[2] + wx0 * wy1 * wz0;
    acc[3] = acc[3] + wx0 * wy1 * wz1;
    acc[4] = acc[4] + wx1 * wy0 * wz0;
    acc[5] = acc[5] + wx1 * wy0 * wz1;
    acc[6] = acc[6] + wx1 * wy1 * wz0;
    acc[7] = acc[7] + wx1 * wy1 * wz1;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) r8[c * v + k] = acc[c];
}

__global__ void __launch_bounds__(kThreads)
gather_cells_kernel(const float* __restrict__ r8, float* __restrict__ out,
                    long long v, int sx, int sy) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long off[8] = {0, 1, sy, sy + 1, sx, sx + 1, sx + sy,
                            sx + sy + 1};
  for (long long c = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       c < v; c += stride) {
    float acc = 0.0f;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (c >= off[q]) acc = acc + r8[q * v + c - off[q]];
    }
    out[c] = acc;
  }
}

}  // namespace

// keys [n] i32 sorted, fracs [4, n] f32, r8 [8, v] f32 scratch, out [v]
// f32 (written whole).
extern "C" int deposit_sorted(const void* keys, const void* fracs, void* r8,
                              void* out, int n, long long v, int sx, int sy,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaMemsetAsync(r8, 0, 8 * v * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    run_sums_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const int32_t*>(keys), static_cast<const float*>(fracs),
        static_cast<float*>(r8), n, v);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long want = (v + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  gather_cells_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const float*>(r8), static_cast<float*>(out), v, sx, sy);
  return static_cast<int>(cudaGetLastError());
}
