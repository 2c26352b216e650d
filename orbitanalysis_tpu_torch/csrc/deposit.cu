// Sorted-stream cloud-in-cell mass deposit, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of orbitanalysis_tpu/ops/pallas_deposit.py:
//   K13 _deposit_kernel (call :217 in _deposit_call; entries
//       cic_deposit_sorted :286, cic_deposit_sorted_slabs :326)
//       -> row_bounds_kernel + deposit_rows_kernel below
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
// The arithmetic is fixed by the plain version (ops/deposit.py
// deposit_stream_torch), which the kernel equals bit for bit: each run of
// equal keys is summed in stream order from 0, one sum R_q[k] for each
// corner q, and each cell c is then 0 + R_0[c] + R_1[c-1] + R_2[c-sy] + ...
// + R_7[c-sx-sy-1], added in corner order (terms below key 0 are 0).  No
// atomics anywhere, so it is the same bits on every run.
//
// The TPU kernel kept the whole virtual grid VMEM-resident, consumed the
// stream in 2048-entry chunks through a data-dependent 512-cell window
// loop and reduced each window with a one-hot MXU matmul; none of that
// carries over.  The card's design works on rows of the flat grid: row j
// is the sy cells [j*sy, (j+1)*sy).  A cell of row j reads the run sums
// of four key rows only: j (corners 0, 1), j - 1 (2, 3), j - sx/sy (4, 5)
// and j - sx/sy - 1 (6, 7), each at its own position and the one before.
// Because the stream is sorted, the entries of a key row are one
// contiguous range of it.
//   pass 1 (row_bounds_kernel), one thread a row edge: two binary searches
//     give lo[j], the first entry with key >= j*sy - 1, and hi[j], the
//     first with key >= j*sy.  Key row j is the range [lo[j], hi[j+1]):
//     its sy cells and the last cell of row j - 1, so every term a row of
//     cells needs lies in the key rows it reads.  2 * (rows + 1) ints of
//     scratch (2 MB at 513^3, against 4.3 GB for a dense [8, V] table).
//   pass 2 (deposit_rows_kernel), a block walks kRowsPerBlock consecutive
//     rows.  Each step j stages the entries of key row j (their dx = 0
//     weights) and of key row j - sx/sy (dx = 1) in shared memory, tile by
//     tile; the first entry of each run within a tile continues the run's
//     sum from the row buffer (0 for a new run) in stream order, so a run
//     may cross tiles.  The row buffers are a ring of two rows, four
//     corners each, for each dx: step j writes row j's cells from the
//     current and the previous step's sums, and then overwrites the older.
//     The first step of a block computes the row before its first without
//     writing it.
// The stream is read twice (once for dx = 0, once for dx = 1, the second
// mostly from L2: it is the same data sx/sy rows later), plus one row in
// kRowsPerBlock again; out is written once, whole, so nothing is zeroed.
//
// Bound on the H100: bytes.  The function reads 20 bytes an entry and
// writes 4 a cell (0.095 ms for 12.6M entries onto 257^3 at 3.35 TB/s).
// A key outside [0, n_cells) deposits nothing.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // threads a block, entries a tile
constexpr int kRowsPerBlock = 16;  // rows of cells a block writes

__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ keys,
                                           int n, long long t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (static_cast<long long>(keys[mid]) < t) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// bounds[0][j] = lo[j], bounds[1][j] = hi[j], j in [0, rows].
__global__ void __launch_bounds__(kThreads)
row_bounds_kernel(const int32_t* __restrict__ keys, int n, int sy, int rows,
                  int* __restrict__ bounds) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j > rows) return;
  const long long start = static_cast<long long>(j) * sy;
  bounds[j] = lower_bound(keys, n, start - 1);
  bounds[rows + 1 + j] = lower_bound(keys, n, start);
}

// One side (dx = 0 or 1) of a step: the entries [begin, end) of key row
// `row`, whose buffer position p holds key row*sy - 1 + p.
struct Side {
  int begin, end;
  long long base;  // key of buffer position 0
};

__global__ void __launch_bounds__(kThreads)
deposit_rows_kernel(const int32_t* __restrict__ keys,
                    const float* __restrict__ fracs,
                    const int* __restrict__ bounds, float* __restrict__ out,
                    int n, long long n_cells, int sy, int rows_x, int rows) {
  // ring[dx][slot][corner][p], p in [0, sy]: the run sums of the key
  // rows of the current and the previous step, the four (dy, dz) corners
  // of one dx
  extern __shared__ float4 ring_mem[];  // float4: 16-byte aligned
  float* ring = reinterpret_cast<float*>(ring_mem);
  __shared__ int tkey[2][kThreads];
  __shared__ float tw[2][4][kThreads];
  __shared__ int seg[kRowsPerBlock + 1][2][2];

  const int width = sy + 1;
  const int plane = 4 * width;
  const int j0 = blockIdx.x * kRowsPerBlock;
  const int j1 = min(j0 + kRowsPerBlock, rows);
  const int steps = j1 - j0 + 1;  // rows j0 - 1 .. j1 - 1
  const int* lo = bounds;
  const int* hi = bounds + rows + 1;

  // the stream ranges of every key row this block reads
  if (threadIdx.x < 2 * steps) {
    const int s = threadIdx.x >> 1, dx = threadIdx.x & 1;
    const int r = j0 - 1 + s - dx * rows_x;
    seg[s][dx][0] = r >= 0 ? lo[r] : 0;
    seg[s][dx][1] = r >= 0 ? hi[r + 1] : 0;
  }

  for (int s = 0; s < steps; ++s) {
    const int j = j0 - 1 + s;
    const int cur = s & 1;
    __syncthreads();  // the previous step's reads of the ring are done
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      float4* slot = ring_mem + (dx * 2 + cur) * width;
      for (int t = threadIdx.x; t < width; t += kThreads) {
        slot[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    Side side[2];
    int n_tiles = 0;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      side[dx].begin = seg[s][dx][0];
      side[dx].end = seg[s][dx][1];
      side[dx].base = static_cast<long long>(j - dx * rows_x) * sy - 1;
      n_tiles = max(n_tiles,
                    (side[dx].end - side[dx].begin + kThreads - 1) / kThreads);
    }
    for (int tile = 0; tile < n_tiles; ++tile) {
      // stage this tile's entries and their four weights for each dx
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int i = side[dx].begin + tile * kThreads + threadIdx.x;
        if (i < side[dx].end) {
          const float fx = fracs[i];
          const float fy = fracs[static_cast<size_t>(n) + i];
          const float fz = fracs[2 * static_cast<size_t>(n) + i];
          const float m = fracs[3 * static_cast<size_t>(n) + i];
          const float wx = dx ? fx * m : (1.0f - fx) * m;
          const float wy0 = 1.0f - fy, wy1 = fy;
          const float wz0 = 1.0f - fz, wz1 = fz;
          tkey[dx][threadIdx.x] = keys[i];
          tw[dx][0][threadIdx.x] = wx * wy0 * wz0;
          tw[dx][1][threadIdx.x] = wx * wy0 * wz1;
          tw[dx][2][threadIdx.x] = wx * wy1 * wz0;
          tw[dx][3][threadIdx.x] = wx * wy1 * wz1;
        }
      }
      __syncthreads();
      // the first entry of each run in the tile sums it on, in stream order
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int first = side[dx].begin + tile * kThreads;
        const int count = min(kThreads, side[dx].end - first);
        const int t = threadIdx.x;
        if (t >= count) continue;
        const int32_t k = tkey[dx][t];
        if ((t > 0 && tkey[dx][t - 1] == k) || k < 0 || k >= n_cells) continue;
        float* buf = ring + dx * 2 * plane + cur * plane + (k - side[dx].base);
        float acc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = buf[q * width];
        for (int u = t; u < count && tkey[dx][u] == k; ++u) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = acc[q] + tw[dx][q][u];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) buf[q * width] = acc[q];
      }
      __syncthreads();  // the tile's sums are in the ring
    }
    if (n_tiles == 0) __syncthreads();  // the ring is zeroed
    if (s == 0) continue;  // the row before the block's first: read only
    // row j of cells: corners in order, (dy, dz) within each dx
    const float* c0 = ring + cur * plane;
    const float* p0 = ring + (cur ^ 1) * plane;
    const float* c1 = c0 + 2 * plane;
    const float* p1 = p0 + 2 * plane;
    const long long row0 = static_cast<long long>(j) * sy;
    for (int z = threadIdx.x; z < sy && row0 + z < n_cells; z += kThreads) {
      float acc = 0.0f;
      acc = acc + c0[z + 1];
      acc = acc + c0[width + z];
      acc = acc + p0[2 * width + z + 1];
      acc = acc + p0[3 * width + z];
      acc = acc + c1[z + 1];
      acc = acc + c1[width + z];
      acc = acc + p1[2 * width + z + 1];
      acc = acc + p1[3 * width + z];
      out[row0 + z] = acc;
    }
  }
}

}  // namespace

// Shared memory of deposit_rows_kernel's row ring, by sy.
static size_t ring_bytes(int sy) {
  return static_cast<size_t>(16) * (sy + 1) * sizeof(float);
}

// keys [n] i32 sorted, fracs [4, n] f32, bounds [2, rows + 1] i32 scratch
// (rows = ceil(v / sy)), out [v] f32 (written whole); sx a multiple of sy.
extern "C" int deposit_sorted(const void* keys, const void* fracs,
                              void* bounds, void* out, int n, long long v,
                              int sx, int sy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (v <= 0) return static_cast<int>(cudaGetLastError());
  const int rows = static_cast<int>((v + sy - 1) / sy);
  row_bounds_kernel<<<rows / kThreads + 1, kThreads, 0, s>>>(
      static_cast<const int32_t*>(keys), n, sy, rows,
      static_cast<int*>(bounds));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = ring_bytes(sy);
  err = cudaFuncSetAttribute(deposit_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  deposit_rows_kernel<<<(rows + kRowsPerBlock - 1) / kRowsPerBlock, kThreads,
                        smem, s>>>(
      static_cast<const int32_t*>(keys), static_cast<const float*>(fracs),
      static_cast<const int*>(bounds), static_cast<float*>(out), n, v, sy,
      sx / sy, rows);
  return static_cast<int>(cudaGetLastError());
}
