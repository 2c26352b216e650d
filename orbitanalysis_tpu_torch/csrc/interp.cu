// Cloud-in-cell interpolation of a periodic vector field to particles,
// hand-written for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package,
// orbitanalysis_tpu/models/pm.py:129 cic_interpolate is plain jnp (8
// corner indices and weights a particle, 24 scalar gathers), which XLA
// fuses on the TPU.  Run as eager torch on the card (models/pm.py
// cic_interpolate_torch, the plain version below), the same chain took
// ~190 launches a call and wrote [8, N] int64 corner indices and [8, N]
// f32 weights to device memory before its 24 gathers of 8-byte indices.
// cic_interpolate_kernel is that chain in one launch.
//
// Input: field [3, G, G, G] f32 (the force planes of pm_forces_grid),
// pos [N, 3] f32, h the float32 cell size box / G.  Output: acc [N, 3]
// f32.  For each particle, operation for operation as the plain version,
// which it equals bit for bit (the library builds with --fmad=false):
//   x = pos / h - 0.5 on each axis, the quotient the IEEE one
//     (__fdiv_rn: the float64 quotient rounded to float32, as div_rn
//     takes it, is the same value);
//   b = floor(x) as int64, wrapped into [0, G) with Python's sign rule,
//     and its +1 neighbour (b + 1) mod G; f = x - floor(x);
//   corner q = (dx, dy, dz), dz fastest (models/pm.py _CORNERS), weighs
//     (wx * wy) * wz with w = 1 - f for d = 0 and f for d = 1;
//   each component is ((v_0 w_0 + v_1 w_1) + v_2 w_2) + ... + v_7 w_7,
//     every product and sum rounded on its own.
// Flat offsets are 64-bit: any grid whose field fits in memory.
//
// Bound on the H100: bytes.  The function reads 12 B a particle and each
// field cell once (12 B a cell), and writes 12 B a particle: 24 N + 12
// G^3 bytes (503 MB, 0.150 ms at 12.6M / 256^3 at 3.35 TB/s).  It cannot
// come near that bound: particles come in index order, uniform in the
// box, so each one's corners are random 32-byte sectors of the field,
// about 13.5 a particle (4 (x, y) rows a component; the two z-neighbours
// of a row share one sector 7 times in 8), 5.4 GB of sector traffic at
// 12.6M.  At 256^3 the field (201 MB) is four times the 50 MB L2, so one
// pass over the particles would take most sectors from DRAM (4.75 ms,
// PERF.md).  The kernel visits the field by slabs instead: blockIdx.y is
// a slab of `width` x-planes, and the card hands out blocks about in
// order of their linear index (x fastest), so it works through the slabs
// one after another (the order is for speed only; every particle is
// written once, by the block of its slab, in any order); each block reads
// its particles' positions (streaming loads, evicted first) and
// interpolates only those whose base x-plane lies in its slab, whose
// corners lie in the slab's planes and the next one.  The wrapper takes
// the fewest slabs whose three planes fit a third of the L2 (12 at
// 256^3, at most 16), so the gathers hit the L2; the cost is one read of
// the positions a slab.  A block takes kPer particles a thread (fewer,
// longer blocks a pass); a particle's base cell and weights stay in
// registers, its 24 corner loads are all issued on the read-only path
// before any product is formed, and its row of acc is written once.
//
// The stream form, cic_interpolate_kernel_stream (C entry
// cic_interpolate_stream, launches counted as cic_interpolate), replaces
// that form in the PM force wherever the force deposits through the
// sorted stream (models/pm.py pm_forces): it visits the particles in the
// deposit's cell-sorted order (ops/deposit.py _sorted_stream) instead of
// their index order.  Input: field as above, the stream's keys [N] int32
// (base cells on the virtual (G+1)^3 grid, strides sx = (G+1)^2, sy =
// G+1, each cell wrapped into [0, G)), fracs [4, N] f32 (rows fx, fy,
// fz read; the mass row not) and order [N] int64 (entry i is particle
// order[i]).  Output: acc [N, 3], row order[i] from entry i.  The
// arithmetic is the positions form's: the stream's fractions are the
// floats x - floor(x) that base_cell forms, its keys the same wrapped
// base cells (bx = k / sx, by = (k % sx) / sy, bz = k % sy), so the two
// forms and the plain twin (models/pm.py cic_interpolate_stream_torch)
// equal bit for bit.
//
// Bound on the H100: bytes.  It reads 24 B an entry (key 4, fractions
// 12, order 8), writes 12 B a particle and reads each field cell once
// (12 B a cell): 36 N + 12 G^3 bytes (654 MB, 0.195 ms at 12.6M /
// 256^3).  The gathers come close to one read of the field: one thread
// an entry, consecutive threads on consecutive entries, so a warp's 32
// entries lie in some 43 consecutive cells of one or two (x, y) rows and
// its corner loads share sectors (about 3 a particle, against 13.5 in
// index order), and the stream sweeps the x-planes in order, so the
// working set is two planes of three components (1.5 MB at 256^3),
// which the L2 holds: no slabs, no position read.  The stream is read by
// streaming loads (evicted first) and each entry's 24 corner loads are
// issued before any product.  Written in stream order, the rows would
// take the whole pass to 0.247 ms at 12.6M / 256^3 (PERF.md).  The
// scattered write is the cost: rows land at random particle indices in
// an array three times the L2, 1.25 32-byte sectors a 12-byte row, each
// sector written in part (40 B of sector traffic a particle, 0.300 ms
// with the reads, before any read-modify-write).  Three scalar stores a
// row, each a request of its own, took the pass to 1.90 ms (the scatter
// alone 1.81); store_rows hands each warp's 32 rows, through shuffles,
// to three store instructions of whole rows, one request a row or two,
// which took it to 1.11 ms (the scatter alone 1.01).  What would come
// closer changes another layer: particles kept near cell order in
// memory, so that order[i] is near i.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;
constexpr int kTile = kThreads * kPer;

// Python's i mod g, in [0, g): torch.remainder on int64.
__device__ __forceinline__ long long wrap(long long i, long long g) {
  if (i >= 0 && i < g) return i;
  const long long r = i % g;
  return r < 0 ? r + g : r;
}

// The +1 neighbour of wrapped cell b on an axis of g cells.
__device__ __forceinline__ long long up_cell(long long b, long long g) {
  return b + 1 == g ? 0 : b + 1;
}

// The base cell of coordinate p on an axis of g cells, its fraction
// toward the +1 neighbour and that neighbour.
__device__ __forceinline__ void base_cell(float p, float h, long long g,
                                          long long& b, long long& up,
                                          float& f) {
  const float x = __fdiv_rn(p, h) - 0.5f;
  const float fl = floorf(x);
  f = x - fl;
  b = wrap(static_cast<long long>(fl), g);
  up = up_cell(b, g);
}

// The three components at base cell b (neighbours up) with fractions f,
// written to row_out[0..2].
__device__ __forceinline__ void corners(const float* __restrict__ field,
                                        float* __restrict__ row_out,
                                        const long long* b,
                                        const long long* up, const float* f,
                                        long long g) {
  // the four (x, y) rows of the stencil, (dx, dy) lexicographic
  const long long row[4] = {(b[0] * g + b[1]) * g, (b[0] * g + up[1]) * g,
                            (up[0] * g + b[1]) * g, (up[0] * g + up[1]) * g};
  const long long z[2] = {b[2], up[2]};
  const long long g3 = g * g * g;
  float v[3][8];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      v[c][q] = __ldg(field + c * g3 + row[q >> 1] + z[q & 1]);
    }
  }
  const float wx[2] = {1.0f - f[0], f[0]};
  const float wy[2] = {1.0f - f[1], f[1]};
  const float wz[2] = {1.0f - f[2], f[2]};
  float w[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) w[q] = (wx[q >> 2] * wy[(q >> 1) & 1]) * wz[q & 1];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float a = v[c][0] * w[0];
#pragma unroll
    for (int q = 1; q < 8; ++q) a = a + v[c][q] * w[q];
    row_out[c] = a;
  }
}

// Particle i at p, when its base x-plane lies in [lo, lo + width).
__device__ __forceinline__ void interpolate(const float* __restrict__ field,
                                            float* __restrict__ acc,
                                            long long i, const float* p,
                                            float h, long long g,
                                            long long lo, int width) {
  long long b[3], up[3];
  float f[3];
  base_cell(p[0], h, g, b[0], up[0], f[0]);
  if (b[0] < lo || b[0] >= lo + width) return;
  base_cell(p[1], h, g, b[1], up[1], f[1]);
  base_cell(p[2], h, g, b[2], up[2], f[2]);
  corners(field, acc + 3 * i, b, up, f, g);
}

__global__ void __launch_bounds__(kThreads)
cic_interpolate_kernel(const float* __restrict__ field,
                       const float* __restrict__ pos, float* __restrict__ acc,
                       long long n, int grid, float h, int width) {
  __shared__ float tile[3 * kTile];
  const long long first = static_cast<long long>(blockIdx.x) * kTile;
  const int live = static_cast<int>(
      n - first < kTile ? n - first : static_cast<long long>(kTile));
#pragma unroll
  for (int k = 0; k < 3 * kPer; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < 3 * live) tile[j] = __ldcs(pos + 3 * first + j);
  }
  __syncthreads();
  const long long lo = static_cast<long long>(width) * blockIdx.y;
#pragma unroll 1
  for (int k = 0; k < kPer; ++k) {
    const int j = threadIdx.x + k * kThreads;
    if (j < live) {
      interpolate(field, acc, first + j, tile + 3 * j, h, grid, lo, width);
    }
  }
}

// The warp's 32 rows (row o of lane l holds v), written by three store
// instructions: lane l of instruction s stores element 32 s + l of the
// warp's 96 floats, so a row's 12 bytes leave in one request, or two
// where it straddles two instructions, and not in three.  Every lane of
// the warp takes part; a lane whose live is false writes nothing.
__device__ __forceinline__ void store_rows(float* __restrict__ acc,
                                           long long o, const float* v,
                                           bool live) {
  constexpr unsigned kFull = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int e = 32 * s + lane;
    const int r = e / 3;
    const int c = e - 3 * r;
    const float v0 = __shfl_sync(kFull, v[0], r);
    const float v1 = __shfl_sync(kFull, v[1], r);
    const float v2 = __shfl_sync(kFull, v[2], r);
    const long long dst = __shfl_sync(kFull, o, r);
    if (__shfl_sync(kFull, live ? 1 : 0, r)) {
      acc[3 * dst + c] = c == 0 ? v0 : (c == 1 ? v1 : v2);
    }
  }
}

// Stream entry i: its key's base cell and its fractions, written to
// row order[i].
__global__ void __launch_bounds__(kThreads)
cic_interpolate_kernel_stream(const float* __restrict__ field,
                              const int* __restrict__ keys,
                              const float* __restrict__ fracs,
                              const long long* __restrict__ order,
                              float* __restrict__ acc, long long n,
                              int grid) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = i < n;
  float v[3] = {0.0f, 0.0f, 0.0f};
  long long o = 0;
  if (live) {
    const int key = __ldcs(keys + i);
    const float f[3] = {__ldcs(fracs + i), __ldcs(fracs + n + i),
                        __ldcs(fracs + 2 * n + i)};
    o = __ldcs(order + i);
    const int sy = grid + 1;
    const int bx = key / (sy * sy);
    const int r = key - bx * (sy * sy);
    const int by = r / sy;
    const long long g = grid;
    const long long b[3] = {bx, by, r - by * sy};
    const long long up[3] = {up_cell(b[0], g), up_cell(b[1], g),
                             up_cell(b[2], g)};
    corners(field, v, b, up, f, g);
  }
  store_rows(acc, o, v, live);
}

}  // namespace

// slabs: the x-slabs the wrapper asks for; the kernel runs
// ceil(grid / width) of width = ceil(grid / slabs) planes each.
extern "C" int cic_interpolate(const void* field, const void* pos, void* acc,
                               long long n, int grid, float h, int slabs,
                               void* stream) {
  if (n > 0) {
    const long long blocks = (n + kTile - 1) / kTile;
    if (blocks > 0x7FFFFFFFLL || grid < 1 || slabs < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int width = (grid + slabs - 1) / slabs;
    const dim3 blocks2(static_cast<unsigned>(blocks),
                       static_cast<unsigned>((grid + width - 1) / width));
    cic_interpolate_kernel<<<blocks2, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(field), static_cast<const float*>(pos),
        static_cast<float*>(acc), n, grid, h, width);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys, fracs [4, n] and order: the deposit's cell-sorted stream of n
// entries on a grid^3 field; one thread an entry.
extern "C" int cic_interpolate_stream(const void* field, const void* keys,
                                      const void* fracs, const void* order,
                                      void* acc, long long n, int grid,
                                      void* stream) {
  if (n > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 0x7FFFFFFFLL || grid < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    cic_interpolate_kernel_stream<<<static_cast<unsigned>(blocks), kThreads,
                                    0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(field), static_cast<const int*>(keys),
        static_cast<const float*>(fracs),
        static_cast<const long long*>(order), static_cast<float*>(acc), n,
        grid);
  }
  return static_cast<int>(cudaGetLastError());
}
