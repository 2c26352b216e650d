// The label-native detector's detect pass, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of orbitanalysis_tpu/ops/pallas_label.py:
//   K9  _detect_label_kernel          (call :395, entry
//       detect_label_pallas) -> detect_label_rows below
//   K8  _detect_label_compact_kernel  (call :555, entry
//       detect_label_compact_pallas) -> detect_label_compact_rows below
//   K10 _fused_label_kernel           (call :273, entry
//       fused_label_detect) -> fused_label_rows below
// One chain, detect_one<kPacked, kTable>, serves all three: K9 and K10
// are detect_label_kernel<kPacked, kTable>, K8 detect_label_compact_kernel.
// K8 and K9 read each particle's frame row (halo centre, bulk velocity)
// from a [6, R, W] rows plane, the output of K6; K10 (kTable) reads it
// from the [H, 6] frame table in global memory, table[label] and 0 where
// the label is outside [0, H) (the TPU's exact one-hot MXU gather; here a
// copy, so it is the same bits as K6 followed by K9).  The table stays
// resident in L2 (50 MB; a 12,000-halo table is 288 KB) and its rows in
// the read-only cache, so the number of halos has no limit of its own.
//
// Per particle i of the [R, W] row planes (row r = i / W, position
// p = i % W), the elementwise chain of pallas_label._detect_core:
// geometry against the frame rows (periodic wrap, r-hat, v_r with the
// Hubble term), the v_r sign bits, FRESH / matched from lab_sv, the
// Cephes arccos of the clipped cosine against the carried r-hat
// (octahedral-decoded when packed), the packed angle carry, the new
// lab_sv and r-hat (octahedral-encoded when packed), and the payload
// word ((p + 1) << 15) | f16_rne(angle) where an apsis fired.
//   K9 writes the carry planes, the [R, W] payload plane and count[R]
//      (count must arrive zeroed: each block adds its apsides with one
//      integer atomicAdd, which is order-free and so exact).
//   K8 writes the carry planes, the events front-packed in position
//      order into [R, k128] (zeros past the count) and count[R] (the
//      true count, which may exceed k128).  Its compaction is exact, so
//      the TPU's per-block overflow channel and the lax.cond reroute
//      through K4 are gone, and it does not write the [R, W] payload
//      plane, which existed only for that reroute.
//
// Exactness against the plain version (ops/label.py detect_label_torch):
// every float operation is the same IEEE operation in the same order.
// --fmad=false keeps a*b+c as two rounded operations; sqrtf and '/' are
// the correctly rounded ones (-prec-sqrt=true -prec-div=true, the
// defaults, stated in the build); jnp.round is round-half-to-even, which
// is rintf here (not roundf); 1 / max(r, 1e-30) keeps that form; the
// Cephes constants are rounded from double to float as the JAX and
// torch versions round their Python floats.
//
// What bounds it on the H100: bytes.  K8 at the bench shape (R = 64,
// W = 32768, packed r-hat) reads 64 B and writes 12 B per particle:
// 159 MB, 47.7 us at 3.35 TB/s; K10 reads 40 B and writes 16 B, the
// frame rows never leaving the chip: 117 MB, 35 us.  Design: K9 and K10
// run one 256-thread block per 256 particles (grid W / 256 x R), so they
// fill the card.  K8 is one launch over (row, tile) tiles of
// kCompactThreads x kCompactVT positions, taken in arrival order
// (common.cuh claim_tile): each thread runs the chain on its kCompactVT
// lanes (position v * kCompactThreads + threadIdx.x of the tile, so
// every plane is read and written coalesced), keeps each lane's payload
// word in a register, and the tile's events go to prefix + rank of the
// row's [k128] events, the rank from tile_ranks and the prefix (the
// events of the row's earlier tiles) from the decoupled look-back
// (lookback_prefix).  The row's last tile writes the exact count and
// zero-fills the row's tail (finish_row); the other tiles of the row
// write below its total, so that is safe in any finishing order.

#include "common.cuh"

namespace {

constexpr int kDetectThreads = 256;   // K9
// K8's tile: the fastest of 256 x 2, 4, 8, 128 x 8 and 512 x 2 on the
// card (detect_variants.py); 40 registers a thread, no spills.
constexpr int kCompactThreads = 256;  // K8: threads a tile
constexpr int kCompactVT = 4;         // K8: positions a thread
constexpr int kCompactTile = kCompactThreads * kCompactVT;

struct DetectArgs {
  const float* rows;     // [6, R, W] centre xyz, bulk velocity xyz (K8, K9)
  const float* table;    // [H, 6] centre xyz, bulk velocity xyz (K10)
  int n_halos;           // H (K10)
  const int32_t* lab;    // [R, W]
  const float* pos;      // [3, R, W]
  const float* vel;      // [3, R, W]
  const int32_t* sv;     // [R, W] (label + 1) | vrb << 28
  const void* rh;        // [3, R, W] f32, or [R, W] u32 octahedral
  const uint32_t* pk;    // [R, W] f32 angle bits 0-30 | matched << 31
  int32_t* osv;
  void* orh;
  uint32_t* opk;
  uint32_t* opay;        // K9: [R, W] payload plane
  uint32_t* oev;         // K8: [R, k128] events
  int32_t* count;        // [R]
  long long n;           // R * W, the plane stride
  int w;
  int k128;
  float hub;
  float box;
  int has_box;
  int pericentric;
};

// The chain for particle i at row position p; writes the carry planes
// (and the payload plane when opay is set) and returns the payload word
// (0 where no apsis fired).  The frame row comes from the rows plane, or
// with kTable from the table.
template <bool kPacked, bool kTable>
__device__ __forceinline__ uint32_t detect_one(const DetectArgs& a, long long i, int p) {
  const long long n = a.n;
  const int32_t lab = a.lab[i];
  float frame[6];
  if (kTable) {
    const bool in_table = lab >= 0 && lab < a.n_halos;
    const float* row = a.table + (in_table ? lab : 0) * 6;
#pragma unroll
    for (int c = 0; c < 6; ++c) frame[c] = in_table ? __ldg(row + c) : 0.0f;
  } else {
#pragma unroll
    for (int c = 0; c < 6; ++c) frame[c] = a.rows[c * n + i];
  }
  float rel[3];
  float r2 = 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float rd = a.pos[d * n + i] - frame[d];
    if (a.has_box) rd = rd - a.box * rintf(rd / a.box);
    rel[d] = rd;
    r2 = r2 + rd * rd;
  }
  const float r = sqrtf(r2);
  const float inv_r = r > 0.0f ? 1.0f / fmaxf(r, 1e-30f) : 0.0f;
  float rh[3];
  float vr = 0.0f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    rh[d] = rel[d] * inv_r;
    vr = vr + rh[d] * ((a.vel[d * n + i] - frame[3 + d]) + a.hub * rel[d]);
  }
  const int32_t vrb = (vr < 0.0f ? 1 : 0) | (vr > 0.0f ? 2 : 0);

  const bool valid = lab >= 0;
  const int32_t sv = a.sv[i];
  const int32_t prev_label = (sv & 0x0FFFFFFF) - 1;
  const int32_t prev_vrb = sv >> 28;
  const uint32_t pk = a.pk[i];
  const bool matched = valid && lab == prev_label && (pk >> 31) != 0u;

  float angle_acc = 0.0f;
  if (matched) {
    float prx, pry, prz;
    if (kPacked) {
      oct_decode(static_cast<const uint32_t*>(a.rh)[i], prx, pry, prz);
    } else {
      const float* prh = static_cast<const float*>(a.rh);
      prx = prh[i];
      pry = prh[n + i];
      prz = prh[2 * n + i];
    }
    float c = prx * rh[0] + pry * rh[1];
    c = c + prz * rh[2];
    c = fminf(fmaxf(c, -1.0f), 1.0f);
    angle_acc = __uint_as_float(pk & 0x7FFFFFFFu) + acos_f32(c);
  }
  const bool flip = a.pericentric ? ((prev_vrb & 1) && (vrb & 2))
                                  : ((prev_vrb & 2) && (vrb & 1));
  const bool apsis = matched && flip;

  a.opk[i] = __float_as_uint((apsis || !valid) ? 0.0f : angle_acc) |
             (valid ? 0x80000000u : 0u);
  a.osv[i] = valid ? ((lab + 1) | (vrb << 28)) : 0;
  if (kPacked) {
    static_cast<uint32_t*>(a.orh)[i] = oct_encode(rh[0], rh[1], rh[2]);
  } else {
    float* orh = static_cast<float*>(a.orh);
    orh[i] = rh[0];
    orh[n + i] = rh[1];
    orh[2 * n + i] = rh[2];
  }
  const uint32_t payload =
      apsis ? ((static_cast<uint32_t>(p + 1) << 15) | (f16_bits_rne(angle_acc) & 0x7FFFu))
            : 0u;
  if (a.opay) a.opay[i] = payload;
  return payload;
}

// K9 and K10: grid (W / 256, R), one particle per thread.
template <bool kPacked, bool kTable>
__global__ void __launch_bounds__(kDetectThreads)
detect_label_kernel(DetectArgs a) {
  __shared__ int block_count;
  const int row = blockIdx.y;
  const int p = blockIdx.x * kDetectThreads + threadIdx.x;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();
  bool apsis = false;
  if (p < a.w) {
    apsis = detect_one<kPacked, kTable>(a, static_cast<long long>(row) * a.w + p, p) != 0u;
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, apsis);
  if ((threadIdx.x & 31) == 0 && ballot) atomicAdd(&block_count, __popc(ballot));
  __syncthreads();
  if (threadIdx.x == 0 && block_count) atomicAdd(a.count + row, block_count);
}

// K8: a tile of kCompactTile positions of one row, in arrival order.
// scratch: the tile counter, then [R, tiles] status words.
template <bool kPacked>
__global__ void __launch_bounds__(kCompactThreads)
detect_label_compact_kernel(DetectArgs a, unsigned long long* scratch, int tiles) {
  __shared__ int slot;
  __shared__ int counts[kCompactVT * (kCompactThreads / 32) + 1];
  const int tile = claim_tile(scratch, &slot);
  const int row = tile / tiles;
  const int t = tile - row * tiles;
  uint32_t w[kCompactVT];
  bool take[kCompactVT];
#pragma unroll
  for (int v = 0; v < kCompactVT; ++v) {
    const int p = t * kCompactTile + v * kCompactThreads + threadIdx.x;
    w[v] = p < a.w ? detect_one<kPacked, false>(a, static_cast<long long>(row) * a.w + p, p)
                   : 0u;
    take[v] = w[v] != 0u;
  }
  int rank[kCompactVT];
  const int total = tile_ranks<kCompactThreads, kCompactVT>(take, rank, counts);
  const int before =
      lookback_prefix(scratch + 1 + static_cast<size_t>(row) * tiles, t, total, &slot);
  uint32_t* o = a.oev + static_cast<size_t>(row) * a.k128;
#pragma unroll
  for (int v = 0; v < kCompactVT; ++v) {
    const int dst = before + rank[v];
    if (take[v] && dst < a.k128) o[dst] = w[v];
  }
  if (t == tiles - 1) finish_row(o, a.k128, before + total, a.count + row);
}

int compact_tiles(int W) { return (W + kCompactTile - 1) / kCompactTile; }

DetectArgs make_args(const void* rows, const void* table, int n_halos,
                     const void* lab, const void* pos,
                     const void* vel, const void* sv, const void* rh,
                     const void* pk, void* osv, void* orh, void* opk,
                     void* opay, void* oev, void* count, int R, int W,
                     int k128, float hub, float box, int has_box,
                     int pericentric) {
  DetectArgs a;
  a.rows = static_cast<const float*>(rows);
  a.table = static_cast<const float*>(table);
  a.n_halos = n_halos;
  a.lab = static_cast<const int32_t*>(lab);
  a.pos = static_cast<const float*>(pos);
  a.vel = static_cast<const float*>(vel);
  a.sv = static_cast<const int32_t*>(sv);
  a.rh = rh;
  a.pk = static_cast<const uint32_t*>(pk);
  a.osv = static_cast<int32_t*>(osv);
  a.orh = orh;
  a.opk = static_cast<uint32_t*>(opk);
  a.opay = static_cast<uint32_t*>(opay);
  a.oev = static_cast<uint32_t*>(oev);
  a.count = static_cast<int32_t*>(count);
  a.n = static_cast<long long>(R) * W;
  a.w = W;
  a.k128 = k128;
  a.hub = hub;
  a.box = box;
  a.has_box = has_box;
  a.pericentric = pericentric;
  return a;
}

}  // namespace

// Entry points: launch on the caller's stream, return cudaGetLastError()
// (0 = launched).  Pointers are device pointers to C-contiguous planes;
// rh / orh are f32 [3, R, W] planes, or u32 [R, W] when packed != 0.

extern "C" int detect_label_rows(const void* rows, const void* lab,
                                 const void* pos, const void* vel,
                                 const void* sv, const void* rh,
                                 const void* pk, void* osv, void* orh,
                                 void* opk, void* opay, void* count, int R,
                                 int W, float hub, float box, int has_box,
                                 int pericentric, int packed, void* stream) {
  if (R > 0 && W > 0) {
    const DetectArgs a = make_args(rows, nullptr, 0, lab, pos, vel, sv, rh,
                                   pk, osv, orh, opk, opay, nullptr, count, R,
                                   W, 0, hub, box, has_box, pericentric);
    const dim3 grid((W + kDetectThreads - 1) / kDetectThreads, R);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (packed) {
      detect_label_kernel<true, false><<<grid, kDetectThreads, 0, s>>>(a);
    } else {
      detect_label_kernel<false, false><<<grid, kDetectThreads, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Scratch words (int64) detect_label_compact_rows needs for R rows of W.
extern "C" long long detect_label_compact_rows_scratch(int R, int W) {
  return lookback_words(R, compact_tiles(W));
}

// K8: zeroes the look-back scratch (scratch_words int64 words, at least
// detect_label_compact_rows_scratch(R, W)) on the stream, then launches.
extern "C" int detect_label_compact_rows(
    const void* rows, const void* lab, const void* pos, const void* vel,
    const void* sv, const void* rh, const void* pk, void* osv, void* orh,
    void* opk, void* oev, void* count, void* scratch, long long scratch_words,
    int R, int W, int k128, float hub, float box, int has_box, int pericentric,
    int packed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = compact_tiles(W);
  const long long words = lookback_words(R, tiles);
  if (scratch_words < words) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const DetectArgs a = make_args(rows, nullptr, 0, lab, pos, vel, sv, rh, pk, osv,
                                 orh, opk, nullptr, oev, count, R, W, k128, hub,
                                 box, has_box, pericentric);
  auto* sc = static_cast<unsigned long long*>(scratch);
  const unsigned grid = static_cast<unsigned>(words - 1);
  if (packed) {
    detect_label_compact_kernel<true><<<grid, kCompactThreads, 0, s>>>(a, sc, tiles);
  } else {
    detect_label_compact_kernel<false><<<grid, kCompactThreads, 0, s>>>(a, sc, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10: table [H, 6] f32, read from global memory; the outputs of
// detect_label_rows, count arriving zeroed.
extern "C" int fused_label_rows(const void* table, const void* lab,
                                const void* pos, const void* vel,
                                const void* sv, const void* rh,
                                const void* pk, void* osv, void* orh,
                                void* opk, void* opay, void* count, int H,
                                int R, int W, float hub, float box,
                                int has_box, int pericentric, int packed,
                                void* stream) {
  if (R > 0 && W > 0) {
    const DetectArgs a = make_args(nullptr, table, H, lab, pos, vel, sv, rh,
                                   pk, osv, orh, opk, opay, nullptr, count, R,
                                   W, 0, hub, box, has_box, pericentric);
    const dim3 grid((W + kDetectThreads - 1) / kDetectThreads, R);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (packed) {
      detect_label_kernel<true, true><<<grid, kDetectThreads, 0, s>>>(a);
    } else {
      detect_label_kernel<false, true><<<grid, kDetectThreads, 0, s>>>(a);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
