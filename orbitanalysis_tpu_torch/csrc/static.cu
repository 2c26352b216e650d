// The aligned detect kernel, hand-written for Hopper (sm_90a); below it,
// the aligned step's fused frame-and-detect pass (aligned_moments,
// aligned_frame_detect), which has a note of its own.
//
// Replaces the TPU kernel:
//   K17 orbitanalysis_tpu/ops/pallas_step.py _static_kernel (call :360,
//       entry fused_static_detect :375) -> static_detect_rows below
//
// Prev and cur planes are aligned: a matched pair sits at the same
// position of both [H, P] rows, so detection is elementwise and there is
// no merge.  Two modes, as on the TPU:
//   native = 1: the aligned engine's carry-native step
//     (make_aligned_native_step(detect_impl='pallas')): FRESH (the
//     position's tenant changed) is bit 27 of the cur sv, and the prev
//     angle plane is the packed carry word (f32 angle bits 0-30, match
//     flag bit 31);
//   native = 0: the legacy select-staged step (make_aligned_orbit_step):
//     FRESH is bit 27 of the prev sv, and the prev angles are float32.
//
// One launch.  A block takes a tile of kTile positions of one row (in
// arrival order, common.cuh claim_tile) and runs _static_kernel's chain
// on each lane, line for line: valid = (ck >> 1) != invalid; the clipped
// cosine ((prx*crx + pry*cry) + prz*crz) and common.cuh's Cephes arccos
// (0 on invalid lanes); the peri/apocentric flip on the sv >> 24 sign
// bits; apsis = valid & flip & ~fresh; angle_acc = fresh ? 0 : pang +
// dtheta.  It writes packed = f32_bits(apsis | ~valid ? 0 : angle_acc) |
// (valid & ~fresh) << 31, keeps each event's (ck, psv, f32 bits of
// angle_acc) in registers, ranks the tile's events and gets the count of
// the row's earlier tiles by common.cuh's decoupled look-back, then
// writes its events to [H, k128] rows in position order; the row's last
// tile writes the exact count (it may exceed k128: no TPU block cap and
// no [8, 128] count tile) and zero-fills the row's tail.  The event's sv
// is the PREV sv, so its low 24 bits are the prev load slot.  Every float
// operation is the plain version's, in its order; the build passes
// --fmad=false and IEEE sqrtf, so kernel and plain version
// (ops/step.py fused_static_detect_torch) agree bit for bit.
//
// What bounds it on the H100: bytes.  At the bench shape [64, 32768] it
// reads 10 planes (84 MB) and writes packed (8.4 MB) and the events:
// 28 us at 3.35 TB/s.  The design reads each input once, in coalesced
// 128-byte warp loads, writes packed coalesced, and keeps no [H, P]
// scratch plane: the events go from registers to their places.  With
// 2048-lane tiles the bench shape is 1024 blocks, not the 64 rows of a
// one-block-a-row scan.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVT = 8;  // lanes a thread
constexpr int kTile = kThreads * kVT;

struct StaticArgs {
  const int32_t* psv;    // [H, P] slot | vrb << 24 (bit 27: FRESH, legacy)
  const float* prx;
  const float* pry;
  const float* prz;
  const uint32_t* pang;  // f32 angle bits (legacy) or the packed carry word
  const uint32_t* ck;    // [H, P] cur keys (id or position) << 1 | 1
  const int32_t* csv;    // slot | vrb << 24 (bit 27: FRESH, native)
  const float* crx;
  const float* cry;
  const float* crz;
  uint32_t* packed;      // [H, P]
  uint32_t* ev_key;      // [H, len]
  uint32_t* ev_sv;
  uint32_t* ev_ang;
  int32_t* count;        // [H]
  unsigned long long* scratch;  // tile counter, then [H, tiles] status
  int P;
  int tiles;             // tiles a row
  int len;               // k128
  uint32_t invalid;      // the padding ID
  int pericentric;
  int native;
};

__global__ void __launch_bounds__(kThreads)
static_detect_kernel(StaticArgs a) {
  __shared__ int slot;
  __shared__ int counts[kVT * kWarps + 1];
  const int tile = claim_tile(a.scratch, &slot);
  const int row = tile / a.tiles;
  const int t = tile - row * a.tiles;
  const size_t base = static_cast<size_t>(row) * a.P;
  bool take[kVT];
  uint32_t key[kVT], sv[kVT], ang[kVT];
#pragma unroll
  for (int v = 0; v < kVT; ++v) {
    const int x = t * kTile + v * kThreads + threadIdx.x;
    take[v] = false;
    if (x < a.P) {
      const size_t i = base + x;
      const uint32_t ck = __ldg(a.ck + i);
      const int32_t psv = __ldg(a.psv + i);
      const bool valid = (ck >> 1) != a.invalid;
      const int vrb_p = psv >> 24;
      const int vrb_c = __ldg(a.csv + i) >> 24;
      const bool fresh = ((a.native ? vrb_c : vrb_p) & 8) != 0;
      const uint32_t pw = __ldg(a.pang + i);
      const float pang = __uint_as_float(a.native ? (pw & 0x7FFFFFFFu) : pw);
      const float prx = __ldg(a.prx + i), pry = __ldg(a.pry + i), prz = __ldg(a.prz + i);
      const float crx = __ldg(a.crx + i), cry = __ldg(a.cry + i), crz = __ldg(a.crz + i);
      float dtheta = 0.0f;
      if (valid) {
        float cs = prx * crx + pry * cry;
        cs = cs + prz * crz;
        dtheta = acos_f32(fminf(fmaxf(cs, -1.0f), 1.0f));
      }
      const bool flip = a.pericentric ? ((vrb_p & 1) && (vrb_c & 2))
                                      : ((vrb_p & 2) && (vrb_c & 1));
      const bool apsis = valid && flip && !fresh;
      const float angle_acc = fresh ? 0.0f : pang + dtheta;
      a.packed[i] = __float_as_uint((apsis || !valid) ? 0.0f : angle_acc) |
                    ((valid && !fresh) ? 0x80000000u : 0u);
      take[v] = apsis;
      key[v] = ck;
      sv[v] = static_cast<uint32_t>(psv);
      ang[v] = __float_as_uint(angle_acc);
    }
  }
  int rank[kVT];
  const int total = tile_ranks<kThreads, kVT>(take, rank, counts);
  const int before =
      lookback_prefix(a.scratch + 1 + static_cast<size_t>(row) * a.tiles, t, total, &slot);
  const size_t out = static_cast<size_t>(row) * a.len;
#pragma unroll
  for (int v = 0; v < kVT; ++v) {
    const int o = before + rank[v];
    if (take[v] && o < a.len) {
      a.ev_key[out + o] = key[v];
      a.ev_sv[out + o] = sv[v];
      a.ev_ang[out + o] = ang[v];
    }
  }
  if (t == a.tiles - 1) {
    finish_row(a.ev_key + out, a.ev_sv + out, a.ev_ang + out, a.len, before + total,
               a.count + row);
  }
}

int tiles_a_row(int P) { return (P + kTile - 1) / kTile; }

}  // namespace

// Scratch words (int64) static_detect_rows needs for H rows of P.
extern "C" long long static_detect_rows_scratch(int H, int P) {
  return lookback_words(H, tiles_a_row(P));
}

// Entry point: zeroes the scratch and launches on the caller's stream,
// returns the first CUDA error (0 = launched).  Pointers are device
// pointers to C-contiguous [H, P] planes of 32-bit words.  Outputs:
// packed [H, P], ev_key / ev_sv / ev_ang [H, k128] (zero past each row's
// count; ev_ang holds the f32 angle bits), count [H] (exact, may exceed
// k128).  scratch: scratch_words int64 words, at least
// static_detect_rows_scratch(H, P).
extern "C" int static_detect_rows(
    const void* psv, const void* prx, const void* pry, const void* prz,
    const void* pang, const void* ck, const void* csv, const void* crx,
    const void* cry, const void* crz, void* packed, void* ev_key,
    void* ev_sv, void* ev_ang, void* count, void* scratch,
    long long scratch_words, int H, int P, int k128, int invalid,
    int pericentric, int native, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = tiles_a_row(P);
  const long long words = lookback_words(H, tiles);
  if (scratch_words < words) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  StaticArgs a;
  a.psv = static_cast<const int32_t*>(psv);
  a.prx = static_cast<const float*>(prx);
  a.pry = static_cast<const float*>(pry);
  a.prz = static_cast<const float*>(prz);
  a.pang = static_cast<const uint32_t*>(pang);
  a.ck = static_cast<const uint32_t*>(ck);
  a.csv = static_cast<const int32_t*>(csv);
  a.crx = static_cast<const float*>(crx);
  a.cry = static_cast<const float*>(cry);
  a.crz = static_cast<const float*>(crz);
  a.packed = static_cast<uint32_t*>(packed);
  a.ev_key = static_cast<uint32_t*>(ev_key);
  a.ev_sv = static_cast<uint32_t*>(ev_sv);
  a.ev_ang = static_cast<uint32_t*>(ev_ang);
  a.count = static_cast<int32_t*>(count);
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.P = P;
  a.tiles = tiles;
  a.len = k128;
  a.invalid = static_cast<uint32_t>(invalid);
  a.pericentric = pericentric;
  a.native = native;
  static_detect_kernel<<<static_cast<unsigned>(words - 1), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// The aligned step's frame-and-detect chain, hand-written for Hopper
// (sm_90a): aligned_moments and aligned_frame_detect below.
//
// Replaces no TPU kernel.  On the TPU this chain is XLA's fusion of
// orbitanalysis_tpu/ops/geometry.py region_frame and
// orbitanalysis_tpu/ops/sorted_step.py aligned_detect_math (the aligned
// step's default 'xla' route); the port ran it as ~170 eager PyTorch
// launches a step, most of them float64 casts of div_rn / sqrt_rn.  It
// feeds K1 (compact.cu compact_angle_rows), which stays its own launch.
//
// aligned_moments (only when the step has no catalog bulk velocity): one
// block a (row, tile of kMomTile slots) writes the float64 partials
// [sum w m vx, sum w m vy, sum w m vz, sum w m] of its tile, w = (id !=
// invalid), m = 1 without masses; each product w m v is float32, as the
// plain version's.  Each thread adds its lanes in a fixed order, a warp
// by a fixed xor-butterfly, the block its warps in order: no float
// atomics, so the bits repeat from run to run.
//
// aligned_frame_detect: one block a (row, tile of kFrameTile slots).
// The block's first threads make the row's frame: the centre, and the
// bulk velocity, either the catalog's or the row's moment partials
// summed in tile order in float64, each sum rounded to float32 and
// divided as region_frame divides (sum(w m v) / max(sum(w m), 1e-30)).
// Then each lane runs the plain chain (ops/sorted_step.py
// aligned_chain_torch) operation for operation: the minimum-image wrap
// (rintf(rel / box), a scalar or per-axis box), the padding mask, v_rel
// with the Hubble term, r = sqrtf((x*x + y*y) + z*z), r-hat = rel * (1 /
// max(r, 1e-30)), v_r = (((.)+(.))+(.)) * w and its sign bits, the
// positional key, the FRESH gate (bit 27 of the staged slot), common.cuh's
// Cephes arccos of the clipped cosine against the carried r-hat
// (octahedral-decoded with kOct), the peri/apocentric flip, the angle
// accumulator, the packed carry word, and K1's angle word f32_bits(angle)
// | apsis << 31, or past PAYLOAD_MAX_ROW the pair (apsis ? position + 1 :
// 0, f16_rne(angle)) of K3.  The new r-hat is written as three planes or
// one octahedral word (kOct).  count[row] gets the block's apsides by one
// integer atomicAdd, which is exact in any order; the entry point zeroes
// it first.  Both [H, P, 3] (the tracker) and [3, H, P] (kSoA, the
// scan's soa_batch) position and velocity layouts are read.
//
// Exactness: --fmad=false keeps every a*b+c two rounded operations;
// sqrtf and '/' are the IEEE ones, which is what the plain version's
// float64 detours (utils/numerics sqrt_rn, div_rn) give; rintf is
// torch.round (half to even); the clamps keep torch.clamp's NaN.  So, fed
// the same bulk velocity, key, sv, r-hat, packed, the angle word (or the
// pair) and count are the plain chain's bits.  The bulk velocity itself
// differs from torch.sum's by the order of summation: its float64 sums
// put it within 2 float32 ulps of the exact quotient, where torch's
// float32 sums of config 2's near-zero bulk velocities stray by
// thousands; it feeds only v_r and the returned bulk velocity.
//
// What bounds it on the H100: bytes.  The pass reads ID, slot, position,
// velocity, and the carry's sv, r-hat and packed word (52 B a slot) and
// writes key, sv, r-hat, packed and the angle word (28 B): 80 B a slot,
// config 2's [100, 16384] is 131 MB, 39 us at 3.35 TB/s; the moments read
// 16 B a slot more (20 with masses).  Design: every plane is read once
// and written once, coalesced (the [H, P, 3] planes a warp's 384
// contiguous bytes at a time, through L1); nothing of the chain goes to
// device memory between operations; each thread loads all four of its
// slots' inputs before it computes or stores any, so a block has every
// load in flight at once; inputs are read and the carry written with
// streaming (evict-first) hints, so the angle words stay in L2 for K1;
// 1024-slot tiles give config 2 1600 blocks of 256 threads.

namespace {

constexpr int kMomThreads = 256;
constexpr int kMomVT = 16;  // slots a thread
constexpr int kMomTile = kMomThreads * kMomVT;
constexpr int kFrameThreads = 256;
constexpr int kFrameVT = 4;  // slots a thread
constexpr int kFrameTile = kFrameThreads * kFrameVT;

int moment_tiles(int P) { return (P + kMomTile - 1) / kMomTile; }

// Component d of slot i of an [H, P, 3] plane, or of a [3, H, P] plane
// (kSoA) of n = H * P slots.
template <bool kSoA>
__device__ __forceinline__ float component(const float* x, long long i, long long n, int d) {
  return kSoA ? __ldg(x + d * n + i) : __ldg(x + i * 3 + d);
}

// torch.clamp's min and max: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float clamp_unit(float x) {
  return x < -1.0f ? -1.0f : (x > 1.0f ? 1.0f : x);
}

template <bool kSoA>
__global__ void __launch_bounds__(kMomThreads)
aligned_moments_kernel(const int32_t* __restrict__ ids, const float* __restrict__ vel,
                       const float* __restrict__ mass, double* __restrict__ partial, int P,
                       int tiles, long long n, int32_t invalid) {
  __shared__ double warp_sums[kMomThreads / 32][4];
  const int row = blockIdx.x / tiles;
  const int t = blockIdx.x - row * tiles;
  const long long base = static_cast<long long>(row) * P;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
  for (int v = 0; v < kMomVT; ++v) {
    const int x = t * kMomTile + v * kMomThreads + threadIdx.x;
    if (x < P) {
      const long long i = base + x;
      const float w = __ldg(ids + i) != invalid ? 1.0f : 0.0f;
      const float wm = mass ? w * __ldg(mass + i) : w;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        acc[d] += static_cast<double>(wm * component<kSoA>(vel, i, n, d));
      }
      acc[3] += static_cast<double>(wm);
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    double s = acc[c];
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) s += __shfl_xor_sync(0xffffffffu, s, d);
    if (lane == 0) warp_sums[warp][c] = s;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kMomThreads / 32; ++w) s += warp_sums[w][threadIdx.x];
    partial[static_cast<size_t>(blockIdx.x) * 4 + threadIdx.x] = s;
  }
}

struct FrameArgs {
  const int32_t* ids;      // [H, P]
  const int32_t* slot;     // [H, P] load slot | FRESH << 27
  const float* pos;        // [H, P, 3] or [3, H, P] (kSoA)
  const float* vel;
  const float* center;     // [H, 3]
  const float* bulk_in;    // [H, 3] catalog bulk velocities, or null
  const double* partial;   // [H, mtiles, 4] aligned_moments' partials, or null
  const int32_t* psv;      // the carry: [H, P] sv
  const void* prhat;       // [3, H, P] f32, or [H, P] octahedral words (kOct)
  const uint32_t* ppacked; // [H, P] f32 angle bits 0-30 | match << 31
  int32_t* key;            // the new carry's planes
  int32_t* sv;
  void* rhat;
  uint32_t* packed;
  uint32_t* words;         // [H, P] K1's angle words, or K3's position words (pair)
  int32_t* ang16;          // [H, P] f16 angle bits (pair only)
  float* bulk_out;         // [H, 3] bulk velocities (with partial)
  int32_t* count;          // [H] apsides, zeroed before the launch
  long long n;             // H * P
  int P;
  int tiles;               // tiles a row
  int mtiles;              // moment tiles a row
  int32_t invalid;         // the padding ID
  int32_t invalid_key;     // (uint32(invalid) << 1) | 1 as int32
  float hub;
  float box[3];
  int has_box;
  int pericentric;
  int pair;
};

// One slot's inputs to the pass.
struct SlotIn {
  int32_t id, slot, psv;
  uint32_t pk;     // the carry's packed word
  uint32_t oct;    // the carry's octahedral r-hat word (kOct)
  float pos[3], vel[3];
  float prh[3];    // the carry's r-hat (not kOct)
};

// Every input is read for the last time in the step: streaming loads
// (evict first), so L2 keeps the angle words for K1 instead.
template <bool kSoA>
__device__ __forceinline__ float component_last(const float* x, long long i, long long n,
                                                int d) {
  return kSoA ? __ldcs(x + d * n + i) : __ldcs(x + i * 3 + d);
}

template <bool kSoA, bool kOct>
__device__ __forceinline__ SlotIn load_slot(const FrameArgs& a, long long i) {
  SlotIn q;
  q.id = __ldcs(a.ids + i);
  q.slot = __ldcs(a.slot + i);
  q.psv = __ldcs(a.psv + i);
  q.pk = __ldcs(a.ppacked + i);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    q.pos[d] = component_last<kSoA>(a.pos, i, a.n, d);
    q.vel[d] = component_last<kSoA>(a.vel, i, a.n, d);
  }
  if (kOct) {
    q.oct = __ldcs(static_cast<const uint32_t*>(a.prhat) + i);
  } else {
    const float* prh = static_cast<const float*>(a.prhat);
#pragma unroll
    for (int d = 0; d < 3; ++d) q.prh[d] = __ldcs(prh + d * a.n + i);
  }
  return q;
}

template <bool kSoA, bool kOct>
__global__ void __launch_bounds__(kFrameThreads)
aligned_frame_detect_kernel(FrameArgs a) {
  __shared__ float frame[6];  // centre xyz, bulk velocity xyz
  __shared__ int warp_events[kFrameThreads / 32];
  const int row = blockIdx.x / a.tiles;
  const int t = blockIdx.x - row * a.tiles;
  if (threadIdx.x < 3) {
    const int c = threadIdx.x;
    float b;
    if (a.partial != nullptr) {
      const double* pr = a.partial + static_cast<size_t>(row) * a.mtiles * 4;
      double s = 0.0, sw = 0.0;
      for (int k = 0; k < a.mtiles; ++k) {
        s += pr[k * 4 + c];
        sw += pr[k * 4 + 3];
      }
      b = static_cast<float>(s) / clamp_min(static_cast<float>(sw), 1e-30f);
      if (t == 0) a.bulk_out[row * 3 + c] = b;
    } else {
      b = a.bulk_in[row * 3 + c];
    }
    frame[c] = a.center[row * 3 + c];
    frame[3 + c] = b;
  }
  __syncthreads();
  const long long base = static_cast<long long>(row) * a.P;
  // every lane's inputs first: the loads of all kFrameVT lanes are in
  // flight together, ahead of the first store
  SlotIn in[kFrameVT];
#pragma unroll
  for (int v = 0; v < kFrameVT; ++v) {
    const int x = t * kFrameTile + v * kFrameThreads + threadIdx.x;
    if (x < a.P) in[v] = load_slot<kSoA, kOct>(a, base + x);
  }
  int events = 0;
#pragma unroll
  for (int v = 0; v < kFrameVT; ++v) {
    const int x = t * kFrameTile + v * kFrameThreads + threadIdx.x;
    if (x >= a.P) continue;
    const long long i = base + x;
    const SlotIn& q = in[v];
    // region_frame
    const bool valid = q.id != a.invalid;
    const float w = valid ? 1.0f : 0.0f;
    float rel[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      float r = q.pos[d] - frame[d];
      if (a.has_box) r = r - a.box[d] * rintf(r / a.box[d]);
      rel[d] = r * w;
    }
    float vrel[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) vrel[d] = (q.vel[d] - frame[3 + d]) + a.hub * rel[d];
    const float r2 = (rel[0] * rel[0] + rel[1] * rel[1]) + rel[2] * rel[2];
    const float radius = sqrtf(r2);
    const float inv_r = radius > 0.0f ? 1.0f / clamp_min(radius, 1e-30f) : 0.0f;
    float rh[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) rh[d] = rel[d] * inv_r;
    const float vrad = ((vrel[0] * rh[0] + vrel[1] * rh[1]) + vrel[2] * rh[2]) * w;
    // aligned_detect_math
    const int32_t vrb = (vrad < 0.0f ? 1 : 0) | (vrad > 0.0f ? 2 : 0);
    const bool fresh = (q.slot & (1 << 27)) != 0;
    const int32_t vrb_p = (q.psv >> 24) & 0xF;
    const float pang = __uint_as_float(q.pk & 0x7FFFFFFFu);
    float pr[3];
    if (kOct) {
      oct_decode(q.oct, pr[0], pr[1], pr[2]);
    } else {
#pragma unroll
      for (int d = 0; d < 3; ++d) pr[d] = q.prh[d];
    }
    const float cosang = clamp_unit((pr[0] * rh[0] + pr[1] * rh[1]) + pr[2] * rh[2]);
    const float dtheta = valid ? acos_f32(cosang) : 0.0f;
    const bool flip = a.pericentric ? ((vrb_p & 1) && (vrb & 2)) : ((vrb_p & 2) && (vrb & 1));
    const bool apsis = valid && flip && !fresh;
    const float angle_acc = fresh ? 0.0f : pang + dtheta;
    // the carry is read again only next step: streaming stores; the
    // compaction's input words next, in this step: plain stores
    __stcs(a.key + i, valid ? ((x << 1) | 1) : a.invalid_key);
    __stcs(a.sv + i, q.slot | (vrb << 24));
    __stcs(a.packed + i, __float_as_uint((apsis || !valid) ? 0.0f : angle_acc) |
                             ((valid && !fresh) ? 0x80000000u : 0u));
    if (a.pair) {
      a.words[i] = apsis ? static_cast<uint32_t>(x + 1) : 0u;
      a.ang16[i] = static_cast<int32_t>(f16_bits_rne(angle_acc));
    } else {
      a.words[i] = __float_as_uint(angle_acc) | (apsis ? 0x80000000u : 0u);
    }
    if (kOct) {
      __stcs(static_cast<uint32_t*>(a.rhat) + i, oct_encode(rh[0], rh[1], rh[2]));
    } else {
      float* orh = static_cast<float*>(a.rhat);
#pragma unroll
      for (int d = 0; d < 3; ++d) __stcs(orh + d * a.n + i, rh[d]);
    }
    events += apsis ? 1 : 0;
  }
  events = __reduce_add_sync(0xffffffffu, events);
  if ((threadIdx.x & 31) == 0) warp_events[threadIdx.x >> 5] = events;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kFrameThreads / 32; ++w) total += warp_events[w];
    if (total > 0) atomicAdd(a.count + row, total);
  }
}

template <bool kSoA, bool kOct>
void launch_frame(const FrameArgs& a, unsigned blocks, cudaStream_t s) {
  aligned_frame_detect_kernel<kSoA, kOct><<<blocks, kFrameThreads, 0, s>>>(a);
}

}  // namespace

// Moment tiles a row of P slots: aligned_moments writes [H, tiles, 4]
// float64 partials.
extern "C" int aligned_moments_tiles(int P) { return moment_tiles(P); }

// Entry point: the moment partials of the aligned step's rows, on the
// caller's stream; returns the first CUDA error (0 = launched).  ids
// [H, P] int32; vel [H, P, 3] or [3, H, P] (soa) float32; mass [H, P]
// float32 or null; partial [H, aligned_moments_tiles(P), 4] float64.
extern "C" int aligned_moments(const void* ids, const void* vel, const void* mass,
                               void* partial, int H, int P, int invalid, int soa,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = moment_tiles(P);
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(H) * tiles);
  const long long n = static_cast<long long>(H) * P;
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* v = static_cast<const float*>(vel);
  const auto* m = static_cast<const float*>(mass);
  auto* out = static_cast<double*>(partial);
  if (soa) {
    aligned_moments_kernel<true><<<blocks, kMomThreads, 0, s>>>(i, v, m, out, P, tiles, n, invalid);
  } else {
    aligned_moments_kernel<false><<<blocks, kMomThreads, 0, s>>>(i, v, m, out, P, tiles, n, invalid);
  }
  return static_cast<int>(cudaGetLastError());
}

// Entry point: the aligned step's fused frame-and-detect pass, on the
// caller's stream; returns the first CUDA error (0 = launched).  Pointers
// are device pointers to C-contiguous arrays, as FrameArgs lists them;
// bulk_in or partial (with bulk_out) gives the bulk velocity, hub the
// Hubble term, box (with has_box) the periodic box an axis.
// count is zeroed here before the launch.
extern "C" int aligned_frame_detect(
    const void* ids, const void* slot, const void* pos, const void* vel,
    const void* center, const void* bulk_in, const void* partial,
    const void* psv, const void* prhat, const void* ppacked, void* key, void* sv,
    void* rhat, void* packed, void* words, void* ang16, void* bulk_out, void* count,
    int H, int P, int invalid, int invalid_key, float hub, float box_x, float box_y,
    float box_z, int has_box, int pericentric, int soa, int oct, int pair,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t rc = cudaMemsetAsync(count, 0, static_cast<size_t>(H) * sizeof(int32_t), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  FrameArgs a;
  a.ids = static_cast<const int32_t*>(ids);
  a.slot = static_cast<const int32_t*>(slot);
  a.pos = static_cast<const float*>(pos);
  a.vel = static_cast<const float*>(vel);
  a.center = static_cast<const float*>(center);
  a.bulk_in = static_cast<const float*>(bulk_in);
  a.partial = static_cast<const double*>(partial);
  a.psv = static_cast<const int32_t*>(psv);
  a.prhat = prhat;
  a.ppacked = static_cast<const uint32_t*>(ppacked);
  a.key = static_cast<int32_t*>(key);
  a.sv = static_cast<int32_t*>(sv);
  a.rhat = rhat;
  a.packed = static_cast<uint32_t*>(packed);
  a.words = static_cast<uint32_t*>(words);
  a.ang16 = static_cast<int32_t*>(ang16);
  a.bulk_out = static_cast<float*>(bulk_out);
  a.count = static_cast<int32_t*>(count);
  a.n = static_cast<long long>(H) * P;
  a.P = P;
  a.tiles = (P + kFrameTile - 1) / kFrameTile;
  a.mtiles = moment_tiles(P);
  a.invalid = invalid;
  a.invalid_key = invalid_key;
  a.hub = hub;
  a.box[0] = box_x;
  a.box[1] = box_y;
  a.box[2] = box_z;
  a.has_box = has_box;
  a.pericentric = pericentric;
  a.pair = pair;
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(H) * a.tiles);
  if (soa) {
    if (oct) launch_frame<true, true>(a, blocks, s);
    else launch_frame<true, false>(a, blocks, s);
  } else {
    if (oct) launch_frame<false, true>(a, blocks, s);
    else launch_frame<false, false>(a, blocks, s);
  }
  return static_cast<int>(cudaGetLastError());
}
