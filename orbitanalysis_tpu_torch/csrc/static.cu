// The aligned detect kernel, hand-written for Hopper (sm_90a).
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
