// Ordered event compaction for the aligned engine's step, the
// label-native detector's routes and the sorted engine's step,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels of orbitanalysis_tpu/ops/pallas_compact.py:
//   K1  _compact_angle_blocked_kernel  (entry compact_angle_blocked)
//   K2  _compact_angle_kernel          (K1's exact single-stage reroute)
//       -> compact_angle_rows below
//   K3  _compact_payload_pair_kernel   (entry compact_payload_pair)
//       -> compact_pair_rows below
//   K4  _compact_payload_kernel        (entry compact_payload, call :240)
//   K5  _compact_payload_blocked_kernel (entry compact_payload_blocked,
//       call :502, K4's blocked form with a lax.cond reroute to K4)
//       -> compact_payload_rows below
//   K18 _compact_events_kernel         (entry compact_events, call :173)
//       -> compact_events_rows below
//   K19 _compact_kernel                (entry compact_rows, call :137)
//       -> compact_rows_groups below
// Contract (every entry point): each row of an [H, P] uint32 plane is
// compacted, in position order, into the front of an [H, k128] row;
// entries past the row's event count are written as zero.
//   compact_angle_rows: aw = f32_bits(angle) | apsis << 31.  An entry is
//     an event where bit 31 is set; its output word is the positional
//     payload ((pos + 1) << 15) | f16_rne(angle), built here with
//     integer ops that mirror pallas_label.f16_bits_rne bit for bit.
//   compact_pair_rows: posw (pos + 1 where an event fired, else 0) and
//     angw (the f16 angle bits); an entry is an event where posw != 0,
//     and both words move together.
//   compact_payload_rows: prebuilt payload words
//     ((pos + 1) << 15) | f16(angle); an entry is an event where the
//     word is >= 2^15 (a non-event is 0), and it moves unchanged.
//   compact_events_rows (K18, the sorted engine's static-membership
//     branch): packed = f32_bits(angle) | apsis << 31 selects, and the
//     three streams (key, sv, packed) move together.
//   compact_rows_groups (K19, the sorted engine's compact_impl='pallas'):
//     two independent groups over [H, N] rows, each with its own int32
//     0/1 mask, its channel count (1 to 6) and its output length; the
//     entries of both past their counts are zero.
//
// The TPU splits K1/K2 and K4/K5 exist for VMEM and the 16-entry block
// fronts of the blocked network; here each compaction is exact with no
// occupancy limit, so nothing reroutes.  Two designs:
//   one block a row (K3, K18 and K19 through common.cuh's
//     compact_streams_kernel, up to six streams moving together
//     unchanged): 1024 threads walk the row in tiles of 1024 entries.  In
//     a tile, __ballot_sync + __popc give each event its rank inside its
//     warp, warp 0 scans the 32 warp totals in shared memory, and a
//     running base carries the count across tiles.
//   (row, tile) tiles in arrival order (K1/K2, compact_angle_rows, and
//     K4/K5, compact_payload_rows: one kernel, compact_tiles_kernel,
//     whose Words parameter picks the events and builds each output word
//     at its write): a block takes a tile of kTileThreads x kTileVT words
//     of one row through common.cuh's claim_tile, loads them coalesced
//     (word v * kTileThreads + threadIdx.x of the tile is the thread's
//     v-th), keeps them in registers, ranks the events (tile_ranks), gets
//     the count of the row's earlier tiles by the decoupled look-back
//     (lookback_prefix) and writes each event to prefix + rank where that
//     is below k128; the row's last tile (its highest index, which may
//     finish before others of the row: they write below the row's total,
//     it writes at or above) zero-fills [min(n, k128), k128).  Every tile
//     reads its whole tile, also in a row whose k128 outputs are full: it
//     cannot know its prefix before it publishes its own count.

// What bounds K18 and K19 on the H100: bytes.  The selection plane is
// read whole; a payload stream is read only at the selected lanes, so it
// costs the 32-byte sectors that hold one.  K18 at the sorted engine's
// bench shape [64, 32768], K = 2048, on a static step (about 2 % of lanes
// events) reads the 8.4 MB packed plane and a fraction of the key and sv
// sectors, and writes three [64, 2048] planes.  K19 on the unfused route
// (N = 2P = 65536; group a with six channels, len P and about half its
// lanes selected; group b with three, len 2048, about 1 %) reads its two
// masks whole and writes six [64, 32768] and three [64, 2048] planes.
// chip_smoke.py reckons each bound from its run's selection.  Both keep
// the one-block-a-row design above, so K19's six-channel group moves its
// payload with sparse, half-coalesced reads and writes.
//
// What bounds K1-K5 on the H100: bytes.  Each entry is one coalesced u32
// read; the writes are sparse (events are a few percent of entries) and
// the zero fill is k128 words per row.  At the aligned step's shape of
// [64, 32768] the plane is 8 MB, 2.5 us at 3.35 TB/s.  One block a row
// would fill only 64 of 132 SMs, each tile waiting for its load and two
// barriers.  The tiles cut the same shape into 64 x 8 tiles of 4096
// words, one resident wave of 256-thread blocks with sixteen loads in
// flight a thread (the fastest of 256 x 4, 8, 16 and 512 x 8 for K4 and
// of 256 x 8, 16, 32 and 512 x 8 for K1 on the card,
// detect_variants.py); K1's f16 conversion runs only at the events.
// What is left above the floor is the launch, the scratch memset and the
// look-back.
//
// The only float work is one multiply by the exact power of two 2^24,
// so FMA contraction cannot change a result; the build still passes
// --fmad=false.

#include "common.cuh"

namespace {

// K1/K2 and K4/K5: tiles of kTileWords words in arrival order.  Words
// picks the events and builds each one's output word from the input word
// and its position in the row.
constexpr int kTileThreads = 256;
constexpr int kTileVT = 16;  // words a thread
constexpr int kTileWords = kTileThreads * kTileVT;

// K1/K2: an event is a word with bit 31 set; its output word is the
// positional payload ((x + 1) << 15) | f16_rne(angle).
struct AngleWords {
  static __device__ __forceinline__ bool take(uint32_t w) { return (w >> 31) != 0u; }
  static __device__ __forceinline__ uint32_t word(uint32_t w, int x) {
    const float ang = __int_as_float(static_cast<int32_t>(w & 0x7FFFFFFFu));
    return (static_cast<uint32_t>(x + 1) << 15) | (f16_bits_rne(ang) & 0x7FFFu);
  }
};

// K4/K5: an event is a word >= 2^15, moved unchanged.
struct PayloadWords {
  static __device__ __forceinline__ bool take(uint32_t w) {
    return (w & 0xFFFF8000u) != 0u;
  }
  static __device__ __forceinline__ uint32_t word(uint32_t w, int) { return w; }
};

template <typename Words>
__global__ void __launch_bounds__(kTileThreads)
compact_tiles_kernel(const uint32_t* __restrict__ in_rows, uint32_t* __restrict__ out,
                     unsigned long long* scratch, int P, int tiles, int k128) {
  __shared__ int slot;
  __shared__ int counts[kTileVT * (kTileThreads / 32) + 1];
  const int tile = claim_tile(scratch, &slot);
  const int row = tile / tiles;
  const int t = tile - row * tiles;
  const uint32_t* in = in_rows + static_cast<size_t>(row) * P;
  uint32_t w[kTileVT];
  bool take[kTileVT];
#pragma unroll
  for (int v = 0; v < kTileVT; ++v) {
    const int x = t * kTileWords + v * kTileThreads + threadIdx.x;
    w[v] = x < P ? __ldg(in + x) : 0u;
    take[v] = Words::take(w[v]);
  }
  int rank[kTileVT];
  const int total = tile_ranks<kTileThreads, kTileVT>(take, rank, counts);
  const int before =
      lookback_prefix(scratch + 1 + static_cast<size_t>(row) * tiles, t, total, &slot);
  uint32_t* o = out + static_cast<size_t>(row) * k128;
#pragma unroll
  for (int v = 0; v < kTileVT; ++v) {
    const int dst = before + rank[v];
    if (take[v] && dst < k128) {
      o[dst] = Words::word(w[v], t * kTileWords + v * kTileThreads + threadIdx.x);
    }
  }
  if (t == tiles - 1) finish_row(o, k128, before + total, nullptr);
}

int row_tiles(int P) { return (P + kTileWords - 1) / kTileWords; }

// Zeroes the look-back scratch (scratch_words int64 words, at least
// lookback_words(H, row_tiles(P))) on the stream, then launches
// compact_tiles_kernel<Words>.
template <typename Words>
int launch_tiles(const void* in, void* out, void* scratch, long long scratch_words,
                 int H, int P, int k128, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = row_tiles(P);
  const long long words = lookback_words(H, tiles);
  if (scratch_words < words) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  compact_tiles_kernel<Words><<<static_cast<unsigned>(words - 1), kTileThreads, 0, s>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(scratch), P, tiles, k128);
  return static_cast<int>(cudaGetLastError());
}

// One group of common.cuh's multi-stream scan: n uint32 streams of [H, P]
// rows selected where sel & sel_mask != 0, each moved unchanged into the
// front of [H, k128] rows.
int launch_one_group(const void* sel, uint32_t sel_mask, const void* const* in,
                     void* const* out, int n, int H, int P, int k128,
                     void* stream) {
  StreamGroup g{};
  g.sel = static_cast<const uint32_t*>(sel);
  g.sel_mask = sel_mask;
  for (int c = 0; c < n; ++c) {
    g.in[c] = static_cast<const uint32_t*>(in[c]);
    g.out[c] = static_cast<uint32_t*>(out[c]);
    g.out_mask[c] = 0xFFFFFFFFu;
  }
  g.n_streams = n;
  g.len = k128;
  g.count = nullptr;
  return launch_compact_streams(g, nullptr, H, P, static_cast<cudaStream_t>(stream));
}

}  // namespace

// Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers to
// C-contiguous uint32 rows: inputs [H, P], outputs [H, k128].

// Scratch words (int64) compact_angle_rows needs for H rows of P.
extern "C" long long compact_angle_rows_scratch(int H, int P) {
  return lookback_words(H, row_tiles(P));
}

// K1/K2: zeroes the look-back scratch (scratch_words int64 words, at
// least compact_angle_rows_scratch(H, P)) on the stream, then launches.
extern "C" int compact_angle_rows(const void* aw, void* out, void* scratch,
                                  long long scratch_words, int H, int P,
                                  int k128, void* stream) {
  return launch_tiles<AngleWords>(aw, out, scratch, scratch_words, H, P, k128,
                                  stream);
}

extern "C" int compact_pair_rows(const void* posw, const void* angw,
                                 void* out_pos, void* out_ang, int H, int P,
                                 int k128, void* stream) {
  const void* in[2] = {posw, angw};
  void* out[2] = {out_pos, out_ang};
  return launch_one_group(posw, 0xFFFFFFFFu, in, out, 2, H, P, k128, stream);
}

extern "C" int compact_events_rows(const void* packed, const void* key,
                                   const void* sv, void* out_key, void* out_sv,
                                   void* out_packed, int H, int P, int k128,
                                   void* stream) {
  const void* in[3] = {key, sv, packed};
  void* out[3] = {out_key, out_sv, out_packed};
  return launch_one_group(packed, 0x80000000u, in, out, 3, H, P, k128, stream);
}

// in_a / out_a / in_b / out_b: host arrays of n_a / n_b device pointers.
extern "C" int compact_rows_groups(const void* sel_a, const void* const* in_a,
                                   void* const* out_a, int n_a, int len_a,
                                   const void* sel_b, const void* const* in_b,
                                   void* const* out_b, int n_b, int len_b, int H,
                                   int N, void* stream) {
  if (n_a < 1 || n_a > kMaxStreams || n_b < 1 || n_b > kMaxStreams) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  StreamGroup g[2] = {};
  const void* sel[2] = {sel_a, sel_b};
  const void* const* in[2] = {in_a, in_b};
  void* const* out[2] = {out_a, out_b};
  const int n[2] = {n_a, n_b};
  const int len[2] = {len_a, len_b};
  for (int k = 0; k < 2; ++k) {
    g[k].sel = static_cast<const uint32_t*>(sel[k]);
    g[k].sel_mask = 0xFFFFFFFFu;
    for (int c = 0; c < n[k]; ++c) {
      g[k].in[c] = static_cast<const uint32_t*>(in[k][c]);
      g[k].out[c] = static_cast<uint32_t*>(out[k][c]);
      g[k].out_mask[c] = 0xFFFFFFFFu;
    }
    g[k].n_streams = n[k];
    g[k].len = len[k];
    g[k].count = nullptr;
  }
  return launch_compact_streams(g[0], &g[1], H, N, static_cast<cudaStream_t>(stream));
}

// Scratch words (int64) compact_payload_rows needs for H rows of P.
extern "C" long long compact_payload_rows_scratch(int H, int P) {
  return lookback_words(H, row_tiles(P));
}

// K4/K5: zeroes the look-back scratch (scratch_words int64 words, at
// least compact_payload_rows_scratch(H, P)) on the stream, then launches.
extern "C" int compact_payload_rows(const void* pay, void* out, void* scratch,
                                    long long scratch_words, int H, int P,
                                    int k128, void* stream) {
  return launch_tiles<PayloadWords>(pay, out, scratch, scratch_words, H, P, k128,
                                    stream);
}
