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
//     branch): packed = f32_bits(angle) | apsis << 31 selects where bit
//     31 is set, and the three words (key, sv, packed) of each event's
//     lane move together unchanged.
//   compact_rows_groups (K19, the sorted engine's compact_impl='pallas'):
//     two independent groups over [H, N] rows, each with its own int32
//     0/1 mask, its channel count (1 to 6) and its output length; the
//     entries of both past their counts are zero.
//
// The TPU splits K1/K2 and K4/K5 exist for VMEM and the 16-entry block
// fronts of the blocked network; here each compaction is exact with no
// occupancy limit, so nothing reroutes.  Two designs:
//   (row, tile) tiles in arrival order (K1/K2, compact_angle_rows, K3,
//     compact_pair_rows, K4/K5, compact_payload_rows, and K18,
//     compact_events_rows: one kernel, compact_tiles_kernel, whose Words
//     parameter picks the events, builds each output word at its write,
//     sets the tile's words a thread and names the side planes (none
//     for K1 and K4; K3's angle word; K18's key and sv) whose word at
//     each event's lane moves with it, read only there and before the
//     scan's barriers): a block takes a tile of kTileThreads x
//     Words::kVT words of one row through common.cuh's claim_tile,
//     loads them coalesced (word v * kTileThreads + threadIdx.x of the
//     tile is the thread's v-th), keeps them in registers, ranks the
//     events (tile_ranks), gets the count of the row's earlier tiles by
//     the decoupled look-back (lookback_prefix) and writes each event
//     to prefix + rank where that is below k128; the row's last tile
//     (its highest index, which may finish before others of the row:
//     they write below the row's total, it writes at or above)
//     zero-fills [min(n, k128), k128) of every output plane.  Every
//     tile reads its whole tile, also in a row whose k128 outputs are
//     full: it cannot know its prefix before it publishes its own
//     count.
//   (row, tile) tiles in arrival order covering both groups (K19,
//     compact_rows_groups): as above, with a status array a group and
//     the two look-backs run at once by two warps.  A tile's channels
//     reach shared memory by cp.async and each group's output range is
//     written coalesced (below).

// What bounds K18 and K19 on the H100: bytes.  The selection plane is
// read whole; a payload stream is read only at the selected lanes, so it
// costs the 32-byte sectors that hold one.  K18 at the sorted engine's
// bench shape [64, 32768], K = 2048, on a static step (about 2 % of lanes
// events) reads the 8.4 MB packed plane and a fraction of the key and sv
// sectors, and writes three [64, 2048] planes.  K19 on the unfused route
// (N = 2P = 65536; group a with six channels, len P and exactly half
// its lanes selected; group b with three, len 2048, about 1 %) reads its
// two masks whole and writes six [64, 32768] and three [64, 2048]
// planes.  chip_smoke.py reckons each bound from its run's selection.
// At half the lanes selected nearly every 32-byte sector of group a's
// channels holds a selected lane, so K19 reads them whole, 16 bytes a
// copy: what a lane-by-lane read would cost in sectors, and all of a
// tile's loads in flight at once.  Moving them through registers one
// channel at a time (the first build) left one load latency a channel
// per tile: 0.1165 ms against the 0.1293 of one block a row.  Tiles of
// one group each (the second build) left group b's 4096 light tiles, a
// chain of dependent latencies each, as a tail after group a's: 0.0328
// ms of group b alone, 0.0787 of group a alone, 0.1099 together
// (detect_variants.py); a tile now covers both groups.  What is left
// above the bound is each tile's chain of latencies (claim, mask loads,
// scans, look-back, writes), about 7 us as in K4's single wave, times
// the waves of tiles: 2048-entry tiles at four blocks an SM (64
// registers, 53 KB of shared memory) beat 1024-entry tiles at five or
// six, and 4096-entry tiles at two (0.0885, 0.0935 and 0.0956 ms on
// phase 3's six-channel input).
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
// K3 takes the same tiles (of 256 x 8, 16 and 32 words, 16 was the
// fastest at [4, 262144] and at one halo of [1, 1 << 19]): the aligned
// engine's wide rows come one to four a step, and one block a row kept
// one to four SMs busy.  K18 takes them too, at 256 x 8 words: one block
// a row left 64 of 132 SMs busy at [64, 32768], each tile waiting for
// its load and two barriers.  Its key and sv words are a second round
// of loads, issued at the events before the scan's barriers; at 16 words
// they hold 99 registers a thread (two blocks an SM), at 8 words 60
// (four), and 256 x 8 was the fastest of 256 x 8, 16 and 32 on phase 3's
// static step (detect_variants.py).  What is left above the floor is
// the launch, the scratch memset, the look-back and, for K18, the
// second round of loads.
//
// The only float work is one multiply by the exact power of two 2^24,
// so FMA contraction cannot change a result; the build still passes
// --fmad=false.

#include "common.cuh"

namespace {

// K1/K2, K3, K4/K5 and K18: tiles of kTileThreads x Words::kVT words in
// arrival order.  Words picks the events and builds each one's output
// word from the input word and its position in the row; the words of
// Words::kSides side planes at each event's lane (read only there) move
// with it.
constexpr int kTileThreads = 256;
constexpr int kTileVT = 16;  // words a thread (K1/K2, K3, K4/K5)
constexpr int kEventVT = 8;   // words a thread (K18)
constexpr int kMaxSides = 2;

// The side planes of a launch: [H, P] inputs, [H, k128] outputs.
struct SidePlanes {
  const uint32_t* in[kMaxSides];
  uint32_t* out[kMaxSides];
};

// K1/K2: an event is a word with bit 31 set; its output word is the
// positional payload ((x + 1) << 15) | f16_rne(angle).
struct AngleWords {
  static constexpr int kSides = 0;
  static constexpr int kVT = kTileVT;
  static __device__ __forceinline__ bool take(uint32_t w) { return (w >> 31) != 0u; }
  static __device__ __forceinline__ uint32_t word(uint32_t w, int x) {
    const float ang = __int_as_float(static_cast<int32_t>(w & 0x7FFFFFFFu));
    return (static_cast<uint32_t>(x + 1) << 15) | (f16_bits_rne(ang) & 0x7FFFu);
  }
};

// K4/K5: an event is a word >= 2^15, moved unchanged.
struct PayloadWords {
  static constexpr int kSides = 0;
  static constexpr int kVT = kTileVT;
  static __device__ __forceinline__ bool take(uint32_t w) {
    return (w & 0xFFFF8000u) != 0u;
  }
  static __device__ __forceinline__ uint32_t word(uint32_t w, int) { return w; }
};

// K3: an event is a nonzero position word, moved unchanged; the angle
// word of its lane moves with it.
struct PairWords {
  static constexpr int kSides = 1;
  static constexpr int kVT = kTileVT;
  static __device__ __forceinline__ bool take(uint32_t w) { return w != 0u; }
  static __device__ __forceinline__ uint32_t word(uint32_t w, int) { return w; }
};

// K18: an event is a packed word with bit 31 set, moved unchanged; the
// key and sv words of its lane move with it.
struct EventWords {
  static constexpr int kSides = 2;
  static constexpr int kVT = kEventVT;
  static __device__ __forceinline__ bool take(uint32_t w) { return (w >> 31) != 0u; }
  static __device__ __forceinline__ uint32_t word(uint32_t w, int) { return w; }
};

template <typename Words>
__global__ void __launch_bounds__(kTileThreads)
compact_tiles_kernel(const uint32_t* __restrict__ in_rows, uint32_t* __restrict__ out,
                     SidePlanes sides, unsigned long long* scratch, int P, int tiles,
                     int k128) {
  constexpr int kVT = Words::kVT;
  constexpr int kWords = kTileThreads * kVT;
  constexpr int kSides = Words::kSides;
  static_assert(kSides <= kMaxSides, "too many side planes");
  __shared__ int slot;
  __shared__ int counts[kVT * (kTileThreads / 32) + 1];
  const int tile = claim_tile(scratch, &slot);
  const int row = tile / tiles;
  const int t = tile - row * tiles;
  const size_t base = static_cast<size_t>(row) * P;
  uint32_t w[kVT];
  bool take[kVT];
#pragma unroll
  for (int v = 0; v < kVT; ++v) {
    const int x = t * kWords + v * kTileThreads + threadIdx.x;
    w[v] = x < P ? __ldg(in_rows + base + x) : 0u;
    take[v] = Words::take(w[v]);
  }
  // the side words at the events, loaded before the scan's barriers
  uint32_t side[kSides > 0 ? kSides : 1][kVT];
#pragma unroll
  for (int c = 0; c < kSides; ++c) {
#pragma unroll
    for (int v = 0; v < kVT; ++v) {
      const int x = t * kWords + v * kTileThreads + threadIdx.x;
      side[c][v] = take[v] ? __ldg(sides.in[c] + base + x) : 0u;
    }
  }
  int rank[kVT];
  const int total = tile_ranks<kTileThreads, kVT>(take, rank, counts);
  const int before =
      lookback_prefix(scratch + 1 + static_cast<size_t>(row) * tiles, t, total, &slot);
  const size_t out_row = static_cast<size_t>(row) * k128;
  uint32_t* o = out + out_row;
#pragma unroll
  for (int v = 0; v < kVT; ++v) {
    const int dst = before + rank[v];
    if (take[v] && dst < k128) {
      o[dst] = Words::word(w[v], t * kWords + v * kTileThreads + threadIdx.x);
#pragma unroll
      for (int c = 0; c < kSides; ++c) sides.out[c][out_row + dst] = side[c][v];
    }
  }
  if (t == tiles - 1) {
    finish_row(o, k128, before + total, nullptr);
#pragma unroll
    for (int c = 0; c < kSides; ++c) {
      finish_row(sides.out[c] + out_row, k128, before + total, nullptr);
    }
  }
}

template <typename Words>
int row_tiles(int P) {
  constexpr int kWords = kTileThreads * Words::kVT;
  return (P + kWords - 1) / kWords;
}

// Scratch words (int64) a launch of compact_tiles_kernel<Words> over H
// rows of P needs.
template <typename Words>
long long tiles_scratch(int H, int P) {
  return lookback_words(H, row_tiles<Words>(P));
}

// Zeroes the look-back scratch (scratch_words int64 words, at least
// tiles_scratch<Words>(H, P)) on the stream, then launches
// compact_tiles_kernel<Words> (side_in / side_out: the Words::kSides
// side planes).
template <typename Words>
int launch_tiles(const void* in, void* out, const void* const* side_in,
                 void* const* side_out, void* scratch, long long scratch_words, int H,
                 int P, int k128, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = row_tiles<Words>(P);
  const long long words = lookback_words(H, tiles);
  if (scratch_words < words) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  SidePlanes sides{};
  for (int c = 0; c < Words::kSides; ++c) {
    sides.in[c] = static_cast<const uint32_t*>(side_in[c]);
    sides.out[c] = static_cast<uint32_t*>(side_out[c]);
  }
  compact_tiles_kernel<Words><<<static_cast<unsigned>(words - 1), kTileThreads, 0, s>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), sides,
      static_cast<unsigned long long*>(scratch), P, tiles, k128);
  return static_cast<int>(cudaGetLastError());
}

// K19: tiles of kGroupTile entries of one row in arrival order, each
// tile covering that range of both groups, with a status array a group.
// Both masks are read whole into registers.  Group a's channels (dense)
// are copied whole to shared memory by cp.async, 16 bytes a copy; group
// b's (sparse) at its selected lanes, 4 bytes a copy, to a small
// per-warp area at each entry's rank in its warp (up to kGroupBCap
// entries a warp; a warp's further entries are read after the scan).
// All of it is issued before the scans' barriers and holds no register.
// Warps 0 and 1 run the two groups' look-backs at the same time.  Group
// a's contiguous output range is then written coalesced, channel by
// channel, each word gathered from the staged tile through the entry
// index of its rank (src); group b's entries are written at their ranks.
constexpr int kGroupThreads = 256;
constexpr int kGroupVT = 8;      // entries a thread
constexpr int kGroupBlocks = 4;  // resident blocks an SM: 64 registers a thread
constexpr int kGroupTile = kGroupThreads * kGroupVT;
constexpr int kGroupWarps = kGroupThreads / 32;
constexpr int kGroupBCap = 8;  // group b entries a warp stages
// dynamic shared memory a block takes at the most (six channels a group)
constexpr int kGroupSmemMax =
    (kMaxStreams * kGroupTile + kGroupWarps * kMaxStreams * kGroupBCap) * 4;

struct GroupArgs {
  const uint32_t* sel[2];               // [H, N] 0/1 masks
  const uint32_t* in[2][kMaxStreams];   // [H, N] channels
  uint32_t* out[2][kMaxStreams];        // [H, len] channels
  int n[2];                             // channels of each group
  int len[2];
  unsigned long long* scratch;  // tile counter, status [2, H, tiles]
  int H;
  int N;
  int tiles;  // tiles a row
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit_and_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_all;" ::: "memory");
}

// On the row's last tile: zeros in [min(count, len), len) of group kG's
// channels.
template <int kG>
__device__ __forceinline__ void zero_tail(const GroupArgs& a, size_t out, int count) {
  const int len = a.len[kG];
#pragma unroll
  for (int c = 0; c < kMaxStreams; ++c) {
    if (c < a.n[kG]) {
      for (int j = min(count, len) + threadIdx.x; j < len; j += kGroupThreads) {
        a.out[kG][c][out + j] = 0u;
      }
    }
  }
}

// Dynamic shared memory: [n_a][kGroupTile] words (group a's channels),
// then [kGroupWarps][n_b][kGroupBCap] (group b's staged entries).  N a
// multiple of 4, group a's planes 16-byte aligned.
__global__ void __launch_bounds__(kGroupThreads, kGroupBlocks)
compact_groups_kernel(GroupArgs a) {
  extern __shared__ __align__(16) uint32_t stage[];
  __shared__ uint16_t src[kGroupTile];  // group a: entry index of each rank
  __shared__ int counts[2][kGroupVT * kGroupWarps + 1];
  __shared__ int slot[2];
  const int tile = claim_tile(a.scratch, &slot[0]);
  const int row = tile / a.tiles;
  const int t = tile - row * a.tiles;
  const size_t base = static_cast<size_t>(row) * a.N + static_cast<size_t>(t) * kGroupTile;
  const int rest = a.N - t * kGroupTile;  // entries of the row from the tile on
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t below = (1u << lane) - 1u;
  bool take[2][kGroupVT];
#pragma unroll
  for (int v = 0; v < kGroupVT; ++v) {
    const int i = v * kGroupThreads + threadIdx.x;
    take[0][v] = i < rest && __ldg(a.sel[0] + base + i) != 0u;
    take[1][v] = i < rest && __ldg(a.sel[1] + base + i) != 0u;
  }
  const int n_a = a.n[0], n_b = a.n[1];
#pragma unroll
  for (int c = 0; c < kMaxStreams; ++c) {
    if (c < n_a) {
      for (int q = threadIdx.x; q < kGroupTile / 4 && 4 * q < rest; q += kGroupThreads) {
        cp_async16(stage + c * kGroupTile + 4 * q, a.in[0][c] + base + 4 * q);
      }
    }
  }
  uint32_t* bstage = stage + n_a * kGroupTile + warp * n_b * kGroupBCap;
  int wrank = 0;  // group b entries of the warp before this v
#pragma unroll
  for (int v = 0; v < kGroupVT; ++v) {
    const uint32_t ballot = __ballot_sync(0xffffffffu, take[1][v]);
    const int r = wrank + __popc(ballot & below);
    if (take[1][v] && r < kGroupBCap) {
      const int i = v * kGroupThreads + threadIdx.x;
#pragma unroll
      for (int c = 0; c < kMaxStreams; ++c) {
        if (c < n_b) cp_async4(bstage + c * kGroupBCap + r, a.in[1][c] + base + i);
      }
    }
    wrank += __popc(ballot);
  }
  int rank[2][kGroupVT];
  const int total_a = tile_ranks<kGroupThreads, kGroupVT>(take[0], rank[0], counts[0]);
  const int total_b = tile_ranks<kGroupThreads, kGroupVT>(take[1], rank[1], counts[1]);
  if (warp < 2) {
    const int before = lookback_warp(
        a.scratch + 1 + (static_cast<size_t>(warp) * a.H + row) * a.tiles, t,
        warp == 0 ? total_a : total_b, lane);
    if (lane == 0) slot[warp] = before;
  }
  __syncthreads();
  const int before_a = slot[0], before_b = slot[1];
  const int len_a = a.len[0], len_b = a.len[1];
#pragma unroll
  for (int v = 0; v < kGroupVT; ++v) {
    if (take[0][v] && before_a + rank[0][v] < len_a) {
      src[rank[0][v]] = static_cast<uint16_t>(v * kGroupThreads + threadIdx.x);
    }
  }
  cp_async_commit_and_wait_all();
  __syncthreads();
  // group a: the tile's output range, coalesced
  const int m = min(total_a, len_a - before_a);
  const size_t out_a = static_cast<size_t>(row) * len_a;
#pragma unroll
  for (int c = 0; c < kMaxStreams; ++c) {
    if (c < n_a) {
      const uint32_t* plane = stage + c * kGroupTile;
      for (int j = threadIdx.x; j < m; j += kGroupThreads) {
        a.out[0][c][out_a + before_a + j] = plane[src[j]];
      }
    }
  }
  // group b: each entry at its rank, from the warp's staged words
  const size_t out_b = static_cast<size_t>(row) * len_b;
  wrank = 0;
#pragma unroll
  for (int v = 0; v < kGroupVT; ++v) {
    const uint32_t ballot = __ballot_sync(0xffffffffu, take[1][v]);
    const int r = wrank + __popc(ballot & below);
    const int dst = before_b + rank[1][v];
    if (take[1][v] && dst < len_b) {
      const int i = v * kGroupThreads + threadIdx.x;
#pragma unroll
      for (int c = 0; c < kMaxStreams; ++c) {
        if (c < n_b) {
          a.out[1][c][out_b + dst] =
              r < kGroupBCap ? bstage[c * kGroupBCap + r] : __ldg(a.in[1][c] + base + i);
        }
      }
    }
    wrank += __popc(ballot);
  }
  if (t == a.tiles - 1) {
    zero_tail<0>(a, out_a, before_a + total_a);
    zero_tail<1>(a, out_b, before_b + total_b);
  }
}

// Tiles a row of N entries (at least one, whose block zero-fills the
// row's outputs).
int group_tiles(int N) { return N > 0 ? (N + kGroupTile - 1) / kGroupTile : 1; }

// Raises compact_groups_kernel's dynamic shared memory limit to
// kGroupSmemMax (past the 48 KB default), once a device.
cudaError_t allow_group_smem() {
  constexpr int kDevices = 64;
  static bool allowed[kDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess || (dev < kDevices && allowed[dev])) return rc;
  rc = cudaFuncSetAttribute(compact_groups_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize, kGroupSmemMax);
  if (rc == cudaSuccess && dev < kDevices) allowed[dev] = true;
  return rc;
}

}  // namespace

// Each entry point launches on the caller's stream and returns
// cudaGetLastError() (0 = launched).  Pointers are device pointers to
// C-contiguous uint32 rows: inputs [H, P], outputs [H, k128].

// Scratch words (int64) compact_angle_rows needs for H rows of P.
extern "C" long long compact_angle_rows_scratch(int H, int P) {
  return tiles_scratch<AngleWords>(H, P);
}

// K1/K2: zeroes the look-back scratch (scratch_words int64 words, at
// least compact_angle_rows_scratch(H, P)) on the stream, then launches.
extern "C" int compact_angle_rows(const void* aw, void* out, void* scratch,
                                  long long scratch_words, int H, int P,
                                  int k128, void* stream) {
  return launch_tiles<AngleWords>(aw, out, nullptr, nullptr, scratch, scratch_words, H,
                                  P, k128, stream);
}

// Scratch words (int64) compact_pair_rows needs for H rows of P.
extern "C" long long compact_pair_rows_scratch(int H, int P) {
  return tiles_scratch<PairWords>(H, P);
}

// K3: zeroes the look-back scratch (scratch_words int64 words, at least
// compact_pair_rows_scratch(H, P)) on the stream, then launches.
extern "C" int compact_pair_rows(const void* posw, const void* angw,
                                 void* out_pos, void* out_ang, void* scratch,
                                 long long scratch_words, int H, int P,
                                 int k128, void* stream) {
  const void* side_in[1] = {angw};
  void* side_out[1] = {out_ang};
  return launch_tiles<PairWords>(posw, out_pos, side_in, side_out, scratch,
                                 scratch_words, H, P, k128, stream);
}

// Scratch words (int64) compact_events_rows needs for H rows of P.
extern "C" long long compact_events_rows_scratch(int H, int P) {
  return tiles_scratch<EventWords>(H, P);
}

// K18: zeroes the look-back scratch (scratch_words int64 words, at least
// compact_events_rows_scratch(H, P)) on the stream, then launches.
extern "C" int compact_events_rows(const void* packed, const void* key,
                                   const void* sv, void* out_packed, void* out_key,
                                   void* out_sv, void* scratch,
                                   long long scratch_words, int H, int P, int k128,
                                   void* stream) {
  const void* side_in[2] = {key, sv};
  void* side_out[2] = {out_key, out_sv};
  return launch_tiles<EventWords>(packed, out_packed, side_in, side_out, scratch,
                                  scratch_words, H, P, k128, stream);
}

// Scratch words (int64) compact_rows_groups needs for H rows of N.
extern "C" long long compact_rows_groups_scratch(int H, int N) {
  return lookback_words(2 * H, group_tiles(N));
}

// K19: zeroes the look-back scratch (scratch_words int64 words, at least
// compact_rows_groups_scratch(H, N)) on the stream, then launches.
// in_a / out_a / in_b / out_b: host arrays of n_a / n_b device pointers;
// N a multiple of 4 and every input plane 16-byte aligned.
extern "C" int compact_rows_groups(const void* sel_a, const void* const* in_a,
                                   void* const* out_a, int n_a, int len_a,
                                   const void* sel_b, const void* const* in_b,
                                   void* const* out_b, int n_b, int len_b,
                                   void* scratch, long long scratch_words, int H,
                                   int N, void* stream) {
  if (n_a < 1 || n_a > kMaxStreams || n_b < 1 || n_b > kMaxStreams || N % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0) return static_cast<int>(cudaGetLastError());
  const long long words = compact_rows_groups_scratch(H, N);
  if (scratch_words < words) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (n_a * kGroupTile + kGroupWarps * n_b * kGroupBCap) * 4;
  cudaError_t rc = allow_group_smem();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  GroupArgs a{};
  const void* sel[2] = {sel_a, sel_b};
  const void* const* in[2] = {in_a, in_b};
  void* const* out[2] = {out_a, out_b};
  const int n[2] = {n_a, n_b};
  const int len[2] = {len_a, len_b};
  for (int g = 0; g < 2; ++g) {
    a.sel[g] = static_cast<const uint32_t*>(sel[g]);
    for (int c = 0; c < n[g]; ++c) {
      a.in[g][c] = static_cast<const uint32_t*>(in[g][c]);
      a.out[g][c] = static_cast<uint32_t*>(out[g][c]);
    }
    a.n[g] = n[g];
    a.len[g] = len[g];
  }
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.H = H;
  a.N = N;
  a.tiles = group_tiles(N);
  compact_groups_kernel<<<static_cast<unsigned>(H * a.tiles), kGroupThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Scratch words (int64) compact_payload_rows needs for H rows of P.
extern "C" long long compact_payload_rows_scratch(int H, int P) {
  return tiles_scratch<PayloadWords>(H, P);
}

// K4/K5: zeroes the look-back scratch (scratch_words int64 words, at
// least compact_payload_rows_scratch(H, P)) on the stream, then launches.
extern "C" int compact_payload_rows(const void* pay, void* out, void* scratch,
                                    long long scratch_words, int H, int P,
                                    int k128, void* stream) {
  return launch_tiles<PayloadWords>(pay, out, nullptr, nullptr, scratch, scratch_words,
                                    H, P, k128, stream);
}
