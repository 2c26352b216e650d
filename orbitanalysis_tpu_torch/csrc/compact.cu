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
//   one block a row (K1 its own loop, as it builds its output word from
//     the input; K3, K18 and K19 through common.cuh's
//     compact_streams_kernel, up to six streams moving together
//     unchanged): 1024 threads walk the row in tiles of 1024 entries.  In
//     a tile, __ballot_sync + __popc give each event its rank inside its
//     warp, warp 0 scans the 32 warp totals in shared memory, and a
//     running base carries the count across tiles.  K1 stops reading
//     once its k128 outputs are full.
//   (row, tile) tiles in arrival order (K4/K5, compact_payload_rows): a
//     block takes a tile of kPayThreads x kPayVT words of one row through
//     common.cuh's claim_tile, loads them coalesced (word v *
//     kPayThreads + threadIdx.x of the tile is the thread's v-th), keeps
//     them in registers, ranks the events (tile_ranks), gets the count
//     of the row's earlier tiles by the decoupled look-back
//     (lookback_prefix) and writes each event to prefix + rank where that
//     is below k128; the row's last tile (its highest index, which may
//     finish before others of the row: they write below the row's total,
//     it writes at or above) zero-fills [min(n, k128), k128).  Every tile
//     reads its whole tile: it cannot know its prefix before it publishes
//     its own count.
//
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
// fills only 64 of 132 SMs and each tile waits for its load and two
// barriers, so K1 is latency-bound well above that floor.  K4/K5 cut the
// same shape into 64 x 8 tiles of 4096 words, one resident wave of
// 256-thread blocks with sixteen loads in flight a thread (the fastest
// of 256 x 4, 8, 16 and 512 x 8 on the card, detect_variants.py); what
// is left above the floor is the launch, the scratch memset and the
// look-back.
//
// The only float work is one multiply by the exact power of two 2^24,
// so FMA contraction cannot change a result; the build still passes
// --fmad=false.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
compact_angle_rows_kernel(const uint32_t* __restrict__ aw,
                          uint32_t* __restrict__ out, int P, int k128) {
  __shared__ int warp_off[kWarps];
  __shared__ int tile_total;
  const uint32_t* in = aw + static_cast<size_t>(blockIdx.x) * P;
  uint32_t* o = out + static_cast<size_t>(blockIdx.x) * k128;
  const int lane = threadIdx.x & 31;
  const uint32_t lanes_below = (1u << lane) - 1u;
  int base = 0;  // events in earlier tiles: uniform across the block
  for (int start = 0; start < P && base < k128; start += kThreads) {
    const int i = start + threadIdx.x;
    const uint32_t w = i < P ? in[i] : 0u;
    const bool sel = (w >> 31) != 0u;
    const uint32_t ballot = __ballot_sync(0xffffffffu, sel);
    int before, total;
    tile_offsets<kWarps>(__popc(ballot), warp_off, &tile_total, before, total);
    if (sel) {
      const int off = base + before + __popc(ballot & lanes_below);
      if (off < k128) {
        const float ang = __int_as_float(static_cast<int32_t>(w & 0x7FFFFFFFu));
        o[off] = (static_cast<uint32_t>(i + 1) << 15) | (f16_bits_rne(ang) & 0x7FFFu);
      }
    }
    base += total;
    __syncthreads();  // warp_off / tile_total are rewritten next tile
  }
  for (int j = min(base, k128) + threadIdx.x; j < k128; j += kThreads) o[j] = 0u;
}

// K4/K5: tiles of kPayTile words in arrival order; an event is a word
// >= 2^15, moved unchanged.
constexpr int kPayThreads = 256;
constexpr int kPayVT = 16;  // words a thread
constexpr int kPayTile = kPayThreads * kPayVT;

__global__ void __launch_bounds__(kPayThreads)
compact_payload_kernel(const uint32_t* __restrict__ pay, uint32_t* __restrict__ out,
                       unsigned long long* scratch, int P, int tiles, int k128) {
  __shared__ int slot;
  __shared__ int counts[kPayVT * (kPayThreads / 32) + 1];
  const int tile = claim_tile(scratch, &slot);
  const int row = tile / tiles;
  const int t = tile - row * tiles;
  const uint32_t* in = pay + static_cast<size_t>(row) * P;
  uint32_t w[kPayVT];
  bool take[kPayVT];
#pragma unroll
  for (int v = 0; v < kPayVT; ++v) {
    const int x = t * kPayTile + v * kPayThreads + threadIdx.x;
    w[v] = x < P ? __ldg(in + x) : 0u;
    take[v] = (w[v] & 0xFFFF8000u) != 0u;
  }
  int rank[kPayVT];
  const int total = tile_ranks<kPayThreads, kPayVT>(take, rank, counts);
  const int before =
      lookback_prefix(scratch + 1 + static_cast<size_t>(row) * tiles, t, total, &slot);
  uint32_t* o = out + static_cast<size_t>(row) * k128;
#pragma unroll
  for (int v = 0; v < kPayVT; ++v) {
    const int dst = before + rank[v];
    if (take[v] && dst < k128) o[dst] = w[v];
  }
  if (t == tiles - 1) finish_row(o, k128, before + total, nullptr);
}

int payload_tiles(int P) { return (P + kPayTile - 1) / kPayTile; }

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
extern "C" int compact_angle_rows(const void* aw, void* out, int H, int P,
                                  int k128, void* stream) {
  if (H > 0) {
    compact_angle_rows_kernel<<<H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(aw), static_cast<uint32_t*>(out), P, k128);
  }
  return static_cast<int>(cudaGetLastError());
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
  return lookback_words(H, payload_tiles(P));
}

// K4/K5: zeroes the look-back scratch (scratch_words int64 words, at
// least compact_payload_rows_scratch(H, P)) on the stream, then launches.
extern "C" int compact_payload_rows(const void* pay, void* out, void* scratch,
                                    long long scratch_words, int H, int P,
                                    int k128, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = payload_tiles(P);
  const long long words = lookback_words(H, tiles);
  if (scratch_words < words) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  compact_payload_kernel<<<static_cast<unsigned>(words - 1), kPayThreads, 0, s>>>(
      static_cast<const uint32_t*>(pay), static_cast<uint32_t*>(out),
      static_cast<unsigned long long*>(scratch), P, tiles, k128);
  return static_cast<int>(cudaGetLastError());
}
