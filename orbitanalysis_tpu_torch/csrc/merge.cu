// The sorted merge-join engine's join kernels, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernels:
//   K15 orbitanalysis_tpu/ops/pallas_merge.py _merge_kernel (call :176,
//       entry merge_rows :191) -> merge_rows below
//   K16 orbitanalysis_tpu/ops/pallas_step.py _fused_kernel (call :457,
//       entry fused_join_detect :472) -> fused_join_detect below
//
// Keys are uint32, (id << 1) | side: prev entries (side 0) ascending,
// cur entries (side 1) descending, as the TPU kernels take them.  The
// TPU merged the two halves with a bitonic network over a whole 2P row
// held in VMEM, recorded each stage's swaps and replayed them backwards
// to route results home.  A block here has 227 KB of shared memory and a
// [2 x 65536] row of six channels is 3 MB, so neither kernel holds the
// merged row.
//
// merge_rows (K15), one launch, by merge path: the output is a stable
// sort of the concatenation [prev, cur] (prev before cur at equal keys,
// each side in its own index order).  A block takes a tile of
// kMergeTile merged positions of one row (blockIdx order: no block waits
// on another) and
//   0. finds where the tile's two diagonals cut A and B, by one
//      warp-wide 32-way search each, with prev first at equal keys; a
//      run of equal cur keys that crosses a tile edge gets its far end
//      by one more warp-wide search of the cur row;
//   1. loads the tile's contiguous prev and cur key ranges into shared
//      memory with coalesced loads and merges them there: each thread
//      walks kMergeVT merged positions after a binary search, noting each
//      position's source in shared memory.  A cur entry merged at B[j]
//      inside a run of equal keys B[js, je) comes from cur index
//      P - je + (j - js): the stable sort takes a run in cur index order,
//      the reverse of B's (the padding sentinel 0xFFFFFFFF opens every
//      padded cur row, and its run may span many tiles);
//   2. moves each channel through one shared-memory buffer: the tile's
//      prev range and its cur entries (at the indices of step 1) are
//      staged with coalesced loads (the next channel's loads in flight
//      while this one is written), and the tile's output positions are
//      written contiguously, coalesced.
// Every word is read once and written once; no block scatters.

// fused_join_detect (K16), one launch, by merge path.  Read the cur keys
// backwards (B[j] = ck[P - 1 - j], ascending) and merge them with the
// prev keys A: prev keys are even and cur keys odd, so no key of one
// side equals one of the other, and a matched pair (prev 2 id, cur
// 2 id + 1) is adjacent in the merged order, the cur entry right after
// its prev partner.  A block takes a tile of kJoinTile merged positions
// of one row (in arrival order, common.cuh claim_tile) and
//   0. finds where the tile's two diagonals cut A and B, by one
//      warp-wide 32-way search each (3 rounds of global loads at rows of
//      32768), and loads the tile's
//      contiguous prev and cur key ranges into shared memory with
//      coalesced loads, plus the merged entry before the tile and the
//      cur key after it;
//   1. merges: each thread walks kJoinVT merged positions after a binary
//      search in shared memory, and notes each cur entry whose merged
//      predecessor is its prev partner (and whose ID is not the padding
//      ID);
//   2. detects, a thread a cur lane: coalesced cur loads, prev loads at
//      partners that rise with the lane, the TPU kernel's detection
//      (pallas_step.py:148-192): the clipped cosine ((rx_l*rx + ry_l*ry)
//      + rz_l*rz), the Cephes arccos, the peri/apocentric flip on the
//      sv >> 24 sign bits, angle_acc = ang_l + dtheta.  It writes the cur
//      lane's packed word (the next carry's angle, 0 at an apsis, the
//      match flag in bit 31) coalesced in the staged (descending) cur
//      order, and the prev lane's event word (f32_bits(angle_acc) |
//      1 << 31 at an apsis) to shared memory.  A pair that straddles two
//      tiles is computed by both, with the same bits, each keeping its
//      own side;
//   3. ranks its prev lanes' events and places them in prev (ID) order
//      after the row's earlier tiles by common.cuh's decoupled look-back
//      (merged tiles are ordered, and so are the prev entries inside
//      each), as (prev key, prev sv, angle) rows of [H, k128]; the row's
//      last tile writes the exact count and zero-fills the tail.
// IDs are unique within a side, as the TPU kernel's contract has them.
// Every float operation is the plain version's, in its order; the build
// passes --fmad=false and IEEE sqrtf, so kernel and plain version agree
// bit for bit.
//
// What bounds them on the H100: bytes.  At the bench shape [64, 32768]
// merge_rows (six channels a side) reads 100 MB and writes 100 MB, 60 us
// at 3.35 TB/s; fused_join_detect reads 11 planes (92 MB) and writes
// packed and the events (10 MB), 31 us.  Both read each key once from
// device memory, coalesced, and keep no [H, P] scratch plane.  K16's
// tiles of 1024 merged positions put 4096 blocks on the 132 SMs at the
// bench shape; K15's tiles of 1024 put 4096 there, each moving 48 KB of
// its six channels through 10 KB of shared memory (the one-channel
// buffer, the sources of the tile's positions and the cur indices of its
// B entries).  Built for 32 registers a thread, eight K15 blocks share an
// SM, so one block's loads overlap the others' searches, barriers and
// writes (256 x 8 positions at 80 registers, three blocks an SM, took
// 1.27x as long on the card; detect_variants.py).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The first x in [lo, hi) at which pred fails (hi where it holds on the
// whole range); pred must hold on a prefix of the range and fail after
// it.  The whole warp calls it with the same arguments: each round its
// 32 lanes probe 32 evenly spaced x, and the first failing probe cuts the
// range to a 32nd (3 rounds of loads at rows of 32768).
template <typename Pred>
__device__ __forceinline__ int warp_partition_point(int lo, int hi, Pred pred) {
  const int lane = threadIdx.x & 31;
  for (;;) {
    const int n = hi - lo;
    const int step = n <= 32 ? 1 : (n + 31) / 32;
    const int x = lo + lane * step;
    const bool holds = x < hi && pred(x);
    const int c = __popc(__ballot_sync(0xffffffffu, holds));
    if (step == 1 || c == 0) return lo + (step == 1 ? c : 0);
    const int next_lo = lo + (c - 1) * step + 1;
    hi = min(hi, lo + c * step);
    lo = next_lo;
  }
}

// How many of the first d merged entries of a row are prev entries (A
// the prev keys, B[j] = ck[P - 1 - j]): the first i in [max(0, d - P),
// min(d, P)] with B[d - 1 - i] before A[i].  kPrevFirst: a prev key
// goes before an equal cur key (K15's stable sort); K16's keys never tie
// across sides.  The whole warp calls it.
template <bool kPrevFirst>
__device__ __forceinline__ int merge_split(const uint32_t* pk, const uint32_t* ck,
                                           int P, int d) {
  return warp_partition_point(max(0, d - P), min(d, P), [=](int x) {
    // B[d - 1 - x] = ck[P - d + x]
    const uint32_t a = __ldg(pk + x), b = __ldg(ck + (P - d + x));
    return kPrevFirst ? a <= b : a < b;
  });
}

// K15: tiles of kMergeTile merged positions.
constexpr int kMergeThreads = 256;
constexpr int kMergeVT = 4;      // merged positions a thread
constexpr int kMergeBlocks = 8;  // resident blocks an SM: 32 registers a thread
constexpr int kMergeTile = kMergeThreads * kMergeVT;

struct MergeArgs {
  const uint32_t* prev[kMaxStreams];  // channel 0 is the key
  const uint32_t* cur[kMaxStreams];
  uint32_t* out[kMaxStreams];         // [H, 2P]
  int n_chan;
  int P;
  int tiles;                          // tiles a row
};

// The tile's words of one channel, buf[x] for x = v * kMergeThreads +
// threadIdx.x: the prev range [i0, i0 + na), then the cur words of B
// positions j0 .. j0 + nb - 1, from cur index at(x - na).  Loads only:
// the caller stores w to buf after a barrier.
template <typename CurIndex>
__device__ __forceinline__ void load_tile(const uint32_t* prev, const uint32_t* cur,
                                          int na, int n, CurIndex at,
                                          uint32_t (&w)[kMergeVT]) {
#pragma unroll
  for (int v = 0; v < kMergeVT; ++v) {
    const int x = v * kMergeThreads + threadIdx.x;
    w[v] = x < na ? __ldg(prev + x) : x < n ? __ldg(cur + at(x - na)) : 0u;
  }
}

__device__ __forceinline__ void store_tile(uint32_t* buf, int n,
                                           const uint32_t (&w)[kMergeVT]) {
#pragma unroll
  for (int v = 0; v < kMergeVT; ++v) {
    const int x = v * kMergeThreads + threadIdx.x;
    if (x < n) buf[x] = w[v];
  }
}

// grid: one block a tile, H * tiles blocks.
__global__ void __launch_bounds__(kMergeThreads, kMergeBlocks)
merge_rows_kernel(MergeArgs a) {
  __shared__ uint32_t buf[kMergeTile];  // one channel's prev range, then its cur entries
  // src[o + o / 32]: the buf index output position o takes (padded
  // against bank conflicts)
  __shared__ uint16_t src[kMergeTile + kMergeTile / 32];
  __shared__ int cur_at[kMergeTile];    // the cur index of B position j0 + x
  // split[w]: prev entries before diagonal w; edge[0]: js of the run of
  // B[j0] (j0 unless it starts before the tile), edge[1]: je of the run
  // of B[j1 - 1] (j1 unless it ends after the tile)
  __shared__ int split[2], edge[2];
  const int row = blockIdx.x / a.tiles;
  const int t = blockIdx.x - row * a.tiles;
  const int P = a.P;
  const size_t base = static_cast<size_t>(row) * P;
  const uint32_t* pk = a.prev[0] + base;
  const uint32_t* ck = a.cur[0] + base;
  const int d0 = t * kMergeTile;
  const int d1 = min(2 * P, d0 + kMergeTile);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int d = warp == 0 ? d0 : d1;
    const int i = merge_split<true>(pk, ck, P, d);
    // warp 0: does the run of B[j0] start before the tile?  warp 1: does
    // the run of B[j1 - 1] end after it?  Then its far end.
    const int j = d - i;
    int e = j;
    if (j > 0 && j < P) {
      const uint32_t k = __ldg(ck + (P - j));  // B[j - 1]
      if (k == __ldg(ck + (P - 1 - j))) {      // B[j]
        e = warp == 0
                ? warp_partition_point(0, j - 1, [=](int x) { return __ldg(ck + (P - 1 - x)) < k; })
                : warp_partition_point(j + 1, P, [=](int x) { return __ldg(ck + (P - 1 - x)) <= k; });
      }
    }
    if ((threadIdx.x & 31) == 0) {
      split[warp] = i;
      edge[warp] = e;
    }
  }
  __syncthreads();
  const int i0 = split[0], i1 = split[1];
  const int j0 = d0 - i0, j1 = d1 - i1;
  const int na = i1 - i0, nb = j1 - j0, n = na + nb;
  const int js_first = edge[0], je_last = edge[1];
  uint32_t w[kMergeVT];
  load_tile(pk + i0, ck, na, n, [=](int x) { return P - 1 - j0 - x; }, w);
  store_tile(buf, n, w);
  __syncthreads();

  // 1. the merge: thread's positions [s, s + kMergeVT) of the tile
  const uint32_t* sb = buf + na;  // B[j0 .. j1)
  const int s = threadIdx.x * kMergeVT;
  if (s < n) {
    int lo = max(0, s - nb), hi = min(s, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (buf[mid] <= sb[s - 1 - mid]) lo = mid + 1; else hi = mid;
    }
    int ia = lo, jb = s - lo;
    uint32_t run_key = 0u;
    int run_js = -1, run_je = -1;  // the last run looked up: B[run_js, run_je)
    for (int v = 0; v < kMergeVT; ++v) {
      const int o = s + v;
      if (o < n) {
        int from;
        if (ia < na && (jb >= nb || buf[ia] <= sb[jb])) {
          from = ia++;
        } else {
          const uint32_t k = sb[jb];
          const bool left = jb > 0 ? sb[jb - 1] == k : js_first < j0;
          const bool right = jb + 1 < nb ? sb[jb + 1] == k : je_last > j1;
          int c = P - 1 - (j0 + jb);
          if (left || right) {
            if (run_js < 0 || run_key != k) {
              int l = 0, h = jb;  // first x with sb[x] >= k
              while (l < h) {
                const int m = (l + h) >> 1;
                if (sb[m] < k) l = m + 1; else h = m;
              }
              run_js = l == 0 ? js_first : j0 + l;
              l = jb + 1, h = nb;  // first x with sb[x] > k
              while (l < h) {
                const int m = (l + h) >> 1;
                if (sb[m] <= k) l = m + 1; else h = m;
              }
              run_je = l == nb ? je_last : j0 + l;
              run_key = k;
            }
            c = P - run_je + (j0 + jb - run_js);
          }
          cur_at[jb] = c;
          from = na + jb++;
        }
        src[o + (o >> 5)] = static_cast<uint16_t>(from);
      }
    }
  }
  __syncthreads();

  // 2. the channels, one buffer: channel c is written while channel
  // c + 1's loads are in flight
  const auto at = [&](int x) { return cur_at[x]; };
  if (a.n_chan > 1) load_tile(a.prev[1] + base + i0, a.cur[1] + base, na, n, at, w);
  const size_t out = static_cast<size_t>(row) * 2 * P + d0;
  for (int c = 0;; ++c) {
#pragma unroll
    for (int v = 0; v < kMergeVT; ++v) {
      const int o = v * kMergeThreads + threadIdx.x;
      if (o < n) a.out[c][out + o] = buf[src[o + (o >> 5)]];
    }
    if (c + 1 == a.n_chan) break;
    __syncthreads();  // every thread has read channel c from buf
    store_tile(buf, n, w);
    __syncthreads();
    if (c + 2 < a.n_chan) {
      load_tile(a.prev[c + 2] + base + i0, a.cur[c + 2] + base, na, n, at, w);
    }
  }
}

constexpr int kJoinVT = 4;  // merged positions a thread
constexpr int kJoinTile = kThreads * kJoinVT;
constexpr int kWarps = kThreads / 32;

struct JoinArgs {
  const uint32_t* pk;    // [H, P] prev keys, ascending
  const int32_t* psv;    // slot | vrb << 24
  const float* prx;
  const float* pry;
  const float* prz;
  const float* pang;     // cumulative angle
  const uint32_t* ck;    // [H, P] cur keys, descending
  const int32_t* csv;
  const float* crx;
  const float* cry;
  const float* crz;
  uint32_t* packed;      // [H, P] staged cur order
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
};

// grid: one block a tile, H * tiles blocks.
__global__ void __launch_bounds__(kThreads)
join_detect_kernel(JoinArgs a) {
  __shared__ uint32_t sa[kJoinTile + 1];  // A[i0 - 1 .. i1)
  __shared__ uint32_t sb[kJoinTile + 2];  // B[j0 - 1 .. j1]
  __shared__ uint32_t sev[kJoinTile];     // the tile's prev lanes' event words
  // partner[lc]: 2 + the tile's index of cur lane lc's prev partner (1
  // for the merged entry before the tile), 0 for none; partner[nb]: the
  // pair of the tile's last prev entry and the cur entry after the tile
  __shared__ int16_t partner[kJoinTile + 1];
  __shared__ int split[2];
  __shared__ int slot;
  __shared__ int counts[kJoinVT * kWarps + 1];
  const int tile = claim_tile(a.scratch, &slot);
  const int row = tile / a.tiles;
  const int t = tile - row * a.tiles;
  const int P = a.P;
  const size_t base = static_cast<size_t>(row) * P;
  const uint32_t* pk = a.pk + base;
  const uint32_t* ck = a.ck + base;
  const int d0 = t * kJoinTile;
  const int d1 = min(2 * P, d0 + kJoinTile);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int i = merge_split<false>(pk, ck, P, warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) split[warp] = i;
  }
  for (int x = threadIdx.x; x < kJoinTile; x += kThreads) {
    sev[x] = 0u;
    partner[x] = 0;
  }
  if (threadIdx.x == 0) partner[kJoinTile] = 0;
  __syncthreads();
  const int i0 = split[0], i1 = split[1];
  const int j0 = d0 - i0, j1 = d1 - i1;
  const int na = i1 - i0, nb = j1 - j0;
  for (int x = threadIdx.x; x < na; x += kThreads) sa[1 + x] = __ldg(pk + i0 + x);
  for (int x = threadIdx.x; x < nb; x += kThreads) sb[1 + x] = __ldg(ck + (P - 1 - j0 - x));
  if (threadIdx.x == 0) {
    sa[0] = i0 > 0 ? __ldg(pk + i0 - 1) : 0u;
    sb[0] = j0 > 0 ? __ldg(ck + (P - j0)) : 0u;
    sb[nb + 1] = j1 < P ? __ldg(ck + (P - 1 - j1)) : 0u;
  }
  __syncthreads();

  // 1. the merge: each thread walks kJoinVT merged positions and notes
  // each cur entry whose merged predecessor is its prev partner
  const int n = na + nb;
  const int s = threadIdx.x * kJoinVT;
  if (s < n) {
    // this thread's split of the tile: ia prev and jb cur entries before
    // merged position s
    int lo = max(0, s - nb), hi = min(s, na);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sa[1 + mid] < sb[s - mid]) lo = mid + 1; else hi = mid;
    }
    int ia = lo, jb = s - lo;
    // the merged entry before position s: the larger of A[i0 + ia - 1]
    // (sa[ia]) and B[j0 + jb - 1] (sb[jb]), where they exist
    const bool has_a = ia > 0 || i0 > 0;
    const bool has_b = jb > 0 || j0 > 0;
    bool pred_a = has_a && (!has_b || sa[ia] > sb[jb]);
    uint32_t pred = pred_a ? sa[ia] : sb[jb];
#pragma unroll
    for (int v = 0; v < kJoinVT; ++v) {
      if (s + v < n) {
        if (ia < na && (jb >= nb || sa[1 + ia] < sb[1 + jb])) {
          pred = sa[1 + ia];
          pred_a = true;
          ++ia;
        } else {
          const uint32_t k = sb[1 + jb];
          if (pred_a && pred + 1u == k && (k >> 1) != a.invalid) {
            partner[jb] = static_cast<int16_t>(ia + 1);
          }
          pred = k;
          pred_a = false;
          ++jb;
        }
      }
    }
    // the tile's last merged entry is a prev key whose partner opens the
    // next tile: its event belongs here
    if (s + kJoinVT >= n && pred_a && j1 < P) {
      const uint32_t k = sb[nb + 1];
      if (pred + 1u == k && (k >> 1) != a.invalid) {
        partner[nb] = static_cast<int16_t>(na + 1);
      }
    }
  }
  __syncthreads();

  // 2. detection, a thread a cur lane (lc = nb: the pair after the
  // tile, which writes no packed word): coalesced cur loads, prev loads
  // at partners that rise with lc
#pragma unroll
  for (int v = 0; v < kJoinVT; ++v) {
    const int lc = v * kThreads + threadIdx.x;
    if (lc <= nb) {
      const int q = partner[lc];
      const size_t c = base + (P - 1 - (j0 + lc));
      uint32_t word = 0u;
      if (q != 0) {
        const int lp = q - 2;
        const size_t p = base + (i0 + lp);
        float cs = __ldg(a.prx + p) * __ldg(a.crx + c) + __ldg(a.pry + p) * __ldg(a.cry + c);
        cs = cs + __ldg(a.prz + p) * __ldg(a.crz + c);
        cs = fminf(fmaxf(cs, -1.0f), 1.0f);
        const float angle_acc = __ldg(a.pang + p) + acos_f32(cs);
        const int vrb_l = __ldg(a.psv + p) >> 24;
        const int vrb = __ldg(a.csv + c) >> 24;
        const bool apsis =
            a.pericentric ? ((vrb_l & 1) && (vrb & 2)) : ((vrb_l & 2) && (vrb & 1));
        word = __float_as_uint(apsis ? 0.0f : angle_acc) | 0x80000000u;
        if (lp >= 0 && apsis) sev[lp] = __float_as_uint(angle_acc) | 0x80000000u;
      }
      if (lc < nb) a.packed[c] = word;
    }
  }
  __syncthreads();

  // 3. the tile's prev lanes' events, in prev order, after the row's
  // earlier tiles
  bool take[kJoinVT];
  int rank[kJoinVT];
#pragma unroll
  for (int v = 0; v < kJoinVT; ++v) {
    const int x = v * kThreads + threadIdx.x;
    take[v] = x < na && (sev[x] >> 31) != 0u;
  }
  const int total = tile_ranks<kThreads, kJoinVT>(take, rank, counts);
  const int before =
      lookback_prefix(a.scratch + 1 + static_cast<size_t>(row) * a.tiles, t, total, &slot);
  const size_t out = static_cast<size_t>(row) * a.len;
#pragma unroll
  for (int v = 0; v < kJoinVT; ++v) {
    const int x = v * kThreads + threadIdx.x;
    const int o = before + rank[v];
    if (take[v] && o < a.len) {
      a.ev_key[out + o] = sa[1 + x];
      a.ev_sv[out + o] = static_cast<uint32_t>(__ldg(a.psv + base + i0 + x));
      a.ev_ang[out + o] = sev[x] & 0x7FFFFFFFu;
    }
  }
  if (t == a.tiles - 1) {
    finish_row(a.ev_key + out, a.ev_sv + out, a.ev_ang + out, a.len, before + total,
               a.count + row);
  }
}

int join_tiles_a_row(int P) { return (2 * P + kJoinTile - 1) / kJoinTile; }

}  // namespace

// Entry points: launch on the caller's stream, return cudaGetLastError()
// (0 = launched).  Pointers are device pointers to C-contiguous [H, P]
// planes of 32-bit words.

// prev / cur / out: host arrays of n_chan device pointers; out planes are
// [H, 2P].
extern "C" int merge_rows(const void* const* prev, const void* const* cur,
                          void* const* out, int n_chan, int H, int P,
                          void* stream) {
  if (n_chan < 1 || n_chan > kMaxStreams) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H > 0 && P > 0) {
    MergeArgs a{};
    for (int c = 0; c < n_chan; ++c) {
      a.prev[c] = static_cast<const uint32_t*>(prev[c]);
      a.cur[c] = static_cast<const uint32_t*>(cur[c]);
      a.out[c] = static_cast<uint32_t*>(out[c]);
    }
    a.n_chan = n_chan;
    a.P = P;
    a.tiles = (2 * P + kMergeTile - 1) / kMergeTile;
    const long long blocks = static_cast<long long>(H) * a.tiles;
    merge_rows_kernel<<<static_cast<unsigned>(blocks), kMergeThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// Scratch words (int64) fused_join_detect needs for H rows of P.
extern "C" long long fused_join_detect_scratch(int H, int P) {
  return lookback_words(H, join_tiles_a_row(P));
}

// Zeroes the scratch and launches on the caller's stream.  Outputs:
// packed [H, P], ev_key / ev_sv / ev_ang [H, k128] (zero past each row's
// count; ev_ang holds the f32 angle bits), count [H] (exact, may exceed
// k128).  scratch: scratch_words int64 words, at least
// fused_join_detect_scratch(H, P).
extern "C" int fused_join_detect(
    const void* pk, const void* psv, const void* prx, const void* pry,
    const void* prz, const void* pang, const void* ck, const void* csv,
    const void* crx, const void* cry, const void* crz, void* packed,
    void* ev_key, void* ev_sv, void* ev_ang, void* count, void* scratch,
    long long scratch_words, int H, int P, int k128, int invalid,
    int pericentric, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || P <= 0) return static_cast<int>(cudaGetLastError());
  const int tiles = join_tiles_a_row(P);
  const long long words = lookback_words(H, tiles);
  if (scratch_words < words) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, words * sizeof(unsigned long long), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  JoinArgs a;
  a.pk = static_cast<const uint32_t*>(pk);
  a.psv = static_cast<const int32_t*>(psv);
  a.prx = static_cast<const float*>(prx);
  a.pry = static_cast<const float*>(pry);
  a.prz = static_cast<const float*>(prz);
  a.pang = static_cast<const float*>(pang);
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
  join_detect_kernel<<<static_cast<unsigned>(words - 1), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
