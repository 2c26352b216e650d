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
// merge_rows (K15): each entry finds its output index by a binary search
// of the other row: its rank in its own row plus the count of the other
// row's keys below it; the result equals a stable sort of the
// concatenation [prev, cur], ties among the padding sentinels included
// (prev before cur, each side in its own index order), and every channel
// of the entry is scattered there.
//
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
// packed and the events (10 MB), 31 us.  K16 reads each key once from
// device memory and the detection planes once, coalesced, keeps no
// [H, P] scratch plane, and with tiles of 1024 merged positions puts
// 4096 blocks on the 132 SMs at the bench shape.  merge_rows still searches
// 15 keys a lane in L2 and scatters each channel with no coalescing
// across a warp; a merge path per block is its faster form.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Length of the prefix of a[0, n) on which pred holds (pred must hold on
// a prefix and fail after it): on an ascending row, pred x < k counts the
// keys below k; on a descending row, pred x >= k counts those at or
// above it.
template <typename Pred>
__device__ __forceinline__ int partition_point(const uint32_t* a, int n, Pred pred) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pred(a[mid])) lo = mid + 1; else hi = mid;
  }
  return lo;
}

struct MergeArgs {
  const uint32_t* prev[kMaxStreams];  // channel 0 is the key
  const uint32_t* cur[kMaxStreams];
  uint32_t* out[kMaxStreams];         // [H, 2P]
  int n_chan;
  int P;
};

// grid (H, P / kThreads, 2): row, tile, side (0 prev, 1 cur).
__global__ void __launch_bounds__(kThreads)
merge_rows_kernel(MergeArgs a) {
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= a.P) return;
  const size_t row = blockIdx.x;
  const size_t P = a.P;
  const uint32_t* pk = a.prev[0] + row * P;
  const uint32_t* ck = a.cur[0] + row * P;
  const bool cur = blockIdx.z != 0;
  int dst;
  if (!cur) {
    const uint32_t k = pk[i];
    dst = i + (a.P - partition_point(ck, a.P, [k](uint32_t x) { return x >= k; }));
  } else {
    const uint32_t k = ck[i];
    dst = partition_point(pk, a.P, [k](uint32_t x) { return x <= k; }) +
          (a.P - partition_point(ck, a.P, [k](uint32_t x) { return x >= k; })) +
          (i - partition_point(ck, a.P, [k](uint32_t x) { return x > k; }));
  }
  for (int c = 0; c < a.n_chan; ++c) {
    const uint32_t* src = cur ? a.cur[c] : a.prev[c];
    a.out[c][row * 2 * P + dst] = src[row * P + i];
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

// How many of the first d merged entries of a row are prev entries: the
// first i in [max(0, d - P), min(d, P)] with A[i] > B[d - 1 - i] (A the
// prev keys, B[j] = ck[P - 1 - j]).  The whole warp calls it: each round
// its 32 lanes probe 32 evenly spaced i, and the first failing probe cuts
// the range to a 32nd.
__device__ int merge_split(const uint32_t* pk, const uint32_t* ck, int P, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - P), hi = min(d, P);
  for (;;) {
    const int n = hi - lo;
    const int step = n <= 32 ? 1 : (n + 31) / 32;
    const int x = lo + lane * step;
    // B[d - 1 - x] = ck[P - d + x]
    const bool below = x < hi && __ldg(pk + x) < __ldg(ck + (P - d + x));
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (step == 1 || c == 0) return lo + (step == 1 ? c : 0);
    const int next_lo = lo + (c - 1) * step + 1;
    hi = min(hi, lo + c * step);
    lo = next_lo;
  }
}

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
    const int i = merge_split(pk, ck, P, warp == 0 ? d0 : d1);
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
    const dim3 grid(H, (P + kThreads - 1) / kThreads, 2);
    merge_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
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
