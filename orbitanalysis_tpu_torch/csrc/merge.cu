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
// [2 x 65536] row of six channels is 3 MB, so neither kernel builds the
// merged row: each entry finds its place, or its partner, by a binary
// search of the other side's keys, and every entry is handled by its
// own thread.
//
// merge_rows (K15): an entry's output index is its rank in its own row
// plus the count of the other row's keys below it; the result equals a
// stable sort of the concatenation [prev, cur], ties among the padding
// sentinels included (prev before cur, each side in its own index
// order), and every channel of the entry is scattered there.
//
// fused_join_detect (K16), two launches (one detect pass over both
// sides, then common.cuh's ordered compaction; a single launch would
// have to put the binary searches inside the one-block-a-row scan, which
// is neither simpler nor faster):
//   1. grid (H, P / 256, 2): a cur lane searches the ascending prev keys
//      for id << 1, a prev lane the descending cur keys for (id << 1) | 1;
//      a found, valid pair computes the TPU kernel's detection
//      (pallas_step.py:148-192) on the same inputs from both sides: the
//      clipped cosine ((rx_l*rx + ry_l*ry) + rz_l*rz), the Cephes arccos,
//      the peri/apocentric flip on the sv >> 24 sign bits, angle_acc =
//      ang_l + dtheta.  The cur lane writes packed (the next carry's
//      angle, 0 at an apsis, with the match flag in bit 31) in the staged
//      cur order; the prev lane writes its event word f32_bits(angle_acc)
//      | 1 << 31 where an apsis fired, else 0, to a [H, P] scratch plane.
//   2. the scan over the prev domain moves (prev key, prev sv, angle) of
//      each event to the front of [H, k128] rows in prev (ID) order and
//      writes the exact count per row.
// Every float operation is the plain version's, in its order; the build
// passes --fmad=false and IEEE sqrtf, so kernel and plain version agree
// bit for bit.
//
// What bounds them on the H100: bytes.  At the bench shape [64, 32768]
// merge_rows (six channels a side) reads 100 MB and writes 100 MB, 60 us
// at 3.35 TB/s; fused_join_detect reads 11 planes (92 MB) and writes
// packed and the events (10 MB), 31 us.  The binary searches read 15
// keys a lane from a 128 KB row that stays in L2, and the scatter of
// merge_rows writes each channel with no coalescing across a warp; the
// compaction pass is one block a row.  Simple first: these are the
// places to go faster (a merge path per block, shared-memory key tiles).

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
  uint32_t* evp;         // [H, P] prev order, scratch for the compaction
  int P;
  uint32_t invalid;      // the padding ID
  int pericentric;
};

// grid (H, P / kThreads, 2): row, tile, side (0 prev, 1 cur).
__global__ void __launch_bounds__(kThreads)
join_detect_kernel(JoinArgs a) {
  const int i = blockIdx.y * kThreads + threadIdx.x;
  if (i >= a.P) return;
  const size_t base = static_cast<size_t>(blockIdx.x) * a.P;
  const uint32_t* pk = a.pk + base;
  const uint32_t* ck = a.ck + base;
  const bool cur = blockIdx.z != 0;
  int ip, ic;  // the prev and cur lanes of the pair
  bool match;
  if (cur) {
    const uint32_t key = ck[i];
    const uint32_t target = key & ~1u;
    ic = i;
    ip = partition_point(pk, a.P, [target](uint32_t x) { return x < target; });
    match = (key >> 1) != a.invalid && ip < a.P && pk[ip] == target;
  } else {
    const uint32_t key = pk[i];
    const uint32_t target = key | 1u;
    ip = i;
    ic = partition_point(ck, a.P, [target](uint32_t x) { return x > target; });
    match = (key >> 1) != a.invalid && ic < a.P && ck[ic] == target;
  }
  bool apsis = false;
  float angle_acc = 0.0f;
  if (match) {
    const size_t p = base + ip;
    const size_t c = base + ic;
    float cs = a.prx[p] * a.crx[c] + a.pry[p] * a.cry[c];
    cs = cs + a.prz[p] * a.crz[c];
    cs = fminf(fmaxf(cs, -1.0f), 1.0f);
    angle_acc = a.pang[p] + acos_f32(cs);
    const int vrb_l = a.psv[p] >> 24;
    const int vrb = a.csv[c] >> 24;
    apsis = a.pericentric ? ((vrb_l & 1) && (vrb & 2)) : ((vrb_l & 2) && (vrb & 1));
  }
  if (cur) {
    a.packed[base + i] =
        match ? (__float_as_uint(apsis ? 0.0f : angle_acc) | 0x80000000u) : 0u;
  } else {
    a.evp[base + i] = apsis ? (__float_as_uint(angle_acc) | 0x80000000u) : 0u;
  }
}

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

// Outputs: packed [H, P], evp [H, P] (scratch), ev_key / ev_sv / ev_ang
// [H, k128] (zero past each row's count; ev_ang holds the f32 angle
// bits), count [H] (exact, may exceed k128).
extern "C" int fused_join_detect(
    const void* pk, const void* psv, const void* prx, const void* pry,
    const void* prz, const void* pang, const void* ck, const void* csv,
    const void* crx, const void* cry, const void* crz, void* packed,
    void* evp, void* ev_key, void* ev_sv, void* ev_ang, void* count, int H,
    int P, int k128, int invalid, int pericentric, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H > 0 && P > 0) {
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
    a.evp = static_cast<uint32_t*>(evp);
    a.P = P;
    a.invalid = static_cast<uint32_t>(invalid);
    a.pericentric = pericentric;
    const dim3 grid(H, (P + kThreads - 1) / kThreads, 2);
    join_detect_kernel<<<grid, kThreads, 0, s>>>(a);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  StreamGroup g{};
  g.sel = static_cast<const uint32_t*>(evp);
  g.sel_mask = 0x80000000u;
  const void* in[3] = {pk, psv, evp};
  void* out[3] = {ev_key, ev_sv, ev_ang};
  const uint32_t mask[3] = {0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu};
  for (int c = 0; c < 3; ++c) {
    g.in[c] = static_cast<const uint32_t*>(in[c]);
    g.out[c] = static_cast<uint32_t*>(out[c]);
    g.out_mask[c] = mask[c];
  }
  g.n_streams = 3;
  g.len = k128;
  g.count = static_cast<int32_t*>(count);
  return launch_compact_streams(g, nullptr, H, P, s);
}
