// Native host-side ragged packing for the snapshot ingestion path.
//
// The PyTorch port's own copy of orbitanalysis_tpu/native/packing.cpp
// (the JAX package's twin), built with g++ by
// orbitanalysis_tpu_torch/native/__init__.py.
//
// The loader returns concatenated per-region blocks (the reference's
// region_offsets convention, orbitanalysis/track_orbits.py:52-54); the
// device engine wants a padded
// [n_rows, capacity] layout.  At 1e8-particle scale this scatter is the
// host-side bottleneck (BASELINE.json configs[4]); NumPy's fancy-index
// scatter is single-threaded, so this OpenMP version parallelizes over
// blocks.  Loaded via ctypes (no pybind11 binding); the Python
// fallback in utils/padding.py is semantically identical.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC packing.cpp -o _packing.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

#include <omp.h>

#ifdef __AVX512F__
#include <immintrin.h>
#endif

extern "C" {

// Pack ragged blocks into out[n_rows * capacity * elem] (pre-filled by
// the caller).  values: [total, elem] row-major; offsets[i] = start of
// block i (ascending); block i lands at row rows[i], columns 0..len-1.
// elem_bytes = bytes per element*elem (the innermost copy unit).
void pack_ragged_bytes(
    const uint8_t* values,
    const int64_t* offsets,   // n_blocks entries
    int64_t n_blocks,
    int64_t total,            // total rows in `values`
    const int64_t* rows,      // n_blocks target rows
    uint8_t* out,
    int64_t capacity,
    int64_t elem_bytes) {
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t start = offsets[b];
    const int64_t end = (b + 1 < n_blocks) ? offsets[b + 1] : total;
    const int64_t len = end - start;
    if (len <= 0) continue;
    std::memcpy(out + (rows[b] * capacity) * elem_bytes,
                values + start * elem_bytes,
                static_cast<size_t>(len) * elem_bytes);
  }
}

// Fill out[n] with the 4-byte pattern `fill` (sentinel init), parallel.
void fill_i32(int32_t* out, int64_t n, int32_t fill) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) out[i] = fill;
}

// Stable parallel counting sort of grid-cell keys — the O(N log N)
// single-threaded np.argsort in the region extractor's snapshot index
// (engine/regions.py) becomes O(N) multi-threaded.  keys[i] in
// [0, n_cells); outputs starts[n_cells+1] (CSR cell boundaries) and
// order[n] (particle indices grouped by cell, original order within a
// cell — matching np.argsort(kind="stable")).
void grid_count_sort(const int64_t* keys, int64_t n, int64_t n_cells,
                     int64_t* starts, int64_t* order) {
  // team size pinned on both regions (required for stability: the two
  // static-schedule loops must see identical per-thread index ranges,
  // and the scan below must visit exactly the teams that counted);
  // capped so per-thread histograms stay bounded on many-core hosts
  int nt = omp_get_max_threads();
  if (nt > 32) nt = 32;
  // per-thread histograms are n_cells * 8 bytes; a very fine grid
  // (n_cells >> n, user-supplied cell_size) would otherwise allocate
  // gigabytes of transient memory — bound the team by a byte budget
  const int64_t mem_nt = (512ll << 20) / (n_cells * 8 + 1);
  if (nt > mem_nt) nt = static_cast<int>(mem_nt);
  if (nt < 1) nt = 1;
  std::vector<std::vector<int64_t>> hist(nt);
  for (int t = 0; t < nt; ++t) hist[t].assign(n_cells, 0);
#pragma omp parallel num_threads(nt)
  {
    const int t = omp_get_thread_num();
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) ++hist[t][keys[i]];
  }
  // exclusive scan: cell-major, thread-minor — with schedule(static)
  // both passes see identical contiguous index ranges per thread, so
  // per-cell output runs are ordered by (thread, index) = stable
  int64_t run = 0;
  for (int64_t c = 0; c < n_cells; ++c) {
    starts[c] = run;
    for (int t = 0; t < nt; ++t) {
      const int64_t h = hist[t][c];
      hist[t][c] = run;
      run += h;
    }
  }
  starts[n_cells] = run;
#pragma omp parallel num_threads(nt)
  {
    const int t = omp_get_thread_num();
    auto& off = hist[t];
#pragma omp for schedule(static)
    for (int64_t i = 0; i < n; ++i) order[off[keys[i]]++] = i;
  }
}

// Stable-layout alignment for the aligned tracking engine (see
// engine/packing.py:StableLayout).  Per halo row (parallel over rows):
// match the front-packed load-order ids against the persistent layout
// via an open-addressing hash of the previous layout row (survivors
// keep their position), assign entrants to free positions in ascending
// position order, and scatter ids/pos/vel/mass straight into the
// stable positions — replacing the NumPy path's per-snapshot
// argsort + searchsorted + four fancy-index scatters (~1 s at 2M rows,
// single-threaded) with an O(P)-per-row multithreaded pass.
//
// In/out:
//   layout   [H, P] i32, in/out — persistent id-at-position table
//   ids      [H, P] i32 load-order front-packed (invalid-padded tail)
//   pos, vel [H, P, 3] f32 load-order; mass [H, P] f32 or null
//   ids_o, pos_o, vel_o, mass_o, slot_o — outputs in stable positions;
//   slot_o[h, j] = load index occupying position j, holes numbered
//   n_valid.. in position order (a permutation of [0, P) per row in
//   bits 0-23), with the FRESH flag in bit 27 at positions whose
//   tenant changed (an entrant, incl. reuse of a departure's hole) —
//   the carry-native detection kernel suppresses stale prev-carry
//   state from this flag alone, with no device-side ID compare.
// Returns the number of rows that overflowed (entrants > free
// positions — cannot happen while membership <= capacity).
//
// The numeric suffix versions the ABI (a stale prebuilt _packing.so is
// gitignored and survives source updates — it must fail the symbol
// lookup and rebuild rather than silently run old semantics): "2"
// added the FRESH bit to the slot contract; "3" added the `soa` flag;
// the "_i64" variant (wide particle IDs, e.g. Gadget uint64 remapped
// to int64) was added alongside without changing the i32 ABI.
//
// soa != 0: pos_o/vel_o are [3, H, P] coordinate planes (the layout
// the device engine consumes) instead of [H, P, 3] — the scatter
// writes the staged SoA form directly, so the caller needs no
// transpose pass and the host->device transfer reads contiguous
// memory.  Inputs stay [H, P, 3] (the loader's layout) either way.
// Output pointers are caller-provided and may be persistent buffers:
// rewriting them in place avoids the per-snapshot mmap/page-fault
// churn of fresh allocations (measured 5-10x swings on the staging
// loop).

}  // extern "C"

namespace {

// Fibonacci-style multiplicative hash, specialized per id width.
inline uint32_t id_hash(int32_t k) {
  return static_cast<uint32_t>(k) * 2654435761u;
}
inline uint32_t id_hash(int64_t k) {
  uint64_t x = static_cast<uint64_t>(k) * 0x9E3779B97F4A7C15ull;
  return static_cast<uint32_t>(x >> 32);
}

template <typename IdT>
int64_t stable_align_impl(
    IdT* layout,
    const IdT* ids,
    const float* pos,
    const float* vel,
    const float* mass,
    int64_t H,
    int64_t P,
    IdT invalid,
    IdT* ids_o,
    float* pos_o,
    float* vel_o,
    float* mass_o,
    int32_t* slot_o,
    int32_t soa) {
  // hash table size: first power of two >= 2P
  int64_t tsz = 1;
  while (tsz < 2 * P) tsz <<= 1;
  const uint32_t tmask = static_cast<uint32_t>(tsz - 1);
  int64_t overflowed = 0;
#pragma omp parallel reduction(+ : overflowed)
  {
    std::vector<IdT> hkey(tsz);
    std::vector<int32_t> hpos(tsz);
    std::vector<int32_t> dest(P);
    std::vector<uint8_t> claimed(P);
#pragma omp for schedule(dynamic, 1)
    for (int64_t h = 0; h < H; ++h) {
      const IdT* lay = layout + h * P;
      const IdT* id = ids + h * P;
      // build id -> position over the previous layout row
      std::fill(hkey.begin(), hkey.end(), invalid);
      for (int64_t j = 0; j < P; ++j) {
        const IdT k = lay[j];
        if (k == invalid) continue;
        uint32_t s = id_hash(k) & tmask;
        while (hkey[s] != invalid) s = (s + 1) & tmask;
        hkey[s] = k;
        hpos[s] = static_cast<int32_t>(j);
      }
      // survivors keep their position
      std::fill(claimed.begin(), claimed.end(), 0);
      int64_t n_valid = 0;
      for (int64_t i = 0; i < P; ++i) {
        const IdT k = id[i];
        if (k == invalid) {
          dest[i] = -1;
          continue;  // front-packed: could break, but stay tolerant
        }
        ++n_valid;
        uint32_t s = id_hash(k) & tmask;
        int32_t d = -1;
        while (hkey[s] != invalid) {
          if (hkey[s] == k) {
            d = hpos[s];
            break;
          }
          s = (s + 1) & tmask;
        }
        dest[i] = d;
        if (d >= 0) claimed[d] = 1;
      }
      // entrants fill free positions in ascending position order;
      // bit 30 marks the dest as an entrant's (-> FRESH in slot_o)
      int64_t free_j = 0;
      bool overflow = false;
      for (int64_t i = 0; i < P; ++i) {
        const IdT k = id[i];
        if (k == invalid || dest[i] >= 0) continue;
        while (free_j < P && claimed[free_j]) ++free_j;
        if (free_j == P) {
          overflow = true;
          break;
        }
        dest[i] = static_cast<int32_t>(free_j) | (1 << 30);
        claimed[free_j] = 1;
      }
      if (overflow) {
        ++overflowed;
        continue;  // row outputs undefined; caller raises
      }
      // scatter into stable positions; holes zero/invalid-filled
      IdT* lay_o = layout + h * P;
      IdT* io = ids_o + h * P;
      int32_t* so = slot_o + h * P;
      for (int64_t j = 0; j < P; ++j) {
        io[j] = invalid;
        so[j] = -1;
      }
      if (mass) std::memset(mass_o + h * P, 0, sizeof(float) * P);
      if (soa) {
        float* px = pos_o + h * P;
        float* py = pos_o + (H + h) * P;
        float* pz = pos_o + (2 * H + h) * P;
        float* vx = vel_o + h * P;
        float* vy = vel_o + (H + h) * P;
        float* vz = vel_o + (2 * H + h) * P;
        std::memset(px, 0, sizeof(float) * P);
        std::memset(py, 0, sizeof(float) * P);
        std::memset(pz, 0, sizeof(float) * P);
        std::memset(vx, 0, sizeof(float) * P);
        std::memset(vy, 0, sizeof(float) * P);
        std::memset(vz, 0, sizeof(float) * P);
        for (int64_t i = 0; i < P; ++i) {
          int32_t d = dest[i];
          if (d < 0) continue;
          const int32_t fresh = (d >> 30) & 1;
          d &= ~(1 << 30);
          io[d] = id[i];
          so[d] = static_cast<int32_t>(i) | (fresh << 27);
          px[d] = pos[(h * P + i) * 3];
          py[d] = pos[(h * P + i) * 3 + 1];
          pz[d] = pos[(h * P + i) * 3 + 2];
          vx[d] = vel[(h * P + i) * 3];
          vy[d] = vel[(h * P + i) * 3 + 1];
          vz[d] = vel[(h * P + i) * 3 + 2];
          if (mass) mass_o[h * P + d] = mass[h * P + i];
        }
      } else {
        float* po = pos_o + h * P * 3;
        float* vo = vel_o + h * P * 3;
        std::memset(po, 0, sizeof(float) * P * 3);
        std::memset(vo, 0, sizeof(float) * P * 3);
        for (int64_t i = 0; i < P; ++i) {
          int32_t d = dest[i];
          if (d < 0) continue;
          const int32_t fresh = (d >> 30) & 1;
          d &= ~(1 << 30);
          io[d] = id[i];
          so[d] = static_cast<int32_t>(i) | (fresh << 27);
          po[d * 3] = pos[(h * P + i) * 3];
          po[d * 3 + 1] = pos[(h * P + i) * 3 + 1];
          po[d * 3 + 2] = pos[(h * P + i) * 3 + 2];
          vo[d * 3] = vel[(h * P + i) * 3];
          vo[d * 3 + 1] = vel[(h * P + i) * 3 + 1];
          vo[d * 3 + 2] = vel[(h * P + i) * 3 + 2];
          if (mass) mass_o[h * P + d] = mass[h * P + i];
        }
      }
      // holes take the unused slot numbers in position order
      int32_t hole_slot = static_cast<int32_t>(n_valid);
      for (int64_t j = 0; j < P; ++j)
        if (so[j] < 0) so[j] = hole_slot++;
      // the new layout row IS the stable-position id row
      std::memcpy(lay_o, io, sizeof(IdT) * P);
    }
  }
  return overflowed;
}

// Unzip a [P, 8]-row AoS block (channels id, slot, px, py, pz, vx, vy,
// vz) into the output planes.  SOA=1: eight [P] planes; SOA=0: id/slot
// planes + [P, 3] AoS pos/vel.  AVX-512 path: 16 rows load as 8 zmm,
// two unpack stages + one cross-register permute yield 8 contiguous
// 16-float stores — ~3 ns/row vs ~5.5 scalar (lane order derived from
// the unpacklo/hi interleave pattern; verified element-exact against
// the scalar path in tests).
template <int SOA>
void unzip_rows8(const float* tmp, int64_t P, int32_t* io, int32_t* so,
                 float* px, float* py, float* pz, float* vx, float* vy,
                 float* vz) {
  int64_t j = 0;
#ifdef __AVX512F__
  // streaming stores need 64B-aligned targets; numpy only guarantees
  // 16.  P is a multiple of 128 floats on every engine path, so base
  // alignment decides for the whole row.
  const bool stream_ok =
      ((reinterpret_cast<uintptr_t>(io) | reinterpret_cast<uintptr_t>(so)
        | reinterpret_cast<uintptr_t>(px) | reinterpret_cast<uintptr_t>(py)
        | reinterpret_cast<uintptr_t>(pz) | reinterpret_cast<uintptr_t>(vx)
        | reinterpret_cast<uintptr_t>(vy) | reinterpret_cast<uintptr_t>(vz))
       & 63) == 0;
  if (SOA) {
    const __m512i I0 = _mm512_set_epi32(27, 19, 26, 18, 25, 17, 24, 16,
                                        11, 3, 10, 2, 9, 1, 8, 0);
    const __m512i I4 = _mm512_set_epi32(31, 23, 30, 22, 29, 21, 28, 20,
                                        15, 7, 14, 6, 13, 5, 12, 4);
    for (; j + 16 <= P; j += 16) {
      const float* t = tmp + j * 8;
      __m512 a0 = _mm512_loadu_ps(t);
      __m512 a1 = _mm512_loadu_ps(t + 16);
      __m512 a2 = _mm512_loadu_ps(t + 32);
      __m512 a3 = _mm512_loadu_ps(t + 48);
      __m512 a4 = _mm512_loadu_ps(t + 64);
      __m512 a5 = _mm512_loadu_ps(t + 80);
      __m512 a6 = _mm512_loadu_ps(t + 96);
      __m512 a7 = _mm512_loadu_ps(t + 112);
      __m512 b0 = _mm512_unpacklo_ps(a0, a1);
      __m512 b1 = _mm512_unpackhi_ps(a0, a1);
      __m512 b2 = _mm512_unpacklo_ps(a2, a3);
      __m512 b3 = _mm512_unpackhi_ps(a2, a3);
      __m512 b4 = _mm512_unpacklo_ps(a4, a5);
      __m512 b5 = _mm512_unpackhi_ps(a4, a5);
      __m512 b6 = _mm512_unpacklo_ps(a6, a7);
      __m512 b7 = _mm512_unpackhi_ps(a6, a7);
#define OA_UPD(lo, x, y) \
  _mm512_castpd_ps(lo(_mm512_castps_pd(x), _mm512_castps_pd(y)))
      __m512 c0 = OA_UPD(_mm512_unpacklo_pd, b0, b2);
      __m512 c1 = OA_UPD(_mm512_unpackhi_pd, b0, b2);
      __m512 c2 = OA_UPD(_mm512_unpacklo_pd, b1, b3);
      __m512 c3 = OA_UPD(_mm512_unpackhi_pd, b1, b3);
      __m512 c4 = OA_UPD(_mm512_unpacklo_pd, b4, b6);
      __m512 c5 = OA_UPD(_mm512_unpackhi_pd, b4, b6);
      __m512 c6 = OA_UPD(_mm512_unpacklo_pd, b5, b7);
      __m512 c7 = OA_UPD(_mm512_unpackhi_pd, b5, b7);
#undef OA_UPD
      // streaming stores when aligned: the planes are consumed by the
      // device DMA / a later sequential pass, never re-read here —
      // skipping the RFO halves the output's DRAM traffic
      if (stream_ok) {
        _mm512_stream_ps(reinterpret_cast<float*>(io) + j,
                         _mm512_permutex2var_ps(c0, I0, c4));
        _mm512_stream_ps(reinterpret_cast<float*>(so) + j,
                         _mm512_permutex2var_ps(c1, I0, c5));
        _mm512_stream_ps(px + j, _mm512_permutex2var_ps(c2, I0, c6));
        _mm512_stream_ps(py + j, _mm512_permutex2var_ps(c3, I0, c7));
        _mm512_stream_ps(pz + j, _mm512_permutex2var_ps(c0, I4, c4));
        _mm512_stream_ps(vx + j, _mm512_permutex2var_ps(c1, I4, c5));
        _mm512_stream_ps(vy + j, _mm512_permutex2var_ps(c2, I4, c6));
        _mm512_stream_ps(vz + j, _mm512_permutex2var_ps(c3, I4, c7));
      } else {
        _mm512_storeu_ps(reinterpret_cast<float*>(io) + j,
                         _mm512_permutex2var_ps(c0, I0, c4));
        _mm512_storeu_ps(reinterpret_cast<float*>(so) + j,
                         _mm512_permutex2var_ps(c1, I0, c5));
        _mm512_storeu_ps(px + j, _mm512_permutex2var_ps(c2, I0, c6));
        _mm512_storeu_ps(py + j, _mm512_permutex2var_ps(c3, I0, c7));
        _mm512_storeu_ps(pz + j, _mm512_permutex2var_ps(c0, I4, c4));
        _mm512_storeu_ps(vx + j, _mm512_permutex2var_ps(c1, I4, c5));
        _mm512_storeu_ps(vy + j, _mm512_permutex2var_ps(c2, I4, c6));
        _mm512_storeu_ps(vz + j, _mm512_permutex2var_ps(c3, I4, c7));
      }
    }
    _mm_sfence();  // order streaming stores before the caller reads
  }
#endif
  for (; j < P; ++j) {
    const float* t = tmp + j * 8;
    std::memcpy(&io[j], &t[0], 4);
    std::memcpy(&so[j], &t[1], 4);
    if (SOA) {
      px[j] = t[2];
      py[j] = t[3];
      pz[j] = t[4];
      vx[j] = t[5];
      vy[j] = t[6];
      vz[j] = t[7];
    } else {
      std::memcpy(px + j * 3, t + 2, 12);  // [P, 3] pos
      std::memcpy(vx + j * 3, t + 5, 12);  // [P, 3] vel
    }
  }
}

// ----------------------------------------------------------------------
// Throughput-tuned i32 alignment — the hot staging path (the aligned
// engine's host tier runs this once per snapshot on the ingest
// critical path).  Same semantics as stable_align_impl, ~3x fewer
// cycles/row:
//
//   * fused hash entries: one u64 load per probe — key in bits 32-63,
//     position in bits 12-31, a 12-bit generation tag in bits 0-11 —
//     instead of two array loads; the generation tag retires the
//     per-row sentinel refill (the table is reused across rows, an
//     entry is live iff the tag matches, and the 512 KB refill runs
//     once per 4095 generations instead of every row).
//   * software prefetch: the probe/build loops touch one random L2
//     line per id; hashing 16 ids ahead and prefetching hides the
//     latency chain that dominated the generic version.
//   * survivors scatter INSIDE the probe loop, as ONE 32-byte AoS row
//     [id, slot, px, py, pz, vx, vy, vz] assembled in SIMD registers
//     and stored into an L2-resident [P, 8] block (one line per two
//     destinations) — instead of 8 scattered 4-byte writes across 8
//     power-of-two-apart planes (set-conflict-prone, 8 RFOs per
//     particle: measured 23.5 ns/row vs ~3 for this form); a SIMD
//     unzip (unzip_rows8) then emits the planes with contiguous
//     stores.  Only holes are zero-filled (the generic version
//     zero-initialized every plane before scattering over 90 % of it).
//   * sequence mode (stable_align_seq1): rows iterate h-major over a
//     whole [S]-stacked batch, so the table persists across snapshots
//     and is maintained *incrementally* — tombstone the departed,
//     insert the entrants (~2 x churn updates/row) — instead of
//     rebuilt from scratch every snapshot; rebuilds fire only when
//     tombstones exceed tsz/4.

constexpr uint64_t ALIGN_GEN_MASK = 0xFFFull;
constexpr uint32_t ALIGN_TOMB_KEY = 0xFFFFFFFFu;  // ids are >= 0

struct AlignCtx {
  std::vector<uint64_t> table;
  std::vector<int32_t> entrants;
  std::vector<uint8_t> claimed;
  std::vector<float> tmp_store;
  float* tmp = nullptr;
  uint32_t tmask = 0;
  uint32_t gen = 0;
  int64_t tombs = 0;
  int64_t P = 0;

  void init(int64_t P_) {
    P = P_;
    int64_t tsz = 1;
    while (tsz < 2 * P) tsz <<= 1;
    tmask = static_cast<uint32_t>(tsz - 1);
    table.assign(tsz, 0);
    gen = 0;
    entrants.resize(P);
    claimed.resize(P);
    tmp_store.resize(P * 8 + 16);
    tmp = reinterpret_cast<float*>(
        (reinterpret_cast<uintptr_t>(tmp_store.data()) + 63)
        & ~static_cast<uintptr_t>(63));
  }

  // start a fresh generation and build id -> position over `lay`
  void rebuild(const int32_t* lay, int32_t invalid) {
    if (++gen > ALIGN_GEN_MASK) {
      std::fill(table.begin(), table.end(), 0);
      gen = 1;
    }
    tombs = 0;
    constexpr int64_t PF = 16;
    for (int64_t j = 0; j < P; ++j) {
      if (j + PF < P) {
        const int32_t kp = lay[j + PF];
        if (kp != invalid)
          __builtin_prefetch(&table[id_hash(kp) & tmask], 1, 1);
      }
      const int32_t k = lay[j];
      if (k == invalid) continue;
      uint32_t s = id_hash(k) & tmask;
      while ((table[s] & ALIGN_GEN_MASK) == gen) s = (s + 1) & tmask;
      table[s] = (static_cast<uint64_t>(static_cast<uint32_t>(k)) << 32)
                 | (static_cast<uint64_t>(j) << 12) | gen;
    }
  }

  // tombstone a departed key (must be present)
  inline void erase(int32_t k) {
    uint32_t s = id_hash(k) & tmask;
    for (;;) {
      const uint64_t e = table[s];
      if ((e & ALIGN_GEN_MASK) != gen) return;  // absent (shouldn't be)
      if (static_cast<uint32_t>(e >> 32) == static_cast<uint32_t>(k)) {
        table[s] = (static_cast<uint64_t>(ALIGN_TOMB_KEY) << 32) | gen;
        ++tombs;
        return;
      }
      s = (s + 1) & tmask;
    }
  }

  // insert a new key (known absent); reuses tombstone slots
  inline void insert(int32_t k, int64_t pos_j) {
    uint32_t s = id_hash(k) & tmask;
    for (;;) {
      const uint64_t e = table[s];
      const bool live = (e & ALIGN_GEN_MASK) == gen;
      if (!live) break;
      if (static_cast<uint32_t>(e >> 32) == ALIGN_TOMB_KEY) {
        --tombs;
        break;
      }
      s = (s + 1) & tmask;
    }
    table[s] = (static_cast<uint64_t>(static_cast<uint32_t>(k)) << 32)
               | (static_cast<uint64_t>(pos_j) << 12) | gen;
  }
};

// One 32-byte AoS tmp row from the load-order streams.
static inline void scatter_row(float* t, int32_t k, int32_t sv,
                               const float* p3, const float* v3) {
  std::memcpy(&t[0], &k, 4);
  std::memcpy(&t[1], &sv, 4);
  t[2] = p3[0];
  t[3] = p3[1];
  t[4] = p3[2];
  t[5] = v3[0];
  t[6] = v3[1];
  t[7] = v3[2];
}

// Align one halo row (one snapshot) against ctx's live table.
// INCR = false: caller rebuilt the table for this row's layout; the
// table is NOT maintained afterwards.  INCR = true: the table is
// updated in place (erase departed / insert entrants) so the next
// snapshot of the same row can reuse it.  Returns false on overflow
// (row outputs undefined).
template <int SOA, bool HAS_MASS, bool INCR>
bool align_row_i32(AlignCtx& cx, int32_t* lay, const int32_t* id,
                   const float* prow, const float* vrow,
                   const float* mrow, int32_t invalid, int32_t* io,
                   int32_t* so, float* px, float* py, float* pz,
                   float* vx, float* vy, float* vz, float* mo) {
  const int64_t P = cx.P;
  const uint32_t tmask = cx.tmask;
  const uint32_t gen = cx.gen;
  uint64_t* table = cx.table.data();
  uint8_t* claimed = cx.claimed.data();
  int32_t* entrants = cx.entrants.data();
  float* tmp = cx.tmp;
  constexpr int64_t PF = 16;

  std::memset(claimed, 0, static_cast<size_t>(P));
  int64_t n_entered = 0;
  int64_t n_valid = 0;
  // fused probe + survivor scatter
  for (int64_t i = 0; i < P; ++i) {
    if (i + PF < P) {
      const int32_t kp = id[i + PF];
      if (kp != invalid)
        __builtin_prefetch(&table[id_hash(kp) & tmask], 0, 1);
    }
    const int32_t k = id[i];
    if (k == invalid) continue;  // front-packed; stay tolerant
    ++n_valid;
    uint32_t s = id_hash(k) & tmask;
    int64_t d = -1;
    for (;;) {
      const uint64_t e = table[s];
      if ((e & ALIGN_GEN_MASK) != gen) break;  // empty
      if (static_cast<uint32_t>(e >> 32) == static_cast<uint32_t>(k)) {
        d = static_cast<int64_t>((e >> 12) & 0xFFFFFull);
        break;
      }
      s = (s + 1) & tmask;
    }
    if (d < 0) {
      entrants[n_entered++] = static_cast<int32_t>(i);
      continue;
    }
    claimed[d] = 1;
#ifdef __AVX512F__
    if (i > 0 && i + 1 < P) {
      // [id, sv, p0, p1 | p2, v0, v1, v2] via two unaligned 16B loads
      // (i > 0 and i < P-1 keep the off-by-one loads in bounds)
      __m128 ip = _mm_castsi128_ps(
          _mm_insert_epi32(_mm_cvtsi32_si128(k), static_cast<int>(i), 1));
      __m128 plo = _mm_loadu_ps(prow + i * 3);       // p0 p1 p2 ?
      __m128 lo = _mm_movelh_ps(ip, plo);            // id sv p0 p1
      __m128 hi = _mm_loadu_ps(vrow + i * 3 - 1);    // ? v0 v1 v2
      hi = _mm_move_ss(hi, _mm_load_ss(prow + i * 3 + 2));
      _mm256_store_ps(tmp + d * 8, _mm256_set_m128(hi, lo));
    } else
#endif
    {
      scatter_row(tmp + d * 8, k, static_cast<int32_t>(i),
                  prow + i * 3, vrow + i * 3);
    }
    if (HAS_MASS) mo[d] = mrow[i];
  }
  if (INCR) {
    // departures: positions whose live tenant was not re-claimed
    for (int64_t j = 0; j < P; ++j) {
      const int32_t k = lay[j];
      if (k != invalid && !claimed[j]) cx.erase(k);
    }
  }
  // entrants fill free positions in ascending position order
  int64_t free_j = 0;
  for (int64_t e = 0; e < n_entered; ++e) {
    while (free_j < P && claimed[free_j]) ++free_j;
    if (free_j == P) return false;  // overflow; caller raises
    const int64_t i = entrants[e];
    const int64_t d = free_j;
    claimed[d] = 1;
    ++free_j;
    const int32_t k = id[i];
    scatter_row(tmp + d * 8, k,
                static_cast<int32_t>(i) | (1 << 27),  // FRESH
                prow + i * 3, vrow + i * 3);
    if (HAS_MASS) mo[d] = mrow[i];
    if (INCR) cx.insert(k, d);
  }
  // holes complete the tmp block (unused slot numbers in position
  // order), so the unzip below runs unconditionally
  int32_t hole_slot = static_cast<int32_t>(n_valid);
  for (int64_t j = 0; j < P; ++j) {
    if (claimed[j]) continue;
    float* t = tmp + j * 8;
    std::memcpy(&t[0], &invalid, 4);
    std::memcpy(&t[1], &hole_slot, 4);
    ++hole_slot;
    t[2] = t[3] = t[4] = t[5] = t[6] = t[7] = 0.0f;
    if (HAS_MASS) mo[j] = 0.0f;
  }
  unzip_rows8<SOA>(tmp, P, io, so, px, py, pz, vx, vy, vz);
  std::memcpy(lay, io, sizeof(int32_t) * P);
  return true;
}

template <int SOA, bool HAS_MASS>
int64_t stable_align_fast_i32(
    int32_t* layout, const int32_t* ids, const float* pos,
    const float* vel, const float* mass, int64_t H, int64_t P,
    int32_t invalid, int32_t* ids_o, float* pos_o, float* vel_o,
    float* mass_o, int32_t* slot_o) {
  int64_t overflowed = 0;
#pragma omp parallel reduction(+ : overflowed)
  {
    AlignCtx cx;
    cx.init(P);
#pragma omp for schedule(dynamic, 1)
    for (int64_t h = 0; h < H; ++h) {
      int32_t* lay = layout + h * P;
      float *px, *py, *pz, *vx, *vy, *vz;
      if (SOA) {
        px = pos_o + h * P;
        py = pos_o + (H + h) * P;
        pz = pos_o + (2 * H + h) * P;
        vx = vel_o + h * P;
        vy = vel_o + (H + h) * P;
        vz = vel_o + (2 * H + h) * P;
      } else {
        px = pos_o + h * P * 3;
        vx = vel_o + h * P * 3;
        py = pz = vy = vz = nullptr;
      }
      cx.rebuild(lay, invalid);
      if (!align_row_i32<SOA, HAS_MASS, false>(
              cx, lay, ids + h * P, pos + h * P * 3, vel + h * P * 3,
              HAS_MASS ? mass + h * P : nullptr, invalid,
              ids_o + h * P, slot_o + h * P, px, py, pz, vx, vy, vz,
              HAS_MASS ? mass_o + h * P : nullptr))
        ++overflowed;
    }
  }
  return overflowed;
}

// Whole-sequence alignment: ids [S, H, P], pos/vel [S, H, P, 3] load
// order; outputs ids_o/slot_o [S, H, P], pos_o/vel_o [S, 3, H, P]
// (soa) or [S, H, P, 3].  Rows iterate h-major so each row's table
// persists across the S snapshots and updates incrementally.
template <int SOA, bool HAS_MASS>
int64_t stable_align_seq_i32(
    int32_t* layout, const int32_t* ids, const float* pos,
    const float* vel, const float* mass, int64_t S, int64_t H,
    int64_t P, int32_t invalid, int32_t* ids_o, float* pos_o,
    float* vel_o, float* mass_o, int32_t* slot_o) {
  const int64_t tsz_quarter = [&] {
    int64_t tsz = 1;
    while (tsz < 2 * P) tsz <<= 1;
    return tsz / 4;
  }();
  int64_t overflowed = 0;
#pragma omp parallel reduction(+ : overflowed)
  {
    AlignCtx cx;
    cx.init(P);
#pragma omp for schedule(dynamic, 1)
    for (int64_t h = 0; h < H; ++h) {
      int32_t* lay = layout + h * P;
      bool built = false;
      for (int64_t s = 0; s < S; ++s) {
        if (!built || cx.tombs > tsz_quarter) {
          cx.rebuild(lay, invalid);
          built = true;
        }
        const int64_t sh = s * H + h;
        float *px, *py, *pz, *vx, *vy, *vz;
        if (SOA) {
          px = pos_o + (s * 3 * H + h) * P;
          py = pos_o + ((s * 3 + 1) * H + h) * P;
          pz = pos_o + ((s * 3 + 2) * H + h) * P;
          vx = vel_o + (s * 3 * H + h) * P;
          vy = vel_o + ((s * 3 + 1) * H + h) * P;
          vz = vel_o + ((s * 3 + 2) * H + h) * P;
        } else {
          px = pos_o + sh * P * 3;
          vx = vel_o + sh * P * 3;
          py = pz = vy = vz = nullptr;
        }
        if (!align_row_i32<SOA, HAS_MASS, true>(
                cx, lay, ids + sh * P, pos + sh * P * 3,
                vel + sh * P * 3, HAS_MASS ? mass + sh * P : nullptr,
                invalid, ids_o + sh * P, slot_o + sh * P, px, py, pz,
                vx, vy, vz, HAS_MASS ? mass_o + sh * P : nullptr)) {
          ++overflowed;
          break;  // row outputs undefined from here; caller raises
        }
      }
    }
  }
  return overflowed;
}

}  // namespace

extern "C" {

// Fast-path ABI: identical contract to stable_align3, specialized i32
// inner loops (see stable_align_fast_i32).  Rows wider than the 20-bit
// position budget fall back to the generic implementation.
int64_t stable_align5(
    int32_t* layout, const int32_t* ids, const float* pos,
    const float* vel, const float* mass, int64_t H, int64_t P,
    int32_t invalid, int32_t* ids_o, float* pos_o, float* vel_o,
    float* mass_o, int32_t* slot_o, int32_t soa) {
  if (P >= (1 << 20))
    return stable_align_impl<int32_t>(layout, ids, pos, vel, mass, H, P,
                                      invalid, ids_o, pos_o, vel_o,
                                      mass_o, slot_o, soa);
  if (soa) {
    if (mass)
      return stable_align_fast_i32<1, true>(layout, ids, pos, vel, mass,
                                            H, P, invalid, ids_o, pos_o,
                                            vel_o, mass_o, slot_o);
    return stable_align_fast_i32<1, false>(layout, ids, pos, vel, mass,
                                           H, P, invalid, ids_o, pos_o,
                                           vel_o, mass_o, slot_o);
  }
  if (mass)
    return stable_align_fast_i32<0, true>(layout, ids, pos, vel, mass,
                                          H, P, invalid, ids_o, pos_o,
                                          vel_o, mass_o, slot_o);
  return stable_align_fast_i32<0, false>(layout, ids, pos, vel, mass,
                                         H, P, invalid, ids_o, pos_o,
                                         vel_o, mass_o, slot_o);
}

// Whole-sequence fast path: [S]-stacked inputs/outputs, h-major row
// iteration with incrementally maintained per-row tables (see
// stable_align_seq_i32).  Same per-snapshot semantics as repeated
// stable_align5 calls; `layout` ends in the post-final-snapshot state.
int64_t stable_align_seq1(
    int32_t* layout, const int32_t* ids, const float* pos,
    const float* vel, const float* mass, int64_t S, int64_t H,
    int64_t P, int32_t invalid, int32_t* ids_o, float* pos_o,
    float* vel_o, float* mass_o, int32_t* slot_o, int32_t soa) {
  if (P >= (1 << 20)) {
    // generic fallback, one snapshot at a time
    int64_t overflowed = 0;
    for (int64_t s = 0; s < S; ++s) {
      const int64_t sh = s * H;
      overflowed += stable_align_impl<int32_t>(
          layout, ids + sh * P, pos + sh * P * 3, vel + sh * P * 3,
          mass ? mass + sh * P : nullptr, H, P, invalid,
          ids_o + sh * P,
          pos_o + (soa ? s * 3 * H * P : sh * P * 3),
          vel_o + (soa ? s * 3 * H * P : sh * P * 3),
          mass ? mass_o + sh * P : nullptr, slot_o + sh * P, soa);
    }
    return overflowed;
  }
  if (soa) {
    if (mass)
      return stable_align_seq_i32<1, true>(layout, ids, pos, vel, mass,
                                           S, H, P, invalid, ids_o,
                                           pos_o, vel_o, mass_o, slot_o);
    return stable_align_seq_i32<1, false>(layout, ids, pos, vel, mass,
                                          S, H, P, invalid, ids_o,
                                          pos_o, vel_o, mass_o, slot_o);
  }
  if (mass)
    return stable_align_seq_i32<0, true>(layout, ids, pos, vel, mass,
                                         S, H, P, invalid, ids_o,
                                         pos_o, vel_o, mass_o, slot_o);
  return stable_align_seq_i32<0, false>(layout, ids, pos, vel, mass,
                                        S, H, P, invalid, ids_o,
                                        pos_o, vel_o, mass_o, slot_o);
}

int64_t stable_align3(
    int32_t* layout, const int32_t* ids, const float* pos,
    const float* vel, const float* mass, int64_t H, int64_t P,
    int32_t invalid, int32_t* ids_o, float* pos_o, float* vel_o,
    float* mass_o, int32_t* slot_o, int32_t soa) {
  return stable_align_impl<int32_t>(layout, ids, pos, vel, mass, H, P,
                                    invalid, ids_o, pos_o, vel_o, mass_o,
                                    slot_o, soa);
}

// Wide-ID variant: int64 layout/ids (e.g. Gadget uint64 IDs remapped to
// int64 by the loader); the f32 payload and the i32 slot contract are
// identical.  The device engine never sees these IDs — the aligned
// layout is positional, so the device streams a 32-bit position
// surrogate and the tracker maps event positions back through the
// staged ID table (engine/tracker.py).
int64_t stable_align3_i64(
    int64_t* layout, const int64_t* ids, const float* pos,
    const float* vel, const float* mass, int64_t H, int64_t P,
    int64_t invalid, int64_t* ids_o, float* pos_o, float* vel_o,
    float* mass_o, int32_t* slot_o, int32_t soa) {
  return stable_align_impl<int64_t>(layout, ids, pos, vel, mass, H, P,
                                    invalid, ids_o, pos_o, vel_o, mass_o,
                                    slot_o, soa);
}

}  // extern "C"
