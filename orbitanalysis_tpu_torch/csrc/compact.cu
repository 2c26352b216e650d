// Ordered event compaction for the aligned engine's step and the
// label-native detector's routes, hand-written for Hopper (sm_90a).
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
//
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
//
// The TPU splits K1/K2 and K4/K5 exist for VMEM and the 16-entry block
// fronts of the blocked network; here there is one exact ordered stream
// compaction with no occupancy limit, so nothing reroutes.  Design: one
// block per row, 1024 threads walking the row in tiles of 1024 entries.  In a tile,
// __ballot_sync + __popc give each event its rank inside its warp, warp
// 0 scans the 32 warp totals in shared memory, and a running base
// carries the count across tiles.  A row stops reading once its k128
// outputs are full.
//
// What bounds it on the H100: bytes.  Each entry is one coalesced u32
// read; the writes are sparse (events are a few percent of entries) and
// the zero fill is k128 words per row.  At the aligned step's shape of
// [64, 32768] the plane is 8 MB, 2.5 us at 3.35 TB/s, but one block per
// row fills only 64 of 132 SMs and each tile waits for its load and two
// barriers, so the kernel is latency-bound well above that floor.  That
// is accepted for bring-up; splitting rows over several blocks (with a
// decoupled look-back for the row base) is the way to the floor.
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

__global__ void __launch_bounds__(kThreads)
compact_pair_rows_kernel(const uint32_t* __restrict__ posw,
                         const uint32_t* __restrict__ angw,
                         uint32_t* __restrict__ out_pos,
                         uint32_t* __restrict__ out_ang, int P, int k128) {
  __shared__ int warp_off[kWarps];
  __shared__ int tile_total;
  const size_t row = blockIdx.x;
  const uint32_t* pin = posw + row * P;
  const uint32_t* ain = angw + row * P;
  uint32_t* op = out_pos + row * k128;
  uint32_t* oa = out_ang + row * k128;
  const int lane = threadIdx.x & 31;
  const uint32_t lanes_below = (1u << lane) - 1u;
  int base = 0;
  for (int start = 0; start < P && base < k128; start += kThreads) {
    const int i = start + threadIdx.x;
    const uint32_t w = i < P ? pin[i] : 0u;
    const bool sel = w != 0u;
    const uint32_t ballot = __ballot_sync(0xffffffffu, sel);
    int before, total;
    tile_offsets<kWarps>(__popc(ballot), warp_off, &tile_total, before, total);
    if (sel) {
      const int off = base + before + __popc(ballot & lanes_below);
      if (off < k128) {
        op[off] = w;
        oa[off] = ain[i];  // sparse read: only where an event fired
      }
    }
    base += total;
    __syncthreads();
  }
  for (int j = min(base, k128) + threadIdx.x; j < k128; j += kThreads) {
    op[j] = 0u;
    oa[j] = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
compact_payload_rows_kernel(const uint32_t* __restrict__ pay,
                            uint32_t* __restrict__ out, int P, int k128) {
  __shared__ int warp_off[kWarps];
  __shared__ int tile_total;
  const uint32_t* in = pay + static_cast<size_t>(blockIdx.x) * P;
  uint32_t* o = out + static_cast<size_t>(blockIdx.x) * k128;
  const int lane = threadIdx.x & 31;
  const uint32_t lanes_below = (1u << lane) - 1u;
  int base = 0;
  for (int start = 0; start < P && base < k128; start += kThreads) {
    const int i = start + threadIdx.x;
    const uint32_t w = i < P ? in[i] : 0u;
    const bool sel = w >= (1u << 15);
    const uint32_t ballot = __ballot_sync(0xffffffffu, sel);
    int before, total;
    tile_offsets<kWarps>(__popc(ballot), warp_off, &tile_total, before, total);
    if (sel) {
      const int off = base + before + __popc(ballot & lanes_below);
      if (off < k128) o[off] = w;
    }
    base += total;
    __syncthreads();
  }
  for (int j = min(base, k128) + threadIdx.x; j < k128; j += kThreads) o[j] = 0u;
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
  if (H > 0) {
    compact_pair_rows_kernel<<<H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(posw), static_cast<const uint32_t*>(angw),
        static_cast<uint32_t*>(out_pos), static_cast<uint32_t*>(out_ang), P, k128);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int compact_payload_rows(const void* pay, void* out, int H, int P,
                                    int k128, void* stream) {
  if (H > 0) {
    compact_payload_rows_kernel<<<H, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(pay), static_cast<uint32_t*>(out), P, k128);
  }
  return static_cast<int>(cudaGetLastError());
}
