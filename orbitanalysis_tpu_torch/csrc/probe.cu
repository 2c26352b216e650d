// The stream probes, hand-written for Hopper (sm_90a): what the card
// streams, for the I/O shapes the port's kernels are held to.
//
// Replaces the TPU kernels of the JAX package's probe scripts:
//   P1 benchmarks/dma_probe.py auto_variant   (pallas_call :68)
//      -> stream_add_rows below
//   P2 benchmarks/dma_probe.py manual_variant (pallas_call :144)
//      -> stream_add_ring below
//   P3 benchmarks/dma_probe.py split_variant  (pallas_call :244)
//      -> stream_add_split below
//   P4 benchmarks/detect_probe.py run_stream.copy_kernel
//      (pallas_call :138) -> detect_stream_rows below
//
// P1-P3 compute y = x + 1 over a contiguous f32 tensor; every output
// element is written (the TPU grid of r // block_rows blocks left the
// last rows of a plane undefined).  What bounds them on the H100:
// bytes, 8 B an element (each input read once, each output written
// once, 1,073,741,824 B at the probe's [2048, 65536] plane), so each is
// held to torch's own x + 1 on the same planes.  By Little's law the
// card's 3.35 TB/s over ~1 us of memory latency needs ~25 KB of loads
// in flight an SM; P1-P3 keep more than that on every SM.
//   stream_add_rows: the TPU's automatic pipeline over row blocks (one
//     grid step a block of block_rows rows) becomes a grid of the card:
//     the blocks of kRowsThreads threads that fit every SM at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x the SMs: one
//     1024-thread block an SM, as the kernel holds more than 32
//     registers a thread),
//     capped by the work, whatever block_rows is.  The flat tensor is
//     cut into units of one 16-byte vector a thread, and block b takes
//     units b, b + grid, b + 2 grid, ...: every block's share is within
//     one vector a thread of every other's (ops/_cuda.py rows_share
//     states the same), and the blocks sweep the tensor together.  Each
//     thread keeps kRowsUnroll streaming 16-byte loads (__ldcs) in
//     flight, 64 KiB an SM, and issues the next ones before it stores
//     (__stcs) the current ones.  Measured (detect_variants.py P1): a
//     persistent grid, whatever its shape, shares or hints, stays ~4 %
//     above torch's x + 1, which launches one short block a 4 KiB chunk;
//     the same loads on such a grid of the work match it.
//   stream_add_ring: the single-program rotating VMEM ring becomes a
//     warp-specialised in-place ring in each block: as many blocks an
//     SM as their rings fit in its 228 KB (ops/_cuda.py ring_plan: six
//     at 32 KiB rings, three at 64 KiB, one at 128 KiB), so 64 to 192
//     KiB of loads can be in flight an SM.  One producer thread (warp
//     0) claims the next stages from a global counter (zeroed on the
//     stream before each launch), as the compactions take their tiles,
//     so a fast SM takes more stages and the kernel ends when the work
//     does; a claim is at least 8 KiB (two stages of 4 KiB: ring_claim),
//     which halves the atomics on the one counter where stages are
//     small.  It tags the slot with the stage and fills it by one TMA
//     bulk copy (cp.async.bulk global->shared, completing on the slot's
//     full mbarrier with complete_tx).  The kRingComputeWarps compute
//     warps add 1 in place and arrive on the slot's done mbarrier; one
//     store thread (warp 1) stores the slot back by one cp.async.bulk
//     shared->global and, as on the TPU (dma_probe.py:116-121), frees
//     the slot for its next load only once cp.async.bulk.wait_group.read
//     shows that the slot's own store has read it out.  No block-wide
//     barrier after the set-up; a claim past the last stage tags the
//     slot -1, which ends every warp.
//   stream_add_split: the TPU's separate in and out VMEM buffers become
//     a warp-specialised TMA pipeline over an in ring and an out ring
//     of NBUF slots, with no block-wide barrier after the set-up.  One
//     producer thread (warp 0) keeps bulk loads in flight into the in
//     ring, n_dma copies a stage over disjoint sub-ranges, each slot
//     gated by an empty mbarrier on which the compute warps arrive once
//     they have read it; the kSplitComputeWarps compute warps add 1 from
//     an in slot to its out slot and arrive on the slot's full
//     mbarrier; one store thread (warp 1) issues the stage's n_dma bulk
//     stores and, before it hands an out slot back to the compute warps,
//     waits (cp.async.bulk.wait_group.read) until that slot's own store
//     has read it out, as the JAX split variant does
//     (dma_probe.py:219-224).  Bulk copies carry an L2 evict-first
//     policy: no byte is read twice.  One or two blocks an SM, as many
//     as their rings fit in its 228 KB (ops/_cuda.py split_plan).
//     Measured (detect_variants.py P3): ~3.7 % above torch's x + 1 at
//     every JAX variant, 4 to 16 compute warps, lags 0 and 1 and stages
//     of chunk_rows x 256 to 768 B alike; without the L2 policy ~1 %
//     slower.  Like P1, a persistent grid sets the pace.
// A JAX chunk of chunk_rows rows of 256 KiB does not fit the 227 KiB of
// shared memory a block has; the wrappers pass a stage of chunk_rows x
// 512 bytes (1/512 of the chunk), so every ring of the probe's variants
// is 32 to 128 KiB (two rings for split) and NBUF is the TPU's n_buf.
//
// P4 has the label detect kernel K9's streams (label.cu
// detect_label_rows, f32 r-hat): per particle of the [R, W] planes it
// reads rows [6, R, W] f32 (all six planes, as the TPU BlockSpec at
// detect_probe.py:149 reads them, though only planes 0 and 3 are used:
// volatile loads keep the other four), lab, sv, pk [R, W] i32, pos,
// vel, rh [3, R, W] f32, 72 B, and writes osv = sv + lab, orh = rh,
// opk = pk, opay = bits(rows[0] + pos[0] + pos[1] + pos[2] + vel[0] +
// vel[1] + vel[2] + rows[3]) (f32 adds in that order, exact: adds only,
// and the build passes --fmad=false), 24 B, and ocnt[R] = the row sums
// of lab: a block reduction and one int32 atomicAdd a block, which is
// order-free for integers, so no float atomics (ocnt must arrive
// zeroed).  Bound on the H100: bytes, 96 B a particle (201.3 MB at the
// bench shape [64, 32768]).  One 256-thread block a 4096-particle tile
// of a row, 16-byte vector loads and stores.

#include "common.cuh"

namespace {

constexpr int kRowsThreads = 1024;
constexpr int kRowsUnroll = 4;  // 16-byte loads in flight a thread
constexpr int kRingComputeWarps = 4;
constexpr int kRingThreads = 32 * (2 + kRingComputeWarps);
constexpr int kRingCompute = 32 * kRingComputeWarps;
// Stores that may still be reading their slots when P2's store thread
// hands the oldest one back (at most NBUF - 1): none from four slots up,
// each slot freed as soon as its own store has read it; one at two
// slots, so the store thread does not wait on the store it just issued
// (detect_variants.py P2).
template <int NBUF>
constexpr int kRingLag = NBUF > 2 ? 0 : 1;
constexpr int kSplitComputeWarps = 8;
constexpr int kSplitThreads = 32 * (2 + kSplitComputeWarps);
constexpr int kSplitCompute = 32 * kSplitComputeWarps;
// Out stages whose stores may still be reading their slot when the store
// thread hands the oldest one back (at most NBUF - 1).
constexpr int kSplitLag = 1;
constexpr int kDetectThreads = 256;
constexpr int kDetectVecs = 4;  // float4s a thread: 4096 particles a block

// v[u] = p[u * stride] for u < left.
__device__ __forceinline__ void load_rows(float4 (&v)[kRowsUnroll], const float4* p,
                                          long long stride, int left) {
#pragma unroll
  for (int u = 0; u < kRowsUnroll; ++u) {
    if (u < left) v[u] = __ldcs(p);
    p += stride;
  }
}

// p[u * stride] = v[u] + 1 for u < left.
__device__ __forceinline__ void store_rows(float4* p, const float4 (&v)[kRowsUnroll],
                                           long long stride, int left) {
#pragma unroll
  for (int u = 0; u < kRowsUnroll; ++u) {
    if (u < left)
      __stcs(p, make_float4(v[u].x + 1.0f, v[u].y + 1.0f, v[u].z + 1.0f, v[u].w + 1.0f));
    p += stride;
  }
}

// Block b takes units b, b + grid, b + 2 grid, ... of the ceil(n_vecs /
// kRowsThreads) units of one vector a thread, so the blocks sweep the
// tensor together; thread t holds the vectors (b + k grid) kRowsThreads
// + t, and loads the next kRowsUnroll of them before it stores the
// current ones.
__global__ void __launch_bounds__(kRowsThreads)
stream_add_rows_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                       long long n_vecs) {
  const long long first = static_cast<long long>(blockIdx.x) * kRowsThreads + threadIdx.x;
  if (first >= n_vecs) return;
  const long long stride = static_cast<long long>(gridDim.x) * kRowsThreads;
  const int count = static_cast<int>((n_vecs - 1 - first) / stride) + 1;
  const float4* xp = x + first;
  float4* yp = y + first;
  float4 cur[kRowsUnroll];
  load_rows(cur, xp, stride, count);
  for (int k = 0; k < count; k += kRowsUnroll) {
    xp += kRowsUnroll * stride;
    float4 next[kRowsUnroll];
    load_rows(next, xp, stride, count - k - kRowsUnroll);
    store_rows(yp, cur, stride, count - k);
    yp += kRowsUnroll * stride;
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) cur[u] = next[u];
  }
}

// --- TMA bulk copies and mbarriers (PTX) -----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed store groups still
// have to read their shared-memory source.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's generic-proxy writes to shared memory visible to
// the bulk copies (the async proxy) that read it next.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// An L2 policy that evicts the lines it touches first: for bytes that
// are never read again.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// bulk_load and bulk_store with an L2 cache policy.
__device__ __forceinline__ void bulk_load_l2(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar,
                                             uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store_l2(void* dst, uint32_t src,
                                              uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(dst),
      "r"(src), "r"(bytes), "l"(policy)
      : "memory");
}

// The stages of one split block: stage g covers bytes [g * stage, g *
// stage + size) of the flat tensor, the last one shorter, and goes to
// block g % grid.
struct Stages {
  long long n_bytes;
  int stage;
  __device__ long long first() const { return blockIdx.x; }
  __device__ int count() const {
    const long long n = (n_bytes + stage - 1) / stage;
    return first() < n ? static_cast<int>((n - 1 - first()) / gridDim.x + 1) : 0;
  }
  __device__ long long offset(int j) const {
    return (first() + static_cast<long long>(j) * gridDim.x) * stage;
  }
  __device__ uint32_t size(int j) const {
    return static_cast<uint32_t>(min(static_cast<long long>(stage), n_bytes - offset(j)));
  }
};

// P2's barriers and stage tags, NBUF of each: a slot is full (the
// producer's expect_tx and the load's bytes, or its plain arrival with
// no stage left), done (kRingCompute arrivals once 1 is added in place)
// and empty (the store thread's arrival once the slot's store has read
// it out); stage is the stage the slot holds, -1 once none is left.
template <int NBUF>
struct RingSlots {
  uint64_t full[NBUF], done[NBUF], empty[NBUF];
  long long stage[NBUF];
};

// The card's nanosecond clock, common to every SM.
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Warp 0's lane 0 claims stages, claim at a time, and loads them, warp
// 1's lane 0 stores them, the other warps add 1 in place.  The block's
// j-th stage sits in slot j % NBUF; round r = j / NBUF of a slot waits
// on the barriers' phase r (parity r & 1) and, for r > 0, on the release
// of round r - 1.  next_stage: the claim counter, zeroed before the
// launch; clock: null, or [grid, 2] for each block's start and end on
// global_ns.
template <int NBUF>
__global__ void __launch_bounds__(kRingThreads)
stream_add_ring_kernel(const unsigned char* __restrict__ x,
                       unsigned char* __restrict__ y, long long n_bytes,
                       int stage, int claim, int* __restrict__ next_stage,
                       unsigned long long* __restrict__ clock) {
  extern __shared__ __align__(128) unsigned char ring[];  // [NBUF][stage]
  __shared__ __align__(8) RingSlots<NBUF> slots;
  if (clock != nullptr && threadIdx.x == 0) clock[2 * blockIdx.x] = global_ns();
  const long long n = (n_bytes + stage - 1) / stage;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  auto size = [&](long long g) {
    return static_cast<uint32_t>(min(static_cast<long long>(stage), n_bytes - g * stage));
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(smem_addr(&slots.full[s]), 1);
      mbar_init(smem_addr(&slots.done[s]), kRingCompute);
      mbar_init(smem_addr(&slots.empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier
  if (warp == 0) {
    if (lane != 0) return;
    long long first = 0;
    for (int j = 0;; ++j) {
      const int slot = j % NBUF;
      // claimed before the slot is free, so the atomic's round trip
      // overlaps the wait; claim stages at a time
      if (j % claim == 0) first = atomicAdd(next_stage, claim);
      const long long g = first + j % claim;
      if (j >= NBUF) mbar_wait(smem_addr(&slots.empty[slot]), (j / NBUF - 1) & 1);
      const uint32_t bar = smem_addr(&slots.full[slot]);
      if (g >= n) {
        slots.stage[slot] = -1;
        mbar_arrive(bar);
        return;
      }
      slots.stage[slot] = g;
      mbar_expect_tx(bar, size(g));
      bulk_load(smem_addr(ring + static_cast<size_t>(slot) * stage), x + g * stage,
                size(g), bar);
    }
  } else if (warp == 1) {
    if (lane != 0) return;
    for (int j = 0;; ++j) {
      const int slot = j % NBUF;
      mbar_wait(smem_addr(&slots.done[slot]), (j / NBUF) & 1);
      const long long g = slots.stage[slot];
      if (g < 0) break;
      bulk_store(y + g * stage, smem_addr(ring + static_cast<size_t>(slot) * stage),
                 size(g));
      bulk_commit();
      if (j >= kRingLag<NBUF>) {
        // claim j - lag's store has read its slot: hand it back
        bulk_wait_read<kRingLag<NBUF>>();
        mbar_arrive(smem_addr(&slots.empty[(j - kRingLag<NBUF>) % NBUF]));
      }
    }
    bulk_wait_all();
    if (clock != nullptr) clock[2 * blockIdx.x + 1] = global_ns();
  } else {
    const int t = threadIdx.x - 64;
    for (int j = 0;; ++j) {
      const int slot = j % NBUF;
      mbar_wait(smem_addr(&slots.full[slot]), (j / NBUF) & 1);
      const long long g = slots.stage[slot];
      if (g >= 0) {
        float4* v = reinterpret_cast<float4*>(ring + static_cast<size_t>(slot) * stage);
        for (uint32_t i = t; i < size(g) / 16; i += kRingCompute) {
          const float4 a = v[i];
          v[i] = make_float4(a.x + 1.0f, a.y + 1.0f, a.z + 1.0f, a.w + 1.0f);
        }
        // this thread's writes, visible to the bulk store that reads them
        fence_async_smem();
      }
      mbar_arrive(smem_addr(&slots.done[slot]));
      if (g < 0) return;
    }
  }
}

// The split pipeline's barriers, NBUF of each: an in slot is full
// (producer's expect_tx and the loads' bytes) and empty (kSplitCompute
// arrivals); an out slot is full (kSplitCompute arrivals) and empty (the
// store thread's arrival once the slot's store has read it out).
template <int NBUF>
struct SplitBars {
  uint64_t in_full[NBUF], in_empty[NBUF], out_full[NBUF], out_empty[NBUF];
};

// Warp 0's lane 0 loads, warp 1's lane 0 stores, the other warps add.
// Stage j sits in slot j % NBUF of both rings; round r = j / NBUF of a
// slot waits on the barriers' phase r (parity r & 1) and, for r > 0, on
// the release of round r - 1 (parity (r - 1) & 1).
template <int NBUF>
__global__ void __launch_bounds__(kSplitThreads)
stream_add_split_kernel(const unsigned char* __restrict__ x,
                        unsigned char* __restrict__ y, long long n_bytes,
                        int stage, int n_dma) {
  extern __shared__ __align__(128) unsigned char ring[];  // ibuf, obuf
  __shared__ __align__(8) SplitBars<NBUF> bars;
  unsigned char* ibuf = ring;
  unsigned char* obuf = ring + static_cast<size_t>(NBUF) * stage;
  const Stages st{n_bytes, stage};
  const int n = st.count();
  const uint32_t sub = static_cast<uint32_t>(stage / n_dma);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(smem_addr(&bars.in_full[s]), 1);
      mbar_init(smem_addr(&bars.in_empty[s]), kSplitCompute);
      mbar_init(smem_addr(&bars.out_full[s]), kSplitCompute);
      mbar_init(smem_addr(&bars.out_empty[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the only block-wide barrier
  if (warp == 0) {
    if (lane != 0) return;
    const uint64_t policy = l2_evict_first();
    for (int j = 0; j < n; ++j) {
      const int slot = j % NBUF;
      if (j >= NBUF) mbar_wait(smem_addr(&bars.in_empty[slot]), (j / NBUF - 1) & 1);
      const uint32_t bar = smem_addr(&bars.in_full[slot]);
      const uint32_t size = st.size(j);
      mbar_expect_tx(bar, size);
      for (uint32_t off = 0; off < size; off += sub)
        bulk_load_l2(smem_addr(ibuf + static_cast<size_t>(slot) * stage + off),
                     x + st.offset(j) + off, min(sub, size - off), bar, policy);
    }
  } else if (warp == 1) {
    if (lane != 0) return;
    const uint64_t policy = l2_evict_first();
    for (int j = 0; j < n; ++j) {
      const int slot = j % NBUF;
      mbar_wait(smem_addr(&bars.out_full[slot]), (j / NBUF) & 1);
      const uint32_t size = st.size(j);
      const unsigned char* out = obuf + static_cast<size_t>(slot) * stage;
      for (uint32_t off = 0; off < size; off += sub)
        bulk_store_l2(y + st.offset(j) + off, smem_addr(out + off),
                      min(sub, size - off), policy);
      bulk_commit();
      if (j >= kSplitLag) {
        // stage j - kSplitLag's store has read its slot: hand it back
        bulk_wait_read<kSplitLag>();
        mbar_arrive(smem_addr(&bars.out_empty[(j - kSplitLag) % NBUF]));
      }
    }
    bulk_wait_all();
  } else {
    const int t = threadIdx.x - 64;
    for (int j = 0; j < n; ++j) {
      const int slot = j % NBUF;
      mbar_wait(smem_addr(&bars.in_full[slot]), (j / NBUF) & 1);
      if (j >= NBUF) mbar_wait(smem_addr(&bars.out_empty[slot]), (j / NBUF - 1) & 1);
      const float4* src = reinterpret_cast<const float4*>(
          ibuf + static_cast<size_t>(slot) * stage);
      float4* dst = reinterpret_cast<float4*>(obuf + static_cast<size_t>(slot) * stage);
      const uint32_t vecs = st.size(j) / 16;
      for (uint32_t i = t; i < vecs; i += kSplitCompute) {
        const float4 v = src[i];
        dst[i] = make_float4(v.x + 1.0f, v.y + 1.0f, v.z + 1.0f, v.w + 1.0f);
      }
      mbar_arrive(smem_addr(&bars.in_empty[slot]));
      // this thread's writes, visible to the bulk store that reads them
      fence_async_smem();
      mbar_arrive(smem_addr(&bars.out_full[slot]));
    }
  }
}

// A 16-byte load the compiler may not drop though its value is unused:
// the probe moves the bytes the TPU kernel moved.
__device__ __forceinline__ void load_kept(const float4* p) {
  float a, b, c, d;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(a), "=f"(b), "=f"(c), "=f"(d)
               : "l"(p)
               : "memory");
  asm volatile("" ::"f"(a), "f"(b), "f"(c), "f"(d));  // no instruction
}

__device__ __forceinline__ int4 add4(int4 a, int4 b) {
  return make_int4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__global__ void __launch_bounds__(kDetectThreads)
detect_stream_kernel(const float4* __restrict__ rows,
                     const int4* __restrict__ lab,
                     const float4* __restrict__ pos,
                     const float4* __restrict__ vel,
                     const int4* __restrict__ sv,
                     const float4* __restrict__ rh,
                     const int4* __restrict__ pk, int4* __restrict__ osv,
                     float4* __restrict__ orh, int4* __restrict__ opk,
                     int4* __restrict__ opay, int* __restrict__ ocnt,
                     int W) {
  __shared__ int warp_sums[kDetectThreads / 32];
  const int row = blockIdx.y;
  const int w4 = W / 4;
  const long long plane = static_cast<long long>(gridDim.y) * w4;  // float4s
  int sum = 0;
#pragma unroll
  for (int v = 0; v < kDetectVecs; ++v) {
    const int c = (blockIdx.x * kDetectVecs + v) * kDetectThreads + threadIdx.x;
    if (c >= w4) break;
    const long long i = static_cast<long long>(row) * w4 + c;
    const float4 r0 = __ldcs(rows + i);
    const float4 r3 = __ldcs(rows + 3 * plane + i);
    load_kept(rows + plane + i);
    load_kept(rows + 2 * plane + i);
    load_kept(rows + 4 * plane + i);
    load_kept(rows + 5 * plane + i);
    const int4 l = __ldcs(lab + i);
    float4 s = add4(r0, __ldcs(pos + i));
    s = add4(s, __ldcs(pos + plane + i));
    s = add4(s, __ldcs(pos + 2 * plane + i));
    s = add4(s, __ldcs(vel + i));
    s = add4(s, __ldcs(vel + plane + i));
    s = add4(s, __ldcs(vel + 2 * plane + i));
    s = add4(s, r3);
    __stcs(osv + i, add4(__ldcs(sv + i), l));
#pragma unroll
    for (int d = 0; d < 3; ++d) __stcs(orh + d * plane + i, __ldcs(rh + d * plane + i));
    __stcs(opk + i, __ldcs(pk + i));
    __stcs(opay + i, make_int4(__float_as_int(s.x), __float_as_int(s.y),
                               __float_as_int(s.z), __float_as_int(s.w)));
    sum += l.x + l.y + l.z + l.w;
  }
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kDetectThreads / 32; ++w) total += warp_sums[w];
    atomicAdd(ocnt + row, total);
  }
}

template <int NBUF>
cudaError_t ring_attributes(int stage) {
  cudaError_t err = cudaFuncSetAttribute(stream_add_ring_kernel<NBUF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         NBUF * stage);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(stream_add_ring_kernel<NBUF>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int NBUF>
cudaError_t ring_geometry(int stage, int* blocks_per_sm) {
  cudaError_t err = ring_attributes<NBUF>(stage);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, stream_add_ring_kernel<NBUF>, kRingThreads, NBUF * stage);
}

template <int NBUF>
cudaError_t launch_ring(const void* x, void* y, long long n_bytes, int stage,
                        int claim, int grid, int* counter, unsigned long long* clock,
                        cudaStream_t s) {
  cudaError_t err = ring_attributes<NBUF>(stage);
  if (err == cudaSuccess) err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  stream_add_ring_kernel<NBUF><<<grid, kRingThreads, NBUF * stage, s>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), n_bytes, stage,
      claim, counter, clock);
  return cudaGetLastError();
}

template <int NBUF>
cudaError_t launch_split(const void* x, void* y, long long n_bytes, int stage,
                         int n_dma, int grid, cudaStream_t s) {
  const int smem = 2 * NBUF * stage;
  cudaError_t err = cudaFuncSetAttribute(
      stream_add_split_kernel<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  stream_add_split_kernel<NBUF><<<grid, kSplitThreads, smem, s>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), n_bytes, stage,
      n_dma);
  return cudaGetLastError();
}

}  // namespace

// P1's block shape: threads a block and the blocks an SM holds at once.
extern "C" int stream_add_rows_geometry(int* threads, int* blocks_per_sm) {
  *threads = kRowsThreads;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, stream_add_rows_kernel, kRowsThreads, 0));
}

// x, y: n_vecs float4s over grid blocks (at most one a unit of
// kRowsThreads vectors).
extern "C" int stream_add_rows(const void* x, void* y, long long n_vecs,
                               int grid, void* stream) {
  if (n_vecs > 0)
    stream_add_rows_kernel<<<grid, kRowsThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<float4*>(y), n_vecs);
  return static_cast<int>(cudaGetLastError());
}

// P2's block shape: threads a block and the blocks of an n_buf x stage
// ring an SM holds at once (the occupancy calculator).
extern "C" int stream_add_ring_geometry(int stage, int n_buf, int* threads,
                                        int* blocks_per_sm) {
  *threads = kRingThreads;
  switch (n_buf) {
    case 2: return static_cast<int>(ring_geometry<2>(stage, blocks_per_sm));
    case 4: return static_cast<int>(ring_geometry<4>(stage, blocks_per_sm));
    case 8: return static_cast<int>(ring_geometry<8>(stage, blocks_per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x, y: n_bytes (a multiple of 16, 16-byte aligned); stage a multiple
// of 16; n_buf 2, 4 or 8; claim >= 1 stages a claim; grid blocks
// (stages + (grid + 1) x claim below 2^31); counter: one int of scratch,
// zeroed here on the stream before the launch; clock: null, or grid x 2
// uint64 for each block's start and end in nanoseconds.
extern "C" int stream_add_ring(const void* x, void* y, long long n_bytes,
                               int stage, int n_buf, int claim, int grid,
                               void* counter, void* clock, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(counter);
  unsigned long long* t = static_cast<unsigned long long*>(clock);
  if (claim < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (n_buf) {
    case 2: return static_cast<int>(launch_ring<2>(x, y, n_bytes, stage, claim, grid, c, t, s));
    case 4: return static_cast<int>(launch_ring<4>(x, y, n_bytes, stage, claim, grid, c, t, s));
    case 8: return static_cast<int>(launch_ring<8>(x, y, n_bytes, stage, claim, grid, c, t, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As stream_add_ring, with n_dma copies a stage each way (stage a
// multiple of 16 * n_dma), two rings of n_buf slots and kSplitThreads
// threads a block.
extern "C" int stream_add_split(const void* x, void* y, long long n_bytes,
                                int stage, int n_buf, int n_dma, int grid,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_buf) {
    case 2: return static_cast<int>(launch_split<2>(x, y, n_bytes, stage, n_dma, grid, s));
    case 4: return static_cast<int>(launch_split<4>(x, y, n_bytes, stage, n_dma, grid, s));
    case 8: return static_cast<int>(launch_split<8>(x, y, n_bytes, stage, n_dma, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// [R, W] planes (W a multiple of 4, every plane 16-byte aligned); ocnt
// [R] zeroed by the caller.
extern "C" int detect_stream_rows(const void* rows, const void* lab,
                                  const void* pos, const void* vel,
                                  const void* sv, const void* rh,
                                  const void* pk, void* osv, void* orh,
                                  void* opk, void* opay, void* ocnt, int R,
                                  int W, void* stream) {
  if (R > 0 && W > 0) {
    const int per_block = kDetectThreads * kDetectVecs * 4;
    const dim3 grid((W + per_block - 1) / per_block, R);
    detect_stream_kernel<<<grid, kDetectThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(rows), static_cast<const int4*>(lab),
        static_cast<const float4*>(pos), static_cast<const float4*>(vel),
        static_cast<const int4*>(sv), static_cast<const float4*>(rh),
        static_cast<const int4*>(pk), static_cast<int4*>(osv), static_cast<float4*>(orh),
        static_cast<int4*>(opk), static_cast<int4*>(opay), static_cast<int*>(ocnt), W);
  }
  return static_cast<int>(cudaGetLastError());
}
