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
// once, 1,073,741,824 B at the probe's [2048, 65536] plane).
//   stream_add_rows: the TPU's automatic pipeline over row blocks
//     becomes one block a tile of block_rows rows (a grid of
//     ceil(R / block_rows) blocks, so a tile count below the SM count
//     leaves SMs idle, as the probe means to show), 1024 threads, four
//     16-byte streaming loads in flight a thread before their stores.
//   stream_add_ring: the single-program rotating VMEM ring becomes one
//     persistent block an SM, each walking its share of the stages
//     (stage g of the flat tensor goes to block g % grid) through an
//     NBUF-slot shared-memory ring.  Thread 0 fills a slot by one TMA
//     bulk copy (cp.async.bulk global->shared, completing on the slot's
//     mbarrier with complete_tx) NBUF - 1 stages ahead; the block adds 1
//     in shared memory and thread 0 stores the slot back by one
//     cp.async.bulk shared->global.  As on the TPU (dma_probe.py:116-121)
//     a slot is refilled only after its own store has read it out
//     (cp.async.bulk.wait_group.read 0: the store of the previous stage,
//     the slot's last occupant).
//   stream_add_split: separate in and out rings (ibuf, obuf), n_dma bulk
//     copies a stage over disjoint sub-ranges in each direction, one
//     mbarrier a slot for all of them; an in slot is refilled without
//     waiting for any store, and an out slot waits only for its own
//     previous store (wait_group.read NBUF - 1: the store NBUF stages
//     back, dma_probe.py:219-224).
// A JAX chunk of chunk_rows rows of 256 KiB does not fit the 227 KiB of
// shared memory a block has; the wrapper passes a stage of chunk_rows x
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
constexpr int kRowsUnroll = 4;
constexpr int kRingThreads = 256;
constexpr int kDetectThreads = 256;
constexpr int kDetectVecs = 4;  // float4s a thread: 4096 particles a block

__global__ void __launch_bounds__(kRowsThreads)
stream_add_rows_kernel(const float4* __restrict__ x, float4* __restrict__ y,
                       long long n_vecs, long long tile_vecs) {
  const long long begin = static_cast<long long>(blockIdx.x) * tile_vecs;
  const long long end = min(begin + tile_vecs, n_vecs);
  for (long long i = begin + threadIdx.x; i < end;
       i += static_cast<long long>(kRowsThreads) * kRowsUnroll) {
    float4 v[kRowsUnroll];
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) {
      const long long k = i + static_cast<long long>(u) * kRowsThreads;
      if (k < end) v[u] = __ldcs(x + k);
    }
#pragma unroll
    for (int u = 0; u < kRowsUnroll; ++u) {
      const long long k = i + static_cast<long long>(u) * kRowsThreads;
      if (k < end) {
        v[u].x += 1.0f;
        v[u].y += 1.0f;
        v[u].z += 1.0f;
        v[u].w += 1.0f;
        __stcs(y + k, v[u]);
      }
    }
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

// The stages of one ring block: stage g covers bytes [g * stage, g *
// stage + size) of the flat tensor, the last one shorter.
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

__device__ __forceinline__ void add_one(const unsigned char* src,
                                        unsigned char* dst, uint32_t bytes) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (uint32_t i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
    float4 v = s[i];
    v.x += 1.0f;
    v.y += 1.0f;
    v.z += 1.0f;
    v.w += 1.0f;
    d[i] = v;
  }
}

template <int NBUF>
__global__ void __launch_bounds__(kRingThreads)
stream_add_ring_kernel(const unsigned char* __restrict__ x,
                       unsigned char* __restrict__ y, long long n_bytes,
                       int stage) {
  extern __shared__ __align__(128) unsigned char ring[];  // [NBUF][stage]
  __shared__ __align__(8) uint64_t full[NBUF];
  const Stages st{n_bytes, stage};
  const int n = st.count();
  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUF; ++s) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int j) {  // thread 0 only
    const int slot = j % NBUF;
    const uint32_t bar = smem_addr(&full[slot]);
    mbar_expect_tx(bar, st.size(j));
    bulk_load(smem_addr(ring + static_cast<size_t>(slot) * stage),
              x + st.offset(j), st.size(j), bar);
  };
  if (threadIdx.x == 0)
    for (int j = 0; j < NBUF - 1 && j < n; ++j) load(j);
  for (int j = 0; j < n; ++j) {
    const int slot = j % NBUF;
    const int next = j + NBUF - 1;
    if (threadIdx.x == 0 && next < n) {
      // the slot to refill last held stage j - 1, stored at the end of
      // the previous iteration: wait until that store has read it
      if (next >= NBUF) bulk_wait_read<0>();
      load(next);
    }
    mbar_wait(smem_addr(&full[slot]), (j / NBUF) & 1);
    unsigned char* buf = ring + static_cast<size_t>(slot) * stage;
    add_one(buf, buf, st.size(j));
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      bulk_store(y + st.offset(j), smem_addr(buf), st.size(j));
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

template <int NBUF>
__global__ void __launch_bounds__(kRingThreads)
stream_add_split_kernel(const unsigned char* __restrict__ x,
                        unsigned char* __restrict__ y, long long n_bytes,
                        int stage, int n_dma) {
  extern __shared__ __align__(128) unsigned char ring[];  // ibuf, obuf
  __shared__ __align__(8) uint64_t full[NBUF];
  unsigned char* ibuf = ring;
  unsigned char* obuf = ring + static_cast<size_t>(NBUF) * stage;
  const Stages st{n_bytes, stage};
  const int n = st.count();
  const uint32_t sub = static_cast<uint32_t>(stage / n_dma);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUF; ++s) mbar_init(smem_addr(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto load = [&](int j) {  // thread 0 only: n_dma copies, one barrier
    const int slot = j % NBUF;
    const uint32_t bar = smem_addr(&full[slot]);
    const uint32_t size = st.size(j);
    mbar_expect_tx(bar, size);
    for (uint32_t off = 0; off < size; off += sub)
      bulk_load(smem_addr(ibuf + static_cast<size_t>(slot) * stage + off),
                x + st.offset(j) + off, min(sub, size - off), bar);
  };
  if (threadIdx.x == 0)
    for (int j = 0; j < NBUF - 1 && j < n; ++j) load(j);
  for (int j = 0; j < n; ++j) {
    const int slot = j % NBUF;
    if (threadIdx.x == 0) {
      // the in slot of stage j - 1 was read before the last barrier
      if (j + NBUF - 1 < n) load(j + NBUF - 1);
      // the out slot's previous store (stage j - NBUF) has read it out
      if (j >= NBUF) bulk_wait_read<NBUF - 1>();
    }
    mbar_wait(smem_addr(&full[slot]), (j / NBUF) & 1);
    __syncthreads();  // thread 0's wait for the out slot is done
    const uint32_t size = st.size(j);
    unsigned char* out = obuf + static_cast<size_t>(slot) * stage;
    add_one(ibuf + static_cast<size_t>(slot) * stage, out, size);
    fence_async_smem();
    __syncthreads();
    if (threadIdx.x == 0) {
      for (uint32_t off = 0; off < size; off += sub)
        bulk_store(y + st.offset(j) + off, smem_addr(out + off),
                   min(sub, size - off));
      bulk_commit();
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
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
cudaError_t launch_ring(const void* x, void* y, long long n_bytes, int stage,
                        int grid, cudaStream_t s) {
  const int smem = NBUF * stage;
  cudaError_t err = cudaFuncSetAttribute(
      stream_add_ring_kernel<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  stream_add_ring_kernel<NBUF><<<grid, kRingThreads, smem, s>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), n_bytes, stage);
  return cudaGetLastError();
}

template <int NBUF>
cudaError_t launch_split(const void* x, void* y, long long n_bytes, int stage,
                         int n_dma, int grid, cudaStream_t s) {
  const int smem = 2 * NBUF * stage;
  cudaError_t err = cudaFuncSetAttribute(
      stream_add_split_kernel<NBUF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  stream_add_split_kernel<NBUF><<<grid, kRingThreads, smem, s>>>(
      static_cast<const unsigned char*>(x), static_cast<unsigned char*>(y), n_bytes, stage,
      n_dma);
  return cudaGetLastError();
}

}  // namespace

// x, y: n_vecs float4s; one block a tile of tile_vecs float4s.
extern "C" int stream_add_rows(const void* x, void* y, long long n_vecs,
                               long long tile_vecs, void* stream) {
  if (n_vecs > 0) {
    const long long blocks = (n_vecs + tile_vecs - 1) / tile_vecs;
    stream_add_rows_kernel<<<static_cast<unsigned>(blocks), kRowsThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(x), static_cast<float4*>(y), n_vecs, tile_vecs);
  }
  return static_cast<int>(cudaGetLastError());
}

// x, y: n_bytes (a multiple of 16, 16-byte aligned); stage a multiple
// of 16; n_buf 2, 4 or 8; grid persistent blocks.
extern "C" int stream_add_ring(const void* x, void* y, long long n_bytes,
                               int stage, int n_buf, int grid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_buf) {
    case 2: return static_cast<int>(launch_ring<2>(x, y, n_bytes, stage, grid, s));
    case 4: return static_cast<int>(launch_ring<4>(x, y, n_bytes, stage, grid, s));
    case 8: return static_cast<int>(launch_ring<8>(x, y, n_bytes, stage, grid, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// As stream_add_ring, with n_dma copies a stage each way (stage a
// multiple of 16 * n_dma) and two rings of n_buf slots.
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
