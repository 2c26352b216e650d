"""Device time of variants of K1/K2, K3, K4/K5 and K18
(``csrc/compact.cu`` compact_angle_rows, compact_pair_rows,
compact_payload_rows and compact_events_rows, one tile kernel), K19
(``csrc/compact.cu`` compact_rows_groups), K8
(``csrc/label.cu`` detect_label_compact_rows), K15 and K16
(``csrc/merge.cu`` merge_rows and fused_join_detect) and K17
(``csrc/static.cu`` static_detect_rows) on ``chip_smoke.py`` phase 3's
inputs, and the stream probes P1, P2 and P3 (``csrc/probe.cu``
stream_add_rows, stream_add_ring and stream_add_split) on
``dma_probe.py``'s ``[2048, 65536]`` f32 plane beside torch's ``x + 1``,
in one process (K3 at phase 3's ``[4, 262144]`` and at one halo
of ``[1, 1 << 19]``; K18 on phase 3's static step, on 2 % events and on
every lane an event at ``[64, 32768]``; K19 with group a of six channels
and of one).

Each variant is the checked-in source with a few text substitutions: a
tile shape (threads a block, entries a thread) or a phase left out.  A
variant that leaves a phase out gives wrong outputs and is timed only,
to show what that phase costs; the others are checked bit for bit
against the plain versions.  Every variant is built by its own ``nvcc``
(all started together) into its own library next to the package's
git-ignored build directory, so the package's own build is untouched;
K1, K3, K4, K8, K15, K18 and K19 variants run through the package's own
wrappers with the variant library in place of the package's (a K1 tile
shape is K4's too: the two share the kernel).  Prints one line a variant
and input:
its name, then the milliseconds of two timings (``chip_smoke.cuda_ms``)
and, for a variant that leaves a phase out, the count of output lanes
that differ.  It needs a CUDA card; the argument picks the kernels (all
nine K kernels by default; P1, P2 and P3 only when named):

    python3 detect_variants.py [K1,K3,K4,K8,K15,K16,K17,K18,K19,P1,P2,P3]
        [PARENT_CHECKOUT]

P1 runs ``auto8``, ``auto32`` and ``pallas5`` (five planes of 409
rows); P3 runs ``split32x4``, ``dual32x4`` and ``quad64x2`` with stages
of ``chunk_rows`` x 256, 512 and 768 bytes; both print torch's ``x +
1`` on the same planes first (``xla``, ``xla5``) and P2's ``man16x4``
of the package's own build.  P2 runs every ``man*`` variant at
``ring_plan``'s grid and ``man16x4`` at one block an SM too, through
``_cuda.stream_add_ring_on``, and prints the ``man16x4`` calls' block
end-time spread (each block's start and end on the card's nanosecond
clock); given a parent checkout, it rebuilds that checkout's P2 with the
block clocks patched in and runs every ``man*`` at one block an SM (its
own grid) and at ``ring_plan``'s blocks an SM.
"""
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(ROOT, "orbitanalysis_tpu_torch", "csrc")
BUILD = os.path.join(ROOT, "orbitanalysis_tpu_torch", "_build", "variants")

LOOKBACK = (
    "const int before =\n"
    "      lookback_prefix(a.scratch + 1 + static_cast<size_t>(row) * "
    "a.tiles, t, total, &slot);",
    "const int before = 0;")
CLAIM = ("const int tile = claim_tile(a.scratch, &slot);",
         "const int tile = blockIdx.x;")


def shape(vt_line, vt, threads, threads_line="constexpr int kThreads = 256;"):
    """Substitutions for ``vt`` entries a thread and ``threads`` a block."""
    return [(vt_line, vt_line.rsplit("=", 1)[0] + f"= {vt};"),
            (threads_line, threads_line.rsplit("=", 1)[0] + f"= {threads};")]


#: The source of each kernel's variants.
SOURCES = {"K1": "compact.cu", "K3": "compact.cu", "K4": "compact.cu",
           "K18": "compact.cu",
           "K8": "label.cu", "K15": "merge.cu", "K16": "merge.cu",
           "K17": "static.cu", "K19": "compact.cu",
           "P1": "probe.cu", "P2": "probe.cu", "P2p": "probe.cu",
           "P3": "probe.cu"}
#: The kernel function each variant's ptxas lines are printed for (a
#: part of its mangled name).
KERNEL_FUNCTIONS = {"K1": "AngleWords", "K3": "PairWords",
                    "K4": "PayloadWords", "K18": "EventWords",
                    "K19": "compact_groups_kernel",
                    "K8": "detect_label_compact_kernel",
                    "K15": "merge_rows_kernel",
                    "K16": "join_detect_kernel", "K17": "static_detect_kernel",
                    "P1": "stream_add_rows_kernel",
                    "P2": "stream_add_ring_kernel",
                    "P2p": "stream_add_ring_kernel",
                    "P3": "stream_add_split_kernel"}
#: (kernel, name, substitutions, checked): the shipped shapes first.
K16_VT = "constexpr int kJoinVT = 4;"
K17_VT = "constexpr int kVT = 8;"
K4_SHAPE = ("constexpr int kTileVT = 16;", "constexpr int kTileThreads = 256;")
K15_SHAPE = ("constexpr int kMergeVT = 4;",
             "constexpr int kMergeThreads = 256;")
K8_SHAPE = ("constexpr int kCompactVT = 4;",
            "constexpr int kCompactThreads = 256;")
K18_VT = "constexpr int kEventVT = 8;"
K19_VT = ("constexpr int kGroupVT = 8;",
          "constexpr int kGroupThreads = 256;")
K19_CAP = "constexpr int kGroupBCap = 8;"


def vt(line, n):
    """The substitution that sets the constant of ``line`` to ``n``."""
    return (line, line.rsplit("=", 1)[0] + f"= {n};")


def k19_blocks(n):
    """K19 built for at least ``n`` resident blocks an SM (1: no register
    cap)."""
    return vt("constexpr int kGroupBlocks = 4;", n)


K19_LOOKBACK = [(
    "const int before = lookback_warp(\n"
    "        a.scratch + 1 + (static_cast<size_t>(warp) * a.H + row) * "
    "a.tiles, t,\n        warp == 0 ? total_a : total_b, lane);",
    "const int before = 0;")]


def k15_blocks(n):
    """K15 built for at least ``n`` resident blocks an SM (ptxas caps its
    registers to fit them; 1: no cap)."""
    old = "constexpr int kMergeBlocks = 8;"
    return (old, old.rsplit("=", 1)[0] + f"= {n};")


P1_THREADS = "constexpr int kRowsThreads = 1024;"
P1_UNROLL = ("constexpr int kRowsUnroll = 4;  // 16-byte loads in flight a "
             "thread")
P1_CONTIGUOUS = [(
    "  const long long first = static_cast<long long>(blockIdx.x) * "
    "kRowsThreads + threadIdx.x;\n"
    "  if (first >= n_vecs) return;\n"
    "  const long long stride = static_cast<long long>(gridDim.x) * "
    "kRowsThreads;\n"
    "  const int count = static_cast<int>((n_vecs - 1 - first) / stride) + "
    "1;",
    "  const long long units = (n_vecs + kRowsThreads - 1) / kRowsThreads;\n"
    "  const long long b = blockIdx.x, base = units / gridDim.x, "
    "rem = units % gridDim.x;\n"
    "  const long long lo = b * base + min(b, rem), "
    "hi = lo + base + (b < rem ? 1 : 0);\n"
    "  const long long first = lo * kRowsThreads + threadIdx.x;\n"
    "  const long long end = min(hi * kRowsThreads, n_vecs);\n"
    "  if (first >= end) return;\n"
    "  const long long stride = kRowsThreads;\n"
    "  const int count = static_cast<int>((end - 1 - first) / stride) + 1;")]
#: the grid of the work: one block a unit (the geometry reports more
#: blocks an SM than any unit count needs)
P1_WORK_GRID = [(
    "  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
    "      blocks_per_sm, stream_add_rows_kernel, kRowsThreads, 0));",
    "  *blocks_per_sm = 1 << 20;\n  return 0;")]
P1_LOAD = "    if (u < left) v[u] = __ldcs(p);"
P1_STORE = ("      __stcs(p, make_float4(v[u].x + 1.0f, v[u].y + 1.0f, "
            "v[u].z + 1.0f, v[u].w + 1.0f));")
P1_PLAIN = [(P1_LOAD, P1_LOAD.replace("__ldcs(p)", "*p")),
            (P1_STORE, P1_STORE.replace("__stcs(p, ", "*p = ").replace(
                "));", ");"))]
P1_EVICT_FIRST = [
    (P1_LOAD, P1_LOAD.replace("v[u] = __ldcs(p);", (
        "asm(\"{.reg .b64 q;\\n"
        "createpolicy.fractional.L2::evict_first.b64 q, 1.0;\\n"
        "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 "
        "{%0, %1, %2, %3}, [%4], q;}\\n\" : \"=f\"(v[u].x), \"=f\"(v[u].y), "
        "\"=f\"(v[u].z), \"=f\"(v[u].w) : \"l\"(p));"))),
    (P1_STORE, (
        "      {\n        const float4 w = make_float4(v[u].x + 1.0f, "
        "v[u].y + 1.0f, v[u].z + 1.0f, v[u].w + 1.0f);\n"
        "        asm volatile(\"{.reg .b64 q;\\n"
        "createpolicy.fractional.L2::evict_first.b64 q, 1.0;\\n"
        "st.global.L1::no_allocate.L2::cache_hint.v4.f32 "
        "[%0], {%1, %2, %3, %4}, q;}\\n\" :: \"l\"(p), \"f\"(w.x), "
        "\"f\"(w.y), \"f\"(w.z), \"f\"(w.w) : \"memory\");\n      }"))]
#: torch's own grid for x + 1 on sm_90 (ATen's vectorized elementwise
#: kernel): one block a chunk of 2 x 128 vectors, 2 vectors a thread,
#: plain loads and stores, as many blocks as chunks
P1_TORCH_GRID = [
    vt(P1_THREADS, 128), *P1_PLAIN,
    ("  const long long first = static_cast<long long>(blockIdx.x) * "
     "kRowsThreads + threadIdx.x;\n"
     "  if (first >= n_vecs) return;\n"
     "  const long long stride = static_cast<long long>(gridDim.x) * "
     "kRowsThreads;\n"
     "  const int count = static_cast<int>((n_vecs - 1 - first) / stride) + "
     "1;",
     "  const long long first = static_cast<long long>(blockIdx.x) * 2 * "
     "kRowsThreads + threadIdx.x;\n"
     "  if (first >= n_vecs) return;\n"
     "  const long long stride = kRowsThreads;\n"
     "  const int count = static_cast<int>(min(2LL, (n_vecs - 1 - first) / "
     "stride + 1));"),
    ("stream_add_rows_kernel<<<grid, kRowsThreads,",
     "stream_add_rows_kernel<<<static_cast<unsigned>((n_vecs + 2 * "
     "kRowsThreads - 1) / (2 * kRowsThreads)), kRowsThreads,")]
P1_UNPIPELINED = [(
    "    load_rows(next, xp, stride, count - k - kRowsUnroll);\n"
    "    store_rows(yp, cur, stride, count - k);",
    "    store_rows(yp, cur, stride, count - k);\n"
    "    load_rows(next, xp, stride, count - k - kRowsUnroll);")]
P3_WARPS = "constexpr int kSplitComputeWarps = 8;"
P3_LAG = "constexpr int kSplitLag = 1;"
P3_NO_HINT = [
    ("complete_tx::bytes.L2::cache_hint ", "complete_tx::bytes "),
    ("[%0], [%1], %2, [%3], %4;", "[%0], [%1], %2, [%3];"),
    ("bulk_group.L2::cache_hint [%0], [%1], %2, %3;",
     "bulk_group [%0], [%1], %2;")]
#: P3's calls: the JAX split variants' (chunk_rows, n_buf, n_dma), each
#: at stages of chunk_rows x these bytes
P3_CALLS = {"split32x4": (32, 4, 1), "dual32x4": (32, 4, 2),
            "quad64x2": (64, 2, 4)}
P3_ROW_BYTES = (256, 512, 768)

P2_WARPS = "constexpr int kRingComputeWarps = 4;"
P2_LAG = "constexpr int kRingLag = NBUF > 2 ? 0 : 1;"
P2_CLAIM = ("if (j % claim == 0) first = atomicAdd(next_stage, claim);\n"
            "      const long long g = first + j % claim;")
#: (a) taken out: stage g dealt to block g % grid, as the parent did
P2_DEALT = [(P2_CLAIM, "const long long g = blockIdx.x + "
             "static_cast<long long>(j) * gridDim.x;")]
#: one stage a claim, whatever its size
P2_SINGLE = [(P2_CLAIM, "const long long g = atomicAdd(next_stage, 1);")]
#: both bulk copies with an L2 evict-first policy, as P3's
P2_EVICT_FIRST = [
    ("    if (lane != 0) return;\n    long long first = 0;\n",
     "    if (lane != 0) return;\n"
     "    const uint64_t policy = l2_evict_first();\n"
     "    long long first = 0;\n"),
    ("bulk_load(smem_addr(ring + static_cast<size_t>(slot) * stage), "
     "x + g * stage,\n                size(g), bar);",
     "bulk_load_l2(smem_addr(ring + static_cast<size_t>(slot) * stage), "
     "x + g * stage,\n                size(g), bar, policy);"),
    ("    if (lane != 0) return;\n    for (int j = 0;; ++j) {\n"
     "      const int slot = j % NBUF;\n      mbar_wait(smem_addr("
     "&slots.done[slot])",
     "    if (lane != 0) return;\n    const uint64_t policy = l2_evict_first();\n"
     "    for (int j = 0;; ++j) {\n      const int slot = j % NBUF;\n"
     "      mbar_wait(smem_addr(&slots.done[slot])"),
    ("bulk_store(y + g * stage, smem_addr(ring + static_cast<size_t>(slot) * "
     "stage),\n                 size(g));",
     "bulk_store_l2(y + g * stage, smem_addr(ring + static_cast<size_t>(slot) "
     "* stage),\n                    size(g), policy);")]
#: The parent's P2 (a persistent block an SM, stages dealt, a block-wide
#: barrier a stage; ``csrc/probe.cu`` before the redesign) with each
#: block's start and end on the card's nanosecond clock, read back by
#: ``ring_clock_read``.
P2_PARENT_CLOCK = [
    ('#include "common.cuh"\n',
     '#include "common.cuh"\n\n__device__ unsigned long long '
     'ring_clock[2 * 8192];\n\n__device__ __forceinline__ unsigned long '
     'long clock_ns() {\n  unsigned long long t;\n  asm volatile("mov.u64 '
     '%0, %%globaltimer;" : "=l"(t));\n  return t;\n}\n'),
    ("  __shared__ __align__(8) uint64_t full[NBUF];\n"
     "  const Stages st{n_bytes, stage};",
     "  __shared__ __align__(8) uint64_t full[NBUF];\n"
     "  if (threadIdx.x == 0) ring_clock[2 * blockIdx.x] = clock_ns();\n"
     "  const Stages st{n_bytes, stage};"),
    ("  if (threadIdx.x == 0) bulk_wait_all();\n}\n\n// The split",
     "  if (threadIdx.x == 0) {\n    bulk_wait_all();\n"
     "    ring_clock[2 * blockIdx.x + 1] = clock_ns();\n  }\n}\n\n"
     "// The split"),
    ("// [R, W] planes (W a multiple of 4",
     'extern "C" int ring_clock_read(void* host, int blocks) {\n'
     "  return static_cast<int>(cudaMemcpyFromSymbol(host, ring_clock, "
     "16 * blocks));\n}\n\n// [R, W] planes (W a multiple of 4")]
#: The blocks an SM the parent's ring kernel is also run at (its own: 1)
P2_PARENT_PER_SM = (1, 6)
#: P2's calls: every JAX manual variant at ring_plan's grid
P2_CALLS = ("man16x4", "man8x8", "man32x4", "man64x2", "man128x2",
            "man64x4", "man32x8")

ROW_LOOKBACK = ("lookback_prefix(scratch + 1 + static_cast<size_t>(row) * "
                "tiles, t, total, &slot);", "0;")
VARIANTS = [
    ("K1", "shipped (256 threads x 16)", [], True),
    ("K1", "256 x 8", shape(K4_SHAPE[0], 8, 256, K4_SHAPE[1]), True),
    ("K1", "256 x 32", shape(K4_SHAPE[0], 32, 256, K4_SHAPE[1]), True),
    ("K1", "512 x 8", shape(K4_SHAPE[0], 8, 512, K4_SHAPE[1]), True),
    ("K1", "no look-back", [ROW_LOOKBACK], False),
    ("K3", "shipped (256 threads x 16, K1/K4's shape)", [], True),
    ("K3", "256 x 8", [vt(K4_SHAPE[0], 8)], True),
    ("K3", "256 x 32", [vt(K4_SHAPE[0], 32)], True),
    ("K18", "shipped (256 threads x 8)", [], True),
    ("K18", "256 x 4", [vt(K18_VT, 4)], True),
    ("K18", "256 x 16", [vt(K18_VT, 16)], True),
    ("K18", "256 x 32", [vt(K18_VT, 32)], True),
    ("K18", "no look-back", [ROW_LOOKBACK], False),
    ("K19", "shipped (256 threads x 8, 4 blocks an SM)", [], True),
    ("K19", "256 x 4, 6 blocks an SM", [vt(K19_VT[0], 4), k19_blocks(6)],
     True),
    ("K19", "256 x 8, no register cap", [k19_blocks(1)], True),
    ("K19", "256 x 16, 2 blocks an SM", [vt(K19_VT[0], 16), k19_blocks(2)],
     True),
    ("K19", "group b staging 0 a warp (read after the scan)",
     [vt(K19_CAP, 0)], True),
    ("K19", "no channel copies", [(
        "cp_async16(stage + c * kGroupTile + 4 * q, a.in[0][c] + base + 4 * q);",
        "{}")], False),
    ("K19", "no look-back", K19_LOOKBACK, False),
    ("K19", "no output writes", [(
        "a.out[0][c][out_a + before_a + j] = plane[src[j]];",
        "if (plane[src[j]] == 0x9E3779B9u && j < 0) a.out[0][c][out_a] = 0u;")],
     False),
    ("K15", "shipped (256 threads x 4, 8 blocks an SM)", [], True),
    ("K15", "256 x 4, no register cap", [k15_blocks(1)], True),
    ("K15", "256 x 8, 4 blocks an SM",
     shape(K15_SHAPE[0], 8, 256, K15_SHAPE[1]) + [k15_blocks(4)], True),
    ("K15", "256 x 8, no register cap",
     shape(K15_SHAPE[0], 8, 256, K15_SHAPE[1]) + [k15_blocks(1)], True),
    ("K15", "256 x 2, 8 blocks an SM",
     shape(K15_SHAPE[0], 2, 256, K15_SHAPE[1]), True),
    ("K15", "512 x 4, 4 blocks an SM",
     shape(K15_SHAPE[0], 4, 512, K15_SHAPE[1]) + [k15_blocks(4)], True),
    ("K15", "128 x 8, 16 blocks an SM",
     shape(K15_SHAPE[0], 8, 128, K15_SHAPE[1]) + [k15_blocks(16)], True),
    ("K15", "128 x 4, 16 blocks an SM",
     shape(K15_SHAPE[0], 4, 128, K15_SHAPE[1]) + [k15_blocks(16)], True),
    ("K4", "shipped (256 threads x 16)", [], True),
    ("K4", "256 x 8", shape(K4_SHAPE[0], 8, 256, K4_SHAPE[1]), True),
    ("K4", "256 x 32", shape(K4_SHAPE[0], 32, 256, K4_SHAPE[1]), True),
    ("K4", "512 x 8", shape(K4_SHAPE[0], 8, 512, K4_SHAPE[1]), True),
    ("K4", "no look-back", [ROW_LOOKBACK], False),
    ("K8", "shipped (256 threads x 4)", [], True),
    ("K8", "256 x 2", shape(K8_SHAPE[0], 2, 256, K8_SHAPE[1]), True),
    ("K8", "256 x 8", shape(K8_SHAPE[0], 8, 256, K8_SHAPE[1]), True),
    ("K8", "128 x 8", shape(K8_SHAPE[0], 8, 128, K8_SHAPE[1]), True),
    ("K8", "512 x 2", shape(K8_SHAPE[0], 2, 512, K8_SHAPE[1]), True),
    ("K8", "no look-back", [ROW_LOOKBACK], False),
    ("K8", "detect chain alone", [
        ROW_LOOKBACK, ("if (take[v] && dst < a.k128)", "if (false)"),
        ("  const int total = tile_ranks<kCompactThreads, kCompactVT>(take, "
         "rank, counts);", "  const int total = 0;")], False),
    ("K16", "shipped (256 threads x 4)", [], True),
    ("K16", "256 x 2", shape(K16_VT, 2, 256), True),
    ("K16", "256 x 8", shape(K16_VT, 8, 256), True),
    ("K16", "128 x 8", shape(K16_VT, 8, 128), True),
    ("K16", "no look-back", [LOOKBACK], False),
    ("K16", "no tile counter (blockIdx)", [CLAIM], False),
    ("K16", "no diagonal search (d / 2)", [(
        "const int i = merge_split<false>(pk, ck, P, warp == 0 ? d0 : d1);",
        "const int i = min(P, (warp == 0 ? d0 : d1) / 2);")], False),
    ("K16", "no detection", [("if (q != 0) {", "if (false) {")], False),
    ("K16", "no merge (so no detection)", [(
        "  if (s < n) {\n    // this thread's split",
        "  if (false) {\n    // this thread's split")], False),
    ("K17", "shipped (256 threads x 8)", [], True),
    ("K17", "256 x 4", shape(K17_VT, 4, 256), True),
    ("K17", "512 x 4", shape(K17_VT, 4, 512), True),
    ("K17", "128 x 16", shape(K17_VT, 16, 128), True),
    ("K17", "no look-back", [LOOKBACK], False),
    ("K17", "no tile counter (blockIdx)", [CLAIM], False),
    ("K17", "detect pass alone", [
        LOOKBACK, CLAIM, ("if (take[v] && o < a.len) {", "if (false) {"),
        ("  const int total = tile_ranks<kThreads, kVT>(take, rank, "
         "counts);", "  const int total = 0;")], False),
    ("P1", "shipped (1024 threads x 4 loads ahead, interleaved units, "
     "__ldcs/__stcs)", [], True),
    ("P1", "256 x 4", [vt(P1_THREADS, 256)], True),
    ("P1", "512 x 4", [vt(P1_THREADS, 512)], True),
    ("P1", "1024 x 2", [vt(P1_UNROLL, 2)], True),
    ("P1", "1024 x 1", [vt(P1_UNROLL, 1)], True),
    ("P1", "contiguous shares", P1_CONTIGUOUS, True),
    ("P1", "no cache hints", P1_PLAIN, True),
    ("P1", "L1 no-allocate, L2 evict-first policy", P1_EVICT_FIRST, True),
    ("P1", "stores before the next loads", P1_UNPIPELINED, True),
    ("P1", "a grid of the work: one block a unit", P1_WORK_GRID, True),
    ("P1", "a grid of the work, 128 threads, no cache hints",
     [vt(P1_THREADS, 128), *P1_PLAIN, *P1_WORK_GRID], True),
    ("P1", "torch's grid: a block of 128 threads a chunk of 256 vectors, "
     "no cache hints", P1_TORCH_GRID, True),
    ("P3", "shipped (8 compute warps, lag 1, L2 evict-first)", [], True),
    ("P3", "4 compute warps", [vt(P3_WARPS, 4)], True),
    ("P3", "16 compute warps", [vt(P3_WARPS, 16)], True),
    ("P3", "lag 0", [vt(P3_LAG, 0)], True),
    ("P3", "no L2 hint", P3_NO_HINT, True),
    ("P2", "shipped (claims of at least 8 KiB, ring_plan's blocks an SM, "
     "warp-specialised, 4 compute warps, lag 0, 1 at two slots)", [], True),
    ("P2", "(a) out: dealt stages", P2_DEALT, True),
    ("P2", "2 compute warps", [vt(P2_WARPS, 2)], True),
    ("P2", "8 compute warps", [vt(P2_WARPS, 8)], True),
    ("P2", "lag 1", [vt(P2_LAG, 1)], True),
    ("P2", "one stage a claim", P2_SINGLE, True),
    ("P2", "L2 evict-first bulk copies", P2_EVICT_FIRST, True),
    ("P2p", "the parent's kernel with block clocks", P2_PARENT_CLOCK, True),
]


def build(variants, parent=None):
    """Compile each variant's source into its own library; returns
    ``({index: ctypes.CDLL}, {index: nvcc's output})``.  A ``P2p``
    variant's source is the checkout ``parent``'s.  Raises on a
    substitution that does not apply or a failed build."""
    from orbitanalysis_tpu_torch.ops import _cuda

    shutil.rmtree(BUILD, ignore_errors=True)
    procs = []
    for i, (kernel, name, subs, _) in enumerate(variants):
        csrc = (os.path.join(parent, "orbitanalysis_tpu_torch", "csrc")
                if kernel == "P2p" else CSRC)
        src = os.path.join(csrc, SOURCES[kernel])
        text = open(src).read()
        for a, b in subs:
            if a not in text:
                raise SystemExit(f"{kernel} {name}: {a!r} not in {src}")
            text = text.replace(a, b)
        d = os.path.join(BUILD, str(i))
        os.makedirs(d)
        shutil.copy(os.path.join(csrc, "common.cuh"), d)
        with open(os.path.join(d, "k.cu"), "w") as f:
            f.write(text)
        so = os.path.join(d, "lib.so")
        procs.append((i, so, subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-o", so, os.path.join(d, "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs, logs = {}, {}
    for i, so, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {variants[i][:2]} failed:\n{out}")
        libs[i] = _cuda.bind(ctypes.CDLL(so))
        logs[i] = out
    return libs, logs


def ptxas_lines(log, kernel):
    """What ``-Xptxas -v`` printed for the entry functions whose mangled
    name holds ``kernel``: registers, stack, spills."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            keep = kernel in line
        if keep and ("Used" in line or "spill" in line):
            out.append("    " + line.strip())
    return out


def launcher(lib, name, planes, h, p, k128, flags):
    """A call of entry point ``name`` of ``lib`` on ``planes``, the
    wrapper's outputs and scratch allocated anew each call, as
    ``_cuda._detect_events`` does."""
    import torch

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    words_fn = getattr(lib, f"{name}_scratch")
    words_fn.argtypes, words_fn.restype = [i32, i32], i64
    fn = getattr(lib, name)
    fn.argtypes = ([vp] * (len(planes) + 6) + [i64]
                   + [i32] * (3 + len(flags)) + [vp])
    fn.restype = i32
    words = words_fn(h, p)
    dev = planes[0].device

    def run(poison=False):
        # poison: outputs filled with -1 first, so a lane the kernel does
        # not write differs from the plain version
        new = torch.full if poison else (lambda shape, _, **kw:
                                         torch.empty(shape, **kw))
        packed = new((h, p), -1, dtype=torch.int32, device=dev)
        ev_key = new((h, k128), -1, dtype=torch.int32, device=dev)
        ev_sv = new((h, k128), -1, dtype=torch.int32, device=dev)
        ev_ang = new((h, k128), -1, dtype=torch.int32, device=dev)
        count = new((h,), -1, dtype=torch.int32, device=dev)
        scratch = torch.empty(words, dtype=torch.int64, device=dev)
        rc = fn(*(t.data_ptr() for t in planes), packed.data_ptr(),
                ev_key.data_ptr(), ev_sv.data_ptr(), ev_ang.data_ptr(),
                count.data_ptr(), scratch.data_ptr(), words, h, p, k128,
                *flags, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        return packed, ev_key, ev_sv, ev_ang, count
    return run


def with_library(lib, fn):
    """``fn`` run with ``lib`` in place of the package's library, so the
    package's wrappers launch the variant."""
    from orbitanalysis_tpu_torch.ops import _cuda

    def run():
        saved, _cuda._lib = _cuda._library(), lib
        try:
            return fn()
        finally:
            _cuda._lib = saved
    return run


def pair_calls(cs, dev):
    """K3's calls on phase 3's ``[4, 262144]`` rows and on one halo of
    ``[1, 1 << 19]`` (3 % events, the last position one), each with its
    plain version's outputs: ``[(label, fn, want)]``."""
    import numpy as np
    import torch

    from orbitanalysis_tpu_torch.ops import compact

    rng = np.random.default_rng(1)
    out = []
    for h, p, k in (cs.PAIR_ROWS, (1, 1 << 19, 16384)):
        sel = rng.random((h, p)) < 0.03
        sel[:, p - 1] = True
        pw, aw = (torch.from_numpy(np.ascontiguousarray(x).view(
            np.int32)).to(dev) for x in (
                np.where(sel, np.arange(p, dtype=np.uint32) + 1,
                         np.uint32(0)),
                np.where(sel, rng.integers(0, 0x7BFF, (h, p)).astype(
                    np.uint32), np.uint32(0))))
        out.append((f"[{h}, {p}]",
                    lambda pw=pw, aw=aw, k=k: compact.compact_payload_pair(
                        pw, aw, k),
                    compact.compact_payload_pair_torch(pw, aw, k)))
    return out


def event_calls(cs, dev):
    """K18's calls on phase 3's input (static step 2), on ``[64, 32768]``
    rows with 2 % events and with every lane an event (each row's k128
    outputs full), each with its plain version's outputs: ``[(label, fn,
    want)]``."""
    import numpy as np
    import torch

    import kernel_ab
    from orbitanalysis_tpu_torch.ops import compact

    rng = np.random.default_rng(1)
    h, p, k = cs.ANGLE_ROWS
    out = [(" phase 3", kernel_ab.k18_args(cs, dev))]
    for tag, density in ((" 2 %", 0.02), (" every lane", 1.0)):
        sel = rng.random((h, p)) < density
        planes = [rng.integers(0, 1 << 31, (h, p)).astype(np.uint32)
                  | (sel.astype(np.uint32) << np.uint32(31)),
                  rng.integers(0, 1 << 32, (h, p), dtype=np.uint64).astype(
                      np.uint32),
                  rng.integers(0, 1 << 31, (h, p)).astype(np.uint32)]
        out.append((tag, [torch.from_numpy(x.view(np.int32)).to(dev)
                          for x in planes] + [k]))
    return [(tag, lambda a=a: compact.compact_events(*a),
             compact.compact_events_torch(*a)) for tag, a in out]


def stream_calls(cs, dev, which):
    """P1's and P3's calls on a seeded ``[2048, 65536]`` f32 plane, each
    with its plain version's outputs, by kernel: ``{kernel: [(label,
    fn, want)]}``; prints torch's ``x + 1`` on the same planes and P2's
    ``man16x4`` (the package's build) first."""
    import torch

    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.probes import dma_probe

    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn((2048, dma_probe.LANES), generator=gen, device=dev)
    planes = dma_probe.variant_input(dma_probe.VARIANTS["pallas5"](), x)
    for tag, fn in (("torch x + 1 (xla)", lambda: x + 1.0),
                    ("torch x + 1 on 5 planes (xla5)",
                     lambda: tuple(p + 1.0 for p in planes)),
                    ("P2 man16x4 (package build)",
                     lambda: dma_probe.stream_add_ring(x, 16, 4)),
                    ("P2 man8x8 (package build)",
                     lambda: dma_probe.stream_add_ring(x, 8, 8))):
        times = [cs.cuda_ms(fn) for _ in range(2)]
        print(f"{tag}: {times[0]:.5f} {times[1]:.5f} ms", flush=True)
    calls, whole = {}, (x + 1.0,)
    if "P1" in which:
        calls["P1"] = []
        for name in ("auto8", "auto32", "pallas5"):
            fn = dma_probe.VARIANTS[name]()
            xin = dma_probe.variant_input(fn, x)
            want = (tuple(p + 1.0 for p in xin) if fn.n_planes else whole)
            run = ((lambda fn=fn, xin=xin: fn(xin)) if fn.n_planes
                   else (lambda fn=fn, xin=xin: (fn(xin),)))
            calls["P1"].append((name, run, want))
    if "P2" in which:
        calls["P2"] = x
    if "P3" in which:
        calls["P3"] = [
            (f"{name} at {b} B a row",
             lambda c=c, n=n, d=d, b=b: (_cuda.stream_add_split(
                 x, c * b, n, d),), whole)
            for name, (c, n, d) in P3_CALLS.items() for b in P3_ROW_BYTES]
    return calls


def clock_spread(clock):
    """Each block's start and end (``[grid, 2]`` ns on the card's clock)
    as one line: the span from the first start to the last end, the
    range of the starts and of the ends, the ends' spread as a share of
    the span, and the median end."""
    import numpy as np

    c = np.asarray(clock, dtype=np.int64)
    t0 = c[:, 0].min()
    start, end = (c[:, 0] - t0) / 1e3, (c[:, 1] - t0) / 1e3
    spread = end.max() - end.min()
    return (f"{len(c)} blocks, span {end.max():.2f} us; starts "
            f"{start.min():.2f}-{start.max():.2f} us; ends {end.min():.2f}-"
            f"{end.max():.2f} us (spread {spread:.2f} us = "
            f"{100 * spread / end.max():.1f} % of the span), median end "
            f"{np.median(end):.2f} us")


def ring_runs(lib, x, n_sm, parent=False):
    """P2's calls on ``x``, each with its plain version's output and its
    block clocks: ``[(label, fn, want, clocked)]``, ``clocked()`` one
    call's ``[grid, 2]`` clock on the host.  Every ``man*`` variant at
    ``ring_plan``'s grid, and ``man16x4`` at one block an SM.  ``parent``:
    ``lib`` is the parent's build (its C signature, its clock read back
    from ``ring_clock_read``), run at one block an SM (its own grid)
    and at ``ring_plan``'s blocks an SM."""
    import torch

    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.probes import dma_probe

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if parent:
        lib.stream_add_ring.argtypes = [p, p, ll, i, i, i, p]
        lib.ring_clock_read.argtypes = [p, i]

    def parent_call(stage, n_buf, grid):
        y = torch.empty_like(x)
        rc = lib.stream_add_ring(x.data_ptr(), y.data_ptr(), x.numel() * 4,
                                 stage, n_buf, grid,
                                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"parent stream_add_ring failed: {rc}")
        return y

    def parent_clocked(stage, n_buf, grid):
        parent_call(stage, n_buf, grid)
        torch.cuda.synchronize()
        out = (ctypes.c_ulonglong * (2 * grid))()
        if lib.ring_clock_read(ctypes.cast(out, p), grid) != 0:
            raise RuntimeError("ring_clock_read failed")
        return [[out[2 * b], out[2 * b + 1]] for b in range(grid)]

    def own_clocked(stage, n_buf, grid):
        return with_library(lib, lambda: _cuda.stream_add_ring_on(
            x, stage, n_buf, grid, clock=True)[1].cpu().tolist())()

    want, n_bytes, runs = (x + 1.0,), x.numel() * 4, []
    for name in P2_CALLS:
        q = dma_probe.VARIANTS[name]().params
        stage, n_buf = q["chunk_rows"] * dma_probe.STAGE_ROW_BYTES, q["n_buf"]
        grid, per_sm = _cuda.ring_plan(n_bytes, stage, n_buf, n_sm)
        grids = [(grid, per_sm)]
        if name == "man16x4" or parent:
            grids = ([(n_sm, 1)] if parent else []) + grids + (
                [] if parent else [(n_sm, 1)])
        for g, k in dict.fromkeys(grids):
            tag = f" {name} at {k} an SM ({g} blocks)"
            if parent:
                fn = (lambda s=stage, b=n_buf, g=g: (parent_call(s, b, g),))
                clocked = (lambda s=stage, b=n_buf, g=g: parent_clocked(
                    s, b, g))
            else:
                fn = with_library(lib, lambda s=stage, b=n_buf, g=g: (
                    _cuda.stream_add_ring_on(x, s, b, g)[0],))
                clocked = (lambda s=stage, b=n_buf, g=g: own_clocked(s, b, g))
            runs.append((tag, fn, want, clocked if name == "man16x4"
                         else None))
    return runs


def main(which="K1,K3,K4,K8,K15,K16,K17,K18,K19", parent=None):
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    import kernel_ab
    from orbitanalysis_tpu_torch.ops import compact, label, merge
    from orbitanalysis_tpu_torch.ops import step as tstep

    which = set(which.split(","))
    if parent and "P2" in which:
        which.add("P2p")
    variants = [v for v in VARIANTS if v[0] in which]
    dev = torch.device("cuda")
    libs, logs = build(variants, parent and os.path.abspath(parent))
    calls = {}
    if "K1" in which:
        x, k1 = kernel_ab.k1_plane(cs, dev)
        calls["K1"] = (lambda: (compact.compact_angle_blocked(x, k1),),
                       (compact.compact_angle_blocked_torch(x, k1),))
    if "K3" in which:
        calls["K3"] = pair_calls(cs, dev)
    if "K18" in which:
        calls["K18"] = event_calls(cs, dev)
    if "K19" in which:
        calls["K19"] = [
            (tag, lambda a=a: sum(compact.compact_rows(*a), ()),
             sum(compact.compact_rows_torch(*a), ()))
            for tag, a in kernel_ab.k19_args(cs, dev).items()]
    if "K15" in which:
        a15 = kernel_ab.k15_args(cs, dev)
        calls["K15"] = (lambda: merge.merge_rows(*a15),
                        merge.merge_rows_torch(*a15))
    if which & {"K4", "K8"}:
        args, _ = cs._detect_inputs(dev, kernel_ab.label_work(cs, dev), True)
        kw = dict(pericentric=True, box_size=cs.LABEL_BOX, rhat_packed=True)
        k = cs.LABEL_K
        pay = label.detect_label(*args, 0.0, **kw)[3]
        calls["K4"] = (lambda: (compact.compact_payload(pay, k),),
                       (compact.compact_payload_torch(pay, k),))
        kw["event_capacity"] = k
        calls["K8"] = (lambda: label.detect_label_compact(*args, 0.0, **kw),
                       label.detect_label_compact_torch(*args, 0.0, **kw))
    if which & {"P1", "P2", "P3"}:
        calls.update(stream_calls(cs, dev, which))
    if which & {"K16", "K17"}:
        (prev, cur, peri, invalid, cap), k17 = kernel_ab.detect_inputs(
            cs, dev)
        (a17, kw17) = k17[0]  # the native call of the aligned churn step
        h, p = prev[0].shape
        calls["K16"] = ("fused_join_detect", [*prev, *cur],
                        compact._k128(cap, p), [int(invalid), int(peri)],
                        tstep.fused_join_detect_torch(prev, cur, peri,
                                                      invalid, cap))
        calls["K17"] = ("static_detect_rows",
                        [t.contiguous() for t in (*a17[0][1:], *a17[1])],
                        compact._k128(a17[4], p),
                        [int(a17[3]), int(a17[2]),
                         int(kw17.get("native", False))],
                        tstep.fused_static_detect_torch(*a17, **kw17))
    print(f"{torch.cuda.get_device_name(0)}; K1 on phase 3's angle words, "
          "K4 on the payload plane and K8 on the inputs of label step 3, "
          "K15 on unfused sorted churn step 2 (six channels), K16 on sorted "
          "churn step 2, K17 on aligned churn step 2 (native), [64, 32768]; "
          "K3 on 3 % events; K18 on sorted static step 2 and synthetic "
          "rows; K19 on unfused sorted churn step 2",
          flush=True)
    for i, (kernel, name, _, checked) in enumerate(variants):
        if kernel == "P1":
            from orbitanalysis_tpu_torch.ops import _cuda

            grid, threads, per_sm = with_library(
                libs[i], lambda: _cuda.rows_launch(2048 * 65536 // 4, dev))()
            print(f"P1 {name}: the wrapper's plan, {grid} blocks of "
                  f"{threads} threads ({per_sm} an SM)", flush=True)
        clocks = {}
        if kernel in ("P2", "P2p"):
            runs = []
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            for tag, fn, want, clocked in ring_runs(
                    libs[i], calls["P2"], n_sm, kernel == "P2p"):
                runs.append((tag, fn, fn, want))
                if clocked:
                    clocks[tag] = clocked
        elif kernel in ("K3", "K18", "K19", "P1", "P3"):
            runs = [(f" {tag}", with_library(libs[i], fn), want)
                    for tag, fn, want in calls[kernel]]
            runs = [(tag, fn, fn, want) for tag, fn, want in runs]
        elif kernel in ("K1", "K4", "K8", "K15"):
            fn, want = calls[kernel]
            fn = with_library(libs[i], fn)
            runs = [("", fn, fn, want)]
        else:
            entry, planes, k128, flags, want = calls[kernel]
            h, p = planes[0].shape
            fn = launcher(libs[i], entry, planes, h, p, k128, flags)
            runs = [("", fn, lambda fn=fn: fn(True), want)]
        for tag, fn, fn_poison, want in runs:
            ne = 0
            for got in (fn_poison(), fn_poison()):
                torch.cuda.synchronize()
                ne = max(ne, cs._bitwise(got, want)[0])
            cs.check(ne == 0 or not checked,
                     f"{kernel} {name}{tag} differs from its plain version")
            times = [cs.cuda_ms(fn) for _ in range(2)]
            note = ("" if checked
                    else f" (leaves a phase out: {ne} lanes differ)")
            print(f"{kernel} {name}{tag}: {times[0]:.5f} {times[1]:.5f} "
                  f"ms{note}", flush=True)
            if tag in clocks:
                for _ in range(2):
                    print(f"  block clocks: {clock_spread(clocks[tag]())}",
                          flush=True)
        print("\n".join(ptxas_lines(logs[i], KERNEL_FUNCTIONS[kernel])),
              flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
