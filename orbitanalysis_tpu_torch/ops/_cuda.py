"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one
process per source, all started together) and links them into one
shared library with a plain C interface under the package's git-ignored
``_build/`` directory, named by a hash of the sources and flags; ctypes
loads it.  Launches take device pointers from ``Tensor.data_ptr()`` and
run on PyTorch's current stream; each C entry point returns
``cudaGetLastError()`` and the wrapper raises if it is not 0.  Each
kernel keeps a plain count of its launches.

Nothing here runs at import: this module imports on machines without
CUDA or nvcc, and only a launch needs them.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
#: --fmad=false: no a*b+c contraction, so the kernels round as the plain
#: torch versions do; IEEE sqrt and division stated (nvcc's defaults).
#: K14 (``nbody.cu``), held to a tolerance and not to bits, writes its
#: FMAs out (``fmaf``), which the flag leaves alone.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-prec-sqrt=true", "-prec-div=true", "-Xcompiler",
    "-fPIC",
]

#: What ``nvcc -Xptxas -v`` printed for each source at the last build
#: (registers, shared memory and spills of every kernel), by file name.
build_log: dict = {}


class Kernel:
    """A kernel entry point of the library, with its launch count."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.route = "cuda"
        self.source = source
        self.replaces = replaces
        self.launches = 0


_SRC = "orbitanalysis_tpu_torch/csrc/"
_JAX = "orbitanalysis_tpu/ops/"
#: The probe scripts of the JAX package, whose four kernels P1-P4 the
#: port's ``probes/`` run as ``csrc/probe.cu``.
_BENCH = "benchmarks/"


def _sites(*lines):
    """The ``pl.pallas_call`` sites a kernel replaces, comma-separated
    (one CUDA kernel serves K1/K2, K4/K5, K6/K11 and K7/K12)."""
    return ", ".join(_JAX + x for x in lines)


#: What the aligned step's fused frame-and-detect kernels stand for: no
#: Pallas kernel, but the chain XLA fuses on the TPU.
_FUSED_CHAIN = ("none: XLA's fusion of " + _JAX + "geometry.py:42 "
                "region_frame and " + _JAX + "sorted_step.py:734 "
                "aligned_detect_math")
#: What the PM force's interpolation kernel stands for: no Pallas kernel,
#: but the gathers XLA fuses on the TPU.
_GATHER_CHAIN = ("none: XLA's fusion of orbitanalysis_tpu/models/pm.py:129 "
                 "cic_interpolate")


KERNELS = {
    k.name: k for k in (
        Kernel("compact_angle_rows", _SRC + "compact.cu",
               _sites("pallas_compact.py:426", "pallas_compact.py:305")),
        Kernel("compact_pair_rows", _SRC + "compact.cu",
               _sites("pallas_compact.py:649")),
        Kernel("compact_payload_rows", _SRC + "compact.cu",
               _sites("pallas_compact.py:240", "pallas_compact.py:502")),
        Kernel("frame_rows", _SRC + "frames.cu",
               _sites("pallas_frames.py:184", "pallas_frames.py:94")),
        Kernel("segment_moments", _SRC + "frames.cu",
               _sites("pallas_frames.py:259", "pallas_frames.py:339")),
        Kernel("detect_label_compact_rows", _SRC + "label.cu",
               _sites("pallas_label.py:555")),
        Kernel("detect_label_rows", _SRC + "label.cu",
               _sites("pallas_label.py:395")),
        Kernel("fused_label_rows", _SRC + "label.cu",
               _sites("pallas_label.py:273")),
        Kernel("merge_rows", _SRC + "merge.cu",
               _sites("pallas_merge.py:176")),
        Kernel("fused_join_detect", _SRC + "merge.cu",
               _sites("pallas_step.py:457")),
        Kernel("static_detect_rows", _SRC + "static.cu",
               _sites("pallas_step.py:360")),
        Kernel("aligned_moments", _SRC + "static.cu", _FUSED_CHAIN),
        Kernel("aligned_frame_detect", _SRC + "static.cu", _FUSED_CHAIN),
        Kernel("compact_events_rows", _SRC + "compact.cu",
               _sites("pallas_compact.py:173")),
        Kernel("compact_rows_groups", _SRC + "compact.cu",
               _sites("pallas_compact.py:137")),
        Kernel("deposit_sorted", _SRC + "deposit.cu",
               _sites("pallas_deposit.py:217")),
        Kernel("cic_interpolate", _SRC + "interp.cu", _GATHER_CHAIN),
        Kernel("direct_forces", _SRC + "nbody.cu",
               _sites("pallas_nbody.py:130")),
        Kernel("stream_add_rows", _SRC + "probe.cu",
               _BENCH + "dma_probe.py:68"),
        Kernel("stream_add_ring", _SRC + "probe.cu",
               _BENCH + "dma_probe.py:144"),
        Kernel("stream_add_split", _SRC + "probe.cu",
               _BENCH + "dma_probe.py:244"),
        Kernel("detect_stream_rows", _SRC + "probe.cu",
               _BENCH + "detect_probe.py:138"),
    )
}

_lock = threading.Lock()
_lib = None


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def sources() -> list:
    """The CUDA sources built into the library (``.cu``), sorted."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "orbitanalysis_tpu_torch are built from source at first use"
    )


def library_path() -> str:
    """The library's path: a hash of every source and header of
    ``csrc/`` and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libkernels-{h.hexdigest()[:16]}.so")


def build() -> float:
    """Compile the kernel library if it is not built yet; returns the
    seconds nvcc took (0.0 when it was already built).  Raises
    RuntimeError with nvcc's output when a compile or the link fails."""
    so = library_path()
    if os.path.exists(so):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sources():
        obj = os.path.join(
            BUILD_DIR, os.path.basename(src)[:-3] + f".{tag}.o")
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        build_log[os.path.basename(src)] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{src}:\n{out}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{so}.{tag}"
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({link.returncode}) linking {so}:\n"
                f"{link.stdout}{link.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return time.perf_counter() - t0


def bind(lib):
    """Set the argument and result types of every entry point that the
    loaded library ``lib`` exports (a variant built from one source
    exports only that source's); returns ``lib``."""
    p, i, ll, f = (ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_float)
    pp = ctypes.POINTER(ctypes.c_void_p)
    signatures = {
        "compact_angle_rows_scratch": [i, i],
        "compact_angle_rows": [p, p, p, ll, i, i, i, p],
        "compact_pair_rows_scratch": [i, i],
        "compact_pair_rows": [p, p, p, p, p, ll, i, i, i, p],
        "compact_payload_rows_scratch": [i, i],
        "compact_payload_rows": [p, p, p, ll, i, i, i, p],
        "frame_rows": [p, p, p, i, i, ll, p],
        "segment_moments_geometry": [i, i, ctypes.POINTER(i),
                                     ctypes.POINTER(i)],
        "segment_moments": [p, p, p, p, p, i, ll, i, i, i, p],
        "detect_label_rows": [p] * 12 + [i, i, f, f, i, i, i, p],
        "detect_label_compact_rows_scratch": [i, i],
        "detect_label_compact_rows": [p] * 13 + [ll, i, i, i, f, f, i, i,
                                                 i, p],
        "fused_label_rows": [p] * 12 + [i, i, i, f, f, i, i, i, p],
        "merge_rows": [pp, pp, pp, i, i, i, p],
        "fused_join_detect_scratch": [i, i],
        "fused_join_detect": [p] * 17 + [ll] + [i] * 5 + [p],
        "static_detect_rows_scratch": [i, i],
        "static_detect_rows": [p] * 16 + [ll] + [i] * 6 + [p],
        "aligned_moments_tiles": [i],
        "aligned_moments": [p] * 4 + [i] * 4 + [p],
        "aligned_frame_detect": [p] * 18 + [i] * 4 + [f] * 4 + [i] * 5 + [p],
        "compact_events_rows_scratch": [i, i],
        "compact_events_rows": [p] * 7 + [ll, i, i, i, p],
        "compact_rows_groups_scratch": [i, i],
        "compact_rows_groups": [p, pp, pp, i, i, p, pp, pp, i, i, p, ll, i,
                                i, p],
        "deposit_sorted": [p, p, p, p, i, ll, i, i, p],
        "cic_interpolate": [p, p, p, ll, i, f, i, p],
        "cic_interpolate_stream": [p, p, p, p, p, ll, i, p],
        "direct_forces": [p, p, p, p, i, i, i, f, f, i, f, f, p],
        "stream_add_rows_geometry": [ctypes.POINTER(i), ctypes.POINTER(i)],
        "stream_add_rows": [p, p, ll, i, p],
        "stream_add_ring_geometry": [i, i, ctypes.POINTER(i),
                                     ctypes.POINTER(i)],
        "stream_add_ring": [p, p, ll, i, i, i, i, p, p, p],
        "stream_add_split": [p, p, ll, i, i, i, i, p],
        "detect_stream_rows": [p] * 12 + [i, i, p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ll if name.endswith("_scratch") else i
    return lib


def _library():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                build()
                _lib = bind(ctypes.CDLL(library_path()))
    return _lib


def on_cpu(x: torch.Tensor, what: str) -> bool:
    """Where a wrapper routes: True for a CPU tensor (the plain-torch
    version), False for a CUDA tensor (the kernel); ValueError for any
    other device.  Nothing falls back from one to the other."""
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"no {what} kernel for device {x.device}")


def _check(name, *tensors, dtype=torch.int32, dim=2):
    for t in tensors:
        if not t.is_cuda or t.dtype != dtype or t.dim() != dim:
            raise ValueError(
                f"{name}: want {dim}-D {dtype} CUDA tensors, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: tensors on different devices")


def _launch(name, fn, *args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    KERNELS[name].launches += 1


def _lookback_scratch(name, h, p, device):
    """The decoupled look-back's scratch for one launch of ``name`` over
    ``h`` rows of ``p`` (a tile counter and an 8-byte status word a tile:
    ``{name}_scratch(H, P)`` int64 words), allocated on the caller's
    stream; the entry point zeroes it before its launch, so two calls on
    two streams never share one.  Returns ``(scratch, words)``."""
    words = getattr(_library(), f"{name}_scratch")(h, p)
    return torch.empty(words, dtype=torch.int64, device=device), words


def _compact_tiles(name, k128, *planes):
    """Launch one of the tile compactions of ``csrc/compact.cu`` on its
    ``[H, P]`` int32 (uint32 words) input ``planes`` with its own
    look-back scratch: one ``[H, k128]`` int32 output a plane, zero past
    each row's count."""
    x = planes[0]
    h, p = x.shape
    if any(t.shape != x.shape for t in planes):
        raise ValueError(f"{name}: input shapes differ")
    outs = [torch.empty((h, k128), dtype=torch.int32, device=x.device)
            for _ in planes]
    _check(name, *planes, *outs)
    scratch, words = _lookback_scratch(name, h, p, x.device)
    _launch(name, getattr(_library(), name), *(t.data_ptr() for t in planes),
            *(o.data_ptr() for o in outs), scratch.data_ptr(), words, h, p,
            k128, device=x.device)
    return outs


def compact_angle_rows(aw: torch.Tensor, k128: int) -> torch.Tensor:
    """Launch the angle-word compaction (K1/K2): ``aw [H, P]`` int32
    (uint32 words ``f32_bits(angle) | apsis << 31``) -> ``[H, k128]``
    int32 payload words ``((pos + 1) << 15) | f16(angle)``, events
    front-packed in position order, zero past each row's count."""
    return _compact_tiles("compact_angle_rows", k128, aw)[0]


def compact_pair_rows(posw: torch.Tensor, angw: torch.Tensor, k128: int):
    """Launch the two-stream compaction (K3): ``posw [H, P]`` (an event
    where the word is not 0) and ``angw [H, P]`` (read at the events) ->
    two ``[H, k128]`` int32 planes, zero past each row's count."""
    return tuple(_compact_tiles("compact_pair_rows", k128, posw, angw))


def compact_payload_rows(payload: torch.Tensor, k128: int) -> torch.Tensor:
    """Launch the payload-word compaction (K4/K5): ``payload [H, P]``
    int32 (uint32 words, an event where the word is >= 2**15) -> ``[H,
    k128]`` int32, events front-packed in position order, zero past each
    row's count."""
    return _compact_tiles("compact_payload_rows", k128, payload)[0]


def frame_rows(table: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Launch the frame-row gather: ``table [H, C]`` f32, ``labels [N]``
    int32 -> ``[C, N]`` f32, ``table[label, c]`` and 0 where the label
    is outside ``[0, H)``."""
    h, c = table.shape
    n = labels.shape[0]
    out = torch.empty((c, n), dtype=torch.float32, device=labels.device)
    _check("frame_rows", table, out, dtype=torch.float32)
    _check("frame_rows", labels, dim=1)
    if table.device != labels.device:
        raise ValueError("frame_rows: tensors on different devices")
    _launch("frame_rows", _library().frame_rows, table.data_ptr(),
            labels.data_ptr(), out.data_ptr(), h, c, n, device=labels.device)
    return out


#: Shared memory the moments kernel may give its per-warp histograms.
_MOMENTS_SMEM = 200 * 1024


def segment_moments(labels: torch.Tensor, vel: torch.Tensor,
                    mass: torch.Tensor | None, n_halos: int) -> torch.Tensor:
    """Launch the per-halo moments: ``labels [N]`` int32, ``vel [3, N]``
    f32, ``mass [N]`` f32 or None -> ``[H, 4]`` f32 ``[sum m v, sum m]``
    over labels in ``[0, H)``: float32 products summed in float64 in an
    order fixed by N and H, rounded to float32 once."""
    n = labels.shape[0]
    _check("segment_moments", labels, dim=1)
    _check("segment_moments", vel, dtype=torch.float32)
    if vel.shape != (3, n):
        raise ValueError(f"segment_moments: vel must be [3, {n}]")
    if mass is not None:
        _check("segment_moments", mass, dtype=torch.float32, dim=1)
        if mass.shape != (n,):
            raise ValueError(f"segment_moments: mass must be [{n}]")
    if len({t.device for t in (labels, vel, mass) if t is not None}) > 1:
        raise ValueError("segment_moments: tensors on different devices")
    lib = _library()
    warps, chunk = ctypes.c_int(), ctypes.c_int()
    lib.segment_moments_geometry(int(n_halos), _MOMENTS_SMEM,
                                 ctypes.byref(warps), ctypes.byref(chunk))
    if warps.value < 1:
        raise ValueError(
            f"segment_moments: {n_halos} halos exceed the kernel's "
            "shared-memory histogram")
    n_blocks = -(-n // chunk.value)
    partial = torch.empty((n_blocks, n_halos, 4), dtype=torch.float64,
                          device=labels.device)
    out = torch.empty((n_halos, 4), dtype=torch.float32,
                      device=labels.device)
    _launch("segment_moments", lib.segment_moments, labels.data_ptr(),
            vel.data_ptr(), None if mass is None else mass.data_ptr(),
            partial.data_ptr(), out.data_ptr(), int(n_halos), n,
            warps.value, chunk.value, n_blocks, device=labels.device)
    return out


def _detect_inputs(name, rows, lab, pos, vel, sv, rhat, packed,
                   rhat_packed):
    """Checks the detect passes' planes; ``rows`` is the ``[6, R, W]``
    rows plane (K8, K9) or the ``[H, 6]`` frame table (K10)."""
    r, w = lab.shape
    _check(name, lab, sv, packed)
    _check(name, pos, vel, dtype=torch.float32, dim=3)
    _check(name, rows, dtype=torch.float32, dim=rows.dim())
    if rhat_packed:
        _check(name, rhat)
    else:
        _check(name, rhat, dtype=torch.float32, dim=3)
    rows_want = (rows.shape[0], 6) if rows.dim() == 2 else (6, r, w)
    for t, want in ((rows, rows_want), (pos, (3, r, w)), (vel, (3, r, w)),
                    (sv, (r, w)), (packed, (r, w)),
                    (rhat, (r, w) if rhat_packed else (3, r, w))):
        if t.shape != want:
            raise ValueError(f"{name}: want shape {want}, got "
                             f"{tuple(t.shape)}")
    if len({t.device for t in (rows, lab, pos, vel, sv, rhat,
                               packed)}) > 1:
        raise ValueError(f"{name}: tensors on different devices")
    return r, w


def _scalars(hub, box, pericentric, rhat_packed):
    return (ctypes.c_float(hub), ctypes.c_float(0.0 if box is None else box),
            int(box is not None), int(pericentric), int(rhat_packed))


def _detect_payload(name, rows, lab, pos, vel, sv, rhat, packed, hub,
                    box, pericentric, rhat_packed, *lead):
    """Launch K9 or K10 (``lead``: K10's halo count before R and W):
    returns ``(sv', rhat', packed', payload [R, W], count [R])``."""
    r, w = _detect_inputs(name, rows, lab, pos, vel, sv, rhat, packed,
                          rhat_packed)
    osv, orh, opk = (torch.empty_like(sv), torch.empty_like(rhat),
                     torch.empty_like(packed))
    pay = torch.empty_like(packed)
    count = torch.zeros(r, dtype=torch.int32, device=lab.device)
    _launch(name, getattr(_library(), name), rows.data_ptr(),
            lab.data_ptr(), pos.data_ptr(), vel.data_ptr(), sv.data_ptr(),
            rhat.data_ptr(), packed.data_ptr(), osv.data_ptr(),
            orh.data_ptr(), opk.data_ptr(), pay.data_ptr(),
            count.data_ptr(), *lead, r, w,
            *_scalars(hub, box, pericentric, rhat_packed), device=lab.device)
    return osv, orh, opk, pay, count


def detect_label_rows(rows, lab, pos, vel, sv, rhat, packed, hub: float,
                      box, pericentric: bool, rhat_packed: bool):
    """Launch the detect pass without compaction (K9): returns
    ``(sv', rhat', packed', payload [R, W], count [R])``."""
    return _detect_payload("detect_label_rows", rows, lab, pos, vel, sv,
                           rhat, packed, hub, box, pericentric, rhat_packed)


def fused_label_rows(table, lab, pos, vel, sv, rhat, packed, hub: float,
                     box, pericentric: bool, rhat_packed: bool):
    """Launch the fused detect pass (K10): ``table [H, 6]`` f32 (halo
    centre ++ bulk velocity) in place of K9's rows plane, the same
    outputs ``(sv', rhat', packed', payload [R, W], count [R])``."""
    return _detect_payload("fused_label_rows", table, lab, pos, vel, sv,
                           rhat, packed, hub, box, pericentric, rhat_packed,
                           table.shape[0])


def detect_label_compact_rows(rows, lab, pos, vel, sv, rhat, packed,
                              hub: float, box, pericentric: bool,
                              rhat_packed: bool, k128: int):
    """Launch the detect pass with its exact event compaction (K8):
    returns ``(sv', rhat', packed', events [R, k128], count [R])``."""
    name = "detect_label_compact_rows"
    r, w = _detect_inputs(name, rows, lab, pos, vel, sv, rhat, packed,
                          rhat_packed)
    osv, orh, opk = (torch.empty_like(sv), torch.empty_like(rhat),
                     torch.empty_like(packed))
    ev = torch.empty((r, k128), dtype=torch.int32, device=lab.device)
    count = torch.empty(r, dtype=torch.int32, device=lab.device)
    scratch, words = _lookback_scratch(name, r, w, lab.device)
    _launch(name, _library().detect_label_compact_rows, rows.data_ptr(),
            lab.data_ptr(), pos.data_ptr(), vel.data_ptr(), sv.data_ptr(),
            rhat.data_ptr(), packed.data_ptr(), osv.data_ptr(),
            orh.data_ptr(), opk.data_ptr(), ev.data_ptr(),
            count.data_ptr(), scratch.data_ptr(), words, r, w, k128,
            *_scalars(hub, box, pericentric, rhat_packed), device=lab.device)
    return osv, orh, opk, ev, count


def _pointers(tensors):
    """A ctypes array of the tensors' device pointers (the C entry points
    copy it into their kernel arguments before they return)."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


#: Channels a merge or a compaction group moves together (the C side's
#: kMaxStreams).
MAX_STREAMS = 6


def merge_rows(prev, cur):
    """Launch the merge of presorted rows (K15): ``prev``/``cur`` tuples
    ``(key, *payloads)`` of ``[H, P]`` 32-bit planes (keys as int32 bit
    patterns of uint32, ``prev`` ascending and ``cur`` descending) ->
    the ``[H, 2P]`` planes of a stable sort of the concatenation."""
    name = "merge_rows"
    if not 1 <= len(prev) == len(cur) <= MAX_STREAMS:
        raise ValueError(f"{name}: 1 to {MAX_STREAMS} channels a side, "
                         "the same number on both")
    h, p = prev[0].shape
    for a, b in zip(prev, cur):
        _check(name, a, b, dtype=a.dtype)
        if a.element_size() != 4 or a.dtype != b.dtype:
            raise ValueError(f"{name}: channels must be matching 32-bit "
                             "dtypes")
        if a.shape != (h, p) or b.shape != (h, p):
            raise ValueError(f"{name}: every channel must be [{h}, {p}]")
    _check(name, prev[0], cur[0])
    out = [torch.empty((h, 2 * p), dtype=a.dtype, device=a.device)
           for a in prev]
    if len({t.device for t in (*prev, *cur)}) > 1:
        raise ValueError(f"{name}: tensors on different devices")
    _launch(name, _library().merge_rows, _pointers(prev), _pointers(cur),
            _pointers(out), len(prev), h, p, device=prev[0].device)
    return tuple(out)


def _check_pairs(name, prev, cur, pang_dtype):
    """Checks K16's and K17's ``prev = (key, sv, rx, ry, rz, angles)``
    and ``cur = (key, sv, rx, ry, rz)`` ``[H, P]`` planes: keys and sv
    int32, r-hat float32, the prev angles ``pang_dtype``.  Returns
    ``(H, P)``."""
    if len(prev) != 6 or len(cur) != 5:
        raise ValueError(f"{name}: want 6 prev and 5 cur planes")
    h, p = prev[0].shape
    _check(name, prev[0], prev[1], cur[0], cur[1])
    _check(name, *prev[2:5], *cur[2:], dtype=torch.float32)
    _check(name, prev[5], dtype=pang_dtype)
    for t in (*prev, *cur):
        if t.shape != (h, p):
            raise ValueError(f"{name}: every plane must be [{h}, {p}]")
    if len({t.device for t in (*prev, *cur)}) > 1:
        raise ValueError(f"{name}: tensors on different devices")
    return h, p


def _detect_events(name, planes, h, p, k128, *flags):
    """Launch K16 or K17 on the checked input ``planes`` (``flags``: the
    ints after k128), with its own look-back scratch
    (:func:`_lookback_scratch`).  Returns ``(packed [H, P], ev_key,
    ev_sv, ev_angle [H, k128], count [H])``."""
    dev = planes[0].device
    packed = torch.empty((h, p), dtype=torch.int32, device=dev)
    ev_key = torch.empty((h, k128), dtype=torch.int32, device=dev)
    ev_sv = torch.empty_like(ev_key)
    ev_ang = torch.empty((h, k128), dtype=torch.float32, device=dev)
    count = torch.empty(h, dtype=torch.int32, device=dev)
    scratch, words = _lookback_scratch(name, h, p, dev)
    _launch(name, getattr(_library(), name),
            *(t.data_ptr() for t in planes), packed.data_ptr(),
            ev_key.data_ptr(), ev_sv.data_ptr(), ev_ang.data_ptr(),
            count.data_ptr(), scratch.data_ptr(), words, h, p, k128, *flags,
            device=dev)
    return packed, ev_key, ev_sv, ev_ang, count


def fused_join_detect(prev, cur, pericentric: bool, invalid: int,
                      k128: int):
    """Launch the join-and-detect kernel (K16): ``prev = (key asc, sv,
    rx, ry, rz, angles)`` and ``cur = (key DESC, sv, rx, ry, rz)``,
    ``[H, P]`` planes (keys and sv int32, the rest float32).  Returns
    ``(packed [H, P], ev_key, ev_sv, ev_angle [H, k128], count [H])``."""
    name = "fused_join_detect"
    h, p = _check_pairs(name, prev, cur, torch.float32)
    return _detect_events(name, (*prev, *cur), h, p, k128, int(invalid),
                          int(pericentric))


def static_detect_rows(prev, cur, pericentric: bool, invalid: int,
                       k128: int, native: bool):
    """Launch the aligned detect kernel (K17): ``prev = (key, sv, rx, ry,
    rz, angles)`` and ``cur = (key, sv, rx, ry, rz)``, aligned ``[H, P]``
    planes; the prev angles are float32, or with ``native`` the packed
    int32 carry words.  The prev key is never read, so it is not passed.
    Returns ``(packed [H, P], ev_key, ev_sv, ev_angle [H, k128], count
    [H])``, the events in position order."""
    name = "static_detect_rows"
    h, p = _check_pairs(name, prev, cur,
                        torch.int32 if native else torch.float32)
    return _detect_events(name, (*prev[1:], *cur), h, p, k128, int(invalid),
                          int(pericentric), int(native))


def aligned_moments(ids, vel, mass, invalid: int, soa: bool):
    """Launch the aligned step's moment partials: ``ids [H, P]`` int32,
    ``vel`` ``[H, P, 3]`` (``[3, H, P]`` with ``soa``) and ``mass [H,
    P]`` (or None) float32 -> ``[H, T, 4]`` float64 partials ``[sum w m
    v, sum w m]`` of each row's T tiles (``w``: the ID is not
    ``invalid``), for :func:`aligned_frame_detect`."""
    name = "aligned_moments"
    h, p = ids.shape
    _check(name, ids)
    _check(name, vel, dtype=torch.float32, dim=3)
    if vel.shape != ((3, h, p) if soa else (h, p, 3)):
        raise ValueError(f"{name}: vel {tuple(vel.shape)} against ids "
                         f"{(h, p)}")
    if mass is not None:
        _check(name, mass, dtype=torch.float32)
        if mass.shape != (h, p):
            raise ValueError(f"{name}: mass must be [{h}, {p}]")
    if len({t.device for t in (ids, vel, mass) if t is not None}) > 1:
        raise ValueError(f"{name}: tensors on different devices")
    lib = _library()
    partial = torch.empty((h, lib.aligned_moments_tiles(p), 4),
                          dtype=torch.float64, device=ids.device)
    _launch(name, lib.aligned_moments, ids.data_ptr(), vel.data_ptr(),
            None if mass is None else mass.data_ptr(), partial.data_ptr(),
            h, p, int(invalid), int(soa), device=ids.device)
    return partial


def aligned_frame_detect(ids, slot, pos, vel, center, bulk, hub, box,
                         prev, pericentric: bool, invalid: int,
                         invalid_key: int, soa: bool, rhat_packed: bool,
                         pair: bool):
    """Launch the aligned step's fused frame-and-detect pass.

    ``ids``/``slot`` ``[H, P]`` int32; ``pos``/``vel`` ``[H, P, 3]``
    (``[3, H, P]`` with ``soa``) and ``center [H, 3]`` float32; ``bulk``:
    the ``[H, 3]`` float32 catalog bulk velocities, or the ``[H, T, 4]``
    float64 partials of :func:`aligned_moments`; ``hub``: the Hubble
    term, a float; ``box``: None or three floats; ``prev``: the carry's
    ``(sv, rhat, packed)`` (``rhat`` ``[3, H, P]`` float32, or ``[H, P]``
    int32 octahedral words with ``rhat_packed``).  Returns ``(key, sv, rhat, packed, words, count
    [H], bulk_vel [H, 3])``: ``words`` is K1's ``[H, P]`` angle-word
    plane, or with ``pair`` the ``(posw, ang16)`` planes of K3."""
    name = "aligned_frame_detect"
    h, p = ids.shape
    psv, prhat, ppacked = prev
    _check(name, ids, slot, psv, ppacked)
    for t in (ids, slot, psv, ppacked):
        if t.shape != (h, p):
            raise ValueError(f"{name}: every [H, P] plane must be "
                             f"[{h}, {p}]")
    _check(name, pos, vel, dtype=torch.float32, dim=3)
    if pos.shape != vel.shape or pos.shape != ((3, h, p) if soa
                                               else (h, p, 3)):
        raise ValueError(f"{name}: pos/vel {tuple(pos.shape)} against ids "
                         f"{(h, p)}")
    _check(name, center, dtype=torch.float32)
    moments = bulk.dtype == torch.float64
    _check(name, bulk, dtype=bulk.dtype, dim=3 if moments else 2)
    if center.shape != (h, 3) or (not moments and bulk.shape != (h, 3)):
        raise ValueError(f"{name}: centres and bulk velocities must be "
                         f"[{h}, 3]")
    if rhat_packed:
        _check(name, prhat)
        rhat_shape = (h, p)
    else:
        _check(name, prhat, dtype=torch.float32, dim=3)
        rhat_shape = (3, h, p)
    if prhat.shape != rhat_shape:
        raise ValueError(f"{name}: carried r-hat must be {rhat_shape}")
    tensors = (ids, slot, pos, vel, center, bulk, psv, prhat, ppacked)
    if len({t.device for t in tensors}) > 1:
        raise ValueError(f"{name}: tensors on different devices")
    dev = ids.device
    key, sv, packed = (torch.empty((h, p), dtype=torch.int32, device=dev)
                       for _ in range(3))
    rhat = torch.empty(rhat_shape, dtype=prhat.dtype, device=dev)
    words = torch.empty((h, p), dtype=torch.int32, device=dev)
    ang16 = torch.empty_like(words) if pair else None
    count = torch.empty(h, dtype=torch.int32, device=dev)
    bulk_out = torch.empty((h, 3), dtype=torch.float32,
                           device=dev) if moments else bulk
    box3 = (0.0, 0.0, 0.0) if box is None else box
    _launch(name, _library().aligned_frame_detect, ids.data_ptr(),
            slot.data_ptr(), pos.data_ptr(), vel.data_ptr(),
            center.data_ptr(), None if moments else bulk.data_ptr(),
            bulk.data_ptr() if moments else None,
            psv.data_ptr(), prhat.data_ptr(), ppacked.data_ptr(),
            key.data_ptr(), sv.data_ptr(), rhat.data_ptr(),
            packed.data_ptr(), words.data_ptr(),
            None if ang16 is None else ang16.data_ptr(),
            bulk_out.data_ptr() if moments else None, count.data_ptr(),
            h, p, int(invalid), int(invalid_key), ctypes.c_float(hub),
            *(ctypes.c_float(b) for b in box3), int(box is not None),
            int(pericentric), int(soa), int(rhat_packed), int(pair),
            device=dev)
    return (key, sv, rhat, packed, (words, ang16) if pair else words, count,
            bulk_out)


def compact_events_rows(packed, key, sv, k128: int):
    """Launch the three-word event compaction (K18): where bit 31 of
    ``packed [H, P]`` is set, ``(key, sv, packed)`` move together to the
    front of ``[H, k128]`` int32 rows, zero past each row's count
    (``key`` and ``sv`` are read only at the events)."""
    out_packed, out_key, out_sv = _compact_tiles(
        "compact_events_rows", k128, packed, key, sv)
    return out_key, out_sv, out_packed


def compact_rows_groups(sel_a, ops_a, len_a: int, sel_b, ops_b,
                        len_b: int):
    """Launch the stable two-group compaction (K19) with its own
    look-back scratch: ``sel_*`` ``[H, N]`` int32 0/1 masks, ``ops_*``
    tuples of 1 to 6 ``[H, N]`` 32-bit planes -> ``(tuple_a [H, len_a],
    tuple_b [H, len_b])``, the selected entries front-packed in order,
    zero past each row's count."""
    name = "compact_rows_groups"
    h, n = sel_a.shape
    _check(name, sel_a, sel_b)
    outs = []
    for ops, ln in ((ops_a, len_a), (ops_b, len_b)):
        if not 1 <= len(ops) <= MAX_STREAMS:
            raise ValueError(f"{name}: 1 to {MAX_STREAMS} channels a group")
        for t in ops:
            _check(name, t, dtype=t.dtype)
            if t.element_size() != 4 or t.shape != (h, n):
                raise ValueError(f"{name}: channels must be 32-bit "
                                 f"[{h}, {n}] planes")
        outs.append(tuple(torch.empty((h, ln), dtype=t.dtype,
                                      device=t.device) for t in ops))
    if len({t.device for t in (sel_a, sel_b, *ops_a, *ops_b)}) > 1:
        raise ValueError(f"{name}: tensors on different devices")
    # the kernel copies group a's channels 16 bytes a copy
    if n % 4 or any(t.data_ptr() % 16 for t in ops_a):
        raise ValueError(f"{name}: rows must be a multiple of 4 entries and "
                         "group a's planes 16-byte aligned")
    scratch, words = _lookback_scratch(name, h, n, sel_a.device)
    _launch(name, _library().compact_rows_groups, sel_a.data_ptr(),
            _pointers(ops_a), _pointers(outs[0]), len(ops_a), len_a,
            sel_b.data_ptr(), _pointers(ops_b), _pointers(outs[1]),
            len(ops_b), len_b, scratch.data_ptr(), words, h, n,
            device=sel_a.device)
    return outs[0], outs[1]


def deposit_sorted(keys: torch.Tensor, fracs: torch.Tensor, n_cells: int,
                   sx: int, sy: int) -> torch.Tensor:
    """Launch the sorted-stream CIC deposit (K13): ``keys [N]`` int32
    ascending base-cell keys on the virtual grid (strides ``sx``, ``sy``,
    1), ``fracs [4, N]`` f32 ``(fx, fy, fz, m)`` -> the flat virtual grid
    ``[n_cells]`` f32.  Keys outside ``[0, n_cells)`` deposit nothing."""
    name = "deposit_sorted"
    n = keys.shape[0]
    _check(name, keys, dim=1)
    _check(name, fracs, dtype=torch.float32)
    if fracs.shape != (4, n):
        raise ValueError(f"{name}: fracs must be [4, {n}]")
    if keys.device != fracs.device:
        raise ValueError(f"{name}: tensors on different devices")
    if n >= 2**31:
        raise ValueError(f"{name}: {n} entries exceed int32 indexing")
    if sy < 1 or sx % sy:
        raise ValueError(f"{name}: sx ({sx}) must be a multiple of sy ({sy})")
    rows = -(-n_cells // sy)
    if rows >= 2**31 - 1:
        raise ValueError(f"{name}: {n_cells} cells exceed int32 row indexing")
    # the row edges' stream offsets: 8 bytes a row of sy cells
    bounds = torch.empty((2, rows + 1), dtype=torch.int32,
                         device=keys.device)
    out = torch.empty(n_cells, dtype=torch.float32, device=keys.device)
    _launch(name, _library().deposit_sorted, keys.data_ptr(),
            fracs.data_ptr(), bounds.data_ptr(), out.data_ptr(), n, n_cells,
            sx, sy, device=keys.device)
    return out


#: The most x-slabs the interpolation kernel visits the field in: each
#: slab reads the positions once more (``csrc/interp.cu``).
INTERP_MAX_SLABS = 16


def interp_slabs(grid: int, l2_bytes: int) -> int:
    """The x-slabs of the interpolation kernel on a ``grid^3`` field: the
    fewest whose three float32 planes fit a third of the card's
    ``l2_bytes`` of L2, at most :data:`INTERP_MAX_SLABS` (12 at 256^3 on
    the H100's 50 MB)."""
    return max(1, min(INTERP_MAX_SLABS, -(-36 * grid ** 3 // l2_bytes)))


def cic_interpolate(field3: torch.Tensor, pos: torch.Tensor, grid: int,
                    box_size) -> torch.Tensor:
    """Launch the CIC interpolation: ``field3 [3, G, G, G]`` f32 (a
    periodic vector field on ``grid^3`` cells), ``pos [N, 3]`` f32 ->
    ``[N, 3]`` f32, each component's 8 corners weighted and added in
    corner order, as ``models/pm.py`` ``cic_interpolate_torch`` does
    (the cell size is the float32 ``box_size / grid``); the field visited
    in :func:`interp_slabs` x-slabs."""
    name = "cic_interpolate"
    n = pos.shape[0]
    _check(name, field3, dtype=torch.float32, dim=4)
    _check(name, pos, dtype=torch.float32)
    if field3.shape != (3, grid, grid, grid):
        raise ValueError(f"{name}: field3 must be [3, {grid}, {grid}, "
                         f"{grid}], got {tuple(field3.shape)}")
    if pos.shape != (n, 3):
        raise ValueError(f"{name}: pos must be [N, 3], got "
                         f"{tuple(pos.shape)}")
    if field3.device != pos.device:
        raise ValueError(f"{name}: tensors on different devices")
    slabs = interp_slabs(grid, torch.cuda.get_device_properties(
        pos.device).L2_cache_size)
    out = torch.empty((n, 3), dtype=torch.float32, device=pos.device)
    _launch(name, _library().cic_interpolate, field3.data_ptr(),
            pos.data_ptr(), out.data_ptr(), n, int(grid),
            ctypes.c_float(float(box_size) / grid), slabs, device=pos.device)
    return out


def cic_interpolate_stream(field3: torch.Tensor, skeys: torch.Tensor,
                           fracs: torch.Tensor, order: torch.Tensor,
                           grid: int) -> torch.Tensor:
    """Launch the stream form of the CIC interpolation (counted as
    ``cic_interpolate``): ``field3 [3, G, G, G]`` f32, the deposit's
    cell-sorted stream ``skeys [N]`` int32 (base-cell keys on the virtual
    ``(G+1)^3`` grid, each cell in ``[0, G)``), ``fracs [4, N]`` f32
    (rows 0-2 read) and ``order [N]`` int64 -> ``[N, 3]`` f32, row
    ``order[i]`` from entry ``i``, as ``models/pm.py``
    ``cic_interpolate_stream_torch`` computes it."""
    name = "cic_interpolate"
    n = skeys.shape[0]
    _check(name, field3, dtype=torch.float32, dim=4)
    _check(name, skeys, dtype=torch.int32, dim=1)
    _check(name, fracs, dtype=torch.float32)
    _check(name, order, dtype=torch.int64, dim=1)
    if field3.shape != (3, grid, grid, grid):
        raise ValueError(f"{name}: field3 must be [3, {grid}, {grid}, "
                         f"{grid}], got {tuple(field3.shape)}")
    if fracs.shape != (4, n) or order.shape != (n,):
        raise ValueError(f"{name}: want fracs [4, {n}] and order [{n}], got "
                         f"{tuple(fracs.shape)} and {tuple(order.shape)}")
    if (grid + 1) ** 3 >= 2**31:
        raise ValueError(f"{name}: the virtual {grid + 1}^3 grid's keys "
                         "exceed int32")
    if len({t.device for t in (field3, skeys, fracs, order)}) > 1:
        raise ValueError(f"{name}: tensors on different devices")
    out = torch.empty((n, 3), dtype=torch.float32, device=skeys.device)
    _launch(name, _library().cic_interpolate_stream, field3.data_ptr(),
            skeys.data_ptr(), fracs.data_ptr(), order.data_ptr(),
            out.data_ptr(), n, int(grid), device=skeys.device)
    return out


#: Targets a block of K14 owns (``csrc/nbody.cu``: kThreads * kTargets)
#: and the sources a thread stages a tile (kThreads).
K14_BLOCK_TARGETS, K14_TILE = 512, 128
#: K14 splits the sources while its target blocks number fewer than
#: this many a streaming multiprocessor.
K14_BLOCKS_PER_SM = 4


def direct_force_split(n: int, n_sm: int) -> tuple[int, int]:
    """``(splits, chunk)`` of K14 for ``n`` particles on a card of
    ``n_sm`` SMs: one chunk of all ``n`` sources where the target blocks
    fill :data:`K14_BLOCKS_PER_SM` blocks an SM, else the fewest chunks
    of whole tiles that bring the blocks up to it."""
    blocks = -(-n // K14_BLOCK_TARGETS)
    want = K14_BLOCKS_PER_SM * n_sm
    if n <= 0 or blocks >= want:
        return 1, max(n, 1)
    chunk = -(-n // -(-want // blocks))
    chunk = -(-chunk // K14_TILE) * K14_TILE
    return -(-n // chunk), chunk


def direct_forces(pos: torch.Tensor, mass: torch.Tensor, softening: float,
                  G: float, box_size) -> torch.Tensor:
    """Launch the blocked direct-summation forces (K14): ``pos [N, 3]``
    f32, ``mass [N]`` f32 -> ``[N, 3]`` f32 accelerations, minimum image
    when ``box_size`` is not None; the sources split into chunks by
    :func:`direct_force_split`, their partial sums added in chunk order
    (one launch counted)."""
    name = "direct_forces"
    n = pos.shape[0]
    _check(name, pos, dtype=torch.float32)
    _check(name, mass, dtype=torch.float32, dim=1)
    if pos.shape != (n, 3) or mass.shape != (n,):
        raise ValueError(f"{name}: want pos [N, 3] and mass [N], got "
                         f"{tuple(pos.shape)} and {tuple(mass.shape)}")
    if pos.device != mass.device:
        raise ValueError(f"{name}: tensors on different devices")
    if n >= 2**31 // 3:
        raise ValueError(f"{name}: {n} particles exceed int32 indexing")
    splits, chunk = direct_force_split(
        n, torch.cuda.get_device_properties(pos.device).multi_processor_count)
    out = torch.empty((n, 3), dtype=torch.float32, device=pos.device)
    partial = (torch.empty((splits, n, 3), dtype=torch.float32,
                           device=pos.device) if splits > 1 else None)
    f = ctypes.c_float
    box = 0.0 if box_size is None else float(box_size)
    _launch(name, _library().direct_forces, pos.data_ptr(), mass.data_ptr(),
            out.data_ptr(), None if partial is None else partial.data_ptr(),
            n, splits, chunk, f(float(softening) * float(softening)),
            f(float(G)), int(box_size is not None), f(box),
            f(1.0 / box if box_size is not None else 0.0),
            device=pos.device)
    return out


#: Shared memory a probe block may give its rings (the H100's 227 KB a
#: block, less the barriers).
RING_SMEM = 227 * 1024 - 1024
#: Shared memory of one H100 SM, which its resident blocks share (228
#: KB), and what the card holds back of it for each block (1 KB).
SM_SMEM = 228 * 1024
BLOCK_RESERVED_SMEM = 1024
#: Ring depths the probe kernels are built for (``csrc/probe.cu``).
RING_DEPTHS = (2, 4, 8)
#: P3's static shared memory: four mbarriers of 8 bytes a slot
#: (``csrc/probe.cu`` ``SplitBars``).
SPLIT_BARRIER_BYTES = 4 * 8
#: P2's threads a block (``csrc/probe.cu`` kRingThreads: a producer
#: warp, a store warp and four compute warps) and its static shared
#: memory a slot (``RingSlots``: three mbarriers and a stage tag of 8
#: bytes each).
RING_THREADS = 192
RING_SLOT_BYTES = 4 * 8
#: The least bytes P2's producer claims at a time: stages of 4 KiB go two
#: to a claim, which halves the atomics on the one claim counter
#: (``detect_variants.py P2``).
RING_CLAIM_BYTES = 8192
#: Threads and blocks one H100 SM holds at once.
SM_THREADS = 2048
SM_BLOCKS = 32


def _check_stream(name, x):
    _check(name, x, dtype=torch.float32, dim=x.dim())
    if x.numel() % 4 or x.data_ptr() % 16:
        raise ValueError(f"{name}: want a 16-byte aligned tensor of a "
                         "multiple of 4 elements")


def rows_plan(n_vecs: int, n_sm: int, blocks_per_sm: int,
              threads: int) -> tuple[int, int]:
    """P1's ``(grid, units)`` for ``n_vecs`` 16-byte vectors: the flat
    tensor in ``units`` of ``threads`` vectors (one a thread, the last
    cut short), dealt out to the blocks that fit the card at once,
    ``n_sm * blocks_per_sm``, or one block a unit where there are
    fewer units."""
    units = -(-n_vecs // threads)
    return min(n_sm * blocks_per_sm, units), units


def rows_share(block: int, grid: int, units: int, threads: int,
               n_vecs: int) -> list[tuple[int, int]]:
    """The vector ranges ``[lo, hi)`` that block ``block`` of P1's grid
    takes (``csrc/probe.cu`` ``stream_add_rows_kernel`` walks the same):
    units ``block``, ``block + grid``, ``block + 2 grid``, ..., each of
    ``threads`` vectors, the last cut at ``n_vecs``."""
    return [(u * threads, min((u + 1) * threads, n_vecs))
            for u in range(block, units, grid)]


def rows_launch(n_vecs: int, device) -> tuple[int, int, int]:
    """P1's ``(grid, threads, blocks_per_sm)`` for ``n_vecs`` vectors on
    the CUDA ``device``: the block shape the library was built for and
    the blocks of it an SM holds at once (the CUDA occupancy
    calculator), through :func:`rows_plan`."""
    threads, per_sm = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = _library().stream_add_rows_geometry(ctypes.byref(threads),
                                                 ctypes.byref(per_sm))
    if rc != 0 or per_sm.value < 1:
        raise RuntimeError(f"stream_add_rows_geometry failed: cudaError "
                           f"{rc}, {per_sm.value} blocks an SM")
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    grid, _ = rows_plan(n_vecs, n_sm, per_sm.value, threads.value)
    return grid, threads.value, per_sm.value


def stream_add_rows(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """Launch P1: ``x + 1`` over ``x [R, L]`` f32 on a grid of the card
    (:func:`rows_launch`), every row written.  ``block_rows``, the TPU
    kernel's row block, is checked and sets nothing on the card."""
    name = "stream_add_rows"
    if x.dim() != 2 or x.shape[1] % 4 or block_rows < 1:
        raise ValueError(f"{name}: want x [R, L] with L a multiple of 4 "
                         f"and block_rows >= 1, got {tuple(x.shape)}, "
                         f"{block_rows}")
    _check_stream(name, x)
    y = torch.empty_like(x)
    n_vecs = x.numel() // 4
    if n_vecs:
        grid, _, _ = rows_launch(n_vecs, x.device)
        _launch(name, _library().stream_add_rows, x.data_ptr(),
                y.data_ptr(), n_vecs, grid, device=x.device)
    return y


def ring_claim(stage: int) -> int:
    """P2's stages a claim: at least :data:`RING_CLAIM_BYTES` a claim."""
    return max(1, RING_CLAIM_BYTES // stage)


def ring_plan(n_bytes: int, stage: int, n_buf: int,
              n_sm: int) -> tuple[int, int]:
    """P2's ``(grid, blocks_per_sm)``: as many blocks an SM as its
    shared memory holds with their rings (``n_buf * stage`` bytes), slot
    barriers and reserve, and as its threads and block slots allow (the
    occupancy calculator's rule, ``stream_add_ring_geometry`` on the
    card), and at most one block a stage.  Raises ValueError where the
    stages and blocks pass the kernel's int32 claim counter."""
    block = n_buf * stage + n_buf * RING_SLOT_BYTES + BLOCK_RESERVED_SMEM
    per_sm = max(1, min(SM_SMEM // block, SM_THREADS // RING_THREADS,
                        SM_BLOCKS))
    grid = min(-(-n_bytes // stage), per_sm * n_sm)
    _check_claims(n_bytes, stage, grid)
    return grid, per_sm


def _check_claims(n_bytes, stage, grid):
    """The most P2's claim counter reaches on ``grid`` blocks, below
    2^31."""
    if -(-n_bytes // stage) + (grid + 1) * ring_claim(stage) >= 2**31:
        raise ValueError(f"stream_add_ring: {n_bytes} bytes in stages of "
                         f"{stage} on {grid} blocks exceed the int32 claim "
                         "counter")


def ring_geometry(stage: int, n_buf: int, device) -> tuple[int, int]:
    """P2's ``(threads, blocks_per_sm)`` on the CUDA ``device`` from the
    CUDA occupancy calculator, given the ring's shared memory."""
    threads, per_sm = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        rc = _library().stream_add_ring_geometry(
            stage, n_buf, ctypes.byref(threads), ctypes.byref(per_sm))
    if rc != 0 or per_sm.value < 1:
        raise RuntimeError(f"stream_add_ring_geometry failed: cudaError "
                           f"{rc}, {per_sm.value} blocks an SM")
    return threads.value, per_sm.value


def _ring(x, stage, n_buf, grid, clock):
    name = "stream_add_ring"
    if n_buf not in RING_DEPTHS or stage <= 0 or stage % 16 or (
            n_buf * stage > RING_SMEM):
        raise ValueError(f"{name}: want n_buf in {RING_DEPTHS} and a stage "
                         f"of a multiple of 16 bytes, the ring within "
                         f"{RING_SMEM} bytes; got {n_buf} x {stage}")
    _check_stream(name, x)
    y = torch.empty_like(x)
    n_bytes = x.numel() * 4
    if not n_bytes:
        return y, (torch.zeros((0, 2), dtype=torch.int64, device=x.device)
                   if clock else None)
    if grid is None:
        n_sm = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        grid = ring_plan(n_bytes, stage, n_buf, n_sm)[0]
    elif grid < 1:
        raise ValueError(f"{name}: want at least one block, got {grid}")
    else:
        _check_claims(n_bytes, stage, grid)
    counter = torch.empty(1, dtype=torch.int32, device=x.device)
    # every block writes its two entries
    clock = (torch.empty((grid, 2), dtype=torch.int64, device=x.device)
             if clock else None)
    _launch(name, _library().stream_add_ring, x.data_ptr(), y.data_ptr(),
            n_bytes, stage, n_buf, ring_claim(stage), grid,
            counter.data_ptr(),
            None if clock is None else clock.data_ptr(), device=x.device)
    return y, clock


def stream_add_ring(x: torch.Tensor, stage: int, n_buf: int) -> torch.Tensor:
    """Launch P2: ``x + 1`` over the flat f32 ``x`` through an
    ``n_buf``-slot shared-memory ring of ``stage`` bytes a slot in each
    block, warp-specialised: a producer claims stages from a counter and
    fills slots by TMA bulk loads, compute warps add 1 in place, a store
    thread drains each slot and frees it once its store has read it
    out; the grid from :func:`ring_plan`."""
    return _ring(x, stage, n_buf, None, False)[0]


def stream_add_ring_on(x: torch.Tensor, stage: int, n_buf: int,
                       grid: int | None = None, clock: bool = False):
    """P2 as :func:`stream_add_ring`, on ``grid`` blocks where given (a
    diagnostic of the grid: any count is correct), with each block's
    start and end on the card's nanosecond clock where ``clock``: ``(y,
    clock [grid, 2] int64 or None)``."""
    return _ring(x, stage, n_buf, grid, clock)


def split_plan(n_bytes: int, stage: int, n_buf: int,
               n_sm: int) -> tuple[int, int]:
    """P3's ``(grid, blocks_per_sm)``: one or two blocks an SM, as many
    as an SM's shared memory holds with their in and out rings (``2 *
    n_buf * stage`` bytes), barriers and reserve, and at most one block
    a stage."""
    block = (2 * n_buf * stage + n_buf * SPLIT_BARRIER_BYTES
             + BLOCK_RESERVED_SMEM)
    per_sm = max(1, min(2, SM_SMEM // block))
    return min(-(-n_bytes // stage), per_sm * n_sm), per_sm


def stream_add_split(x: torch.Tensor, stage: int, n_buf: int,
                     n_dma: int) -> torch.Tensor:
    """Launch P3: ``x + 1`` over the flat f32 ``x`` through a
    warp-specialised pipeline over in and out rings of ``n_buf`` slots
    of ``stage`` bytes, ``n_dma`` bulk copies a stage each way: the
    loads gated by the compute warps' release of an in slot, an out
    slot handed back once its own store has read it; the grid from
    :func:`split_plan`."""
    name = "stream_add_split"
    if n_buf not in RING_DEPTHS or n_dma < 1 or stage <= 0 or (
            stage % (16 * n_dma)) or 2 * n_buf * stage > RING_SMEM:
        raise ValueError(f"{name}: want n_buf in {RING_DEPTHS}, a stage of "
                         f"a multiple of 16 * n_dma bytes and both rings "
                         f"within {RING_SMEM} bytes; got {n_buf} x {stage}, "
                         f"n_dma {n_dma}")
    _check_stream(name, x)
    y = torch.empty_like(x)
    n_bytes = x.numel() * 4
    if n_bytes:
        n_sm = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        grid, _ = split_plan(n_bytes, stage, n_buf, n_sm)
        _launch(name, _library().stream_add_split, x.data_ptr(),
                y.data_ptr(), n_bytes, stage, n_buf, n_dma, grid,
                device=x.device)
    return y


def detect_stream_rows(rows, lab, pos, vel, sv, rh, pk):
    """Launch P4, a copy kernel with K9's streams: ``rows [6, R, W]``,
    ``pos``/``vel``/``rh [3, R, W]`` f32, ``lab``/``sv``/``pk [R, W]``
    int32 -> ``(sv + lab, rh, pk, payload [R, W], count [R, 1])``, the
    payload the bits of ``rows[0] + pos[0] + pos[1] + pos[2] + vel[0] +
    vel[1] + vel[2] + rows[3]`` and the count each row's sum of
    ``lab``."""
    name = "detect_stream_rows"
    if lab.dim() != 2:
        raise ValueError(f"{name}: want lab [R, W], got {tuple(lab.shape)}")
    r, w = lab.shape
    for t, want in ((rows, (6, r, w)), (pos, (3, r, w)), (vel, (3, r, w)),
                    (rh, (3, r, w)), (sv, (r, w)), (pk, (r, w))):
        if t.shape != want:
            raise ValueError(f"{name}: want shape {want}, got "
                             f"{tuple(t.shape)}")
    _check(name, lab, sv, pk)
    _check(name, rows, pos, vel, rh, dtype=torch.float32, dim=3)
    planes = (rows, lab, pos, vel, sv, rh, pk)
    if len({t.device for t in planes}) > 1:
        raise ValueError(f"{name}: tensors on different devices")
    if w % 4 or r > 65535 or any(t.data_ptr() % 16 for t in planes):
        raise ValueError(f"{name}: want at most 65535 rows of a multiple of "
                         "4 entries, every plane 16-byte aligned")
    osv, orh, opk = (torch.empty_like(sv), torch.empty_like(rh),
                     torch.empty_like(pk))
    pay = torch.empty_like(pk)
    count = torch.zeros((r, 1), dtype=torch.int32, device=lab.device)
    if lab.numel():
        _launch(name, _library().detect_stream_rows,
                *(t.data_ptr() for t in planes), osv.data_ptr(),
                orh.data_ptr(), opk.data_ptr(), pay.data_ptr(),
                count.data_ptr(), r, w, device=lab.device)
    return osv, orh, opk, pay, count
