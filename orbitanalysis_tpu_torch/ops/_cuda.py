"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

At first use, ``nvcc`` compiles ``csrc/compact.cu`` for ``sm_90a`` into
a shared library with a plain C interface under the package's
git-ignored ``_build/`` directory, named by a hash of the source and
flags, and ctypes loads it.  Launches take device pointers from
``Tensor.data_ptr()`` and run on PyTorch's current stream; each C entry
point returns ``cudaGetLastError()`` and the wrapper raises if it is
not 0.  Each kernel keeps a plain count of its launches.

Nothing here runs at import: this module imports on machines without
CUDA or nvcc, and only a launch needs them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "compact.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]


class Kernel:
    """A kernel entry point of the library, with its launch count."""

    def __init__(self, name: str, route: str, source: str, replaces: str):
        self.name = name
        self.route = route
        self.source = source
        self.replaces = replaces
        self.launches = 0


KERNELS = {
    k.name: k for k in (
        Kernel("compact_angle_rows", "cuda",
               "orbitanalysis_tpu_torch/csrc/compact.cu",
               "orbitanalysis_tpu/ops/pallas_compact.py:416"),
        Kernel("compact_pair_rows", "cuda",
               "orbitanalysis_tpu_torch/csrc/compact.cu",
               "orbitanalysis_tpu/ops/pallas_compact.py:627"),
    )
}

_lock = threading.Lock()
_lib = None


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


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
    with open(SOURCE, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcompact-{h.hexdigest()[:16]}.so")


def build() -> float:
    """Compile the kernel library if it is not built yet; returns the
    seconds nvcc took (0.0 when it was already built).  Raises
    RuntimeError with nvcc's output when the build fails."""
    so = library_path()
    if os.path.exists(so):
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {SOURCE}:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, so)
    return time.perf_counter() - t0


def _library():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                build()
                lib = ctypes.CDLL(library_path())
                p, i = ctypes.c_void_p, ctypes.c_int
                lib.compact_angle_rows.argtypes = [p, p, i, i, i, p]
                lib.compact_angle_rows.restype = i
                lib.compact_pair_rows.argtypes = [p, p, p, p, i, i, i, p]
                lib.compact_pair_rows.restype = i
                _lib = lib
    return _lib


def _check(name, *tensors):
    for t in tensors:
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(
                f"{name}: want 2-D int32 CUDA tensors, got {t.dtype} "
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


def compact_angle_rows(aw: torch.Tensor, k128: int) -> torch.Tensor:
    """Launch the angle-word compaction: ``aw [H, P]`` int32 (uint32
    bits) -> ``[H, k128]`` int32 payload words, zero past each row's
    count."""
    h, p = aw.shape
    out = torch.empty((h, k128), dtype=torch.int32, device=aw.device)
    _check("compact_angle_rows", aw, out)
    _launch("compact_angle_rows", _library().compact_angle_rows,
            aw.data_ptr(), out.data_ptr(), h, p, k128, device=aw.device)
    return out


def compact_pair_rows(posw: torch.Tensor, angw: torch.Tensor, k128: int):
    """Launch the two-stream compaction: ``posw``/``angw [H, P]`` ->
    two ``[H, k128]`` int32 planes, zero past each row's count."""
    h, p = posw.shape
    if angw.shape != posw.shape:
        raise ValueError("compact_pair_rows: posw and angw shapes differ")
    out_pos = torch.empty((h, k128), dtype=torch.int32, device=posw.device)
    out_ang = torch.empty_like(out_pos)
    _check("compact_pair_rows", posw, angw, out_pos, out_ang)
    _launch("compact_pair_rows", _library().compact_pair_rows,
            posw.data_ptr(), angw.data_ptr(), out_pos.data_ptr(),
            out_ang.data_ptr(), h, p, k128, device=posw.device)
    return out_pos, out_ang
