"""Native (C++) host tier, loaded through ctypes (twin of
``orbitanalysis_tpu/native/__init__.py``).

The port keeps its own copy of the JAX package's
``orbitanalysis_tpu/native/packing.cpp`` beside this module and builds
it with g++ into the port's own git-ignored build directory, keyed by a
hash of the source.  It holds the multithreaded ragged-block packer and the
stable-layout aligner that feed the device engine.  Everything here is
optional: the NumPy fallbacks in :mod:`orbitanalysis_tpu_torch.utils.
padding` and :mod:`orbitanalysis_tpu_torch.engine.packing` compute the
same results, so the port runs without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "packing.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_lib = None
_tried = False


def _library_path() -> str | None:
    try:
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
    except OSError:
        return None
    return os.path.join(BUILD_DIR, f"_packing-{digest}.so")


def _compile(so: str) -> bool:
    """g++ the shared source into ``so`` (caller holds ``_lock``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
             SOURCE, "-o", tmp],
            check=True, capture_output=True, timeout=300,
        )
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _declare(lib):
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.pack_ragged_bytes.argtypes = [p, p, i64, i64, p, p, i64, i64]
    lib.pack_ragged_bytes.restype = None
    lib.fill_i32.argtypes = [p, i64, i32]
    lib.fill_i32.restype = None
    lib.stable_align5.argtypes = [
        p, p, p, p, p, i64, i64, i32, p, p, p, p, p, i32]
    lib.stable_align5.restype = i64
    lib.stable_align3_i64.argtypes = [
        p, p, p, p, p, i64, i64, i64, p, p, p, p, p, i32]
    lib.stable_align3_i64.restype = i64


def ensure():
    """The ctypes library, building it on first use; None when the
    source or the compiler is unavailable (the caller then takes the
    NumPy path)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            so = _library_path()
            if so is not None and (os.path.exists(so) or _compile(so)):
                lib = ctypes.CDLL(so)
                _declare(lib)
                _lib = lib
    return _lib


def tier() -> str:
    """Which host tier the packing runs on: ``'native'`` or ``'numpy'``."""
    return "native" if ensure() is not None else "numpy"


def pack_ragged_native(values, offsets, n_rows, capacity, rows, fill):
    """Native counterpart of :func:`utils.padding.pack_ragged`, or None
    when the library is unavailable."""
    lib = ensure()
    if lib is None:
        return None
    values = np.ascontiguousarray(values)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    elem = int(np.prod(values.shape[1:], dtype=np.int64))
    out = np.zeros((n_rows, capacity) + values.shape[1:], dtype=values.dtype)
    if (values.dtype == np.int32 and elem == 1
            and np.asarray(fill).dtype.kind in "iu"):
        lib.fill_i32(out.ctypes.data, out.size, ctypes.c_int32(int(fill)))
    elif np.any(np.asarray(fill) != 0):
        out.fill(fill)
    lib.pack_ragged_bytes(
        values.ctypes.data, offsets.ctypes.data, len(offsets), len(values),
        rows.ctypes.data, out.ctypes.data, capacity,
        elem * values.dtype.itemsize,
    )
    return out


def stable_align_native(layout, ids, pos, vel, mass, invalid):
    """Native counterpart of the stable-layout alignment in
    :func:`orbitanalysis_tpu_torch.engine.packing.align_packed`: match,
    entrant placement and scatter in one multithreaded pass, updating
    ``layout`` in place.  Returns ``(ids_o, pos_o, vel_o, mass_o,
    slot)``, or None when the library is unavailable or the dtypes are
    not the i32/f32 (or i64-ID/f32) fast path.  Raises ValueError on
    layout overflow."""
    lib = ensure()
    if lib is None:
        return None
    id_dt = np.dtype(ids.dtype)
    H, P = ids.shape
    if (
        id_dt not in (np.dtype(np.int32), np.dtype(np.int64))
        or layout.dtype != id_dt
        or not layout.flags.c_contiguous
        or layout.shape != (H, P)
        or pos.dtype != np.float32 or pos.shape != (H, P, 3)
        or vel.dtype != np.float32 or vel.shape != (H, P, 3)
        or (mass is not None and mass.dtype != np.float32)
    ):
        return None
    if id_dt == np.dtype(np.int32):
        align, inv = lib.stable_align5, ctypes.c_int32(int(invalid))
    else:
        align, inv = lib.stable_align3_i64, ctypes.c_int64(int(invalid))
    ids = np.ascontiguousarray(ids)
    pos = np.ascontiguousarray(pos)
    vel = np.ascontiguousarray(vel)
    mass = None if mass is None else np.ascontiguousarray(mass)
    ids_o = np.zeros((H, P), id_dt)
    pos_o = np.zeros((H, P, 3), np.float32)
    vel_o = np.zeros((H, P, 3), np.float32)
    mass_o = None if mass is None else np.zeros((H, P), np.float32)
    slot = np.zeros((H, P), np.int32)
    overflowed = align(
        layout.ctypes.data, ids.ctypes.data, pos.ctypes.data,
        vel.ctypes.data, None if mass is None else mass.ctypes.data,
        H, P, inv, ids_o.ctypes.data, pos_o.ctypes.data, vel_o.ctypes.data,
        None if mass_o is None else mass_o.ctypes.data,
        slot.ctypes.data, ctypes.c_int32(0),
    )
    if overflowed:
        raise ValueError("stable layout overflow: grow capacity first")
    return ids_o, pos_o, vel_o, mass_o, slot
