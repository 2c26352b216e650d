"""Native (C++) host tier, loaded through ctypes (twin of
``orbitanalysis_tpu/native/__init__.py``).

The port keeps its own copy of the JAX package's
``orbitanalysis_tpu/native/packing.cpp`` beside this module and builds
it with g++ into the port's own git-ignored build directory, keyed by a
hash of the source.  It holds the multithreaded ragged-block packer and the
stable-layout aligner that feed the device engine, and the grid
counting sort of :class:`~orbitanalysis_tpu_torch.engine.regions.
RegionExtractor`.  Everything here is optional: the NumPy fallbacks in
:mod:`orbitanalysis_tpu_torch.utils.padding`,
:mod:`orbitanalysis_tpu_torch.engine.packing` and the extractor compute
the same results, so the port runs without a compiler.

:func:`build` compiles the library, :func:`load` loads a built one,
:func:`ensure` does both on first use and :func:`available` says whether
it is loaded.
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
    lib.grid_count_sort.argtypes = [p, i64, i64, p, p]
    lib.grid_count_sort.restype = None
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
    lib.stable_align_seq1.argtypes = [
        p, p, p, p, p, i64, i64, i64, i32, p, p, p, p, p, i32]
    lib.stable_align_seq1.restype = i64


def build(force: bool = False) -> bool:
    """Compile the library with g++ unless a build of this source
    exists (always with ``force``).  Returns success."""
    with _lock:
        so = _library_path()
        if so is None:
            return False
        if os.path.exists(so) and not force:
            return True
        return _compile(so)


def load():
    """The ctypes library of a built source, or None when it is not
    built (nothing is compiled)."""
    global _lib
    if _lib is not None:
        return _lib
    so = _library_path()
    if so is None or not os.path.exists(so):
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(so)
            _declare(lib)
            _lib = lib
    return _lib


def ensure():
    """The ctypes library, building it on first use; None when the
    source or the compiler is unavailable (the caller then takes the
    NumPy path)."""
    global _tried
    lib = load()
    if lib is not None or _tried:
        return lib
    _tried = True
    build()
    return load()


def available() -> bool:
    """Whether the library is loaded (or built and loadable)."""
    return load() is not None


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


def _check_out(what, out, mass, plane, vshape, id_dt):
    """``out = (ids_o, pos_o, vel_o, mass_o, slot)`` must be C-contiguous
    buffers of exactly the shapes and dtypes the pass writes (``plane``
    for the IDs, masses and slots, ``vshape`` for positions and
    velocities), ``mass_o`` None exactly when ``mass`` is."""
    ids_o, pos_o, vel_o, mass_o, slot = out
    if (mass is None) != (mass_o is None):
        raise ValueError(f"{what}: mass_o must be provided iff mass is")
    for a, shape, dt in ((ids_o, plane, id_dt), (pos_o, vshape, np.float32),
                         (vel_o, vshape, np.float32),
                         (mass_o, plane, np.float32),
                         (slot, plane, np.int32)):
        if a is not None and (a.shape != shape or a.dtype != dt
                              or not a.flags.c_contiguous):
            raise ValueError(
                f"{what} out buffer: want C-contiguous {shape} "
                f"{np.dtype(dt)}, got {a.shape} {a.dtype}")


def stable_align_native(layout, ids, pos, vel, mass, invalid, out=None,
                        soa=False):
    """Native counterpart of the stable-layout alignment in
    :func:`orbitanalysis_tpu_torch.engine.packing.align_packed`: match,
    entrant placement and scatter in one multithreaded pass, updating
    ``layout`` in place.  Returns ``(ids_o, pos_o, vel_o, mass_o,
    slot)``, or None when the library is unavailable or the dtypes are
    not the i32/f32 (or i64-ID/f32) fast path.  Raises ValueError on
    layout overflow.

    ``soa=True`` writes ``pos_o``/``vel_o`` as ``[3, H, P]`` planes
    instead of ``[H, P, 3]``.  ``out=(ids_o, pos_o, vel_o, mass_o,
    slot)`` scatters into the caller's C-contiguous buffers of exactly
    those shapes and dtypes (``mass_o`` None exactly when ``mass`` is)
    and returns them."""
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
    vshape = (3, H, P) if soa else (H, P, 3)
    if out is not None:
        _check_out("stable_align_native", out, mass, (H, P), vshape, id_dt)
        ids_o, pos_o, vel_o, mass_o, slot = out
    else:
        # np.zeros (calloc) rather than np.empty: first touch of a large
        # malloc'd block may enter transparent-huge-page compaction; the
        # pass writes every byte anyway
        ids_o = np.zeros((H, P), id_dt)
        pos_o = np.zeros(vshape, np.float32)
        vel_o = np.zeros(vshape, np.float32)
        mass_o = None if mass is None else np.zeros((H, P), np.float32)
        slot = np.zeros((H, P), np.int32)
    overflowed = align(
        layout.ctypes.data, ids.ctypes.data, pos.ctypes.data,
        vel.ctypes.data, None if mass is None else mass.ctypes.data,
        H, P, inv, ids_o.ctypes.data, pos_o.ctypes.data, vel_o.ctypes.data,
        None if mass_o is None else mass_o.ctypes.data,
        slot.ctypes.data, ctypes.c_int32(1 if soa else 0),
    )
    if overflowed:
        raise ValueError("stable layout overflow: grow capacity first")
    return ids_o, pos_o, vel_o, mass_o, slot


def stable_align_seq_native(layout, ids, pos, vel, mass, invalid, out,
                            soa=False):
    """Whole-sequence stable-layout alignment: ``ids [S, H, P]`` and
    ``pos``/``vel`` ``[S, H, P, 3]`` in load order, written into the
    caller's stacked ``out=(ids_o, pos_o, vel_o, mass_o, slot)``
    buffers (``pos_o``/``vel_o`` ``[S, 3, H, P]`` when ``soa``).  Rows
    run halo-major in C++, so each row's hash table lives across the S
    snapshots and is updated by the churn alone; the same per-snapshot
    result as :func:`stable_align_native` called in sequence, and
    ``layout`` ends as after the last snapshot.  Returns ``out``, or
    None when the library is unavailable or the dtypes are not i32/f32
    (the caller then aligns one snapshot at a time).  Raises ValueError
    on layout overflow."""
    lib = ensure()
    if lib is None:
        return None
    if (
        np.dtype(ids.dtype) != np.dtype(np.int32)
        or layout.dtype != np.int32
        or pos.dtype != np.float32
        or vel.dtype != np.float32
        or (mass is not None and mass.dtype != np.float32)
    ):
        return None
    S, H, P = ids.shape
    if not (
        layout.flags.c_contiguous
        and layout.shape == (H, P)
        and pos.shape == (S, H, P, 3)
        and vel.shape == (S, H, P, 3)
    ):
        return None
    ids = np.ascontiguousarray(ids)
    pos = np.ascontiguousarray(pos)
    vel = np.ascontiguousarray(vel)
    mass = None if mass is None else np.ascontiguousarray(mass)
    _check_out("stable_align_seq_native", out, mass, (S, H, P),
               (S, 3, H, P) if soa else (S, H, P, 3), np.dtype(np.int32))
    ids_o, pos_o, vel_o, mass_o, slot = out
    overflowed = lib.stable_align_seq1(
        layout.ctypes.data, ids.ctypes.data, pos.ctypes.data,
        vel.ctypes.data, None if mass is None else mass.ctypes.data,
        S, H, P, ctypes.c_int32(int(invalid)), ids_o.ctypes.data,
        pos_o.ctypes.data, vel_o.ctypes.data,
        None if mass_o is None else mass_o.ctypes.data,
        slot.ctypes.data, ctypes.c_int32(1 if soa else 0),
    )
    if overflowed:
        raise ValueError("stable layout overflow: grow capacity first")
    return out


def grid_count_sort_native(flat: np.ndarray, n_cells: int):
    """Stable counting sort of cell keys in ``[0, n_cells)``:
    ``(cell_starts, order)``, as ``np.searchsorted(sorted, arange)`` and
    ``np.argsort(kind='stable')`` give them, or None when the library is
    unavailable."""
    lib = ensure()
    if lib is None:
        return None
    flat = np.ascontiguousarray(flat, dtype=np.int64)
    starts = np.empty(n_cells + 1, dtype=np.int64)
    order = np.empty(len(flat), dtype=np.int64)
    lib.grid_count_sort(flat.ctypes.data, len(flat), int(n_cells),
                        starts.ctypes.data, order.ctypes.data)
    return starts, order
