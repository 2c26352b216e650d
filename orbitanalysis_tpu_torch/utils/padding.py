"""Host-side ragged <-> padded conversions (twin of
``orbitanalysis_tpu/utils/padding.py``).

The device state is a padded ``[n_halos, capacity]`` layout with an
invalid-ID sentinel in unused slots.  These NumPy helpers pack loader
output into that layout and compact event masks back into ragged
catalogs.  Slot order within each halo row preserves the loader's
particle order, so compacted outputs keep the reference's within-halo
ordering.
"""

from __future__ import annotations

import numpy as np

#: Sentinel stored in unused ID slots: the dtype max, so that a plain
#: ascending sort pushes padding to the end of each row.
INVALID_ID = np.iinfo(np.int32).max


def invalid_id_for(dtype) -> int:
    """The invalid-slot sentinel for a given integer dtype (its max value)."""
    return int(np.iinfo(np.dtype(dtype)).max)


def round_up_pow2(n: int) -> int:
    """Round ``n`` up to a power of two."""
    if n <= 1:
        return 1
    return 1 << (int(n) - 1).bit_length()


def round_up(n: int, multiple: int = 128) -> int:
    """Round ``n`` up to a multiple (``multiple`` itself for ``n <= 0``)."""
    if n <= 0:
        return multiple
    return ((n + multiple - 1) // multiple) * multiple


def _row_col(lengths: np.ndarray, rows: np.ndarray):
    """Flat (row, col) scatter indices for ragged blocks of ``lengths``
    placed at the given target rows, columns starting at 0."""
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    reprow = np.repeat(rows, lengths)
    col = np.arange(int(lengths.sum()), dtype=np.int64) - np.repeat(
        starts, lengths)
    return reprow, col


def pack_ragged(
    values: np.ndarray,
    offsets: np.ndarray,
    n_rows: int,
    capacity: int,
    rows: np.ndarray | None = None,
    fill=0,
    dtype=None,
) -> np.ndarray:
    """Pack ragged blocks into a padded ``[n_rows, capacity, ...]`` array.

    ``values`` is the concatenated block data (``[N]`` or ``[N, d]``),
    ``offsets`` the start index of each block, ``rows`` the target row
    of each block (default ``0..n_blocks-1``).  Unused slots get
    ``fill``.  Large inputs go through the native multithreaded packer
    when it is available.
    """
    values = np.asarray(values)
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.diff(np.concatenate((offsets, [len(values)])))
    if rows is None:
        rows = np.arange(len(lengths), dtype=np.int64)
    else:
        rows = np.asarray(rows, dtype=np.int64)
    if lengths.size and int(lengths.max(initial=0)) > capacity:
        raise ValueError(
            f"region of {int(lengths.max())} particles exceeds capacity "
            f"{capacity}; increase capacity/headroom"
        )
    if (dtype is None or np.dtype(dtype) == values.dtype) and (
        values.nbytes >= (1 << 20)
    ):
        from orbitanalysis_tpu_torch import native

        out = native.pack_ragged_native(
            values, offsets, n_rows, capacity, rows, fill
        )
        if out is not None:
            return out
    out_shape = (n_rows, capacity) + values.shape[1:]
    # np.zeros (calloc) then fill, not np.full: large malloc'd blocks
    # are madvised for huge pages and their first touch can be slow
    out = np.zeros(out_shape, dtype=dtype or values.dtype)
    if np.any(np.asarray(fill) != 0):
        out.fill(fill)
    reprow, col = _row_col(lengths, rows)
    out[reprow, col] = values
    return out


def pack_ragged_to(
    out: np.ndarray,
    values: np.ndarray,
    offsets: np.ndarray,
    rows: np.ndarray | None = None,
    fill=0,
) -> np.ndarray:
    """Like :func:`pack_ragged` but writes into the preallocated ``out``
    (every entry: ``fill`` where no block lands) and returns it."""
    values = np.asarray(values)
    offsets = np.asarray(offsets, dtype=np.int64)
    lengths = np.diff(np.concatenate((offsets, [len(values)])))
    if rows is None:
        rows = np.arange(len(lengths), dtype=np.int64)
    out[...] = fill
    reprow, col = _row_col(lengths, np.asarray(rows, dtype=np.int64))
    out[reprow, col] = values
    return out


def unpack_mask(mask: np.ndarray, *arrays: np.ndarray,
                rows: np.ndarray | None = None):
    """Compact padded per-row data selected by a boolean ``[R, C]`` mask.

    Returns ``(offsets, *compacted)``: ``offsets`` has ``len(rows)+1``
    cumulative counts, and each compacted array is the row-major
    concatenation of the masked elements (per-halo blocks in slot
    order).
    """
    mask = np.asarray(mask, dtype=bool)
    if rows is not None:
        rows = np.asarray(rows, dtype=np.int64)
        mask = mask[rows]
        arrays = tuple(np.asarray(a)[rows] for a in arrays)
    counts = mask.sum(axis=1)
    flat_sel = mask.reshape(-1)
    compacted = [
        np.asarray(a).reshape((flat_sel.size,) + np.asarray(a).shape[2:])[
            flat_sel]
        for a in arrays
    ]
    offsets = np.concatenate(([0], np.cumsum(counts)))
    return (offsets,) + tuple(compacted)
