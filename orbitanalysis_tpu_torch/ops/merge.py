"""Merge of presorted rows (twin of ``orbitanalysis_tpu/ops/pallas_merge.py``
``merge_rows`` and ``sort_descending_u32``).

The sorted engine's join merges two ID-sorted rows per halo: the carry
(``prev``, keys ascending) and the snapshot (``cur``, keys descending).
On a CUDA tensor :func:`merge_rows` launches the hand-written kernel
``merge_rows`` of ``csrc/merge.cu`` (K15; a merge path over tiles of
output positions, each tile's words staged in shared memory and written
coalesced); on a CPU tensor it runs
:func:`merge_rows_torch`, a stable sort of the concatenation.  Both give
the same bits, the ties among padding sentinels included.

Keys are uint32 bit patterns in int32 tensors, ``(id << 1) | side``:
keys past ``2**31`` (every cur key of a large ID, the sentinels
``0xFFFFFFFE``/``0xFFFFFFFF``) are negative as int32, so every sort here
orders ``key & 0xFFFFFFFF`` as int64.
"""

from __future__ import annotations

import torch

from orbitanalysis_tpu_torch.ops import _cuda

_LANES = 128


def u32_order(key: torch.Tensor) -> torch.Tensor:
    """The uint32 value of an int32 bit pattern, as int64 (sort key)."""
    return key.to(torch.int64) & 0xFFFFFFFF


def _check(prev_ops, cur_ops, num_keys):
    if num_keys != 1:
        raise NotImplementedError(
            "the merge kernel supports a single packed uint32 key; use "
            "merge_impl='lax_sort' for 64-bit particle IDs"
        )
    if len(prev_ops) != len(cur_ops):
        raise ValueError("prev/cur operand count mismatch")
    if prev_ops[0].dtype != torch.int32:
        raise TypeError("merge key must be uint32 (an int32 bit pattern)")
    h, p = prev_ops[0].shape
    if p % _LANES or (p & (p - 1)):
        raise ValueError(
            f"row length must be a power of two >= {_LANES} (bitonic "
            f"merge network); got {p} — pad with round_up_pow2"
        )
    for a, b in zip(prev_ops, cur_ops):
        if a.shape != (h, p) or b.shape != (h, p):
            raise ValueError("all operands must be [H, P]")
        if a.dtype != b.dtype or a.element_size() != 4:
            raise TypeError("payloads must be matching 32-bit dtypes")


def merge_rows_torch(prev_ops, cur_ops, num_keys: int = 1):
    """Plain-torch twin of the merge kernel: a stable sort of the
    concatenation ``[prev, cur]`` by the uint32 key, the payloads riding
    along.  Returns ``(key, *payloads)`` as ``[H, 2P]`` planes."""
    _check(prev_ops, cur_ops, num_keys)
    cat = [torch.cat([a, b], dim=1) for a, b in zip(prev_ops, cur_ops)]
    order = torch.sort(u32_order(cat[0]), dim=1, stable=True).indices
    return tuple(torch.gather(c, 1, order) for c in cat)


def merge_rows(prev_ops, cur_ops, num_keys: int = 1):
    """Merge per-row presorted operand tuples into ``[H, 2P]`` sorted rows
    (K15).

    ``prev_ops`` / ``cur_ops``: tuples ``(key, *payloads)`` of ``[H, P]``
    tensors; ``key`` is int32 holding uint32 bits, ascending in
    ``prev_ops`` rows and **descending** in ``cur_ops`` rows.  Payloads
    are 32-bit and match between the tuples.  Returns the merged ``(key,
    *payloads)`` with the key ascending: a stable sort of the
    concatenation.  The JAX package's argument checks and errors.
    """
    if not prev_ops[0].is_cuda:
        return merge_rows_torch(prev_ops, cur_ops, num_keys)
    _check(prev_ops, cur_ops, num_keys)
    return _cuda.merge_rows(tuple(prev_ops), tuple(cur_ops))


def sort_descending_u32(key, *payloads):
    """Row-sort by the uint32 key descending, payloads riding along (the
    JAX package's ``lax.sort`` of the complemented key; plain torch on
    every device, as it is no kernel there either)."""
    order = torch.sort(u32_order(key), dim=-1, descending=True,
                       stable=True).indices
    return (torch.gather(key, -1, order),) + tuple(
        torch.gather(x, -1, order) for x in payloads)
