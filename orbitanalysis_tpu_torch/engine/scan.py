"""Snapshot-sequence drivers (twin of ``orbitanalysis_tpu/engine/scan.py``).

The JAX package walks a stacked snapshot sequence with ``lax.scan``,
the per-particle carry resident on the device.  Here the walk is a
Python loop over the snapshot axis: each step is the same eager step
function the tracker calls, and the whole stack moves to the carry's
device once before the loop.

Ported so far: :func:`scan_events_sorted` with :func:`stack_batches`.
"""

from __future__ import annotations

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch


def _with_drag_axis(snaps: SnapshotBatch) -> SnapshotBatch:
    """Broadcast a scalar ``hubble_drag`` to the snapshot axis, so every
    field has one entry a snapshot."""
    n = snaps.ids.shape[0]
    drag = np.broadcast_to(np.asarray(snaps.hubble_drag, np.float32), (n,))
    return snaps._replace(hubble_drag=drag)


def stack_batches(batches) -> SnapshotBatch:
    """Stack per-snapshot :class:`SnapshotBatch`es (NumPy arrays or
    tensors) along a new leading snapshot axis; ``None`` fields stay
    ``None`` and scalar ``hubble_drag`` values become one array."""
    def stack(xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], torch.Tensor):
            return torch.stack(list(xs))
        return np.stack([np.asarray(x) for x in xs])

    return SnapshotBatch(*(stack(xs) for xs in zip(*batches)))


def scan_events_sorted(
    carry,
    snaps: SnapshotBatch,
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=np.int32,
    merge_impl: str = "lax_sort",
    compact_impl: str = "lax_sort",
    cur_presorted: bool = False,
    fused: bool = False,
    soa_batch: bool = False,
):
    """The sorted-carry step over a stacked snapshot sequence.

    ``carry`` is a :class:`~orbitanalysis_tpu_torch.ops.sorted_step.
    SortedCarry` (:func:`~orbitanalysis_tpu_torch.ops.sorted_step.
    init_sorted_carry`); ``snaps`` a :class:`SnapshotBatch` whose fields
    carry a leading snapshot axis ``[S, ...]`` (NumPy arrays or tensors,
    moved to the carry's device once; ``hubble_drag`` a scalar or
    ``[S]``).  With rows staged ID-sorted (:func:`~orbitanalysis_tpu_torch.
    ops.sorted_step.presort_snapshot`) pass ``cur_presorted=True``; with
    ``pos``/``vel`` staged ``[S, 3, H, P]`` (``presort_snapshot(...,
    soa=True)``) pass ``soa_batch=True``.  The options are
    :func:`~orbitanalysis_tpu_torch.ops.sorted_step.make_sorted_orbit_step`'s.

    Returns ``(final_carry, (count [S, H], ids [S, H, K], angles
    [S, H, K]))``, the events in previous-snapshot load order.
    """
    from orbitanalysis_tpu_torch.ops.sorted_step import (
        make_sorted_orbit_step,
    )

    step = make_sorted_orbit_step(
        event_capacity, mode=mode, box_size=box_size, id_dtype=id_dtype,
        merge_impl=merge_impl, compact_impl=compact_impl,
        cur_presorted=cur_presorted, fused=fused, soa_batch=soa_batch,
    )
    dev = carry.ids.device
    snaps = _with_drag_axis(snaps)

    def on_dev(x):
        if x is None:
            return None
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(dev).contiguous()

    fields = {k: on_dev(v) for k, v in snaps._asdict().items()
              if k != "hubble_drag"}
    counts, ids, angles = [], [], []
    for s in range(snaps.ids.shape[0]):
        batch = SnapshotBatch(
            **{k: None if v is None else v[s] for k, v in fields.items()},
            hubble_drag=float(snaps.hubble_drag[s]))
        carry, ev = step(carry, batch)
        counts.append(ev.count)
        ids.append(ev.ids)
        angles.append(ev.angles)
    return carry, (torch.stack(counts), torch.stack(ids),
                   torch.stack(angles))
