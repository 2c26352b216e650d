"""Host-side snapshot packing: loader dicts -> padded batches (twin of
``orbitanalysis_tpu/engine/packing.py``).

The data contract is the reference's two-callback interface: the loader
returns concatenated per-region blocks plus ``region_offsets``.  This
module turns that ragged layout into the engine's static-shape
``[n_halos, capacity]`` NumPy arrays (vectorized scatters, no Python
loop over halos).  Host data stays NumPy; the tracker moves each packed
snapshot to the device once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from orbitanalysis_tpu_torch.utils.metrics import phase_timer
from orbitanalysis_tpu_torch.utils.padding import (
    invalid_id_for,
    pack_ragged,
    round_up,
)

#: Aligned-staging slot channel layout: load-order slot in bits 0-23,
#: FRESH flag in bit 27 — set where the position's tenant changed since
#: the previous snapshot (an entrant, including reuse of a departure's
#: hole).  The aligned detect step suppresses stale carry state from
#: this flag alone; index consumers mask with SLOT_MASK.
FRESH_BIT = np.int32(1 << 27)
SLOT_MASK = np.int32((1 << 24) - 1)


class PackedSnapshot(NamedTuple):
    ids: np.ndarray                 # [H, P]
    pos: np.ndarray                 # [H, P, 3]
    vel: np.ndarray                 # [H, P, 3]
    mass: Optional[np.ndarray]      # [H, P] or None (scalar masses)
    center: np.ndarray              # [H, 3]
    bulk_vel: Optional[np.ndarray]  # [H, 3] or None
    lengths: np.ndarray             # [H] particles per halo row
    rows: np.ndarray                # active halo rows (indices into H)
    # aligned staging: slot[h, i] is the load-order slot of the entry at
    # stable position i, with the FRESH flag in bit 27
    slot: Optional[np.ndarray] = None  # [H, P] int32 or None


def required_capacity(lengths, headroom: float = 1.3,
                      multiple: int = 128) -> int:
    """Capacity for the padded particle axis: max region size with
    headroom for later growth, rounded up to ``multiple``."""
    mx = int(np.max(lengths, initial=0))
    return round_up(int(np.ceil(mx * headroom)), multiple)


class StableLayout:
    """Persistent particle -> position assignment per halo row.

    A particle tracked at ``(halo, i)`` stays at ``(halo, i)`` for as
    long as it remains in that halo's region, and an entrant reuses a
    position freed by a departure — so consecutive staged snapshots are
    aligned element-wise and the device step needs no join.  Occupancy
    never exceeds current membership, so the tracker's capacity check
    covers this layout too.
    """

    def __init__(self, n_halos: int, capacity: int, id_dtype=np.int32):
        self.id_dtype = np.dtype(id_dtype)
        self.invalid = invalid_id_for(id_dtype)
        self.layout = np.full(
            (n_halos, capacity), self.invalid, self.id_dtype
        )

    @property
    def capacity(self) -> int:
        return self.layout.shape[1]

    def grow(self, new_capacity: int):
        h, p = self.layout.shape
        if new_capacity <= p:
            return
        self.layout = np.pad(
            self.layout, ((0, 0), (0, new_capacity - p)),
            constant_values=self.invalid,
        )

    def restore(self, packed_ids_load: np.ndarray, dest: np.ndarray):
        """Rebuild the layout from a checkpoint: load-order ids and the
        positions they occupied (``dest``, -1 on padding).  A following
        :meth:`assign` of the same membership then reproduces the
        original run's positions exactly."""
        lay = np.full_like(self.layout, self.invalid)
        valid = (packed_ids_load != self.invalid) & (dest >= 0)
        if valid.any() and int(dest[valid].max()) >= self.capacity:
            raise ValueError(
                "checkpointed layout position "
                f"{int(dest[valid].max())} exceeds capacity "
                f"{self.capacity}; grow the layout before restoring"
            )
        r = np.broadcast_to(np.arange(lay.shape[0])[:, None], lay.shape)
        lay[r[valid], dest[valid]] = packed_ids_load[valid]
        self.layout = lay

    def assign(self, packed_ids_load: np.ndarray):
        """Destination positions for load-order packed rows.

        Returns ``(dest, valid)`` where ``dest[h, i]`` is the stable
        position of load entry ``i`` (-1 on padding): matched particles
        keep their previous position, entrants fill free positions in
        ascending position order.  Replaces the layout table.
        """
        lay = self.layout
        H, P = lay.shape
        ids = packed_ids_load
        valid = ids != self.invalid

        order = np.argsort(lay, axis=-1, kind="stable")
        lay_sorted = np.take_along_axis(lay, order, axis=-1)
        if self.id_dtype.itemsize <= 4:
            # batched: row keys made disjoint by a << 32 row offset
            base = (np.arange(H, dtype=np.int64) << 32)[:, None]
            flat_sorted = (lay_sorted.astype(np.int64) + base).ravel()
            q = (ids.astype(np.int64) + base).ravel()
            idx = np.searchsorted(flat_sorted, q).reshape(H, P)
            idx -= np.arange(H, dtype=np.int64)[:, None] * P
        else:
            # wide IDs use the full 64-bit range: per-row searchsorted
            idx = np.empty((H, P), dtype=np.int64)
            for hh in range(H):
                idx[hh] = np.searchsorted(lay_sorted[hh], ids[hh])
        idx_c = np.minimum(idx, P - 1)
        found = (
            valid
            & (idx < P)
            & (np.take_along_axis(lay_sorted, idx_c, axis=-1) == ids)
        )
        dest = np.where(
            found, np.take_along_axis(order, idx_c, axis=-1), -1
        ).astype(np.int64)

        claimed = np.zeros((H, P), bool)
        r_idx = np.broadcast_to(np.arange(H)[:, None], (H, P))
        claimed[r_idx[found], dest[found]] = True

        entered = valid & ~found
        free_order = np.argsort(claimed, axis=-1, kind="stable")
        rank = np.cumsum(entered, axis=-1) - 1
        n_entered = rank[:, -1] + 1
        n_free = P - claimed.sum(axis=-1)
        if np.any(n_entered > n_free):
            raise ValueError("stable layout overflow: grow capacity first")
        dest_entered = np.take_along_axis(
            free_order, np.maximum(rank, 0), axis=-1
        )
        dest = np.where(entered, dest_entered, dest)

        new_layout = np.full_like(lay, self.invalid)
        new_layout[r_idx[valid], dest[valid]] = ids[valid]
        self.layout = new_layout
        return dest, valid


def align_packed(layout: StableLayout, ids, pos, vel, mass=None, out=None,
                 soa: bool = False):
    """Re-stage front-packed ``[H, P]`` load-order rows into ``layout``'s
    persistent positions (updates the layout).

    Returns ``(ids, pos, vel, mass, slot)`` where ``slot & SLOT_MASK``
    is a permutation of ``[0, P)`` per row: the load-order index at
    occupied positions, with the unused slot numbers over the holes in
    position order.  ``FRESH_BIT`` flags positions whose tenant changed
    since the previous snapshot.  ``soa=True`` returns ``pos``/``vel``
    as ``[3, H, P]`` planes; ``out=(ids, pos, vel, mass, slot)`` writes
    into the caller's C-contiguous buffers and returns them.  The
    i32/f32 and i64/f32 cases run through the native pass when it is
    available; the NumPy path below computes the same result.
    """
    from orbitanalysis_tpu_torch import native

    res = native.stable_align_native(
        layout.layout, ids, pos, vel, mass, layout.invalid, out=out,
        soa=soa)
    if res is not None:
        return res
    # .assign replaces layout.layout, so this stays the pre-alignment
    # table the FRESH compare below needs
    old_layout = layout.layout
    dest, valid = layout.assign(ids)
    H, P = ids.shape
    r_idx = np.broadcast_to(np.arange(H)[:, None], (H, P))
    rv, dv = r_idx[valid], dest[valid]

    def scatter(v, fill):
        o = np.full(v.shape, fill, v.dtype)
        o[rv, dv] = v[valid]
        return o

    ids_o = scatter(ids, layout.invalid)
    pos_o = np.zeros_like(pos)
    pos_o[rv, dv] = pos[valid]
    vel_o = np.zeros_like(vel)
    vel_o[rv, dv] = vel[valid]
    mass_o = None if mass is None else scatter(mass, 0.0)

    iota = np.broadcast_to(np.arange(P, dtype=np.int32), (H, P))
    slot = np.full((H, P), -1, np.int32)
    slot[rv, dv] = iota[valid]
    hole = slot < 0
    n_valid = valid.sum(axis=-1).astype(np.int32)
    hole_rank = (np.cumsum(hole, axis=-1) - 1).astype(np.int32)
    slot = np.where(hole, n_valid[:, None] + hole_rank, slot)
    fresh = (ids_o != layout.invalid) & (ids_o != old_layout)
    slot_o = slot | (fresh * FRESH_BIT)
    if soa:
        pos_o = np.ascontiguousarray(np.moveaxis(pos_o, -1, 0))
        vel_o = np.ascontiguousarray(np.moveaxis(vel_o, -1, 0))
    if out is None:
        return ids_o, pos_o, vel_o, mass_o, slot_o
    o_ids, o_pos, o_vel, o_mass, o_slot = out
    o_ids[...] = ids_o
    o_pos[...] = pos_o
    o_vel[...] = vel_o
    if o_mass is not None:
        o_mass[...] = mass_o
    o_slot[...] = slot_o
    return o_ids, o_pos, o_vel, o_mass, o_slot


def pack_snapshot_aligned(
    snapshot: dict,
    rows: np.ndarray,
    n_halos: int,
    layout: StableLayout,
    region_positions: np.ndarray,
    region_bulk_vels: Optional[np.ndarray] = None,
    id_dtype=np.int32,
    pos_dtype=np.float32,
    restore_dest: Optional[np.ndarray] = None,
    phases: Optional[dict] = None,
) -> PackedSnapshot:
    """Pack one loader snapshot into the stable layout (see
    :func:`align_packed` for the slot contract).  ``restore_dest``
    (resume seeding): ``[H, P]`` checkpointed stable positions of this
    snapshot's load-order entries, restored into the layout before
    aligning so the resumed run reproduces the crashed run's positions.
    ``phases``: a record dict the alignment's host seconds are added
    into (``align_s``, :func:`~orbitanalysis_tpu_torch.utils.metrics.
    phase_timer`).
    """
    load = pack_snapshot(
        snapshot, rows, n_halos, layout.capacity, region_positions,
        region_bulk_vels, id_dtype=id_dtype, pos_dtype=pos_dtype,
    )
    if restore_dest is not None:
        layout.restore(load.ids, restore_dest)
    with phase_timer(phases, "track.pack.align"):
        ids, pos, vel, mass, slot = align_packed(
            layout, load.ids, load.pos, load.vel, load.mass
        )
    return load._replace(ids=ids, pos=pos, vel=vel, mass=mass, slot=slot)


def stage_batch_aligned(batch, layout: Optional[StableLayout] = None,
                        soa: bool = False):
    """Stage a :class:`~orbitanalysis_tpu_torch.ops.apsis.SnapshotBatch`
    of NumPy arrays (one snapshot, or ``[S, ...]``-stacked) in the
    stable layout: the aligned engine's staging, as
    :func:`~orbitanalysis_tpu_torch.ops.sorted_step.presort_snapshot` is
    the sorted engine's.

    Rows must be front-packed in load order (invalid-padded tails).  The
    snapshots are aligned in sequence order against one persistent
    ``layout`` (a new one if not given), so consecutive staged snapshots
    are element-wise aligned for the aligned steps.  ``soa=True`` also
    stages ``pos``/``vel`` as ``[3, H, P]`` (stacked ``[S, 3, H, P]``).
    Returns the batch with ``ids``, ``pos``, ``vel``, ``mass`` and
    ``slot`` replaced by host arrays.
    """
    from orbitanalysis_tpu_torch import native

    ids = np.asarray(batch.ids)
    stacked = ids.ndim == 3
    seq = ids if stacked else ids[None]
    S, H, P = seq.shape
    if layout is None:
        layout = StableLayout(H, P, id_dtype=ids.dtype)
    pos = np.asarray(batch.pos).reshape(S, H, P, 3)
    vel = np.asarray(batch.vel).reshape(S, H, P, 3)
    mass = None if batch.mass is None else (
        np.asarray(batch.mass).reshape(S, H, P))
    # one allocation for the whole sequence, each snapshot aligned
    # straight into its slice (out=); np.zeros (calloc), not np.empty:
    # first touch of a large malloc'd block may enter transparent-huge-
    # page compaction, and the alignment writes every byte anyway
    vshape = (S, 3, H, P) if soa else (S, H, P, 3)
    o_ids = np.zeros(seq.shape, seq.dtype)
    o_pos = np.zeros(vshape, pos.dtype)
    o_vel = np.zeros(vshape, vel.dtype)
    o_mass = None if mass is None else np.zeros(mass.shape, mass.dtype)
    o_slot = np.zeros((S, H, P), np.int32)
    # the native sequence pass keeps each row's hash table across the
    # snapshots; else one alignment a snapshot
    res = native.stable_align_seq_native(
        layout.layout, np.ascontiguousarray(seq),
        np.ascontiguousarray(pos, dtype=np.float32),
        np.ascontiguousarray(vel, dtype=np.float32),
        None if mass is None else np.ascontiguousarray(
            mass, dtype=np.float32),
        layout.invalid, out=(o_ids, o_pos, o_vel, o_mass, o_slot), soa=soa)
    if res is None:
        for s in range(S):
            align_packed(
                layout, seq[s], pos[s], vel[s],
                None if mass is None else mass[s],
                out=(o_ids[s], o_pos[s], o_vel[s],
                     None if o_mass is None else o_mass[s], o_slot[s]),
                soa=soa)
    if not stacked:
        o_ids, o_pos, o_vel, o_slot = o_ids[0], o_pos[0], o_vel[0], o_slot[0]
        o_mass = None if o_mass is None else o_mass[0]
    return batch._replace(ids=o_ids, pos=o_pos, vel=o_vel, mass=o_mass,
                          slot=o_slot)


def pack_snapshot(
    snapshot: dict,
    rows: np.ndarray,
    n_halos: int,
    capacity: int,
    region_positions: np.ndarray,
    region_bulk_vels: Optional[np.ndarray] = None,
    id_dtype=np.int32,
    pos_dtype=np.float32,
    sort_ids: bool = False,
) -> PackedSnapshot:
    """Pack one loader snapshot dict into padded load-order arrays.

    ``rows`` maps each region block to its global halo row (one row per
    main-branch halo for the whole run, so carried state stays aligned
    as halos are born).  ``sort_ids=True`` stages each row ID-sorted for
    the sorted engine (the padding sentinel, the dtype max, stays at the
    tail), with each entry's load-order slot in ``slot``.
    """
    ids = np.asarray(snapshot["ids"])
    offsets = np.asarray(snapshot["region_offsets"], dtype=np.int64)
    n = len(ids)
    lengths_blocks = np.diff(np.concatenate((offsets, [n])))
    invalid = invalid_id_for(id_dtype)

    if np.issubdtype(ids.dtype, np.integer) and ids.size:
        if ids.min(initial=0) < 0:
            # the engines pack IDs into unsigned keys and -1 aliases the
            # padding sentinel: a negative ID would drop from matching
            raise ValueError(
                "negative particle IDs are not supported (the sort-merge "
                "join packs IDs into unsigned keys); remap IDs to >= 0 "
                "in the loader"
            )
        if ids.max(initial=0) >= invalid:
            raise ValueError(
                f"particle IDs exceed {np.dtype(id_dtype)} range; pass a "
                "wider id_dtype (e.g. np.int64) to track_orbits"
            )

    def pack(values, fill):
        return pack_ragged(values, offsets, n_halos, capacity, rows=rows,
                           fill=fill)

    packed_ids = pack(ids.astype(id_dtype), invalid)
    packed_pos = pack(np.asarray(snapshot["coordinates"], dtype=pos_dtype),
                      0.0)
    packed_vel = pack(np.asarray(snapshot["velocities"], dtype=pos_dtype),
                      0.0)

    masses = snapshot.get("masses")
    if masses is None or np.isscalar(masses) or np.ndim(masses) == 0:
        packed_mass = None  # equal masses: plain mean bulk velocity
    else:
        packed_mass = pack(np.asarray(masses, dtype=pos_dtype), 0.0)

    center = np.zeros((n_halos, 3), dtype=pos_dtype)
    center[rows] = np.atleast_2d(np.asarray(region_positions, dtype=pos_dtype))

    bulk = None
    if region_bulk_vels is not None:
        bulk = np.zeros((n_halos, 3), dtype=pos_dtype)
        bulk[rows] = np.atleast_2d(
            np.asarray(region_bulk_vels, dtype=pos_dtype))

    lengths = np.zeros(n_halos, dtype=np.int64)
    lengths[rows] = lengths_blocks

    slot = None
    if sort_ids:
        order = np.argsort(packed_ids, axis=-1, kind="stable")
        packed_ids = np.take_along_axis(packed_ids, order, axis=-1)
        packed_pos = np.take_along_axis(packed_pos, order[..., None],
                                        axis=-2)
        packed_vel = np.take_along_axis(packed_vel, order[..., None],
                                        axis=-2)
        if packed_mass is not None:
            packed_mass = np.take_along_axis(packed_mass, order, axis=-1)
        slot = order.astype(np.int32)

    return PackedSnapshot(
        ids=packed_ids,
        pos=packed_pos,
        vel=packed_vel,
        mass=packed_mass,
        center=center,
        bulk_vel=bulk,
        lengths=lengths,
        rows=np.asarray(rows),
        slot=slot,
    )
