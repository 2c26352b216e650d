"""Hash-sharded particle-pool tracking, the full-box scale path (twin of
``orbitanalysis_tpu/parallel/hash_sharded.py``).

The halo-sharded paths put whole halo rows on one device.  This module
shards the flat (halo, particle) record pool by ``id % n_shards``
instead:

- the prev/cur ID join is shard-local by construction: a particle's
  records land on the same shard every snapshot, whatever halo region
  it sits in, so membership churn and region migration never move
  carry state between devices;
- the one collective of a step is the sum of the per-halo bulk-velocity
  moments (``[H, 4]``), besides the routing of each snapshot's records
  to their owner shards (on the host by :func:`route_flat`, or on the
  devices by :func:`make_device_router`'s all-to-all);
- each device sorts ``O(N / D)`` records and holds ``O(N / D)`` state.

Records are keyed by (halo, id): a particle in two overlapping regions
is two independent records, and one that leaves region A for region B
is a departure and an entry, never a carried angle.

One rank of a ``'shards'`` mesh is one shard.  Its carry, batch and
events are its row of the JAX package's ``[D, ...]`` arrays, kept with
the leading shard dimension (``[1, C]``, as the body of JAX's
``shard_map`` sees them); :func:`~orbitanalysis_tpu_torch.parallel.
sharding.shard_rows` cuts a host ``[D, ...]`` array into a rank's
block.  Workflow::

    mesh   = make_mesh({"shards": D})
    step   = make_hash_sharded_step(mesh, n_halos, K, mode=...)
    carry  = shard_rows(init_hash_carry(D, C, H, device="cpu"), mesh,
                        "shards")                       # this rank's row
    batch  = shard_rows(route_flat(flat, D, C), mesh, "shards")
    carry, ev = step(carry, batch, centers)             # events [1, K]

Event order: events ride (halo, prev load slot), so the host restores
the reference's per-halo output order by one small sort
(:func:`events_to_reference_order`).

The JAX package runs all of this in XLA with no Pallas kernel; the
port's is plain torch.  The step's join is one stable ``torch.sort`` of
one int64 key ``(halo << 32) | (id << 1) | side`` (JAX sorts three int32
keys) and a gather of the channels; its moments go through
:func:`~orbitanalysis_tpu_torch.ops.frames.segment_moments` (K7's kernel
on the card), float64 sums rounded once, so a shard's partial moments
are the same bits on the card and on the CPU.  Every division and root
is the IEEE float32 one (``utils/numerics.div_rn``, ``sqrt_rn``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops.frames import segment_moments
from orbitanalysis_tpu_torch.parallel.collectives import all_to_all, psum
from orbitanalysis_tpu_torch.utils.device import resolve_device
from orbitanalysis_tpu_torch.utils.numerics import (
    div_rn,
    periodic_displacement,
    sqrt_rn,
    torch_dtype,
)

_INVALID = np.int32(np.iinfo(np.int32).max)


class WideIdMap:
    """Persistent wide (e.g. Gadget uint64) particle-ID -> dense int32
    handle mapping for the hash engine.

    The device join needs keys that are stable and unique per particle,
    not the real 64-bit values, so the host hands out dense int32
    handles on first sight and maps event handles back to real IDs at
    write time.  Handles are deterministic given the snapshot stream
    (assigned in sorted order per batch of unseen IDs), so every rank
    that maps the same stream holds the same map, and routing by
    ``handle % n_shards`` is stable across snapshots.  A resumed run
    rebuilds an equivalent map from the resume snapshot onward: handles
    never cross run boundaries (the savefile and checkpoint carry only
    real IDs and load-order state).
    """

    def __init__(self):
        self._sorted = np.empty(0, np.int64)   # known ids, ascending
        self._handle = np.empty(0, np.int32)   # handle per sorted id
        self.inverse = np.empty(0, np.int64)   # handle -> id

    def map(self, ids) -> np.ndarray:
        """int32 handles for ``ids`` (new handles for unseen values)."""
        ids = np.asarray(ids, np.int64)
        if ids.size and ids.min() < 0:
            raise ValueError(
                "negative particle IDs are not supported; remap IDs to "
                ">= 0 in the loader"
            )
        if len(self._sorted):
            idx = np.searchsorted(self._sorted, ids)
            idxc = np.minimum(idx, len(self._sorted) - 1)
            found = self._sorted[idxc] == ids
        else:
            found = np.zeros(len(ids), bool)
        new = np.unique(ids[~found])
        if len(new):
            base = len(self.inverse)
            if base + len(new) >= np.iinfo(np.int32).max - 1:
                raise ValueError(
                    "wide-ID handle space exhausted (>= 2^31-2 distinct "
                    "particles on one tracker)"
                )
            handles_new = np.arange(base, base + len(new), dtype=np.int32)
            self.inverse = np.concatenate([self.inverse, new])
            merged = np.concatenate([self._sorted, new])
            mh = np.concatenate([self._handle, handles_new])
            order = np.argsort(merged, kind="stable")
            self._sorted = merged[order]
            self._handle = mh[order]
            idx = np.searchsorted(self._sorted, ids)
        return self._handle[idx] if len(self._sorted) else (
            np.empty(0, np.int32)
        )

    def unmap(self, handles) -> np.ndarray:
        """Real wide IDs for int32 ``handles``."""
        return self.inverse[np.asarray(handles, np.int64)]


class HashCarry(NamedTuple):
    """Per-shard particle state, ``[D, C]`` (one row a shard; a rank
    holds its ``[1, C]`` row)."""

    halo: torch.Tensor    # [D, C] int32 halo row (n_halos = padding)
    ids: torch.Tensor     # [D, C] int32 particle id (invalid = padding)
    slot: torch.Tensor    # [D, C] int32 global load slot of last snapshot
    vrad: torch.Tensor    # [D, C] f32 radial velocity
    rhat: torch.Tensor    # [D, C, 3] f32
    angles: torch.Tensor  # [D, C] f32 accumulated angle


class HashEvents(NamedTuple):
    """One step's events, one row a shard (exact counts, K-wide lists)."""

    count: torch.Tensor     # [D] int32
    halo: torch.Tensor      # [D, K] int32
    ids: torch.Tensor       # [D, K] int32
    slots: torch.Tensor     # [D, K] int32 prev global load slot
    angles: torch.Tensor    # [D, K]
    bulk_vel: torch.Tensor  # [H, 3] (replicated)


class HashBatch(NamedTuple):
    """One routed snapshot, ``[D, C]`` per-shard blocks."""

    halo: torch.Tensor    # [D, C] int32
    ids: torch.Tensor     # [D, C] int32
    slot: torch.Tensor    # [D, C] int32 global load slot
    pos: torch.Tensor     # [D, C, 3] f32
    vel: torch.Tensor     # [D, C, 3] f32
    mass: Optional[torch.Tensor] = None  # [D, C] f32


_CARRY_DTYPES = HashCarry(halo=np.int32, ids=np.int32, slot=np.int32,
                          vrad=np.float32, rhat=np.float32,
                          angles=np.float32)


def init_hash_carry(n_shards: int, cap: int, n_halos: int,
                    device="cuda") -> HashCarry:
    """The empty ``[n_shards, cap]`` carry on ``device`` (CUDA by
    default; RuntimeError without it)."""
    device = resolve_device(device, "init_hash_carry")
    d, c = int(n_shards), int(cap)
    return HashCarry(
        halo=torch.full((d, c), int(n_halos), dtype=torch.int32,
                        device=device),
        ids=torch.full((d, c), int(_INVALID), dtype=torch.int32,
                       device=device),
        slot=torch.zeros((d, c), dtype=torch.int32, device=device),
        vrad=torch.zeros((d, c), dtype=torch.float32, device=device),
        rhat=torch.zeros((d, c, 3), dtype=torch.float32, device=device),
        angles=torch.zeros((d, c), dtype=torch.float32, device=device),
    )


def hash_carry_from_numpy(carry, device="cuda") -> HashCarry:
    """A :class:`HashCarry` of tensors on ``device`` from host arrays (a
    JAX package carry through ``np.asarray``, any number of shard rows):
    the state the tests hand to both packages."""
    device = resolve_device(device, "hash_carry_from_numpy")
    return HashCarry(*(
        torch.from_numpy(np.array(x, dtype=dt)).to(device)
        for x, dt in zip(carry, _CARRY_DTYPES)))


def hash_carry_to_numpy(carry: HashCarry) -> HashCarry:
    """The carry's planes as host arrays (the JAX package's dtypes)."""
    return HashCarry(*(x.detach().cpu().numpy() for x in carry))


def route_flat(flat: dict, n_shards: int, cap: int,
               id_map: Optional[WideIdMap] = None) -> HashBatch:
    """Host-side bucketing of a flat (halo, id, pos, vel[, mass]) record
    list into ``[n_shards, cap]`` padded NumPy blocks by ``id %
    n_shards`` (every rank buckets the same snapshot; each then takes
    its row with ``shard_rows``).

    ``flat['slot']`` defaults to the record's position, the reference's
    load order (region-major), which the event path preserves.
    ``id_map``: a :class:`WideIdMap` translating wide (64-bit) IDs to
    dense int32 device handles (events come back as handles; unmap at
    write time).
    """
    ids = np.asarray(flat["ids"], dtype=np.int64)
    if id_map is not None:
        ids = id_map.map(ids).astype(np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= 2**31 - 1):
        raise ValueError(
            "hash-sharded tracking stores particle IDs as int32; pass "
            "id_dtype=np.int64 to track_orbits (dense int32 handles via "
            "WideIdMap) or remap IDs into [0, 2^31-1) in the loader"
        )
    n = len(ids)
    halo = np.asarray(flat["halo"], dtype=np.int32)
    slot = np.asarray(
        flat.get("slot", np.arange(n, dtype=np.int64)), dtype=np.int64
    )
    pos = np.asarray(flat["pos"], dtype=np.float32)
    vel = np.asarray(flat["vel"], dtype=np.float32)
    mass = flat.get("mass")

    shard = (ids % n_shards).astype(np.int64)
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=n_shards)
    if counts.max(initial=0) > cap:
        raise ValueError(
            f"shard capacity {cap} < largest bucket {int(counts.max())}; "
            "raise cap (hash imbalance is O(sqrt) — a few % headroom)"
        )

    def alloc(shape, fill, dtype):
        return np.full((n_shards, cap) + shape, fill, dtype)

    out_halo = alloc((), 0, np.int32)
    out_ids = alloc((), _INVALID, np.int32)
    out_slot = alloc((), 0, np.int32)
    out_pos = alloc((3,), 0, np.float32)
    out_vel = alloc((3,), 0, np.float32)
    out_mass = alloc((), 1, np.float32) if mass is not None else None

    starts = np.concatenate(([0], np.cumsum(counts)))
    # positions within each bucket, in routed (stable load) order
    col = np.arange(n) - starts[shard[order]]
    rows = shard[order]
    out_halo[rows, col] = halo[order]
    out_ids[rows, col] = ids[order].astype(np.int32)
    out_slot[rows, col] = slot[order].astype(np.int32)
    out_pos[rows, col] = pos[order]
    out_vel[rows, col] = vel[order]
    if out_mass is not None:
        out_mass[rows, col] = np.asarray(mass, np.float32)[order]
    return HashBatch(halo=out_halo, ids=out_ids, slot=out_slot, pos=out_pos,
                     vel=out_vel, mass=out_mass)


def _local_step(n_halos: int, event_capacity: int, pericentric: bool,
                box_size, angle_dtype, group):
    """The shard-local step on this rank's ``[1, C]`` carry and batch:
    join and detect; the one collective is the sum of the bulk-velocity
    moments over ``group``.  Shared by :func:`make_hash_sharded_step` and
    :func:`make_hash_scan`."""
    K = int(event_capacity)
    H = int(n_halos)
    adt = torch_dtype(angle_dtype)

    def local_step(carry: HashCarry, batch: HashBatch, centers, bulk_cat,
                   hubble_drag):
        halo_c = batch.halo[0]
        ids_c = batch.ids[0]
        slot_c = batch.slot[0]
        pos = batch.pos[0]
        vel = batch.vel[0]
        dev = ids_c.device
        valid_c = ids_c != int(_INVALID)
        C = ids_c.shape[0]
        centers = torch.as_tensor(centers, dtype=torch.float32, device=dev)

        # ---- per-halo bulk velocity: local segment moments + psum ----
        if bulk_cat is None:
            w = valid_c.to(torch.float32)
            if batch.mass is not None:
                w = torch.where(valid_c, batch.mass[0], w)
            seg = torch.where(valid_c, halo_c, torch.full_like(halo_c, H))
            mom = psum(segment_moments(seg, vel.T, w, n_halos=H), group)
            bulk = div_rn(mom[:, :3], torch.clamp(mom[:, 3:4], min=1e-30))
        else:
            bulk = torch.as_tensor(bulk_cat, dtype=torch.float32, device=dev)

        # ---- region frame (centre and bulk looked up by halo) ----
        halo_ix = torch.clamp(halo_c, max=H - 1).long()
        rel = pos - centers[halo_ix]
        if box_size is not None:
            rel = periodic_displacement(rel, box_size)
        hd = (hubble_drag.to(device=dev, dtype=torch.float32)
              if isinstance(hubble_drag, torch.Tensor)
              else float(np.float32(hubble_drag)))
        vrel = vel - bulk[halo_ix] + hd * rel
        r2 = (rel[:, 0] * rel[:, 0] + rel[:, 1] * rel[:, 1]
              + rel[:, 2] * rel[:, 2])
        rinv = torch.where(
            r2 > 0, div_rn(1.0, sqrt_rn(torch.clamp(r2, min=1e-30))),
            torch.zeros_like(r2))
        rhat = rel * rinv[:, None]
        vr = (vrel[:, 0] * rhat[:, 0] + vrel[:, 1] * rhat[:, 1]
              + vrel[:, 2] * rhat[:, 2])

        # ---- shard-local sort-merge join on (halo, id, side) ----
        side = torch.cat([torch.zeros(C, dtype=torch.int64, device=dev),
                          torch.ones(C, dtype=torch.int64, device=dev)])
        m_halo = torch.cat([carry.halo[0], torch.where(
            valid_c, halo_c, torch.full_like(halo_c, H))])
        m_ids = torch.cat([carry.ids[0], ids_c])
        key = ((m_halo.long() << 32) | (m_ids.long() << 1) | side)
        order = torch.sort(key, stable=True).indices
        m_halo, m_ids, side = m_halo[order], m_ids[order], side[order]
        m_slot = torch.cat([carry.slot[0], slot_c])[order]
        m_vr = torch.cat([carry.vrad[0], vr])[order]
        m_r = torch.cat([carry.rhat[0], rhat])[order]
        m_ang = torch.cat([carry.angles[0],
                           torch.zeros(C, dtype=torch.float32,
                                       device=dev)])[order]

        is_cur = side == 1
        left_same = ((torch.roll(m_halo, 1) == m_halo)
                     & (torch.roll(m_ids, 1) == m_ids)
                     & (torch.roll(side, 1) == 0))
        first = torch.arange(2 * C, device=dev) == 0
        m_valid = (m_ids != int(_INVALID)) & (m_halo < H)
        matched = is_cur & left_same & m_valid & ~first

        vr_l = torch.roll(m_vr, 1)
        r_l = torch.roll(m_r, 1, dims=0)
        cos = torch.clamp(r_l[:, 0] * m_r[:, 0] + r_l[:, 1] * m_r[:, 1]
                          + r_l[:, 2] * m_r[:, 2], -1.0, 1.0)
        zero = torch.zeros_like(cos)
        dtheta = torch.where(matched, torch.acos(cos), zero)
        if pericentric:
            flip = (vr_l < 0) & (m_vr > 0)
        else:
            flip = (vr_l > 0) & (m_vr < 0)
        apsis = matched & flip
        angle_acc = torch.roll(m_ang, 1) + dtheta
        apsis_angle = torch.where(apsis, angle_acc, zero)
        angle_new = torch.where(apsis | ~matched, zero, angle_acc)

        # ---- new carry: the cur side, in (halo, id) order ----
        keep = torch.sort((~is_cur).to(torch.int32), stable=True).indices[:C]
        new_carry = HashCarry(
            halo=m_halo[keep][None],
            ids=m_ids[keep][None],
            slot=m_slot[keep][None],
            vrad=m_vr[keep][None],
            rhat=m_r[keep][None],
            angles=angle_new[keep][None],
        )

        # ---- events: the prev partner's slot rides one position left ----
        count = torch.sum(apsis, dtype=torch.int32)
        ev = torch.sort((~apsis).to(torch.int32), stable=True).indices[:K]
        events = HashEvents(
            count=count[None],
            halo=m_halo[ev][None],
            ids=m_ids[ev][None],
            slots=torch.roll(m_slot, 1)[ev][None],
            angles=apsis_angle[ev].to(adt)[None],
            bulk_vel=bulk,
        )
        return new_carry, events

    return local_step


def make_hash_sharded_step(mesh, n_halos: int, event_capacity: int,
                           axis: str = "shards", mode: str = "pericentric",
                           box_size=None, angle_dtype=np.float32):
    """Build ``step(carry, batch, centers, bulk_cat=None, hubble_drag=0.0)
    -> (carry, HashEvents)`` on this rank's ``[1, C]`` carry and batch
    rows.

    ``centers``: ``[H, 3]`` replicated; ``bulk_cat``: ``[H, 3]`` catalog
    bulk velocities, or None for the mass-weighted mean over each halo's
    particles summed across the shards (the reference's bulk,
    ``track_orbits.py:267-284``).  Events come back as this shard's
    ``[1, K]`` row with its exact count.
    """
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh needs a {axis!r} axis")
    local_step = _local_step(n_halos, event_capacity, mode == "pericentric",
                             box_size, angle_dtype, mesh.group(axis))

    def step(carry, batch, centers, bulk_cat=None, hubble_drag=0.0):
        return local_step(carry, batch, centers, bulk_cat, hubble_drag)

    return step


class FlatRecords(NamedTuple):
    """Unrouted records split by position: ``[D, L]`` row blocks in load
    order (device ``d`` holds global slots ``[d L, (d + 1) L)``), the
    natural layout of data already on the devices before ownership
    routing."""

    halo: torch.Tensor   # [D, L] int32
    ids: torch.Tensor    # [D, L] int32 (_INVALID = padding)
    slot: torch.Tensor   # [D, L] int32 global load slot
    pos: torch.Tensor    # [D, L, 3] f32
    vel: torch.Tensor    # [D, L, 3] f32
    mass: Optional[torch.Tensor]  # [D, L] f32 or None


def flat_to_position_shards(flat: dict, n_shards: int,
                            pad_to: Optional[int] = None) -> FlatRecords:
    """Host-side: cut a flat load-order record list into the
    position-split ``[D, L]`` NumPy layout the device router reads.
    Consecutive chunks keep load order, so the routed blocks come out in
    the order :func:`route_flat` gives them."""
    ids = np.asarray(flat["ids"], dtype=np.int64)
    if ids.size and (ids.min() < 0 or ids.max() >= 2**31 - 1):
        raise ValueError(
            "hash-sharded tracking stores particle IDs as int32; remap "
            "IDs into [0, 2^31-1) in the loader"
        )
    n = len(ids)
    D = int(n_shards)
    L = int(pad_to) if pad_to is not None else -(-n // D) if n else 1
    if D * L < n:
        raise ValueError(f"pad_to={L} too small: {D}x{L} < {n} records")
    slot = np.asarray(
        flat.get("slot", np.arange(n, dtype=np.int64)), dtype=np.int64
    )
    mass = flat.get("mass")

    def pad(v, fill, dtype):
        v = np.asarray(v, dtype=dtype)
        out = np.full((D * L,) + v.shape[1:], fill, dtype)
        out[:n] = v
        return out.reshape((D, L) + v.shape[1:])

    return FlatRecords(
        halo=pad(flat["halo"], 0, np.int32),
        ids=pad(ids, _INVALID, np.int32),
        slot=pad(slot, 0, np.int32),
        pos=pad(flat["pos"], 0, np.float32),
        vel=pad(flat["vel"], 0, np.float32),
        mass=None if mass is None else pad(mass, 1, np.float32),
    )


def router_words(with_mass: bool) -> int:
    """int32 words a routed record takes in the router's one exchange:
    halo, id, slot, position (3), velocity (3), and the mass if any."""
    return 10 if with_mass else 9


def _local_route(n_shards: int, cap: int, block: int, group):
    """Device-side ownership routing of this rank's ``[1, L]`` load-order
    chunk: bucket by ``id % D`` into fixed ``block`` send buffers, one
    all-to-all of the packed records, then compact the ``[D, block]``
    blocks received into the ``[1, cap]`` batch row (the device form of
    :func:`route_flat`, with its within-shard order, since the source
    chunks are consecutive in load order).

    Returns ``local_route(FlatRecords row) -> (HashBatch row,
    dropped)``, ``dropped [1]`` the records lost to ``block`` or ``cap``
    overflow on this rank (fail-loud: the caller asserts zero; hash
    imbalance is O(sqrt), so a few % headroom suffices)."""
    D = int(n_shards)
    if D * block < cap:
        raise ValueError(
            f"block={block} too small: D*block={D * block} cannot fill "
            f"cap={cap}"
        )

    def local_route(flat: FlatRecords):
        ids = flat.ids[0]
        dev = ids.device
        L = ids.shape[0]
        valid = ids != int(_INVALID)
        dst = torch.where(valid, ids.long() % D,
                          torch.full_like(ids, D, dtype=torch.int64))
        perm = torch.sort(dst, stable=True).indices  # load order in buckets
        dst_s = dst[perm]
        counts = torch.bincount(dst, minlength=D + 1)
        starts = torch.cumsum(counts, 0) - counts
        rank = torch.arange(L, device=dev) - starts[dst_s]
        live = dst_s < D
        ok = (rank < block) & live
        bucket = torch.where(ok, dst_s * block + rank,
                             torch.full_like(rank, D * block))
        dropped_send = torch.sum((rank >= block) & live, dtype=torch.int32)

        # one packed exchange: every channel as int32 words of a record
        chans = [flat.halo[0][:, None], ids[:, None], flat.slot[0][:, None],
                 flat.pos[0].view(torch.int32), flat.vel[0].view(torch.int32)]
        fills = [0, int(_INVALID), 0, 0, 0, 0, 0, 0, 0]
        if flat.mass is not None:
            chans.append(flat.mass[0][:, None].view(torch.int32))
            fills.append(int(np.float32(1.0).view(np.int32)))
        rec = torch.cat(chans, dim=1)[perm]                   # [L, W]
        fill = torch.tensor(fills, dtype=torch.int32, device=dev)
        buf = fill.expand(D * block + 1, len(fills)).clone()
        buf[bucket] = rec                   # overflow lands in the spare row
        got = all_to_all(buf[:D * block], group)              # [D*block, W]

        valid_r = got[:, 1] != int(_INVALID)
        perm2 = torch.sort((~valid_r).to(torch.int32),
                           stable=True).indices[:cap]
        n_valid = torch.sum(valid_r, dtype=torch.int32)
        dropped_recv = torch.clamp(n_valid - cap, min=0)
        out = got[perm2]
        batch = HashBatch(
            halo=out[:, 0][None].contiguous(),
            ids=out[:, 1][None].contiguous(),
            slot=out[:, 2][None].contiguous(),
            pos=out[:, 3:6].contiguous().view(torch.float32)[None],
            vel=out[:, 6:9].contiguous().view(torch.float32)[None],
            mass=(None if flat.mass is None
                  else out[:, 9].contiguous().view(torch.float32)[None]),
        )
        return batch, (dropped_send + dropped_recv)[None]

    return local_route


def default_block(L: int, D: int, cap: int) -> int:
    """The router's default bucket width: twice the uniform-hash
    expectation, and at least ``cap / D`` so a full batch fits."""
    return max(-(-2 * L // D), -(-cap // D))


def make_device_router(mesh, cap: int, block: Optional[int] = None,
                       axis: str = "shards"):
    """Ownership router: ``route(FlatRecords [1, L]) -> (HashBatch [1,
    cap], dropped [1])`` on this rank's chunk.  ``block`` is the
    per-(source, destination) bucket width (default
    :func:`default_block`)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh needs a {axis!r} axis")
    D = int(mesh.shape[axis])
    group = mesh.group(axis)

    def route(flat: FlatRecords):
        L = flat.ids.shape[1]
        blk = block if block is not None else default_block(L, D, cap)
        return _local_route(D, cap, blk, group)(flat)

    return route


def make_hash_scan(mesh, n_halos: int, event_capacity: int, cap: int,
                   block: Optional[int] = None, axis: str = "shards",
                   mode: str = "pericentric", box_size=None,
                   angle_dtype=np.float32):
    """Hash-sharded tracking of a whole snapshot sequence: route, join
    and detect each snapshot on the devices, with no host staging in
    the loop (the JAX package runs the same in one ``lax.scan``; here a
    Python loop on each rank).

    Returns ``scan(carry, flat_seq, centers_seq, bulk_seq=None,
    hubble_drag=0.0) -> (carry, HashEvents [S, 1, ...], dropped [S,
    1])`` where ``flat_seq`` is this rank's :class:`FlatRecords` with
    leaves ``[S, 1, L]``, ``centers_seq`` is ``[S, H, 3]``, ``bulk_seq``
    optionally ``[S, H, 3]`` and ``hubble_drag`` a scalar or ``[S]``.
    Each step's routing is an all-to-all (:func:`make_device_router`);
    ``dropped`` must come back all zero (bucket overflow is fail-loud).
    """
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh needs a {axis!r} axis")
    D = int(mesh.shape[axis])
    group = mesh.group(axis)
    local_step = _local_step(n_halos, event_capacity, mode == "pericentric",
                             box_size, angle_dtype, group)

    def scan(carry, flat_seq, centers_seq, bulk_seq=None, hubble_drag=0.0):
        S, _, L = flat_seq.ids.shape
        blk = block if block is not None else default_block(L, D, cap)
        local_route = _local_route(D, cap, blk, group)
        drag = np.broadcast_to(np.asarray(hubble_drag, np.float32), (S,))
        events, dropped = [], []
        for s in range(S):
            batch, drop = local_route(FlatRecords(*(
                None if x is None else x[s] for x in flat_seq)))
            carry, ev = local_step(
                carry, batch, centers_seq[s],
                None if bulk_seq is None else bulk_seq[s], float(drag[s]))
            events.append(ev)
            dropped.append(drop)
        return (carry, HashEvents(*(torch.stack(f) for f in zip(*events))),
                torch.stack(dropped))

    return scan


def events_to_reference_order(ev_count, ev_halo, ev_ids, ev_slot,
                              ev_angles, n_halos: int):
    """Host-side: merge the per-shard event lists (``[D]`` counts and
    ``[D, K]`` lists, NumPy) into the reference's per-halo,
    prev-load-order layout (offsets and flat ids and angles)."""
    ev_count = np.asarray(ev_count)
    parts = []
    for d in range(len(ev_count)):
        k = int(ev_count[d])
        parts.append((
            np.asarray(ev_halo[d][:k]),
            np.asarray(ev_ids[d][:k]),
            np.asarray(ev_slot[d][:k]),
            np.asarray(ev_angles[d][:k]),
        ))
    halo = np.concatenate([p[0] for p in parts])
    ids = np.concatenate([p[1] for p in parts])
    slot = np.concatenate([p[2] for p in parts])
    ang = np.concatenate([p[3] for p in parts])
    order = np.lexsort((slot, halo))
    halo, ids, slot, ang = halo[order], ids[order], slot[order], ang[order]
    counts = np.bincount(halo, minlength=n_halos)
    offsets = np.concatenate(([0], np.cumsum(counts)))
    return offsets, ids, ang
