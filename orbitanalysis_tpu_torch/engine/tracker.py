"""Offline multi-snapshot orbit tracking, the primary entry point (twin
of ``orbitanalysis_tpu/engine/tracker.py:707`` ``track_orbits``).

The user-facing contract is the reference's: the same ``regions`` /
``load_snapshot_data`` callback pair, the same savefile schema, the
same checkpoint/resume semantics.  Between the callbacks and the file:

- the callbacks run on a prefetch thread, one snapshot ahead;
- host staging packs each snapshot into a padded ``[n_halos,
  capacity]`` layout (NumPy, or the native packer);
- one device step per snapshot advances all halos together, with the
  per-particle state resident on the device between snapshots;
- the event lists of snapshot s are fetched and written while the step
  of snapshot s+1 runs.

Engines, one class each behind :class:`_Engine`, picked once by
:func:`_pick_engine`: ``'aligned'`` (stable row positions staged on the
host, no device join; its event compaction is the hand-written CUDA
kernel) is what ``join_impl='auto'`` picks on a CUDA device;
``'general'`` (the sort-merge join step) elsewhere, and after ``auto``
capacity growth; ``'sorted'`` (rows staged ID-sorted on the host, an
ID-sorted carry, the join-and-detect kernel on the card) when asked for.

With ``mesh=`` the run spans the ranks of a ``torch.distributed`` world,
one rank a device (:mod:`orbitanalysis_tpu_torch.parallel`): a
``'halos'`` mesh runs those engines on each rank's block of halo rows,
a ``'shards'`` mesh the hash-sharded particle-pool engine.  Every rank
loads, packs and decides alike from the same host data; the event lists
are gathered to every rank and rank 0 writes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from orbitanalysis_tpu_torch.engine import io_hdf5
from orbitanalysis_tpu_torch.engine.packing import (
    SLOT_MASK,
    PackedSnapshot,
    StableLayout,
    pack_snapshot,
    pack_snapshot_aligned,
    required_capacity,
)
from orbitanalysis_tpu_torch.ops.apsis import (
    Carry,
    SnapshotBatch,
    carry_from_numpy,
    init_carry,
    make_orbit_step,
    make_static_orbit_step,
)
from orbitanalysis_tpu_torch.ops.compact import f16_bits_rne
from orbitanalysis_tpu_torch.ops.sorted_step import (
    AUTO_FUSED_CAPACITY,
    MAX_ALIGNED_CAPACITY,
    MAX_FUSED_CAPACITY,
    SortedCarry,
    decode_aligned_carry,
    init_aligned_carry,
    init_sorted_carry,
    make_aligned_native_step,
    make_sorted_orbit_step,
    sorted_carry_to_numpy,
)
from orbitanalysis_tpu_torch.parallel import multihost
from orbitanalysis_tpu_torch.utils.device import resolve_device
from orbitanalysis_tpu_torch.utils.metrics import Metrics, phase_timer, trace
from orbitanalysis_tpu_torch.utils.numerics import hubble_parameter
from orbitanalysis_tpu_torch.utils.padding import (
    invalid_id_for,
    pack_ragged,
    round_up,
    round_up_pow2,
    unpack_mask,
)


def _normalize_inputs(snapshot_numbers, main_branches):
    main_branches = np.asarray(main_branches)
    if main_branches.ndim == 1:
        main_branches = main_branches[:, None]
    snapshot_numbers = np.asarray(snapshot_numbers)
    if len(main_branches) != len(snapshot_numbers):
        raise ValueError(
            "Number of halo main branch nodes does not equal the number of "
            "snapshot numbers supplied. Must have len(main_branches) == "
            "len(snapshot_numbers)."
        )
    order = np.argsort(snapshot_numbers)
    return snapshot_numbers[order], main_branches[order]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _call_regions(regions, snapshot_number, halo_ids):
    """Accept both 2- and 3-tuple ``regions`` returns."""
    out = regions(snapshot_number, halo_ids)
    if len(out) == 3:
        positions, radii, bulk_vels = out
    else:
        positions, radii = out
        bulk_vels = None
    return (
        np.atleast_2d(np.asarray(positions)),
        np.atleast_1d(np.asarray(radii)),
        None if bulk_vels is None else np.atleast_2d(np.asarray(bulk_vels)),
    )


def _load_item(regions, load_snapshot_data, halo_ids, snapshot_number):
    """Run both user callbacks for one snapshot; a ``None`` payload means
    nothing to process (no live branches)."""
    rows = np.argwhere(np.asarray(halo_ids) != -1).flatten()
    if len(rows) == 0:
        return rows, None
    region_positions, region_radii, region_bulk_vels = _call_regions(
        regions, snapshot_number, halo_ids[rows]
    )
    snapshot = load_snapshot_data(
        snapshot_number, region_positions, region_radii
    )
    return rows, (region_positions, region_radii, region_bulk_vels, snapshot)


class _SnapshotFeed:
    """Snapshot ingestion, optionally prefetched on a background thread.

    The callback I/O for snapshot s+1 runs while the host packs and
    writes snapshot s and the device computes it.  Calls into the user
    callbacks stay sequential (one at a time, in snapshot order, from one
    thread).  A loader exception is re-raised at the iteration that
    requested the snapshot, like the synchronous path, and halts
    prefetching.
    """

    def __init__(self, items, regions, load_snapshot_data, depth: int):
        self._items = items
        self._regions = regions
        self._load = load_snapshot_data
        self._queue = None
        self._stop = None
        self._thread = None
        self._next = 0
        if depth > 0 and len(items) > 1:
            import queue
            import threading

            self._queue = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run, name="orbit-snapshot-prefetch", daemon=True
            )
            self._thread.start()

    def _run(self):
        import queue

        for halo_ids, snapshot_number in self._items:
            if self._stop.is_set():
                return
            try:
                out = (None, _load_item(self._regions, self._load,
                                        halo_ids, snapshot_number))
            except BaseException as exc:  # re-raised on the main thread
                out = (exc, None)
            while not self._stop.is_set():
                try:
                    self._queue.put(out, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if out[0] is not None:
                return

    def get(self, index: int):
        """Blocking fetch of item ``index`` (called in order)."""
        if index != self._next:
            raise RuntimeError("snapshot feed consumed out of order")
        self._next += 1
        if self._thread is None:
            halo_ids, snapshot_number = self._items[index]
            return _load_item(self._regions, self._load,
                              halo_ids, snapshot_number)
        exc, payload = self._queue.get()
        if exc is not None:
            self.close()
            raise exc
        return payload

    def close(self):
        if self._thread is not None:
            import queue

            self._stop.set()
            # unblock a put() stuck on a full queue, then reap
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5)
            self._thread = None


class _Fetch:
    """Device->host copies of a step's small outputs, queued right after
    the step, so the deferred write of snapshot s waits for step s only
    and not for step s+1 queued behind it (a plain ``.cpu()`` would
    wait for the whole stream)."""

    def __init__(self, tensors: dict):
        self._event = None
        if any(t.is_cuda for t in tensors.values()):
            self._host = {
                k: torch.empty(t.shape, dtype=t.dtype,
                               pin_memory=True).copy_(t, non_blocking=True)
                for k, t in tensors.items()
            }
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = dict(tensors)

    def __getitem__(self, name) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host[name].numpy()


class _MeshFetch:
    """A sharded step's small outputs, gathered from every rank to the
    host of every rank at their first read (the counterpart of the JAX
    package's ``_fetch_host``, ``engine/tracker.py:90-106``).

    Each read is a collective: every rank reads the same names in the
    same order, which the writer's control flow, decided on replicated
    host data and gathered counts, guarantees.  ``gather(tensor)`` joins
    the ranks' blocks.  The ``[rows, K]`` event lists cross count-bounded:
    only their first columns up to the largest gathered count (rounded
    up to 256), zero-padded back to K on the host.  Names in
    ``replicated`` hold the same value on every rank and are copied,
    not gathered."""

    _LISTS = ("ids", "angles", "slots", "halo")

    def __init__(self, tensors: dict, gather, replicated=()):
        self._tensors = tensors
        self._gather = gather
        self._replicated = replicated
        self._host = {}

    def __getitem__(self, name) -> np.ndarray:
        if name not in self._host:
            x = self._tensors[name]
            if name in self._replicated:
                out = _host(x)
            elif name in self._LISTS:
                k = x.shape[1]
                most = int(self["count"].max(initial=0))
                kf = min(round_up(max(most, 1), 256), k)
                out = self._gather(x[:, :kf].contiguous())
                if kf < k:
                    out = np.pad(out, ((0, 0), (0, k - kf)))
            else:
                out = self._gather(x)
            self._host[name] = out
        return self._host[name]


class _MeshEvents:
    """A sharded step's events whose full planes (the general engine's
    masks, the aligned engine's payload) are gathered on first read, as
    CPU tensors; every rank reads them at the same point (the overflow
    branches are decided on gathered counts)."""

    def __init__(self, events, gather):
        self._events = events
        self._gather = gather

    def __getattr__(self, name):
        x = getattr(self._events, name)
        if isinstance(x, tuple):
            return tuple(torch.from_numpy(self._gather(v)) for v in x)
        return torch.from_numpy(self._gather(x))


def _on_primary(fn):
    """``fn()`` run by the primary process alone (the savefile's single
    reader and writer); its result, or the exception it raised, reaches
    every process."""
    if multihost.process_count() == 1:
        return fn()
    out = None
    if multihost.is_primary():
        try:
            out = (None, fn())
        except Exception as exc:  # re-raised on every process below
            out = (exc, None)
    exc, value = multihost.broadcast_from_primary(out)
    if exc is not None:
        raise exc
    return value


def _stage(packed: PackedSnapshot, hubble_drag: float, device, mesh=None,
           counts=None):
    """One packed snapshot as a device :class:`SnapshotBatch` (with a
    mesh: this rank's block of it).  On CUDA the host arrays go through
    pinned buffers with asynchronous copies, so staging does not wait
    for the step still running.  ``counts``: a dict whose ``h2d_bytes``
    the bytes handed to the device are added into."""
    cuda = torch.device(device).type == "cuda"

    def t(a):
        if a is None:
            return None
        x = torch.from_numpy(np.ascontiguousarray(a))
        if counts is not None:
            counts["h2d_bytes"] = counts.get("h2d_bytes", 0) + x.nbytes
        if cuda:
            return x.pin_memory().to(device, non_blocking=True)
        return x.to(device)

    batch = SnapshotBatch(
        ids=packed.ids, pos=packed.pos, vel=packed.vel,
        center=packed.center, mass=packed.mass,
        bulk_vel=packed.bulk_vel, hubble_drag=float(hubble_drag),
        slot=packed.slot,
    )
    if mesh is not None:
        from orbitanalysis_tpu_torch.parallel.sharding import shard_tree

        return shard_tree(batch, mesh, put=t)
    return SnapshotBatch(*(
        t(x) if isinstance(x, np.ndarray) else x for x in batch))


def _particles_step(step, mesh):
    """The general step on a ``('halos', 'particles')`` mesh: gather each
    of this rank's rows from the ``'particles'`` group, run the
    single-device step on whole rows, and keep this rank's particle
    block of the new carry (the events stay whole rows, the same on
    every rank of the group).  XLA inserts the same all-gathers for the
    JAX package's mesh (``parallel/mesh.py:9-11``)."""
    from orbitanalysis_tpu_torch.parallel.sharding import (
        gather_tree,
        shard_tree,
        tree_sharding_specs,
        tree_map,
    )

    def sharded(carry, batch):
        specs = tree_sharding_specs(carry, mesh)
        carry = gather_tree(carry, mesh, axes=("particles",))
        batch = gather_tree(batch, mesh, axes=("particles",))
        carry, events = step(carry, batch)
        # the new carry's particle block: the halo axis is already local
        keep = tree_map(lambda _, s: tuple(
            a if a == "particles" else None for a in s), carry, specs)
        return shard_tree(carry, mesh, keep), events

    return sharded


class _StepClock:
    """The step's stretch of the device stream: CUDA timing events
    recorded after the staging copies (at creation) and after the step's
    last launch (:meth:`stop`, before the step's fetch copies).  Read
    once the fetch's own event has completed, which completes both: no
    added synchronisation."""

    def __init__(self):
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)
        self._start.record()

    def stop(self):
        self._end.record()

    def seconds(self) -> float:
        return self._start.elapsed_time(self._end) * 1e-3


def _allgather(mesh, axis, x) -> np.ndarray:
    """Every rank's block of ``x`` over the mesh's ``axis``, on the host."""
    from orbitanalysis_tpu_torch.parallel.collectives import process_allgather

    return process_allgather(x, mesh.group(axis), tiled=True)


def _padded(x: torch.Tensor, pad: int, value, dim: int = -1) -> torch.Tensor:
    """``x`` with ``pad`` entries of ``value`` appended along ``dim``."""
    shape = list(x.shape)
    shape[dim] = pad
    tail = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=dim)


class _Run(NamedTuple):
    """What every engine of one call is built from."""

    n_rows: int
    id_dtype: object
    angle_dtype: object
    device: torch.device
    mesh: object
    capacity: Optional[int]  # the caller's, as are the next two
    headroom: float
    event_capacity: Optional[int]
    resume_layout: Optional[np.ndarray] = None  # the aligned engine's
    box_size: object = None  # the seed snapshot's


class _Loaded(NamedTuple):
    """One loaded snapshot, as the loop hands it to an engine."""

    data: dict  # the loader's
    rows: np.ndarray  # active halo rows
    offsets: np.ndarray
    lengths: np.ndarray  # particles a region
    positions: np.ndarray  # region centres of ``rows``
    bulk_vels: Optional[np.ndarray]


class _Engine:
    """The interface the tracker's loop drives, one engine a detection
    mode (``engines[0]`` of a ``mode='both'`` pair leads and packs for
    both): ``seed_capacity``, ``create``, ``needs_growth``, ``grow`` or
    ``to_general`` (if it ``converts``), ``pack``, ``is_static``,
    ``stage``, ``step``, ``events`` and the checkpoint trio
    (``checkpoint_angles``, ``load_order_angles``, ``restore_angles``).
    The defaults here are those of an engine that needs none."""

    join = None  # the engine's name in the Metrics records
    limit = None  # per-row capacity ceiling (sorted, aligned)
    converts = False  # growth may convert it to the general engine
    surrogate = False  # wide IDs ride a 32-bit device surrogate

    @classmethod
    def resume_layout(cls, writer, savefile):  # noqa: ARG003
        """The checkpointed layout a resumed run restores (None)."""
        return None

    @classmethod
    def create(cls, run: _Run, modes, capacity: int) -> list:
        """One engine a detection mode."""
        return [cls(run, m, capacity) for m in modes]

    def is_static(self, ids, prev_ids) -> bool:  # noqa: ARG002
        """Whether the step may skip the join (static membership)."""
        return False


class _RowEngine(_Engine):
    """The device carry and step functions of one detection mode over
    ``[n_rows, capacity]`` particle rows (with a ``'halos'`` mesh, this
    rank's block of rows): what the general, sorted and aligned engines
    share."""

    sort_ids = False  # rows staged ID-sorted on the host

    def __init__(self, run: _Run, mode, capacity, event_capacity=None):
        self.run = run
        self.n_halos = run.n_rows
        self.capacity = capacity
        # hosts fetch [H, K] event lists instead of [H, P] masks; K is
        # sized for the rare-event regime, overflow is recovered
        k = run.event_capacity if event_capacity is None else event_capacity
        self.event_capacity = min(
            max(128, round_up(capacity // 16, 128)) if k is None else k,
            capacity)
        self.mode, self.box_size, self.device = mode, run.box_size, run.device
        self.id_dtype, self.angle_dtype = run.id_dtype, run.angle_dtype
        self.invalid = invalid_id_for(run.id_dtype)
        # a 'halos' mesh: this rank holds a block of rows (and, on a
        # 'particles' axis, a block of each row's slots); the carry is
        # made on the host and cut into the blocks
        self.mesh = run.mesh
        self._steps = {}
        home = self.device if self.mesh is None else "cpu"
        self.carry = self._place(self._new_carry(home))

    @classmethod
    def seed_capacity(cls, run: _Run, snap: _Loaded) -> int:
        """The per-row capacity the engine starts at."""
        return run.capacity or required_capacity(snap.lengths, run.headroom)

    def _place(self, tree):
        """A full tree as this rank's blocks (itself without a mesh)."""
        if self.mesh is None:
            return tree
        from orbitanalysis_tpu_torch.parallel.sharding import shard_tree

        return shard_tree(tree, self.mesh)

    def _full(self, tree):
        """A tree of this engine's blocks whole, on every rank."""
        if self.mesh is None:
            return tree
        from orbitanalysis_tpu_torch.parallel.sharding import gather_tree

        return gather_tree(tree, self.mesh)

    def _step_fn(self, static=False):
        key = (self.capacity, self.event_capacity, static)
        if key not in self._steps:
            step = self._make_step(static)
            # a 'halos' mesh runs the single-device step on each rank's
            # rows (no collective); a 'particles' axis gathers rows first
            if self.mesh is not None and "particles" in self.mesh.axis_names:
                step = _particles_step(step, self.mesh)
            self._steps[key] = step
        return self._steps[key]

    def needs_growth(self, lengths) -> bool:
        return bool(lengths.size) and int(lengths.max()) > self.capacity

    def grow(self, new_capacity):
        """Re-pad the carry's particle axis on the device."""
        new_capacity = self._grown_capacity(new_capacity)
        pad = new_capacity - self.capacity
        if pad <= 0:
            return
        self.carry = self._place(self._grown(self._full(self.carry), pad))
        self.capacity = new_capacity
        self._steps.clear()

    def _grown_capacity(self, new_capacity):
        return round_up(new_capacity, 128)

    def grow_events(self, needed: int):
        """Grow the per-halo event-list width to the next power of two
        covering ``needed`` (at most the capacity; the carry stays)."""
        new_k = min(max(round_up_pow2(int(needed)), 128), self.capacity)
        if new_k <= self.event_capacity:
            return
        self.event_capacity = new_k
        self._steps.clear()

    def pack(self, snap: _Loaded, partners, phases, acct):  # noqa: ARG002
        """``(packed, ids, slot)``: ``snap`` packed for the step (timed
        into ``phases``; ``acct``: the accounting's dict, or None) with
        the host's ``[H, P]`` ID and load-slot tables of its layout."""
        with phase_timer(phases, "track.pack"):
            packed = pack_snapshot(
                snap.data, snap.rows, self.n_halos, self.capacity,
                snap.positions, snap.bulk_vels, id_dtype=self.id_dtype,
                sort_ids=self.sort_ids)
        return packed, packed.ids, packed.slot

    def stage(self, packed: PackedSnapshot, hubble_drag, counts=None):
        """The step's input: this rank's block of ``packed`` on the
        device (``counts``: as :func:`_stage`'s)."""
        return _stage(packed, hubble_drag, self.device, self.mesh, counts)

    def step(self, batch: SnapshotBatch, static=False, clock=None):
        self.carry, events = self._step_fn(static)(self.carry, batch)
        if clock is not None:
            clock.stop()
        small = self._fetched(events)
        if self.mesh is not None:
            # the 'halos' group's rows ('particles' ranks hold whole rows)
            gather = functools.partial(_allgather, self.mesh, "halos")
            return _MeshEvents(events, gather), _MeshFetch(small, gather)
        return events, _Fetch(small)

    def restore_angles(self, ck_angles: np.ndarray, offsets, rows, order):
        """Resume: the carry's angles from the (load-order) sidecar;
        ``order``: the staged slot channel (flag bits masked)."""
        self._set_angles(self._device_layout(pack_ragged(
            ck_angles, offsets, self.n_halos, self.capacity, rows=rows,
            fill=0.0), order))

    def _device_layout(self, x, order):  # noqa: ARG002
        return x

    def _set_angles(self, angles):
        self.carry = self.carry._replace(
            angles=self._place(torch.from_numpy(np.ascontiguousarray(
                angles, dtype=self.angle_dtype))).to(self.device))

    def checkpoint_angles(self) -> np.ndarray:
        """Per-particle angle accumulators on the host, in the carry's
        device layout (checkpointing; collective with a mesh)."""
        return _host(self._full(self.carry.angles))

    def load_order_angles(self, angles_dev, p: "_Pending"):
        """:meth:`checkpoint_angles` of the pending snapshot ``p`` ->
        ``(angles, layout_positions)`` flat in reference (load-order)
        layout; the aligned engine adds each particle's stable position
        so resume can rebuild its layout exactly (else None)."""
        _, angles_flat = unpack_mask(p.packed_ids != self.invalid,
                                     angles_dev, rows=p.rows)
        return angles_flat, None


class _GeneralEngine(_RowEngine):
    """The sort-merge join step on load-order rows: any ID and angle
    dtype, any capacity, a ``'particles'`` mesh axis."""

    join = "general"

    def _new_carry(self, home):
        return init_carry(self.n_halos, self.capacity, id_dtype=self.id_dtype,
                          angle_dtype=self.angle_dtype, device=home)

    def _make_step(self, static):
        make = make_static_orbit_step if static else make_orbit_step
        return make(mode=self.mode, box_size=self.box_size,
                    id_dtype=self.id_dtype, angle_dtype=self.angle_dtype,
                    event_capacity=self.event_capacity)

    def is_static(self, ids, prev_ids) -> bool:
        # an identical ID layout to the previous snapshot needs no join
        # (the sorted engine tests it on the device)
        return prev_ids is not None and bool(np.array_equal(ids, prev_ids))

    def _grown(self, c, pad):
        return Carry(ids=_padded(c.ids, pad, self.invalid),
                     rhat=_padded(c.rhat, pad, 0.0),
                     vrad=_padded(c.vrad, pad, 0.0),
                     angles=_padded(c.angles, pad, 0.0))

    def _fetched(self, events) -> dict:
        return dict(count=events.ev_count, ids=events.ev_ids,
                    angles=events.ev_angles, bulk_vel=events.bulk_vel)

    def events(self, p, events, fetch, count, phases, decode, verbose):
        """The saved rows' events of the pending snapshot ``p`` -> ``(ids,
        angles, counts)`` flat in reference order (the fetches timed into
        ``phases``, the host decode into ``decode``, which may be None)."""
        rows = p.saved_rows
        counts = count[rows]
        if int(counts.max(initial=0)) > self.event_capacity:
            # event-capacity overflow: fetch the full masks
            with phase_timer(phases, "track.fetch"):
                apsis = _host(events.apsis)
                apsis_angle = _host(events.apsis_angle)
            with phase_timer(decode, "track.decode"):
                _, ids, angles = unpack_mask(apsis, p.layout_ids, apsis_angle,
                                             rows=rows)
            return ids, angles, counts
        with phase_timer(phases, "track.fetch"):
            ev_ids = fetch["ids"][rows]
            ev_angles = fetch["angles"][rows]
        with phase_timer(decode, "track.decode"):
            sel = np.arange(ev_ids.shape[1])[None, :] < counts[:, None]
            return ev_ids[sel], ev_angles[sel], counts


class _LayoutEngine(_RowEngine):
    """An engine whose carry follows a layout staged on the host (rows
    ID-sorted, or stable positions) through the staged slot permutation:
    power-of-two capacities up to :attr:`limit`, whole particle rows on
    one device, and conversion to the general engine."""

    converts = True

    @classmethod
    def seed_capacity(cls, run, snap) -> int:
        # powers of two, as the JAX package's merge network needs
        return max(round_up_pow2(super().seed_capacity(run, snap)), 128)

    def _grown_capacity(self, new_capacity):
        new_capacity = max(round_up_pow2(new_capacity), 128)
        if new_capacity > self.limit:
            raise ValueError(
                f"region growth needs capacity {new_capacity}, beyond "
                f"the {self.join} engine's per-row ceiling ({self.limit}); "
                "re-run with join_impl='general' (resume=True continues "
                "from the savefile)")
        return new_capacity

    def _slots(self, c, pad):  # appended: rows stay slot permutations
        return torch.arange(
            self.capacity, self.capacity + pad, dtype=torch.int32,
            device=c.rhat.device).expand(self.n_halos, pad)

    def to_general(self, new_capacity: int, layout_ids):
        """``(general_engine, carry_ids_in_load_order)`` at ``new_capacity``:
        the carry scattered from its device layout to load-slot order, the
        radial-velocity sign bits as +-1.0 placeholders (detection only
        compares signs).  ``layout_ids``: the ``[H, P]`` stable-position
        table of real IDs (the aligned carry is positional)."""
        new_capacity = round_up(new_capacity, 128)
        c, ids_s = self._decoded(self._full(self.carry), layout_ids)
        slot = c.slot
        h, p = ids_s.shape
        vr_s = (((c.vrb >> 1) & 1).astype(np.float32)
                - (c.vrb & 1).astype(np.float32))
        ids_l = np.full((h, new_capacity), self.invalid, dtype=ids_s.dtype)
        vr_l = np.zeros((h, new_capacity), dtype=np.float32)
        ang_l = np.zeros((h, new_capacity), dtype=c.angles.dtype)
        rhat_l = np.zeros((3, h, new_capacity), dtype=np.float32)
        np.put_along_axis(ids_l, slot, ids_s, axis=-1)
        np.put_along_axis(vr_l, slot, vr_s, axis=-1)
        np.put_along_axis(ang_l, slot, c.angles, axis=-1)
        np.put_along_axis(rhat_l, np.broadcast_to(slot[None], c.rhat.shape),
                          c.rhat, axis=-1)
        out = _GeneralEngine(self.run, self.mode, new_capacity,
                             event_capacity=self.event_capacity)
        out.carry = out._place(carry_from_numpy(
            ids_l, rhat_l, vr_l, ang_l,
            device=self.device if self.mesh is None else "cpu"))
        return out, ids_l

    def _device_layout(self, x, order):
        return np.take_along_axis(x, np.asarray(order), axis=-1)

    def load_order_angles(self, angles_dev, p: "_Pending"):
        # the carry follows the staged layout: scatter back to load order
        slot = np.asarray(p.packed_slot)
        valid = np.zeros(slot.shape, dtype=bool)
        np.put_along_axis(valid, slot, p.packed_ids != self.invalid, axis=-1)
        angles = np.zeros_like(angles_dev)
        np.put_along_axis(angles, slot, angles_dev, axis=-1)
        _, angles_flat = unpack_mask(valid, angles, rows=p.rows)
        return angles_flat, self._layout_positions(slot, valid, p.rows)

    def _layout_positions(self, slot, valid, rows):  # noqa: ARG002
        return None


class _SortedEngine(_LayoutEngine):
    """Rows staged ID-sorted on the host, an ID-sorted carry and the
    join-and-detect kernel on the card (32-bit signed IDs, f32 angles);
    each step reads one flag on the host (static membership or not)."""

    join = "sorted"
    limit = MAX_FUSED_CAPACITY
    sort_ids = True

    def _new_carry(self, home):
        return init_sorted_carry(
            self.n_halos, self.capacity, id_dtype=self.id_dtype,
            angle_dtype=self.angle_dtype, device=home)

    def _make_step(self, static):  # noqa: ARG002
        # the event buffer spans the whole capacity (overflow free);
        # events in ID order with their load slots
        return make_sorted_orbit_step(
            self.capacity, mode=self.mode, box_size=self.box_size,
            id_dtype=self.id_dtype, angle_dtype=self.angle_dtype,
            fused=True, cur_presorted=True, events_id_order=True)

    def _grown(self, c, pad):
        # sentinel IDs sort last, so each row stays ID-sorted
        return SortedCarry(ids=_padded(c.ids, pad, self.invalid),
                           slot=torch.cat([c.slot, self._slots(c, pad)], -1),
                           vrb=_padded(c.vrb, pad, 0),
                           rhat=_padded(c.rhat, pad, 0.0),
                           angles=_padded(c.angles, pad, 0.0))

    def _decoded(self, full, layout_ids):  # noqa: ARG002
        c = sorted_carry_to_numpy(full)
        return c, c.ids

    def _fetched(self, events) -> dict:
        return dict(count=events.count, ids=events.ids, angles=events.angles,
                    slots=events.slots, bulk_vel=events.bulk_vel)

    def events(self, p, events, fetch, count, phases, decode, verbose):
        """As :meth:`_GeneralEngine.events`.  Overflow free (the event
        buffer spans the capacity); events come in ID order with their
        load slots, and the host restores reference order on a
        count-bounded slice."""
        rows = p.saved_rows
        counts = count[rows]
        kf = min(round_up(max(int(counts.max(initial=0)), 1), 256),
                 self.capacity)
        with phase_timer(phases, "track.fetch"):
            ev_ids = fetch["ids"][rows, :kf]
            ev_angles = fetch["angles"][rows, :kf]
            ev_slots = fetch["slots"][rows, :kf]
        with phase_timer(decode, "track.decode"):
            sel = np.arange(kf)[None, :] < counts[:, None]
            order = np.argsort(
                np.where(sel, ev_slots, np.iinfo(np.int32).max),
                axis=-1, kind="stable")
            ids = np.take_along_axis(ev_ids, order, -1)[sel]
            angles = np.take_along_axis(ev_angles, order, -1)[sel]
        return ids, angles, counts


class _AlignedEngine(_LayoutEngine):
    """Stable row positions staged on the host (one :class:`StableLayout`
    a ``mode='both'`` pair), no device join, positional events.  Wide
    (64-bit) IDs ride a 32-bit position surrogate on the device:
    detection is positional in the stable layout; event positions map
    back through the staged host ID table."""

    join = "aligned"
    limit = MAX_ALIGNED_CAPACITY

    def __init__(self, run: _Run, mode, capacity, event_capacity=None):
        self.surrogate = np.dtype(run.id_dtype).itemsize == 8
        self._dev_id_dtype = np.int32 if self.surrogate else run.id_dtype
        self._dev_invalid = invalid_id_for(self._dev_id_dtype)
        self.layout = None
        # the checkpointed positions, restored by the first pack
        self._restore = run.resume_layout
        super().__init__(run, mode, capacity, event_capacity)

    @classmethod
    def resume_layout(cls, writer, savefile):
        # the aligned layout is history-dependent: restore it from the
        # sidecar so the resumed run reproduces the crashed run's
        # positions bit for bit
        try:
            return _on_primary(lambda: writer.read_checkpoint(
                savefile, with_layout=True))[2]
        except OSError:
            return None  # the seed snapshot's resume raises the error

    @classmethod
    def seed_capacity(cls, run, snap) -> int:
        cap = super().seed_capacity(run, snap)
        if run.resume_layout is not None and run.resume_layout.size:
            # the crashed run may have grown past what the seed snapshot
            # needs; its checkpointed positions must stay addressable
            cap = max(cap, round_up_pow2(int(run.resume_layout.max()) + 1))
        return cap

    @classmethod
    def create(cls, run, modes, capacity):
        engines = super().create(run, modes, capacity)
        layout = StableLayout(run.n_rows, capacity, id_dtype=run.id_dtype)
        for e in engines:
            e.layout = layout
        return engines

    def _new_carry(self, home):
        return init_aligned_carry(self.n_halos, self.capacity, device=home)

    def _make_step(self, static):  # noqa: ARG002
        # bounded event buffer; overflow stays lossless because the step
        # also emits the full pre-compaction payload plane, from which
        # the writer recovers every event
        return make_aligned_native_step(
            self.event_capacity, mode=self.mode, box_size=self.box_size,
            id_dtype=self._dev_id_dtype, angle_dtype=self.angle_dtype,
            emit_payload=True)

    def grow(self, new_capacity):
        super().grow(new_capacity)
        self.layout.grow(self.capacity)

    def _grown(self, c, pad):
        # sentinel keys, appended slot numbers, zero rhat/angle planes
        return type(c)(key=_padded(c.key, pad, -1),
                       sv=torch.cat([c.sv, self._slots(c, pad)], dim=-1),
                       rhat=_padded(c.rhat, pad, 0.0),
                       packed=_padded(c.packed, pad, 0))

    def _decoded(self, full, layout_ids):
        return decode_aligned_carry(full), np.asarray(layout_ids)

    def pack(self, snap, partners, phases, acct):  # noqa: ARG002
        with phase_timer(phases, "track.pack"):
            restore = None
            if self._restore is not None:
                restore = pack_ragged(
                    self._restore.astype(np.int32), snap.offsets,
                    self.n_halos, self.capacity, rows=snap.rows, fill=-1)
                self._restore = None
            packed = pack_snapshot_aligned(
                snap.data, snap.rows, self.n_halos, self.layout,
                snap.positions, snap.bulk_vels, id_dtype=self.id_dtype,
                restore_dest=restore, phases=acct)
        # strip the FRESH flags: host bookkeeping uses the slot channel
        # as scatter/gather indices
        ids, slot = packed.ids, packed.slot & SLOT_MASK
        if self.surrogate:
            # wide IDs stay on the host; the device ID channel is the
            # position surrogate (iota where occupied)
            iota = np.broadcast_to(
                np.arange(self.capacity, dtype=np.int32), ids.shape)
            packed = packed._replace(ids=np.where(
                ids != self.invalid, iota, np.int32(self._dev_invalid)))
        return packed, ids, slot

    def _fetched(self, events) -> dict:
        return dict(count=events.count, ids=events.ids, angles=events.angles,
                    bulk_vel=events.bulk_vel)

    def _set_angles(self, angles):
        ang = np.ascontiguousarray(angles, dtype=np.float32).view(np.int32)
        match = self.carry.packed & -(1 << 31)
        self.carry = self.carry._replace(
            packed=self._place(torch.from_numpy(ang)).to(self.device)
            | match)

    def checkpoint_angles(self) -> np.ndarray:
        packed = _host(self._full(self.carry.packed) & 0x7FFFFFFF)
        return packed.view(np.float32)

    def _layout_positions(self, slot, valid, rows):
        pos_of = np.zeros(slot.shape, dtype=np.int32)
        np.put_along_axis(pos_of, slot, np.broadcast_to(
            np.arange(slot.shape[-1], dtype=np.int32), slot.shape), axis=-1)
        return unpack_mask(valid, pos_of, rows=rows)[1]

    def events(self, p, events, fetch, count, phases, decode, verbose):
        """As :meth:`_GeneralEngine.events`.  The device returns
        stable-layout row positions and f16-exact angles; particle IDs
        come from the current snapshot's staged ID table (an event
        position's tenant is unchanged since the previous snapshot) and
        the order from the PREVIOUS snapshot's load slots (the reference
        emits apsides in previous-snapshot load order)."""
        rows = p.saved_rows
        counts = count[rows]
        width = events.ids.shape[1]
        if int(counts.max(initial=0)) > width:
            # The compaction cut events past the buffer width while the
            # counts kept them.  Nothing is lost: decode every event of
            # this snapshot from the full pre-compaction payload plane,
            # then grow the event capacity for the following steps.
            kf = round_up(int(counts.max()), 256)
            with phase_timer(phases, "track.fetch"):
                pay = events.payload
                if isinstance(pay, tuple):
                    # wide-row pair format: pos + 1 where an event fired,
                    # f16 bits alongside
                    posw = _host(pay[0])[rows]
                    angw = _host(pay[1])[rows]
                else:
                    # angle words: apsis flag in bit 31, f32 angle bits
                    pw = _host(pay)[rows].view(np.uint32)
                    posw = np.where(
                        pw >> np.uint32(31),
                        np.arange(pw.shape[1], dtype=np.uint32)[None, :] + 1,
                        np.uint32(0))
                    # the kernel's own f16 encode (clamps past 65504)
                    angw = f16_bits_rne(torch.from_numpy(
                        (pw & np.uint32(0x7FFFFFFF)).view(np.float32))).numpy()
            with phase_timer(decode, "track.decode"):
                nsr = posw.shape[0]
                ev_pos = np.zeros((nsr, kf), np.int32)
                ang_bits = np.zeros((nsr, kf), np.uint16)
                for r in range(nsr):
                    nz = np.flatnonzero(posw[r])
                    ev_pos[r, :len(nz)] = posw[r, nz].astype(np.int64) - 1
                    ang_bits[r, :len(nz)] = angw[r, nz].astype(np.uint16)
                ev_angles = ang_bits.view(np.float16).astype(np.float32)
            if verbose:
                print("Event buffer overflow on snapshot "
                      f"{'%03d' % p.snapshot_number} (max "
                      f"{int(counts.max())} apsides/halo > {width}): recovered "
                      "all events from the payload plane; growing event "
                      "capacity\n")
            self.grow_events(int(counts.max()))
        else:
            kf = width
            with phase_timer(phases, "track.fetch"):
                ev_pos = fetch["ids"][rows]
                ev_angles = fetch["angles"][rows]
        with phase_timer(decode, "track.decode"):
            sel = np.arange(kf)[None, :] < counts[:, None]
            prev_slot = p.prev_packed_slot[rows]
            pos_idx = np.clip(ev_pos.astype(np.int64), 0,
                              prev_slot.shape[1] - 1)
            ev_slots = np.take_along_axis(prev_slot, pos_idx, axis=-1)
            slot_key = np.where(sel, ev_slots, np.iinfo(np.int32).max)
            order = np.argsort(slot_key, axis=-1, kind="stable")
            ev_pos = np.take_along_axis(ev_pos, order, axis=-1)
            ev_angles = np.take_along_axis(ev_angles, order, axis=-1)
            id_tab = p.packed_ids[rows]
            ev_ids = np.take_along_axis(id_tab, np.clip(
                ev_pos.astype(np.int64), 0, id_tab.shape[1] - 1), axis=-1)
            return ev_ids[sel], ev_angles[sel], counts


class _HashEngine(_Engine):
    """Hash-sharded particle-pool engine (the full-box scale path): flat
    (halo, id) records sharded by ``id % n_shards`` over the mesh's
    ``'shards'`` axis, one shard a rank (:mod:`~orbitanalysis_tpu_torch.
    parallel.hash_sharded`).  The churn join is shard-local; the
    collective of a step is the sum of the bulk-velocity moments.  Every
    rank routes the same snapshot on the host and keeps its row (no
    ``[H, P]`` host layout)."""

    join = "hash"

    def __init__(self, run: _Run, mode, cap, id_map=None):
        from orbitanalysis_tpu_torch.parallel.hash_sharded import (
            init_hash_carry,
            make_hash_sharded_step,
        )

        self.mesh, self.n_halos, self.mode = run.mesh, run.n_rows, mode
        self.n_shards = int(run.mesh.shape["shards"])
        self.box_size, self.angle_dtype = run.box_size, run.angle_dtype
        self.capacity = cap
        self.event_capacity = cap  # event lists span the shard: no overflow
        self.invalid = invalid_id_for(np.int32)
        # wide (64-bit) IDs ride dense int32 handles on the device
        # (a WideIdMap; None for 32-bit IDs); events unmap to real IDs at
        # write time.  Every rank maps the same stream, so every rank
        # holds the same handles, and the engines of a mode='both' pair
        # share the one map the pair routes through.
        self.id_map = id_map
        self._gather = functools.partial(_allgather, self.mesh, "shards")
        self._make = make_hash_sharded_step
        self._build()
        self.carry = init_hash_carry(1, cap, self.n_halos,
                                     device=self.mesh.device)

    @classmethod
    def seed_capacity(cls, run, snap) -> int:
        n_shards = int(run.mesh.shape["shards"])
        return run.capacity or round_up(int(np.ceil(
            len(snap.data["ids"]) / n_shards * run.headroom)) + 1, 128)

    @classmethod
    def create(cls, run, modes, capacity):
        from orbitanalysis_tpu_torch.parallel.hash_sharded import WideIdMap

        # one ID map: the pair routes once, through engines[0]
        id_map = (WideIdMap() if np.dtype(run.id_dtype).itemsize == 8
                  else None)
        return [cls(run, m, capacity, id_map=id_map) for m in modes]

    def _build(self):
        self._step = self._make(
            self.mesh, self.n_halos, self.capacity, mode=self.mode,
            box_size=self.box_size, angle_dtype=self.angle_dtype)

    def needs_growth(self, lengths) -> bool:  # noqa: ARG002
        return False  # the shard capacity grows in route()

    def route(self, flat):
        """This rank's row of the snapshot's routed ``[D, cap]`` blocks
        (the shard capacity grows first where a bucket outgrows it: a
        decision every rank takes alike, from the same host data)."""
        from orbitanalysis_tpu_torch.parallel.hash_sharded import route_flat
        from orbitanalysis_tpu_torch.parallel.sharding import shard_rows

        if self.id_map is not None:
            # map once here (persistent handles) so the bucket-size
            # check below sees the same keys route_flat shards on
            flat = dict(flat, ids=self.id_map.map(flat["ids"]))
        ids = np.asarray(flat["ids"], dtype=np.int64)
        if ids.size:
            largest = int(np.bincount((ids % self.n_shards).astype(np.int64),
                                      minlength=self.n_shards).max())
            if largest > self.capacity:
                self.grow(largest)
        return shard_rows(route_flat(flat, self.n_shards, self.capacity),
                          self.mesh, "shards")

    def grow(self, needed):
        self.grow_to(round_up(int(np.ceil(needed * 1.2)), 128))

    def grow_to(self, new_cap):
        """Re-pad the per-shard record capacity to exactly ``new_cap``
        (lockstep growth across mode='both' engine pairs)."""
        pad = new_cap - self.capacity
        if pad <= 0:
            return
        c = self.carry
        self.carry = type(c)(halo=_padded(c.halo, pad, self.n_halos, dim=1),
                             ids=_padded(c.ids, pad, self.invalid, dim=1),
                             slot=_padded(c.slot, pad, 0, dim=1),
                             vrad=_padded(c.vrad, pad, 0.0, dim=1),
                             rhat=_padded(c.rhat, pad, 0.0, dim=1),
                             angles=_padded(c.angles, pad, 0.0, dim=1))
        self.capacity = new_cap
        self.event_capacity = new_cap
        self._build()

    def pack(self, snap: _Loaded, partners, phases, acct):  # noqa: ARG002
        """``(staged, None, None)``: this rank's routed batch row (routed
        once for the pair; the partners' shard capacity grows in
        lockstep) with the ``[n_rows, 3]`` centre and catalog
        bulk-velocity tables, on the device."""
        with phase_timer(phases, "track.pack"):
            data, rows = snap.data, snap.rows
            flat = dict(halo=np.repeat(rows.astype(np.int32), snap.lengths),
                        ids=data["ids"], pos=data["coordinates"],
                        vel=data["velocities"])
            m = data.get("masses")
            if (isinstance(m, np.ndarray) and np.ndim(m) == 1
                    and len(m) == len(data["ids"])):
                flat["mass"] = m
            batch = self.route(flat)  # grows the shard capacity if needed
            for e in partners:
                if e.capacity < self.capacity:
                    e.grow_to(self.capacity)
            centers = np.zeros((self.n_halos, 3), np.float32)
            centers[rows] = snap.positions
            centers = torch.from_numpy(centers).to(self.mesh.device)
            bulk = None
            if snap.bulk_vels is not None:
                bulk = np.zeros((self.n_halos, 3), np.float32)
                bulk[rows] = snap.bulk_vels
                bulk = torch.from_numpy(bulk).to(self.mesh.device)
        return (batch, centers, bulk), None, None

    def stage(self, packed, hubble_drag, counts=None):  # noqa: ARG002
        """The step's input (routed on the device: nothing to count)."""
        return packed + (hubble_drag,)

    def step(self, staged, static=False, clock=None):  # noqa: ARG002 — mesh
        self.carry, events = self._step(self.carry, *staged)
        small = dict(count=events.count, halo=events.halo, ids=events.ids,
                     slots=events.slots, angles=events.angles,
                     bulk_vel=events.bulk_vel)
        return events, _MeshFetch(small, self._gather,
                                  replicated=("bulk_vel",))

    def events(self, p, events, fetch, count, phases, decode, verbose):
        """The shards' events of the saved rows -> ``(ids, angles,
        counts)`` flat in reference order (events ride their halo row
        and previous load slot; wide IDs unmap from their handles; the
        fetched counts are a shard's, not a row's)."""
        from orbitanalysis_tpu_torch.parallel.hash_sharded import (
            events_to_reference_order,
        )

        with phase_timer(phases, "track.fetch"):
            offs, ids, ang = events_to_reference_order(
                fetch["count"], fetch["halo"], fetch["ids"], fetch["slots"],
                fetch["angles"], self.n_halos)
        rows = p.saved_rows
        counts = np.diff(offs)[rows]
        sel = (np.concatenate([np.arange(offs[r], offs[r + 1])
                               for r in rows]).astype(np.int64)
               if len(rows) else np.zeros(0, np.int64))
        ids = ids[sel]
        if self.id_map is not None:
            ids = self.id_map.unmap(ids)  # device handles -> real IDs
        return ids, ang[sel], counts

    def checkpoint_angles(self):
        """(slot, valid, angles) of every shard on the host, for the
        checkpoint (collective)."""
        c = self.carry
        return (self._gather(c.slot), self._gather(c.ids) != self.invalid,
                self._gather(c.angles))

    def load_order_angles(self, captured, p):
        """:meth:`checkpoint_angles` -> ``(angles, None)``, the angles
        flat in load order (the records carry their load slots)."""
        slot, valid, angles = captured
        flat = np.zeros(p.n_particles, dtype=angles.dtype)
        flat[slot[valid]] = angles[valid]
        return flat, None

    def restore_angles(self, ck_angles, offsets, rows, order):  # noqa: ARG002
        """Resume: replace this shard's carry angles from the
        (load-order) sidecar, through the records' load slots."""
        ck = np.asarray(ck_angles, dtype=np.float32)
        if ck.size == 0:
            return  # empty resume snapshot: carry angles stay zero
        slot = _host(self.carry.slot)
        valid = _host(self.carry.ids) != self.invalid
        new = np.where(valid, ck[np.minimum(slot, len(ck) - 1)],
                       0.0).astype(np.float32)
        self.carry = self.carry._replace(
            angles=torch.from_numpy(new).to(self.mesh.device))


_ENGINES = {e.join: e for e in (_GeneralEngine, _SortedEngine,
                                _AlignedEngine)}  # join_impl's names


def _pick_engine(join_impl, device_type, axis_names, id_dtype, angle_dtype,
                 capacity=None):
    """The engine class of a call, a pure function of its arguments:
    ``axis_names`` the mesh's (empty without one), ``capacity`` the seed
    snapshot's as the candidate engine starts it (``seed_capacity``;
    None before the seed snapshot: only the checks that need none).
    ``'auto'`` picks the aligned engine on a CUDA device when its
    constraints hold (32- or 64-bit signed IDs, f32 angles, whole rows,
    32-bit IDs up to ``AUTO_FUSED_CAPACITY``), else the general one."""
    if join_impl not in ("auto", "general", "sorted", "aligned"):
        raise ValueError(f"unknown join_impl: {join_impl!r}")
    if "shards" in axis_names:
        if join_impl in ("sorted", "aligned"):
            raise ValueError(
                "a 'shards' mesh runs the hash-sharded engine; "
                f"join_impl={join_impl!r} does not apply — use 'auto'")
        return _HashEngine
    if join_impl == "auto":
        idt = np.dtype(id_dtype)
        if not (device_type == "cuda" and "particles" not in axis_names
                and idt.itemsize in (4, 8)
                and np.issubdtype(idt, np.signedinteger)
                and np.dtype(angle_dtype) == np.float32):
            return _GeneralEngine
        if (capacity is not None and idt.itemsize == 4
                and capacity > AUTO_FUSED_CAPACITY):
            return _GeneralEngine
        join_impl = "aligned"
    engine = _ENGINES[join_impl]
    if engine.limit is None:
        return engine
    if "particles" in axis_names:
        raise ValueError(
            f"join_impl={join_impl!r} shards the halo axis only (its "
            "kernels need whole particle rows on one device); use a "
            "mesh without a 'particles' axis or join_impl='general'")
    if capacity is not None and capacity > engine.limit:
        raise ValueError(
            f"join_impl={join_impl!r} supports per-halo capacities up to "
            f"{engine.limit} (needed {capacity}); use join_impl='general'")
    return engine


def _growth_converts(join_impl, grow_impl) -> bool:
    """The picker's rule for growth: whether capacity growth converts a
    sorted or aligned engine to the general one (``grow_impl='auto'``:
    when the picker chose the engine)."""
    if grow_impl not in ("auto", "keep", "general"):
        raise ValueError(f"unknown grow_impl: {grow_impl!r}")
    return grow_impl == "general" or grow_impl == join_impl == "auto"


@dataclasses.dataclass
class _Pending:
    """A snapshot whose step is queued: its fetch, write and checkpoint
    wait until the next snapshot's step is issued (``save`` False: the
    seed snapshot, which only seeds the carry)."""

    phases: dict
    snapshot_number: int
    rows: np.ndarray  # active halo rows
    n_particles: int
    packed_ids: Optional[np.ndarray]  # the staged [H, P] host tables
    packed_slot: Optional[np.ndarray]  # (None on the hash engine)
    save: bool = False
    events_list: Optional[list] = None  # (events, fetch) a mode
    clock: Optional[_StepClock] = None
    t0: float = 0.0
    saved_rows: Optional[np.ndarray] = None  # active here and before
    layout_ids: Optional[np.ndarray] = None  # the previous ID table
    prev_packed_slot: Optional[np.ndarray] = None  # and load slots
    catalog: Optional[dict] = None  # the saved rows' datasets
    n_events_by_mode: dict = dataclasses.field(default_factory=dict)
    angles_host: Optional[list] = None  # captured before the next step


def track_orbits(
    snapshot_numbers,
    main_branches,
    regions,
    load_snapshot_data,
    savefile,
    mode: str = "pericentric",
    checkpoint: bool = False,
    resume: bool = False,
    verbose: bool = True,
    capacity: Optional[int] = None,
    headroom: float = 1.3,
    id_dtype=np.int32,
    angle_dtype=np.float32,
    mesh=None,
    event_capacity: Optional[int] = None,
    metrics: Optional[Metrics] = None,
    profile_dir: Optional[str] = None,
    join_impl: str = "auto",
    prefetch: int = 1,
    grow_impl: str = "auto",
    npool=None,  # noqa: ARG001 — accepted for reference API compat, unused
    device="cuda",
    writer=None,
):
    """Track pericentric/apocentric passages over a snapshot sequence.

    Parameters mirror the JAX package's ``track_orbits`` (and through it
    the reference driver); see there for the callback contract.

    snapshot_numbers : (S,) int array-like, any order.
    main_branches : (S, n_halos) int array-like of per-snapshot
        progenitor halo IDs; ``-1`` = no progenitor at that snapshot.
    regions : ``regions(snapshot_number, halo_ids) -> (positions,
        radii[, bulk_velocities])``.
    load_snapshot_data : ``load_snapshot_data(snapshot_number,
        region_positions, region_radii) -> dict`` with ``ids``,
        ``coordinates``, ``velocities``, ``masses``, ``region_offsets``
        and optionally ``box_size`` and the cosmology keys
        (``redshift``, ``H0``, ``Omega_m``, ``Omega_L``[, ``Omega_k``]).
    savefile : str, or a ``(pericentric, apocentric)`` pair for
        ``mode='both'``.
    mode : {'pericentric', 'apocentric', 'both'}
    capacity, headroom, id_dtype, angle_dtype, event_capacity, metrics,
    prefetch, checkpoint, resume, verbose : as in the JAX package.  On
        the single-device engines the ``metrics`` records also account
        for the whole call (:class:`~orbitanalysis_tpu_torch.utils.
        metrics.Metrics` lists their keys); with a mesh they hold the
        phases of each snapshot.
    profile_dir : directory for a ``torch.profiler`` Chrome trace.
    join_impl : {'auto', 'general', 'sorted', 'aligned'}.  ``'auto'``
        picks ``'aligned'`` on a CUDA device when its constraints hold
        (32- or 64-bit signed IDs, f32 angles, capacity up to
        ``AUTO_FUSED_CAPACITY``), else ``'general'``.  ``'sorted'``
        stages rows ID-sorted on the host and runs the join-and-detect
        kernel (32-bit signed IDs, f32 angles, power-of-two capacities up
        to ``MAX_FUSED_CAPACITY``); each of its steps reads one flag on
        the host (static membership or not).
    grow_impl : {'auto', 'keep', 'general'}: what capacity growth does
        to a sorted or aligned engine — ``'keep'`` grows it in place,
        ``'general'`` converts its carry to the general engine,
        ``'auto'`` converts when ``join_impl`` was auto-selected.
    device : torch device of the state and the steps (default
        ``'cuda'``; raises RuntimeError when CUDA is unavailable — pass
        ``device='cpu'`` to run on the CPU).
    writer : savefile writer (default :class:`~orbitanalysis_tpu_torch.
        engine.io_hdf5.H5Writer`); :class:`~orbitanalysis_tpu_torch.
        engine.io_hdf5.MemoryWriter` keeps the catalogs in memory.

    mesh : :class:`~orbitanalysis_tpu_torch.parallel.mesh.Mesh`, one rank
        of a ``torch.distributed`` world a device, every rank calling
        ``track_orbits`` with the same arguments.  A ``'halos'`` axis
        splits the halo rows over the ranks (padded to a multiple of the
        axis size) and runs the general, sorted or aligned engine on each
        rank's rows; a ``('halos', 'particles')`` mesh also splits the
        general engine's rows, gathered whole for each step.  A
        ``'shards'`` axis runs the hash-sharded particle-pool engine
        (:mod:`~orbitanalysis_tpu_torch.parallel.hash_sharded`).  Every
        rank loads and packs each snapshot and takes part in every
        gather of events; rank 0 alone reads and writes the savefile and
        its checkpoint.  The steps run on the mesh's device, which must
        be of ``device``'s type.
    """
    # the call's accounting (single-device engines, with metrics): the
    # lead runs from here to the first saved snapshot's iteration
    acct = metrics is not None and mesh is None
    lead = {} if acct else None
    lead_span = contextlib.ExitStack()
    lead_span.enter_context(phase_timer(lead, "track.lead"))
    device = resolve_device(device, "track_orbits")
    writer = io_hdf5.H5Writer() if writer is None else writer
    modes, savefiles = io_hdf5.normalize_mode_savefiles(mode, savefile)
    savefile = savefiles[0]  # layout leader (checkpoint layout source)
    snapshot_numbers, main_branches = _normalize_inputs(snapshot_numbers,
                                                        main_branches)
    n_rows = main_branches.shape[1]
    final_branch = main_branches[-1]
    final_snapshot = snapshot_numbers[-1]

    # single-writer savefile across the ranks of a mesh; every rank
    # takes part in every gather of device results
    primary = multihost.is_primary()
    axes = ()
    if mesh is not None:
        from orbitanalysis_tpu_torch.parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(
                "mesh must be an orbitanalysis_tpu_torch.parallel.Mesh "
                f"(parallel.make_mesh), got {type(mesh).__name__}")
        if mesh.device.type != device.type:
            raise ValueError(
                f"the mesh's device {mesh.device} is not of device="
                f"{str(device)!r}'s type")
        device, axes = mesh.device, tuple(mesh.axis_names)
        if "shards" not in axes:
            if "halos" not in axes:
                raise ValueError(
                    "mesh needs a 'halos' or a 'shards' axis, got "
                    f"{mesh.axis_names}")
            # pad the halo axis so it divides evenly over the mesh
            n_rows = round_up(n_rows, int(mesh.shape["halos"]))
    pick = functools.partial(_pick_engine, join_impl, device.type, axes,
                             id_dtype, angle_dtype)
    engine_cls = pick()  # the checks that need no snapshot
    to_general_on_growth = _growth_converts(join_impl, grow_impl)

    if resume:
        if verbose:
            print("Resuming from file...\n")
        resume_snaps = _on_primary(
            lambda: [writer.last_snapshot_number(f) for f in savefiles])
        resume_snap = resume_snaps[0]
        if any(s != resume_snap for s in resume_snaps):
            raise ValueError(
                "mode='both' resume needs both savefiles at the same "
                f"snapshot; got {dict(zip(savefiles, resume_snaps))} — "
                "delete the trailing snapshot group(s) of the file that "
                "ran ahead and re-run")
        sind = int(np.argwhere(snapshot_numbers == resume_snap).flatten()[0])
        snapshot_numbers = snapshot_numbers[sind:]
        main_branches = main_branches[sind:]

    tstart = time.time()
    run = _Run(n_rows, id_dtype, angle_dtype, device, mesh, capacity,
               headroom, event_capacity,
               engine_cls.resume_layout(writer, savefile) if resume else None)
    engines: list = []  # one per detection mode; engines[0] leads
    engine: Optional[_Engine] = None
    prev_ids_host = None   # [H, P] packed ids of last processed snapshot
    prev_slot_host = None  # [H, P] staged load slots of the same
    prev_rows = None       # active halo rows of last processed snapshot
    started = False

    # Software pipeline: the step of snapshot s is queued on the device
    # and its event fetch + savefile write deferred into ``pending``,
    # flushed while snapshot s+1 loads, packs and computes.
    pending: Optional[_Pending] = None
    flushed_s = 0.0  # a saved snapshot's flush inside this iteration

    def flush_pending():
        """Fetch, decode and write the pending snapshot, then its
        checkpoint."""
        nonlocal pending, flushed_s
        if pending is None:
            return
        p, phases = pending, pending.phases
        pending = None
        new = phases if acct else None  # keys of the call's accounting
        flush = {} if acct and p.save else None
        with phase_timer(flush, "track.flush"):
            for (events, fetch), ev_engine, mname, fname in zip(
                    p.events_list if p.save else (), engines, modes,
                    savefiles):
                with phase_timer(phases, "track.fetch"):
                    ev_count = fetch["count"]
                    bulk_vel = fetch["bulk_vel"]
                if verbose:
                    print("Finished {} detection for snapshot {} "
                          "(dispatch-to-write {} s)\n".format(
                              io_hdf5.apsis_tag(mname),
                              "%03d" % p.snapshot_number, time.time() - p.t0))
                ids_flat, angles_flat, counts = ev_engine.events(
                    p, events, fetch, ev_count, phases, new, verbose)
                with phase_timer(phases, "track.save"):
                    if primary:  # single writer
                        writer.append_snapshot(
                            fname, p.snapshot_number,
                            io_hdf5.snapshot_datasets(
                                mname, apsis_ids=ids_flat,
                                apsis_offsets=np.concatenate(
                                    ([0], np.cumsum(counts))),
                                apsis_angles=angles_flat,
                                bulk_velocities=bulk_vel[p.saved_rows],
                                **p.catalog),
                            verbose=verbose)
                p.n_events_by_mode[mname] = int(len(ids_flat))
            if p.clock is not None:
                # every fetch has been read: the clock's events are done
                phases["step_device_s"] = p.clock.seconds()
            if checkpoint:
                _write_checkpoint(p, engines, savefiles, writer, primary)
        if flush is not None:
            phases["snapshot_s"] = phases.get("snapshot_s", 0.0) + \
                flush["flush_s"]
            flushed_s += flush["flush_s"]
        if p.save and metrics is not None:
            extra = ({"n_events_" + io_hdf5.apsis_tag(m): n
                      for m, n in p.n_events_by_mode.items()}
                     if len(modes) > 1 else {})
            metrics.log(
                snapshot=int(p.snapshot_number),
                n_halos_active=int(len(p.rows)),
                n_particles=int(p.n_particles),
                n_events=int(sum(p.n_events_by_mode.values())),
                join=engine.join, capacity=int(engine.capacity),
                event_capacity=int(engine.event_capacity), **extra, **phases)

    items = list(zip(main_branches, snapshot_numbers))
    feed = _SnapshotFeed(items, regions, load_snapshot_data,
                         depth=max(int(prefetch), 0))
    try:
        with trace(profile_dir):
            for i, (halo_ids, snapshot_number) in enumerate(items):
                phases = {}
                new = phases if acct else None  # the accounting's keys
                if started:
                    lead_span.close()  # the seed snapshot is done
                flushed_s = 0.0
                with phase_timer(new, "track.snapshot"):
                    if verbose:
                        print("-" * 30, "\n")
                        print("Snapshot {}\n".format(
                            "%03d" % snapshot_number))
                    # the recorded 'load' phase is the residual wait on the
                    # prefetch thread
                    with phase_timer(phases, "track.load"):
                        rows, payload = feed.get(i)
                    if payload is None:
                        continue
                    (region_positions, region_radii, region_bulk_vels,
                     snapshot) = payload
                    if len(snapshot["coordinates"]) == 0:
                        continue
                    hubble_drag = _hubble_drag(snapshot)
                    offsets = np.asarray(snapshot["region_offsets"],
                                         dtype=np.int64)
                    lengths = np.diff(np.concatenate(
                        (offsets, [len(snapshot["ids"])])))
                    snap = _Loaded(snapshot, rows, offsets, lengths,
                                   region_positions, region_bulk_vels)

                    if engine is None:  # the seed snapshot builds them
                        run = run._replace(box_size=snapshot.get("box_size"))
                        engine_cls = pick(engine_cls.seed_capacity(run, snap))
                        engines = engine_cls.create(
                            run, modes, engine_cls.seed_capacity(run, snap))
                        engine = engines[0]
                        if not resume and primary:
                            for fname, m in zip(savefiles, modes):
                                writer.initialize(fname, m, run.box_size,
                                                  verbose)

                    if engine.needs_growth(lengths):
                        # growth re-pads device state: drain the pipeline so
                        # pending overflow fallbacks keep their shapes
                        flush_pending()
                        new_cap = required_capacity(lengths, headroom)
                        to_general = engine.converts and to_general_on_growth
                        if to_general and engine.surrogate:
                            if grow_impl == "general":
                                raise ValueError(
                                    "wide (64-bit) particle IDs ride a 32-bit "
                                    "device surrogate on the aligned engine; "
                                    "grow in place instead: grow_impl='keep'")
                            to_general = False
                        if verbose:
                            print(f"Growing particle capacity {engine.capacity}"
                                  f" -> {new_cap}" + ("; switching to the "
                                  "general join engine" if to_general else "")
                                  + "\n")
                        if to_general:
                            converted = [e.to_general(new_cap, prev_ids_host)
                                         for e in engines]
                            engines = [e for e, _ in converted]
                            engine = engines[0]
                            prev_ids_host = converted[0][1]
                        else:
                            for e in engines:
                                e.grow(new_cap)
                            if prev_ids_host is not None:
                                grow_by = ((0, 0), (0, engine.capacity
                                                    - prev_ids_host.shape[1]))
                                prev_ids_host = np.pad(
                                    prev_ids_host, grow_by,
                                    constant_values=engine.invalid)
                                if prev_slot_host is not None:
                                    # padded positions are all FRESH next
                                    # step, so no event can reference them
                                    prev_slot_host = np.pad(prev_slot_host,
                                                            grow_by)

                    # host bookkeeping copies (none for the hash engine)
                    packed, packed_ids_host, packed_slot_host = engine.pack(
                        snap, engines[1:], phases, new)
                    t0 = time.time()
                    static = engine.is_static(packed_ids_host, prev_ids_host)
                    if checkpoint and pending is not None:
                        # the pending snapshot's angles, before the next
                        # step replaces the carry
                        pending.angles_host = [
                            e.checkpoint_angles() for e in engines]
                    layout_ids = prev_ids_host  # the queued step's layout
                    with phase_timer(phases, "track.step"):
                        with phase_timer(new, "track.stage"):
                            batch = engine.stage(packed, hubble_drag,
                                                 counts=new)
                        with phase_timer(new, "track.issue"):
                            clock = (_StepClock() if acct and
                                     device.type == "cuda" else None)
                            events_list = [
                                e.step(batch, static=static, clock=clock)
                                for e in engines]

                    common = (phases, snapshot_number, rows,
                              len(snapshot["ids"]), packed_ids_host,
                              packed_slot_host)
                    if not started:
                        # the first processed snapshot seeds the carry;
                        # nothing to save
                        if resume:
                            _resume_angles(engines, savefiles, writer, offsets,
                                           rows, angle_dtype, snapshot_number,
                                           packed_slot_host)
                        started = True
                        new_pending = _Pending(*common)
                    else:
                        saved_rows = np.intersect1d(rows, prev_rows)
                        radii_full = np.zeros(
                            n_rows, dtype=np.asarray(region_radii).dtype)
                        radii_full[rows] = region_radii
                        pos_full = np.zeros((n_rows, 3),
                                            dtype=region_positions.dtype)
                        pos_full[rows] = region_positions
                        if lead:  # the call's first record
                            phases.update(lead)
                            lead = None
                        new_pending = _Pending(
                            *common, save=True, events_list=events_list,
                            clock=clock, t0=t0, saved_rows=saved_rows,
                            layout_ids=layout_ids,
                            prev_packed_slot=prev_slot_host,
                            catalog=dict(
                                halo_ids=halo_ids[saved_rows],
                                final_descendant_ids=(
                                    final_branch[saved_rows]
                                    if snapshot_number != final_snapshot
                                    else None),
                                region_radii=radii_full[saved_rows],
                                region_positions=pos_full[saved_rows]))

                    # flush the previous snapshot's I/O while this step runs
                    flush_pending()
                    pending = new_pending
                    prev_ids_host = packed_ids_host
                    prev_slot_host = packed_slot_host
                    prev_rows = rows
                if flushed_s:  # the previous snapshot's, in its own
                    phases["snapshot_s"] -= flushed_s
            flush_pending()
    finally:
        feed.close()
        lead_span.close()

    if verbose:
        print("Finished {} detection for all snapshots in {} s\n".format(
            " and ".join(io_hdf5.apsis_tag(m) for m in modes),
            time.time() - tstart))


def _hubble_drag(snapshot) -> float:
    """``H(z)/(1+z)`` when the loader supplies a cosmology, else 0."""
    if "redshift" not in snapshot:
        return 0.0
    missing = [k for k in ("H0", "Omega_m", "Omega_L") if k not in snapshot]
    if missing:
        raise KeyError(
            "loader dict has 'redshift' (enables the Hubble-flow term) but "
            f"lacks {missing}; supply the full cosmology or omit 'redshift'"
        )
    Hz = hubble_parameter(
        snapshot["redshift"], snapshot["H0"], snapshot["Omega_m"],
        snapshot["Omega_L"], snapshot.get("Omega_k", 0),
    )
    return float(Hz / (1.0 + snapshot["redshift"]))


def _resume_angles(engines, savefiles, writer, offsets, rows, angle_dtype,
                   snapshot_number, packed_slot_host):
    """Seed each engine's angle state from its checkpoint sidecar (read
    by the primary process, sent to every rank)."""
    for e, fname in zip(engines, savefiles):
        ck_angles, ck_snap = _on_primary(
            lambda f=fname: writer.read_checkpoint(f))
        if ck_snap >= 0 and ck_snap != snapshot_number:
            raise ValueError(
                f"checkpoint sidecar holds angles for snapshot {ck_snap} "
                f"but the savefile resumes at snapshot {snapshot_number}; "
                "the run likely crashed between the savefile append and "
                "the checkpoint write — delete the last savefile group or "
                "the checkpoint and re-run"
            )
        e.restore_angles(np.asarray(ck_angles, dtype=angle_dtype), offsets,
                         rows, packed_slot_host)


def _write_checkpoint(p, engines, savefiles, writer, primary=True):
    """Angle sidecar of the pending snapshot, per savefile, in reference
    (load-order) layout (with the aligned engine's stable positions).
    Every rank gathers the angles; the primary writes."""
    angles_list = p.angles_host
    if angles_list is None:
        angles_list = [e.checkpoint_angles() for e in engines]
    if not primary:
        return
    for e, fname, captured in zip(engines, savefiles, angles_list):
        angles_flat, layout_flat = e.load_order_angles(captured, p)
        writer.write_checkpoint(fname, angles_flat, p.snapshot_number,
                                layout_positions=layout_flat)
