"""Snapshot-sequence drivers (twin of ``orbitanalysis_tpu/engine/scan.py``).

The JAX package walks a stacked snapshot sequence with ``lax.scan``,
the per-particle carry resident on the device.  Here the walk is a
Python loop over the snapshot axis: each step is the same eager step
function the tracker calls, and the whole stack moves to the carry's
device once before the loop.

- :func:`scan_events` / :func:`scan_events_compact`: the general step
  (full ``[S, H, P]`` apsis masks, or compacted ``[S, H, K]`` lists);
- :func:`scan_counts`: per-particle apsis counts kept in the carry,
  re-indexed each step through the step's cur->prev slot map;
- :func:`scan_events_sorted`: the sorted-carry step, on CUDA tensors
  one replayed CUDA graph of the whole scan;
- :func:`scan_events_aligned`: the aligned step on stable-layout
  staging (:func:`~orbitanalysis_tpu_torch.engine.packing.
  stage_batch_aligned`), per step or batched over the whole sequence.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops.apsis import (
    Carry,
    SnapshotBatch,
    make_orbit_step,
)
from orbitanalysis_tpu_torch.ops.join import gather_rows
from orbitanalysis_tpu_torch.utils import graphs
from orbitanalysis_tpu_torch.utils.metrics import phase_timer
from orbitanalysis_tpu_torch.utils.padding import invalid_id_for


def _with_drag_axis(snaps: SnapshotBatch) -> SnapshotBatch:
    """Broadcast a scalar ``hubble_drag`` to the snapshot axis, so every
    field has one entry a snapshot."""
    n = snaps.ids.shape[0]
    drag = snaps.hubble_drag
    if isinstance(drag, torch.Tensor):
        drag = drag.cpu().numpy()
    drag = np.broadcast_to(np.asarray(drag, np.float32), (n,))
    return snaps._replace(hubble_drag=drag)


def _on_device(snaps: SnapshotBatch, dev) -> dict:
    """Every field of a stacked batch but ``hubble_drag`` as a contiguous
    tensor on ``dev`` (``None`` fields stay ``None``)."""
    def on_dev(x):
        if x is None:
            return None
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(dev).contiguous()

    return {k: on_dev(v) for k, v in snaps._asdict().items()
            if k != "hubble_drag"}


def _scan(step, carry, snaps: SnapshotBatch, dev, emit):
    """``step`` over the snapshots of ``snaps``, the stack moved to
    ``dev`` once; ``emit(ev)`` picks each step's outputs, stacked along
    a new leading axis.  Returns ``(final_carry, stacked outputs)``.
    Each step is the profiler range ``oa.scan.step``."""
    snaps = _with_drag_axis(snaps)
    fields = _on_device(snaps, dev)
    outs = []
    for s in range(snaps.ids.shape[0]):
        with phase_timer(None, "scan.step"):
            batch = SnapshotBatch(
                **{k: None if v is None else v[s] for k, v in fields.items()},
                hubble_drag=float(snaps.hubble_drag[s]))
            carry, ev = step(carry, batch)
            outs.append(emit(ev))
    return carry, tuple(torch.stack(x) for x in zip(*outs))


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


class CountingCarry(NamedTuple):
    """Carry of :func:`scan_counts`: the tracking carry and a per-slot
    apsis counter in the current snapshot's slot layout."""

    track: Carry
    counts: torch.Tensor  # [H, P] int32, current-snapshot slot layout


def scan_events(
    carry: Carry,
    snaps: SnapshotBatch,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=np.int32,
):
    """The general step over a stacked snapshot sequence.

    ``snaps`` is a :class:`SnapshotBatch` whose fields carry a leading
    snapshot axis ``[S, ...]`` (NumPy arrays or tensors, moved to the
    carry's device once; ``mass``/``bulk_vel`` may be ``None``,
    ``hubble_drag`` a scalar or ``[S]``).  Returns ``(final_carry,
    (apsis [S, H, P] bool, apsis_angle [S, H, P]))`` in the previous
    snapshot's slot layout, what the savefile writer compacts.
    """
    step = make_orbit_step(mode=mode, box_size=box_size, id_dtype=id_dtype)
    return _scan(step, carry, snaps, carry.ids.device,
                 lambda ev: (ev.apsis, ev.apsis_angle))


def scan_events_compact(
    carry: Carry,
    snaps: SnapshotBatch,
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=np.int32,
):
    """:func:`scan_events` with the events of each step compacted to the
    front of each row: ``(ev_count [S, H], ev_ids [S, H, K], ev_angles
    [S, H, K])``.  Rows where ``ev_count > K`` were cut; re-run those
    snapshots through :func:`scan_events` (or raise ``event_capacity``).
    """
    step = make_orbit_step(mode=mode, box_size=box_size, id_dtype=id_dtype,
                           event_capacity=event_capacity)
    return _scan(step, carry, snaps, carry.ids.device,
                 lambda ev: (ev.ev_count, ev.ev_ids, ev.ev_angles))


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
    metrics: Optional[dict] = None,
):
    """The sorted-carry step over a stacked snapshot sequence.

    ``carry`` is a :class:`~orbitanalysis_tpu_torch.ops.sorted_step.
    SortedCarry` (:func:`~orbitanalysis_tpu_torch.ops.sorted_step.
    init_sorted_carry`); ``snaps`` as for :func:`scan_events`.  With rows
    staged ID-sorted (:func:`~orbitanalysis_tpu_torch.ops.sorted_step.
    presort_snapshot`) pass ``cur_presorted=True``; with ``pos``/``vel``
    staged ``[S, 3, H, P]`` (``presort_snapshot(..., soa=True)``) pass
    ``soa_batch=True``.  The options are
    :func:`~orbitanalysis_tpu_torch.ops.sorted_step.make_sorted_orbit_step`'s.

    On the fused presorted path the static-membership test of every step
    is one reduction over ``[S]`` (:func:`~orbitanalysis_tpu_torch.ops.
    sorted_step.static_flags`), read on the host once a call, before the
    loop; each step is handed its flag, so no step reads the device.  On
    CUDA tensors the scan is then one replayed CUDA graph
    (:mod:`orbitanalysis_tpu_torch.utils.graphs`): a key's first call
    runs the loop, its second captures it, later calls replay.  The key
    holds the step builder, each staged tensor's address, shape, strides
    and dtype, the carry's shapes and dtypes, the capacity, mode, box,
    routes, ``soa_batch``, each step's drag and the flags.  Staged NumPy
    arrays are new tensors every call, so their calls run the loop.

    ``metrics`` (a dict) gathers the call's numbers, adding to what it
    holds: ``step_s`` (the span ``sorted.step``: each step's enqueue, or
    a replay's, its copies and any capture before it included), the
    counters ``sorted_steps``, ``sorted_updates`` (the staged members of
    every step after the call's first), ``sorted_events`` (counted past
    the capacity too), ``sorted_static_steps`` (the steps that took the
    static branch), ``sorted_graph_captures`` and
    ``sorted_graph_replays``, and on CUDA tensors ``sorted_device_s``
    (CUDA timing events around each step, or around the replay).  The
    counters are summed on the device and read, with the timing events,
    once at the end of the call.  Without it nothing is timed or counted.

    Returns ``(final_carry, (count [S, H], ids [S, H, K], angles
    [S, H, K]))``, the events in previous-snapshot load order.
    """
    from orbitanalysis_tpu_torch.ops.geometry import box_f32
    from orbitanalysis_tpu_torch.ops.sorted_step import (
        make_sorted_orbit_step,
        static_flags,
    )

    build = make_sorted_orbit_step
    step = build(
        event_capacity, mode=mode, box_size=box_size, id_dtype=id_dtype,
        merge_impl=merge_impl, compact_impl=compact_impl,
        cur_presorted=cur_presorted, fused=fused, soa_batch=soa_batch,
    )
    dev = carry.ids.device
    snaps = _with_drag_axis(snaps)
    fields = _on_device(snaps, dev)
    S = snaps.ids.shape[0]
    drags = tuple(float(d) for d in snaps.hubble_drag)
    static = (static_flags(carry.ids, fields["ids"])
              if fused and cur_presorted else (None,) * S)

    def batch(s):
        return SnapshotBatch(
            **{k: None if v is None else v[s] for k, v in fields.items()},
            hubble_drag=drags[s])

    def run(c, metrics=None, stamps=None):
        outs = []
        for s in range(S):
            with phase_timer(metrics, "sorted.step"):
                if stamps is not None:
                    stamps.append(graphs.stamp())
                c, ev = step(c, batch(s), static=static[s])
                if stamps is not None:
                    stamps[-1][1].record()
            outs.append((ev.count, ev.ids, ev.angles))
        return c, tuple(torch.stack(x) for x in zip(*outs))

    stamps = [] if metrics is not None and dev.type == "cuda" else None
    key = graphs.graph_key(
        build, carry, tuple(fields.values()), int(event_capacity), mode,
        None if box_size is None else box_f32(box_size),
        np.dtype(id_dtype), merge_impl, compact_impl, bool(cur_presorted),
        bool(fused), bool(soa_batch), drags, static)
    carry, out = graphs.scan(key, run, carry, "sorted", metrics, stamps)
    if metrics is not None:
        _count_sorted(metrics, fields["ids"], invalid_id_for(id_dtype),
                      out[0], static, stamps)
    return carry, out


def _count_sorted(metrics, ids, invalid, count, static, stamps):
    """Add a :func:`scan_events_sorted` call's counters and device
    stretches into ``metrics``: the counters summed on the device, one
    wait (on the last timing event, which completes every earlier one)
    and one read."""
    tally = torch.stack([(ids[1:] != invalid).sum(dtype=torch.int64),
                         count.sum(dtype=torch.int64)])
    if stamps:
        stamps[-1][1].synchronize()
    updates, n_events = tally.tolist()
    for key, v in (("sorted_steps", ids.shape[0]),
                   ("sorted_updates", updates), ("sorted_events", n_events),
                   ("sorted_static_steps", sum(map(bool, static)))):
        metrics[key] = metrics.get(key, 0) + v
    if stamps:
        metrics["sorted_device_s"] = metrics.get(
            "sorted_device_s", 0.0) + sum(
                a.elapsed_time(b) for a, b in stamps) * 1e-3


def scan_events_aligned(
    carry,
    snaps: SnapshotBatch,
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=np.int32,
    soa_batch: bool = False,
    batched: bool = False,
    rhat_packed: bool = False,
):
    """The aligned engine over a sequence staged by
    :func:`~orbitanalysis_tpu_torch.engine.packing.stage_batch_aligned`
    (element-wise aligned across the sequence, so churn needs no
    device-side join).  ``carry`` is an :class:`~orbitanalysis_tpu_torch.
    ops.sorted_step.AlignedCarry` (:func:`~orbitanalysis_tpu_torch.ops.
    sorted_step.init_aligned_carry`).  Events are positional: ``(count
    [S, H], positions [S, H, K], angles [S, H, K])``, the angles
    quantized to float16 (the savefile's dtype); callers map positions
    through their staged tables.

    ``batched=False`` runs :func:`~orbitanalysis_tpu_torch.ops.
    sorted_step.make_aligned_native_step` once a snapshot (its default
    route: one angle-word compaction a step).  ``batched=True`` uses
    that detection reads only adjacent snapshots' sign bits and the
    staged FRESH flags, never the angle recurrence: the region frames of
    all ``S*H`` rows in one pass, the sign flips batched over shifted
    snapshot slices, the angle accumulator alone as a loop over one
    ``[H, P]`` plane, then ONE payload compaction over all ``S*H`` rows
    (a position/angle pair compaction for rows wider than
    :data:`~orbitanalysis_tpu_torch.ops.compact.PAYLOAD_MAX_ROW`).  It
    materializes about eighteen ``[S, H, P]`` planes.
    """
    from orbitanalysis_tpu_torch.ops.sorted_step import (
        make_aligned_native_step,
    )

    if not batched:
        step = make_aligned_native_step(
            event_capacity, mode=mode, box_size=box_size, id_dtype=id_dtype,
            soa_batch=soa_batch, rhat_packed=rhat_packed)
        return _scan(step, carry, snaps, carry.key.device,
                     lambda ev: (ev.count, ev.ids, ev.angles))
    if rhat_packed:
        raise ValueError(
            "rhat_packed applies to the per-step scan (batched=False); "
            "the batched driver materializes rhat planes per snapshot "
            "anyway"
        )
    if mode not in ("pericentric", "apocentric"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    if snaps.slot is None:
        raise ValueError(
            "the aligned sequence driver needs stable-layout staging: "
            "snaps.slot (with FRESH flags in bit 27) is mandatory — "
            "stage via stage_batch_aligned"
        )
    id_dt = np.dtype(id_dtype)
    if id_dt.itemsize != 4 or not np.issubdtype(id_dt, np.signedinteger):
        raise ValueError(
            "the aligned sequence driver requires 32-bit signed particle "
            "IDs on device; stage wide IDs through the int32 position "
            "surrogate (pack_snapshot_aligned / the tracker's aligned "
            "engine does this automatically)"
        )
    final, count, words = _aligned_batch_words(
        carry, snaps, mode=mode, box_size=box_size, id_dtype=id_dtype,
        soa_batch=soa_batch)
    return final, _compact_batch(words, count, int(event_capacity),
                                 invalid_id_for(id_dtype))


def _aligned_batch_words(carry, snaps: SnapshotBatch, mode="pericentric",
                        box_size=None, id_dtype=np.int32,
                        soa_batch: bool = False):
    """Everything of ``scan_events_aligned(batched=True)`` before its one
    compaction (arguments as there, unchecked).  Returns ``(final_carry,
    count [S, H], words)``: ``words`` is the ``[S*H, P]`` payload plane
    ``((pos + 1) << 15) | f16(angle)`` at the events, zero elsewhere, or
    for rows wider than :data:`~orbitanalysis_tpu_torch.ops.compact.
    PAYLOAD_MAX_ROW` the pair ``(pos + 1 at the events, f16 angle
    bits)``."""
    from orbitanalysis_tpu_torch.ops.compact import PAYLOAD_MAX_ROW
    from orbitanalysis_tpu_torch.ops.geometry import region_frame
    from orbitanalysis_tpu_torch.ops.sorted_step import (
        _BIT31,
        AlignedCarry,
        _acos_f32,
        _invalid_key,
        _vr_bits,
    )
    from orbitanalysis_tpu_torch.utils.numerics import to_i32_bits

    dev = carry.key.device
    snaps = _with_drag_axis(snaps)
    invalid = invalid_id_for(id_dtype)
    f = _on_device(snaps, dev)
    ids, slot = f["ids"], f["slot"]
    S, H, P = ids.shape
    valid = ids != invalid
    if soa_batch:
        pos = f["pos"].movedim(1, 0).reshape(3, S * H, P)
        vel = f["vel"].movedim(1, 0).reshape(3, S * H, P)
    else:
        pos = f["pos"].reshape(S * H, P, 3)
        vel = f["vel"].reshape(S * H, P, 3)
    drag = np.repeat(np.asarray(snaps.hubble_drag, np.float32), H)[:, None]
    frame = region_frame(
        pos, vel, valid.reshape(S * H, P), f["center"].reshape(S * H, 3),
        mass=None if f["mass"] is None else f["mass"].reshape(S * H, P),
        bulk_vel=(None if f["bulk_vel"] is None
                  else f["bulk_vel"].reshape(S * H, 3)),
        box_size=box_size, hubble_drag=torch.from_numpy(drag).to(dev),
        soa=soa_batch)
    del pos, vel
    rhat = frame.rhat.reshape(3, S, H, P)
    vrb = _vr_bits(frame.vrad.reshape(S, H, P))
    fresh = (slot & (1 << 27)) != 0
    live = valid & ~fresh

    # prev-side quantities from shifted snapshot slices (the carry for
    # snapshot 0)
    cos0 = (carry.rhat[0] * rhat[0, 0] + carry.rhat[1] * rhat[1, 0]
            + carry.rhat[2] * rhat[2, 0])
    cos_rest = (rhat[0, :-1] * rhat[0, 1:] + rhat[1, :-1] * rhat[1, 1:]
                + rhat[2, :-1] * rhat[2, 1:])
    cosang = torch.clamp(torch.cat([cos0[None], cos_rest]), -1.0, 1.0)
    del cos_rest
    dtheta = torch.where(live, _acos_f32(cosang), torch.zeros_like(cosang))
    del cosang
    prev_vrb = torch.cat([((carry.sv >> 24) & 3)[None], vrb[:-1]])
    if mode == "pericentric":
        flip = ((prev_vrb & 1) > 0) & ((vrb & 2) > 0)
    else:
        flip = ((prev_vrb & 2) > 0) & ((vrb & 1) > 0)
    apsis = live & flip
    del prev_vrb, flip
    count = apsis.sum(dim=-1, dtype=torch.int32)

    # the one time dependency: the angle accumulator, one [H, P] plane
    ang = (carry.packed & 0x7FFFFFFF).view(torch.float32)
    ev_ang = torch.empty_like(dtheta)
    zero = torch.zeros_like(ang)
    for s in range(S):
        acc = torch.where(fresh[s], zero, ang + dtheta[s])
        ev_ang[s] = torch.where(apsis[s], acc, zero)
        ang = torch.where(apsis[s] | ~valid[s], zero, acc)
    del dtheta

    pos_iota = torch.arange(P, dtype=torch.int32, device=dev)
    final = AlignedCarry(
        key=torch.where(valid[-1], (pos_iota << 1) | 1,
                        torch.full_like(ids[-1], _invalid_key(invalid))),
        sv=slot[-1] | (vrb[-1] << 24),
        rhat=rhat[:, -1].contiguous(),
        packed=ang.view(torch.int32) | torch.where(
            live[-1], _BIT31, 0).to(torch.int32),
    )
    # a payload word an event (position + f16 angle), or a position/angle
    # pair for rows past the word's 17 position bits
    ang15 = ev_ang.to(torch.float16).view(torch.int16).to(torch.int32) & 0xFFFF
    del ev_ang
    if P <= PAYLOAD_MAX_ROW:
        word = to_i32_bits((pos_iota.long() + 1) << 15) | ang15
        words = torch.where(apsis, word, torch.zeros_like(word))
        return final, count, words.reshape(S * H, P)
    posw = torch.where(apsis, pos_iota + 1, torch.zeros_like(ang15))
    return final, count, (posw.reshape(S * H, P), ang15.reshape(S * H, P))


def _compact_batch(words, count, K, invalid):
    """One compaction over all ``S*H`` rows of :func:`_aligned_batch_words`'s
    ``words``: ``(count [S, H], positions [S, H, K], angles [S, H, K])``."""
    from orbitanalysis_tpu_torch.ops.compact import (
        compact_payload_blocked,
        compact_payload_pair,
    )

    S, H = count.shape
    if isinstance(words, tuple):
        k_eff = min(K, words[0].shape[1])
        evposw, ev_ang_bits = compact_payload_pair(*words, k_eff)
        ev_pos = evposw - 1
    else:
        k_eff = min(K, words.shape[1])
        evpay = compact_payload_blocked(words, k_eff)
        ev_pos = ((evpay >> 15) & 0x1FFFF) - 1
        ev_ang_bits = evpay & 0x7FFF
    evang = (ev_ang_bits & 0xFFFF).to(torch.int16).view(
        torch.float16).to(torch.float32)
    kiota = torch.arange(ev_pos.shape[1], device=ev_pos.device)
    ev_ok = kiota[None, :] < count.reshape(S * H)[:, None]
    ev_ids = torch.where(ev_ok, ev_pos, torch.full_like(ev_pos, invalid))
    ev_angles = torch.where(ev_ok, evang, torch.zeros_like(evang))
    kw = min(ev_ids.shape[1], K)
    return (count, ev_ids[:, :K].reshape(S, H, kw),
            ev_angles[:, :K].reshape(S, H, kw))


def scan_counts(
    carry: CountingCarry,
    snaps: SnapshotBatch,
    mode: str = "pericentric",
    box_size=None,
    angle_cut: float = 0.0,
    id_dtype=np.int32,
):
    """Keep cumulative per-particle apsis counts on the device.

    The counts follow each particle through the step's cur->prev slot
    map (entrants restart at 0, the reference's region-entry semantics);
    ``angle_cut`` drops apsides whose accumulated angle is not above it,
    as the collation's filter of passages inside a subhalo does.
    Returns ``(final CountingCarry, total counted apsides a step [S])``.
    """
    step = make_orbit_step(mode=mode, box_size=box_size, id_dtype=id_dtype,
                           with_prev_slot=True)
    cut = float(np.float32(angle_cut))

    def count_step(c: CountingCarry, s):
        track, ev = step(c.track, s)
        hit = ev.apsis & (ev.apsis_angle > cut)
        counts = gather_rows(c.counts + hit.to(c.counts.dtype),
                             ev.prev_slot, fill=0)
        return CountingCarry(track=track, counts=counts), hit.sum(
            dtype=torch.int32)

    carry, (totals,) = _scan(count_step, carry, snaps,
                             carry.track.ids.device, lambda total: (total,))
    return carry, totals


__all__ = [
    "CountingCarry",
    "scan_counts",
    "scan_events",
    "scan_events_aligned",
    "scan_events_compact",
    "scan_events_sorted",
    "stack_batches",
]
