"""Label-native orbit detection over a position-stable particle pool
(twin of ``orbitanalysis_tpu/ops/label_step.py``).

Device-resident pipelines hold their particles in one global array
whose positions never change: position i is particle i for the whole
run.  That array is a stable layout by construction, so membership churn
against halo regions is a per-particle halo *label* change and the
reference's detection (``track_orbits.py:293-351``: entered/departed
handling, radial-velocity sign flips, angle accumulate/reset) is
elementwise over the pool, with no join and no host staging.  The only
passes that are not elementwise are the per-halo bulk-velocity moments
and the per-particle halo frame rows (``table[label]``).

State is held as ``[R, row_width]`` row planes (particle ``i`` at row
``i // row_width``, lane ``i % row_width``), which are also the rows of
the positional event compaction: events come back as global pool
indices ``row * row_width + position``.

Routes (``frames``), as the JAX package picks them; each launches a
hand-written CUDA kernel wherever the JAX package reaches a Pallas
kernel, and runs plain torch wherever it ran XLA:

- ``'split'`` (what ``'auto'`` picks below 256 halos): moments
  :func:`~orbitanalysis_tpu_torch.ops.frames.segment_moments` (K7), frame
  rows :func:`~orbitanalysis_tpu_torch.ops.frames.frame_rows` (K6), then
  the detect-and-compact pass
  :func:`~orbitanalysis_tpu_torch.ops.label.detect_label_compact` (K8)
  when the JAX package's ``blocked_ok`` holds, otherwise
  :func:`~orbitanalysis_tpu_torch.ops.label.detect_label` (K9) and
  :func:`~orbitanalysis_tpu_torch.ops.compact.compact_payload` (K4);
- ``'pallas2'``: K7, K6, the plain detect chain, then the payload
  compaction (K5, the same kernel as K4);
- ``'fused'``: K7, then the fused detect pass
  :func:`~orbitanalysis_tpu_torch.ops.label.fused_label_detect` (K10:
  the frame rows, K6's gather, taken from the table inside K9's pass),
  then the payload compaction (K5);
- ``'pallas'``: moments (K12) and frame rows (K11) over the flat ``[N]``
  labels, the plain detect chain, then the payload compaction (K5); on
  the card K11 and K12 are the kernels of K6 and K7;
- ``'matmul'``, ``'soa'``, ``'twolevel'`` (what ``'auto'`` picks at 256
  halos or more), ``'select'`` and the ``*_bf16x3`` forms: plain moments,
  plain gather and the plain detect chain, then the payload compaction
  (K5).  These forms compute the same gather and the same sums: their
  one-hot and two-level matmuls were the TPU's way to gather.

On CPU tensors every kernel's plain version runs instead.

While a ``torch.profiler`` records, a step opens the ranges
``oa.label.moments`` (K7, or the plain moments), ``oa.label.frames``
(K6, or its plain gather), ``oa.label.detect`` (K8, K9 + K4, K10 + K5,
or the plain chain and K5) and ``oa.label.finish``;
:func:`scan_label_events` adds ``oa.label.step`` around each step and
takes a ``metrics`` dict for its spans, counters and device time.

On CUDA tensors :func:`scan_label_events` replays a CUDA graph of the
whole ``S``-step loop (:mod:`orbitanalysis_tpu_torch.utils.graphs`, the
port's one graph helper, which the sorted scan uses too): no route's
step reads anything back to the host, so the loop captures as it runs.
Its key holds the step builder, each sequence tensor's address, shape,
strides and dtype, the carry's shapes and dtypes, and the arguments a
capture bakes in, the per-step drags among them.  A key's first call
runs the loop, its second captures and replays, later calls replay; CPU
tensors always run the loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops.compact import (
    compact_payload,
    compact_payload_blocked,
)
from orbitanalysis_tpu_torch.ops.frames import (
    frame_rows,
    frame_rows_torch,
    segment_moments,
    segment_moments_torch,
)
from orbitanalysis_tpu_torch.ops.label import (
    detect_label,
    detect_label_compact,
    detect_label_torch,
    fused_label_detect,
)
from orbitanalysis_tpu_torch.utils import graphs
from orbitanalysis_tpu_torch.utils.device import resolve_device
from orbitanalysis_tpu_torch.utils.metrics import phase_timer
from orbitanalysis_tpu_torch.utils.numerics import div_rn

__all__ = [
    "LabelCarry",
    "LabelEvents",
    "assign_regions",
    "init_label_carry",
    "label_carry_from_numpy",
    "label_carry_to_numpy",
    "make_label_orbit_step",
    "scan_label_events",
]

#: Per-128-lane-block event capacity of the JAX package's blocked
#: compaction (``pallas_compact.BLOCK_CAP``): it decides, as there,
#: whether ``'split'`` takes the detect-and-compact pass.
BLOCK_CAP = 16
#: Halo count from which ``frames='auto'`` takes the two-level form.
TWOLEVEL_MIN_H = 256

_FRAMES = ("auto", "matmul", "matmul_bf16x3", "soa", "soa_bf16x3",
           "twolevel", "select", "pallas", "pallas2", "fused", "split")


class LabelCarry(NamedTuple):
    """Per-particle detector state as ``[R, W]`` row planes.

    ``lab_sv``: previous halo label + 1 in bits 0-27 (0 = untracked)
    with the radial-velocity sign bits in bits 28-29 (bit 28 inward,
    bit 29 outward); ``rhat``: ``[3, R, W]`` f32 radial unit vectors, or
    ``[R, W]`` int32 octahedral words (uint32 bits) when packed;
    ``packed``: f32 angle accumulator in bits 0-30, matched flag in
    bit 31 (int32 holding the uint32 bits).
    """

    lab_sv: torch.Tensor  # [R, W] int32
    rhat: torch.Tensor    # [3, R, W] f32, or [R, W] int32 oct-packed
    packed: torch.Tensor  # [R, W] int32 (uint32 bits)


class LabelEvents(NamedTuple):
    """Positional events per compaction row: ``count[r]`` events in row
    ``r`` (exact, may exceed K), front-packed global pool indices and
    f16-exact angles; entries past the count are -1 / 0."""

    count: torch.Tensor     # [R] int32
    index: torch.Tensor     # [R, K] int32 global pool index (-1 invalid)
    angle: torch.Tensor     # [R, K] float32 (f16-exact)
    bulk_vel: torch.Tensor  # [H, 3] the frame bulk velocities used


def _rows_of(n: int, row_width: int):
    w = min(int(row_width), n)
    if w <= 0 or n % w:
        raise ValueError(
            f"pool size {n} must be a multiple of row_width {w}")
    return n // w, w


def init_label_carry(n: int, rhat_packed: bool = False,
                     row_width: int = 1 << 15,
                     device="cuda") -> LabelCarry:
    """All-untracked carry over ``R = n // row_width`` row planes on
    ``device`` (CUDA by default; RuntimeError without it).
    ``rhat_packed=True`` stores the radial unit vectors octahedral-packed
    (4 instead of 12 bytes a particle); counts are unaffected, angles
    move by the ~1e-4 rad quantization per step."""
    device = resolve_device(device, "init_label_carry")
    r, w = _rows_of(n, row_width)
    i32 = dict(dtype=torch.int32, device=device)
    return LabelCarry(
        lab_sv=torch.zeros((r, w), **i32),
        rhat=(torch.zeros((r, w), **i32) if rhat_packed
              else torch.zeros((3, r, w), dtype=torch.float32,
                               device=device)),
        packed=torch.zeros((r, w), **i32),
    )


def label_carry_from_numpy(lab_sv, rhat, packed,
                           device="cuda") -> LabelCarry:
    """A :class:`LabelCarry` on ``device`` (CUDA by default) from the JAX
    carry's fields as host arrays (``lab_sv`` int32, ``rhat`` f32
    ``[3, R, W]`` or uint32 ``[R, W]``, ``packed`` uint32);
    bit-preserving."""
    device = resolve_device(device, "label_carry_from_numpy")

    def t(a, dt):
        return torch.from_numpy(np.array(a).view(dt)).to(device)

    rhat = np.asarray(rhat)
    return LabelCarry(
        lab_sv=t(lab_sv, np.int32),
        rhat=t(rhat, np.float32 if rhat.dtype == np.float32 else np.int32),
        packed=t(packed, np.int32),
    )


def label_carry_to_numpy(carry: LabelCarry) -> LabelCarry:
    """The carry's fields as host arrays in the JAX carry's dtypes
    (``packed`` and a packed ``rhat`` uint32); bit-preserving."""
    rhat = carry.rhat.cpu().numpy()
    return LabelCarry(
        lab_sv=carry.lab_sv.cpu().numpy(),
        rhat=rhat.view(np.uint32) if rhat.dtype == np.int32 else rhat,
        packed=carry.packed.cpu().numpy().view(np.uint32),
    )


def assign_regions(pos, centers, radii, box_size=None,
                   soa: bool = False) -> torch.Tensor:
    """Halo label per particle: index of the nearest centre whose region
    (periodic-wrapped distance < radius) holds it, else -1 — the
    reference's brute-force radius test per halo resolved to one owner,
    streamed over the halo axis.  ``pos`` ``[N, 3]`` (``[3, N]`` with
    ``soa``) tensor; ``centers`` ``[H, 3]`` and ``radii`` ``[H]``."""
    pos = torch.as_tensor(pos)
    x = pos if soa else torch.movedim(pos, -1, 0)          # [3, N]
    dev = x.device
    n = x.shape[1]
    centers = torch.as_tensor(centers, dtype=torch.float32, device=dev)
    radii = torch.as_tensor(radii, dtype=torch.float32, device=dev)
    best_d2 = torch.full((n,), float("inf"), device=dev)
    label = torch.full((n,), -1, dtype=torch.int32, device=dev)
    box = (None if box_size is None
           else torch.full((), float(np.float32(box_size)), device=dev))
    for h in range(centers.shape[0]):
        d = x - centers[h][:, None]
        if box is not None:
            d = d - box * torch.round(div_rn(d, box.expand_as(d)))
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        hit = (d2 < radii[h] * radii[h]) & (d2 < best_d2)
        best_d2 = torch.where(hit, d2, best_d2)
        label = torch.where(hit, torch.full_like(label, h), label)
    return label


def _resolve_frames(frames: str, n_halos: int) -> str:
    if frames != "auto":
        return frames
    return "twolevel" if n_halos >= TWOLEVEL_MIN_H else "split"


def make_label_orbit_step(
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    n_halos: Optional[int] = None,
    chunk=None,
    row_width: int = 1 << 15,
    frames: str = "auto",
    rhat_packed: bool = False,
):
    """The churn-proof detector over a position-stable pool:
    ``step(carry, inputs) -> (carry, LabelEvents)`` with ``inputs =
    (pos [3, N] or [3, R, W], vel likewise, label [N] or [R, W],
    centers [H, 3], bulk_vel [H, 3] or None, mass [N] / [R, W] or None,
    hubble_drag scalar)``.  Apsides are the reference's (a sign flip
    between consecutive steps while the particle stays in the same
    halo's region; a label change restarts its state).

    ``event_capacity`` is per compaction row of ``row_width`` entries;
    ``frames`` picks the route (module docstring).  ``chunk`` (in the
    JAX signature, the one-hot chunking of its matmul forms) is accepted
    in its place and changes nothing.
    """
    if frames not in _FRAMES:
        raise ValueError(f"unknown frames impl {frames!r}")
    if mode not in ("pericentric", "apocentric"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    pericentric = mode == "pericentric"
    K = int(event_capacity)
    if row_width > (1 << 17) - 128:
        raise ValueError("row_width exceeds the positional payload budget")

    def step(carry: LabelCarry, inputs):
        pos, vel, label, centers, bulk_vel, mass, hubble_drag = inputs
        if label.dim() == 1:
            r_, w_ = _rows_of(label.shape[0], row_width)
            label = label.reshape(r_, w_)
            pos = pos.reshape(3, r_, w_)
            vel = vel.reshape(3, r_, w_)
            if mass is not None:
                mass = mass.reshape(r_, w_)
        R, W = label.shape
        dev = label.device
        h = centers.shape[0] if n_halos is None else int(n_halos)
        lab_m = torch.where(label >= 0, label,
                            torch.full((), -1, dtype=label.dtype,
                                       device=dev)).to(torch.int32)
        impl = _resolve_frames(frames, h)
        kernels = impl in ("split", "pallas2", "fused", "pallas")

        if bulk_vel is None:
            with phase_timer(None, "label.moments"):
                moments = (segment_moments if kernels
                           else segment_moments_torch)
                mom = moments(lab_m, vel, mass, n_halos=h)
                bulk = div_rn(mom[:, :3],
                              torch.clamp(mom[:, 3:4], min=1e-30))
        else:
            bulk = torch.as_tensor(bulk_vel, dtype=torch.float32, device=dev)
        table = torch.cat([torch.as_tensor(centers, dtype=torch.float32,
                                           device=dev), bulk], dim=-1)
        k_eff = min(K, W)
        detect_kw = dict(pericentric=pericentric, box_size=box_size,
                         rhat_packed=rhat_packed)
        carry_in = (carry.lab_sv, carry.rhat, carry.packed, hubble_drag)
        if impl == "fused":
            with phase_timer(None, "label.detect"):
                sv_n, rh_n, pk_n, payload, count = fused_label_detect(
                    table, lab_m, pos, vel, *carry_in, **detect_kw)
                evpay = compact_payload_blocked(payload, k_eff)
            with phase_timer(None, "label.finish"):
                return _finish(sv_n, rh_n, pk_n, evpay, count, bulk, K)
        with phase_timer(None, "label.frames"):
            rows = (frame_rows if kernels else frame_rows_torch)(
                table, lab_m).reshape(6, R, W)
        planes = (rows, lab_m, pos, vel, *carry_in)
        with phase_timer(None, "label.detect"):
            if impl == "split":
                rpb = W // 128
                k128 = min(((k_eff + 127) // 128) * 128, W)
                blocked_ok = (W > 128 and (rpb * BLOCK_CAP) % 128 == 0
                              and k128 <= rpb * BLOCK_CAP)
                if blocked_ok:
                    sv_n, rh_n, pk_n, evpay, count = detect_label_compact(
                        *planes, event_capacity=k_eff, **detect_kw)
                else:
                    sv_n, rh_n, pk_n, payload, count = detect_label(
                        *planes, **detect_kw)
                    evpay = compact_payload(payload, k_eff)
            else:
                sv_n, rh_n, pk_n, payload, count = detect_label_torch(
                    *planes, **detect_kw)
                evpay = compact_payload_blocked(payload, k_eff)
        with phase_timer(None, "label.finish"):
            return _finish(sv_n, rh_n, pk_n, evpay, count, bulk, K)

    return step


def _finish(sv_n, rh_n, pk_n, evpay, count, bulk, K):
    """The step's outputs from the new carry planes and the compacted
    ``[R, k128]`` payload words: global pool indices and f16 angles,
    ``-1`` / 0 past each row's count."""
    R, W = sv_n.shape
    dev = sv_n.device
    ev_pos = ((evpay >> 15) & 0x1FFFF) - 1
    ev_ang = (evpay & 0x7FFF).to(torch.int16).view(torch.float16).to(
        torch.float32)
    kiota = torch.arange(ev_pos.shape[1], device=dev)
    ev_ok = kiota[None, :] < count[:, None]
    row0 = torch.arange(R, dtype=torch.int32, device=dev)[:, None] * W
    return LabelCarry(lab_sv=sv_n, rhat=rh_n, packed=pk_n), LabelEvents(
        count=count,
        index=torch.where(ev_ok, ev_pos + row0,
                          torch.full((), -1, dtype=torch.int32,
                                     device=dev))[:, :K],
        angle=torch.where(ev_ok, ev_ang,
                          torch.zeros((), device=dev))[:, :K],
        bulk_vel=bulk,
    )


def scan_label_events(carry, pos_seq, vel_seq, label_seq, centers_seq,
                      event_capacity: int, mode: str = "pericentric",
                      box_size=None, mass=None, bulk_vel_seq=None,
                      hubble_drag=0.0, row_width: int = 1 << 15,
                      frames: str = "auto", rhat_packed: bool = False,
                      metrics: Optional[dict] = None):
    """:func:`make_label_orbit_step` over an ``[S]``-stacked sequence
    (``pos_seq``/``vel_seq`` ``[S, 3, N]``, ``label_seq`` ``[S, N]``,
    ``centers_seq`` ``[S, H, 3]``; or ``[S, 3, R, W]`` and ``[S, R, W]``
    row planes; tensors or arrays, moved to the carry's device), as a
    Python loop, or on CUDA tensors the replay of its CUDA graph (module
    docstring).  Returns ``(carry, LabelEvents stacked [S, ...])``.
    ``hubble_drag`` is a scalar or one value per step.

    ``mass`` is one plane for every step (``[N]`` or ``[R, W]``) or one
    plane a step (``[S, N]`` or ``[S, R, W]``, as a tracked sequence
    carries them): a mass with more elements than a step's labels is
    taken a plane a step, step ``s`` weighting its moments by
    ``mass[s]``.

    ``metrics`` (a dict, as :func:`~orbitanalysis_tpu_torch.utils.
    metrics.phase_timer` takes) gathers the call's numbers, adding to
    what it holds: ``step_s`` (the span ``label.step``: each step's host
    enqueue, or a replay's whole enqueue, its copies and any capture
    before it included), the counters ``label_steps``, ``label_updates``
    (the members, ``label >= 0``, of every step after the call's first,
    which from a fresh carry only seeds it) and ``label_events`` (every
    step's events, counted past the capacity too) and, on CUDA tensors,
    ``label_device_s``
    (each step's stretch of the device stream between CUDA timing
    events, or the replay's), ``label_graph_captures`` (1 where the call
    captured its graph) and ``label_graph_replays`` (1 where it replayed
    a graph an earlier call captured).  The counters are summed on the
    device and read, with the timing events, once at the end of the
    call.  Without it no timing event is recorded, nothing is counted
    and nothing waits for the device.
    """
    build = make_label_orbit_step
    step = build(
        event_capacity, mode=mode, box_size=box_size, row_width=row_width,
        frames=frames, rhat_packed=rhat_packed,
    )
    dev = carry.lab_sv.device

    def dev_t(x, dtype):
        return None if x is None else torch.as_tensor(x, dtype=dtype,
                                                      device=dev)

    label_seq = dev_t(label_seq, torch.int32)
    pos_seq = dev_t(pos_seq, torch.float32)
    vel_seq = dev_t(vel_seq, torch.float32)
    centers_seq = dev_t(centers_seq, torch.float32)
    mass = dev_t(mass, torch.float32)
    bulk_vel_seq = dev_t(bulk_vel_seq, torch.float32)
    S = label_seq.shape[0]
    if label_seq.dim() == 2:
        r_, w_ = _rows_of(label_seq.shape[1], row_width)
        label_seq = label_seq.reshape(S, r_, w_)
        pos_seq = pos_seq.reshape(S, 3, r_, w_)
        vel_seq = vel_seq.reshape(S, 3, r_, w_)
    R, W = label_seq.shape[1:]
    per_step = mass is not None and mass.numel() != R * W
    if mass is not None:
        mass = mass.reshape((S, R, W) if per_step else (R, W))
    drag = np.broadcast_to(np.asarray(hubble_drag, np.float32), (S,))

    def inputs(s):
        return (pos_seq[s], vel_seq[s], label_seq[s], centers_seq[s],
                None if bulk_vel_seq is None else bulk_vel_seq[s],
                mass[s] if per_step else mass, float(drag[s]))

    def run(c, metrics=None, stamps=None):
        return _scan_steps(step, c, map(inputs, range(S)), metrics, stamps)

    clock = metrics is not None and dev.type == "cuda"
    stamps = [] if clock else None
    key = graphs.graph_key(
        build, carry, (pos_seq, vel_seq, label_seq, centers_seq, mass,
                       bulk_vel_seq),
        int(event_capacity), mode,
        None if box_size is None else float(box_size), int(row_width),
        _resolve_frames(frames, centers_seq.shape[1]), bool(rhat_packed),
        tuple(drag.tolist()))
    carry, out = graphs.scan(key, run, carry, "label", metrics, stamps)
    if metrics is not None:
        _count_scan(metrics, label_seq, out.count, stamps)
    return carry, out


def _scan_steps(step, carry, inputs, metrics=None, stamps=None):
    """The scan's loop: ``step`` over ``inputs``, each step in the span
    ``label.step`` (into ``metrics``) and, given ``stamps`` (a list), in
    a pair of CUDA timing events appended to it.  Returns ``(carry,
    LabelEvents stacked [S, ...])``."""
    events = []
    for x in inputs:
        with phase_timer(metrics, "label.step"):
            if stamps is not None:
                stamps.append(graphs.stamp())
            carry, ev = step(carry, x)
            if stamps is not None:
                stamps[-1][1].record()
        events.append(ev)
    return carry, LabelEvents(*(torch.stack(f) for f in zip(*events)))


def _count_scan(metrics, label_seq, count, stamps):
    """Add a :func:`scan_label_events` call's counters and device
    stretches into ``metrics``: the counters summed on the device, one
    wait (on the last timing event, which completes every earlier one)
    and one read."""
    tally = torch.stack([(label_seq[1:] >= 0).sum(dtype=torch.int64),
                         count.sum(dtype=torch.int64)])
    if stamps:
        stamps[-1][1].synchronize()
    updates, n_events = tally.tolist()
    for key, v in (("label_steps", label_seq.shape[0]),
                   ("label_updates", updates), ("label_events", n_events)):
        metrics[key] = metrics.get(key, 0) + v
    if stamps:
        metrics["label_device_s"] = metrics.get("label_device_s", 0.0) + sum(
            a.elapsed_time(b) for a, b in stamps) * 1e-3
