"""The general per-snapshot orbit step (twin of
``orbitanalysis_tpu/ops/apsis.py:141`` ``make_orbit_step``).

One eager function runs, for all halos at once on the padded
``[n_halos, capacity]`` state:

  periodic recenter -> bulk velocity -> radial velocity
  -> sort-merge ID join -> sign-flip apsis flag -> angle accumulate/reset

The carried per-particle state (the reference's ``*_prev`` arrays)
stays on the device between steps; the host receives compact event
tensors.  This engine has no hand-written kernel: it is what
``join_impl='auto'`` picks off the GPU, and what capacity growth hands
the aligned engine's carry to.

Semantics (identical to the reference):

- pericenter: ``v_r(prev) < 0 and v_r(now) > 0``; apocenter the reverse
  — only for ID-matched particles;
- the angular advance is ``arccos(rhat_prev . rhat_now)``, accumulated
  since the last apsis or region entry, recorded at an apsis and reset;
- entrants (and halos without a progenitor) start from angle 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops.geometry import region_frame
from orbitanalysis_tpu_torch.ops.join import merge_join
from orbitanalysis_tpu_torch.utils.device import resolve_device
from orbitanalysis_tpu_torch.utils.numerics import torch_dtype
from orbitanalysis_tpu_torch.utils.padding import invalid_id_for


class Carry(NamedTuple):
    """Per-particle state carried across snapshots."""

    ids: torch.Tensor     # [H, P] particle IDs, load order, sentinel-padded
    rhat: torch.Tensor    # [3, H, P] radial unit vectors (SoA layout)
    vrad: torch.Tensor    # [H, P]
    angles: torch.Tensor  # [H, P] cumulative angle since last apsis/entry


class SnapshotBatch(NamedTuple):
    """One snapshot's padded device input."""

    ids: torch.Tensor                        # [H, P]
    pos: torch.Tensor                        # [H, P, 3]
    vel: torch.Tensor                        # [H, P, 3]
    center: torch.Tensor                     # [H, 3]
    mass: Optional[torch.Tensor] = None      # [H, P] (None = equal masses)
    bulk_vel: Optional[torch.Tensor] = None  # [H, 3] catalog bulk velocities
    hubble_drag: float = 0.0                 # H(z)/(1+z); 0 = off
    # aligned staging: load-order slot per position, FRESH flag in bit 27
    slot: Optional[torch.Tensor] = None      # [H, P] int32


class StepEvents(NamedTuple):
    """Per-step outputs; prev-layout tensors follow the previous
    snapshot's slot order (the reference's within-halo output order)."""

    apsis: torch.Tensor         # [H, P] bool, prev layout
    apsis_angle: torch.Tensor   # [H, P], prev layout: angle at the apsis
    dtheta: torch.Tensor | None  # [H, P], prev layout (static step,
    #                              general step with with_dtheta)
    matched_prev: torch.Tensor  # [H, P] bool, prev layout
    departed: torch.Tensor      # [H, P] bool, prev layout
    entered: torch.Tensor       # [H, P] bool, cur layout
    radius: torch.Tensor        # [H, P], cur layout
    bulk_vel: torch.Tensor      # [H, 3]
    prev_slot: torch.Tensor | None  # [H, P] int32 cur->prev slot map, -1 = none
    # event compaction (None unless event_capacity was set): events at
    # the front of each row in slot order
    ev_count: torch.Tensor | None = None   # [H] int32 apsides per halo
    ev_ids: torch.Tensor | None = None     # [H, K] event particle IDs
    ev_angles: torch.Tensor | None = None  # [H, K] angle at each apsis


def init_carry(n_halos: int, capacity: int, id_dtype=np.int32,
               angle_dtype=np.float32, pos_dtype=np.float32,
               device="cuda") -> Carry:
    """All-invalid carry: every halo behaves as 'no progenitor yet'.
    ``device`` defaults to CUDA (RuntimeError without it)."""
    device = resolve_device(device, "init_carry")
    shape = (n_halos, capacity)
    pdt = torch_dtype(pos_dtype)
    return Carry(
        ids=torch.full(shape, invalid_id_for(id_dtype),
                       dtype=torch_dtype(id_dtype), device=device),
        rhat=torch.zeros((3,) + shape, dtype=pdt, device=device),
        vrad=torch.zeros(shape, dtype=pdt, device=device),
        angles=torch.zeros(shape, dtype=torch_dtype(angle_dtype),
                           device=device),
    )


def carry_from_numpy(ids, rhat, vrad, angles, device="cuda") -> Carry:
    """A :class:`Carry` on ``device`` (CUDA by default) from host arrays
    holding the JAX carry's fields (bit-preserving copies)."""
    device = resolve_device(device, "carry_from_numpy")
    return Carry(*(torch.from_numpy(np.array(a)).to(device)
                   for a in (ids, rhat, vrad, angles)))


def carry_to_numpy(carry: Carry) -> Carry:
    """The carry's fields as host NumPy arrays (bit-preserving)."""
    return Carry(*(t.cpu().numpy() for t in carry))


def _vr_bits(vr: torch.Tensor) -> torch.Tensor:
    """Radial-velocity sign as 2 bits: bit0 ``v_r < 0``, bit1 ``v_r > 0``."""
    return (vr < 0).to(torch.uint8) | ((vr > 0).to(torch.uint8) << 1)


def _compact_events(apsis, ids, apsis_angle, event_capacity):
    """Events to the row front in slot order: ``(count, ids[:, :K],
    angles[:, :K])`` (all None without ``event_capacity``)."""
    if event_capacity is None:
        return None, None, None
    cap = apsis.shape[-1]
    slot = torch.arange(cap, device=apsis.device).expand_as(apsis)
    order = torch.argsort(torch.where(apsis, slot, slot + cap), dim=-1)
    count = apsis.sum(dim=-1, dtype=torch.int32)
    return (
        count,
        torch.gather(ids, 1, order)[:, :event_capacity],
        torch.gather(apsis_angle, 1, order)[:, :event_capacity],
    )


def _check_mode(mode):
    if mode not in ("pericentric", "apocentric"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    return mode == "pericentric"


def make_orbit_step(
    mode: str = "pericentric",
    box_size=None,
    id_dtype=np.int32,
    angle_dtype=np.float32,
    with_prev_slot: bool = False,
    with_dtheta: bool = False,
    event_capacity: int | None = None,
):
    """The general step for a fixed configuration:
    ``step(carry, snap) -> (carry, StepEvents)``.

    ``with_prev_slot=True`` also returns the cur->prev slot map in
    ``StepEvents.prev_slot`` (-1 for entrants and padding), which the
    count accumulator of :func:`~orbitanalysis_tpu_torch.engine.scan.
    scan_counts` re-indexes its counts through; otherwise it is None.
    ``event_capacity=K`` compacts the events to the front of each row
    (slot order kept) so hosts fetch ``[H, K]`` lists plus counts;
    ``ev_count > K`` flags a row whose list was cut.
    ``with_dtheta=True`` also returns each matched pair's angle change in
    prev layout (``StepEvents.dtheta``, zero elsewhere), which the
    on-the-fly file writer stores; otherwise it is None.
    """
    pericentric = _check_mode(mode)
    invalid = invalid_id_for(id_dtype)
    adt = torch_dtype(angle_dtype)

    def step(carry: Carry, snap: SnapshotBatch):
        valid_cur = snap.ids != invalid
        valid_prev = carry.ids != invalid
        frame = region_frame(
            snap.pos, snap.vel, valid_cur, snap.center, mass=snap.mass,
            bulk_vel=snap.bulk_vel, box_size=box_size,
            hubble_drag=snap.hubble_drag,
        )

        def compute(left_vals, this_vals, matched):
            vrb0, rx0, ry0, rz0, ang0 = left_vals
            vrb1, rx1, ry1, rz1, _ = this_vals
            cosang = torch.clamp(rx0 * rx1 + ry0 * ry1 + rz0 * rz1,
                                 -1.0, 1.0)
            dtheta = torch.where(matched, torch.acos(cosang),
                                 torch.zeros_like(cosang))
            if pericentric:
                flip = ((vrb0 & 1) > 0) & ((vrb1 & 2) > 0)
            else:
                flip = ((vrb0 & 2) > 0) & ((vrb1 & 1) > 0)
            apsis = matched & flip
            angle_acc = ang0 + dtheta.to(adt)
            zero = torch.zeros_like(angle_acc)
            out = (
                (apsis, None),
                (torch.where(apsis, angle_acc, zero),
                 torch.where(apsis, zero, angle_acc)),
            )
            return out + ((dtheta, None),) if with_dtheta else out

        mj = merge_join(
            carry.ids, snap.ids, invalid,
            values=(
                (_vr_bits(carry.vrad), _vr_bits(frame.vrad)),
                (carry.rhat[0], frame.rhat[0]),
                (carry.rhat[1], frame.rhat[1]),
                (carry.rhat[2], frame.rhat[2]),
                (carry.angles, None),
            ),
            compute=compute,
            with_prev_slot=with_prev_slot,
        )
        apsis = mj.to_prev[0]
        apsis_angle, angles_new = mj.to_prev[1], mj.to_cur[1]
        ev_count, ev_ids, ev_angles = _compact_events(
            apsis, carry.ids, apsis_angle, event_capacity)
        new_carry = Carry(ids=snap.ids, rhat=frame.rhat, vrad=frame.vrad,
                          angles=angles_new)
        return new_carry, StepEvents(
            apsis=apsis,
            apsis_angle=apsis_angle,
            dtheta=mj.to_prev[2] if with_dtheta else None,
            matched_prev=mj.matched_prev,
            departed=valid_prev & ~mj.matched_prev,
            entered=valid_cur & ~mj.matched_cur,
            radius=frame.radius,
            bulk_vel=frame.bulk_vel,
            prev_slot=mj.prev_slot_of_cur,
            ev_count=ev_count,
            ev_ids=ev_ids,
            ev_angles=ev_angles,
        )

    return step


def make_static_orbit_step(
    mode: str = "pericentric",
    box_size=None,
    id_dtype=np.int32,
    angle_dtype=np.float32,
    event_capacity: int | None = None,
):
    """Fast path for *static membership*: ``snap.ids`` equals
    ``carry.ids`` slot for slot (the caller checks it on the host), so
    no join is needed and prev and cur layouts coincide.  Same results
    as :func:`make_orbit_step` restricted to the all-matched case."""
    pericentric = _check_mode(mode)
    invalid = invalid_id_for(id_dtype)
    adt = torch_dtype(angle_dtype)

    def step(carry: Carry, snap: SnapshotBatch):
        valid = snap.ids != invalid
        frame = region_frame(
            snap.pos, snap.vel, valid, snap.center, mass=snap.mass,
            bulk_vel=snap.bulk_vel, box_size=box_size,
            hubble_drag=snap.hubble_drag,
        )
        cosang = torch.clamp(
            carry.rhat[0] * frame.rhat[0] + carry.rhat[1] * frame.rhat[1]
            + carry.rhat[2] * frame.rhat[2], -1.0, 1.0)
        dtheta = torch.where(valid, torch.acos(cosang),
                             torch.zeros_like(cosang))
        if pericentric:
            flip = (carry.vrad < 0) & (frame.vrad > 0)
        else:
            flip = (carry.vrad > 0) & (frame.vrad < 0)
        apsis = valid & flip
        angle_acc = carry.angles + dtheta.to(adt)
        zero = torch.zeros_like(angle_acc)
        apsis_angle = torch.where(apsis, angle_acc, zero)
        angles_new = torch.where(apsis, zero, angle_acc)
        ev_count, ev_ids, ev_angles = _compact_events(
            apsis, carry.ids, apsis_angle, event_capacity)
        slots = torch.arange(valid.shape[1], dtype=torch.int32,
                             device=valid.device).expand_as(valid)
        new_carry = Carry(ids=snap.ids, rhat=frame.rhat, vrad=frame.vrad,
                          angles=angles_new)
        return new_carry, StepEvents(
            apsis=apsis,
            apsis_angle=apsis_angle,
            dtheta=dtheta,
            matched_prev=valid,
            departed=torch.zeros_like(valid),
            entered=torch.zeros_like(valid),
            radius=frame.radius,
            bulk_vel=frame.bulk_vel,
            prev_slot=torch.where(valid, slots, torch.full_like(slots, -1)),
            ev_count=ev_count,
            ev_ids=ev_ids,
            ev_angles=ev_angles,
        )

    return step


def orbit_step(carry: Carry, snap: SnapshotBatch, mode: str = "pericentric",
               box_size=None):
    """One general step for ``(mode, box_size)``: ``(carry, StepEvents)``.
    ``box_size`` is a scalar or a length-3 array_like."""
    return make_orbit_step(mode=mode, box_size=box_size)(carry, snap)
