"""The label-native detector's detect pass (twin of
``orbitanalysis_tpu/ops/pallas_label.py``: ``_detect_core``,
``detect_label_pallas``, ``detect_label_compact_pallas`` and
``fused_label_detect``).

Per particle of the ``[R, W]`` row planes: geometry against its halo's
frame rows (periodic wrap, radial unit vector, radial velocity with the
Hubble term), the radial-velocity sign bits, FRESH / matched from the
carried ``lab_sv``, the Cephes arccos of the clipped cosine against the
carried radial unit vector, the packed angle carry, and the positional
payload word ``((pos + 1) << 15) | f16_rne(angle)`` where an apsis
fired — the reference's detection (``track_orbits.py:293-351``) with a
label change as region entry.

- :func:`detect_label_torch` is that chain in plain torch; the XLA frame
  routes of :mod:`orbitanalysis_tpu_torch.ops.label_step` run it too.
- :func:`detect_label` (K9) returns the payload plane and the counts;
  :func:`detect_label_compact` (K8) compacts the events in the same
  pass; :func:`fused_label_detect` (K10) is K9 with each particle's frame
  row taken from the ``[H, 6]`` frame table in the same pass.  All three
  launch the CUDA source ``csrc/label.cu`` on CUDA tensors and the plain
  chain only on CPU tensors.

Every float operation of the plain chain is the IEEE operation the
kernel runs, in the same order: divisions and square roots go through
:func:`~orbitanalysis_tpu_torch.utils.numerics.div_rn` /
:func:`~orbitanalysis_tpu_torch.utils.numerics.sqrt_rn`, so the plain
chain on the card gives the kernel's bits.  ``jnp.round`` is
round-half-to-even, as ``torch.round`` is.  uint32 planes are int32
tensors; every right shift is masked.
"""

from __future__ import annotations

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.ops.compact import (
    _k128,
    compact_payload_torch,
    f16_bits_rne,
)
from orbitanalysis_tpu_torch.ops.frames import frame_rows_torch
from orbitanalysis_tpu_torch.ops.sorted_step import _BIT31, _acos_f32
from orbitanalysis_tpu_torch.utils.numerics import (
    div_rn,
    oct_decode,
    oct_encode,
    sqrt_rn,
    to_i32_bits,
)


def _f32(x) -> float:
    """A Python float holding the float32 value of ``x``."""
    return float(np.float32(x))


def detect_label_torch(rows, lab, pos, vel, sv, rhat, packed, hubble_drag,
                       *, pericentric: bool, box_size, rhat_packed: bool):
    """The detect chain (``pallas_label._detect_core``) in plain torch.

    ``rows``: ``[6, R, W]`` f32 (halo centre ++ bulk velocity per
    particle); ``lab``: ``[R, W]`` int32 (-1 untracked); ``pos``/``vel``:
    ``[3, R, W]`` f32; ``sv``/``packed``: the carry's int32 planes;
    ``rhat``: ``[3, R, W]`` f32, or ``[R, W]`` int32 octahedral words
    when ``rhat_packed``.  Returns ``(sv', rhat', packed', payload
    [R, W] int32, count [R] int32)``.
    """
    dev = lab.device
    rel = []
    r2 = None
    for d in range(3):
        rd = pos[d] - rows[d]
        if box_size is not None:
            box = torch.full((), _f32(box_size), device=dev)
            rd = rd - box * torch.round(div_rn(rd, box.expand_as(rd)))
        rel.append(rd)
        r2 = rd * rd if r2 is None else r2 + rd * rd
    r = sqrt_rn(r2)
    zero = torch.zeros((), device=dev)
    inv_r = torch.where(r > 0, div_rn(1.0, torch.clamp(r, min=1e-30)), zero)
    rh = [rd * inv_r for rd in rel]
    hub = torch.full((), _f32(hubble_drag), device=dev)
    vr = None
    for d in range(3):
        term = rh[d] * ((vel[d] - rows[3 + d]) + hub * rel[d])
        vr = term if vr is None else vr + term
    vrb = (vr < 0).to(torch.int32) | ((vr > 0).to(torch.int32) << 1)

    valid = lab >= 0
    prev_label = (sv & 0x0FFFFFFF) - 1
    prev_vrb = (sv >> 28) & 0xF
    matched = valid & (lab == prev_label) & (packed < 0)
    prev = oct_decode(rhat) if rhat_packed else rhat
    cosang = torch.clamp(prev[0] * rh[0] + prev[1] * rh[1] + prev[2] * rh[2],
                         -1.0, 1.0)
    pang = (packed & 0x7FFFFFFF).view(torch.float32)
    angle_acc = torch.where(matched, pang + _acos_f32(cosang), zero)
    if pericentric:
        flip = ((prev_vrb & 1) > 0) & ((vrb & 2) > 0)
    else:
        flip = ((prev_vrb & 2) > 0) & ((vrb & 1) > 0)
    apsis = matched & flip
    opk = (torch.where(apsis | ~valid, zero, angle_acc).view(torch.int32)
           | torch.where(valid, _BIT31, 0).to(torch.int32))
    osv = torch.where(valid, (lab + 1) | (vrb << 28),
                      torch.zeros((), dtype=torch.int32, device=dev))
    orh = oct_encode(torch.stack(rh)) if rhat_packed else torch.stack(rh)
    w = lab.shape[1]
    pos1 = torch.arange(1, w + 1, dtype=torch.int64, device=dev)
    ang15 = (f16_bits_rne(angle_acc) & 0x7FFF).to(torch.int64)
    payload = torch.where(apsis, to_i32_bits((pos1 << 15) | ang15),
                          torch.zeros((), dtype=torch.int32, device=dev))
    count = apsis.sum(dim=-1, dtype=torch.int32)
    return osv, orh, opk, payload, count


def detect_label_compact_torch(rows, lab, pos, vel, sv, rhat, packed,
                               hubble_drag, *, event_capacity: int,
                               pericentric: bool, box_size,
                               rhat_packed: bool):
    """Plain twin of the detect-and-compact kernel: the chain, then the
    payload compaction.  Returns ``(sv', rhat', packed', events
    [R, k128], count [R])``."""
    osv, orh, opk, payload, count = detect_label_torch(
        rows, lab, pos, vel, sv, rhat, packed, hubble_drag,
        pericentric=pericentric, box_size=box_size, rhat_packed=rhat_packed)
    return osv, orh, opk, compact_payload_torch(payload, event_capacity), count


def _contig(*ts):
    return [t.contiguous() for t in ts]


def detect_label(rows, lab, pos, vel, sv, rhat, packed, hubble_drag, *,
                 pericentric: bool, box_size, rhat_packed: bool = False):
    """The detect pass without compaction (K9): the CUDA kernel
    ``detect_label_rows`` on CUDA tensors, :func:`detect_label_torch`
    on CPU tensors.  Returns ``(sv', rhat', packed', payload, count)``."""
    if _cuda.on_cpu(lab, "detect"):
        return detect_label_torch(
            rows, lab, pos, vel, sv, rhat, packed, hubble_drag,
            pericentric=pericentric, box_size=box_size,
            rhat_packed=rhat_packed)
    return _cuda.detect_label_rows(
        *_contig(rows, lab, pos, vel, sv, rhat, packed), _f32(hubble_drag),
        None if box_size is None else _f32(box_size), pericentric,
        rhat_packed)


def detect_label_compact(rows, lab, pos, vel, sv, rhat, packed,
                         hubble_drag, *, event_capacity: int,
                         pericentric: bool, box_size,
                         rhat_packed: bool = False):
    """The detect pass with its exact ordered event compaction (K8): the
    CUDA kernel ``detect_label_compact_rows`` on CUDA tensors,
    :func:`detect_label_compact_torch` on CPU tensors.  Returns
    ``(sv', rhat', packed', events [R, k128], count [R])``; the counts
    are exact even past ``k128``."""
    if _cuda.on_cpu(lab, "detect"):
        return detect_label_compact_torch(
            rows, lab, pos, vel, sv, rhat, packed, hubble_drag,
            event_capacity=event_capacity, pericentric=pericentric,
            box_size=box_size, rhat_packed=rhat_packed)
    w = lab.shape[1]
    if w % 128:
        raise ValueError("row_width must be a multiple of 128")
    return _cuda.detect_label_compact_rows(
        *_contig(rows, lab, pos, vel, sv, rhat, packed), _f32(hubble_drag),
        None if box_size is None else _f32(box_size), pericentric,
        rhat_packed, _k128(event_capacity, w))


def fused_label_detect_torch(table, lab, pos, vel, sv, rhat, packed,
                             hubble_drag, *, pericentric: bool, box_size,
                             rhat_packed: bool = False):
    """Plain twin of the fused detect pass: the frame rows gathered from
    ``table [H, 6]`` (:func:`~orbitanalysis_tpu_torch.ops.frames.
    frame_rows_torch`), then :func:`detect_label_torch`.  Returns
    ``(sv', rhat', packed', payload [R, W], count [R])``."""
    r, w = lab.shape
    rows = frame_rows_torch(table, lab).reshape(6, r, w)
    return detect_label_torch(rows, lab, pos, vel, sv, rhat, packed,
                              hubble_drag, pericentric=pericentric,
                              box_size=box_size, rhat_packed=rhat_packed)


def fused_label_detect(table, lab, pos, vel, sv, rhat, packed, hubble_drag,
                       *, pericentric: bool, box_size,
                       rhat_packed: bool = False):
    """The fused label-native detect pass (K10): frame rows, geometry,
    detection, carry update and payload words in one pass, each plane
    read or written once.  ``table``: ``[H, 6]`` f32 (centres ++ bulk
    velocities); ``lab``: ``[R, W]`` int32 in ``[-1, H)``; the rest as
    :func:`detect_label`.  The CUDA kernel ``fused_label_rows`` stages the
    table in shared memory (ValueError past its size) on CUDA tensors;
    :func:`fused_label_detect_torch` runs on CPU tensors.  Returns
    ``(sv', rhat', packed', payload [R, W], count [R])``; feed the
    payload to :func:`~orbitanalysis_tpu_torch.ops.compact.
    compact_payload_blocked`."""
    # the kernel's bound holds on every device, so a route that runs on
    # the CPU runs on the card
    _cuda.check_fused_table(table.shape[0])
    if _cuda.on_cpu(lab, "detect"):
        return fused_label_detect_torch(
            table, lab, pos, vel, sv, rhat, packed, hubble_drag,
            pericentric=pericentric, box_size=box_size,
            rhat_packed=rhat_packed)
    return _cuda.fused_label_rows(
        *_contig(table.to(torch.float32), lab, pos, vel, sv, rhat, packed),
        _f32(hubble_drag), None if box_size is None else _f32(box_size),
        pericentric, rhat_packed)
