"""The aligned engine's per-snapshot step (twin of the aligned subset of
``orbitanalysis_tpu/ops/sorted_step.py``: carries, codecs,
``aligned_detect_math`` and ``make_aligned_native_step``).

The host staging (:class:`orbitanalysis_tpu_torch.engine.packing.
StableLayout`) gives every particle a persistent row position, so
consecutive staged snapshots are aligned element-wise and the step
needs no join: ``region_frame``, an elementwise detect chain, and one
ordered event compaction — the hand-written CUDA kernel of
:mod:`orbitanalysis_tpu_torch.ops.compact` on the GPU.

uint32 planes (carry keys, packed angles, payload words) are ``int32``
tensors holding the bit pattern: torch has no ``uint32`` arithmetic.
Every right shift of such a plane is masked, since an int32 shift is
arithmetic.  The JAX package's uint32 arrays cross over bit for bit
through :func:`aligned_carry_from_numpy` / :func:`aligned_carry_to_numpy`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops.compact import (
    PAYLOAD_MAX_ROW,
    compact_angle_blocked,
    compact_payload_pair,
    f16_bits_rne,
)
from orbitanalysis_tpu_torch.ops.geometry import region_frame
from orbitanalysis_tpu_torch.utils.device import resolve_device
from orbitanalysis_tpu_torch.utils.numerics import sqrt_rn
from orbitanalysis_tpu_torch.utils.padding import invalid_id_for

#: Capacity ceiling ``join_impl='auto'`` keeps the aligned engine under;
#: a larger first snapshot, or growth past it, runs the general engine.
AUTO_FUSED_CAPACITY = 65536

#: Per-row ceiling of the aligned engine; rows wider than
#: PAYLOAD_MAX_ROW take the two-stream pair compaction.
MAX_ALIGNED_CAPACITY = 1 << 19

#: int32 holding the uint32 bit 31 (apsis / match flag).
_BIT31 = -(1 << 31)


class SortedCarry(NamedTuple):
    """Host-side unpacked view of an :class:`AlignedCarry` (NumPy):
    ``vrb`` bits 0-1 hold the radial-velocity sign (bit0 ``v_r < 0``,
    bit1 ``v_r > 0``), bit 2 the match flag."""

    ids: np.ndarray     # [H, P] int32 (positions for the aligned carry)
    slot: np.ndarray    # [H, P] int32 load-order slot
    vrb: np.ndarray     # [H, P] uint8
    rhat: np.ndarray    # [3, H, P] radial unit vectors
    angles: np.ndarray  # [H, P] f32 cumulative angle


class CompactEvents(NamedTuple):
    """Per-step compact apsis events of the aligned step."""

    count: torch.Tensor     # [H] int32 apsides per halo (exact, may be > K)
    ids: torch.Tensor       # [H, K] event row positions (invalid past count)
    angles: torch.Tensor    # [H, K] f16-exact angle at each apsis (f32)
    bulk_vel: torch.Tensor  # [H, 3] region bulk velocity of this snapshot
    #: full pre-compaction event plane (``emit_payload=True``): the
    #: ``[H, P]`` angle words ``f32_bits(angle) | apsis << 31`` — or the
    #: ``(posw, ang16)`` pair past PAYLOAD_MAX_ROW — so the host can
    #: recover every event when ``count > K`` cut the compacted lists
    payload: torch.Tensor | tuple | None = None


class AlignedCarry(NamedTuple):
    """Carry of the aligned engine, in packed channel formats.

    ``key``: ``(position << 1) | 1`` at valid entries, ``-1`` (uint32
    ``0xFFFFFFFF``) elsewhere; ``sv``: ``load_slot | FRESH << 27 |
    vrb << 24``; ``rhat``: last snapshot's radial unit vectors;
    ``packed``: f32 angle accumulator in bits 0-30, match flag bit 31.
    """

    key: torch.Tensor     # [H, P] int32 (uint32 bits)
    sv: torch.Tensor      # [H, P] int32
    rhat: torch.Tensor    # [3, H, P] float32
    packed: torch.Tensor  # [H, P] int32 (uint32 bits)


def init_aligned_carry(n_halos: int, capacity: int,
                       device="cuda") -> AlignedCarry:
    """All-invalid carry (32-bit signed IDs: the int32-max sentinel's key
    is ``0xFFFFFFFF``, i.e. -1 as int32) on ``device``, CUDA by default
    (RuntimeError without it)."""
    device = resolve_device(device, "init_aligned_carry")
    shape = (n_halos, capacity)
    return AlignedCarry(
        key=torch.full(shape, -1, dtype=torch.int32, device=device),
        sv=torch.arange(capacity, dtype=torch.int32,
                        device=device).expand(shape).contiguous(),
        rhat=torch.zeros((3,) + shape, dtype=torch.float32, device=device),
        packed=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def aligned_carry_from_numpy(key, sv, rhat, packed,
                             device="cuda") -> AlignedCarry:
    """An :class:`AlignedCarry` on ``device`` (CUDA by default) from the
    JAX carry's fields as host arrays (``key``/``packed`` uint32, ``sv``
    int32, ``rhat`` f32); bit-preserving."""
    device = resolve_device(device, "aligned_carry_from_numpy")

    def t(a, dt):
        return torch.from_numpy(np.array(a).view(dt)).to(device)

    return AlignedCarry(key=t(key, np.int32), sv=t(sv, np.int32),
                        rhat=t(rhat, np.float32),
                        packed=t(packed, np.int32))


def aligned_carry_to_numpy(carry: AlignedCarry) -> AlignedCarry:
    """The carry's fields as host arrays in the JAX carry's dtypes
    (``key``/``packed`` uint32); bit-preserving."""
    return AlignedCarry(
        key=carry.key.cpu().numpy().view(np.uint32),
        sv=carry.sv.cpu().numpy(),
        rhat=carry.rhat.cpu().numpy(),
        packed=carry.packed.cpu().numpy().view(np.uint32),
    )


def decode_aligned_carry(carry: AlignedCarry) -> SortedCarry:
    """Host-side unpack of the carry into :class:`SortedCarry` channels,
    for the rare host consumers (checkpointing, growth, engine
    conversion).  Accepts device tensors or host arrays."""
    if isinstance(carry.key, torch.Tensor):
        carry = aligned_carry_to_numpy(carry)
    key = np.asarray(carry.key).view(np.uint32)
    sv = np.asarray(carry.sv)
    packed = np.asarray(carry.packed).view(np.uint32)
    match = (packed >> np.uint32(31)).astype(np.uint8)
    return SortedCarry(
        ids=(key >> np.uint32(1)).astype(np.int32),
        slot=(sv & 0x00FFFFFF).astype(np.int32),
        vrb=((sv >> 24) & 3).astype(np.uint8) | (match << 2),
        rhat=np.asarray(carry.rhat),
        angles=(packed & np.uint32(0x7FFFFFFF)).view(np.float32),
    )


def encode_aligned_carry(c: SortedCarry) -> AlignedCarry:
    """Inverse of :func:`decode_aligned_carry` (host NumPy, JAX dtypes);
    move it to a device with :func:`aligned_carry_from_numpy`."""
    ids = np.asarray(c.ids)
    vrb = np.asarray(c.vrb)
    angles = np.ascontiguousarray(c.angles, dtype=np.float32)
    return AlignedCarry(
        key=(ids.astype(np.uint32) << np.uint32(1)) | np.uint32(1),
        sv=(np.asarray(c.slot) & 0x00FFFFFF).astype(np.int32)
        | ((vrb & 3).astype(np.int32) << 24),
        rhat=np.asarray(c.rhat),
        packed=angles.view(np.uint32)
        | (((vrb >> 2) & 1).astype(np.uint32) << np.uint32(31)),
    )


def _vr_bits(vr: torch.Tensor) -> torch.Tensor:
    """Radial-velocity sign bits as int32: bit0 ``v_r < 0``, bit1
    ``v_r > 0``."""
    return (vr < 0).to(torch.int32) | ((vr > 0).to(torch.int32) << 1)


def _acos_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 arccos to ~2 ulp: the Cephes ``asinf`` polynomial the JAX
    package uses in its kernels (``pallas_step._acos_f32``), operation
    for operation.  ``|x| <= 0.5`` via ``pi/2 - asin(x)``, else
    ``2*asin(sqrt((1-|x|)/2))`` reflected for negative ``x``; the root
    is the IEEE one (:func:`~orbitanalysis_tpu_torch.utils.numerics.
    sqrt_rn`), as in the CUDA kernels."""
    def asin_poly(v, w):
        p = 4.2163199048e-2 * torch.ones_like(w)
        p = p * w + 2.4181311049e-2
        p = p * w + 4.5470025998e-2
        p = p * w + 7.4953002686e-2
        p = p * w + 1.6666752422e-1
        return p * w * v + v

    pi = float(np.float32(np.pi))
    ax = x.abs()
    t = 0.5 * (1.0 - ax)
    sq = sqrt_rn(t)
    big_pos = 2.0 * asin_poly(sq, t)
    acos_big = torch.where(x < 0, pi - big_pos, big_pos)
    acos_small = float(np.float32(np.pi / 2)) - asin_poly(x, x * x)
    return torch.where(ax > 0.5, acos_big, acos_small)


def aligned_detect_math(carry: AlignedCarry, valid_cur, slot, frame,
                        pericentric: bool):
    """The aligned engine's elementwise detect chain: positional keys,
    FRESH gating, sign-flip detection, angle accumulation, packed-carry
    encode and the f16 angle bits.

    Returns ``(cur_key, cur_sv, apsis, angle_acc, packed, ang16, count,
    pos_iota)``; ``ang16`` holds :func:`f16_bits_rne` of the angles.
    """
    h, p = valid_cur.shape
    cur_vrb = _vr_bits(frame.vrad)
    pos_iota = torch.arange(p, dtype=torch.int32,
                            device=valid_cur.device).expand(h, p)
    cur_key = torch.where(valid_cur, (pos_iota << 1) | 1,
                          torch.full_like(pos_iota, -1))
    cur_sv = slot | (cur_vrb << 24)
    fresh = (slot & (1 << 27)) != 0
    vrb_p = (carry.sv >> 24) & 0xF  # sign bits 0-1 (bit 3: stale FRESH)
    pang = (carry.packed & 0x7FFFFFFF).view(torch.float32)
    prev = carry.rhat
    cosang = torch.clamp(
        prev[0] * frame.rhat[0] + prev[1] * frame.rhat[1]
        + prev[2] * frame.rhat[2], -1.0, 1.0)
    dtheta = torch.where(valid_cur, _acos_f32(cosang),
                         torch.zeros_like(cosang))
    if pericentric:
        flip = ((vrb_p & 1) > 0) & ((cur_vrb & 2) > 0)
    else:
        flip = ((vrb_p & 2) > 0) & ((cur_vrb & 1) > 0)
    apsis = valid_cur & flip & ~fresh
    angle_acc = torch.where(fresh, torch.zeros_like(pang), pang + dtheta)
    zero = torch.zeros_like(angle_acc)
    packed = torch.where(apsis | ~valid_cur, zero, angle_acc).view(
        torch.int32) | torch.where(valid_cur & ~fresh, _BIT31, 0).to(
            torch.int32)
    ang16 = f16_bits_rne(angle_acc)
    count = apsis.sum(dim=-1, dtype=torch.int32)
    return (cur_key, cur_sv, apsis, angle_acc, packed, ang16, count,
            pos_iota)


def make_aligned_native_step(
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=np.int32,
    angle_dtype=np.float32,
    detect_impl: str = "xla",
    emit_payload: bool = False,
):
    """The aligned step: ``step(carry, snap) -> (AlignedCarry,
    CompactEvents)``.

    ``snap`` is a :class:`~orbitanalysis_tpu_torch.ops.apsis.
    SnapshotBatch` staged by :func:`~orbitanalysis_tpu_torch.engine.
    packing.pack_snapshot_aligned`; its ``slot`` channel (FRESH flags in
    bit 27) is mandatory.  Events are positional: ``events.ids`` holds
    stable-layout row positions and ``events.angles`` f16-exact angles;
    the host maps positions to IDs and previous load slots through its
    staged tables.  Rows up to :data:`PAYLOAD_MAX_ROW` compact one
    payload word per event, wider rows a position/angle pair.

    ``detect_impl='xla'`` (the JAX package's name for its default) runs
    the detect chain as plain torch; ``'pallas'``, the JAX package's
    fused detect kernel, is not ported.  ``emit_payload=True`` also
    returns the full pre-compaction plane in ``CompactEvents.payload``.
    """
    if mode not in ("pericentric", "apocentric"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    if np.dtype(angle_dtype) != np.float32:
        raise ValueError(
            "the aligned engine packs the match bit into the f32 angle "
            "sign bit; use angle_dtype=float32"
        )
    id_dt = np.dtype(id_dtype)
    if id_dt.itemsize != 4 or not np.issubdtype(id_dt, np.signedinteger):
        raise ValueError(
            "the aligned engine requires 32-bit signed particle IDs "
            "(packed uint32 keys)"
        )
    if detect_impl == "pallas":
        raise NotImplementedError(
            "detect_impl='pallas' is the fused static-detect kernel K17 "
            "(pallas_step.fused_static_detect), not yet ported; see "
            "ROADMAP.md Queue 2"
        )
    if detect_impl != "xla":
        raise ValueError(f"unknown detect_impl: {detect_impl!r}")
    pericentric = mode == "pericentric"
    invalid = invalid_id_for(id_dtype)
    K = int(event_capacity)

    def step(carry: AlignedCarry, snap):
        if snap.slot is None:
            raise ValueError(
                "the aligned step needs stable-layout staging: snap.slot "
                "(with FRESH flags in bit 27) is mandatory — stage via "
                "pack_snapshot_aligned"
            )
        h, p = snap.ids.shape
        valid_cur = snap.ids != invalid
        frame = region_frame(
            snap.pos, snap.vel, valid_cur, snap.center, mass=snap.mass,
            bulk_vel=snap.bulk_vel, box_size=box_size,
            hubble_drag=snap.hubble_drag,
        )
        (cur_key, cur_sv, apsis, angle_acc, packed, ang16, count,
         pos_iota) = aligned_detect_math(
            carry, valid_cur, snap.slot, frame, pericentric)
        k_eff = min(K, p)
        if p <= PAYLOAD_MAX_ROW:
            aw = angle_acc.view(torch.int32) | torch.where(
                apsis, _BIT31, 0).to(torch.int32)
            full_payload = aw if emit_payload else None
            evpay = compact_angle_blocked(aw, k_eff)
            ev_pos = ((evpay >> 15) & 0x1FFFF) - 1
            ev_ang_bits = evpay & 0x7FFF
        else:
            # pos + 1 = 2**17 at the last position of a 131072-wide row
            # would wrap the single payload word: two streams instead
            posw = torch.where(apsis, pos_iota + 1,
                               torch.zeros_like(pos_iota))
            full_payload = (posw, ang16) if emit_payload else None
            evposw, ev_ang_bits = compact_payload_pair(posw, ang16, k_eff)
            ev_pos = evposw - 1
        evang = (ev_ang_bits & 0xFFFF).to(torch.int16).view(
            torch.float16).to(torch.float32)
        kiota = torch.arange(ev_pos.shape[1], device=ev_pos.device)
        ev_ok = kiota[None, :] < count[:, None]
        return AlignedCarry(key=cur_key, sv=cur_sv, rhat=frame.rhat,
                            packed=packed), CompactEvents(
            count=count,
            ids=torch.where(ev_ok, ev_pos,
                            torch.full_like(ev_pos, invalid))[:, :K],
            angles=torch.where(ev_ok, evang, torch.zeros_like(evang))[:, :K],
            bulk_vel=frame.bulk_vel,
            payload=full_payload,
        )

    return step
