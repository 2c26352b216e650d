"""The sorted and the aligned engines' per-snapshot steps (twin of
``orbitanalysis_tpu/ops/sorted_step.py``: carries, codecs,
``make_sorted_orbit_step``, ``aligned_detect_math``,
``make_aligned_native_step`` and the legacy ``make_aligned_orbit_step``).

The sorted engine keeps the carry sorted by particle ID between steps.
Each step joins it with the snapshot staged ID-sorted on the host
(:func:`presort_snapshot`, ``pack_snapshot(..., sort_ids=True)``): on
its fused path (the tracker's) one join-and-detect kernel
(:mod:`orbitanalysis_tpu_torch.ops.step`, K16), or, when the membership
did not change, an elementwise detect chain and the three-stream event
compaction (K18); its unfused paths merge (K15, or a sort) and compact
(K19, or a sort) around a detect chain in the merged domain.  A CUDA
tensor launches the hand-written kernels wherever the JAX package
reaches a Pallas kernel; where it runs ``lax.sort`` or XLA, the port
runs plain torch.

The aligned engine's host staging (:class:`orbitanalysis_tpu_torch.
engine.packing.StableLayout`) gives every particle a persistent row
position, so consecutive staged snapshots are aligned element-wise and
the step needs no join: ``region_frame`` and an elementwise detect chain
(on the GPU one fused kernel, :func:`aligned_chain`), and one ordered
event compaction — the hand-written CUDA kernel of
:mod:`orbitanalysis_tpu_torch.ops.compact` on the GPU — or, with
``detect_impl='pallas'`` and in the legacy step, the aligned detect
kernel of :mod:`orbitanalysis_tpu_torch.ops.step` (K17), which detects
and compacts in one call.

uint32 planes (carry keys, packed angles, payload words) are ``int32``
tensors holding the bit pattern: torch has no ``uint32`` arithmetic.
Every right shift of such a plane is masked, since an int32 shift is
arithmetic, and every sort of such a plane orders ``key & 0xFFFFFFFF``
as int64.  The JAX package's carries cross over bit for bit through
:func:`sorted_carry_from_numpy` / :func:`sorted_carry_to_numpy` and
:func:`aligned_carry_from_numpy` / :func:`aligned_carry_to_numpy`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.ops.compact import (
    PAYLOAD_MAX_ROW,
    compact_angle_blocked,
    compact_events,
    compact_payload_pair,
    compact_rows,
    f16_bits_rne,
)
from orbitanalysis_tpu_torch.ops.geometry import box_f32, region_frame
from orbitanalysis_tpu_torch.ops.merge import (
    merge_rows,
    sort_descending_u32,
    u32_order,
)
from orbitanalysis_tpu_torch.utils.device import resolve_device
from orbitanalysis_tpu_torch.utils.metrics import phase_timer
from orbitanalysis_tpu_torch.utils.numerics import (
    oct_decode,
    oct_encode,
    sqrt_rn,
    to_i32_bits,
    torch_dtype,
)
from orbitanalysis_tpu_torch.utils.padding import invalid_id_for

#: Largest per-row capacity the sorted engine accepts (the JAX package's
#: fused-kernel ceiling, kept so both packages take the same runs).
MAX_FUSED_CAPACITY = 131072

#: Capacity ceiling ``join_impl='auto'`` keeps the aligned engine under;
#: a larger first snapshot, or growth past it, runs the general engine.
AUTO_FUSED_CAPACITY = 65536

#: Per-row ceiling of the aligned engine; rows wider than
#: PAYLOAD_MAX_ROW take the two-stream pair compaction.
MAX_ALIGNED_CAPACITY = 1 << 19

#: int32 holding the uint32 bit 31 (apsis / match flag).
_BIT31 = -(1 << 31)

#: Sort key of merged entries that are neither part of the next carry
#: nor an apsis event (departed, padding, matched-away prev).
_DEAD_KEY = 1 << 30


class SortedCarry(NamedTuple):
    """Per-particle state of the sorted engine, sorted by ID (torch
    tensors on the device), and the host-side unpacked view of an
    :class:`AlignedCarry` (NumPy, from :func:`decode_aligned_carry`).

    ``ids`` ascend within each row, the dtype-max padding sentinel last
    (positions for the aligned view); ``slot`` is each particle's
    load-order slot in the snapshot it came with; ``vrb`` bits 0-1 hold
    the radial-velocity sign (bit0 ``v_r < 0``, bit1 ``v_r > 0``), bit 2
    the match flag."""

    ids: torch.Tensor     # [H, P] id dtype, ascending, sentinel-padded
    slot: torch.Tensor    # [H, P] int32 load-order slot
    vrb: torch.Tensor     # [H, P] uint8
    rhat: torch.Tensor    # [3, H, P] radial unit vectors
    angles: torch.Tensor  # [H, P] cumulative angle


class CompactEvents(NamedTuple):
    """Per-step compact apsis events: of the sorted step (particle IDs
    in previous-snapshot load order, or in ID order with the load slots
    alongside: ``events_id_order``) and of the aligned step (row
    positions, f16-exact angles)."""

    count: torch.Tensor     # [H] int32 apsides per halo (exact, may be > K)
    ids: torch.Tensor       # [H, K] event IDs / positions (invalid past count)
    angles: torch.Tensor    # [H, K] angle at each apsis
    bulk_vel: torch.Tensor  # [H, 3] region bulk velocity of this snapshot
    slots: torch.Tensor | None = None  # [H, K] prev load slots (ID order)
    #: full pre-compaction event plane (``emit_payload=True``): the
    #: ``[H, P]`` angle words ``f32_bits(angle) | apsis << 31`` — or the
    #: ``(posw, ang16)`` pair past PAYLOAD_MAX_ROW — so the host can
    #: recover every event when ``count > K`` cut the compacted lists
    payload: torch.Tensor | tuple | None = None


class AlignedCarry(NamedTuple):
    """Carry of the aligned engine, in packed channel formats.

    ``key``: ``(position << 1) | 1`` at valid entries, ``-1`` (uint32
    ``0xFFFFFFFF``) elsewhere; ``sv``: ``load_slot | FRESH << 27 |
    vrb << 24``; ``rhat``: last snapshot's radial unit vectors, or their
    octahedral words (``rhat_packed``); ``packed``: f32 angle accumulator
    in bits 0-30, match flag bit 31.
    """

    key: torch.Tensor     # [H, P] int32 (uint32 bits)
    sv: torch.Tensor      # [H, P] int32
    rhat: torch.Tensor    # [3, H, P] float32, or [H, P] int32 oct-packed
    packed: torch.Tensor  # [H, P] int32 (uint32 bits)


def init_aligned_carry(n_halos: int, capacity: int,
                       pos_dtype=torch.float32, rhat_packed: bool = False,
                       device="cuda") -> AlignedCarry:
    """All-invalid carry (32-bit signed IDs: the int32-max sentinel's key
    is ``0xFFFFFFFF``, i.e. -1 as int32) on ``device``, CUDA by default
    (RuntimeError without it).  ``rhat_packed=True`` keeps the radial
    unit vectors as one plane of octahedral words (pair it with
    ``make_aligned_native_step(..., rhat_packed=True)``): counts are
    unaffected, angles move by the ~1e-4 rad quantization a step.

    ``pos_dtype`` (a torch or NumPy dtype) is the dtype of the unpacked
    r-hat planes, as in JAX.  A step writes float32 planes, so it sets
    only the first step's carry, whose planes no valid slot reads; the
    aligned detect kernel (``detect_impl='pallas'`` on the card) takes
    float32 planes only."""
    device = resolve_device(device, "init_aligned_carry")
    if not isinstance(pos_dtype, torch.dtype):
        pos_dtype = getattr(torch, np.dtype(pos_dtype).name)
    shape = (n_halos, capacity)
    return AlignedCarry(
        key=torch.full(shape, -1, dtype=torch.int32, device=device),
        sv=torch.arange(capacity, dtype=torch.int32,
                        device=device).expand(shape).contiguous(),
        rhat=(torch.zeros(shape, dtype=torch.int32, device=device)
              if rhat_packed else
              torch.zeros((3,) + shape, dtype=pos_dtype, device=device)),
        packed=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def aligned_carry_from_numpy(key, sv, rhat, packed,
                             device="cuda") -> AlignedCarry:
    """An :class:`AlignedCarry` on ``device`` (CUDA by default) from the
    JAX carry's fields as host arrays (``key``/``packed`` uint32, ``sv``
    int32, ``rhat`` f32 or uint32 octahedral words); bit-preserving."""
    device = resolve_device(device, "aligned_carry_from_numpy")

    def t(a, dt):
        return torch.from_numpy(np.array(a).view(dt)).to(device)

    rhat = np.asarray(rhat)
    return AlignedCarry(
        key=t(key, np.int32), sv=t(sv, np.int32),
        rhat=t(rhat, np.float32 if rhat.dtype == np.float32 else np.int32),
        packed=t(packed, np.int32))


def aligned_carry_to_numpy(carry: AlignedCarry) -> AlignedCarry:
    """The carry's fields as host arrays in the JAX carry's dtypes
    (``key``/``packed`` and a packed ``rhat`` uint32); bit-preserving."""
    rhat = carry.rhat.cpu().numpy()
    return AlignedCarry(
        key=carry.key.cpu().numpy().view(np.uint32),
        sv=carry.sv.cpu().numpy(),
        rhat=rhat.view(np.uint32) if rhat.dtype == np.int32 else rhat,
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


def _invalid_key(invalid) -> int:
    """The padding key ``(uint32(invalid) << 1) | 1``, modulo 2**32 and
    read as int32 bits: -1 for the int32 sentinel."""
    k = (((int(invalid) & 0xFFFFFFFF) << 1) | 1) & 0xFFFFFFFF
    return k - (1 << 32) if k >= 1 << 31 else k


def _aligned_keys(valid_cur, slot, frame, invalid):
    """The aligned step's staged key and sv planes: ``(position << 1) |
    1`` at valid entries (:func:`_invalid_key` of ``invalid``, the
    padding key, elsewhere) and ``slot | vrb << 24``.  Returns
    ``(cur_key, cur_sv, cur_vrb, pos_iota)``."""
    h, p = valid_cur.shape
    cur_vrb = _vr_bits(frame.vrad)
    pos_iota = torch.arange(p, dtype=torch.int32,
                            device=valid_cur.device).expand(h, p)
    cur_key = torch.where(valid_cur, (pos_iota << 1) | 1,
                          torch.full_like(pos_iota, _invalid_key(invalid)))
    return cur_key, slot | (cur_vrb << 24), cur_vrb, pos_iota


def aligned_detect_math(carry: AlignedCarry, valid_cur, slot, frame,
                        pericentric: bool, invalid,
                        rhat_packed: bool = False,
                        share_angles: bool = False):
    """The aligned engine's elementwise detect chain: positional keys,
    FRESH gating, sign-flip detection, angle accumulation, packed-carry
    encode and the f16 angle bits.  ``invalid``: the padding ID, whose
    key ``(uint32(invalid) << 1) | 1`` marks the entries that are not
    valid.  ``rhat_packed``: the carry holds octahedral r-hat words.
    ``share_angles`` is accepted for the JAX signature and changes
    nothing: there it is an XLA fusion barrier, and eager torch
    computes the angles once anyway.

    Returns ``(cur_key, cur_sv, apsis, angle_acc, packed, ang16, count,
    pos_iota)``; ``ang16`` holds :func:`f16_bits_rne` of the angles.
    """
    cur_key, cur_sv, cur_vrb, pos_iota = _aligned_keys(valid_cur, slot,
                                                       frame, invalid)
    fresh = (slot & (1 << 27)) != 0
    vrb_p = (carry.sv >> 24) & 0xF  # sign bits 0-1 (bit 3: stale FRESH)
    pang = (carry.packed & 0x7FFFFFFF).view(torch.float32)
    prev = oct_decode(carry.rhat) if rhat_packed else carry.rhat
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


def aligned_chain_torch(carry: AlignedCarry, snap, box_size, pericentric,
                        invalid, soa: bool = False,
                        rhat_packed: bool = False):
    """The aligned step's frame-and-detect chain in plain torch:
    :func:`region_frame`, :func:`aligned_detect_math` and the input words
    of the event compaction.  The twin of the fused kernels
    (:func:`aligned_chain`), and the route of CPU tensors.

    Returns ``(key, sv, rhat, packed, words, count, bulk_vel)``: the new
    carry's planes (``rhat`` octahedral words with ``rhat_packed``);
    ``words``, the ``[H, P]`` angle words ``f32_bits(angle) | apsis <<
    31`` of K1 or, for rows wider than :data:`PAYLOAD_MAX_ROW`, the
    ``(apsis ? position + 1 : 0, f16 angle bits)`` planes of K3; the
    ``[H]`` apsis counts; the ``[H, 3]`` bulk velocities."""
    p = snap.ids.shape[1]
    valid_cur, frame = _aligned_frame(snap, box_size, invalid, soa)
    with phase_timer(None, "step.detect"):
        (cur_key, cur_sv, apsis, angle_acc, packed, ang16, count,
         pos_iota) = aligned_detect_math(
            carry, valid_cur, snap.slot, frame, pericentric, invalid,
            rhat_packed=rhat_packed)
        if p <= PAYLOAD_MAX_ROW:
            words = angle_acc.view(torch.int32) | torch.where(
                apsis, _BIT31, 0).to(torch.int32)
        else:
            # pos + 1 = 2**17 at the last position of a 131072-wide row
            # would wrap the single payload word: two streams
            words = (torch.where(apsis, pos_iota + 1,
                                 torch.zeros_like(pos_iota)), ang16)
        rhat = oct_encode(frame.rhat) if rhat_packed else frame.rhat
    return cur_key, cur_sv, rhat, packed, words, count, frame.bulk_vel


def _aligned_frame(snap, box_size, invalid, soa):
    """The plain chain's first half, timed as ``step.frame``: the valid
    mask of ``snap``'s slots and their :func:`region_frame`."""
    with phase_timer(None, "step.frame"):
        valid_cur = snap.ids != invalid
        return valid_cur, region_frame(
            snap.pos, snap.vel, valid_cur, snap.center, mass=snap.mass,
            bulk_vel=snap.bulk_vel, box_size=box_size,
            hubble_drag=snap.hubble_drag, soa=soa,
        )


def aligned_chain(carry: AlignedCarry, snap, box_size, pericentric, invalid,
                  soa: bool = False, rhat_packed: bool = False):
    """The aligned step's frame-and-detect chain, with the outputs of
    :func:`aligned_chain_torch`: on CPU tensors that plain chain, on CUDA
    tensors the fused kernels of ``csrc/static.cu`` (every layout, box,
    Hubble term, mode, r-hat carry and row width): ``aligned_moments``
    when ``snap.bulk_vel`` is None, then one ``aligned_frame_detect``
    pass.  The kernels take float32 coordinates, masses and bulk
    velocities, and a scalar ``hubble_drag``.  Given the same bulk
    velocity the two routes agree bit for bit; the kernel's own bulk
    velocity sums in float64, within 2 float32 ulps of the exact quotient
    (``torch.sum``'s float32 order strays further)."""
    if _cuda.on_cpu(snap.ids, "aligned frame-and-detect"):
        return aligned_chain_torch(carry, snap, box_size, pericentric,
                                   invalid, soa=soa, rhat_packed=rhat_packed)
    p = snap.ids.shape[1]
    # the plain chain leaves an [H, P, 3] step's r-hat strided
    ids, slot, pos, vel, center = (t.contiguous() for t in (
        snap.ids, snap.slot, snap.pos, snap.vel, snap.center))
    prev = tuple(t.contiguous() for t in (carry.sv, carry.rhat,
                                          carry.packed))
    with phase_timer(None, "step.frame"):
        if snap.bulk_vel is None:
            bulk = _cuda.aligned_moments(
                ids, vel, None if snap.mass is None
                else snap.mass.contiguous(), invalid, soa)
        else:
            bulk = snap.bulk_vel.to(torch.float32).contiguous()
    # the box per axis, each rounded to float32 as region_frame rounds it
    box = None if box_size is None else tuple(
        np.broadcast_to(box_f32(box_size), 3).tolist())
    with phase_timer(None, "step.detect"):
        return _cuda.aligned_frame_detect(
            ids, slot, pos, vel, center, bulk,
            float(np.float32(snap.hubble_drag)), box, prev, pericentric,
            invalid, _invalid_key(invalid), soa, rhat_packed,
            p > PAYLOAD_MAX_ROW)


def _check_aligned(mode, angle_dtype, id_dtype):
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


def make_aligned_native_step(
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=np.int32,
    angle_dtype=np.float32,
    events_id_order: bool = True,
    soa_batch: bool = False,
    detect_impl: str = "xla",
    rhat_packed: bool = False,
    emit_payload: bool = False,
):
    """The aligned step: ``step(carry, snap) -> (AlignedCarry,
    CompactEvents)``, the JAX package's options and errors.

    ``snap`` is a :class:`~orbitanalysis_tpu_torch.ops.apsis.
    SnapshotBatch` staged by :func:`~orbitanalysis_tpu_torch.engine.
    packing.pack_snapshot_aligned`; its ``slot`` channel (FRESH flags in
    bit 27) is mandatory.  Events are positional: ``events.ids`` holds
    stable-layout row positions; the host maps positions to IDs and
    previous load slots through its staged tables.

    ``detect_impl``:

    - ``'xla'`` (the JAX package's name for its default): the frame and
      detect chain (:func:`aligned_chain`: plain torch on the CPU, the
      fused kernels of ``csrc/static.cu`` on CUDA, one pass a step and a
      moments pass when ``snap.bulk_vel`` is None) and one ordered
      compaction of f16-exact angles — one payload word an event for
      rows up to :data:`PAYLOAD_MAX_ROW` (K1), a position/angle pair for
      wider rows (K3).  ``emit_payload=True`` also returns the full
      pre-compaction plane in ``CompactEvents.payload``;
      ``rhat_packed=True`` carries octahedral r-hat words
      (:func:`init_aligned_carry` with ``rhat_packed``).
    - ``'pallas'``: detection and compaction in one call, the aligned
      detect kernel (K17, :func:`~orbitanalysis_tpu_torch.ops.step.
      fused_static_detect` with ``native=True``): float32 angles, and
      each event's previous load slot in ``CompactEvents.slots``
      (``events_id_order=True``, events in position order) or the events
      sorted by that slot (``events_id_order=False``).  Rows must be a
      power of two >= 128 long.

    ``soa_batch=True``: ``pos``/``vel`` arrive as ``[3, H, P]``.

    Under a profiler the step's stages are the ranges ``oa.step.frame``
    (:func:`region_frame`, or the moments kernel), ``oa.step.detect``
    (:func:`aligned_detect_math`, the fused pass, or the K17 call),
    ``oa.step.compact`` (K1 or the pair compaction) and
    ``oa.step.finish`` (the event lists and the new carry).
    """
    _check_aligned(mode, angle_dtype, id_dtype)
    if detect_impl not in ("xla", "pallas"):
        raise ValueError(f"unknown detect_impl: {detect_impl!r}")
    if rhat_packed and detect_impl != "xla":
        raise ValueError(
            "rhat_packed requires detect_impl='xla' (the fused pallas "
            "detect kernel streams f32 rhat planes)"
        )
    if emit_payload and detect_impl != "xla":
        raise ValueError(
            "emit_payload requires detect_impl='xla' (the pallas path "
            "has no pre-compaction payload plane to expose)"
        )
    # step.py imports this module
    from orbitanalysis_tpu_torch.ops.step import fused_static_detect

    pericentric = mode == "pericentric"
    invalid = invalid_id_for(id_dtype)
    id_dt = torch_dtype(id_dtype)
    K = int(event_capacity)

    def step(carry: AlignedCarry, snap):
        if snap.slot is None:
            raise ValueError(
                "the aligned step needs stable-layout staging: snap.slot "
                "(with FRESH flags in bit 27) is mandatory — stage via "
                "pack_snapshot_aligned"
            )
        p = snap.ids.shape[1]
        k_eff = min(K, p)
        if detect_impl == "pallas":
            valid_cur, frame = _aligned_frame(snap, box_size, invalid,
                                              soa_batch)
            with phase_timer(None, "step.detect"):
                cur_key, cur_sv, _, _ = _aligned_keys(valid_cur, snap.slot,
                                                      frame, invalid)
                rh = frame.rhat
                packed, evk, evsv, evang, count = fused_static_detect(
                    (carry.key, carry.sv, carry.rhat[0], carry.rhat[1],
                     carry.rhat[2], carry.packed),
                    (cur_key, cur_sv, rh[0], rh[1], rh[2]),
                    pericentric, invalid, k_eff, native=True)
            with phase_timer(None, "step.finish"):
                ev_ids, ev_angles, ev_slots = _finish_events(
                    count, (evk >> 1) & 0x7FFFFFFF, evsv & 0x00FFFFFF, evang,
                    K, invalid, id_dt, id_order=events_id_order)
                return AlignedCarry(key=cur_key, sv=cur_sv, rhat=rh,
                                    packed=packed), CompactEvents(
                    count=count, ids=ev_ids, angles=ev_angles,
                    bulk_vel=frame.bulk_vel, slots=ev_slots)
        cur_key, cur_sv, rhat, packed, words, count, bulk_vel = \
            aligned_chain(carry, snap, box_size, pericentric, invalid,
                          soa=soa_batch, rhat_packed=rhat_packed)
        with phase_timer(None, "step.compact"):
            if p <= PAYLOAD_MAX_ROW:
                evpay = compact_angle_blocked(words, k_eff)
                ev_pos = ((evpay >> 15) & 0x1FFFF) - 1
                ev_ang_bits = evpay & 0x7FFF
            else:
                evpay, ev_ang_bits = compact_payload_pair(*words, k_eff)
                ev_pos = evpay - 1
        with phase_timer(None, "step.finish"):
            # both compactions zero each row past its count, and an
            # event's word is never 0 (it holds the position + 1), so
            # the angles there are 0 already
            evang = ev_ang_bits.to(torch.int16).view(torch.float16).to(
                torch.float32)
            return AlignedCarry(
                key=cur_key, sv=cur_sv, rhat=rhat, packed=packed), \
                CompactEvents(
                    count=count,
                    ids=torch.where(evpay != 0, ev_pos, invalid)[:, :K],
                    angles=evang[:, :K],
                    bulk_vel=bulk_vel,
                    payload=words if emit_payload else None,
                )

    return step


def make_aligned_orbit_step(
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=np.int32,
    angle_dtype=np.float32,
    events_id_order: bool = True,
    soa_batch: bool = False,
):
    """The legacy select-staged aligned step: ``step(carry, snap) ->
    (SortedCarry, CompactEvents)``, the in-repo oracle of the aligned
    engine.

    The carry is a :class:`SortedCarry` in the stable layout (real IDs,
    load slots, sign bits, float32 angles; :func:`init_sorted_carry`);
    ``snap`` is staged by ``pack_snapshot_aligned`` (``snap.slot`` maps
    positions to the row's load order; without it a position is its own
    slot).  A position whose staged ID differs from the carry's gets the
    FRESH flag (bit 27) on its prev sv, so the aligned detect kernel (K17,
    ``native=False``) suppresses the stale prev state and restarts the
    angle at 0.  Events come back as real IDs with float32 angles and the
    previous load slots: in position order with ``CompactEvents.slots``
    (``events_id_order=True``), or sorted by slot.
    """
    _check_aligned(mode, angle_dtype, id_dtype)
    # step.py imports this module
    from orbitanalysis_tpu_torch.ops.step import fused_static_detect

    pericentric = mode == "pericentric"
    invalid = invalid_id_for(id_dtype)
    id_dt = torch_dtype(id_dtype)
    K = int(event_capacity)

    def step(carry: SortedCarry, snap):
        h, p = snap.ids.shape
        valid_cur = snap.ids != invalid
        frame = region_frame(
            snap.pos, snap.vel, valid_cur, snap.center, mass=snap.mass,
            bulk_vel=snap.bulk_vel, box_size=box_size,
            hubble_drag=snap.hubble_drag, soa=soa_batch,
        )
        iota = torch.arange(p, dtype=torch.int32,
                            device=snap.ids.device).expand(h, p)
        cur_slot = iota if snap.slot is None else snap.slot
        cur_key = to_i32_bits((snap.ids.to(torch.int64) << 1) | 1)
        cur_sv = cur_slot | (_vr_bits(frame.vrad) << 24)
        # a continuing tenant carries its state; elsewhere FRESH makes the
        # kernel ignore the stale prev planes
        prev_sv = torch.where(
            snap.ids == carry.ids,
            carry.slot | ((carry.vrb & 3).to(torch.int32) << 24),
            torch.full((), 1 << 27, dtype=torch.int32,
                       device=snap.ids.device))
        rh = frame.rhat
        packed, evk, evsv, evang, count = fused_static_detect(
            (to_i32_bits(carry.ids.to(torch.int64) << 1), prev_sv,
             carry.rhat[0], carry.rhat[1], carry.rhat[2], carry.angles),
            (cur_key, cur_sv, rh[0], rh[1], rh[2]),
            pericentric, invalid, min(K, p))
        match_o, ang_o = _decode_packed_angles(packed)
        new_carry = _carry_from_channels(cur_key, cur_sv, rh[0], rh[1],
                                         rh[2], ang_o, match_o, id_dt)
        ev_ids, ev_angles, ev_slots = _finish_events(
            count, (evk >> 1) & 0x7FFFFFFF, evsv & 0x00FFFFFF, evang, K,
            invalid, id_dt, id_order=events_id_order)
        return new_carry, CompactEvents(
            count=count, ids=ev_ids, angles=ev_angles,
            bulk_vel=frame.bulk_vel, slots=ev_slots)

    return step


# ----------------------------------------------------------------------
# the sorted engine
# ----------------------------------------------------------------------

def init_sorted_carry(n_halos: int, capacity: int, id_dtype=np.int32,
                      angle_dtype=np.float32, pos_dtype=np.float32,
                      device="cuda") -> SortedCarry:
    """All-invalid carry (every halo behaves as 'no progenitor yet') on
    ``device``, CUDA by default (RuntimeError without it)."""
    device = resolve_device(device, "init_sorted_carry")
    shape = (n_halos, capacity)
    return SortedCarry(
        ids=torch.full(shape, invalid_id_for(id_dtype),
                       dtype=torch_dtype(id_dtype), device=device),
        slot=torch.arange(capacity, dtype=torch.int32,
                          device=device).expand(shape).contiguous(),
        vrb=torch.zeros(shape, dtype=torch.uint8, device=device),
        rhat=torch.zeros((3,) + shape, dtype=torch_dtype(pos_dtype),
                         device=device),
        angles=torch.zeros(shape, dtype=torch_dtype(angle_dtype),
                           device=device),
    )


def sorted_carry_from_numpy(ids, slot, vrb, rhat, angles,
                            device="cuda") -> SortedCarry:
    """A :class:`SortedCarry` on ``device`` (CUDA by default) from the
    JAX carry's fields as host arrays; bit-preserving."""
    device = resolve_device(device, "sorted_carry_from_numpy")

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    return SortedCarry(ids=t(ids), slot=t(np.asarray(slot, np.int32)),
                       vrb=t(np.asarray(vrb, np.uint8)), rhat=t(rhat),
                       angles=t(angles))


def sorted_carry_to_numpy(carry: SortedCarry) -> SortedCarry:
    """The carry's fields as host arrays in the JAX carry's dtypes;
    bit-preserving."""
    return SortedCarry(*(x.cpu().numpy() for x in carry))


def presort_snapshot(batch, soa: bool = False):
    """Stage a snapshot batch in ID-sorted row layout on the host.

    Sorts each halo row ascending by particle ID (the padding sentinel,
    the dtype max, last) and records the load-order slots in
    ``batch.slot``, for ``make_sorted_orbit_step(..., cur_presorted=
    True)``.  ``batch`` is a :class:`~orbitanalysis_tpu_torch.ops.apsis.
    SnapshotBatch` of NumPy arrays, ``[H, P]`` or stacked ``[S, H, P]``;
    the result holds NumPy arrays too.  ``soa=True`` also stages
    ``pos``/``vel`` as ``[3, H, P]`` (stacked: ``[S, 3, H, P]``) for
    ``soa_batch=True``.
    """
    ids = np.asarray(batch.ids)
    order = np.argsort(ids, axis=-1, kind="stable").astype(np.int32)

    def take(x):
        return np.take_along_axis(np.asarray(x), order, axis=-1)

    def take3(x):
        out = np.take_along_axis(np.asarray(x), order[..., None], axis=-2)
        if soa:
            out = np.ascontiguousarray(np.moveaxis(out, -1, out.ndim - 3))
        return out

    slot = order if batch.slot is None else take(batch.slot)
    return batch._replace(
        ids=take(ids),
        pos=take3(batch.pos),
        vel=take3(batch.vel),
        mass=None if batch.mass is None else take(batch.mass),
        slot=slot,
    )


def _shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """Value at the left neighbour (index i-1) along the last axis."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _shift_left(x: torch.Tensor, fill) -> torch.Tensor:
    """Value at the right neighbour (index i+1) along the last axis."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def _decode_packed_angles(packed: torch.Tensor):
    """Split the packed carry channel, the bit layout shared by the
    kernels and the compaction path: f32 angle in bits 0-30 (angles are
    non-negative), match flag in bit 31.  Returns ``(match uint8,
    angle f32)``."""
    match = ((packed >> 31) & 1).to(torch.uint8)
    return match, (packed & 0x7FFFFFFF).view(torch.float32)


def _carry_from_channels(key_asc, sv_asc, rx, ry, rz, angles, match,
                         id_dt) -> SortedCarry:
    """The next carry from ID-ascending channels (packed key ``id << 1 |
    side``; sv = ``slot | vrb << 24``)."""
    return SortedCarry(
        ids=((key_asc >> 1) & 0x7FFFFFFF).to(id_dt),
        slot=sv_asc & 0x00FFFFFF,
        vrb=((sv_asc >> 24) & 0xFF).to(torch.uint8) | (match << 2),
        rhat=torch.stack([rx, ry, rz]),
        angles=angles,
    )


def _finish_events(count, ev_ids, ev_slot, ev_ang, K, invalid, id_dt,
                   id_order):
    """Mask compacted event channels past each row's count, then keep ID
    order (slots alongside; the host restores reference order) or sort
    by slot on the device.  Returns ``(ids, angles, slots_or_None)``."""
    h, k128 = ev_ids.shape
    kiota = torch.arange(k128, device=ev_ids.device)
    ev_ok = kiota[None, :] < count[:, None]
    ids_raw = torch.where(ev_ok, ev_ids.to(id_dt),
                          torch.full_like(ev_ids, invalid, dtype=id_dt))
    ang_raw = torch.where(ev_ok, ev_ang, torch.zeros_like(ev_ang))
    if id_order:
        return (ids_raw[:, :K], ang_raw[:, :K],
                torch.where(ev_ok, ev_slot, -1)[:, :K])
    key = torch.where(ev_ok, ev_slot, _DEAD_KEY)
    order = torch.sort(key, dim=-1, stable=True).indices
    return (torch.gather(ids_raw, 1, order)[:, :K],
            torch.gather(ang_raw, 1, order)[:, :K], None)


def _sort_rows(keys, *chans):
    """Stable row sort of ``chans`` by ``keys`` (one int64 key or a
    tuple of keys, primary first)."""
    if not isinstance(keys, tuple):
        keys = (keys,)
    order = None
    for k in reversed(keys):  # least significant key first
        kk = k if order is None else torch.gather(k, 1, order)
        o = torch.sort(kk, dim=1, stable=True).indices
        order = o if order is None else torch.gather(order, 1, o)
    return tuple(torch.gather(c, 1, order) for c in chans)


def _static_detect(prev_ops, cur_asc, pericentric, invalid, k_eff):
    """The fused path's static-membership branch: the carry's ID layout
    equals the staged snapshot's, so matched pairs share a position and
    detection is elementwise (plain torch, as the JAX package runs it in
    XLA); the events go through the three-stream compaction (K18)."""
    _, psv, prx, pry, prz, pang = prev_ops
    ck, csv, crx, cry, crz = cur_asc
    valid = ((ck >> 1) & 0x7FFFFFFF) != invalid
    vrb_p = (psv >> 24) & 0xFF
    vrb_c = (csv >> 24) & 0xFF
    cosang = torch.clamp(prx * crx + pry * cry + prz * crz, -1.0, 1.0)
    zero = torch.zeros_like(cosang)
    dth = torch.where(valid, _acos_f32(cosang), zero)
    if pericentric:
        flp = ((vrb_p & 1) > 0) & ((vrb_c & 2) > 0)
    else:
        flp = ((vrb_p & 2) > 0) & ((vrb_c & 1) > 0)
    aps = valid & flp
    acc = pang + dth
    bit31 = torch.tensor(_BIT31, dtype=torch.int32, device=ck.device)
    nil = torch.zeros((), dtype=torch.int32, device=ck.device)
    pck = torch.where(aps | ~valid, zero, acc).view(torch.int32) | \
        torch.where(valid, bit31, nil)
    evp_in = torch.where(aps, acc, zero).view(torch.int32) | \
        torch.where(aps, bit31, nil)
    cnt = aps.sum(dim=-1, dtype=torch.int32)
    ek, es, ep = compact_events(evp_in, ck, psv, k_eff)
    return pck, ek, es, (ep & 0x7FFFFFFF).view(torch.float32), cnt


def make_sorted_orbit_step(
    event_capacity: int,
    mode: str = "pericentric",
    box_size=None,
    id_dtype=np.int32,
    angle_dtype=np.float32,
    merge_impl: str = "lax_sort",
    compact_impl: str = "lax_sort",
    cur_presorted: bool = False,
    fused: bool = False,
    events_id_order: bool = False,
    soa_batch: bool = False,
):
    """The sorted-carry step: ``step(carry, snap) -> (SortedCarry,
    CompactEvents)``, the JAX package's options and errors.

    ``snap`` is a :class:`~orbitanalysis_tpu_torch.ops.apsis.
    SnapshotBatch` of tensors on the carry's device.  ``merge_impl``:
    ``'lax_sort'`` merges prev and cur with one stable sort of the
    concatenation (plain torch); ``'pallas'`` sorts the cur side alone
    and merges with the merge kernel (K15).  ``compact_impl``:
    ``'lax_sort'`` extracts the next carry and the events with one sort
    (plain torch); ``'pallas'`` with the two-group compaction (K19) and a
    small ``[H, K]`` sort.  ``cur_presorted=True`` declares rows staged
    ID-sorted with their load slots in ``snap.slot``
    (:func:`presort_snapshot`).  ``fused=True`` runs the join-and-detect
    kernel (K16) and implies both ``'pallas'`` impls; with
    ``cur_presorted`` each step first tests on the device whether the
    staged IDs equal the carry's and then runs the static branch (plain
    detect chain and K18) instead.  The port reads that one flag on the
    host, where the JAX package branches with ``lax.cond`` on the
    device: a synchronisation each step.  ``events_id_order=True``
    (fused only) returns the events in ID order with their previous load
    slots in ``CompactEvents.slots``.  On the fused path the event
    tensors are ``min(K, P)`` wide.  ``soa_batch=True``: ``pos``/``vel``
    arrive as ``[3, H, P]``.  The unfused paths detect with torch's
    ``acos`` (the JAX package's XLA ``arccos``), the fused ones with the
    kernels' Cephes arccos.
    """
    if mode not in ("pericentric", "apocentric"):
        raise ValueError(
            "Orbit detection mode not recognized. Please specify either "
            "'pericentric' or 'apocentric'."
        )
    if merge_impl not in ("lax_sort", "pallas"):
        raise ValueError(f"unknown merge_impl: {merge_impl!r}")
    if compact_impl not in ("lax_sort", "pallas"):
        raise ValueError(f"unknown compact_impl: {compact_impl!r}")
    if fused:
        merge_impl = compact_impl = "pallas"
    if events_id_order and not fused:
        raise ValueError("events_id_order requires fused=True")
    if compact_impl == "pallas" and np.dtype(angle_dtype) != np.float32:
        raise ValueError(
            "compact_impl='pallas' packs the match bit into the f32 "
            "angle sign bit; use angle_dtype=float32"
        )
    id_np = np.dtype(id_dtype)
    if compact_impl == "pallas" and id_np.itemsize != 4:
        raise ValueError("compact_impl='pallas' requires 32-bit particle IDs")
    # single-key packing (id << 1 | side) needs ids < 2**31: signed ids
    # of at most 32 bits (the sentinel is the dtype max)
    pack_key = id_np.itemsize <= 4 and np.issubdtype(id_np,
                                                     np.signedinteger)
    if merge_impl == "pallas" and not pack_key:
        raise ValueError(
            "merge_impl='pallas' requires <=32-bit signed particle IDs "
            "(single packed uint32 sort key); use merge_impl='lax_sort'"
        )
    # step.py imports this module
    from orbitanalysis_tpu_torch.ops.step import fused_join_detect

    pericentric = mode == "pericentric"
    invalid = invalid_id_for(id_dtype)
    id_dt = torch_dtype(id_dtype)
    ang_dt = torch_dtype(angle_dtype)
    K = int(event_capacity)

    def flip(chans):
        return tuple(torch.flip(x, dims=(1,)) for x in chans)

    def step(carry: SortedCarry, snap):
        h, p = snap.ids.shape
        dev = snap.ids.device
        valid_cur = snap.ids != invalid
        frame = region_frame(
            snap.pos, snap.vel, valid_cur, snap.center, mass=snap.mass,
            bulk_vel=snap.bulk_vel, box_size=box_size,
            hubble_drag=snap.hubble_drag, soa=soa_batch,
        )
        iota = torch.arange(p, dtype=torch.int32, device=dev).expand(h, p)
        cur_vrb = _vr_bits(frame.vrad)
        cur_slot = iota if snap.slot is None else snap.slot
        # slot and the 3 v_r sign/match bits share one int32 channel
        prev_sv = carry.slot | (carry.vrb.to(torch.int32) << 24)
        cur_sv = cur_slot | (cur_vrb << 24)
        rh = frame.rhat

        if merge_impl == "pallas":
            cur_key = to_i32_bits((snap.ids.to(torch.int64) << 1) | 1)
            prev_key = to_i32_bits(carry.ids.to(torch.int64) << 1)
            cur_asc = (cur_key, cur_sv, rh[0], rh[1], rh[2])
            if cur_presorted:
                cur_ops = None if fused else flip(cur_asc)
            else:
                cur_ops = sort_descending_u32(*cur_asc)
            if fused:
                prev_ops6 = (prev_key, prev_sv, carry.rhat[0],
                             carry.rhat[1], carry.rhat[2], carry.angles)
                k_eff = min(K, p)  # events <= P
                if cur_presorted and bool(
                        torch.all((prev_key | 1) == cur_key)):
                    # static membership: the host reads the flag the
                    # JAX package's lax.cond branches on
                    packed, evk, evsv, evang, count = _static_detect(
                        prev_ops6, cur_asc, pericentric, invalid, k_eff)
                    asc = cur_asc
                else:
                    if cur_presorted:
                        cur_ops = flip(cur_asc)
                    packed, evk, evsv, evang, count = fused_join_detect(
                        prev_ops6, cur_ops, pericentric, invalid, k_eff)
                    # the packed plane follows the staged (descending)
                    # cur order
                    packed = torch.flip(packed, dims=(1,))
                    asc = cur_asc if cur_presorted else flip(cur_ops)
                match_o, ang_o = _decode_packed_angles(packed)
                new_carry = _carry_from_channels(*asc, ang_o, match_o,
                                                 id_dt)
                ev_ids, ev_angles, ev_slots = _finish_events(
                    count, (evk >> 1) & 0x7FFFFFFF, evsv & 0x00FFFFFF,
                    evang, K, invalid, id_dt, id_order=events_id_order)
                return new_carry, CompactEvents(
                    count=count, ids=ev_ids, angles=ev_angles,
                    bulk_vel=frame.bulk_vel, slots=ev_slots)
            zeros_ang = torch.zeros((h, p), dtype=ang_dt, device=dev)
            k_s, sv_s, rx_s, ry_s, rz_s, ang_s = merge_rows(
                (prev_key, prev_sv, carry.rhat[0], carry.rhat[1],
                 carry.rhat[2], carry.angles),
                cur_ops + (zeros_ang,))
            is_cur = (k_s & 1) == 1
            ids_s = ((k_s >> 1) & 0x7FFFFFFF).to(id_dt)
        else:
            def cat(a, b):
                return torch.cat([a, b], dim=1)

            payload = (cat(prev_sv, cur_sv), cat(carry.rhat[0], rh[0]),
                       cat(carry.rhat[1], rh[1]), cat(carry.rhat[2], rh[2]),
                       cat(carry.angles,
                           torch.zeros((h, p), dtype=ang_dt, device=dev)))
            if pack_key:
                keys = cat(
                    to_i32_bits(carry.ids.to(torch.int64) << 1),
                    to_i32_bits((snap.ids.to(torch.int64) << 1) | 1))
                k_s, sv_s, rx_s, ry_s, rz_s, ang_s = _sort_rows(
                    u32_order(keys), keys, *payload)
                is_cur = (k_s & 1) == 1
                ids_s = ((k_s >> 1) & 0x7FFFFFFF).to(id_dt)
            else:
                ids_cat = cat(carry.ids, snap.ids)
                side = cat(torch.zeros((h, p), dtype=torch.int64,
                                       device=dev),
                           torch.ones((h, p), dtype=torch.int64,
                                      device=dev))
                ids_s, side_s, sv_s, rx_s, ry_s, rz_s, ang_s = _sort_rows(
                    (ids_cat.to(torch.int64), side), ids_cat, side,
                    *payload)
                is_cur = side_s == 1
        slot_s = sv_s & 0x00FFFFFF
        vrb_s = (sv_s >> 24) & 0xFF

        # ---- detection in the merged domain (matched pairs adjacent,
        # prev first)
        valid_key = ids_s != invalid
        left_is_prev = ~_shift_right(is_cur, True)
        match_cur = (is_cur & left_is_prev & valid_key
                     & (ids_s == _shift_right(ids_s, invalid)))
        vrb_l = _shift_right(vrb_s, 0)
        rx_l, ry_l, rz_l = (_shift_right(x, 0.0) for x in (rx_s, ry_s, rz_s))
        ang_l = _shift_right(ang_s, 0.0)
        cosang = torch.clamp(rx_l * rx_s + ry_l * ry_s + rz_l * rz_s,
                             -1.0, 1.0)
        dtheta = torch.where(match_cur, torch.acos(cosang),
                             torch.zeros_like(cosang))
        if pericentric:
            flip_ = ((vrb_l & 1) > 0) & ((vrb_s & 2) > 0)
        else:
            flip_ = ((vrb_l & 2) > 0) & ((vrb_s & 1) > 0)
        apsis = match_cur & flip_
        angle_acc = ang_l + dtheta.to(ang_dt)
        zero = torch.zeros_like(angle_acc)
        apsis_angle = torch.where(apsis, angle_acc, zero)
        angle_new = torch.where(apsis | ~match_cur, zero, angle_acc)
        # the event rides to its prev partner (one position left), which
        # holds the load slot that orders the events
        apsis_prev = _shift_left(apsis, False)
        ev_angle_prev = _shift_left(apsis_angle, 0.0)
        count = apsis.sum(dim=-1, dtype=torch.int32)

        if compact_impl == "pallas":
            # the match flag rides the angle's sign bit, so the carry
            # extraction is a single-channel compaction
            packed = angle_new.view(torch.int32) | torch.where(
                match_cur, _BIT31, 0).to(torch.int32)
            k128 = ((K + 127) // 128) * 128
            if merge_impl == "pallas":
                ops_a = (packed,)
            else:
                ops_a = (k_s, sv_s, rx_s, ry_s, rz_s, packed)
            a_out, (ev_id, ev_slot, ev_ang) = compact_rows(
                is_cur.to(torch.int32), ops_a, p,
                apsis_prev.to(torch.int32),
                (ids_s, slot_s, ev_angle_prev), k128)
            match_o, ang_o = _decode_packed_angles(a_out[-1])
            if merge_impl == "pallas":
                asc = cur_asc if cur_presorted else flip(cur_ops)
                carry_chans = asc
            else:
                carry_chans = a_out[:5]
            new_carry = _carry_from_channels(*carry_chans, ang_o, match_o,
                                             id_dt)
            ev_ids, ev_angles, _ = _finish_events(
                count, ev_id, ev_slot, ev_ang, K, invalid, id_dt,
                id_order=False)
        else:
            # one stable sort: the next carry to the front (in ID
            # order), the events next (in prev load-slot order), dead
            # entries last
            key_b = torch.where(
                is_cur, 0, torch.where(apsis_prev, 1 + slot_s, _DEAD_KEY))
            angle_b = torch.where(is_cur, angle_new, ev_angle_prev)
            sv_b = slot_s | ((vrb_s | (match_cur.to(torch.int32) << 2))
                             << 24)
            ids_o, sv_o, rx_o, ry_o, rz_o, ang_o = _sort_rows(
                key_b.to(torch.int64), ids_s, sv_b, rx_s, ry_s, rz_s,
                angle_b)
            new_carry = SortedCarry(
                ids=ids_o[:, :p].contiguous(),
                slot=sv_o[:, :p] & 0x00FFFFFF,
                vrb=((sv_o[:, :p] >> 24) & 0xFF).to(torch.uint8),
                rhat=torch.stack([rx_o[:, :p], ry_o[:, :p], rz_o[:, :p]]),
                angles=ang_o[:, :p].contiguous(),
            )
            ev_ids = ids_o[:, p:p + K]
            ev_angles = ang_o[:, p:p + K]
        return new_carry, CompactEvents(count=count, ids=ev_ids,
                                        angles=ev_angles,
                                        bulk_vel=frame.bulk_vel)

    return step
