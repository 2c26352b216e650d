"""The detect-and-compact kernels of the sorted and aligned steps (twin
of ``orbitanalysis_tpu/ops/pallas_step.py``: ``fused_join_detect``, K16,
and ``fused_static_detect``, K17).

- :func:`fused_join_detect` joins the carry (``prev``, keys ascending)
  with the staged snapshot (``cur``, keys descending), detects apsides
  on the matched pairs, routes every result back to its source position
  and compacts the events in prev (ID) order.  On CUDA tensors it
  launches the hand-written kernel ``fused_join_detect`` of
  ``csrc/merge.cu`` (one launch: merge-path tiles of the merged row,
  the events placed by a decoupled look-back); on CPU tensors it runs
  :func:`fused_join_detect_torch`, the JAX kernel's merged-domain
  formulation (a sort of the concatenation, neighbour shifts, the
  inverse permutation back), so the two check each other's design.
- :func:`fused_static_detect` detects on aligned rows (a matched pair
  shares a position, so no merge) and compacts the events in position
  order: the aligned engine's ``detect_impl='pallas'`` (``native=True``)
  and the legacy select-staged step.  On CUDA tensors it launches
  ``static_detect_rows`` of ``csrc/static.cu``; on CPU tensors it runs
  :func:`fused_static_detect_torch`.
"""

from __future__ import annotations

import torch

from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.ops.compact import (
    _front_pack,
    _k128,
    compact_events_torch,
)
from orbitanalysis_tpu_torch.ops.merge import u32_order
from orbitanalysis_tpu_torch.ops.sorted_step import (
    _BIT31,
    _acos_f32,
    _shift_left,
    _shift_right,
)

_LANES = 128


def _check(prev_ops, cur_ops):
    """The JAX kernels' contract for K16 and K17: power-of-two rows of at
    least 128 lanes (K16's bitonic merge network; the TPU's lane tiles),
    6 prev and 5 cur planes.  Returns ``(H, P)``."""
    h, p = prev_ops[0].shape
    if p % _LANES or (p & (p - 1)):
        raise ValueError(
            f"row length must be a power of two >= {_LANES}; got {p} — "
            "pad with round_up_pow2"
        )
    if len(prev_ops) != 6 or len(cur_ops) != 5:
        raise ValueError("want (key, sv, rx, ry, rz, angles) prev planes "
                         "and (key, sv, rx, ry, rz) cur planes")
    return h, p


def fused_join_detect_torch(prev_ops, cur_ops, pericentric: bool,
                            invalid_id: int, event_capacity: int):
    """Plain-torch twin of the join-and-detect kernel, in the JAX
    kernel's merged domain: ``prev_ops = (key asc, sv, rx, ry, rz,
    angles)``, ``cur_ops = (key DESC, sv, rx, ry, rz)``, ``[H, P]``.

    Returns ``(packed, ev_key, ev_sv, ev_angle, count)``: ``packed
    [H, P]`` int32 words ``f32_bits(angle_new) | match << 31`` in the
    staged (descending) cur order; ``ev_*`` ``[H, k128]`` the events in
    prev order (prev key, prev sv, f32 angle), zero past each row's
    count; ``count [H]`` the exact apsides a row.
    """
    h, p = _check(prev_ops, cur_ops)
    pk, psv, prx, pry, prz, pang = prev_ops
    ck, csv, crx, cry, crz = cur_ops
    cat_key = torch.cat([pk, ck], dim=1)
    order = torch.sort(u32_order(cat_key), dim=1, stable=True).indices

    def merged(a, b):
        return torch.gather(torch.cat([a, b], dim=1), 1, order)

    key = torch.gather(cat_key, 1, order)
    sv = merged(psv, csv)
    rx, ry, rz = merged(prx, crx), merged(pry, cry), merged(prz, crz)
    ang = merged(pang, torch.zeros_like(pang))

    is_cur = (key & 1) == 1
    ids = (key >> 1) & 0x7FFFFFFF
    valid = ids != invalid_id
    key_l = _shift_right(key, 0)
    first = torch.zeros_like(is_cur)
    first[:, 0] = True
    match = (is_cur & ((key_l & 1) == 0) & valid
             & (ids == ((key_l >> 1) & 0x7FFFFFFF)) & ~first)
    vrb = (sv >> 24) & 0xFF
    vrb_l = _shift_right(vrb, 0)
    rx_l, ry_l, rz_l = (_shift_right(x, 0.0) for x in (rx, ry, rz))
    ang_l = _shift_right(ang, 0.0)
    cosang = torch.clamp(rx_l * rx + ry_l * ry + rz_l * rz, -1.0, 1.0)
    zero = torch.zeros_like(cosang)
    dtheta = torch.where(match, _acos_f32(cosang), zero)
    if pericentric:
        flip = ((vrb_l & 1) > 0) & ((vrb & 2) > 0)
    else:
        flip = ((vrb_l & 2) > 0) & ((vrb & 1) > 0)
    apsis = match & flip
    angle_acc = ang_l + dtheta
    apsis_angle = torch.where(apsis, angle_acc, zero)
    angle_new = torch.where(apsis | ~match, zero, angle_acc)
    count = apsis.sum(dim=-1, dtype=torch.int32)

    # the event rides to its prev partner (one position left); one
    # combined channel goes back through the inverse permutation
    apsis_prev = _shift_left(apsis, False)
    ev_ang = _shift_left(apsis_angle, 0.0)
    bit31 = torch.tensor(_BIT31, dtype=torch.int32, device=key.device)
    nil = torch.zeros((), dtype=torch.int32, device=key.device)
    u = torch.where(
        is_cur,
        angle_new.view(torch.int32) | torch.where(match, bit31, nil),
        ev_ang.view(torch.int32) | torch.where(apsis_prev, bit31, nil))
    back = torch.empty_like(u).scatter_(1, order, u)
    packed, evp = back[:, p:], back[:, :p]
    ev_key, ev_sv, ev_ang_w = _front_pack(
        evp < 0, [pk, psv, evp & 0x7FFFFFFF], _k128(event_capacity, p))
    return (packed.contiguous(), ev_key, ev_sv,
            ev_ang_w.view(torch.float32), count)


def fused_join_detect(prev_ops, cur_ops, pericentric: bool, invalid_id: int,
                      event_capacity: int):
    """Join, detect and compact in one call (K16): the CUDA kernel on
    CUDA tensors, :func:`fused_join_detect_torch` on CPU tensors; the
    same arguments and outputs."""
    if not prev_ops[0].is_cuda:
        return fused_join_detect_torch(prev_ops, cur_ops, pericentric,
                                       invalid_id, event_capacity)
    h, p = _check(prev_ops, cur_ops)
    return _cuda.fused_join_detect(tuple(prev_ops), tuple(cur_ops),
                                   pericentric, invalid_id,
                                   _k128(event_capacity, p))


def fused_static_detect_torch(prev_ops, cur_asc_ops, pericentric: bool,
                              invalid_id: int, event_capacity: int,
                              native: bool = False):
    """Plain-torch twin of the aligned detect kernel: ``prev_ops = (key,
    sv, rx, ry, rz, angles)``, ``cur_asc_ops = (key, sv, rx, ry, rz)``,
    aligned ``[H, P]`` planes.  The prev key is never read: validity and
    the event key come from the cur key.  FRESH (the position's tenant
    changed: no flip fires and the angle restarts at 0) is bit 27 of the
    prev sv, or with ``native`` bit 27 of the cur sv, where the prev
    angles are the packed carry words (f32 angle bits 0-30, match flag
    bit 31) instead of float32.

    Returns ``(packed, ev_key, ev_sv, ev_angle, count)``: ``packed
    [H, P]`` int32 words ``f32_bits(angle_new) | (valid & ~fresh) <<
    31``; ``ev_*`` ``[H, k128]`` the events in position order (cur key,
    PREV sv, f32 angle), zero past each row's count; ``count [H]`` the
    exact apsides a row.
    """
    _check(prev_ops, cur_asc_ops)
    _, psv, prx, pry, prz, pang = prev_ops
    ck, csv, crx, cry, crz = cur_asc_ops
    valid = ((ck >> 1) & 0x7FFFFFFF) != invalid_id
    vrb_p = psv >> 24
    vrb_c = csv >> 24
    if native:
        fresh = (vrb_c & 8) > 0
        pang = (pang & 0x7FFFFFFF).view(torch.float32)
    else:
        fresh = (vrb_p & 8) > 0
    cosang = torch.clamp(prx * crx + pry * cry + prz * crz, -1.0, 1.0)
    zero = torch.zeros_like(cosang)
    dtheta = torch.where(valid, _acos_f32(cosang), zero)
    if pericentric:
        flip = ((vrb_p & 1) > 0) & ((vrb_c & 2) > 0)
    else:
        flip = ((vrb_p & 2) > 0) & ((vrb_c & 1) > 0)
    apsis = valid & flip & ~fresh
    angle_acc = torch.where(fresh, zero, pang + dtheta)
    bit31 = torch.tensor(_BIT31, dtype=torch.int32, device=ck.device)
    nil = torch.zeros((), dtype=torch.int32, device=ck.device)
    packed = (torch.where(apsis | ~valid, zero, angle_acc).view(torch.int32)
              | torch.where(valid & ~fresh, bit31, nil))
    evp = torch.where(apsis, angle_acc.view(torch.int32) | bit31, nil)
    ev_key, ev_sv, ev_w = compact_events_torch(evp, ck, psv, event_capacity)
    return (packed, ev_key, ev_sv,
            (ev_w & 0x7FFFFFFF).view(torch.float32),
            apsis.sum(dim=-1, dtype=torch.int32))


def fused_static_detect(prev_ops, cur_asc_ops, pericentric: bool,
                        invalid_id: int, event_capacity: int,
                        native: bool = False):
    """Aligned detection and event compaction in one call (K17): the
    CUDA kernel on CUDA tensors, :func:`fused_static_detect_torch` on
    CPU tensors; the same arguments and outputs."""
    if not prev_ops[0].is_cuda:
        return fused_static_detect_torch(prev_ops, cur_asc_ops, pericentric,
                                         invalid_id, event_capacity, native)
    h, p = _check(prev_ops, cur_asc_ops)
    return _cuda.static_detect_rows(
        tuple(t.contiguous() for t in prev_ops),
        tuple(t.contiguous() for t in cur_asc_ops), pericentric, invalid_id,
        _k128(event_capacity, p), native)
