"""Ordered event compaction (twin of
``orbitanalysis_tpu/ops/pallas_compact.py``): ``compact_angle_blocked``
and ``compact_payload_pair`` for the aligned step, ``compact_payload``
and ``compact_payload_blocked`` for the label-native detector,
``compact_events`` (K18) and ``compact_rows`` (K19) for the sorted
engine's step.

Each entry point launches the hand-written CUDA kernel
(``csrc/compact.cu``, through :mod:`orbitanalysis_tpu_torch.ops._cuda`)
when its input lies on a CUDA device, and its plain-torch twin only
when the input lies on the CPU.  Nothing falls back: a failed build or
launch raises.  The twins are exposed as ``*_torch`` for the tests and
the on-card comparison.

Outputs are ``[H, k128]`` int32 planes holding uint32 words, with
``k128 = min(round_up(event_capacity, 128), P)``: the selected entries
front-packed in position order, and zeros past each row's count (the
JAX kernels leave those entries unspecified).  ``compact_rows`` keeps
each channel's dtype and writes rows of the lengths it is given.
"""

from __future__ import annotations

import torch

from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.utils.numerics import to_i32_bits

_LANES = 128

#: Widest row the single-word positional payload supports: the 17 bits
#: above the 15-bit f16 angle hold ``pos + 1 <= 2**17 - 1``.  Wider rows
#: go through :func:`compact_payload_pair`.
PAYLOAD_MAX_ROW = (1 << 17) - 1


def f16_bits_rne(x: torch.Tensor) -> torch.Tensor:
    """IEEE f32 -> f16 bit pattern (round to nearest even) as int32,
    with integer ops only — bit for bit the JAX package's
    ``pallas_label.f16_bits_rne`` and the CUDA kernel's encode for every
    finite non-negative input, f16 subnormals included.  Values above
    the f16 range (and +inf/NaN) clamp to 0x7BFF (65504) instead of inf,
    so the 15-bit angle field never spills into the position bits.
    Lanes outside that domain still get a defined value: NaN lanes of
    the subnormal branch (negative NaNs) give 0, and negative inputs
    clamp before the integer conversion."""
    u = x.view(torch.int32).to(torch.int64)
    e = u >> 23
    rn = u + 0x0FFF + ((u >> 13) & 1)
    h_norm = torch.clamp((rn - 0x38000000) >> 13, max=0x7BFF)
    s = torch.clamp(x * 16777216.0, min=-2e9, max=2e9)
    h_sub = torch.round(torch.nan_to_num(s, nan=0.0)).to(torch.int64)
    return torch.where(e >= 113, h_norm, h_sub).to(torch.int32)


def _k128(event_capacity: int, p: int) -> int:
    return min(((event_capacity + _LANES - 1) // _LANES) * _LANES, p)


def _check_rows(p: int, single_word: bool):
    if single_word and p > PAYLOAD_MAX_ROW:
        raise ValueError(
            f"single-word positional payloads address at most "
            f"{PAYLOAD_MAX_ROW} row positions (got row length {p}); "
            "use compact_payload_pair"
        )
    if p % _LANES:
        raise ValueError(f"row length must be a multiple of {_LANES}")


def _front_pack(sel: torch.Tensor, chans, k128: int):
    """Entries where ``sel`` holds, front-packed in position order into
    zero-filled ``[H, k128]`` rows (the first ``k128`` of each row)."""
    h, p = sel.shape
    rank = torch.cumsum(sel, dim=1) - 1
    keep = sel & (rank < k128)
    rows = torch.arange(h, device=sel.device)[:, None].expand(h, p)[keep]
    cols = rank[keep]
    outs = []
    for c in chans:
        o = torch.zeros((h, k128), dtype=torch.int32, device=sel.device)
        o[rows, cols] = c[keep]
        outs.append(o)
    return outs


def compact_angle_blocked_torch(aw: torch.Tensor, event_capacity: int):
    """Plain-torch twin of the angle-word compaction kernel: ``aw [H, P]``
    int32 words ``f32_bits(angle) | apsis << 31`` -> ``[H, k128]``
    payload words ``((pos + 1) << 15) | f16_rne(angle)``."""
    h, p = aw.shape
    _check_rows(p, single_word=True)
    sel = ((aw >> 31) & 1).bool()
    ang15 = f16_bits_rne((aw & 0x7FFFFFFF).view(torch.float32)) & 0x7FFF
    pos1 = torch.arange(1, p + 1, dtype=torch.int64, device=aw.device)
    payload = to_i32_bits((pos1 << 15) | ang15.to(torch.int64))
    (out,) = _front_pack(sel, [payload], _k128(event_capacity, p))
    return out


def compact_payload_pair_torch(posw: torch.Tensor, angw: torch.Tensor,
                               event_capacity: int):
    """Plain-torch twin of the two-stream compaction kernel: events where
    ``posw != 0``; returns ``(ev_pos_word, ev_ang_word)``."""
    h, p = posw.shape
    _check_rows(p, single_word=False)
    out_pos, out_ang = _front_pack(posw != 0, [posw, angw],
                                   _k128(event_capacity, p))
    return out_pos, out_ang


def compact_payload_torch(payload: torch.Tensor, event_capacity: int):
    """Plain-torch twin of the payload compaction kernel: prebuilt
    payload words ``((pos + 1) << 15) | f16(angle)`` ``[H, P]`` -> the
    events (any word >= 2**15 as uint32) front-packed in position order
    into ``[H, k128]``, zeros past each row's count."""
    h, p = payload.shape
    _check_rows(p, single_word=True)
    (out,) = _front_pack((payload >> 15) != 0, [payload],
                         _k128(event_capacity, p))
    return out


def compact_events_torch(packed: torch.Tensor, key: torch.Tensor,
                         sv: torch.Tensor, event_capacity: int):
    """Plain-torch twin of the three-stream event compaction: where bit
    31 of ``packed [H, P]`` is set, ``(key, sv, packed)`` front-packed in
    position order into ``[H, k128]`` rows; returns ``(evk, evsv,
    evpacked)``."""
    h, p = packed.shape
    _check_rows(p, single_word=False)
    return tuple(_front_pack(packed < 0, [key, sv, packed],
                             _k128(event_capacity, p)))


def _check_groups(sel_a, ops_a, len_a, ops_b, len_b):
    h, p = sel_a.shape
    if p % _LANES or len_a % _LANES or len_b % _LANES:
        raise ValueError(
            f"row/output lengths must be multiples of {_LANES}")
    for x in (*ops_a, *ops_b):
        if x.element_size() != 4:
            raise TypeError("compaction channels must be 32-bit dtypes")


def _pack_group(sel, ops, length):
    """One group of :func:`compact_rows_torch`: each channel viewed as
    int32 bits, front-packed, and viewed back."""
    h, n = sel.shape
    width = min(length, n)
    bits = [x.view(torch.int32) for x in ops]
    packed = _front_pack(sel != 0, bits, width)
    out = []
    for x, o in zip(ops, packed):
        if width < length:
            o = torch.cat([o, o.new_zeros((h, length - width))], dim=1)
        out.append(o.view(x.dtype))
    return tuple(out)


def compact_rows_torch(sel_a, ops_a, len_a: int, sel_b, ops_b, len_b: int):
    """Plain-torch twin of the stable two-group compaction: ``sel_*``
    ``[H, N]`` 0/1 masks, ``ops_*`` tuples of ``[H, N]`` 32-bit planes;
    returns ``(tuple_a [H, len_a], tuple_b [H, len_b])``, the selected
    entries front-packed in order and zeros past each row's count."""
    _check_groups(sel_a, ops_a, len_a, ops_b, len_b)
    return (_pack_group(sel_a, ops_a, len_a),
            _pack_group(sel_b, ops_b, len_b))


def compact_angle_blocked(aw: torch.Tensor, event_capacity: int):
    """The aligned step's event compaction for rows up to
    :data:`PAYLOAD_MAX_ROW`: the CUDA kernel ``compact_angle_rows`` on a
    CUDA tensor, :func:`compact_angle_blocked_torch` on a CPU tensor."""
    if _cuda.on_cpu(aw, "compaction"):
        return compact_angle_blocked_torch(aw, event_capacity)
    h, p = aw.shape
    _check_rows(p, single_word=True)
    return _cuda.compact_angle_rows(aw, _k128(event_capacity, p))


def compact_payload_pair(posw: torch.Tensor, angw: torch.Tensor,
                         event_capacity: int):
    """Two-stream compaction for rows wider than :data:`PAYLOAD_MAX_ROW`:
    the CUDA kernel ``compact_pair_rows`` on CUDA tensors,
    :func:`compact_payload_pair_torch` on CPU tensors."""
    if _cuda.on_cpu(posw, "compaction"):
        return compact_payload_pair_torch(posw, angw, event_capacity)
    h, p = posw.shape
    _check_rows(p, single_word=False)
    return _cuda.compact_pair_rows(posw, angw, _k128(event_capacity, p))


def compact_payload(payload: torch.Tensor, event_capacity: int):
    """The label-native detector's single-stream payload compaction
    (K4): the CUDA kernel ``compact_payload_rows`` on a CUDA tensor,
    :func:`compact_payload_torch` on a CPU tensor."""
    if _cuda.on_cpu(payload, "compaction"):
        return compact_payload_torch(payload, event_capacity)
    h, p = payload.shape
    _check_rows(p, single_word=True)
    return _cuda.compact_payload_rows(payload, _k128(event_capacity, p))


def compact_payload_blocked(payload: torch.Tensor, event_capacity: int):
    """The JAX package's blocked form of :func:`compact_payload` (K5),
    same contract.  Its per-block cap and overflow reroute were a
    TPU workaround; here it launches the same exact kernel."""
    return compact_payload(payload, event_capacity)


def compact_events(packed: torch.Tensor, key: torch.Tensor,
                   sv: torch.Tensor, event_capacity: int):
    """The sorted step's static-branch event compaction (K18): the CUDA
    kernel ``compact_events_rows`` on CUDA tensors,
    :func:`compact_events_torch` on CPU tensors.  ``packed``: ``[H, P]``
    words ``f32_bits(angle) | apsis << 31``; ``key``/``sv``: the event
    payloads.  Returns ``(evk, evsv, evpacked)``, each ``[H, k128]``."""
    if _cuda.on_cpu(packed, "compaction"):
        return compact_events_torch(packed, key, sv, event_capacity)
    h, p = packed.shape
    _check_rows(p, single_word=False)
    return _cuda.compact_events_rows(packed, key, sv,
                                     _k128(event_capacity, p))


def compact_rows(sel_a, ops_a, len_a: int, sel_b, ops_b, len_b: int):
    """Stable two-group compaction of ``[H, N]`` rows (K19), the sorted
    step's ``compact_impl='pallas'``: the CUDA kernel
    ``compact_rows_groups`` on CUDA tensors, :func:`compact_rows_torch`
    on CPU tensors.  ``sel_*`` are int32 0/1 masks, ``ops_*`` tuples of
    ``[H, N]`` 32-bit planes; returns ``(tuple_a [H, len_a], tuple_b
    [H, len_b])``."""
    if _cuda.on_cpu(sel_a, "compaction"):
        return compact_rows_torch(sel_a, ops_a, len_a, sel_b, ops_b, len_b)
    _check_groups(sel_a, ops_a, len_a, ops_b, len_b)
    return _cuda.compact_rows_groups(sel_a, tuple(ops_a), len_a, sel_b,
                                     tuple(ops_b), len_b)
