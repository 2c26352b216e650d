"""Ordered event compaction (twin of
``orbitanalysis_tpu/ops/pallas_compact.py``): ``compact_angle_blocked``
and ``compact_payload_pair`` for the aligned step, ``compact_payload``
and ``compact_payload_blocked`` for the label-native detector.

Each entry point launches the hand-written CUDA kernel
(``csrc/compact.cu``, through :mod:`orbitanalysis_tpu_torch.ops._cuda`)
when its input lies on a CUDA device, and its plain-torch twin only
when the input lies on the CPU.  Nothing falls back: a failed build or
launch raises.  The twins are exposed as ``*_torch`` for the tests and
the on-card comparison.

Outputs are ``[H, k128]`` int32 planes holding uint32 words, with
``k128 = min(round_up(event_capacity, 128), P)``: the selected entries
front-packed in position order, and zeros past each row's count (the
JAX kernels leave those entries unspecified).
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


def _route(x: torch.Tensor) -> str:
    if x.is_cuda:
        return "cuda"
    if x.device.type == "cpu":
        return "cpu"
    raise ValueError(f"no compaction kernel for device {x.device}")


def compact_angle_blocked(aw: torch.Tensor, event_capacity: int):
    """The aligned step's event compaction for rows up to
    :data:`PAYLOAD_MAX_ROW`: the CUDA kernel ``compact_angle_rows`` on a
    CUDA tensor, :func:`compact_angle_blocked_torch` on a CPU tensor."""
    if _route(aw) == "cpu":
        return compact_angle_blocked_torch(aw, event_capacity)
    h, p = aw.shape
    _check_rows(p, single_word=True)
    return _cuda.compact_angle_rows(aw, _k128(event_capacity, p))


def compact_payload_pair(posw: torch.Tensor, angw: torch.Tensor,
                         event_capacity: int):
    """Two-stream compaction for rows wider than :data:`PAYLOAD_MAX_ROW`:
    the CUDA kernel ``compact_pair_rows`` on CUDA tensors,
    :func:`compact_payload_pair_torch` on CPU tensors."""
    if _route(posw) == "cpu":
        return compact_payload_pair_torch(posw, angw, event_capacity)
    h, p = posw.shape
    _check_rows(p, single_word=False)
    return _cuda.compact_pair_rows(posw, angw, _k128(event_capacity, p))


def compact_payload(payload: torch.Tensor, event_capacity: int):
    """The label-native detector's single-stream payload compaction
    (K4): the CUDA kernel ``compact_payload_rows`` on a CUDA tensor,
    :func:`compact_payload_torch` on a CPU tensor."""
    if _route(payload) == "cpu":
        return compact_payload_torch(payload, event_capacity)
    h, p = payload.shape
    _check_rows(p, single_word=True)
    return _cuda.compact_payload_rows(payload, _k128(event_capacity, p))


def compact_payload_blocked(payload: torch.Tensor, event_capacity: int):
    """The JAX package's blocked form of :func:`compact_payload` (K5),
    same contract.  Its per-block cap and overflow reroute were a
    TPU workaround; here it launches the same exact kernel."""
    return compact_payload(payload, event_capacity)
