"""Sort-merge particle-ID matching between consecutive snapshots (twin of
``orbitanalysis_tpu/ops/join.py``: ``merge_join``, and the
searchsorted forms ``sort_rows``, ``match_ids``, ``two_way_match`` and
``gather_rows`` kept for small and host-side uses).

Concatenate the previous and current ID rows, sort by ``(id, side)``
with a stable ``torch.sort`` (prev entries come first in the concat, so
a stable sort by ID alone orders each matched pair prev-then-cur), pair
neighbours by a shift compare, run the caller's ``compute`` at the
merged positions, and scatter the results back to slot order through
the sort permutation.  Departed/entered/matched sets are boolean masks;
all shapes are static.

Assumption (inherited from the reference): particle IDs are unique
within one halo region.  The same ID may appear in several regions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SortedRows(NamedTuple):
    ids: torch.Tensor     # [H, P] sorted ascending (padding last)
    order: torch.Tensor   # [H, P] int32: original slot of each sorted entry


def sort_rows(ids: torch.Tensor) -> SortedRows:
    """Each row's IDs sorted ascending (stably), with the permutation."""
    vals, order = torch.sort(ids, dim=-1, stable=True)
    return SortedRows(ids=vals, order=order.to(torch.int32))


def match_ids(query: torch.Tensor, ref: SortedRows,
              invalid_id) -> torch.Tensor:
    """For each query slot, the slot of the reference row (original,
    unsorted layout) holding the same ID: ``[H, P]`` int32, -1 where the
    ID is absent or the slot is padding."""
    cap = ref.ids.shape[-1]
    pos = torch.searchsorted(ref.ids.contiguous(), query.contiguous(),
                             side="left").clamp_(max=cap - 1)
    hit = (torch.gather(ref.ids, 1, pos) == query) & (query != invalid_id)
    slot = torch.gather(ref.order, 1, pos)
    return torch.where(hit, slot, torch.full_like(slot, -1))


class TwoWayMatch(NamedTuple):
    prev_slot_of_cur: torch.Tensor  # [H, P] int32, -1 = entered/padding
    cur_slot_of_prev: torch.Tensor  # [H, P] int32, -1 = departed/padding


def two_way_match(cur_ids, cur_sorted: SortedRows, prev_ids,
                  prev_sorted: SortedRows, invalid_id) -> TwoWayMatch:
    """Slot maps both ways between consecutive snapshots' rows."""
    return TwoWayMatch(
        prev_slot_of_cur=match_ids(cur_ids, prev_sorted, invalid_id),
        cur_slot_of_prev=match_ids(prev_ids, cur_sorted, invalid_id),
    )


class MergeJoin(NamedTuple):
    """Outputs of the join.  "prev layout" = slot order of the previous
    row, "cur layout" = slot order of the current row."""

    matched_prev: torch.Tensor  # [H, P] bool, prev layout
    matched_cur: torch.Tensor   # [H, P] bool, cur layout
    prev_slot_of_cur: torch.Tensor | None  # [H, P] int32, cur layout, -1 = none
    to_prev: tuple              # computed channels, prev layout
    to_cur: tuple               # computed channels, cur layout


def _shift_right(x, fill):
    """Value at the left neighbour (index i-1) along the last axis."""
    return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)


def _shift_left(x, fill):
    """Value at the right neighbour (index i+1) along the last axis."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def merge_join(
    prev_ids: torch.Tensor,   # [H, P]
    cur_ids: torch.Tensor,    # [H, P]
    invalid_id,
    values: tuple = (),       # ((prev_arr|None, cur_arr|None), ...) pairs
    compute=None,
    with_prev_slot: bool = True,
) -> MergeJoin:
    """Match IDs between two rows, exchanging/transforming payloads.

    Each value channel is a pair ``(prev_arr, cur_arr)`` sharing one
    ``[H, 2P]`` merged channel (``None`` for a missing half).
    ``compute(left_vals, this_vals, matched) -> outputs`` runs at the
    merged positions: ``this_vals`` is each channel's value at the
    position and ``left_vals`` its left neighbour's (for a matched cur
    entry: its prev partner's; garbage elsewhere, so mask with
    ``matched``).  ``outputs`` is a tuple of ``(to_prev, to_cur)``
    pairs (either half may be None, both halves share a dtype):
    ``to_prev`` lands at the prev partner's slot, ``to_cur`` stays at
    the current entry's slot, unmatched slots get zeros.  With
    ``compute=None`` the raw payloads are exchanged.
    ``with_prev_slot`` also returns ``prev_slot_of_cur``: each matched
    cur slot's prev partner slot, -1 elsewhere (None when off).
    """
    h, p = prev_ids.shape
    cat_ids = torch.cat([prev_ids, cur_ids], dim=1)
    ids_s, sp_s = torch.sort(cat_ids, dim=-1, stable=True)

    def merged(pv, cv):
        c = torch.cat([
            pv if pv is not None else torch.zeros_like(cv),
            cv if cv is not None else torch.zeros_like(pv),
        ], dim=1)
        return torch.gather(c, 1, sp_s)

    chan_s = tuple(merged(pv, cv) for pv, cv in values)
    is_cur = sp_s >= p
    valid_key = ids_s != invalid_id

    left_is_prev = ~_shift_right(is_cur, True)
    # a cur entry matches when its left neighbour is the prev entry with
    # the same (valid) ID; the stable (id, side) order puts prev first
    match_cur_m = (
        is_cur & left_is_prev & valid_key
        & (ids_s == _shift_right(ids_s, invalid_id))
    )
    match_prev_m = _shift_left(match_cur_m, False)

    left_vals = tuple(_shift_right(c, 0) for c in chan_s)
    if compute is None:
        outputs = tuple((c, l) for l, c in zip(left_vals, chan_s))
    else:
        outputs = compute(left_vals, chan_s, match_cur_m)

    # fold each (to_prev, to_cur) pair into one merged channel: to_prev
    # moves one position left (to the prev partner), to_cur stays; the
    # two position sets are disjoint, unmatched positions get zeros
    def fold(tp, tc):
        if tp is None and tc is None:
            raise ValueError("output pair with both halves None")
        if tp is None:
            return torch.where(match_cur_m, tc, torch.zeros_like(tc))
        moved = torch.where(match_prev_m, _shift_left(tp, 0),
                            torch.zeros_like(tp))
        if tc is None:
            return moved
        return torch.where(
            is_cur, torch.where(match_cur_m, tc, torch.zeros_like(tc)),
            moved)

    def restore(x):
        # scatter merged positions back to concat (slot) order
        return torch.empty_like(x).scatter_(1, sp_s, x)

    out_r = tuple(restore(fold(tp, tc)) for tp, tc in outputs)
    matched_r = restore(match_cur_m | match_prev_m)
    prev_slot = None
    if with_prev_slot:
        # a matched cur entry's left neighbour is its prev partner, whose
        # concat position is its prev slot
        prev_slot = restore(torch.where(
            match_cur_m, _shift_right(sp_s, 0),
            torch.full_like(sp_s, -1)))[:, p:].to(torch.int32)
    return MergeJoin(
        matched_prev=matched_r[:, :p],
        matched_cur=matched_r[:, p:],
        prev_slot_of_cur=prev_slot,
        to_prev=tuple(c[:, :p] if tp is not None else None
                      for c, (tp, _) in zip(out_r, outputs)),
        to_cur=tuple(c[:, p:] if tc is not None else None
                     for c, (_, tc) in zip(out_r, outputs)),
    )


def gather_rows(values: torch.Tensor, slots: torch.Tensor, fill=0):
    """``values[h, slots[h, i]]``, with ``fill`` where a slot is -1.

    ``values`` is ``[H, P]`` or ``[H, P, d]``; ``slots`` is ``[H, P]``.
    """
    ok = slots >= 0
    idx = torch.clamp(slots, min=0).long()
    if values.dim() == slots.dim() + 1:
        out = torch.gather(values, 1,
                           idx[..., None].expand(-1, -1, values.shape[-1]))
        return torch.where(ok[..., None], out,
                           torch.full_like(out, fill))
    out = torch.gather(values, 1, idx)
    return torch.where(ok, out, torch.full_like(out, fill))
