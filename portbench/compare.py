"""The comparisons that decide ``correct``: the program's outputs, as the
timed path produced them, against the plain references in
``portbench/reference``.  Each function returns plain numbers; the
limits they are held to live in each traffic file (``limits``) and are
set in ``PERF.md`` from measured readings.

Event sets are compared as sets of keys ``(snapshot << 40) | (halo <<
32) | id``: a particle whose radial velocity lies within rounding of
zero may flip in one precision and not in the other, so sound runs
differ in a few events in millions, and the share is the number held.
"""

from __future__ import annotations

import numpy as np

#: An event angle counts as off when it is further than this from the
#: reference's (rad): one float16 ulp at pi is 2**-9 (the savefile's
#: angles are float16), and float32 arccos near cos = 1 resolves no
#: finer than sqrt(2 * 2**-24) = 3.5e-4 a step, summed over the steps
#: since the last apsis.
ANGLE_TOL = 4e-3


def event_keys(snap, row, ids) -> np.ndarray:
    return ((np.asarray(snap, np.int64) << 40)
            | (np.asarray(row, np.int64) << 32)
            | np.asarray(ids, np.int64))


def match_events(prog_keys, ref_keys, prog_angles=None, ref_angles=None):
    """``(mismatch, angle_off)``: the events in one set and not in the
    other (a duplicated program event counts once more) over the
    reference's events, and the share of common events whose angles
    differ by more than :data:`ANGLE_TOL` (0 without angles)."""
    prog_keys = np.asarray(prog_keys, np.int64)
    ref_keys = np.asarray(ref_keys, np.int64)
    common, ip, ir = np.intersect1d(prog_keys, ref_keys,
                                    return_indices=True)
    mismatch = (len(prog_keys) - len(common)) + (len(ref_keys) - len(common))
    off = 0.0
    if prog_angles is not None and len(common):
        gap = np.abs(np.asarray(prog_angles, np.float64)[ip]
                     - np.asarray(ref_angles, np.float64)[ir])
        off = float(np.count_nonzero(~(gap <= ANGLE_TOL))) / len(common)
    return mismatch / max(len(ref_keys), 1), off


def _rows_of(offsets, n_halos):
    offsets = np.asarray(offsets, np.int64)
    return np.repeat(np.arange(n_halos), np.diff(offsets))


def _offsets_ok(offsets, n_items, n_halos) -> bool:
    o = np.asarray(offsets)
    return (o.shape == (n_halos + 1,) and o[0] == 0 and o[-1] == n_items
            and bool(np.all(np.diff(o) >= 0)))


def _order_faults(row, ids, prev_snap) -> int:
    """Halo blocks whose IDs are not in the previous snapshot's load
    order (the reference's within-halo order), or not in it at all."""
    if len(ids) == 0:
        return 0
    prev_keys = event_keys(0, np.repeat(np.arange(len(prev_snap.counts)),
                                        prev_snap.counts), prev_snap.ids)
    order = np.argsort(prev_keys, kind="stable")
    keys = event_keys(0, row, ids)
    at = np.searchsorted(prev_keys[order], keys).clip(max=len(order) - 1)
    found = prev_keys[order][at] == keys
    idx = np.where(found, order[at], -1)
    bad = ~found
    step_back = np.diff(idx) <= 0
    same_row = np.diff(row) == 0
    bad_rows = set(np.asarray(row)[bad].tolist())
    bad_rows |= set(np.asarray(row)[1:][step_back & same_row].tolist())
    return len(bad_rows)


def track_catalog(cat: dict, ref: list, seq, radius: float,
                  mode: str = "pericentric") -> dict:
    """One ``track_orbits`` catalog (a ``MemoryWriter`` file) against the
    reference's events: ``event_mismatch``, ``angle_mismatch``,
    ``bulk_gap`` (largest |bulk velocity - reference|) and
    ``layout_faults`` (missing or extra groups or datasets, halo IDs,
    descendants, region data or offsets not as given, blocks out of the
    reference's order: exact)."""
    H = len(seq.centers)
    tag = "pericenter" if mode == "pericentric" else "apocenter"
    S = len(seq.snaps)
    faults = 0
    names = {"snapshot_%03d" % s for s in range(1, S)}
    got = {k for k in cat if k != "attrs"}
    faults += len(names ^ got)
    if cat.get("attrs", {}).get("mode") != mode:
        faults += 1
    keys, angles, ref_keys, ref_angles = [], [], [], []
    bulk_gap = 0.0
    for s in range(1, S):
        e = ref[s - 1]
        ref_keys.append(event_keys(s, e.row, e.ids))
        ref_angles.append(e.angles)
        g = cat.get("snapshot_%03d" % s)
        if g is None:
            continue
        ids = np.asarray(g.get(tag + "_IDs", []))
        ang = np.asarray(g.get("angles", []), np.float64)
        offs = g.get("region_offsets")
        arange = np.arange(H)
        want = {"halo_IDs": arange, "region_radii": np.full(H, radius),
                "region_positions": seq.centers}
        if s < S - 1:
            want["final_descendant_IDs"] = arange
        elif "final_descendant_IDs" in g:
            faults += 1
        for k, v in want.items():
            x = g.get(k)
            if x is None or np.shape(x) != np.shape(v) or not np.array_equal(
                    np.asarray(x, np.float64), np.asarray(v, np.float64)):
                faults += 1
        if offs is None or not _offsets_ok(offs, len(ids), H) or len(
                ang) != len(ids):
            faults += 1
            continue
        row = _rows_of(offs, H)
        faults += _order_faults(row, ids, seq.snaps[s - 1])
        keys.append(event_keys(s, row, ids))
        angles.append(ang)
        bulk = np.asarray(g.get("bulk_velocities", np.full((H, 3), np.nan)),
                          np.float64)
        if bulk.shape != (H, 3):
            faults += 1
            continue
        bulk_gap = max(bulk_gap, float(np.nan_to_num(
            np.abs(bulk - e.bulk), nan=np.inf).max()))
    mismatch, off = match_events(
        np.concatenate(keys) if keys else [], np.concatenate(ref_keys),
        np.concatenate(angles) if angles else [], np.concatenate(ref_angles))
    return dict(event_mismatch=mismatch, angle_mismatch=off,
                bulk_gap=bulk_gap, layout_faults=float(faults))


def scan_events(count, positions, angles, staged_ids, ref: list) -> dict:
    """One ``scan_events_aligned`` result (``count [S, H]``, positions
    and angles ``[S, H, K]``, on any device) against the reference:
    ``event_mismatch``, ``angle_mismatch`` and ``layout_faults`` (events
    at the first snapshot, counts past ``K``, positions outside the row
    or on an empty slot: exact).  Positions are mapped to IDs through
    the staged ``[S, H, P]`` ID planes."""
    import torch

    S, H, K = positions.shape
    P = staged_ids.shape[-1]
    count = count.long()
    faults = int((count[0] != 0).sum()) + int((count > K).sum())
    ok = torch.arange(K, device=count.device)[None, None, :] < count[..., None]
    inside = (positions >= 0) & (positions < P)
    faults += int((ok & ~inside).sum())
    pos = torch.where(ok & inside, positions.long(), 0)
    ids = torch.gather(staged_ids.long(), 2, pos)
    faults += int((ok & (ids == np.iinfo(np.int32).max)).sum())
    s_idx = torch.arange(S, device=count.device)[:, None, None].expand(S, H, K)
    h_idx = torch.arange(H, device=count.device)[None, :, None].expand(S, H, K)
    keys = ((s_idx << 40) | (h_idx << 32) | ids)[ok].cpu().numpy()
    ang = angles.double()[ok].cpu().numpy()
    ref_keys = np.concatenate([event_keys(s, e.row, e.ids)
                               for s, e in enumerate(ref, start=1)])
    ref_ang = np.concatenate([e.angles for e in ref])
    mismatch, off = match_events(keys, ref_keys, ang, ref_ang)
    return dict(event_mismatch=mismatch, angle_mismatch=off,
                layout_faults=float(faults))
