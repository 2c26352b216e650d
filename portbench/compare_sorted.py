"""The comparison that decides ``correct`` for the sorted merge-join
cell: one ``scan_events_sorted`` result, as the timed path produced it,
against the plain reference ``portbench/reference/orbits.py``.  It
returns plain numbers; their limits live in the traffic file
(``limits``) and are set in ``PERF.md`` from measured readings.  Event
sets are compared as :mod:`portbench.compare` compares them (keys
``(snapshot << 40) | (halo << 32) | id``, angles to
:data:`portbench.compare.ANGLE_TOL`).
"""

from __future__ import annotations

import numpy as np

from portbench.compare import event_keys, match_events


def sorted_events(count, ids, angles, seq, ref: list) -> dict:
    """One scan's events (``count [S, H]``, particle IDs and angles ``[S,
    H, K]``, on any device) against the reference: ``event_mismatch``,
    ``angle_mismatch`` and ``layout_faults`` (events at the first
    snapshot, counts past ``K``, and events that are no member of their
    halo at the previous snapshot or that break the previous snapshot's
    load order within their halo: exact).  ``seq`` is the churn sequence
    (``generate.churn_sequence``) whose snapshots give each halo's
    members in load order."""
    import torch

    S, H, K = ids.shape
    dev = ids.device
    count = count.long()
    faults = int((count[0] != 0).sum()) + int((count > K).sum())
    ok = torch.arange(K, device=dev)[None, None, :] < count[..., None]
    eid = ids.long()
    halo = torch.arange(H, device=dev)[:, None].expand(H, K)
    for s in range(1, S):
        prev = seq.snaps[s - 1]
        load = torch.as_tensor(event_keys(
            0, np.repeat(np.arange(H), prev.counts), prev.ids), device=dev)
        order = torch.argsort(load)
        keys = ((halo << 32) | eid[s]).reshape(-1)
        at = torch.searchsorted(load[order], keys).clamp(max=len(load) - 1)
        found = (load[order][at] == keys).reshape(H, K)
        index = torch.where(found, order[at].reshape(H, K), -1)
        faults += int((ok[s] & ~found).sum())
        faults += int((ok[s, :, 1:] & ~(index[:, 1:] > index[:, :-1])).sum())
    s_idx = torch.arange(S, device=dev)[:, None, None].expand(S, H, K)
    keys = ((s_idx << 40) | (halo[None] << 32) | eid)[ok].cpu().numpy()
    ang = angles.double()[ok].cpu().numpy()
    ref_keys = np.concatenate([event_keys(s, e.row, e.ids)
                               for s, e in enumerate(ref, start=1)])
    ref_ang = np.concatenate([e.angles for e in ref])
    mismatch, off = match_events(keys, ref_keys, ang, ref_ang)
    return dict(event_mismatch=mismatch, angle_mismatch=off,
                layout_faults=float(faults))
