"""The comparison that decides ``correct`` for the label-native cell: one
``scan_label_events`` result, as the timed path produced it, against the
plain reference ``portbench/reference/labels.py``.  It returns plain
numbers; their limits live in the traffic file (``limits``) and are set
in ``PERF.md`` from measured readings.  Event sets are compared as
:mod:`portbench.compare` compares them (keys ``(snapshot << 40) | (halo
<< 32) | id``, angles to :data:`portbench.compare.ANGLE_TOL`).
"""

from __future__ import annotations

import numpy as np

from portbench.compare import event_keys, match_events


def label_events(count, index, angle, label_seq, ids, ref: list) -> dict:
    """One scan's events (``count [S, R]``, global pool indices and
    angles ``[S, R, K]``, on any device) against the reference:
    ``event_mismatch``, ``angle_mismatch`` and ``layout_faults`` (events
    at the first step, counts past ``K``, indices outside their row of
    ``N / R`` positions or on a position that is no halo's member at
    that step: exact).  An event's halo is its position's label at its
    step (``label_seq [S, N]``) and its ID ``ids[index]`` (``ids [N]``
    the ID of each position)."""
    import torch

    S, R, K = index.shape
    dev = index.device
    N = label_seq.shape[-1]
    W = N // R
    count = count.long()
    faults = int((count[0] != 0).sum()) + int((count > K).sum())
    ok = torch.arange(K, device=dev)[None, None, :] < count[..., None]
    idx = index.long()
    lo = (torch.arange(R, device=dev) * W)[None, :, None]
    inside = (idx >= lo) & (idx < lo + W)
    faults += int((ok & ~inside).sum())
    idx = torch.where(ok & inside, idx, 0).reshape(S, R * K)
    halo = torch.gather(label_seq.to(dev).long(), 1, idx).reshape(S, R, K)
    faults += int((ok & inside & (halo < 0)).sum())
    pid = ids.to(dev).long()[idx].reshape(S, R, K)
    s_idx = torch.arange(S, device=dev)[:, None, None].expand(S, R, K)
    keys = ((s_idx << 40) | (halo << 32) | pid)[ok].cpu().numpy()
    ang = angle.double()[ok].cpu().numpy()
    ref_keys = np.concatenate([event_keys(s, e.row, e.ids)
                               for s, e in enumerate(ref, start=1)])
    ref_ang = np.concatenate([e.angles for e in ref])
    mismatch, off = match_events(keys, ref_keys, ang, ref_ang)
    return dict(event_mismatch=mismatch, angle_mismatch=off,
                layout_faults=float(faults))
