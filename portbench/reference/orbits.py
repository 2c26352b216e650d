"""Plain PyTorch reference of config 2's orbit tracking: the reference
algorithm's semantics (``SURVEY.md`` sections 2-3: ``track_orbits.py``
of the original code), written from them and from nothing of the
program.

A snapshot's particles are joined to the previous snapshot's by (halo,
particle ID); each halo is its own progenitor.  Per particle and halo:

- ``rel`` = minimum-image displacement from the region centre, ``r``,
  ``rhat = rel / r`` (0 at ``r = 0``);
- the bulk velocity is the mass-weighted mean of the halo's members;
- ``v_r = (v - v_bulk + hubble_drag * rel) . rhat``;
- a pericentre is ``v_r < 0`` at the previous snapshot and ``> 0`` now
  (an apocentre the reverse), for particles present in both;
- the angle advances by ``arccos(rhat_prev . rhat_now)`` from the last
  apsis or from the particle's entry into the region; it is recorded at
  an apsis and reset to 0.

Every function computes in ``dtype``: float64 for the reference,
bfloat16 for the control (the nearest precision below the program's
float32).  Nothing here imports the program.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Frames(NamedTuple):
    key: torch.Tensor    # [n] int64 (halo << 32) | id
    row: torch.Tensor    # [n] int64 halo of each particle
    rhat: torch.Tensor   # [n, 3]
    vr: torch.Tensor     # [n]
    bulk: torch.Tensor   # [H, 3]


def frames(snap, centers, box, drag, dtype, device) -> Frames:
    """Region frames of one snapshot (a ``generate.Snapshot``)."""
    H = len(centers)
    counts = torch.as_tensor(snap.counts, device=device)
    row = torch.repeat_interleave(torch.arange(H, device=device), counts)
    ids = torch.as_tensor(snap.ids, device=device).long()
    pos = torch.as_tensor(snap.pos, device=device).to(dtype)
    vel = torch.as_tensor(snap.vel, device=device).to(dtype)
    mass = torch.as_tensor(snap.mass, device=device).to(dtype)
    cen = torch.as_tensor(centers, device=device).to(dtype)
    rel = pos - cen[row]
    rel = rel - box * torch.round(rel / box)
    msum = torch.zeros(H, dtype=dtype, device=device).index_add_(0, row, mass)
    mv = torch.zeros(H, 3, dtype=dtype, device=device).index_add_(
        0, row, mass[:, None] * vel)
    bulk = mv / msum[:, None]
    vrel = vel - bulk[row] + drag * rel
    r = torch.sqrt((rel * rel).sum(-1))
    rhat = torch.where(r[:, None] > 0, rel / torch.where(r > 0, r, 1)[:, None],
                       torch.zeros((), dtype=dtype, device=device))
    vr = (vrel * rhat).sum(-1)
    return Frames((row << 32) | ids, row, rhat, vr, bulk)


class Join(NamedTuple):
    matched: torch.Tensor  # [n_cur] bool
    prev: torch.Tensor     # [n_cur] int64 index into the previous snapshot


def join(prev_key, cur_key) -> Join:
    """Each current particle's index in the previous snapshot."""
    sk, order = torch.sort(prev_key)
    at = torch.searchsorted(sk, cur_key).clamp(max=max(len(sk) - 1, 0))
    if len(sk) == 0:
        z = torch.zeros_like(cur_key, dtype=torch.bool)
        return Join(z, torch.zeros_like(cur_key))
    return Join(sk[at] == cur_key, order[at])


def _flip(vr0, vr1, mode):
    if mode == "pericentric":
        return (vr0 < 0) & (vr1 > 0)
    return (vr0 > 0) & (vr1 < 0)


def _dtheta(rhat0, rhat1):
    return torch.acos(torch.clamp((rhat0 * rhat1).sum(-1), -1, 1))


class StepEvents(NamedTuple):
    """One snapshot's events, in the previous snapshot's order."""

    row: np.ndarray      # [e] halo
    ids: np.ndarray      # [e] particle IDs
    angles: np.ndarray   # [e] float64
    bulk: np.ndarray     # [H, 3] float64, the current snapshot's


def track(seq, drag, mode="pericentric", dtype=torch.float64,
          device="cpu") -> list:
    """The offline tracker over a churn sequence: for snapshots 1 to S-1
    the :class:`StepEvents` the catalog's group of that snapshot holds."""
    out, state = [], None
    for snap in seq.snaps:
        f = frames(snap, seq.centers, seq.box, drag, dtype, device)
        ang = torch.zeros(len(f.key), dtype=dtype, device=device)
        if state is not None:
            pf, pang = state
            j = join(pf.key, f.key)
            acc = pang[j.prev] + _dtheta(pf.rhat[j.prev], f.rhat)
            hit = j.matched & _flip(pf.vr[j.prev], f.vr, mode)
            ang = torch.where(j.matched & ~hit, acc, ang)
            order = torch.argsort(j.prev[hit])
            ids = (f.key[hit] & 0xFFFFFFFF)[order]
            out.append(StepEvents(
                row=f.row[hit][order].cpu().numpy(),
                ids=ids.cpu().numpy(),
                angles=acc[hit][order].double().cpu().numpy(),
                bulk=f.bulk.double().cpu().numpy()))
        state = (f, ang)
    return out
