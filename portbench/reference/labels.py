"""Plain PyTorch reference of apsis detection over a position-stable
pool: the reference algorithm's semantics (``SURVEY.md`` sections 2-3:
``track_orbits.py`` of the original code, as ``orbits.py`` here states
them) for a pool in which particle ``i`` keeps position ``i`` for the
whole run and membership is a halo label, written from them and from
nothing of the program.

Per step ``s`` and particle ``i`` with ``label[s, i] = h >= 0`` (a
member of halo ``h``; -1: of none):

- ``rel`` = minimum-image displacement from halo ``h``'s centre, ``r``,
  ``rhat = rel / r`` (0 at ``r = 0``);
- halo ``h``'s bulk velocity is the mass-weighted mean velocity of its
  members at ``s`` (``mass[s]``);
- ``v_r = (v - v_bulk + hubble_drag * rel) . rhat``;
- a pericentre is ``v_r < 0`` at ``s - 1`` and ``> 0`` at ``s`` (an
  apocentre the reverse), for a particle whose label is ``h`` at both;
- the angle advances by ``arccos(rhat_prev . rhat_now)`` from the last
  apsis or from the step the particle took its label; it is recorded at
  an apsis and reset to 0.  A label change restarts the particle's
  state, as an entry into the region does.

The formulas and their order are ``orbits.py``'s, so on one history the
two references give the same events.  Every function computes in
``dtype``: float64 for the reference, bfloat16 for the control (the
nearest precision below the program's float32).  Nothing here imports
the program.
"""

from __future__ import annotations

import torch

from portbench.reference.orbits import StepEvents, _dtheta, _flip


def frames(label, pos, vel, mass, centers, box, drag, dtype):
    """One step's ``(rhat [N, 3], v_r [N], bulk [H, 3])`` from ``label
    [N]``, ``pos``/``vel`` ``[3, N]``, ``mass [N]`` and ``centers [H,
    3]``; non-members' values are computed from their halo-0 stand-in
    and never read."""
    H = centers.shape[0]
    lab = label.long()
    member = lab >= 0
    at = lab.clamp(min=0)
    pos = pos.T.to(dtype)
    vel = vel.T.to(dtype)
    zero = torch.zeros((), dtype=dtype, device=pos.device)
    m = torch.where(member, mass.to(dtype), zero)
    cen = centers.to(dtype)
    rel = pos - cen[at]
    rel = rel - box * torch.round(rel / box)
    msum = torch.zeros(H, dtype=dtype, device=pos.device).index_add_(
        0, at, m)
    mv = torch.zeros(H, 3, dtype=dtype, device=pos.device).index_add_(
        0, at, m[:, None] * vel)
    bulk = torch.where(msum[:, None] > 0,
                       mv / torch.where(msum > 0, msum, 1)[:, None], zero)
    vrel = vel - bulk[at] + drag * rel
    r = torch.sqrt((rel * rel).sum(-1))
    rhat = torch.where(r[:, None] > 0,
                       rel / torch.where(r > 0, r, 1)[:, None], zero)
    vr = (vrel * rhat).sum(-1)
    return rhat, vr, bulk


def track(label, pos, vel, mass, centers, ids, box, drag,
          mode="pericentric", dtype=torch.float64) -> list:
    """The detector over a pool from a fresh state: ``label [S, N]``
    (int, -1 for no halo), ``pos``/``vel`` ``[S, 3, N]``, ``mass [S, N]``
    (one plane a step), ``centers [H, 3]`` and ``ids [N]`` (each
    position's particle ID), on one device.  For steps 1 to S-1 the
    :class:`~portbench.reference.orbits.StepEvents` of that step, in pool
    order: ``row`` the halo, ``ids`` the IDs, ``angles`` in float64 and
    ``bulk`` the step's ``[H, 3]`` bulk velocities."""
    S = label.shape[0]
    out = []
    prev = None
    for s in range(S):
        lab = label[s].long()
        rhat, vr, bulk = frames(lab, pos[s], vel[s], mass[s], centers, box,
                                drag, dtype)
        ang = torch.zeros(lab.shape[0], dtype=dtype, device=lab.device)
        if prev is not None:
            plab, prhat, pvr, pang = prev
            same = (lab >= 0) & (lab == plab)
            acc = pang + _dtheta(prhat, rhat)
            hit = same & _flip(pvr, vr, mode)
            idx = torch.nonzero(hit).reshape(-1)
            out.append(StepEvents(
                row=lab[idx].cpu().numpy(),
                ids=ids[idx].long().cpu().numpy(),
                angles=acc[idx].double().cpu().numpy(),
                bulk=bulk.double().cpu().numpy()))
            ang = torch.where(same & ~hit, acc, ang)
        prev = (torch.where(lab >= 0, lab, -1), rhat, vr, ang)
    return out
