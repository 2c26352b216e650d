"""Plain PyTorch reference of config 4: a particle-mesh (PM) N-body
simulation, kick-drift-kick leapfrog in a periodic box, with the static
apsis detector run every ``detect_every`` steps.  Written from the
method (Hockney & Eastwood's PM: cloud-in-cell assignment, FFT Poisson
solve, spectral gradient, cloud-in-cell interpolation; the detector of
``SURVEY.md`` sections 2-3 on fixed halo member lists) and from nothing
of the program.

A call, from a state ``(pos, vel, mass)``:

- the opening acceleration ``a = F(pos)``; then each step ``v += dt/2
  a``, ``pos = (pos + dt v) mod L``, ``a = F(pos)``, ``v += dt/2 a``;
- ``F``: mass onto the ``G^3`` mesh by cloud-in-cell about the cell
  centres (coordinate ``pos / h - 1/2``, ``h = L / G``, periodic), the
  density ``rho = mesh / h^3``, ``phi_k = -4 pi G_N rho_k / |k|^2``
  (``phi_0 = 0``, no window deconvolution), the acceleration ``-i k
  phi_k`` back to the mesh, then to each particle by the same weights;
- the detector: halo ``h`` is the fixed member list ``h * P .. h * P +
  P - 1`` (identity rows); its centre is the mass-weighted mean of the
  members' minimum-image displacements from its first member, added to
  that member (the periodic anchor); its bulk velocity the
  mass-weighted mean velocity; per member ``rel`` = the minimum-image
  displacement from the centre, ``rhat = rel / |rel|`` (0 at 0),
  ``v_r = (v - bulk) . rhat``;
- a detection seeds the track at the call's start (no event), then
  every ``detect_every`` steps a member's turn since the last detection
  is ``atan2(|rhat_prev x rhat|, rhat_prev . rhat)``, added to its
  angle; a pericentre is ``v_r < 0`` before and ``> 0`` now (an
  apocentre the reverse): it is an event, it counts when the angle
  passed ``angle_cut``, and the angle restarts from 0.

Departures from the program, each deliberate:

- everything runs in ``dtype``: float64 for the reference, bfloat16 for
  the control (the nearest precision below the program's float32),
  where the program computes in float32 with float64 frame sums;
- ``torch.fft`` has no bfloat16, so the control's Poisson solve runs in
  float32 on its bfloat16 mesh and rounds the field back to bfloat16;
- the mesh adds each particle's eight weights by ``index_add_`` in any
  order, where the program sums a cell-sorted stream in a fixed order
  (kernel K13 on the card);
- the centres and bulk velocities stay in ``dtype``, not rounded to
  float32;
- particles go through the mesh in blocks of :data:`BLOCK`, so that the
  corner indices and weights of 12.6M particles fit beside the state.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

#: particles a block of the deposit and the interpolation
BLOCK = 1 << 21

_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


class Result(NamedTuple):
    pos: torch.Tensor      # [N, 3] the final positions
    vel: torch.Tensor      # [N, 3] the final velocities
    counts: torch.Tensor   # [N] int64 apsis counts of the call
    events: list           # events at each detection after the seed


def _corners(pos, grid, box):
    """Each particle's base cell ``[n, 3]`` (int64, in ``[0, grid)``) and
    its fractions toward the +1 neighbours ``[n, 3]``."""
    x = pos / (box / grid) - 0.5
    i0 = torch.floor(x)
    return torch.remainder(i0.long(), grid), x - i0


def _stencil(i0, f, grid):
    """The eight corners' flat cell indices and weights, ``[8, n]``."""
    flats, ws = [], []
    for dx, dy, dz in _CORNERS:
        ix = torch.remainder(i0[:, 0] + dx, grid)
        iy = torch.remainder(i0[:, 1] + dy, grid)
        iz = torch.remainder(i0[:, 2] + dz, grid)
        flats.append((ix * grid + iy) * grid + iz)
        w = (f[:, 0] if dx else 1 - f[:, 0]) \
            * (f[:, 1] if dy else 1 - f[:, 1]) \
            * (f[:, 2] if dz else 1 - f[:, 2])
        ws.append(w)
    return torch.stack(flats), torch.stack(ws)


def deposit(pos, mass, grid, box):
    """The cloud-in-cell mass mesh ``[grid^3]`` (flat)."""
    mesh = torch.zeros(grid ** 3, dtype=pos.dtype, device=pos.device)
    for s in range(0, pos.shape[0], BLOCK):
        i0, f = _corners(pos[s:s + BLOCK], grid, box)
        flat, w = _stencil(i0, f, grid)
        mesh.index_add_(0, flat.reshape(-1),
                        (w * mass[s:s + BLOCK][None, :]).reshape(-1))
    return mesh


def field(mesh, grid, box, G):
    """The acceleration ``[3, grid^3]`` on the mesh from the mass mesh."""
    dtype = mesh.dtype
    fdt = dtype if dtype == torch.float64 else torch.float32
    dev = mesh.device
    h = box / grid
    rho_k = torch.fft.rfftn(mesh.to(fdt).reshape(grid, grid, grid)
                            / h ** 3)
    k = torch.fft.fftfreq(grid, d=h, dtype=fdt, device=dev) * 2 * math.pi
    kz = torch.fft.rfftfreq(grid, d=h, dtype=fdt, device=dev) * 2 * math.pi
    kx, ky, kz = k[:, None, None], k[None, :, None], kz[None, None, :]
    k2 = kx * kx + ky * ky + kz * kz
    phi_k = torch.where(k2 > 0, -4 * math.pi * G / torch.where(
        k2 > 0, k2, 1), 0) * rho_k
    out = [torch.fft.irfftn(-1j * kv * phi_k, s=(grid, grid, grid))
           for kv in (kx, ky, kz)]
    return torch.stack(out).reshape(3, -1).to(dtype)


def interpolate(acc_mesh, pos, grid, box):
    """The mesh acceleration at each particle, ``[n, 3]``."""
    out = []
    for s in range(0, pos.shape[0], BLOCK):
        i0, f = _corners(pos[s:s + BLOCK], grid, box)
        flat, w = _stencil(i0, f, grid)
        out.append(torch.stack([(acc_mesh[c][flat] * w).sum(0)
                                for c in range(3)], dim=-1))
    return torch.cat(out)


def pm_force(pos, mass, grid, box, G):
    return interpolate(field(deposit(pos, mass, grid, box), grid, box, G),
                       pos, grid, box)


def _minimum_image(d, box):
    return d - box * torch.round(d / box)


def frames(pos, vel, mass, rows, box):
    """``(rhat [rows, P, 3], v_r [rows, P])`` of identity halo rows."""
    p = pos.reshape(rows, -1, 3)
    v = vel.reshape(rows, -1, 3)
    w = mass.reshape(rows, -1, 1)
    wsum = w.sum(1)
    anchor = p[:, :1, :]
    center = anchor[:, 0, :] + (w * _minimum_image(p - anchor, box)).sum(
        1) / wsum
    bulk = (w * v).sum(1) / wsum
    rel = _minimum_image(p - center[:, None, :], box)
    r = torch.sqrt((rel * rel).sum(-1, keepdim=True))
    rhat = torch.where(r > 0, rel / torch.where(r > 0, r, 1), 0)
    vr = ((v - bulk[:, None, :]) * rhat).sum(-1)
    return rhat, vr


def turn(a, b):
    """The angle between the directions ``a`` and ``b``, ``[..., 3]``."""
    cross = torch.linalg.cross(a, b)
    return torch.atan2(torch.sqrt((cross * cross).sum(-1)), (a * b).sum(-1))


def simulate(pos, vel, mass, config, dtype=torch.float64) -> Result:
    """One call of config 4 (``config`` the configuration file's dict)
    from the state ``(pos, vel, mass)``, computed in ``dtype``."""
    grid, box, G = config["grid"], float(config["box_size"]), config["G"]
    dt, every = config["dt"], config["detect_every"]
    rows, cut = config["rows"], config["angle_cut"]
    peri = config["mode"] == "pericentric"
    pos, vel, mass = (t.to(dtype) for t in (pos, vel, mass))
    rhat, vr = frames(pos, vel, mass, rows, box)
    angles = torch.zeros_like(vr)
    counts = torch.zeros(vr.shape, dtype=torch.int64, device=vr.device)
    events = []
    acc = pm_force(pos, mass, grid, box, G)
    for k in range(config["n_steps"]):
        vel = vel + 0.5 * dt * acc
        pos = torch.remainder(pos + dt * vel, box)
        acc = pm_force(pos, mass, grid, box, G)
        vel = vel + 0.5 * dt * acc
        if (k + 1) % every:
            continue
        rhat1, vr1 = frames(pos, vel, mass, rows, box)
        angles = angles + turn(rhat, rhat1)
        flip = (vr < 0) & (vr1 > 0) if peri else (vr > 0) & (vr1 < 0)
        counts += (flip & (angles > cut)).long()
        angles = torch.where(flip, 0, angles)
        events.append(int(flip.sum()))
        rhat, vr = rhat1, vr1
    return Result(pos, vel, counts.reshape(-1), events)
