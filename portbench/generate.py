"""The benchmark's traffic generators, frozen here so that a change to the
program cannot change what the benchmark feeds it.

Every generator draws from one ``torch.Generator`` seeded by ``--seed``
on the device the run uses, in a few large calls, and makes the same
sizes from every seed: only the values differ.

- :func:`churn_sequence`: the law of
  ``orbitanalysis_tpu_torch/models/synthetic.py:111`` (``churn_snapshots``:
  per-halo pools of particles on random walks in a periodic box, each
  particle toggling membership with probability ``churn`` a snapshot),
  drawn for all halos at once instead of halo by halo with NumPy;
- :func:`snapshot_callbacks`: the two callbacks of ``track_orbits``
  over it (``chip_smoke.py:467`` ``_churn_loader``; the loader returns
  arrays built once and held in memory, with the cosmology of
  ``chip_smoke.py:203`` ``E2E_COSMO``);
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded by any whole number (negative or
    past 64 bits too: it is reduced modulo 2**63)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


class Snapshot(NamedTuple):
    """One snapshot of a churn sequence, members halo-major and in pool
    order within a halo (the loader's order)."""

    ids: np.ndarray       # [n] int64
    pos: np.ndarray       # [n, 3] float32
    vel: np.ndarray       # [n, 3] float32
    mass: np.ndarray      # [n] float32
    counts: np.ndarray    # [H] int64 members a halo


class ChurnSequence(NamedTuple):
    snaps: list           # [S] Snapshot
    centers: np.ndarray   # [H, 3] float32 region centres
    box: float


#: particle IDs of halo h are h * ID_STRIDE + pool slot
ID_STRIDE = 10 ** 6


def churn_sequence(n_halos: int, pool: int, n_snap: int, box: float,
                   churn: float, seed: int, device) -> ChurnSequence:
    """``n_snap`` snapshots of ``n_halos`` halos with ``pool`` particles a
    pool: 80 % members at the start, each particle toggling membership
    with probability ``churn`` a snapshot, positions drifting by ``0.1
    v`` (periodic) and velocities kicked by ``0.3 N(0, 1)`` a snapshot,
    masses uniform in [0.5, 2).  The walk runs in float64 on the device;
    the snapshots are float32 host arrays."""
    g = generator(seed, device)
    f64 = dict(dtype=torch.float64, device=device, generator=g)
    H, P = n_halos, pool
    centers = torch.rand(H, 3, **f64) * box
    member = torch.rand(H, P, **f64) < 0.8
    pos = centers[:, None, :] + 3.0 * torch.randn(H, P, 3, **f64)
    vel = torch.randn(H, P, 3, **f64)
    ids = (torch.arange(H, device=device)[:, None] * ID_STRIDE
           + torch.arange(P, device=device)[None, :])
    snaps = []
    for _ in range(n_snap):
        member ^= torch.rand(H, P, **f64) < churn
        pos = torch.remainder(pos + vel * 0.1, box)
        vel = vel + 0.3 * torch.randn(H, P, 3, **f64)
        mass = 0.5 + 1.5 * torch.rand(H, P, **f64)
        snaps.append(Snapshot(
            ids=ids[member].cpu().numpy(),
            pos=pos[member].float().cpu().numpy(),
            vel=vel[member].float().cpu().numpy(),
            mass=mass[member].float().cpu().numpy(),
            counts=member.sum(dim=1).cpu().numpy()))
    return ChurnSequence(snaps, centers.float().cpu().numpy(), float(box))


def hubble_drag(cosmology: dict) -> float:
    """``H(z) / (1 + z)`` of a flat-or-curved FLRW cosmology
    (``orbitanalysis_tpu_torch/utils/numerics.py:89``), 0 without one."""
    if not cosmology:
        return 0.0
    zp1 = 1.0 + cosmology["redshift"]
    hz = cosmology["H0"] * np.sqrt(
        cosmology["Omega_m"] * zp1 ** 3
        + cosmology.get("Omega_k", 0.0) * zp1 ** 2 + cosmology["Omega_L"])
    return float(hz / zp1)


def snapshot_callbacks(seq: ChurnSequence, radius: float, cosmology: dict):
    """``(regions, load)`` for ``track_orbits``: every halo is requested
    at every snapshot (each halo its own progenitor), and the loader
    returns the whole snapshot's arrays, built once here."""
    H = len(seq.centers)
    radii = np.full(H, float(radius))
    loaded = []
    for s in seq.snaps:
        offsets = np.concatenate(([0], np.cumsum(s.counts)[:-1]))
        d = dict(ids=s.ids, coordinates=s.pos, velocities=s.vel,
                 masses=s.mass, region_offsets=offsets, box_size=seq.box)
        d.update(cosmology)
        loaded.append(d)

    def regions(snapshot_number, halo_ids):
        return seq.centers[halo_ids], radii[halo_ids]

    def load(snapshot_number, positions, radii_):
        return loaded[snapshot_number]

    return regions, load
