"""Synthetic orbit/snapshot generators for tests and benchmarks (twin of
``orbitanalysis_tpu/models/synthetic.py``, same NumPy draws so both
packages see identical data from one seed).

Analytic Kepler orbits with closed-form pericenter-passage counts, and
random "churn" snapshots that stress the ID bookkeeping with particles
entering and leaving regions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class KeplerEnsemble(NamedTuple):
    """Particles on independent Kepler orbits around a point mass at the
    origin.  ``positions``/``velocities``: [n_snap, N, 3]; ``peri_counts``:
    [n_snap, N] cumulative pericenter passages strictly inside (t_0, t_i];
    ``ids``: [N]."""

    times: np.ndarray
    positions: np.ndarray
    velocities: np.ndarray
    peri_counts: np.ndarray
    apo_counts: np.ndarray
    ids: np.ndarray
    period: np.ndarray


def _solve_kepler(M, e, iters=32):
    """Eccentric anomaly from mean anomaly by Newton iteration."""
    E = np.where(e < 0.8, M, np.pi * np.ones_like(M))
    for _ in range(iters):
        f = E - e * np.sin(E) - M
        E = E - f / (1.0 - e * np.cos(E))
    return E


def kepler_ensemble(
    n_particles: int,
    n_snapshots: int,
    GM: float = 1.0,
    a_range=(0.5, 2.0),
    e_range=(0.05, 0.7),
    dt: float | None = None,
    seed: int = 0,
    id_offset: int = 0,
) -> KeplerEnsemble:
    """Sample an ensemble of Kepler orbits at a fixed snapshot cadence.

    ``dt`` defaults to 0.35x the *shortest* orbital period, so radial-
    velocity sign flips at snapshot cadence detect every passage (at most
    one pericenter and one apocenter can occur between snapshots).
    """
    rng = np.random.default_rng(seed)
    a = rng.uniform(*a_range, n_particles)
    e = rng.uniform(*e_range, n_particles)
    n = np.sqrt(GM / a**3)  # mean motion
    period = 2 * np.pi / n
    M0 = rng.uniform(0, 2 * np.pi, n_particles)  # mean anomaly at t=0

    # random orbital-plane orientations (uniform on SO(3) via random axes)
    zhat = rng.normal(size=(n_particles, 3))
    zhat /= np.linalg.norm(zhat, axis=1, keepdims=True)
    tmp = rng.normal(size=(n_particles, 3))
    xhat = tmp - (tmp * zhat).sum(1, keepdims=True) * zhat
    xhat /= np.linalg.norm(xhat, axis=1, keepdims=True)
    yhat = np.cross(zhat, xhat)

    if dt is None:
        dt = 0.35 * period.min()
    times = np.arange(n_snapshots) * dt

    pos = np.empty((n_snapshots, n_particles, 3))
    vel = np.empty((n_snapshots, n_particles, 3))
    peri = np.empty((n_snapshots, n_particles), dtype=np.int64)
    apo = np.empty((n_snapshots, n_particles), dtype=np.int64)

    b_over_a = np.sqrt(1 - e**2)
    for s, t in enumerate(times):
        M = M0 + n * t
        E = _solve_kepler(np.mod(M, 2 * np.pi), e)
        x = a * (np.cos(E) - e)
        y = a * b_over_a * np.sin(E)
        denom = 1.0 - e * np.cos(E)
        xd = -a * n * np.sin(E) / denom
        yd = a * n * b_over_a * np.cos(E) / denom
        pos[s] = x[:, None] * xhat + y[:, None] * yhat
        vel[s] = xd[:, None] * xhat + yd[:, None] * yhat
        # pericenter at M = 0 mod 2pi, apocenter at M = pi mod 2pi;
        # cumulative passages strictly after t_0:
        peri[s] = np.floor(M / (2 * np.pi)) - np.floor(M0 / (2 * np.pi))
        apo[s] = np.floor((M - np.pi) / (2 * np.pi)) - np.floor(
            (M0 - np.pi) / (2 * np.pi)
        )

    ids = np.arange(id_offset, id_offset + n_particles, dtype=np.int64)
    return KeplerEnsemble(
        times=times,
        positions=pos,
        velocities=vel,
        peri_counts=peri,
        apo_counts=apo,
        ids=ids,
        period=period,
    )


def churn_snapshots(
    n_halos: int,
    n_particles: int,
    n_snapshots: int,
    box_size: float = 100.0,
    churn: float = 0.15,
    seed: int = 0,
):
    """Random snapshots with per-halo particle membership churn.

    Each halo region holds a varying subset of a per-halo particle pool;
    ``churn`` is the per-snapshot probability that a particle toggles
    membership.  Positions/velocities are random walks — no physics, this
    is purely a stress test for join/angle bookkeeping.  Returns a list of
    per-snapshot dicts mapping halo index -> ragged arrays.
    """
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, box_size, size=(n_halos, 3))
    snaps = []
    pool_ids = [
        np.arange(h * 10**6, h * 10**6 + n_particles) for h in range(n_halos)
    ]
    member = [rng.random(n_particles) < 0.8 for _ in range(n_halos)]
    pos = [
        centers[h] + rng.normal(scale=3.0, size=(n_particles, 3))
        for h in range(n_halos)
    ]
    vel = [rng.normal(scale=1.0, size=(n_particles, 3)) for h in range(n_halos)]
    for _ in range(n_snapshots):
        snap = {}
        for h in range(n_halos):
            toggle = rng.random(n_particles) < churn
            member[h] = np.where(toggle, ~member[h], member[h])
            pos[h] = (pos[h] + vel[h] * 0.1) % box_size
            vel[h] = vel[h] + rng.normal(scale=0.3, size=(n_particles, 3))
            sel = member[h]
            snap[h] = dict(
                ids=pool_ids[h][sel],
                pos=pos[h][sel].copy(),
                vel=vel[h][sel].copy(),
                mass=rng.uniform(0.5, 2.0, sel.sum()),
                center=centers[h].copy(),
            )
        snaps.append(snap)
    return snaps, centers
