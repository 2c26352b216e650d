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


#: The padding ID of the bench's int32 ID form (the int32 maximum).
_INVALID_I32 = np.iinfo(np.int32).max


def _orbit_pool(n_halos: int, capacity: int, n_snaps: int, seed: int):
    """The JAX package benchmark's orbit pool (``bench.py`` ``make_orbits``,
    its draws in its order): each halo owns ``capacity`` particles on
    eccentric orbits (radial breathing on circular motion, random planes
    and phases), with its pool IDs shuffled in the row.  Returns ``(rng,
    ids [H, C] int32, pos [S, H, C, 3] f32, vel [S, H, C, 3] f32,
    center [H, 3] f32)``; ``rng`` goes on to the membership draws."""
    rng = np.random.default_rng(seed)
    H, C, S = n_halos, capacity, n_snaps
    center = rng.uniform(20.0, 80.0, size=(H, 3)).astype(np.float32)
    r0 = rng.uniform(0.5, 5.0, size=(H, C)).astype(np.float32)
    omega = (1.0 / r0**1.5).astype(np.float32)
    phase0 = rng.uniform(0, 2 * np.pi, size=(H, C)).astype(np.float32)
    axis_x = rng.normal(size=(H, C, 3)).astype(np.float32)
    axis_x /= np.linalg.norm(axis_x, axis=-1, keepdims=True)
    tmp = rng.normal(size=(H, C, 3)).astype(np.float32)
    tmp -= (tmp * axis_x).sum(-1, keepdims=True) * axis_x
    axis_y = (tmp / np.linalg.norm(tmp, axis=-1, keepdims=True)).astype(
        np.float32)
    ids = np.arange(H * C, dtype=np.int32).reshape(H, C)
    for h in range(H):  # shuffled within rows, so a join does real work
        ids[h] = ids[h][np.argsort(rng.random(C), kind="stable")]
    ecc = rng.uniform(0.2, 0.5, size=(H, C)).astype(np.float32)
    phase_r = rng.uniform(0, 2 * np.pi, size=(H, C)).astype(np.float32)
    dt = np.float32(0.3)
    pos = np.empty((S, H, C, 3), dtype=np.float32)
    vel = np.empty_like(pos)
    for s in range(S):
        ph = phase0 + omega * (np.float32(s) * dt)
        phr = phase_r + omega * (np.float32(s) * dt)
        r = r0 * (1.0 + ecc * np.sin(phr))
        rdot = r0 * ecc * omega * np.cos(phr)
        cph, sph = np.cos(ph), np.sin(ph)
        pos[s] = (center[:, None, :]
                  + r[..., None] * (cph[..., None] * axis_x
                                    + sph[..., None] * axis_y))
        vel[s] = (rdot[..., None] * (cph[..., None] * axis_x
                                     + sph[..., None] * axis_y)
                  + (r * omega)[..., None] * (-sph[..., None] * axis_x
                                              + cph[..., None] * axis_y))
    return rng, ids, pos, vel, center


def _memberships(rng, n_halos: int, capacity: int, n_snaps: int,
                 churn: float):
    """The benchmark's membership history (``bench.py``
    ``make_churn_sequence``): each halo tracks 90 % of its pool, and each
    snapshot ``churn`` of that count swaps against the reserve.  Yields
    ``(member [H, C] bool, load_keys [H, C])`` a snapshot; the members
    in ascending ``load_keys`` order are the snapshot's load order."""
    H, C = n_halos, capacity
    n_valid = int(C * 0.9)
    k = min(int(round(churn * n_valid)), C - n_valid)
    member = np.zeros((H, C), dtype=bool)
    init = np.argsort(rng.random((H, C)), axis=1)[:, :n_valid]
    np.put_along_axis(member, init, True, axis=1)
    rows = np.arange(H)[:, None]
    for s in range(n_snaps):
        if s > 0 and k > 0:
            keys = np.where(member, rng.random((H, C)), np.inf)
            drop = np.argpartition(keys, k - 1, axis=1)[:, :k]
            member[rows, drop] = False
            keys = np.where(member, np.inf, rng.random((H, C)))
            add = np.argpartition(keys, k - 1, axis=1)[:, :k]
            member[rows, add] = True
        yield member, np.where(member, rng.random((H, C)), np.inf)


def bench_workloads(n_halos: int, capacity: int, n_snaps: int,
                    seed: int = 0, churn: float = 0.07) -> dict:
    """The JAX package's benchmark workloads (``bench.py``:
    ``make_orbits``, ``make_churn_sequence``, ``make_static_sequence``,
    ``make_label_sequence``) from one orbit pool, with the same NumPy
    draws in the same order, so one seed gives ``bench.py``'s arrays.

    Returns a dict of three forms (the pool is made once for all):

    - ``'churn'``: ``(ids_seq [S, H, C] int32, pos [S, H, C, 3], vel,
      centers [S, H, 3], n_valid)``, each row's ``n_valid`` members in
      load order, then int32-max padding (zero positions);
    - ``'static'``: the same tuple with the whole pool tracked at every
      snapshot (``n_valid = C``; ``ids_seq`` a read-only broadcast);
    - ``'label'``: ``(label [S, N] int32 (-1 untracked), pos [S, 3, N],
      vel [S, 3, N], centers, n_valid_total)`` with ``N = H * C``:
      particle ``h * C + c`` is pool slot ``c`` of halo ``h``, labelled
      ``h`` while tracked, and ``n_valid_total`` counts snapshot 0.

    The churn and label forms run the same membership history, so their
    event totals are comparable.
    """
    return _bench_workloads(n_halos, capacity, n_snaps, seed, churn,
                            ("churn", "static", "label"))


def _bench_workloads(n_halos, capacity, n_snaps, seed, churn, forms):
    """:func:`bench_workloads` building only ``forms``: the one-form
    wrappers below skip the host work of the others."""
    H, C, S = n_halos, capacity, n_snaps
    rng, ids, pos, vel, center = _orbit_pool(H, C, S, seed)
    centers = np.ascontiguousarray(np.broadcast_to(center, (S, H, 3)))
    out = {}
    if "static" in forms:
        out["static"] = (np.broadcast_to(ids, (S, H, C)), pos, vel, centers,
                         C)
    if "churn" not in forms and "label" not in forms:
        return out
    n_valid = int(C * 0.9)
    make_churn, make_label = "churn" in forms, "label" in forms
    if make_churn:
        ids_seq = np.full((S, H, C), _INVALID_I32, np.int32)
        pos_c = np.zeros_like(pos)
        vel_c = np.zeros_like(vel)
    if make_label:
        home = np.repeat(np.arange(H, dtype=np.int32), C)
        label = np.empty((S, H * C), dtype=np.int32)
    n_valid_total = 0
    for s, (member, keys) in enumerate(_memberships(rng, H, C, S, churn)):
        if s == 0:
            n_valid_total = int(member.sum())
        if make_churn:
            sel = np.argsort(keys, axis=1)[:, :n_valid]
            ids_seq[s, :, :n_valid] = np.take_along_axis(ids, sel, axis=1)
            pos_c[s, :, :n_valid] = np.take_along_axis(pos[s], sel[..., None],
                                                       axis=1)
            vel_c[s, :, :n_valid] = np.take_along_axis(vel[s], sel[..., None],
                                                       axis=1)
        if make_label:
            label[s] = np.where(member.reshape(-1), home, -1)
    if make_churn:
        out["churn"] = (ids_seq, pos_c, vel_c, centers, n_valid)
    if make_label:
        def planes(x):
            return np.ascontiguousarray(
                np.moveaxis(x.reshape(S, -1, 3), -1, 1))

        out["label"] = (label, planes(pos), planes(vel), centers,
                        n_valid_total)
    return out


def churn_workload(n_halos: int, capacity: int, n_snaps: int, seed: int = 0,
                   churn: float = 0.07):
    """The JAX benchmark's churn sequence in the ID form (``bench.py``
    ``make_orbits`` + ``make_churn_sequence``): ``(ids_seq [S, H, C],
    pos [S, H, C, 3], vel, centers [S, H, 3], n_valid)``; see
    :func:`bench_workloads`."""
    return _bench_workloads(n_halos, capacity, n_snaps, seed, churn,
                            ("churn",))["churn"]


def static_workload(n_halos: int, capacity: int, n_snaps: int,
                    seed: int = 0):
    """The JAX benchmark's fixed-membership sequence (``bench.py``
    ``make_static_sequence``): every pool particle tracked at every
    snapshot; see :func:`bench_workloads`."""
    return _bench_workloads(n_halos, capacity, n_snaps, seed, 0.07,
                            ("static",))["static"]


def label_churn_workload(n_halos: int, capacity: int, n_snaps: int,
                         seed: int = 0, churn: float = 0.07):
    """The JAX benchmark's churn workload in the label-native
    representation (``bench.py``: ``make_orbits``, ``make_churn_sequence``,
    ``make_label_sequence``): ``(label [S, N] int32 (-1 untracked),
    pos [S, 3, N] f32, vel [S, 3, N] f32, centers [S, H, 3] f32,
    n_valid_total)`` with ``N = n_halos * capacity``; see
    :func:`bench_workloads`."""
    return _bench_workloads(n_halos, capacity, n_snaps, seed, churn,
                            ("label",))["label"]
