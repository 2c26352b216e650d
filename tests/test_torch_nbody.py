"""The port's N-body integrator (``orbitanalysis_tpu_torch.models.nbody``)
and its blocked direct-force kernel's plain version
(``ops/nbody.py``, K14) against the JAX package on the CPU.

Inputs are made from seeds with NumPy and handed to both packages; the
JAX kernel ``direct_forces_pallas`` runs in interpret mode, as
``tests/test_pallas.py`` runs it.  Tolerances, with their reasons:

- forces: the JAX test's measure ``max |a1 - a2| / (|a2| + 1e-3) <
  1e-3`` (the two sum pairs in different orders, and the Gram form
  cancels ``|x_i|^2 + |x_j|^2 - 2 x_i.x_j`` for close pairs);
- detector flags and counts exact on identical states (sign tests on
  the same float32 radial velocities: the port's frame means are
  float64 sums rounded once, JAX's float32 sums, one ulp apart at most);
  angles to 1e-5 rad (``acos`` of cosines an ulp or two apart);
- integrated runs: counts equal JAX's except at most 3 particles off by
  one (``tests/test_nbody.py``'s own allowance against the closed form:
  the trajectories are float32 and differ in rounding), positions to
  1e-4 of the orbit scale.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbitanalysis_tpu.models import nbody as jnb
from orbitanalysis_tpu.models.synthetic import kepler_ensemble
from orbitanalysis_tpu.ops.pallas_nbody import direct_forces_pallas
from orbitanalysis_tpu_torch.models import nbody as tnb
from orbitanalysis_tpu_torch.ops import nbody as tops

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a1, a2):
    a1, a2 = np.asarray(a1, np.float64), np.asarray(a2, np.float64)
    return float((np.abs(a1 - a2)
                  / (np.linalg.norm(a2, axis=1, keepdims=True) + 1e-3)).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("box", [None, 10.0])
def test_direct_forces_match_jax(rng, box):
    n = 64
    pos = (rng.uniform(0, 10.0, (n, 3)) if box else rng.normal(size=(n, 3))
           ).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = np.asarray(jnb.direct_forces(jnp.asarray(pos), jnp.asarray(mass),
                                        softening=0.1, box_size=box))
    got = tnb.direct_forces(_t(pos), _t(mass), softening=0.1, box_size=box)
    assert _rel(got.numpy(), want) < 1e-3
    # and a float64 NumPy sum, the JAX test's reference
    expect = np.zeros((n, 3))
    for i in range(n):
        dx = pos.astype(np.float64) - pos[i]
        if box:
            dx -= box * np.round(dx / box)
        w = mass / ((dx ** 2).sum(-1) + 0.01) ** 1.5
        expect[i] = (w[:, None] * dx).sum(0)
    np.testing.assert_allclose(got.numpy(), expect, rtol=2e-4, atol=2e-4)


def test_direct_forces_leaves_matmul_precision_alone(rng):
    """The Gram form relies on full-float32 products and sets no global
    switch: PyTorch's defaults hold before and after."""
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    assert before == (False, "highest")
    pos = _t(rng.normal(size=(32, 3)).astype(np.float32))
    tnb.direct_forces(pos, torch.ones(32))
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision()) == before


@pytest.mark.parametrize("n", [257, 1000])
def test_blocked_twin_matches_pallas(rng, n):
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = np.asarray(direct_forces_pallas(
        jnp.asarray(pos), jnp.asarray(mass), softening=0.1, interpret=True))
    got = tops.direct_forces_blocked(_t(pos), _t(mass), softening=0.1)
    assert _rel(got.numpy(), want) < 1e-3
    gram = tnb.direct_forces(_t(pos), _t(mass), softening=0.1)
    assert _rel(got.numpy(), gram.numpy()) < 1e-3


def test_blocked_twin_periodic_matches_pallas(rng):
    n, box = 400, 10.0
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = np.asarray(direct_forces_pallas(
        jnp.asarray(pos), jnp.asarray(mass), softening=0.2, box_size=box,
        interpret=True))
    got = tops.direct_forces_blocked(_t(pos), _t(mass), softening=0.2,
                                     box_size=box)
    assert _rel(got.numpy(), want) < 1e-3
    dense = tnb.direct_forces(_t(pos), _t(mass), softening=0.2, box_size=box)
    assert _rel(got.numpy(), dense.numpy()) < 1e-3


def test_blocked_twin_zero_mass_padding(rng, monkeypatch):
    """Zero-mass sources add nothing, also across the twin's target
    blocks (forced small here)."""
    n = 300
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    a1 = tops.direct_forces_blocked(_t(pos), _t(mass), softening=0.1)
    pos2 = np.concatenate([pos, rng.normal(size=(50, 3)).astype(np.float32)])
    mass2 = np.concatenate([mass, np.zeros(50, np.float32)])
    monkeypatch.setattr(tops, "_PAIR_ELEMS", 350 * 7)
    a2 = tops.direct_forces_blocked(_t(pos2), _t(mass2), softening=0.1)[:n]
    np.testing.assert_allclose(a1.numpy(), a2.numpy(), atol=1e-5)
    want = np.asarray(direct_forces_pallas(
        jnp.asarray(pos2), jnp.asarray(mass2), softening=0.1,
        interpret=True))[:n]
    assert _rel(a2.numpy(), want) < 1e-3


def test_make_direct_force_fn_routes():
    assert tnb.make_direct_force_fn() is tnb.direct_forces
    f = tnb.make_direct_force_fn(use_pallas=True)
    pos = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    acc = f(pos, torch.ones(2), softening=0.0, G=2.0)
    np.testing.assert_allclose(acc.numpy(), [[2, 0, 0], [-2, 0, 0]],
                               rtol=1e-6)


def _cluster(rng, n=64):
    pos = rng.normal(scale=1.0, size=(n, 3)).astype(np.float32)
    vel = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    return pos, vel, np.full(n, 1.0 / n, np.float32)


def test_kdk_step_and_energy_match_jax(rng):
    pos, vel, mass = _cluster(rng)
    eps = 0.2
    jst = jnb.NBodyState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass))
    tst = tnb.nbody_state_from_numpy(pos, vel, mass, device=CPU)
    e0j = float(jnb.total_energy(jst, softening=eps))
    e0t = float(tnb.total_energy(tst, softening=eps))
    assert e0t == pytest.approx(e0j, rel=1e-5)
    jacc = jnb.direct_forces(jst.pos, jst.mass, softening=eps)
    tacc = tnb.direct_forces(tst.pos, tst.mass, softening=eps)
    for _ in range(200):
        jst, jacc = jnb.kdk_step(jst, jacc, 0.01, jnb.direct_forces,
                                 softening=eps)
        tst, tacc = tnb.kdk_step(tst, tacc, 0.01, tnb.direct_forces,
                                 softening=eps)
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos),
                               atol=1e-4)
    e1 = float(tnb.total_energy(tst, softening=eps))
    assert abs(e1 - e0t) / abs(e0t) < 2e-3
    # periodic wrap: torch.remainder as jnp.mod
    st, _ = tnb.kdk_step(
        tnb.nbody_state_from_numpy(pos, vel, mass, device=CPU),
        torch.zeros(64, 3), 5.0, lambda p, m, **_: torch.zeros_like(p),
        box_size=2.0)
    want = np.mod(pos + np.float32(5.0) * vel, np.float32(2.0))
    np.testing.assert_array_equal(st.pos.numpy(), want)


def _kepler_states(n, seed, snaps=2):
    ens = kepler_ensemble(n, snaps, seed=seed)
    return ens, [(ens.positions[s].astype(np.float32),
                  ens.velocities[s].astype(np.float32)) for s in range(snaps)]


@pytest.mark.parametrize("mode", ["pericentric", "apocentric"])
@pytest.mark.parametrize("identity", [True, False])
@pytest.mark.parametrize("box", [None, 10.0])
def test_detect_apsides_static_matches_jax(mode, identity, box):
    n, h = 512, 4
    _, states = _kepler_states(n, seed=11, snaps=4)
    mass = np.random.default_rng(2).uniform(0.5, 2, n).astype(np.float32)
    if box:
        states = [(np.mod(p + 5.0, box).astype(np.float32), v)
                  for p, v in states]
    members = np.arange(n, dtype=np.int32).reshape(h, n // h)
    if not identity:
        members = np.random.default_rng(3).permutation(n).astype(
            np.int32).reshape(h, n // h)
        members[:, -5:] = -1                      # padding slots
    jtr = jnb.init_track_state(h, n // h)
    ttr = tnb.init_track_state(h, n // h, device=CPU)
    for p, v in states:
        jst = jnb.NBodyState(jnp.asarray(p), jnp.asarray(v), jnp.asarray(mass))
        tst = tnb.nbody_state_from_numpy(p, v, mass, device=CPU)
        jtr, (jap, jrad, jc, jb) = jnb.detect_apsides_static(
            jtr, jst, jnp.asarray(members), mode=mode, box_size=box,
            identity=identity)
        ttr, (tap, trad, tc, tb) = tnb.detect_apsides_static(
            ttr, tst, members, mode=mode, box_size=box, identity=identity)
        np.testing.assert_array_equal(tap.numpy(), np.asarray(jap))
        np.testing.assert_array_equal(ttr.counts.numpy(),
                                      np.asarray(jtr.counts))
        np.testing.assert_allclose(ttr.angles.numpy(), np.asarray(jtr.angles),
                                   atol=1e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
        np.testing.assert_allclose(trad.numpy(), np.asarray(jrad), rtol=1e-5,
                                   atol=1e-6)
    assert int(ttr.counts.sum()) > 0


def _kepler_run(n, seed, dt_div, n_steps, every, mode="pericentric"):
    ens = kepler_ensemble(n, 2, seed=seed)
    pos = ens.positions[0].astype(np.float32)
    vel = ens.velocities[0].astype(np.float32)
    mass = np.full(n, 1e-12, np.float32)
    zero = np.zeros((1, 3), np.float32)
    base = dict(dt=float(ens.period.min()) / dt_div, n_steps=n_steps,
                detect_every=every, mode=mode, softening=0.0)
    jst = jnb.NBodyState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass))
    tst = tnb.nbody_state_from_numpy(pos, vel, mass, device=CPU)
    jcfg = jnb.OrbitNBodyConfig(centers=jnp.asarray(zero),
                                bulk_vels=jnp.asarray(zero), **base)
    tcfg = tnb.OrbitNBodyConfig(centers=_t(zero), bulk_vels=_t(zero), **base)
    return jst, tst, jcfg, tcfg


def _counts_close(got, want, allowed=3):
    diff = np.asarray(got, np.int64) - np.asarray(want, np.int64)
    assert np.abs(diff).max() <= 1
    assert (diff != 0).sum() <= allowed, diff


def test_simulate_kepler_counts_match_jax_and_closed_form():
    """tests/test_nbody.py::test_tracking_counts_kepler on the port."""
    n = 64
    probe = kepler_ensemble(n, 2, e_range=(0.05, 0.5), seed=3)
    t_total = 2.2 * float(probe.period.max())
    ens = kepler_ensemble(n, 2, e_range=(0.05, 0.5), seed=3, dt=t_total)
    n_steps = 4000
    pos = ens.positions[0].astype(np.float32)
    vel = ens.velocities[0].astype(np.float32)
    mass = np.full(n, 1e-12, np.float32)
    zero = np.zeros((1, 3), np.float32)
    base = dict(dt=t_total / n_steps, n_steps=n_steps, detect_every=10,
                mode="pericentric", softening=0.0, G=1.0)
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    _, jtr, jev = jnb.simulate_with_tracking(
        jnb.NBodyState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass)),
        jnp.asarray(members),
        jnb.OrbitNBodyConfig(centers=jnp.asarray(zero),
                             bulk_vels=jnp.asarray(zero), **base),
        force_fn=jnb.point_mass_forces(GM=1.0))
    _, ttr, tev = tnb.simulate_with_tracking(
        tnb.nbody_state_from_numpy(pos, vel, mass, device=CPU), members,
        tnb.OrbitNBodyConfig(centers=_t(zero), bulk_vels=_t(zero), **base),
        force_fn=tnb.point_mass_forces(GM=1.0))
    counts = ttr.counts.numpy()[0]
    _counts_close(counts, ens.peri_counts[1])
    _counts_close(counts, np.asarray(jtr.counts)[0])
    assert tev.shape == (n_steps,) and tev.dtype == torch.int32
    assert int(tev.sum()) == counts.sum()
    # detections only on the cadence; the other steps record 0
    off = np.ones(n_steps, bool)
    off[9::10] = False
    assert not tev.numpy()[off].any()
    assert np.asarray(jev)[off].sum() == 0


def test_both_mode_matches_single_runs_and_jax():
    n = 512
    jst, tst, jcfg, tcfg = _kepler_run(n, 9, 40, 220, 4, mode="both")
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    force_t = tnb.point_mass_forces(GM=1.0)
    _, (tp, ta), ev = tnb.simulate_with_tracking(tst, members, tcfg, force_t)
    assert ev.shape == (220, 2)
    _, tp1, evp = tnb.simulate_with_tracking(
        tst, members, tcfg._replace(mode="pericentric"), force_t)
    _, ta1, eva = tnb.simulate_with_tracking(
        tst, members, tcfg._replace(mode="apocentric"), force_t)
    assert torch.equal(tp.counts, tp1.counts)
    assert torch.equal(ta.counts, ta1.counts)
    assert torch.equal(ev[:, 0], evp) and torch.equal(ev[:, 1], eva)
    assert int(tp.counts.sum()) > 0 and int(ta.counts.sum()) > 0
    _, (jp, ja), jev = jnb.simulate_with_tracking(
        jst, members, jcfg, jnb.point_mass_forces(GM=1.0))
    _counts_close(tp.counts.numpy(), np.asarray(jp.counts))
    _counts_close(ta.counts.numpy(), np.asarray(ja.counts))


def test_identity_fast_path_matches_gather():
    n = 512
    _, tst, _, tcfg = _kepler_run(n, 3, 40, 200, 4)
    force = tnb.point_mass_forces(GM=1.0)
    mem_host = np.arange(n, dtype=np.int32).reshape(2, n // 2)
    _, tr_id, ev_id = tnb.simulate_with_tracking(tst, mem_host, tcfg, force)
    _, tr_g, ev_g = tnb.simulate_with_tracking(
        tst, torch.from_numpy(mem_host), tcfg, force)          # no auto
    _, tr_x, _ = tnb.simulate_with_tracking(
        tst, torch.from_numpy(mem_host), tcfg, force, identity=True)
    assert torch.equal(tr_id.counts, tr_g.counts)
    assert torch.equal(tr_id.counts, tr_x.counts)
    assert torch.equal(ev_id, ev_g)
    assert int(tr_id.counts.sum()) > 0


@pytest.mark.parametrize("mode", ["pericentric", "both"])
def test_checkpoint_resume_exact(tmp_path, mode):
    """A run cut after 96 steps and resumed equals the straight run, bit
    for bit (counts, angles, positions, per-step events)."""
    n = 32
    _, tst, _, tcfg = _kepler_run(n, 5, 100, 160, 4, mode=mode)
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    force = tnb.point_mass_forces(GM=1.0)
    st_ref, tr_ref, ev_ref = tnb.simulate_with_tracking(tst, members, tcfg,
                                                        force)
    ck = str(tmp_path / "ck")
    tnb.run_tracked_simulation(tst, members, tcfg._replace(n_steps=96),
                               force, checkpoint_dir=ck, checkpoint_every=48)
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "step_00000048.pt", "step_00000096.pt"]
    st, tr, ev = tnb.run_tracked_simulation(
        tst, members, tcfg, force, checkpoint_dir=ck, checkpoint_every=48,
        resume=True)
    trs = (tr,) if mode != "both" else tr
    refs = (tr_ref,) if mode != "both" else tr_ref
    for a, b in zip(trs, refs):
        assert bool(a.primed)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(ev, ev_ref)
    assert torch.equal(st.pos, st_ref.pos)
    # resuming a finished run returns its saved end state
    st2, _, ev2 = tnb.run_tracked_simulation(
        tst, members, tcfg, force, checkpoint_dir=ck, checkpoint_every=48,
        resume=True)
    assert torch.equal(ev2, ev_ref) and torch.equal(st2.pos, st_ref.pos)


def test_state_handoff_from_jax():
    """JAX integrates k steps; its state and track go to the port, which
    finishes the run: counts as JAX's straight run, positions close."""
    n, k, total = 256, 60, 200
    jst, _, jcfg, _ = _kepler_run(n, 4, 40, total, 4)
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    jforce = jnb.point_mass_forces(GM=1.0)
    jst_f, jtr_f, jev_f = jnb.simulate_with_tracking(jst, members, jcfg,
                                                     jforce)
    jst_k, jtr_k, _ = jnb.simulate_with_tracking(
        jst, members, jcfg._replace(n_steps=k), jforce)
    tst = tnb.nbody_state_from_numpy(*(np.asarray(x) for x in jst_k),
                                     device=CPU)
    ttr = tnb.track_state_from_numpy(*(np.asarray(x) for x in jtr_k),
                                     device=CPU)
    assert bool(ttr.primed) and ttr.counts.dtype == torch.int32
    back = tnb.track_state_to_numpy(ttr)
    for a, b in zip(back, jtr_k):
        np.testing.assert_array_equal(a, np.asarray(b))
    zero = _t(np.zeros((1, 3), np.float32))
    tcfg = tnb.OrbitNBodyConfig(
        dt=jcfg.dt, n_steps=total - k, detect_every=4, softening=0.0,
        centers=zero, bulk_vels=zero)
    st, tr, ev = tnb.simulate_with_tracking(
        tst, members, tcfg, tnb.point_mass_forces(GM=1.0), track=ttr,
        step_offset=k)
    _counts_close(tr.counts.numpy(), np.asarray(jtr_f.counts))
    np.testing.assert_allclose(tnb.nbody_state_to_numpy(st).pos,
                               np.asarray(jst_f.pos), atol=1e-4)
    assert int(ev.sum()) == pytest.approx(
        int(np.asarray(jev_f)[k:].sum()), abs=3)


def test_array_valued_config_fields_accepted():
    rng = np.random.default_rng(0)
    n = 64
    st = tnb.nbody_state_from_numpy(
        rng.normal(size=(n, 3)).astype(np.float32) + 5.0,
        rng.normal(size=(n, 3)).astype(np.float32) * 0.1,
        np.full(n, 1e-12, np.float32), device=CPU)
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    cfg = tnb.OrbitNBodyConfig(
        dt=np.float32(0.01), n_steps=4, detect_every=2, mode="pericentric",
        softening=torch.tensor(0.0), box_size=np.float32(20.0),
        G=np.float64(1.0), angle_cut=torch.tensor(0.0),
        centers=np.zeros((1, 3), np.float32),
        bulk_vels=torch.zeros((1, 3)))
    _, tr, ev = tnb.simulate_with_tracking(st, members, cfg,
                                           tnb.point_mass_forces(GM=1.0))
    assert torch.isfinite(tr.angles).all() and ev.shape == (4,)


def test_bad_mode_and_track_mismatch_raise():
    st = tnb.NBodyState(torch.ones(16, 3), torch.zeros(16, 3), torch.ones(16))
    members = np.arange(16, dtype=np.int32).reshape(1, 16)
    with pytest.raises(ValueError, match="not recognized"):
        tnb.simulate_with_tracking(
            st, members, tnb.OrbitNBodyConfig(dt=0.1, n_steps=1,
                                              mode="bogus"))
    cfg = tnb.OrbitNBodyConfig(dt=0.01, n_steps=2, mode="both", softening=0.0,
                               centers=torch.zeros(1, 3),
                               bulk_vels=torch.zeros(1, 3))
    with pytest.raises(ValueError, match="pair"):
        tnb.simulate_with_tracking(
            st, members, cfg, tnb.point_mass_forces(),
            track=tnb.init_track_state(1, 16, device=CPU))
    tr = tnb.init_track_state(1, 16, device=CPU)
    with pytest.raises(ValueError, match="single"):
        tnb.simulate_with_tracking(
            st, members, cfg._replace(mode="pericentric"),
            tnb.point_mass_forces(), track=(tr, tr))


def test_constructors_default_to_cuda():
    """The state constructors resolve ``device='cuda'`` by default and
    raise without CUDA rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    z = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnb.nbody_state_from_numpy(z, z, np.ones(4, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnb.init_track_state(1, 4)


def test_pm_tracking_matches_jax():
    """tests/test_pm.py::test_pm_driven_tracking_runs on both packages:
    finite state, and per-particle counts equal but for a few particles
    off by one (PM forces agree to ~1e-6, the trajectories drift)."""
    from orbitanalysis_tpu.models.pm import make_pm_force_fn as jpm
    from orbitanalysis_tpu_torch.models.pm import make_pm_force_fn as tpm

    rng = np.random.default_rng(4)
    n, grid, box = 256, 32, 50.0
    pos = np.mod(np.full(3, box / 2, np.float32)
                 + rng.normal(scale=2.0, size=(n, 3)).astype(np.float32), box)
    vel = rng.normal(scale=0.2, size=(n, 3)).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    base = dict(dt=0.1, n_steps=50, detect_every=5, mode="pericentric",
                box_size=box, softening=0.0)
    _, jtr, _ = jnb.simulate_with_tracking(
        jnb.NBodyState(jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(mass)),
        jnp.asarray(members), jnb.OrbitNBodyConfig(**base),
        force_fn=jpm(grid))
    st, ttr, _ = tnb.simulate_with_tracking(
        tnb.nbody_state_from_numpy(pos, vel, mass, device=CPU), members,
        tnb.OrbitNBodyConfig(**base), force_fn=tpm(grid))
    assert torch.isfinite(st.pos).all() and torch.isfinite(ttr.angles).all()
    assert int(ttr.counts.sum()) > 0
    _counts_close(ttr.counts.numpy(), np.asarray(jtr.counts), allowed=5)
    assert jax.default_backend() == "cpu"


def test_integrator_runs_without_jax(tmp_path):
    """With jax and the JAX package blocked, the port's integrator runs:
    direct (Gram and the K14 path), PM with both deposits, P3M, and a
    checkpointed, resumed run; and the postprocessing, progenitor,
    on-the-fly, region and Gadget modules import and run on the CPU
    through a MemoryWriter."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "orbitanalysis_tpu"):
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from orbitanalysis_tpu_torch import models as m
        from orbitanalysis_tpu_torch.models.p3m import make_p3m_force_fn
        rng = np.random.default_rng(0)
        n = 256
        st = m.nbody_state_from_numpy(
            rng.uniform(0, 20, (n, 3)).astype(np.float32),
            rng.normal(scale=0.2, size=(n, 3)).astype(np.float32),
            np.full(n, 1.0 / n, np.float32), device="cpu")
        members = np.arange(n, dtype=np.int32).reshape(2, n // 2)
        cfg = m.OrbitNBodyConfig(dt=0.05, n_steps=6, detect_every=2,
                                 box_size=20.0, softening=0.1)
        forces = [m.direct_forces, m.make_direct_force_fn(use_pallas=True),
                  m.make_pm_force_fn(16),
                  m.make_pm_force_fn(16, deposit="sorted"),
                  make_p3m_force_fn(16)]
        for f in forces:
            out, tr, ev = m.simulate_with_tracking(st, members, cfg, f)
            assert torch.isfinite(out.pos).all() and ev.shape == (6,)
        ck = {str(tmp_path / "ck")!r}
        m.run_tracked_simulation(st, members, cfg._replace(n_steps=4),
                                 forces[2], checkpoint_dir=ck,
                                 checkpoint_every=2)
        _, tr, ev = m.run_tracked_simulation(
            st, members, cfg, forces[2], checkpoint_dir=ck,
            checkpoint_every=2, resume=True)
        _, tr2, ev2 = m.simulate_with_tracking(st, members, cfg, forces[2])
        assert torch.equal(tr.counts, tr2.counts) and torch.equal(ev, ev2)

        import orbitanalysis_tpu_torch as otp
        from orbitanalysis_tpu_torch import postprocessing, progenitors
        from orbitanalysis_tpu_torch.engine import gadget, onthefly, regions
        from orbitanalysis_tpu_torch.engine.io_hdf5 import MemoryWriter
        from orbitanalysis_tpu_torch.models.synthetic import churn_snapshots
        rng = np.random.default_rng(1)
        snaps, _ = churn_snapshots(2, 100, 4, box_size=30.0, seed=3)
        full = {{s: dict(ids=np.concatenate([d["ids"] for d in sn.values()]),
                         coordinates=np.concatenate(
                             [d["pos"] for d in sn.values()]),
                         velocities=np.concatenate(
                             [d["vel"] for d in sn.values()]))
                 for s, sn in enumerate(snaps)}}
        cat = {{s: (np.arange(2), np.stack([sn[h]["center"] for h in sn]),
                    np.full(2, 6.0)) for s, sn in enumerate(snaps)}}
        reg, load = regions.make_region_callbacks(full, cat, box_size=30.0)
        w = MemoryWriter()
        otp.track_orbits(np.arange(4), np.tile(np.arange(2), (4, 1)), reg,
                         load, "t", device="cpu", writer=w, verbose=False)
        otp.track_orbits_onthefly(3, np.tile(np.arange(2), (2, 1)), reg,
                                  load, "o_{{}}", device="cpu", writer=w,
                                  verbose=False)
        ap = postprocessing.Apsides("t", writer=w)
        ap.collate_apsides(savefile="c", angle_cut=0.0, device="cpu",
                           save_final_counts=True, verbose=False)
        od = postprocessing.OrbitDecomposition("t", writer=w)
        od.get_halo_decomposition_at_snapshot(1, angle_cut=0.0)
        ids, offs = progenitors.get_central_particle_ids_device(
            load(3, *reg(3, np.arange(2))), cat[3][1], n=10, device="cpu")
        assert progenitors.find_main_progenitors_device(
            full[2]["ids"], [0], ids, offs, device="cpu") == [0, 0]
        assert "o_003" in w.files and callable(
            gadget.make_gadget_callbacks) and callable(onthefly.track_orbits)
        assert sys.modules["jax"] is None
        for name in sys.modules:
            assert not name.startswith("orbitanalysis_tpu."), name
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
