"""The port's distributed PM (``models/pm_sharded.py``) against the JAX
package's.

The port runs on gloo worlds of 2 and 4 ranks (``tests/torch_ranks.py``,
one world a size for the whole module), every rank on the global arrays
(JAX's contract: each rank computes its block and the results are
gathered), so every rank's result is checked.  JAX runs on as many of
the conftest's virtual CPU devices.  At the JAX tests' sizes
(``tests/test_pm.py``, ``tests/test_p3m.py``):

- the slab deposit of each rank's routed lanes (K13's plain version
  here), its blocks assembled, within the deposit tests' ``rtol = atol
  = 2e-5`` of JAX's ``cic_deposit``, in one x-segment and in three;
  no float ``index_add_`` in the slab-resident and P3M forces; the psum
  path deposits through ``cic_deposit_auto`` and matches JAX within
  1e-4 through ``cic_deposit_sorted`` too;
- the grid solve within 1e-4 of JAX's sharded solve, the psum path
  within 1e-4 of JAX's, the slab-resident rows and scalar paths within
  2e-4 of JAX's, rows against scalar within 1e-5 with particles pinned
  just inside a slab's upper face (their +x corner reads the halo
  plane);
- distributed P3M within 1e-4 of JAX's single-device P3M, the reference
  JAX's own test holds its distributed P3M to (``tests/test_p3m.py:149``):
  JAX's distributed P3M lays its cells out ``cap_sr`` wide (1024 slots
  here, against ~80 particles in the fullest cell) and takes about three
  minutes a call on this CPU;
- ``bucket_factor=1.0`` on a thin slab gives JAX's NaN mask exactly;
  ``slab_occupancy`` equals JAX's; ``grid % D`` and ``n % D`` raise;
- through ``simulate_with_tracking`` the counts equal the port's
  single-device ``make_pm_force_fn`` counts and JAX's sharded counts
  exactly;
- ``ppermute`` on a ring, on a partial permutation (zeros where nothing
  arrives), as a self-send on a one-rank group and without a group, and
  ``all_to_all`` on complex64 with its bytes counted as complex64's.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbitanalysis_tpu.models import pm_sharded as jps
from orbitanalysis_tpu.models.nbody import (
    NBodyState as JState,
    OrbitNBodyConfig as JConfig,
    simulate_with_tracking as jax_simulate,
)
from orbitanalysis_tpu.models.p3m import make_p3m_force_fn as jax_p3m
from orbitanalysis_tpu.models.pm import cic_deposit as jax_deposit
from orbitanalysis_tpu.parallel import make_mesh as jax_mesh
from orbitanalysis_tpu_torch.models import pm_sharded as tps
from orbitanalysis_tpu_torch.models.nbody import (
    OrbitNBodyConfig,
    nbody_state_from_numpy,
    simulate_with_tracking,
)
from orbitanalysis_tpu_torch.models.pm import make_pm_force_fn
from orbitanalysis_tpu_torch.parallel.collectives import ppermute

from torch_ranks import run_world

torch.set_num_threads(1)

GRID, BOX, N = 32, 50.0, 4096
P3M = dict(grid=32, box=20.0, n=4096, soft=0.05)
SIM_N = 2048


def _inputs(d):
    rng = np.random.default_rng(7)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, N).astype(np.float32)
    # particles just inside each slab's upper face: their +x corner is
    # the next slab's first plane (the halo plane)
    h, loc = BOX / GRID, GRID // d
    pin = pos.copy()
    pin[:64, 0] = (np.arange(64) % d) * (BOX / d) + (loc - 0.1) * h
    p3m_pos = rng.uniform(0, P3M["box"], (P3M["n"], 3)).astype(np.float32)
    p3m_mass = rng.uniform(0.5, 2.0, P3M["n"]).astype(np.float32)
    # all particles in one thin X-slab: buckets overflow at factor 1
    thin = rng.uniform(0, BOX, (2048, 3)).astype(np.float32)
    thin[:, 0] = rng.uniform(0, BOX / 16, 2048)
    sim_pos = rng.uniform(0, BOX, (SIM_N, 3)).astype(np.float32)
    sim_vel = rng.normal(scale=0.2, size=(SIM_N, 3)).astype(np.float32)
    sim_mass = rng.uniform(0.5, 2.0, SIM_N).astype(np.float32)
    # the slab deposit's inputs: the pinned particles, and particles on
    # the slab faces and the y and z box faces (the folds)
    dep = pin.copy()
    faces = [r * (BOX / d) + dx for r in range(d)
             for dx in (0.0, 0.5 * h, -0.5 * h, 1e-4, -1e-4)]
    dep[64:64 + len(faces), 0] = np.mod(faces, BOX)
    for k, v in enumerate((0.0, 0.5 * h, BOX - 0.5 * h, BOX - 1e-4, BOX)):
        dep[128 + k, 1] = v
        dep[136 + k, 2] = v
        dep[144 + k, 1:] = v
    rho = np.asarray(jax_deposit(jnp.asarray(pos), jnp.asarray(mass), GRID,
                                 BOX))
    return dict(
        grid=GRID, box=BOX, pos=pos, mass=mass, pin_pos=pin, rho=rho,
        p3m_grid=P3M["grid"], p3m_box=P3M["box"], p3m_soft=P3M["soft"],
        p3m_pos=p3m_pos, p3m_mass=p3m_mass, thin_pos=thin,
        thin_mass=np.ones(2048, np.float32), bad_grid=8 * d + 1,
        sim_pos=sim_pos, sim_vel=sim_vel, sim_mass=sim_mass, dep_pos=dep,
        seg_cells=_seg_cells(loc))


def _seg_cells(loc, n_seg=3):
    """The segment limit that cuts a slab of ``loc`` planes of the
    ``GRID`` virtual grid into ``n_seg`` x-segments."""
    sx, sy = (GRID + 1) ** 2, GRID + 1
    return -(-loc // n_seg) * sx + sx + 2 * sy


@pytest.fixture(scope="module", params=[2, 4], ids=["D2", "D4"])
def world(request, tmp_path_factory):
    d = request.param
    work = tmp_path_factory.mktemp(f"pm_sharded_{d}")
    inp = _inputs(d)
    np.savez(work / "pm_sharded_in.npz", **inp)
    outs = run_world("pm_sharded", d, str(work), timeout=200)
    return dict(d=d, inp=inp, outs=outs,
                mesh=jax_mesh({"x": d}, jax.devices()[:d]))


def _scale(ref):
    return np.abs(ref).max() + 1e-12


@pytest.mark.timeout(300)
def test_grid_solve_matches_jax(world):
    inp, d = world["inp"], world["d"]
    solve = jps.make_sharded_pm_grid_solver(world["mesh"], GRID)
    want = np.asarray(jax.jit(lambda r: solve(r, BOX))(
        jnp.asarray(inp["rho"])))
    loc = GRID // d
    for r, o in enumerate(world["outs"]):
        assert o["solve"].shape == (3, GRID, GRID, GRID)
        assert np.abs(o["solve"] - want).max() < 1e-4 * _scale(want)
        np.testing.assert_array_equal(o["local_solve"],
                                      o["solve"][:, r * loc:(r + 1) * loc])


@pytest.mark.timeout(300)
def test_psum_path_matches_jax(world):
    inp = world["inp"]
    f = jps.make_sharded_pm_force_fn(world["mesh"], GRID)
    want = np.asarray(jax.jit(lambda p, m: f(p, m, box_size=BOX))(
        jnp.asarray(inp["pos"]), jnp.asarray(inp["mass"])))
    for o in world["outs"]:
        assert np.abs(o["psum"] - want).max() < 1e-4 * _scale(want)


@pytest.mark.timeout(300)
def test_psum_path_deposits_through_auto(world):
    """The psum path calls ``cic_deposit_auto`` (K13 on CUDA tensors; the
    scatter ``cic_deposit`` on these CPU ones, whose float ``index_add_``
    the spy sees), and through ``cic_deposit_sorted``, K13's plain
    version, it still matches JAX within 1e-4."""
    inp = world["inp"]
    f = jps.make_sharded_pm_force_fn(world["mesh"], GRID)
    want = np.asarray(jax.jit(lambda p, m: f(p, m, box_size=BOX))(
        jnp.asarray(inp["pos"]), jnp.asarray(inp["mass"])))
    for o in world["outs"]:
        assert o["psum_calls"].tolist() == ["auto", "scatter"]
        assert int(o["psum_float_adds"]) > 0
        assert np.abs(o["psum_sorted"] - want).max() < 1e-4 * _scale(want)


@pytest.mark.timeout(300)
def test_slab_and_p3m_forces_reach_no_float_index_add(world):
    """The slab-resident rows and scalar paths and distributed P3M
    deposit through K13's stream (its plain version here), never a float
    ``index_add_``."""
    for o in world["outs"]:
        assert int(o["slab_float_adds"]) == 0


def _assemble(blocks, d):
    """The global density from each rank's ``[loc + 1, G, G]`` slab
    block: planes ``[r * loc, (r + 1) * loc)`` and the halo plane added
    onto the next slab's first."""
    loc = GRID // d
    rho = np.zeros((GRID, GRID, GRID), np.float64)
    for r, b in enumerate(blocks):
        rho[r * loc:(r + 1) * loc] += b[:loc]
        rho[((r + 1) * loc) % GRID] += b[loc]
    return rho


@pytest.mark.timeout(300)
def test_slab_deposit_assembles_to_jax_deposit(world):
    """Each rank's slab deposit of its routed lanes, the halo planes
    added, is JAX's ``cic_deposit`` within the deposit tests' ``rtol =
    atol = 2e-5``, with particles on the slab faces and the y and z box
    faces."""
    inp, d = world["inp"], world["d"]
    want = np.asarray(jax_deposit(jnp.asarray(inp["dep_pos"]),
                                  jnp.asarray(inp["mass"]), GRID, BOX))
    got = _assemble([o["slab_block"] for o in world["outs"]], d)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    for o in world["outs"]:
        assert o["slab_block"].shape == (GRID // d + 1, GRID, GRID)


@pytest.mark.timeout(300)
def test_slab_deposit_in_three_segments(world):
    """With the segment limit lowered, the slab deposit runs in three
    x-segments and matches the one-segment deposit and JAX within the
    same tolerance."""
    inp, d = world["inp"], world["d"]
    want = np.asarray(jax_deposit(jnp.asarray(inp["dep_pos"]),
                                  jnp.asarray(inp["mass"]), GRID, BOX))
    for o in world["outs"]:
        assert o["slab_segments"].tolist() == [-(-(GRID // d) // 3), 3]
        np.testing.assert_allclose(o["slab_block_seg"], o["slab_block"],
                                   rtol=2e-5, atol=2e-5)
    got = _assemble([o["slab_block_seg"] for o in world["outs"]], d)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("assignment", ["rows", "scalar"])
def test_slab_resident_matches_jax(world, assignment):
    """Both interpolations within 2e-4 of JAX's, and rows against scalar
    within 1e-5 on the pinned particles."""
    inp = world["inp"]
    f = jps.make_slab_resident_pm_force_fn(world["mesh"], GRID,
                                           assignment=assignment)
    want = np.asarray(jax.jit(lambda p, m: f(p, m, box_size=BOX))(
        jnp.asarray(inp["pin_pos"]), jnp.asarray(inp["mass"])))
    for o in world["outs"]:
        got = o[f"slab_{assignment}"]
        assert np.abs(got - want).max() < 2e-4 * _scale(want)
        assert (np.abs(o["slab_rows"] - o["slab_scalar"]).max()
                < 1e-5 * _scale(want))


@pytest.mark.timeout(300)
def test_slab_resident_p3m_matches_jax(world):
    inp = world["inp"]
    want = np.asarray(jax_p3m(P3M["grid"], sigma_cells=1.5)(
        jnp.asarray(inp["p3m_pos"]), jnp.asarray(inp["p3m_mass"]),
        box_size=P3M["box"], softening=P3M["soft"]))
    assert not np.isnan(want).any()
    for o in world["outs"]:
        assert not np.isnan(o["p3m"]).any()
        assert np.abs(o["p3m"] - want).max() < 1e-4 * _scale(want)


@pytest.mark.timeout(300)
def test_overflow_nan_mask_and_occupancy_match_jax(world):
    """Bucket overflow is a NaN force on exactly JAX's particles, never a
    zero; the occupancy helper equals JAX's."""
    inp, mesh = world["inp"], world["mesh"]
    f = jps.make_slab_resident_pm_force_fn(mesh, GRID, bucket_factor=1.0)
    want = np.asarray(jax.jit(lambda p, m: f(p, m, box_size=BOX))(
        jnp.asarray(inp["thin_pos"]), jnp.asarray(inp["thin_mass"])))
    assert np.isnan(want).any() and not np.isnan(want).all()
    occ = jps.make_slab_resident_pm_force_fn(mesh, GRID).slab_occupancy(
        inp["pos"], BOX)
    for o in world["outs"]:
        np.testing.assert_array_equal(np.isnan(o["thin"]), np.isnan(want))
        ok = ~np.isnan(want)
        assert np.abs(o["thin"][ok] - want[ok]).max() < 2e-4 * _scale(
            want[ok])
        np.testing.assert_array_equal(o["occupancy"], occ)
        assert o["occupancy"].sum() == N


@pytest.mark.timeout(300)
def test_contract_errors_raise(world):
    for o in world["outs"]:
        assert sorted(o["raised"].tolist()) == ["grid", "psum", "slab"]


@pytest.mark.timeout(300)
def test_integrator_counts_match_single_device_and_jax(world):
    """Counts through the slab-resident force equal the port's
    single-device PM counts and JAX's sharded counts exactly (as
    ``tests/test_pm.py:312-343`` asserts for JAX)."""
    inp, mesh = world["inp"], world["mesh"]
    n = SIM_N
    st = nbody_state_from_numpy(inp["sim_pos"], inp["sim_vel"],
                                inp["sim_mass"], device="cpu")
    cfg = OrbitNBodyConfig(dt=0.1, n_steps=8, detect_every=2, box_size=BOX)
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    _, tr, _ = simulate_with_tracking(st, members, cfg,
                                      force_fn=make_pm_force_fn(GRID))
    single = tr.counts.numpy()
    _, jtr, _ = jax_simulate(
        JState(jnp.asarray(inp["sim_pos"]), jnp.asarray(inp["sim_vel"]),
               jnp.asarray(inp["sim_mass"])),
        jnp.asarray(members),
        JConfig(dt=0.1, n_steps=8, detect_every=2, box_size=BOX),
        force_fn=jps.make_slab_resident_pm_force_fn(mesh, GRID))
    jcounts = np.asarray(jtr.counts)
    assert single.sum() > 0
    for o in world["outs"]:
        np.testing.assert_array_equal(o["sim_counts"], single)
        np.testing.assert_array_equal(o["sim_counts"], jcounts)


@pytest.mark.timeout(300)
def test_ppermute_and_complex_all_to_all(world):
    d = world["d"]
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
          for r in range(d)]
    for r, o in enumerate(world["outs"]):
        np.testing.assert_array_equal(o["ring"], xs[(r - 1) % d])
        np.testing.assert_array_equal(
            o["partial"], xs[0] if r == 1 else np.zeros((2, 3), np.float32))
        np.testing.assert_array_equal(o["self"], xs[r])
        sent = [np.arange(4.0 * d) + q - 1j * np.arange(4.0 * d)
                for q in range(d)]
        want = np.concatenate([s.reshape(d, -1)[r] for s in sent])
        np.testing.assert_array_equal(o["a2a_complex"], want.astype(
            np.complex64))
        assert int(o["a2a_complex_bytes"]) == 4 * d * 8
        # the bucket and pencil all_to_alls, the halo ppermutes and the
        # result gather of one slab-resident force evaluation
        a2a, perm, gath = o["slab_bytes"].tolist()
        assert a2a > 0 and gath == (N // d) * 3 * 4
        assert perm == (GRID * GRID + 3 * GRID * GRID) * 4


def test_ppermute_without_a_group_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert ppermute(x, None, [(0, 0)]) is x


def test_factories_have_jax_signatures():
    for name in ("make_sharded_pm_grid_solver",
                 "make_slab_resident_pm_force_fn",
                 "make_sharded_pm_force_fn"):
        want = inspect.signature(getattr(jps, name)).parameters
        got = inspect.signature(getattr(tps, name)).parameters
        assert list(got) == list(want), name
        assert [p.default for p in got.values()] == [
            p.default for p in want.values()], name
