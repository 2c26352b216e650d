"""The port's ``parallel/`` package against the JAX package's.

In the test process: the sharding rule (``tree_sharding_specs``, the
``[3, H, P]`` SoA case included) against JAX's, and a world of one (no
process group): meshes, blocks, collectives and the multihost helpers
are the identity, and the mesh contracts raise as JAX's do.

On a world of 2 gloo ranks (``tests/torch_ranks.py``): the multihost
helpers and the four collectives; the halo-sharded sorted and aligned
steps bit-equal to the port's single-process steps; the particle-sharded
label step against JAX's ``make_sharded_label_step`` on 2 of the
conftest's virtual CPU devices (counts, indices and ``lab_sv`` exact;
bulk velocities and angles as ``tests/test_label.py``'s sharded test
holds them); the sharded direct forces against JAX's within 1e-5
relative, global arrays in and out, and the integrator through them
with JAX's counts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbitanalysis_tpu.ops.label_step import (
    init_label_carry as jax_label_carry,
)
from orbitanalysis_tpu.parallel import make_mesh as jax_mesh
from orbitanalysis_tpu.parallel import tree_sharding_specs as jax_specs
from orbitanalysis_tpu.parallel.label_sharded import (
    make_sharded_label_step as jax_label_step,
    shard_label_tree as jax_shard_label,
)
from orbitanalysis_tpu.parallel.nbody_sharded import (
    make_sharded_direct_force_fn as jax_force_fn,
)
from orbitanalysis_tpu_torch.engine.packing import stage_batch_aligned
from orbitanalysis_tpu_torch.models.synthetic import (
    churn_workload,
    label_churn_workload,
)
from orbitanalysis_tpu_torch.ops.apsis import Carry, SnapshotBatch
from orbitanalysis_tpu_torch.ops.sorted_step import (
    init_aligned_carry,
    init_sorted_carry,
    make_aligned_native_step,
    make_sorted_orbit_step,
    presort_snapshot,
)
from orbitanalysis_tpu_torch.parallel import (
    Mesh,
    gather_tree,
    make_halo_mesh,
    make_mesh,
    make_sharded_aligned_step,
    make_sharded_sorted_step,
    multihost,
    shard_tree,
    tree_sharding_specs,
)
from orbitanalysis_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
    process_allgather,
    psum,
)
from orbitanalysis_tpu_torch.parallel.sharding import take_block

from torch_ranks import run_world

torch.set_num_threads(1)

D = 2
#: steps of the integrator through the sharded direct forces
SIM_STEPS = 24


def _trees(h, p):
    """State and batch trees of the shapes the engines shard."""
    z = np.zeros
    return (
        Carry(ids=z((h, p), np.int32), rhat=z((3, h, p), np.float32),
              vrad=z((h, p), np.float32), angles=z((h, p), np.float32)),
        SnapshotBatch(ids=z((h, p), np.int32), pos=z((h, p, 3), np.float32),
                      vel=z((3, h, p), np.float32),
                      center=z((h, 3), np.float32), mass=None,
                      bulk_vel=z((h, 3), np.float32), hubble_drag=0.5,
                      slot=z((h, 2), np.int32)),
    )


@pytest.mark.parametrize("axes", [{"halos": 2}, {"halos": 2, "particles": 2},
                                  {"shards": 2}])
@pytest.mark.parametrize("h,p", [(4, 256), (3, 256), (8, 3)])
def test_sharding_specs_match_jax(axes, h, p):
    """The port's rule gives JAX's PartitionSpecs on every leaf: the
    halo axis first, SoA ``[3, H, P]`` leaves shifted by one (also at
    three halos), AoS leaves told apart by their trailing 3, particle
    axes of 4 or fewer entries replicated, scalars replicated."""
    n = int(np.prod(list(axes.values())))
    jm = jax_mesh(axes, jax.devices()[:n])
    tm = Mesh(axes, torch.device("cpu"))
    for tree in _trees(h, p):
        want = jax.tree.leaves(jax_specs(tree, jm),
                               is_leaf=lambda x: isinstance(
                                   x, jax.sharding.PartitionSpec))
        got = [s for s in tree_sharding_specs(tree, tm)
               if s is not None]
        assert [tuple(w) for w in want] == got


def test_world_of_one_is_the_identity():
    """Without a process group: a mesh of one rank, blocks equal to the
    whole, every collective and multihost helper the identity."""
    assert multihost.process_count() == 1 and multihost.is_primary()
    multihost.initialize()  # no launcher environment: nothing to start
    mesh = make_mesh({"halos": 1}, device="cpu")
    assert mesh.shape == {"halos": 1} and mesh.group("halos") is None
    assert make_halo_mesh(device="cpu").shape == {"halos": 1}
    carry, batch = _trees(4, 256)
    blocks = shard_tree(batch, mesh)
    assert isinstance(blocks.ids, torch.Tensor) and blocks.mass is None
    assert blocks.hubble_drag == 0.5
    back = gather_tree(blocks, mesh)
    for a, b in zip(batch, back):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b.numpy())
    x = torch.arange(6.0).reshape(2, 3)
    assert psum(x) is x and all_gather(x) is x and all_to_all(x) is x
    assert all_gather(x, tiled=False).shape == (1, 2, 3)
    np.testing.assert_array_equal(process_allgather(x.numpy()),
                                  x.numpy()[None])
    np.testing.assert_array_equal(multihost.allgather_host([3, 4]), [3, 4])
    assert multihost.broadcast_from_primary({"a": 1}) == {"a": 1}


def test_mesh_contracts_raise():
    """A mesh larger than the world raises; the sharded sorted and
    aligned steps need a 'halos' axis and refuse a 'particles' one; a
    block that does not divide raises; CUDA is not assumed."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh({"halos": 2}, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh({"halos": 2, "particles": 2}, device="cpu")
    mesh2d = make_mesh({"halos": 1, "particles": 1}, device="cpu")
    for make in (make_sharded_sorted_step, make_sharded_aligned_step):
        with pytest.raises(ValueError, match="halo axis only"):
            make(mesh2d, 128)
        with pytest.raises(ValueError, match="'halos'"):
            make(make_mesh({"shards": 1}, device="cpu"), 128)
    fake = Mesh({"halos": 2}, torch.device("cpu"))  # rank 0 of 2
    np.testing.assert_array_equal(take_block(np.arange(4), ("halos",), fake),
                                  [0, 1])
    with pytest.raises(ValueError, match="does not divide"):
        take_block(np.arange(3), ("halos",), fake)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh({"halos": 1})


# --------------------------------------------------------- world of 2

K = 128
ROW = 256


def _staged_inputs():
    """The churn sequence in the ID form, staged ID-sorted (the sorted
    step's) and in the stable layout (the aligned step's), SoA planes."""
    ids, pos, vel, cen, _ = churn_workload(4, 256, 5, seed=3)
    batch = SnapshotBatch(ids=ids, pos=pos, vel=vel, center=cen)
    return dict(sorted=presort_snapshot(batch, soa=True),
                aligned=stage_batch_aligned(batch, soa=True))


@pytest.fixture(scope="module")
def parallel_world(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_world")
    rng = np.random.default_rng(0)
    staged = _staged_inputs()
    inp = dict(K=K, row_width=ROW, frames="matmul", force_box=20.0)
    for name, b in staged.items():
        for f in ("ids", "pos", "vel", "center", "slot"):
            inp[f"{name}_{f}"] = getattr(b, f)
    lab, pos, vel, cen, _ = label_churn_workload(4, ROW, 4, seed=5)
    inp.update(label=lab, label_pos=pos, label_vel=vel, label_centers=cen,
               label_H=4, label_mass=rng.uniform(
                   0.5, 2.0, lab.shape[1]).astype(np.float32))
    inp["force_pos_free"] = rng.normal(size=(512, 3)).astype(np.float32)
    inp["force_pos_box"] = rng.uniform(0, 20, (512, 3)).astype(np.float32)
    inp["force_mass"] = rng.uniform(0.5, 2.0, 512).astype(np.float32)
    # the JAX dry run's integrator inputs (__graft_entry__.py:198-217),
    # run for more steps so that apsides occur
    sim_rng = np.random.default_rng(0)
    n_sim = 64 * D
    inp["sim_pos"] = sim_rng.normal(size=(n_sim, 3)).astype(np.float32)
    inp["sim_vel"] = sim_rng.normal(scale=0.3,
                                    size=(n_sim, 3)).astype(np.float32)
    inp["sim_mass"] = np.full(n_sim, 1.0 / n_sim, np.float32)
    inp["sim_steps"] = SIM_STEPS
    np.savez(work / "parallel_in.npz", **inp)
    outs = run_world("parallel", D, str(work), timeout=150)
    return dict(inp=inp, outs=outs, staged=staged)


@pytest.mark.timeout(240)
def test_multihost_helpers_and_collectives(parallel_world):
    """allgather_host stacks in rank order, broadcast_from_primary gives
    rank 0's value; psum, all_gather (tiled on either axis, or stacked)
    and all_to_all give lax's results."""
    outs = parallel_world["outs"]
    xs = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
          for r in range(D)]
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["allgather"], [[0, 100], [1, 101]])
        np.testing.assert_array_equal(o["bcast"], [7])
        np.testing.assert_array_equal(o["psum"], sum(xs))
        np.testing.assert_array_equal(o["gather0"], np.concatenate(xs, 0))
        np.testing.assert_array_equal(o["gather1"], np.concatenate(xs, 1))
        np.testing.assert_array_equal(o["stack"], np.stack(xs))
        sent = [np.arange(4 * D) + 100 * q for q in range(D)]
        want = np.concatenate([s.reshape(D, -1)[r] for s in sent])
        np.testing.assert_array_equal(o["a2a"], want)


def _single_steps(name, staged):
    """The port's single-process step over the whole staged sequence."""
    b = staged[name]
    h, p = b.ids.shape[1:]
    if name == "sorted":
        step = make_sorted_orbit_step(K, box_size=100.0, fused=True,
                                      cur_presorted=True, soa_batch=True)
        carry = init_sorted_carry(h, p, device="cpu")
    else:
        step = make_aligned_native_step(K, box_size=100.0, soa_batch=True)
        carry = init_aligned_carry(h, p, device="cpu")
    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x))

    evs = []
    for s in range(b.ids.shape[0]):
        carry, ev = step(carry, SnapshotBatch(
            ids=t(b.ids[s]), pos=t(b.pos[s]), vel=t(b.vel[s]),
            center=t(b.center[s]), slot=t(b.slot[s])))
        evs.append(ev)
    return evs, carry


@pytest.mark.timeout(240)
@pytest.mark.parametrize("name", ["sorted", "aligned"])
def test_halo_sharded_steps_equal_single_process(parallel_world, name):
    """Each rank's rows of events and carry are the single-process
    step's rows, bit for bit (no collective inside the step)."""
    outs, staged = parallel_world["outs"], parallel_world["staged"]
    evs, carry = _single_steps(name, staged)
    total = 0
    for s, ev in enumerate(evs):
        for f in ("count", "ids", "angles"):
            got = np.concatenate([o[f"{name}_{f}_{s}"] for o in outs])
            np.testing.assert_array_equal(got, getattr(ev, f).numpy(),
                                          err_msg=f"{name} {f} {s}")
        total += int(ev.count.sum())
    assert total > 0
    for f, v in carry._asdict().items():
        axis = 1 if v.dim() == 3 and v.shape[0] == 3 else 0
        got = np.concatenate([o[f"{name}_carry_{f}"] for o in outs], axis)
        np.testing.assert_array_equal(got, v.numpy(), err_msg=f)


@pytest.mark.timeout(240)
def test_label_sharded_step_matches_jax(parallel_world):
    """Two ranks against JAX's particle-sharded label step on two
    devices: the same global event indices and counts, lab_sv planes
    equal, bulk velocities and angles as the JAX package's own sharded
    test holds them against its single-device step."""
    inp, outs = parallel_world["inp"], parallel_world["outs"]
    mesh = jax_mesh({"particles": D}, jax.devices()[:D])
    n = inp["label"].shape[1]
    step, _ = jax_label_step(mesh, K, int(inp["label_H"]), box_size=100.0,
                             row_width=ROW, frames="matmul")
    step = jax.jit(step)
    carry = jax_shard_label(mesh, jax_label_carry(n, row_width=ROW))
    total = 0
    for s in range(inp["label"].shape[0]):
        carry, ev = step(carry, (
            jnp.asarray(inp["label_pos"][s]), jnp.asarray(inp["label_vel"][s]),
            jnp.asarray(inp["label"][s]), jnp.asarray(inp["label_centers"][s]),
            jnp.asarray(inp["label_mass"]), jnp.float32(0)))
        ev = jax.tree.map(np.asarray, ev)
        for o in outs:
            np.testing.assert_allclose(o[f"label_bulk_vel_{s}"], ev.bulk_vel,
                                       rtol=1e-5, atol=1e-5)
        count = np.concatenate([o[f"label_count_{s}"] for o in outs])
        np.testing.assert_array_equal(count, ev.count)
        index = np.concatenate([o[f"label_index_{s}"] for o in outs])
        angle = np.concatenate([o[f"label_angle_{s}"] for o in outs])
        for r, k in enumerate(count):
            k = min(int(k), K)
            np.testing.assert_array_equal(index[r, :k], ev.index[r, :k])
            np.testing.assert_allclose(angle[r, :k], ev.angle[r, :k],
                                       atol=2e-3)
        total += int(count.sum())
    assert total > 0
    lab_sv = np.concatenate([o["label_lab_sv"] for o in outs])
    np.testing.assert_array_equal(lab_sv.view(np.uint32),
                                  np.asarray(carry.lab_sv))


def _f64_forces(pos, mass, softening, box=None):
    """The pair sum in float64 (NumPy), the reference both packages'
    float32 forms are measured against."""
    p = pos.astype(np.float64)
    dx = p[None, :, :] - p[:, None, :]
    if box is not None:
        dx = dx - box * np.round(dx / box)
    d2 = (dx * dx).sum(-1) + softening * softening
    return ((mass[None, :] / d2 ** 1.5)[..., None] * dx).sum(1)


@pytest.mark.timeout(240)
def test_sharded_direct_forces_match_jax(parallel_world):
    """The sharded pair sum against JAX's on two devices, measured in
    units of the RMS acceleration: the global arrays in and out on every
    rank (JAX's contract), and ``force.local`` on each rank's block (the
    block body) equal to the global result's block.  The periodic form
    (direct differences) agrees within 1e-5.  The free form is the Gram
    product ``|x|^2 + |y|^2 - 2 x.y`` in float32, whose own error against
    a float64 sum is ~3e-5 on these inputs in either package (the JAX
    package holds its sharded form to 1e-4 of its direct form,
    ``tests/test_distributed.py``): there the two agree within 1e-4 and
    the port's error is no larger than twice JAX's.  A particle count
    that does not divide over the ranks raises."""
    inp, outs = parallel_world["inp"], parallel_world["outs"]
    mesh = jax_mesh({"particles": D}, jax.devices()[:D])
    f = jax_force_fn(mesh)
    n = inp["force_mass"].shape[0]
    for tag, box, tol in (("free", None, 1e-4),
                          ("box", inp["force_box"], 1e-5)):
        pos = inp[f"force_pos_{tag}"]
        kw = {} if box is None else dict(box_size=box)
        want = np.asarray(jax.jit(lambda p, m: f(p, m, softening=0.1, **kw))(
            jnp.asarray(pos), jnp.asarray(inp["force_mass"])))
        ref = _f64_forces(pos, inp["force_mass"], 0.1, box)
        rms = np.sqrt((ref ** 2).sum(1).mean())
        local = np.concatenate([o[f"force_local_{tag}"] for o in outs])
        for r, o in enumerate(outs):
            got = o[f"force_{tag}"]
            assert got.shape == (n, 3), tag
            np.testing.assert_array_equal(got, local)
            assert np.abs(got - want).max() < tol * rms, tag
            assert (np.abs(got - ref).max()
                    <= 2 * np.abs(want - ref).max() + 1e-6 * rms), tag
    assert all(bool(o["force_odd_raises"]) for o in outs)


@pytest.mark.timeout(240)
def test_sharded_direct_integrator_counts_match_jax(parallel_world):
    """F5: ``simulate_with_tracking`` over the replicated state with
    ``make_sharded_direct_force_fn`` on 2 ranks gives JAX's counts (the
    JAX dry run's call, ``__graft_entry__.py:199-220``, on 2 virtual
    devices, for SIM_STEPS steps) on every rank, and the same positions.
    A force function that took the global arrays as a block would sum
    every source twice and double the accelerations."""
    from orbitanalysis_tpu.models.nbody import (
        NBodyState,
        OrbitNBodyConfig,
        simulate_with_tracking,
    )

    inp, outs = parallel_world["inp"], parallel_world["outs"]
    n = inp["sim_mass"].shape[0]
    mesh = jax_mesh({"particles": D}, jax.devices()[:D])
    st = NBodyState(jnp.asarray(inp["sim_pos"]), jnp.asarray(inp["sim_vel"]),
                    jnp.asarray(inp["sim_mass"]))
    cfg = OrbitNBodyConfig(dt=0.05, n_steps=SIM_STEPS, detect_every=1,
                           softening=0.2)
    fin, tr, _ = simulate_with_tracking(
        st, jnp.arange(n, dtype=jnp.int32).reshape(1, n), cfg,
        force_fn=jax_force_fn(mesh))
    want = np.asarray(tr.counts)
    assert want.sum() > 0
    for o in outs:
        np.testing.assert_array_equal(o["sim_counts"], want)
        np.testing.assert_allclose(o["sim_pos"], np.asarray(fin.pos),
                                   atol=1e-4)
