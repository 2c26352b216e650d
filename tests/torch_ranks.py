"""Worlds of ranks for the port's distributed tests: each rank is a
process of a ``torch.distributed`` gloo world on the CPU.

The test process writes a task's inputs to ``<work>/<task>_in.npz``
(made from a seed with numpy), :func:`run_world` starts the ranks
(``python tests/torch_ranks.py <task> <store> <rank> <world> <work>``,
a ``file://`` store under the test's own directory, so parallel test
workers never share a port), each rank runs ``TASKS[task]`` and writes
``<work>/<task>_out_<rank>.npz`` (and, for the tracker tasks, rank 0
its savefiles), and the test compares.  A rank imports neither JAX nor
the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_TESTS)


def run_world(task: str, n: int, work: str, timeout: float = 150):
    """Run ``task`` on ``n`` ranks; raise with the ranks' output when a
    rank fails or the world does not end within ``timeout`` seconds.
    Every rank is killed on the way out."""
    store = os.path.join(work, f"{task}_store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT, _TESTS] + env.get("PYTHONPATH", "").split(os.pathsep))
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, store,
             str(r), str(n), work],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=work)
        for r in range(n)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or f"RANK{r}_OK" not in out:
            raise AssertionError(f"rank {r} of {task} failed "
                                 f"(exit {p.returncode}):\n{out[-4000:]}")
    return [dict(np.load(os.path.join(work, f"{task}_out_{r}.npz")))
            for r in range(n)]


def save_snaps(path, snaps, **extra):
    """Per-halo snapshot dicts (``models.synthetic.churn_snapshots``) as
    one ``.npz``."""
    arrays = dict(extra)
    for s, snap in enumerate(snaps):
        for h, d in snap.items():
            for k, v in d.items():
                arrays[f"s{s}_h{h}_{k}"] = np.asarray(v)
    np.savez(path, n_snaps=len(snaps), **arrays)


def load_snaps(data):
    """The snapshot dicts of :func:`save_snaps`."""
    snaps = [dict() for _ in range(int(data["n_snaps"]))]
    for key in data.files:
        if not key.startswith("s") or "_h" not in key:
            continue
        s, h, name = key.split("_", 2)
        snaps[int(s[1:])].setdefault(int(h[1:]), {})[name] = data[key]
    return snaps


# ------------------------------------------------------------------ tasks

def task_parallel(rank, world, work):
    """multihost helpers, the four collectives, and the halo-sharded
    sorted and aligned steps, the particle-sharded label step, the
    sharded direct forces (global and block forms) and the integrator
    through them."""
    import torch

    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu_torch.ops.label_step import init_label_carry
    from orbitanalysis_tpu_torch.ops.sorted_step import (
        init_aligned_carry,
        init_sorted_carry,
    )
    from orbitanalysis_tpu_torch.parallel import (
        make_mesh,
        make_sharded_aligned_step,
        make_sharded_direct_force_fn,
        make_sharded_sorted_step,
        multihost,
        shard_tree,
    )
    from orbitanalysis_tpu_torch.parallel.collectives import (
        all_gather,
        all_to_all,
        psum,
    )
    from orbitanalysis_tpu_torch.parallel.label_sharded import (
        make_sharded_label_step,
        shard_label_tree,
    )

    inp = np.load(os.path.join(work, "parallel_in.npz"))
    out = {}
    assert multihost.process_count() == world
    assert multihost.is_primary() == (rank == 0)
    out["allgather"] = multihost.allgather_host(np.array([rank, 100 + rank]))
    out["bcast"] = np.asarray(
        multihost.broadcast_from_primary(np.array([7 * (rank + 1)])))

    mesh = make_mesh({"halos": world}, device="cpu")
    g = mesh.group("halos")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out["psum"] = psum(x, g).numpy()
    out["gather0"] = all_gather(x, g, axis=0).numpy()
    out["gather1"] = all_gather(x, g, axis=1).numpy()
    out["stack"] = all_gather(x, g, tiled=False).numpy()
    out["a2a"] = all_to_all(
        torch.arange(4 * world, dtype=torch.int64) + 100 * rank, g).numpy()

    # halo-sharded sorted and aligned steps over a churn sequence
    S = int(inp["sorted_ids"].shape[0])
    K = int(inp["K"])
    for name, make, init in (
            ("sorted", make_sharded_sorted_step, init_sorted_carry),
            ("aligned", make_sharded_aligned_step, init_aligned_carry)):
        h, p = inp[f"{name}_ids"].shape[1:]
        kw = dict(box_size=100.0)
        if name == "sorted":
            kw.update(fused=True, cur_presorted=True, soa_batch=True)
        else:
            kw.update(soa_batch=True)
        step = make(mesh, K, **kw)
        carry = shard_tree(init(h, p, device="cpu"), mesh)
        for s in range(S):
            batch = shard_tree(SnapshotBatch(
                ids=inp[f"{name}_ids"][s], pos=inp[f"{name}_pos"][s],
                vel=inp[f"{name}_vel"][s], center=inp[f"{name}_center"][s],
                slot=inp[f"{name}_slot"][s]), mesh)
            carry, ev = step(carry, batch)
            for f in ("count", "ids", "angles"):
                out[f"{name}_{f}_{s}"] = getattr(ev, f).numpy()
        for f, v in carry._asdict().items():
            out[f"{name}_carry_{f}"] = v.numpy()

    # particle-sharded label step
    lmesh = make_mesh({"particles": world}, device="cpu")
    n = int(inp["label"].shape[1])
    rw = int(inp["row_width"])
    step, n_shards = make_sharded_label_step(
        lmesh, K, int(inp["label_H"]), box_size=100.0, row_width=rw,
        frames=str(inp["frames"]))
    assert n_shards == world
    carry = shard_label_tree(lmesh, init_label_carry(n, row_width=rw,
                                                     device="cpu"))
    lo, hi = rank * n // world, (rank + 1) * n // world
    for s in range(inp["label"].shape[0]):
        mass = torch.from_numpy(inp["label_mass"][lo:hi])
        carry, ev = step(carry, (
            torch.from_numpy(inp["label_pos"][s][:, lo:hi].copy()),
            torch.from_numpy(inp["label_vel"][s][:, lo:hi].copy()),
            torch.from_numpy(inp["label"][s][lo:hi].copy()),
            torch.from_numpy(inp["label_centers"][s]), mass, 0.0))
        for f in ("count", "index", "angle", "bulk_vel"):
            out[f"label_{f}_{s}"] = getattr(ev, f).numpy()
    out["label_lab_sv"] = carry.lab_sv.numpy()

    # sharded direct forces, free and periodic: the global arrays in
    # and out (JAX's contract), and the block body on this rank's block
    fmesh = make_mesh({"particles": world}, device="cpu")
    force = make_sharded_direct_force_fn(fmesh)
    n = inp["force_mass"].shape[0]
    lo, hi = rank * n // world, (rank + 1) * n // world
    mass = torch.from_numpy(inp["force_mass"])
    for tag, box in (("free", None), ("box", float(inp["force_box"]))):
        pos = torch.from_numpy(inp[f"force_pos_{tag}"])
        out[f"force_{tag}"] = force(pos, mass, softening=0.1,
                                    box_size=box).numpy()
        out[f"force_local_{tag}"] = force.local(
            pos[lo:hi], mass[lo:hi], softening=0.1, box_size=box).numpy()
    try:
        force(pos[:n - 1], mass[:n - 1])
        out["force_odd_raises"] = np.array(False)
    except ValueError:
        out["force_odd_raises"] = np.array(True)

    # the integrator over the replicated state with the sharded direct
    # forces (the JAX dry run's call, __graft_entry__.py:199-220)
    from orbitanalysis_tpu_torch.models.nbody import (
        OrbitNBodyConfig,
        nbody_state_from_numpy,
        simulate_with_tracking,
    )

    st = nbody_state_from_numpy(inp["sim_pos"], inp["sim_vel"],
                                inp["sim_mass"], device="cpu")
    n_sim = inp["sim_mass"].shape[0]
    cfg = OrbitNBodyConfig(dt=0.05, n_steps=int(inp["sim_steps"]),
                           detect_every=1, softening=0.2)
    fin, tr, _ = simulate_with_tracking(
        st, np.arange(n_sim, dtype=np.int32).reshape(1, n_sim), cfg,
        force_fn=force)
    out["sim_counts"] = tr.counts.numpy()
    out["sim_pos"] = fin.pos.numpy()
    return out


def task_hash(rank, world, work):
    """The hash-sharded step from a given carry, the scan with its
    device router, the router against the host router, and router
    overflow."""
    import torch

    from orbitanalysis_tpu_torch.parallel import make_mesh
    from orbitanalysis_tpu_torch.parallel import hash_sharded as hs
    from orbitanalysis_tpu_torch.parallel.sharding import shard_rows

    inp = np.load(os.path.join(work, "hash_in.npz"))
    mesh = make_mesh({"shards": world}, device="cpu")
    K, cap = int(inp["K"]), int(inp["cap"])
    box = float(inp["box"])
    out = {}

    def flat_of(tag, s):
        f = dict(halo=inp[f"{tag}_halo_{s}"], ids=inp[f"{tag}_ids_{s}"],
                 pos=inp[f"{tag}_pos_{s}"], vel=inp[f"{tag}_vel_{s}"])
        if f"{tag}_mass_{s}" in inp:
            f["mass"] = inp[f"{tag}_mass_{s}"]
        return f

    for tag in ("plain", "mass"):
        S, H = int(inp[f"{tag}_S"]), int(inp[f"{tag}_H"])
        step = hs.make_hash_sharded_step(mesh, H, K, box_size=box)
        carry = shard_rows(hs.hash_carry_from_numpy(
            [inp[f"{tag}_carry_{f}"] for f in hs.HashCarry._fields],
            device="cpu"), mesh, "shards")
        for s in range(S):
            flat = flat_of(tag, s)
            batch = shard_rows(hs.route_flat(flat, world, cap), mesh,
                               "shards")
            bulk = (torch.from_numpy(inp[f"{tag}_bulk_{s}"])
                    if f"{tag}_bulk_{s}" in inp else None)
            carry, ev = step(carry, batch,
                             torch.from_numpy(inp[f"{tag}_centers_{s}"]),
                             bulk)
            for f, v in ev._asdict().items():
                out[f"{tag}_ev_{f}_{s}"] = v.numpy()
        for f, v in hs.hash_carry_to_numpy(carry)._asdict().items():
            out[f"{tag}_carry_{f}"] = v

    # the scan: device routing + step over the whole sequence
    S, H = int(inp["plain_S"]), int(inp["plain_H"])
    seqs = [hs.flat_to_position_shards(flat_of("plain", s), world,
                                        pad_to=int(inp["scan_L"]))
            for s in range(S)]
    flat_seq = hs.FlatRecords(*(
        None if parts[0] is None else torch.from_numpy(
            np.stack(parts)[:, rank:rank + 1].copy())
        for parts in zip(*seqs)))
    scan = hs.make_hash_scan(mesh, H, K, cap, box_size=box)
    carry = shard_rows(hs.init_hash_carry(world, cap, H, device="cpu"),
                       mesh, "shards")
    carry, evs, dropped = scan(
        carry, flat_seq, torch.from_numpy(np.stack(
            [inp[f"plain_centers_{s}"] for s in range(S)])))
    for f, v in evs._asdict().items():
        out[f"scan_{f}"] = v.numpy()
    out["scan_dropped"] = dropped.numpy()

    # the device router against the host router
    flat = dict(halo=inp["router_halo"], ids=inp["router_ids"],
                pos=inp["router_pos"], vel=inp["router_vel"],
                mass=inp["router_mass"])
    rcap = int(inp["router_cap"])
    fl = shard_rows(hs.flat_to_position_shards(flat, world), mesh, "shards")
    batch, dropped = hs.make_device_router(mesh, rcap)(fl)
    for f, v in batch._asdict().items():
        out[f"router_{f}"] = v.numpy()
    out["router_dropped"] = dropped.numpy()

    # overflow is reported, not silent: every ID on shard 0
    n = int(inp["overflow_n"])
    flat = dict(halo=np.zeros(n, np.int32),
                ids=(np.arange(n) * world).astype(np.int64),
                pos=np.zeros((n, 3), np.float32),
                vel=np.zeros((n, 3), np.float32))
    fl = shard_rows(hs.flat_to_position_shards(flat, world), mesh, "shards")
    for tag, (c, b) in (("fits", (n, n // world)),
                        ("over", (n // 2, n // (2 * world)))):
        _, dropped = hs.make_device_router(mesh, c, block=b)(fl)
        out[f"overflow_{tag}"] = dropped.numpy()
    return out


def _tracker_runs(work, runs):
    """``track_orbits(mesh=...)`` runs of the task's snapshots; rank 0
    writes each run's savefiles under ``work``."""
    from helpers import make_callbacks

    from orbitanalysis_tpu_torch import track_orbits
    from orbitanalysis_tpu_torch.parallel import make_mesh
    from orbitanalysis_tpu_torch.utils.metrics import Metrics

    shift = np.int64(2) ** 33

    def loader_wide(s, rp, rr):
        d = dict(loader(s, rp, rr))
        d["ids"] = d["ids"].astype(np.int64) + shift
        return d

    def crashing(load, at):
        state = {"crashed": False}

        def load_crash(s, rp, rr):
            if s == at and not state["crashed"]:
                state["crashed"] = True
                raise RuntimeError("simulated crash")
            return load(s, rp, rr)

        return load_crash

    out = {}
    for name, axes, kw in runs:
        mesh = make_mesh(axes, device="cpu")
        kw = dict(kw)
        data = np.load(os.path.join(
            work, f"tracker_{kw.pop('data', 'churn')}_in.npz"))
        snaps = load_snaps(data)
        regions, loader = make_callbacks(snaps, None,
                                         box_size=float(data["box"]))
        snap_nums = np.arange(len(snaps))
        branches = np.tile(np.arange(len(snaps[0])), (len(snaps), 1))
        load = loader_wide if kw.pop("wide", False) else loader
        save = (tuple(os.path.join(work, f"{m}_{name}.h5")
                      for m in ("peri", "apo"))
                if kw.get("mode") == "both" else os.path.join(work,
                                                             f"{name}.h5"))
        metrics = Metrics()
        common = dict(verbose=False, device="cpu", mesh=mesh,
                      metrics=metrics)
        if kw.pop("resume", False):
            load_crash = crashing(load, 5)
            try:
                track_orbits(snap_nums, branches, regions, load_crash, save,
                             **common, **kw)
                raise AssertionError("the run did not crash")
            except RuntimeError as exc:
                assert "simulated crash" in str(exc), exc
            track_orbits(snap_nums, branches, regions, load_crash, save,
                         resume=True, **common, **kw)
        else:
            track_orbits(snap_nums, branches, regions, load, save,
                         **common, **kw)
        for key in ("event_capacity", "capacity"):
            out[f"{name}_{key}"] = np.array(
                [r[key] for r in metrics.records])
    return out


#: the growing snapshots at a capacity they outgrow
GROW = dict(data="grow", capacity=128, headroom=1.05)
#: the 2-rank tracker runs: (name, mesh axes, track_orbits kwargs)
TRACKER_RUNS = (
    ("halos_general", {"halos": 2}, dict(join_impl="general",
                                         checkpoint=True)),
    ("halos_sorted", {"halos": 2}, dict(join_impl="sorted",
                                        checkpoint=True)),
    ("halos_aligned", {"halos": 2}, dict(join_impl="aligned",
                                         checkpoint=True)),
    ("halos_aligned_resume", {"halos": 2}, dict(join_impl="aligned",
                                                checkpoint=True,
                                                resume=True)),
    # event lists of 4: the general engine falls back to the gathered
    # masks, the aligned one recovers from the gathered payload plane
    ("halos_general_spill", {"halos": 2}, dict(join_impl="general",
                                               event_capacity=4)),
    ("halos_aligned_spill", {"halos": 2}, dict(join_impl="aligned",
                                               event_capacity=4)),
    # regions that double at snapshot 4 past a capacity of 128: growth
    # on every rank
    ("grow_keep", {"halos": 2}, dict(GROW, join_impl="aligned",
                                     grow_impl="keep", checkpoint=True)),
    ("grow_general", {"halos": 2}, dict(GROW, join_impl="aligned",
                                        grow_impl="general")),
    # a shard holds ~164 records at snapshot 0 and ~246 from snapshot 4
    ("grow_shards", {"shards": 2}, dict(GROW, capacity=200,
                                        checkpoint=True)),
    ("shards", {"shards": 2}, dict(checkpoint=True)),
    ("shards_both", {"shards": 2}, dict(mode="both")),
    ("shards_wide", {"shards": 2}, dict(id_dtype=np.int64, wide=True,
                                        checkpoint=True)),
    ("shards_resume", {"shards": 2}, dict(checkpoint=True, resume=True)),
    ("shards_wide_resume", {"shards": 2}, dict(id_dtype=np.int64,
                                               wide=True, checkpoint=True,
                                               resume=True)),
    # both engines of the pair unmap their events through one ID map
    ("shards_both_wide", {"shards": 2}, dict(mode="both", id_dtype=np.int64,
                                             wide=True, checkpoint=True)),
    ("shards_both_wide_resume", {"shards": 2}, dict(
        mode="both", id_dtype=np.int64, wide=True, checkpoint=True,
        resume=True)),
)

#: the 4-rank run: the general engine on a ('halos', 'particles') mesh
TRACKER_RUNS_2D = (
    ("halos_particles", {"halos": 2, "particles": 2},
     dict(join_impl="general", checkpoint=True)),
)


def task_tracker(rank, world, work):
    return _tracker_runs(work, TRACKER_RUNS)


def task_tracker2d(rank, world, work):
    return _tracker_runs(work, TRACKER_RUNS_2D)


def task_pm_sharded(rank, world, work):
    """The distributed PM of ``models/pm_sharded.py`` on a mesh ``{'x':
    world}``: the grid solve, the psum path (and which depositor it
    calls), the slab-resident rows and scalar paths, distributed P3M (no
    float ``index_add_`` in either), the slab deposit alone in one and in
    several segments, the overflow NaN mask, the occupancy helper, the
    contract errors, the integrator through the slab force, and
    ``ppermute`` / complex ``all_to_all``."""
    import torch
    import torch.distributed as dist

    from orbitanalysis_tpu_torch.models import pm as tpm
    from orbitanalysis_tpu_torch.models import pm_sharded as ps
    from orbitanalysis_tpu_torch.models.nbody import (
        OrbitNBodyConfig,
        nbody_state_from_numpy,
        simulate_with_tracking,
    )
    from orbitanalysis_tpu_torch.ops import deposit as td
    from orbitanalysis_tpu_torch.parallel import make_mesh
    from orbitanalysis_tpu_torch.parallel.collectives import (
        all_to_all,
        ppermute,
        reset_sent_bytes,
        sent_bytes,
    )
    from orbitanalysis_tpu_torch.parallel.sharding import take_block

    inp = np.load(os.path.join(work, "pm_sharded_in.npz"))
    mesh = make_mesh({"x": world}, device="cpu")
    grid, box = int(inp["grid"]), float(inp["box"])
    out = {}

    def t(name):
        return torch.from_numpy(inp[name])

    solve = ps.make_sharded_pm_grid_solver(mesh, grid)
    out["solve"] = solve(t("rho"), box).numpy()
    i, loc = rank, solve.slab
    out["local_solve"] = solve.local_solve(
        t("rho")[i * loc:(i + 1) * loc], box).numpy()

    # the deposits the forces reach: a spy on float index_add_ while the
    # slab-resident and P3M forces run, then on the psum path, whose
    # depositors are spied too
    float_adds = []
    index_add = torch.Tensor.index_add_

    def spy_index_add(self, *args, **kw):
        if self.is_floating_point():
            float_adds.append(1)
        return index_add(self, *args, **kw)

    torch.Tensor.index_add_ = spy_index_add
    try:
        for a in ("rows", "scalar"):
            f = ps.make_slab_resident_pm_force_fn(mesh, grid, assignment=a)
            out[f"slab_{a}"] = f(t("pin_pos"), t("mass"),
                                 box_size=box).numpy()
        reset_sent_bytes()
        f = ps.make_slab_resident_pm_force_fn(mesh, grid,
                                              assignment="scalar")
        out["slab_pos"] = f(t("pos"), t("mass"), box_size=box).numpy()
        out["slab_bytes"] = np.array([sent_bytes()[k] for k in (
            "all_to_all", "ppermute", "all_gather")])
        out["occupancy"] = f.slab_occupancy(inp["pos"], box)
        p3m = ps.make_slab_resident_pm_force_fn(
            mesh, int(inp["p3m_grid"]), deconvolve=True,
            p3m_sigma_cells=1.5)
        out["p3m"] = p3m(t("p3m_pos"), t("p3m_mass"), box_size=float(
            inp["p3m_box"]), softening=float(inp["p3m_soft"])).numpy()
        out["slab_float_adds"] = np.array(len(float_adds))
        calls = []
        auto, scatter = tpm.cic_deposit_auto, tpm.cic_deposit

        def spy_auto(*args, **kw):
            calls.append("auto")
            return auto(*args, **kw)

        def spy_scatter(*args, **kw):
            calls.append("scatter")
            return scatter(*args, **kw)

        tpm.cic_deposit_auto, tpm.cic_deposit = spy_auto, spy_scatter
        try:
            out["psum"] = ps.make_sharded_pm_force_fn(mesh, grid)(
                t("pos"), t("mass"), box_size=box).numpy()
        finally:
            tpm.cic_deposit_auto, tpm.cic_deposit = auto, scatter
        out["psum_calls"] = np.array(calls)
        out["psum_float_adds"] = np.array(len(float_adds)) \
            - out["slab_float_adds"]
    finally:
        torch.Tensor.index_add_ = index_add
    # the psum path on K13's arithmetic: its plain version on the CPU
    tpm.cic_deposit_auto = td.cic_deposit_sorted
    try:
        out["psum_sorted"] = ps.make_sharded_pm_force_fn(mesh, grid)(
            t("pos"), t("mass"), box_size=box).numpy()
    finally:
        tpm.cic_deposit_auto = auto

    # the slab deposit alone, on this rank's routed lanes: one segment,
    # then the segment limit lowered to seg_cells
    def slab_block():
        pos_l = take_block(t("dep_pos"), ("x",), mesh)
        mass_l = take_block(t("mass"), ("x",), mesh)
        cap = ps._bucket_cap(4.0, pos_l.shape[0], world)
        lanes = ps._route(pos_l, mass_l, grid, box, loc, world, cap,
                          mesh.group("x"))[0]
        i0, fr = td.cic_base(lanes[:, :3], grid, box)
        return ps._slab_deposit(i0[:, 0] - rank * loc, i0, fr, lanes[:, 3],
                                grid, loc).numpy()

    out["slab_block"] = slab_block()
    limit = td._SEGMENT_CELLS
    td._SEGMENT_CELLS = int(inp["seg_cells"])
    try:
        out["slab_segments"] = np.array(td.x_segments(grid, loc))
        out["slab_block_seg"] = slab_block()
    finally:
        td._SEGMENT_CELLS = limit
    thin = ps.make_slab_resident_pm_force_fn(mesh, grid, bucket_factor=1.0)
    out["thin"] = thin(t("thin_pos"), t("thin_mass"), box_size=box).numpy()
    # the contract errors
    raised = []
    try:
        ps.make_sharded_pm_grid_solver(mesh, int(inp["bad_grid"]))
    except ValueError:
        raised.append("grid")
    for name, fn in (("slab", f), ("psum", ps.make_sharded_pm_force_fn(
            mesh, grid))):
        try:
            fn(t("pos")[:-1], t("mass")[:-1], box_size=box)
        except ValueError:
            raised.append(name)
    out["raised"] = np.array(raised)

    # the integrator through the slab-resident force
    st = nbody_state_from_numpy(inp["sim_pos"], inp["sim_vel"],
                                inp["sim_mass"], device="cpu")
    n = inp["sim_mass"].shape[0]
    cfg = OrbitNBodyConfig(dt=0.1, n_steps=8, detect_every=2, box_size=box)
    _, tr, _ = simulate_with_tracking(
        st, np.arange(n, dtype=np.int32).reshape(1, n), cfg,
        force_fn=ps.make_slab_resident_pm_force_fn(mesh, grid))
    out["sim_counts"] = tr.counts.numpy()

    # ppermute on the axis's group and on a gloo group of this rank alone
    # (a self-send), and all_to_all on complex64
    g = mesh.group("x")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out["ring"] = ppermute(x, g, [(d, (d + 1) % world)
                                  for d in range(world)]).numpy()
    out["partial"] = ppermute(x, g, [(0, 1)]).numpy()
    solo = [dist.new_group([r]) for r in range(world)][rank]
    out["self"] = ppermute(x, solo, [(0, 0)]).numpy()
    z = torch.complex(torch.arange(4.0 * world) + rank,
                      -torch.arange(4.0 * world))
    reset_sent_bytes()
    out["a2a_complex"] = all_to_all(z, g).numpy()
    out["a2a_complex_bytes"] = np.array(sent_bytes()["all_to_all"])
    return out


TASKS = dict(parallel=task_parallel, hash=task_hash, tracker=task_tracker,
             tracker2d=task_tracker2d, pm_sharded=task_pm_sharded)


def main(argv):
    task, store, rank, world, work = argv
    rank, world = int(rank), int(world)
    for name in ("jax", "jaxlib", "orbitanalysis_tpu"):
        sys.modules[name] = None  # a rank never imports them
    import torch

    torch.set_num_threads(1)
    from orbitanalysis_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{store}", world, rank, backend="gloo")
    try:
        out = TASKS[task](rank, world, work)
        np.savez(os.path.join(work, f"{task}_out_{rank}.npz"), **out)
    finally:
        multihost.shutdown()
    print(f"RANK{rank}_OK", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
