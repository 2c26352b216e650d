"""Entry points: the single-device step and a multi-device dry run (twin
of the repo's ``__graft_entry__.py``).

``entry()`` returns the package's flagship step, the fused per-snapshot
orbit-tracking step over a padded ``[n_halos, capacity]`` batch
(:mod:`orbitanalysis_tpu_torch.ops.apsis`), with example arguments on
the card.

``dryrun_multichip(n)`` runs one step of each distributed engine on a
world of ``n`` ranks, one rank a device: the general step on a
``('halos', 'particles')`` mesh and its scan driver, the halo-sharded
sorted and aligned steps, the integrator with the sharded direct forces,
the hash-sharded step and scan, the slab-resident distributed P3M
through the integrator, and the particle-sharded label step.  Called in
a running world of ``n`` ranks it runs this rank's part; otherwise it
spawns the ranks: gloo on the CPU when ``device='cpu'`` (as the JAX dry
run uses virtual CPU devices), else NCCL, one rank a card.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np


def _example_inputs(n_halos=8, capacity=256, seed=0, device="cuda"):
    import torch

    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch, init_carry
    from orbitanalysis_tpu_torch.utils.padding import invalid_id_for

    rng = np.random.default_rng(seed)
    invalid = invalid_id_for(np.int32)
    n_valid = capacity - 17  # leave some padding slots to exercise masking
    ids = np.full((n_halos, capacity), invalid, dtype=np.int32)
    ids[:, :n_valid] = rng.permutation(n_halos * n_valid).reshape(
        n_halos, n_valid)
    pos = rng.normal(size=(n_halos, capacity, 3)).astype(np.float32)
    vel = rng.normal(size=(n_halos, capacity, 3)).astype(np.float32)
    center = rng.normal(size=(n_halos, 3)).astype(np.float32)

    carry = init_carry(n_halos, capacity, device=device)
    snap = SnapshotBatch(
        ids=torch.from_numpy(ids).to(device),
        pos=torch.from_numpy(pos).to(device),
        vel=torch.from_numpy(vel).to(device),
        center=torch.from_numpy(center).to(device),
        mass=None,
        bulk_vel=None,
        hubble_drag=0.0,
    )
    return carry, snap


def entry(device="cuda"):
    """Return ``(fn, example_args)``: the forward step and its inputs on
    ``device`` (the card unless ``device='cpu'``)."""
    from orbitanalysis_tpu_torch.ops.apsis import make_orbit_step

    fn = make_orbit_step(mode="pericentric", box_size=100.0)
    return fn, _example_inputs(device=device)


def _host(tree):
    """A tree of tensors as NumPy arrays (scalars and None as they
    are)."""
    import torch

    return type(tree)(*(x.cpu().numpy() if isinstance(x, torch.Tensor)
                        else x for x in tree))


def _dryrun_rank(n_devices: int, device: str) -> None:
    """This rank's part of :func:`dryrun_multichip` in a running world of
    ``n_devices`` ranks."""
    import torch

    from orbitanalysis_tpu_torch.engine.scan import scan_events
    from orbitanalysis_tpu_torch.engine.tracker import _particles_step
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch, make_orbit_step
    from orbitanalysis_tpu_torch.parallel import make_mesh
    from orbitanalysis_tpu_torch.parallel.sharding import (
        gather_tree,
        shard_tree,
    )

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    # 2D mesh when possible: 'halos' = data parallelism over halo rows,
    # 'particles' = each row's particle axis split (the step gathers the
    # rows within the 'particles' group)
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh = make_mesh({"halos": n_devices // 2, "particles": 2},
                         device=device)
    else:
        mesh = make_mesh({"halos": n_devices}, device=device)
    n_halos = 2 * int(mesh.shape["halos"])
    capacity = 256  # divisible by any 'particles' axis used above
    carry, snap = _example_inputs(n_halos=n_halos, capacity=capacity,
                                  device="cpu")
    step = make_orbit_step(mode="pericentric", box_size=100.0)
    if "particles" in mesh.axis_names:
        step = _particles_step(step, mesh)
    carry, snap = shard_tree(carry, mesh), shard_tree(snap, mesh)
    new_carry, _ = step(carry, snap)
    sync()

    # the scan driver over this rank's rows (whole rows: the particle
    # blocks gathered) and a two-snapshot stack
    _, snap2 = _example_inputs(n_halos=n_halos, capacity=capacity, seed=1,
                               device="cpu")
    snap2 = shard_tree(snap2, mesh)
    rows = gather_tree(new_carry, mesh, axes=("particles",))
    s1, s2 = (gather_tree(s, mesh, axes=("particles",)) for s in (snap,
                                                                  snap2))
    stacked = SnapshotBatch(*(
        torch.stack([a, b]) if isinstance(a, torch.Tensor) else a
        for a, b in zip(s1, s2)))
    scan_events(rows, stacked, mode="pericentric", box_size=100.0)
    sync()

    # the sorted-carry fused-kernel step, halo-sharded
    from orbitanalysis_tpu_torch.engine.packing import stage_batch_aligned
    from orbitanalysis_tpu_torch.ops.sorted_step import (
        init_aligned_carry,
        init_sorted_carry,
        presort_snapshot,
    )
    from orbitanalysis_tpu_torch.parallel import (
        make_sharded_aligned_step,
        make_sharded_sorted_step,
    )

    hmesh = make_mesh({"halos": n_devices}, device=device)
    n_h = 2 * n_devices
    _, snap_s = _example_inputs(n_halos=n_h, capacity=128, seed=2,
                                device="cpu")
    sstep = make_sharded_sorted_step(hmesh, 128, fused=True,
                                     cur_presorted=True)
    sc = shard_tree(init_sorted_carry(n_h, 128, device="cpu"), hmesh)
    sstep(sc, shard_tree(presort_snapshot(_host(snap_s)), hmesh))
    sync()

    # the carry-native aligned step, halo-sharded: the stable-layout
    # host staging supplies the FRESH flags
    _, snap_al = _example_inputs(n_halos=n_h, capacity=128, seed=3,
                                 device="cpu")
    astep = make_sharded_aligned_step(hmesh, 128)
    ac = shard_tree(init_aligned_carry(n_h, 128, device="cpu"), hmesh)
    astep(ac, shard_tree(stage_batch_aligned(_host(snap_al)), hmesh))
    sync()

    # the integrator with the pair sum sharded over a particle axis
    # (every rank holds the global state; each computes its block's
    # accelerations and they are all-gathered)
    from orbitanalysis_tpu_torch.models.nbody import (
        OrbitNBodyConfig,
        nbody_state_from_numpy,
        simulate_with_tracking,
    )
    from orbitanalysis_tpu_torch.parallel import make_sharded_direct_force_fn

    np_rng = np.random.default_rng(0)
    pmesh = make_mesh({"particles": n_devices}, device=device)
    n_part = 64 * n_devices
    st = nbody_state_from_numpy(
        np_rng.normal(size=(n_part, 3)).astype(np.float32),
        np_rng.normal(scale=0.3, size=(n_part, 3)).astype(np.float32),
        np.full((n_part,), 1.0 / n_part, np.float32), device=pmesh.device)
    members = np.arange(n_part, dtype=np.int32).reshape(1, n_part)
    cfg = OrbitNBodyConfig(dt=0.05, n_steps=2, detect_every=1,
                           softening=0.2)
    simulate_with_tracking(st, members, cfg,
                           force_fn=make_sharded_direct_force_fn(pmesh))
    sync()

    # hash-sharded particle-axis tracking: the flat (halo, id) pool
    # sharded by id % D, shard-local join, psum'd bulk
    from orbitanalysis_tpu_torch.parallel import hash_sharded as hs
    from orbitanalysis_tpu_torch.parallel.sharding import shard_rows

    shmesh = make_mesh({"shards": n_devices}, device=device)
    nh, npph = 4, 40
    # a shard's capacity: JAX's 64, or twice the even share where fewer
    # ranks split the 160 records (the JAX dry run runs on 8 devices)
    hcap = max(64, -(-2 * nh * npph // n_devices // 64) * 64)
    hstep = hs.make_hash_sharded_step(shmesh, nh, 64, mode="pericentric",
                                      box_size=100.0)
    hcarry = shard_rows(hs.init_hash_carry(n_devices, hcap, nh,
                                           device="cpu"), shmesh, "shards")
    hcenters = np_rng.uniform(20, 80, size=(nh, 3)).astype(np.float32)

    def flat():
        return dict(
            halo=np.repeat(np.arange(nh, dtype=np.int32), npph),
            ids=np.concatenate(
                [np_rng.permutation(npph) + 1000 * h for h in range(nh)]),
            pos=(np_rng.normal(scale=3.0, size=(nh * npph, 3))
                 + np.repeat(hcenters, npph, axis=0)).astype(np.float32),
            vel=np_rng.normal(size=(nh * npph, 3)).astype(np.float32),
        )

    centers = torch.from_numpy(hcenters).to(shmesh.device)
    for _ in range(2):
        hbatch = shard_rows(hs.route_flat(flat(), n_devices, hcap), shmesh,
                            "shards")
        hcarry, _ = hstep(hcarry, hbatch, centers)
    sync()

    # the scan-resident hash-sharded sequence: device routing by
    # all_to_all, join and detect for the whole snapshot stack
    rank = shmesh.index("shards")
    seqs = [hs.flat_to_position_shards(flat(), n_devices,
                                       pad_to=-(-nh * npph // n_devices))
            for _ in range(3)]
    flat_seq = hs.FlatRecords(*(
        None if parts[0] is None else torch.from_numpy(
            np.stack(parts)[:, rank:rank + 1].copy()).to(shmesh.device)
        for parts in zip(*seqs)))
    hscan = hs.make_hash_scan(shmesh, nh, 64, hcap, mode="pericentric",
                              box_size=100.0)
    _, _, hdrop = hscan(
        shard_rows(hs.init_hash_carry(n_devices, hcap, nh, device="cpu"),
                   shmesh, "shards"),
        flat_seq, centers[None].expand(3, nh, 3).contiguous())
    sync()
    if int(hdrop.sum()) != 0:
        raise RuntimeError("hash routing overflow")

    # grid-resident distributed P3M through the integrator: particles
    # routed by all_to_all, slab deposit and interpolation with ppermute
    # halo planes, the pencil FFT solve, slab-local short-range cells
    from orbitanalysis_tpu_torch.models.pm_sharded import (
        make_slab_resident_pm_force_fn,
    )

    box = 16.0
    xmesh = make_mesh({"x": n_devices}, device=device)
    pm_f = make_slab_resident_pm_force_fn(
        xmesh, grid=6 * n_devices, deconvolve=True, p3m_sigma_cells=1.5)
    st_pm = nbody_state_from_numpy(
        np_rng.uniform(0, box, size=(n_part, 3)).astype(np.float32),
        st.vel.cpu().numpy(), st.mass.cpu().numpy(), device=xmesh.device)
    cfg_pm = OrbitNBodyConfig(dt=0.05, n_steps=2, detect_every=1,
                              box_size=box, softening=0.1)
    fs2, _, _ = simulate_with_tracking(st_pm, members, cfg_pm,
                                       force_fn=pm_f)
    sync()
    if not bool(torch.isfinite(fs2.pos).all()):
        raise RuntimeError("distributed P3M positions not finite")

    # particle-sharded label-native detection; the only collective is
    # the psum of the [H, 4] bulk-velocity moments
    from orbitanalysis_tpu_torch.ops.label_step import init_label_carry
    from orbitanalysis_tpu_torch.parallel.label_sharded import (
        make_sharded_label_step,
        shard_label_tree,
    )

    n_lab = 128 * n_devices  # row_width multiple of 128 per shard
    lstep, _ = make_sharded_label_step(pmesh, 32, nh, box_size=100.0,
                                       row_width=128)
    lab = np_rng.integers(-1, nh, size=n_lab).astype(np.int32)
    lpos = np_rng.uniform(20, 80, size=(3, n_lab)).astype(np.float32)
    lvel = np_rng.normal(size=(3, n_lab)).astype(np.float32)
    lcarry = shard_label_tree(pmesh, init_label_carry(
        n_lab, row_width=128, device="cpu"))
    i = pmesh.index("particles")
    lo, hi = i * n_lab // n_devices, (i + 1) * n_lab // n_devices
    linputs = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(
        pmesh.device) for a in (lpos[:, lo:hi], lvel[:, lo:hi], lab[lo:hi],
                                hcenters)) + (None, 0.0)
    lcarry, _ = lstep(lcarry, linputs)
    lstep(lcarry, linputs)  # second step: non-fresh paths
    sync()


def _spawned_rank(rank: int, n: int, store: str, device: str):
    from orbitanalysis_tpu_torch.parallel import multihost

    backend = "gloo" if device == "cpu" else "nccl"
    multihost.initialize(f"file://{store}", n, rank, backend=backend)
    try:
        _dryrun_rank(n, device)
    finally:
        multihost.shutdown()


def dryrun_multichip(n_devices: int, device="cuda",
                     timeout: float = 600) -> None:
    """One step of each distributed engine on ``n_devices`` ranks (see
    the module docstring).  In a running world its size must be
    ``n_devices``; otherwise the ranks are spawned here (gloo on the CPU
    for ``device='cpu'``, NCCL with one card a rank otherwise, which
    needs ``n_devices`` cards).  Raises when a rank fails or the world
    does not end within ``timeout`` seconds."""
    import torch

    from orbitanalysis_tpu_torch.parallel import multihost

    n_devices = int(n_devices)
    if multihost.process_count() > 1 or torch.distributed.is_initialized():
        if multihost.process_count() != n_devices:
            raise ValueError(
                f"the running world has {multihost.process_count()} ranks, "
                f"not {n_devices}")
        _dryrun_rank(n_devices, device)
        return
    if torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) on the cards needs "
                f"{n_devices} CUDA devices, one a rank; {have} found "
                "(pass device='cpu' for gloo ranks on the CPU)")
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="orbit_dryrun_") as work:
        store = os.path.join(work, "store")
        procs = [ctx.Process(target=_spawned_rank,
                             args=(r, n_devices, store, str(device)))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(timeout)
        finally:
            hung = [p for p in procs if p.is_alive()]
            for p in hung:
                p.kill()
                p.join()
    if hung:
        raise RuntimeError(f"{len(hung)} rank(s) did not end in {timeout} s")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"dry-run rank(s) {bad} failed")
