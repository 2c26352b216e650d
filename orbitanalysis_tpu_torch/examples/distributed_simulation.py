"""Distributed on-the-fly orbit tracking: slab-resident P3M forces and
apsis detection over the ranks of a world (twin of
``examples/distributed_simulation.py``).

A cold cloud of 4096 particles collapses in a periodic box of 20 for 60
steps; the forces are the slab-resident distributed P3M of
:mod:`orbitanalysis_tpu_torch.models.pm_sharded` on ``8 * max(D, 4)``
cells a side, ``D`` the ranks of the mesh axis ``'x'``.  Every rank runs
``simulate_with_tracking`` on the same replicated state; each force
evaluation splits the particles and the grid over the ranks.

Run:

- on one card, a world of one:
  ``python -m orbitanalysis_tpu_torch.examples.distributed_simulation``
- one rank a card over NCCL: ``torchrun --nproc-per-node D -m
  orbitanalysis_tpu_torch.examples.distributed_simulation``
- on the CPU, ``N`` gloo ranks spawned here: ``python -m
  orbitanalysis_tpu_torch.examples.distributed_simulation --cpu --ranks N``
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

#: particles, box, steps and detection cadence of the cold cloud
N, BOX, N_STEPS, DETECT_EVERY = 4096, 20.0, 60, 4


def simulate(device: str = "cuda", n_steps: int = N_STEPS) -> dict:
    """The example on this rank's world (a world of one without a
    process group): prints (on rank 0) and returns the summary
    (``total``, ``max``, ``with_one``, ``n``, ``finite``, ``counts``)."""
    import torch

    from orbitanalysis_tpu_torch.models import (
        OrbitNBodyConfig,
        nbody_state_from_numpy,
        simulate_with_tracking,
    )
    from orbitanalysis_tpu_torch.models.pm_sharded import (
        make_slab_resident_pm_force_fn,
    )
    from orbitanalysis_tpu_torch.parallel import make_mesh, multihost

    mesh = make_mesh({"x": multihost.process_count()}, device=device)
    n_dev = int(mesh.shape["x"])
    primary = multihost.is_primary()
    if primary:
        print(f"devices: {n_dev} x {mesh.device.type}")

    # a cold collapsing cloud in a periodic box
    rng = np.random.default_rng(42)
    grid = 8 * max(n_dev, 4)
    pos = rng.uniform(0, BOX, (N, 3)).astype(np.float32)
    vel = rng.normal(scale=0.05, size=(N, 3)).astype(np.float32)
    mass = np.full(N, 50.0 / N, np.float32)

    # grid-resident distributed P3M: per-rank memory O(grid^3 / n_dev),
    # short-range erfc correction on slab-local cells
    force = make_slab_resident_pm_force_fn(
        mesh, grid, deconvolve=True, p3m_sigma_cells=1.5
    )
    state = nbody_state_from_numpy(pos, vel, mass, device=mesh.device)
    members = np.arange(N, dtype=np.int32).reshape(1, N)
    cfg = OrbitNBodyConfig(
        dt=0.05, n_steps=n_steps, detect_every=DETECT_EVERY, box_size=BOX,
        softening=0.05,
    )
    state, track, _ = simulate_with_tracking(state, members, cfg,
                                             force_fn=force)

    counts = track.counts[0].cpu().numpy()
    finite = bool(torch.isfinite(state.pos).all())
    summary = dict(total=int(counts.sum()), max=int(counts.max()),
                   with_one=int((counts > 0).sum()), n=N, finite=finite,
                   counts=counts)
    if primary:
        print(f"steps: {cfg.n_steps} (detector every {cfg.detect_every})")
        print(f"pericenter passages: total {summary['total']}, "
              f"max per particle {summary['max']}, "
              f"{summary['with_one']}/{N} particles with >= 1")
    if not finite:
        raise RuntimeError("positions not finite")
    if primary:
        print("positions finite; done")
    return summary


def _rank(rank: int, world: int, store: str, n_steps: int, out: str):
    """One gloo rank of :func:`run_ranks` (the spawn target)."""
    from orbitanalysis_tpu_torch.parallel import multihost

    multihost.initialize(f"file://{store}", world, rank, backend="gloo")
    try:
        summary = simulate("cpu", n_steps)
    finally:
        multihost.shutdown()
    np.savez(os.path.join(out, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in summary.items()})


def run_ranks(n_ranks: int, n_steps: int = N_STEPS,
              timeout: float = 600) -> list:
    """The example on ``n_ranks`` gloo ranks on the CPU, spawned here;
    returns each rank's summary.  Raises when a rank fails or the world
    does not end within ``timeout`` seconds (every rank is killed on
    the way out)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="orbit_ranks_") as work:
        store = os.path.join(work, "store")
        procs = [ctx.Process(target=_rank,
                             args=(r, n_ranks, store, n_steps, work))
                 for r in range(n_ranks)]
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
            raise RuntimeError(f"{len(hung)} rank(s) did not end in "
                               f"{timeout} s")
        bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"rank(s) {bad} failed")
        outs = []
        for r in range(n_ranks):
            with np.load(os.path.join(work, f"rank{r}.npz")) as z:
                outs.append({k: z[k] for k in z.files})
        return outs


def main(argv=None):
    from orbitanalysis_tpu_torch.examples._cli import device_of, parser
    from orbitanalysis_tpu_torch.parallel import multihost

    p = parser(__doc__, outdir=False)
    p.add_argument("--ranks", type=int, default=None,
                   help="with --cpu: spawn this many gloo ranks")
    args = p.parse_args(argv)
    if args.ranks is not None:
        if not args.cpu:
            raise SystemExit("--ranks spawns gloo ranks on the CPU: pass "
                             "--cpu, or use torchrun on the cards")
        run_ranks(args.ranks)
        return
    torchrun = "WORLD_SIZE" in os.environ
    if torchrun:
        multihost.initialize(backend="gloo" if args.cpu else "nccl")
    try:
        simulate(device_of(args))
    finally:
        if torchrun:
            multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
