"""On-the-fly orbit tracking inside a native N-body run (twin of
``examples/onthefly_integrator.py``).

The integrator evolves a disk of test particles around a central point
mass with KDK leapfrog while the apsis detector runs every
``detect_every`` force evaluations, with durable checkpoints
(``run_tracked_simulation``, ``torch.save`` files).

Run:  python -m orbitanalysis_tpu_torch.examples.onthefly_integrator [outdir] [--cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np

#: test particles, integrator steps, checkpoint interval
N, N_STEPS, CHECKPOINT_EVERY = 1024, 6000, 2000


def main(outdir: str = "example_out", device: str = "cuda",
         n_steps: int = N_STEPS) -> dict:
    """Run ``n_steps`` steps over three of the longest orbital periods
    into ``outdir`` on ``device``; prints and returns the summary
    (``passages``, ``histogram``, ``mean``, ``analytic``)."""
    import torch

    from orbitanalysis_tpu_torch.models import (
        OrbitNBodyConfig,
        nbody_state_from_numpy,
        point_mass_forces,
    )
    from orbitanalysis_tpu_torch.models.nbody import run_tracked_simulation
    from orbitanalysis_tpu_torch.models.synthetic import kepler_ensemble
    from orbitanalysis_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device, "onthefly_integrator")
    os.makedirs(outdir, exist_ok=True)
    # a disk of test particles around a central point mass
    ens = kepler_ensemble(N, 2, e_range=(0.1, 0.6), seed=2)
    state = nbody_state_from_numpy(
        ens.positions[0].astype(np.float32),
        ens.velocities[0].astype(np.float32),
        np.full(N, 1e-12, np.float32), device=dev)
    members = np.arange(N, dtype=np.int32).reshape(1, N)

    t_total = 3.0 * float(ens.period.max())
    config = OrbitNBodyConfig(
        dt=t_total / n_steps,
        n_steps=n_steps,
        detect_every=4,          # 4x coarser than the force cadence
        mode="pericentric",
        softening=0.0,
        centers=torch.zeros((1, 3), dtype=torch.float32, device=dev),
        bulk_vels=torch.zeros((1, 3), dtype=torch.float32, device=dev),
    )
    _, track, events = run_tracked_simulation(
        state, members, config,
        force_fn=point_mass_forces(GM=1.0),
        checkpoint_dir=os.path.join(outdir, "nbody_ck"),
        checkpoint_every=min(CHECKPOINT_EVERY, n_steps),
    )

    counts = track.counts[0].cpu().numpy()
    passages = int(events.sum())
    print(f"integrated {N} particles for {n_steps} steps "
          f"({passages} pericenter passages)")
    histogram = {int(k): int(v) for k, v in zip(
        *np.unique(counts, return_counts=True))}
    print("count histogram:", histogram)
    expected_mean = t_total / ens.period
    print(f"mean counts: detected {counts.mean():.2f} vs analytic "
          f"{expected_mean.mean():.2f}")
    return dict(passages=passages, histogram=histogram,
                mean=float(counts.mean()),
                analytic=float(expected_mean.mean()))


if __name__ == "__main__":
    from orbitanalysis_tpu_torch.examples._cli import device_of, parser

    args = parser(__doc__).parse_args(sys.argv[1:])
    main(args.outdir, device_of(args))
