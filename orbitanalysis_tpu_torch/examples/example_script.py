"""End-to-end example: track orbits, collate, decompose, plot (twin of
``examples/example_script.py``).

It synthesizes a Kepler-like halo, defines the two data callbacks, runs
the tracker, then produces the position- and phase-space decomposition
plots.  The savefiles are HDF5 (``H5Writer``), so the example needs
``h5py``; the card machine has none, so there it runs only through the
CPU tests (``tests/test_torch_examples.py``).

Run:  python -m orbitanalysis_tpu_torch.examples.example_script [outdir] [--cpu]
"""

from __future__ import annotations

import os
import sys

import numpy as np

#: particles and snapshots of the synthetic halo
N_PARTICLES, N_SNAPSHOTS = 2000, 40
HALO_CENTER = np.array([50.0, 50.0, 50.0])
BOX_SIZE = 100.0


def main(outdir: str = "example_out", device: str = "cuda") -> dict:
    """Run the example into ``outdir`` on ``device``; prints and returns
    the summary (``completed``: particles with at least one orbit,
    ``n``, ``max_count``)."""
    from orbitanalysis_tpu_torch import (
        Apsides,
        OrbitDecomposition,
        track_orbits,
    )
    from orbitanalysis_tpu_torch.models.synthetic import kepler_ensemble
    from orbitanalysis_tpu_torch.utils.metrics import Metrics

    os.makedirs(outdir, exist_ok=True)
    # synthetic data: one halo of particles on Kepler orbits about a center
    ens = kepler_ensemble(N_PARTICLES, N_SNAPSHOTS, seed=1)
    snapshot_numbers = np.arange(N_SNAPSHOTS)
    main_branches = np.zeros((N_SNAPSHOTS, 1), dtype=np.int64)  # halo 0

    # the two-callback data contract
    def regions(snapshot_number, halo_ids):
        return HALO_CENTER[None, :], np.array([10.0])

    def load_snapshot_data(snapshot_number, region_positions, region_radii):
        s = int(snapshot_number)
        return dict(
            ids=ens.ids,
            coordinates=ens.positions[s] + HALO_CENTER,
            velocities=ens.velocities[s],
            masses=1.0,
            region_offsets=np.array([0]),
            box_size=BOX_SIZE,
        )

    # track + postprocess + plot
    savefile = os.path.join(outdir, "orbits.h5")
    metrics = Metrics(jsonl_path=os.path.join(outdir, "metrics.jsonl"))
    track_orbits(
        snapshot_numbers, main_branches, regions, load_snapshot_data,
        savefile, mode="pericentric", checkpoint=True, metrics=metrics,
        verbose=False, device=device,
    )
    print("tracked; per-phase totals:", {
        k: round(v["total_s"], 3) for k, v in metrics.summary().items()
    })

    collated = os.path.join(outdir, "collated.h5")
    Apsides(savefile).collate_apsides(
        savefile=collated, save_final_counts=True, verbose=False
    )
    print("collated ->", collated)

    decomp = OrbitDecomposition(savefile)
    final = int(snapshot_numbers[-1])
    decomp.get_halo_decomposition_at_snapshot(
        halo_id=0,
        snapshot_number=final,
        snapshot_data=load_snapshot_data(final, None, None),
        angle_cut=np.pi / 4,
    )
    decomp.plot_position_space(
        projection="xy", savefile=os.path.join(outdir, "position_space.png")
    )
    decomp.plot_phase_space(savefile=os.path.join(outdir, "phase_space.png"))
    print("plots ->", outdir)

    counts = np.asarray(decomp.counts)
    summary = dict(completed=int((counts > 0).sum()), n=len(counts),
                   max_count=int(counts.max()))
    print(f"{summary['completed']} of {summary['n']} particles completed "
          f">=1 orbit; max count {summary['max_count']}")
    return summary


if __name__ == "__main__":
    from orbitanalysis_tpu_torch.examples._cli import device_of, parser

    args = parser(__doc__).parse_args(sys.argv[1:])
    main(args.outdir, device_of(args))
