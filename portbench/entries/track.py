"""Cell entry: ``orbitanalysis_tpu_torch.track_orbits``, the analyst's
offline run over a whole snapshot sequence, its catalogs kept in memory
by a ``MemoryWriter``.  A call is one whole ``track_orbits`` call; its
work is every member of every snapshot (particle-snapshots).  A sample
of the calls' catalogs, drawn from the seed, is kept for the
comparison."""

from __future__ import annotations

import random

import numpy as np
import torch

from portbench import compare, generate
from portbench.reference import orbits


def churn_inputs(config, seed, device):
    """Config 2's sequence and callbacks from the seed."""
    seq = generate.churn_sequence(
        config["halos"], config["pool"], config["snapshots"],
        config["box_size"], config["churn"], seed, device)
    regions, load = generate.snapshot_callbacks(
        seq, config["region_radius"], config["cosmology"])
    return seq, regions, load


def as_catalog(steps, seq, radius, mode="pericentric") -> dict:
    """Reference events (:func:`orbits.track`) in the savefile's form:
    what the control puts in the program's place."""
    H, S = len(seq.centers), len(seq.snaps)
    tag = "pericenter" if mode == "pericentric" else "apocenter"
    cat = {"attrs": {"mode": mode, "box_size": seq.box}}
    for s, e in enumerate(steps, start=1):
        g = {"region_offsets": np.concatenate(
                 ([0], np.cumsum(np.bincount(e.row, minlength=H)))),
             tag + "_IDs": e.ids.astype(np.int32),
             "angles": e.angles.astype(np.float16),
             "halo_IDs": np.arange(H)}
        if s < S - 1:
            g["final_descendant_IDs"] = np.arange(H)
        g["region_radii"] = np.full(H, float(radius))
        g["region_positions"] = seq.centers
        g["bulk_velocities"] = e.bulk.astype(np.float32)
        cat["snapshot_%03d" % s] = g
    return cat


def worst(results: list) -> dict:
    """Each number's largest value over the checked answers."""
    out = {}
    for r in results:
        for k, v in r.items():
            out[k] = max(out.get(k, -np.inf), v)
    return out


def keep(kept: list, item, i: int, k: int, rng: random.Random):
    """Call ``i``'s answer into a uniform sample of ``k`` of the calls so
    far (a reservoir), drawn by ``rng``."""
    if len(kept) < k:
        kept.append(item)
    else:
        j = rng.randrange(i + 1)
        if j < k:
            kept[j] = item


def broken(results: list, limits: dict) -> int:
    return sum(any(not v <= limits[k] for k, v in r.items())
               for r in results)


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.traced = False
        self.failed = 0

    def setup(self):
        from orbitanalysis_tpu_torch import track_orbits
        from orbitanalysis_tpu_torch.engine.io_hdf5 import MemoryWriter
        from orbitanalysis_tpu_torch.utils.metrics import Metrics

        self._track_orbits, self._writer, self._metrics = (
            track_orbits, MemoryWriter, Metrics)
        c = self.config
        self.seq, self.regions, self.load = churn_inputs(c, self.seed,
                                                         self.device)
        S, H = c["snapshots"], c["halos"]
        self.snap_nums = np.arange(S)
        self.branches = np.tile(np.arange(H), (S, 1))
        self.members = int(sum(int(s.counts.sum()) for s in self.seq.snaps))
        self.catalogs = []
        self._rng = random.Random(self.seed)
        self._run(None)                      # warm-up: every shape

    def _run(self, metrics):
        w = self._writer()
        self._track_orbits(
            self.snap_nums, self.branches, self.regions, self.load,
            "track.h5", mode=self.traffic["mode"], verbose=False,
            join_impl=self.traffic["join_impl"], metrics=metrics, writer=w,
            device=self.device)
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()
        return w.files["track.h5"]

    def call(self, i):
        m = self._metrics() if self.traced else None
        keep(self.catalogs, self._run(m), i,
             int(self.traffic["check_calls"]), self._rng)
        out = {"work": self.members}
        if m is not None:
            out["records"] = m.records
        return out

    def release(self):
        pass

    def reference(self, dtype=torch.float64):
        return orbits.track(self.seq,
                            generate.hubble_drag(self.config["cosmology"]),
                            self.traffic["mode"], dtype, self.device)

    def check(self, catalogs=None):
        ref = self.reference()
        results = [compare.track_catalog(
            cat, ref, self.seq, self.config["region_radius"],
            self.traffic["mode"]) for cat in (catalogs or self.catalogs)]
        self.failed = broken(results, self.traffic["limits"])
        return worst(results)

    def control(self):
        """The numbers of the reference in bfloat16 put in the program's
        place (never run by the benchmark's own runs)."""
        low = self.reference(torch.bfloat16)
        cat = as_catalog(low, self.seq, self.config["region_radius"],
                         self.traffic["mode"])
        return self.check([cat])

    def layer_info(self):
        return {"snapshots_per_call": self.config["snapshots"]}
