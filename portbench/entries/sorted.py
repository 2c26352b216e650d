"""Cell entry: ``orbitanalysis_tpu_torch.engine.scan.scan_events_sorted``
on its fused, presorted path (the merge-join engine: K16 a churning
step), a device-resident pipeline: the whole sequence is staged once in
set-up with each halo's row sorted by particle ID and the positions and
velocities as ``[S, 3, H, P]`` planes (``presort_snapshot(soa=True)``)
and kept on the card, and a call is one whole scan of it from a fresh
carry.  Set-up makes two calls, so that the scan's CUDA graph is
captured there and every call of the window replays it.  Its work is
every member of every step after the first (the first seeds the carry).
A sample of the scans, drawn from the seed, is kept for the comparison
with ``portbench/reference/orbits.py``."""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench import compare_sorted, generate, harness
from portbench.entries.scan import front_packed
from portbench.entries.track import broken, churn_inputs, keep, worst
from portbench.reference import orbits


def sorted_form(seq, capacity: int, device):
    """A churn sequence (``generate.churn_sequence``) staged as the merge-
    join engine takes it, on ``device``: the front-packed ``[S, H, P]``
    rows (:func:`portbench.entries.scan.front_packed`) sorted by ID,
    with their load slots, ``pos``/``vel`` ``[S, 3, H, P]``, the mass
    planes and the region centres ``[S, H, 3]``."""
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu_torch.ops.sorted_step import presort_snapshot

    S, H = len(seq.snaps), len(seq.centers)
    ids, pos, vel, mass = front_packed(seq, capacity)
    centers = np.ascontiguousarray(
        np.broadcast_to(seq.centers, (S, H, 3)))
    staged = presort_snapshot(SnapshotBatch(
        ids=ids, pos=pos, vel=vel, center=centers, mass=mass), soa=True)
    return staged._replace(**{
        f: torch.from_numpy(np.ascontiguousarray(getattr(staged, f))).to(
            device) for f in ("ids", "pos", "vel", "center", "mass", "slot")})


def as_events(steps, H: int, K: int, device):
    """Reference events (:func:`orbits.track`) as the scan's ``(count [S,
    H], ids [S, H, K], angles [S, H, K])``: what the control puts in the
    program's place."""
    S = len(steps) + 1
    count = torch.zeros(S, H, dtype=torch.int32, device=device)
    ids = torch.full((S, H, K), np.iinfo(np.int32).max, dtype=torch.int32,
                     device=device)
    angles = torch.zeros(S, H, K, dtype=torch.float32, device=device)
    for s, e in enumerate(steps, start=1):
        for h in range(H):
            sel = e.row == h
            n = int(sel.sum())
            count[s, h] = n
            ids[s, h, :min(n, K)] = torch.as_tensor(
                e.ids[sel][:K].astype(np.int32), device=device)
            angles[s, h, :min(n, K)] = torch.as_tensor(
                e.angles[sel][:K], device=device).float()
    return count, ids, angles


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.traced = False
        self.failed = 0

    def setup(self):
        from orbitanalysis_tpu_torch.engine.scan import scan_events_sorted
        from orbitanalysis_tpu_torch.ops import _cuda
        from orbitanalysis_tpu_torch.ops.sorted_step import init_sorted_carry

        self._scan, self._init, self._cuda = (scan_events_sorted,
                                              init_sorted_carry, _cuda)
        c, t = self.config, self.traffic
        self.seq, _, _ = churn_inputs(c, self.seed, self.device)
        self.H, self.P, self.K = c["halos"], t["capacity"], t["event_capacity"]
        self.stack = sorted_form(self.seq, self.P, self.device)._replace(
            hubble_drag=generate.hubble_drag(c["cosmology"]))
        self.updates = int(sum(int(s.counts.sum())
                               for s in self.seq.snaps[1:]))
        self.steps = c["snapshots"]
        self.kept = []
        self._rng = random.Random(self.seed)
        # warm-up: every shape, the kernel library, the spans and
        # counters the traced calls take, and on the card the scan's
        # CUDA graph (the second call captures it)
        for _ in range(2):
            self._one({})
        harness.sync(self.device)

    def _one(self, metrics):
        carry = self._init(self.H, self.P, device=self.device)
        _, events = self._scan(
            carry, self.stack, self.K, mode=self.traffic["mode"],
            box_size=self.config["box_size"], fused=True, cur_presorted=True,
            soa_batch=True, metrics=metrics)
        return events

    def call(self, i):
        before = self._cuda.launch_counts() if self.traced else None
        metrics = {} if self.traced else None
        t0 = time.perf_counter()
        events = self._one(metrics)
        host_s = time.perf_counter() - t0
        harness.sync(self.device)
        keep(self.kept, events, i, int(self.traffic["check_calls"]),
             self._rng)
        out = {"work": self.updates, "host_s": host_s}
        if before is not None:
            out["metrics"] = metrics
            after = self._cuda.launch_counts()
            out["launches"] = {n: after[n] - before.get(n, 0) for n in after
                               if after[n] != before.get(n, 0)}
        return out

    def release(self):
        pass

    def reference(self, dtype=torch.float64):
        return orbits.track(self.seq,
                            generate.hubble_drag(self.config["cosmology"]),
                            self.traffic["mode"], dtype, self.device)

    def check(self, kept=None):
        ref = self.reference()
        results = [compare_sorted.sorted_events(*ev, self.seq, ref)
                   for ev in (kept or self.kept)]
        self.failed = broken(results, self.traffic["limits"])
        return worst(results)

    def control(self):
        """The reference in bfloat16 put in the program's place."""
        low = self.reference(torch.bfloat16)
        return self.check([as_events(low, self.H, self.K, self.device)])

    def layer_info(self):
        return {"steps_per_call": self.steps, "halos": self.H,
                "capacity": self.P, "event_capacity": self.K}
