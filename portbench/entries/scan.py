"""Cell entry: ``orbitanalysis_tpu_torch.engine.scan.scan_events_aligned``
(per step, ``batched=False``), a device-resident pipeline: the whole
sequence is staged once in set-up in the stable layout
(``stage_batch_aligned(soa=True)``) and kept on the card, and a call is
one whole scan of it from a fresh carry.  Its work is every member of
every step after the first (the first seeds the carry).  A sample of the
scans, drawn from the seed, is kept for the comparison."""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from portbench import compare, generate
from portbench.entries.track import broken, churn_inputs, keep, worst
from portbench.reference import orbits


def front_packed(seq, capacity):
    """``[S, H, P]`` ID, ``[S, H, P, 3]`` position and velocity and ``[S,
    H, P]`` mass arrays, each row's members first in load order, then
    int32-max padding."""
    S, H = len(seq.snaps), len(seq.centers)
    inv = np.iinfo(np.int32).max
    ids = np.full((S, H, capacity), inv, np.int32)
    pos = np.zeros((S, H, capacity, 3), np.float32)
    vel = np.zeros_like(pos)
    mass = np.zeros((S, H, capacity), np.float32)
    for s, sn in enumerate(seq.snaps):
        if sn.counts.max(initial=0) > capacity:
            raise ValueError(f"snapshot {s}: a halo holds "
                             f"{sn.counts.max()} members, over {capacity}")
        row = np.repeat(np.arange(H), sn.counts)
        col = np.arange(len(row)) - np.repeat(
            np.concatenate(([0], np.cumsum(sn.counts)[:-1])), sn.counts)
        ids[s, row, col] = sn.ids
        pos[s, row, col] = sn.pos
        vel[s, row, col] = sn.vel
        mass[s, row, col] = sn.mass
    return ids, pos, vel, mass


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.traced = False
        self.failed = 0

    def setup(self):
        from orbitanalysis_tpu_torch.engine.packing import stage_batch_aligned
        from orbitanalysis_tpu_torch.engine.scan import scan_events_aligned
        from orbitanalysis_tpu_torch.ops import _cuda
        from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch
        from orbitanalysis_tpu_torch.ops.sorted_step import init_aligned_carry

        self._scan, self._init = scan_events_aligned, init_aligned_carry
        self._cuda = _cuda
        c, t = self.config, self.traffic
        self.seq, _, _ = churn_inputs(c, self.seed, self.device)
        self.H, self.P, self.K = c["halos"], t["capacity"], t["event_capacity"]
        S = c["snapshots"]
        ids, pos, vel, mass = front_packed(self.seq, self.P)
        centers = np.ascontiguousarray(
            np.broadcast_to(self.seq.centers, (S, self.H, 3)))
        staged = stage_batch_aligned(SnapshotBatch(
            ids=ids, pos=pos, vel=vel, center=centers, mass=mass,
            hubble_drag=generate.hubble_drag(c["cosmology"])), soa=True)
        self.stack = staged._replace(**{
            f: torch.from_numpy(np.ascontiguousarray(getattr(staged, f))).to(
                self.device) for f in ("ids", "pos", "vel", "center", "mass",
                                       "slot")})
        self.updates = int(sum(int(s.counts.sum())
                               for s in self.seq.snaps[1:]))
        self.steps = S - 1
        self.kept = []
        self._rng = random.Random(self.seed)
        self._one()                           # warm-up
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()

    def _one(self):
        carry = self._init(self.H, self.P, device=self.device)
        _, events = self._scan(carry, self.stack, self.K,
                               mode=self.traffic["mode"],
                               box_size=self.config["box_size"],
                               soa_batch=True, batched=False)
        return events

    def call(self, i):
        before = self._cuda.launch_counts() if self.traced else None
        t0 = time.perf_counter()
        events = self._one()
        host_s = time.perf_counter() - t0
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()
        keep(self.kept, events, i, int(self.traffic["check_calls"]),
             self._rng)
        out = {"work": self.updates, "host_s": host_s}
        if before is not None:
            out["events"] = int(events[0].sum())
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
        results = [compare.scan_events(*ev, self.stack.ids, ref)
                   for ev in (kept or self.kept)]
        self.failed = broken(results, self.traffic["limits"])
        return worst(results)

    def control(self):
        """The reference in bfloat16 put in the program's place: its events
        as positions in the program's staged layout."""
        low = self.reference(torch.bfloat16)
        return self.check([as_events(low, self.stack.ids, self.K)])

    def layer_info(self):
        return {"steps_per_call": self.steps, "halos": self.H,
                "capacity": self.P, "event_capacity": self.K}


def as_events(steps, staged_ids, K):
    """Reference events as ``(count, positions, angles)`` of the scan:
    each event's position is where its ID sits in the staged row."""
    S, H, P = staged_ids.shape
    dev = staged_ids.device
    count = torch.zeros(S, H, dtype=torch.int32, device=dev)
    positions = torch.zeros(S, H, K, dtype=torch.int32, device=dev)
    angles = torch.zeros(S, H, K, dtype=torch.float32, device=dev)
    for s, e in enumerate(steps, start=1):
        row = staged_ids[s].long()
        for h in range(H):
            want = torch.as_tensor(e.ids[e.row == h], device=dev)
            ang = torch.as_tensor(e.angles[e.row == h], device=dev)
            order = torch.argsort(row[h])
            at = torch.searchsorted(row[h][order], want).clamp(max=P - 1)
            n = min(len(want), K)
            count[s, h] = len(want)
            positions[s, h, :n] = order[at][:n].int()
            angles[s, h, :n] = ang[:n].float()
    return count, positions, angles
