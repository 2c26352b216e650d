"""Cell entry: ``orbitanalysis_tpu_torch.ops.label_step.scan_label_events``,
the label-native detector over a position-stable pool: particle ``h *
pool + c`` is pool slot ``c`` of halo ``h`` for the whole run, as in an
integrator's or a record pool's global array, so churn is a change of
the particle's halo label and detection needs no join and no staging.
The sequence is built once in set-up on the card in that form (labels,
positions, velocities and one mass plane a step; non-members hold label
-1 and zeros) and kept there, and a call is one whole scan of it from a
fresh carry with the program's defaults (``frames='auto'``, the moments
on the card, float32 radial unit vectors).  Its work is every member of
every step after the first (the first seeds the carry).  A sample of
the scans, drawn from the seed, is kept for the comparison with
``portbench/reference/labels.py``."""

from __future__ import annotations

import random
import time

import torch

from portbench import compare_label, generate, harness
from portbench.entries.track import broken, keep, worst
from portbench.reference import labels


def label_form(seq, pool: int, device):
    """A churn sequence (``generate.churn_sequence``) as a pool on
    ``device``: ``label [S, N]`` int32 (the halo while a member, else
    -1), ``pos`` and ``vel`` ``[S, 3, N]`` and ``mass [S, N]`` float32
    (zero on non-members), and ``ids [N]`` int64, the ID each position
    holds (``h * ID_STRIDE + c``)."""
    S, H = len(seq.snaps), len(seq.centers)
    n = H * pool
    label = torch.full((S, n), -1, dtype=torch.int32, device=device)
    pos = torch.zeros((S, 3, n), dtype=torch.float32, device=device)
    vel = torch.zeros_like(pos)
    mass = torch.zeros((S, n), dtype=torch.float32, device=device)
    for s, sn in enumerate(seq.snaps):
        sid = torch.from_numpy(sn.ids).to(device)
        halo = sid // generate.ID_STRIDE
        at = halo * pool + sid % generate.ID_STRIDE
        label[s, at] = halo.to(torch.int32)
        pos[s][:, at] = torch.from_numpy(sn.pos).to(device).T
        vel[s][:, at] = torch.from_numpy(sn.vel).to(device).T
        mass[s, at] = torch.from_numpy(sn.mass).to(device)
    slot = torch.arange(n, device=device)
    ids = (slot // pool) * generate.ID_STRIDE + slot % pool
    return label, pos, vel, mass, ids


def as_events(steps, ids, pool: int, rows: int, K: int):
    """Reference events (:func:`labels.track`) as a scan's ``(count [S,
    R], index [S, R, K], angle [S, R, K])``: what the control puts in the
    program's place.  Positions follow from the IDs by the pool's
    layout."""
    S, n = len(steps) + 1, ids.shape[0]
    W = n // rows
    dev = ids.device
    count = torch.zeros(S, rows, dtype=torch.int32, device=dev)
    index = torch.full((S, rows, K), -1, dtype=torch.int32, device=dev)
    angle = torch.zeros(S, rows, K, dtype=torch.float32, device=dev)
    for s, e in enumerate(steps, start=1):
        pid = torch.as_tensor(e.ids, device=dev)
        at = (pid // generate.ID_STRIDE) * pool + pid % generate.ID_STRIDE
        ang = torch.as_tensor(e.angles, device=dev).float()
        row = at // W
        for r in range(rows):
            sel = row == r
            k = int(sel.sum())
            count[s, r] = k
            index[s, r, :min(k, K)] = at[sel][:K].int()
            angle[s, r, :min(k, K)] = ang[sel][:K]
    return count, index, angle


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.traced = False
        self.failed = 0

    def setup(self):
        from orbitanalysis_tpu_torch.ops import _cuda
        from orbitanalysis_tpu_torch.ops.label_step import (
            init_label_carry,
            scan_label_events,
        )

        self._scan, self._init, self._cuda = (scan_label_events,
                                              init_label_carry, _cuda)
        c, t = self.config, self.traffic
        self.seq = generate.churn_sequence(
            c["halos"], c["pool"], c["snapshots"], c["box_size"], c["churn"],
            self.seed, self.device)
        self.H, self.P = c["halos"], c["pool"]
        self.N, self.W, self.K = (self.H * self.P, t["row_width"],
                                  t["event_capacity"])
        self.R = self.N // self.W
        S = c["snapshots"]
        self.label, self.pos, self.vel, self.mass, self.ids = label_form(
            self.seq, self.P, self.device)
        self.centers = torch.as_tensor(self.seq.centers,
                                       device=self.device).expand(
                                           S, self.H, 3)
        self.drag = generate.hubble_drag(c["cosmology"])
        self.updates = int(sum(int(s.counts.sum())
                               for s in self.seq.snaps[1:]))
        self.steps = S
        self.kept = []
        self._rng = random.Random(self.seed)
        # warm-up: every shape, the kernel library, and the spans and
        # counters the traced calls take
        self._one({})
        harness.sync(self.device)

    def _one(self, metrics):
        carry = self._init(self.N, row_width=self.W, device=self.device)
        _, events = self._scan(
            carry, self.pos, self.vel, self.label, self.centers, self.K,
            mode=self.traffic["mode"], box_size=self.config["box_size"],
            mass=self.mass, hubble_drag=self.drag, row_width=self.W,
            frames=self.traffic["frames"], metrics=metrics)
        return events

    def call(self, i):
        before = self._cuda.launch_counts() if self.traced else None
        metrics = {} if self.traced else None
        t0 = time.perf_counter()
        events = self._one(metrics)
        host_s = time.perf_counter() - t0
        harness.sync(self.device)
        keep(self.kept, (events.count, events.index, events.angle), i,
             int(self.traffic["check_calls"]), self._rng)
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
        return labels.track(self.label, self.pos, self.vel, self.mass,
                            self.centers[0], self.ids,
                            self.config["box_size"], self.drag,
                            self.traffic["mode"], dtype)

    def check(self, kept=None):
        ref = self.reference()
        results = [compare_label.label_events(*ev, self.label, self.ids,
                                              ref)
                   for ev in (kept or self.kept)]
        self.failed = broken(results, self.traffic["limits"])
        return worst(results)

    def control(self):
        """The reference in bfloat16 put in the program's place: its events
        as the scan's positional rows."""
        low = self.reference(torch.bfloat16)
        return self.check([as_events(low, self.ids, self.P, self.R,
                                     self.K)])

    def layer_info(self):
        return {"steps_per_call": self.steps, "halos": self.H,
                "particles": self.N, "rows": self.R, "row_width": self.W,
                "event_capacity": self.K}
