"""Cell entry: ``orbitanalysis_tpu_torch.models.nbody.
simulate_with_tracking`` with PM forces (``models.pm.make_pm_force_fn``,
its default deposit K13 and scalar interpolation): the simulation that
counts every particle's apsis passages while it runs.  A call is one
whole call of ``n_steps`` KDK steps from one of a few initial states
drawn from the seed at set-up, with a fresh track (the call's first
detection seeds it), so every call does the same work: every particle
of every step (particle-steps).  A sample of the calls, drawn from the
seed, keeps its outputs; the reference replays each one."""

from __future__ import annotations

import random
import time

import torch

from portbench import compare_nbody, generate
from portbench.entries.track import broken, keep, worst
from portbench.reference import nbody


def initial_states(config, count, seed, device):
    """``count`` states ``(pos, vel, mass)`` from the seed, in bulk on the
    device: positions uniform in the box, velocities ``velocity_scale``
    N(0, 1) a component, masses ``mass``."""
    g = generate.generator(seed, device)
    n, box = config["particles"], float(config["box_size"])
    f32 = dict(dtype=torch.float32, device=device, generator=g)
    mass = torch.full((n,), float(config["mass"]), dtype=torch.float32,
                      device=device)
    out = []
    for _ in range(count):
        pos = torch.rand(n, 3, **f32) * box
        vel = torch.randn(n, 3, **f32) * float(config["velocity_scale"])
        out.append((pos, vel, mass))
    return out


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, device
        self.traced = False
        self.failed = 0

    def setup(self):
        from orbitanalysis_tpu_torch.models.nbody import (
            NBodyState,
            OrbitNBodyConfig,
            simulate_with_tracking,
        )
        from orbitanalysis_tpu_torch.models.pm import make_pm_force_fn
        from orbitanalysis_tpu_torch.ops import _cuda

        c = self.config
        self._simulate, self._cuda = simulate_with_tracking, _cuda
        self._state = NBodyState
        self.states = initial_states(c, int(self.traffic["states"]),
                                     self.seed, self.device)
        self.members = torch.arange(
            c["particles"], dtype=torch.int32, device=self.device).reshape(
                c["rows"], c["row"])
        self.sim_config = OrbitNBodyConfig(
            dt=c["dt"], n_steps=c["n_steps"], detect_every=c["detect_every"],
            mode=c["mode"], box_size=c["box_size"], angle_cut=c["angle_cut"],
            G=c["G"])
        self.force = make_pm_force_fn(c["grid"])
        self.work = c["particles"] * c["n_steps"]
        self.kept = []
        self._rng = random.Random(self.seed)
        # warm-up: every shape, cuFFT's plans, the kernel library, and
        # the spans the traced calls take
        self._one(0, {})
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()

    def _one(self, i, metrics):
        s = i % len(self.states)
        st, tr, ev = self._simulate(
            self._state(*self.states[s]), self.members, self.sim_config,
            force_fn=self.force, identity=True, metrics=metrics)
        return s, st, tr, ev

    def call(self, i):
        before = self._cuda.launch_counts() if self.traced else None
        metrics = {} if self.traced else None
        t0 = time.perf_counter()
        s, st, tr, ev = self._one(i, metrics)
        host_s = time.perf_counter() - t0
        if str(self.device).startswith("cuda"):
            torch.cuda.synchronize()
        keep(self.kept, (s, st.pos, st.vel, tr.counts, ev), i,
             int(self.traffic["check_calls"]), self._rng)
        out = {"work": self.work, "host_s": host_s}
        if before is not None:
            out["metrics"] = metrics
            after = self._cuda.launch_counts()
            out["launches"] = {n: after[n] - before.get(n, 0) for n in after
                               if after[n] != before.get(n, 0)}
        return out

    def release(self):
        pass

    def reference(self, s, dtype=torch.float64):
        pos, vel, mass = self.states[s]
        return nbody.simulate(pos, vel, mass, self.config, dtype)

    def check(self, kept=None):
        refs, results = {}, []
        for s, pos, vel, counts, ev in (kept or self.kept):
            if s not in refs:
                refs[s] = self.reference(s)
            results.append(compare_nbody.call_numbers(
                pos, vel, counts, ev, refs[s], float(self.config["box_size"]),
                self.config["detect_every"]))
        self.failed = broken(results, self.traffic["limits"])
        return worst(results)

    def control(self):
        """The reference in bfloat16 put in the program's place, on the
        first initial state."""
        low = self.reference(0, torch.bfloat16)
        events = torch.zeros(self.config["n_steps"], dtype=torch.int64)
        every = self.config["detect_every"]
        events[every - 1::every] = torch.tensor(low.events)
        return self.check([(0, low.pos, low.vel, low.counts, events)])

    def layer_info(self):
        c = self.config
        return {"particles": c["particles"], "grid": c["grid"],
                "steps_per_call": c["n_steps"]}
