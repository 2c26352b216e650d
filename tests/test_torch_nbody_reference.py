"""The port's PM simulation with on-the-fly detection
(``orbitanalysis_tpu_torch.models.nbody.simulate_with_tracking`` with
``models.pm.make_pm_force_fn``) against the benchmark's plain float64
reference (``portbench/reference/nbody.py``) on the CPU, at config 4's
box, time step and cadence with fewer particles: 8 rows of 2,048 on
32^3, 32 steps, a detection every 8.

At this cadence a particle turns ~1e-5 rad between detections about its
halo's centre, below what float32 ``acos`` of a dot product resolves, so
these tests hold the detector to turns that small.  Tolerances, with
their reasons:

- positions: 2e-4 box units, above 32 drifts of half a float32 ulp at
  64-100 (3.8e-6 each, 1.2e-4 in all), which the float64 reference does
  not round;
- velocities: 1e-5, ~20 x the gaps read (3-5e-7 over four seeds): the
  float32 forces (FFT and CIC rounding) against float64 ones, over 33
  evaluations;
- counts: at most 1e-3 of the particles may differ (a radial velocity
  within rounding of zero at a detection flips in one precision only;
  0-3 of 16,384 read), and each detection's events within 1 %.

The file imports nothing of JAX."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orbitanalysis_tpu_torch.models import nbody as tnb
from orbitanalysis_tpu_torch.models.pm import make_pm_force_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, ROW, GRID, BOX, DT, STEPS, EVERY = 8, 2048, 32, 100.0, 1e-3, 32, 8
N = ROWS * ROW
CONFIG = dict(particles=N, rows=ROWS, row=ROW, grid=GRID, box_size=BOX,
              dt=DT, n_steps=STEPS, detect_every=EVERY, mode="pericentric",
              angle_cut=0.0, G=1.0)


def _reference():
    spec = importlib.util.spec_from_file_location(
        "portbench_reference_nbody",
        os.path.join(REPO, "portbench", "reference", "nbody.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    pos = torch.rand(N, 3, generator=g) * BOX
    vel = torch.randn(N, 3, generator=g) * 0.02
    return tnb.NBodyState(pos, vel, torch.ones(N))


def _run(state, metrics=None):
    cfg = tnb.OrbitNBodyConfig(dt=DT, n_steps=STEPS, detect_every=EVERY,
                               mode="pericentric", box_size=BOX)
    members = torch.arange(N, dtype=torch.int32).reshape(ROWS, ROW)
    return tnb.simulate_with_tracking(state, members, cfg,
                                      force_fn=make_pm_force_fn(GRID),
                                      identity=True, metrics=metrics)


@pytest.fixture(scope="module", params=[5, 2 ** 31 + 99])
def runs(request):
    torch.set_num_threads(2)
    state = _state(request.param)
    program = _run(state)
    ref = REF.simulate(state.pos, state.vel, state.mass, CONFIG)
    return state, program, ref


def test_every_event_is_counted(runs):
    """At ``angle_cut=0`` an event adds one count when its particle has
    turned since its last apsis: a turn of ~1e-5 rad adds to the angle
    (float32 ``acos`` rounded it to 0, and about half the events went
    uncounted: 277 of 551 on one seed).  The one exception is a particle
    whose float32 direction is bit for bit the same at both detections
    (moving across its line of sight by less than ~1e-7 rad in 8 steps),
    whose turn is exactly 0: 1 event of 581 on one seed, 0 on eight
    others, so at most 1 in 500 may go uncounted."""
    _, (_, track, events), _ = runs
    n_events = int(events.sum())
    assert n_events > 100
    assert 0 <= n_events - int(track.counts.sum()) <= n_events // 500


def test_program_agrees_with_reference(runs):
    _, (st, track, events), ref = runs
    d = st.pos.double() - ref.pos
    d = d - BOX * torch.round(d / BOX)
    assert float(d.abs().max()) <= 2e-4
    assert float((st.vel.double() - ref.vel).abs().max()) <= 1e-5
    differ = int((track.counts.reshape(-1).long() != ref.counts).sum())
    assert differ <= N // 1000
    got = events[EVERY - 1::EVERY].tolist()
    assert len(got) == len(ref.events) == STEPS // EVERY
    for a, b in zip(got, ref.events):
        assert abs(a - b) <= 0.01 * b
    rest = [e for k, e in enumerate(events.tolist()) if (k + 1) % EVERY]
    assert not any(rest)


def _pair(axis, angle):
    """Two float32 unit vectors ``angle`` rad apart about ``axis``."""
    a = torch.tensor(axis, dtype=torch.float64)
    a = a / a.norm()
    perp = torch.linalg.cross(a, torch.tensor([0.3, -0.5, 0.8],
                                              dtype=torch.float64))
    perp = perp / perp.norm()
    b = math.cos(angle) * a + math.sin(angle) * perp
    return a.float(), (b / b.norm()).float()


@pytest.mark.parametrize("angle", [1e-6, 1e-5, 3e-4, 0.1, 1.5, 3.0])
@pytest.mark.parametrize("axis", [(1.0, 0.0, 0.0), (0.36, -0.48, 0.8),
                                  (-0.577, 0.577, 0.577)])
def test_small_turns_keep_their_digits(axis, angle):
    """The detector's turn between two float32 directions is within 1 %
    of the float64 angle between the same two vectors; float32 ``acos``
    of their dot gives 0 for turns of 1e-5 rad and less."""
    a, b = _pair(axis, angle)
    got = float(tnb.turn_angle(a, b))
    a64, b64 = a.double(), b.double()
    want = float(torch.atan2(torch.linalg.cross(a64, b64).norm(),
                             a64 @ b64))
    assert want > 0.5 * angle
    assert abs(got - want) <= 0.01 * want
    if angle <= 1e-5:
        assert float(torch.acos(torch.clamp(a @ b, -1.0, 1.0))) == 0.0


def test_metrics_change_nothing_and_count_by_hand():
    """A call with ``metrics`` gives the bits of a call without; the
    counters equal the hand counts: 33 force evaluations (the opening
    one and one a step), 5 detections (the seeding one and 32 / 8), 33 x
    N particles deposited; the spans hold host seconds."""
    torch.set_num_threads(2)
    state = _state(11)
    plain = _run(state)
    metrics = {}
    traced = _run(state, metrics)
    for a, b in zip(plain[0], traced[0]):
        assert torch.equal(a, b)
    for a, b in zip(plain[1], traced[1]):
        assert torch.equal(a, b)
    assert torch.equal(plain[2], traced[2])
    assert metrics["force_evals"] == STEPS + 1
    assert metrics["detections"] == STEPS // EVERY + 1
    assert metrics["deposited"] == (STEPS + 1) * N
    for key in ("step_s", "force_s", "detect_s", "deposit_s", "solve_s",
                "interp_s"):
        assert metrics[key] > 0, key
    # the device stretches are CUDA timing events: none on the CPU
    assert "force_device_s" not in metrics
    assert "detect_device_s" not in metrics


def test_profiled_call_opens_the_ranges():
    state = _state(3)
    cfg = tnb.OrbitNBodyConfig(dt=DT, n_steps=EVERY, detect_every=EVERY,
                               mode="pericentric", box_size=BOX)
    members = np.arange(N, dtype=np.int32).reshape(ROWS, ROW)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tnb.simulate_with_tracking(state, members, cfg,
                                   force_fn=make_pm_force_fn(GRID))
    names = {e.key: e.count for e in prof.key_averages()}
    assert names["oa.sim.step"] == EVERY
    assert names["oa.sim.force"] == EVERY + 1
    assert names["oa.sim.detect"] == 2
    for name in ("oa.pm.deposit", "oa.pm.solve", "oa.pm.interp"):
        assert names[name] == EVERY + 1, name
