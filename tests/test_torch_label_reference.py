"""The port's label-native scan (``orbitanalysis_tpu_torch.ops.
label_step.scan_label_events``) against the benchmark's plain float64
reference of the label form (``portbench/reference/labels.py``) on the
CPU, on the benchmark's own churn law (``portbench/generate.py``) at a
small size: 4 halos x 512 pool slots x 8 snapshots, one mass plane a
step, the Hubble term on.

- The port's events equal the reference's as sets, and each angle is
  within one float16 ulp of the reference's, or within
  :data:`ANGLE_ATOL` where one float16 ulp is finer than float32 arccos
  resolves: the port's angles are float16-exact sums of a float32
  arccos a step, and near cos = 1 that resolves no finer than
  ``sqrt(2 * 2**-24)`` = 3.5e-4 rad a step (the draws' turns are
  ~1e-2 rad a step, so most angles lie there; 4.6e-4 read).
- The label reference gives ``reference/orbits.py``'s events on the same
  history (the two references are tied: the same formulas in the same
  order, so the angles agree to float64 rounding).
- Per-step masses (``[S, N]`` and ``[S, R, W]``) give what a loop of the
  step with each plane gives, bit for bit; a one-plane mass gives the
  loop with that plane, as before per-step masses.
- ``metrics=`` fills the span and the counters with the hand counts and
  leaves the outputs' bits alone; under a profiler each step's ranges
  nest in ``oa.label.step``; with neither, no range is opened, no timing
  event recorded and nothing counted.
- Planted faults (moments not weighted by mass, a step left out, a
  carry left unchanged) break the benchmark's limits.

The file imports nothing of JAX."""

import json
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from orbitanalysis_tpu_torch.ops import label_step as ls  # noqa: E402
from portbench import compare_label, generate  # noqa: E402
from portbench.entries.label import label_form  # noqa: E402
from portbench.reference import labels, orbits  # noqa: E402

H, P, S, K = 4, 512, 8, 128
N = H * P
BOX = 100.0
COSMO = dict(redshift=0.5, H0=0.1, Omega_m=0.3, Omega_L=0.7)
DRAG = generate.hubble_drag(COSMO)
#: Angle gap allowed where one float16 ulp is finer than float32 arccos
#: resolves (rad): about three steps of its 3.5e-4 resolution.
ANGLE_ATOL = 1e-3
#: The label cell's limits.
with open(os.path.join(REPO, "portbench", "traffic", "label.json")) as _f:
    LIMITS = json.load(_f)["limits"]


@pytest.fixture(scope="module", params=[5, 2 ** 31 + 99])
def pool(request):
    torch.set_num_threads(2)
    seq = generate.churn_sequence(H, P, S, BOX, 0.07, request.param, "cpu")
    label, pos, vel, mass, ids = label_form(seq, P, "cpu")
    centers = torch.as_tensor(seq.centers)
    return seq, label, pos, vel, mass, ids, centers


def _scan(pool, mass="per_step", step=None, metrics=None, **kw):
    seq, label, pos, vel, m, ids, centers = pool
    mass = m if mass == "per_step" else mass
    return ls.scan_label_events(
        ls.init_label_carry(N, row_width=P, device="cpu"), pos, vel, label,
        centers.expand(S, H, 3), K, box_size=BOX, mass=mass,
        hubble_drag=DRAG, row_width=P, metrics=metrics, **kw)


def _reference(pool):
    seq, label, pos, vel, mass, ids, centers = pool
    return labels.track(label, pos, vel, mass, centers, ids, BOX, DRAG)


def _numbers(events, pool):
    label, ids = pool[1], pool[5]
    return compare_label.label_events(events.count, events.index,
                                      events.angle, label, ids,
                                      _reference(pool))


def _f16_ulps(a, b):
    ia = np.asarray(a, np.float16).view(np.int16).astype(np.int32)
    ib = np.asarray(b, np.float16).view(np.int16).astype(np.int32)
    return np.abs(ia - ib)


def _port_events(events, ids):
    """``{(step, halo, id): angle}`` of a scan's events."""
    out = {}
    for s in range(S):
        for r in range(H):
            n = int(events.count[s, r])
            for j in range(n):
                i = int(events.index[s, r, j])
                out[(s, r, int(ids[i]))] = float(events.angle[s, r, j])
    return out


def test_port_matches_label_reference(pool):
    _, events = _scan(pool)
    ref = _reference(pool)
    got = _port_events(events, pool[5])
    want = {(s, int(r), int(i)): a for s, e in enumerate(ref, start=1)
            for r, i, a in zip(e.row, e.ids, e.angles)}
    assert len(want) > 100
    assert set(got) == set(want)
    keys = sorted(want)
    g = np.array([got[k] for k in keys])
    w = np.array([want[k] for k in keys])
    assert np.all((_f16_ulps(g, w) <= 1) | (np.abs(g - w) <= ANGLE_ATOL))
    numbers = _numbers(events, pool)
    assert numbers == dict(event_mismatch=0.0, angle_mismatch=0.0,
                           layout_faults=0.0)


def test_label_reference_matches_orbits_reference(pool):
    seq = pool[0]
    lab = _reference(pool)
    orb = orbits.track(seq, DRAG)
    assert len(lab) == len(orb) == S - 1
    for a, b in zip(lab, orb):
        ka = orbits_keys(a)
        kb = orbits_keys(b)
        assert np.array_equal(np.sort(ka), np.sort(kb))
        oa, ob = np.argsort(ka), np.argsort(kb)
        np.testing.assert_allclose(a.angles[oa], b.angles[ob], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(a.bulk, b.bulk, rtol=1e-14, atol=0)


def orbits_keys(e):
    return (np.asarray(e.row, np.int64) << 32) | np.asarray(e.ids, np.int64)


def _loop(pool, planes):
    """The step looped by hand, step ``s`` weighted by ``planes[s]``."""
    seq, label, pos, vel, m, ids, centers = pool
    step = ls.make_label_orbit_step(K, box_size=BOX, row_width=P)
    carry = ls.init_label_carry(N, row_width=P, device="cpu")
    out = []
    for s in range(S):
        carry, ev = step(carry, (pos[s], vel[s], label[s], centers, None,
                                 planes[s], DRAG))
        out.append(ev)
    return carry, ls.LabelEvents(*(torch.stack(f) for f in zip(*out)))


def _same_bits(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", ["flat", "rows"])
def test_per_step_mass_is_the_loop_of_its_planes(pool, shape):
    mass = pool[4]
    given = mass if shape == "flat" else mass.reshape(S, H, P)
    carry, events = _scan(pool, mass=given)
    want_carry, want = _loop(pool, list(mass))
    _same_bits(events, want)
    _same_bits(carry, want_carry)
    # the weights matter: the first plane every step gives other bulks
    _, first = _scan(pool, mass=mass[0])
    assert not torch.equal(first.bulk_vel[1:], events.bulk_vel[1:])


@pytest.mark.parametrize("shape", ["flat", "rows"])
def test_one_plane_mass_is_the_loop_of_that_plane(pool, shape):
    plane = pool[4][3]
    given = plane if shape == "flat" else plane.reshape(H, P)
    carry, events = _scan(pool, mass=given)
    want_carry, want = _loop(pool, [plane] * S)
    _same_bits(events, want)
    _same_bits(carry, want_carry)


def test_metrics_hold_hand_counts_and_leave_the_bits(pool):
    label = pool[1]
    metrics = {"label_steps": 2}
    _, events = _scan(pool, metrics=metrics)
    _, bare = _scan(pool)
    _same_bits(events, bare)
    assert set(metrics) == {"step_s", "label_steps", "label_updates",
                            "label_events"}
    assert metrics["label_steps"] == 2 + S
    assert metrics["label_updates"] == int((label[1:] >= 0).sum())
    assert metrics["label_updates"] == sum(int(s.counts.sum())
                                           for s in pool[0].snaps[1:])
    assert metrics["label_events"] == int(events.count.sum()) > 0
    assert metrics["step_s"] > 0
    # a second call adds to what the dict holds
    _scan(pool, metrics=metrics)
    assert metrics["label_steps"] == 2 + 2 * S
    assert metrics["label_events"] == 2 * int(events.count.sum())


def _ranges(tmp_path, fn):
    """The ``oa.*`` ranges of ``fn()`` under ``torch.profiler`` (CPU):
    ``{name: [(start, end), ...]}`` in microseconds."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        name = e.get("name", "")
        if e.get("ph") == "X" and name.startswith("oa."):
            ts = float(e["ts"])
            out.setdefault(name, []).append((ts, ts + float(e["dur"])))
    return out


@pytest.mark.parametrize("with_metrics", [False, True])
def test_label_ranges_nest(pool, tmp_path, with_metrics):
    metrics = {} if with_metrics else None
    r = _ranges(tmp_path, lambda: _scan(pool, metrics=metrics))
    assert set(r) == {"oa.label.step", "oa.label.moments", "oa.label.frames",
                      "oa.label.detect", "oa.label.finish"}
    for name, spans in r.items():
        assert len(spans) == S, name
        for s, e in spans:
            assert any(ps - 1.0 <= s and e <= pe + 1.0
                       for ps, pe in r["oa.label.step"]), name
    assert (metrics is None) or metrics["label_steps"] == S


def test_no_range_no_timing_no_count_without_metrics(pool, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("traced with tracing off")

    real_event = torch.cuda.Event

    def event(*a, **k):
        if k.get("enable_timing"):
            raise AssertionError("a CUDA timing event with tracing off")
        return real_event(*a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(ls, "_count_scan", refuse)
    _, events = _scan(pool)
    assert int(events.count.sum()) > 0


def _dropped_step(pool):
    """A scan whose step 4 leaves the carry and emits nothing."""
    real = ls.make_label_orbit_step

    def make(*a, **k):
        step = real(*a, **k)
        calls = []

        def broken(carry, inputs):
            calls.append(1)
            new, ev = step(carry, inputs)
            if len(calls) == 5:
                return carry, ev._replace(count=torch.zeros_like(ev.count))
            return new, ev
        return broken
    return make


def _unchanged(pool):
    real = ls.make_label_orbit_step

    def make(*a, **k):
        step = real(*a, **k)

        def broken(carry, inputs):
            return carry, step(carry, inputs)[1]
        return broken
    return make


@pytest.mark.parametrize("fault", ["unweighted", "dropped", "unchanged"])
def test_planted_faults_are_not_correct(pool, fault, monkeypatch):
    if fault == "unweighted":
        _, events = _scan(pool, mass=None)
    else:
        make = _dropped_step(pool) if fault == "dropped" else \
            _unchanged(pool)
        monkeypatch.setattr(ls, "make_label_orbit_step", make)
        _, events = _scan(pool)
    numbers = _numbers(events, pool)
    assert any(not v <= LIMITS[k] for k, v in numbers.items()), numbers
