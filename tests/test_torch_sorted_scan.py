"""The port's sorted merge-join scan (``orbitanalysis_tpu_torch.engine.
scan.scan_events_sorted``) on its fused presorted path, on the CPU,
against the benchmark's plain float64 reference
(``portbench/reference/orbits.py``), on the benchmark's own churn law
(``portbench/generate.py``) at a small size: 4 halos x 512 pool slots x 8
snapshots staged as ``portbench/entries/sorted.py`` stages them, a mass
plane a step, the Hubble term on.

- The port's event IDs equal the reference's for every halo and
  snapshot, in the reference's order; each angle is within one float16
  ulp of the reference's, or within :data:`ANGLE_ATOL` where one float16
  ulp is finer than float32 arccos resolves.
- The static-membership flags read once a call
  (``ops/sorted_step.static_flags``) are the branches the step takes
  when it reads its own flag, on churning, static and mixed sequences
  (one mixed step's IDs differ from the last in bit 31 alone, which the
  step's test ignores); the scan then reads nothing a step, and its
  carry and events are the per-step reading loop's bit for bit.
- ``metrics=`` fills the span and the counters with the hand counts and
  leaves the outputs' bits alone; under a profiler each step's ranges
  nest in ``oa.sorted.step``; with neither, no range is opened, no
  timing event recorded and nothing counted.
- Planted faults (a carry left unchanged, a step left out) break the
  benchmark's limits.

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

from orbitanalysis_tpu_torch.engine import scan as tscan  # noqa: E402
from orbitanalysis_tpu_torch.models.synthetic import (  # noqa: E402
    churn_workload,
    static_workload,
)
from orbitanalysis_tpu_torch.ops import sorted_step as tss  # noqa: E402
from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch  # noqa: E402
from portbench import compare_sorted, generate  # noqa: E402
from portbench.entries.sorted import sorted_form  # noqa: E402
from portbench.reference import orbits  # noqa: E402

H, P, S, K = 4, 512, 8, 128
BOX = 100.0
COSMO = dict(redshift=0.5, H0=0.1, Omega_m=0.3, Omega_L=0.7)
DRAG = generate.hubble_drag(COSMO)
#: Angle gap allowed where one float16 ulp is finer than float32 arccos
#: resolves (rad): the port's angles are float32 sums of a float32
#: arccos a step, and near cos = 1 that resolves no finer than
#: ``sqrt(2 * 2**-24)`` = 3.5e-4 rad a step; about three steps of it.
ANGLE_ATOL = 1e-3
INVALID = np.iinfo(np.int32).max
#: The sorted cell's limits.
with open(os.path.join(REPO, "portbench", "traffic", "sorted64.json")) as _f:
    LIMITS = json.load(_f)["limits"]


@pytest.fixture(scope="module", params=[5, 2 ** 31 + 99])
def pool(request):
    torch.set_num_threads(2)
    seq = generate.churn_sequence(H, P, S, BOX, 0.07, request.param, "cpu")
    staged = sorted_form(seq, P, "cpu")._replace(hubble_drag=DRAG)
    return seq, staged


def _carry():
    return tss.init_sorted_carry(H, P, device="cpu")


def _scan(staged, carry=None, metrics=None):
    return tscan.scan_events_sorted(
        _carry() if carry is None else carry, staged, K, box_size=BOX,
        fused=True, cur_presorted=True, soa_batch=True, metrics=metrics)


def _f16_ulps(a, b):
    ia = np.asarray(a, np.float16).view(np.int16).astype(np.int32)
    ib = np.asarray(b, np.float16).view(np.int16).astype(np.int32)
    return np.abs(ia - ib)


def _same_bits(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_port_matches_reference(pool):
    seq, staged = pool
    _, (count, ids, angles) = _scan(staged)
    ref = orbits.track(seq, DRAG)
    assert int(count[0].sum()) == 0
    total = 0
    for s, e in enumerate(ref, start=1):
        for h in range(H):
            n = int(count[s, h])
            want = e.ids[e.row == h]
            np.testing.assert_array_equal(ids[s, h, :n].numpy(), want)
            got = angles[s, h, :n].double().numpy()
            w = e.angles[e.row == h]
            assert np.all((_f16_ulps(got, w) <= 1)
                          | (np.abs(got - w) <= ANGLE_ATOL))
            total += n
    assert total > 100
    numbers = compare_sorted.sorted_events(count, ids, angles, seq, ref)
    assert numbers == dict(event_mismatch=0.0, angle_mismatch=0.0,
                           layout_faults=0.0)


# ----------------------------------------------------------------------
# the static test, once a call
# ----------------------------------------------------------------------

def _staged(kind):
    """A presorted sequence of 3 halos of 256 over 8 snapshots:
    ``'churn'``, ``'static'`` (one membership throughout), or ``'mixed'``
    (churn, with steps 3 and 4 holding step 2's IDs with their own
    positions, and step 6 step 5's IDs with one ID's bit 31 set, which
    keeps the row's order)."""
    h, p, s = 3, 256, 8
    make = static_workload if kind == "static" else churn_workload
    ids, pos, vel, cen, _ = make(h, p, s, seed=11)
    if kind == "mixed":
        ids[3] = ids[4] = ids[2]
        ids[6] = ids[5]
    st = tss.presort_snapshot(SnapshotBatch(ids=ids, pos=pos, vel=vel,
                                            center=cen), soa=True)
    if kind == "mixed":
        st.ids[6, 0, 0] |= np.int32(-(1 << 31))
    return st._replace(**{f: torch.from_numpy(np.ascontiguousarray(
        getattr(st, f))) for f in ("ids", "pos", "vel", "center", "slot")},
        hubble_drag=np.linspace(0.0, 0.02, s))


def _reading_loop(staged, monkeypatch):
    """The fused presorted step over ``staged``, each step reading its
    own flag: ``(carry, stacked events, the static branch taken a step,
    the host reads made)``."""
    taken, reads = [], []
    real_static = tss._static_detect
    real_bool = torch.Tensor.__bool__

    def static_detect(*a):
        taken[-1] = True
        return real_static(*a)

    def read(t):
        reads.append(1)
        return real_bool(t)

    monkeypatch.setattr(tss, "_static_detect", static_detect)
    monkeypatch.setattr(torch.Tensor, "__bool__", read)
    step = tss.make_sorted_orbit_step(K, box_size=BOX, fused=True,
                                      cur_presorted=True, soa_batch=True)
    h, p = staged.ids.shape[1:]
    carry = tss.init_sorted_carry(h, p, device="cpu")
    drag = np.broadcast_to(np.asarray(staged.hubble_drag, np.float32),
                           (staged.ids.shape[0],))
    outs = []
    for s in range(staged.ids.shape[0]):
        taken.append(False)
        carry, ev = step(carry, SnapshotBatch(
            ids=staged.ids[s], pos=staged.pos[s], vel=staged.vel[s],
            center=staged.center[s], slot=staged.slot[s],
            hubble_drag=float(drag[s])))
        outs.append((ev.count, ev.ids, ev.angles))
    monkeypatch.undo()
    events = tuple(torch.stack(x) for x in zip(*outs))
    return carry, events, taken, len(reads)


@pytest.mark.parametrize("kind", ["churn", "static", "mixed"])
def test_flags_a_call_are_the_steps_own_reads(kind, monkeypatch):
    staged = _staged(kind)
    n = staged.ids.shape[0]
    want_carry, want, taken, reads = _reading_loop(staged, monkeypatch)
    assert reads == n
    h, p = staged.ids.shape[1:]
    flags = tss.static_flags(
        tss.init_sorted_carry(h, p, device="cpu").ids, staged.ids)
    assert list(flags) == taken
    expect = {"churn": [False] * n, "static": [False] + [True] * (n - 1),
              "mixed": [False, False, False, True, True, False, True,
                        False]}[kind]
    assert taken == expect
    if kind == "mixed":
        # bit 31 alone differs: plain equality would not call it static
        assert not torch.equal(staged.ids[6], staged.ids[5])
    # the scan: the flags read once (no read a step), the loop's bits
    real_bool = torch.Tensor.__bool__
    scan_reads = []

    def read(t):
        scan_reads.append(1)
        return real_bool(t)

    monkeypatch.setattr(torch.Tensor, "__bool__", read)
    metrics = {}
    carry, events = tscan.scan_events_sorted(
        tss.init_sorted_carry(h, p, device="cpu"), staged, K, box_size=BOX,
        fused=True, cur_presorted=True, soa_batch=True, metrics=metrics)
    monkeypatch.undo()
    assert scan_reads == []
    _same_bits(events, want)
    _same_bits(carry, want_carry)
    assert metrics["sorted_static_steps"] == sum(expect)
    assert int(events[0].sum()) > 0


def test_flags_follow_the_incoming_carry():
    """Step 0's flag compares the carry handed in with the first staged
    IDs: a carry holding them makes step 0 static."""
    staged = _staged("churn")
    h, p = staged.ids.shape[1:]
    carry = tss.init_sorted_carry(h, p, device="cpu")
    assert tss.static_flags(carry.ids, staged.ids)[0] is False
    assert tss.static_flags(staged.ids[0], staged.ids)[0] is True
    assert tss.static_flags(carry.ids, staged.ids[:0]) == ()
    assert tss.static_flags(staged.ids[0], staged.ids[:1]) == (True,)


# ----------------------------------------------------------------------
# spans, counters and ranges
# ----------------------------------------------------------------------

def test_metrics_hold_hand_counts_and_leave_the_bits(pool):
    seq, staged = pool
    metrics = {"sorted_steps": 2}
    _, events = _scan(staged, metrics=metrics)
    _, bare = _scan(staged)
    _same_bits(events, bare)
    assert set(metrics) == {"step_s", "sorted_steps", "sorted_updates",
                            "sorted_events", "sorted_static_steps"}
    assert metrics["sorted_steps"] == 2 + S
    assert metrics["sorted_updates"] == int((staged.ids[1:] != INVALID).sum())
    assert metrics["sorted_updates"] == sum(int(s.counts.sum())
                                            for s in seq.snaps[1:])
    assert metrics["sorted_events"] == int(events[0].sum()) > 0
    assert metrics["sorted_static_steps"] == 0
    assert metrics["step_s"] > 0
    # a second call adds to what the dict holds
    _scan(staged, metrics=metrics)
    assert metrics["sorted_steps"] == 2 + 2 * S
    assert metrics["sorted_events"] == 2 * int(events[0].sum())


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
def test_sorted_ranges_nest(pool, tmp_path, with_metrics):
    metrics = {} if with_metrics else None
    r = _ranges(tmp_path, lambda: _scan(pool[1], metrics=metrics))
    assert set(r) == {"oa.sorted.step", "oa.sorted.frame", "oa.sorted.join",
                      "oa.sorted.finish"}
    for name, spans in r.items():
        assert len(spans) == S, name
        for s, e in spans:
            assert any(ps - 1.0 <= s and e <= pe + 1.0
                       for ps, pe in r["oa.sorted.step"]), name
    assert (metrics is None) or metrics["sorted_steps"] == S


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
    monkeypatch.setattr(tscan, "_count_sorted", refuse)
    _, events = _scan(pool[1])
    assert int(events[0].sum()) > 0


# ----------------------------------------------------------------------
# planted faults
# ----------------------------------------------------------------------

def _faulty_builder(fault):
    real = tss.make_sorted_orbit_step

    def make(*a, **k):
        step = real(*a, **k)
        calls = []

        def broken(carry, snap, static=None):
            calls.append(1)
            new, ev = step(carry, snap, static=static)
            if fault == "unchanged":
                return carry, ev
            if len(calls) == 5:
                return carry, ev._replace(count=torch.zeros_like(ev.count))
            return new, ev
        return broken
    return make


@pytest.mark.parametrize("fault", ["unchanged", "dropped"])
def test_planted_faults_are_not_correct(pool, fault, monkeypatch):
    seq, staged = pool
    monkeypatch.setattr(tss, "make_sorted_orbit_step", _faulty_builder(fault))
    _, (count, ids, angles) = _scan(staged)
    numbers = compare_sorted.sorted_events(count, ids, angles, seq,
                                           orbits.track(seq, DRAG))
    assert any(not v <= LIMITS[k] for k, v in numbers.items()), numbers
