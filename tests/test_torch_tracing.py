"""The port's tracing on the CPU: ``track_orbits``' ``Metrics`` records
account for the whole call (every phase inside its parent, self times
non-negative, the seed snapshot in ``lead_s``), the ``oa.*`` profiler
ranges nest as the phases do in the tracker and in the aligned scan, and
with tracing off no range is opened.

The file imports nothing of JAX; the data is the port's own synthetic
churn."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orbitanalysis_tpu_torch import track_orbits
from orbitanalysis_tpu_torch.engine.io_hdf5 import MemoryWriter
from orbitanalysis_tpu_torch.models.synthetic import churn_snapshots
from orbitanalysis_tpu_torch.utils.metrics import Metrics, phase_timer

from helpers import make_callbacks

torch.set_num_threads(1)

N_HALOS, N_PART, N_SNAP, BOX = 3, 150, 8, 60.0
#: Record keys of the call's accounting (single-device engines).
NEW_KEYS = ("snapshot_s", "stage_s", "issue_s", "decode_s", "h2d_bytes")
#: Floating-point room when a sum of spans is held against its parent.
EPS = 1e-6


@pytest.fixture(scope="module")
def churn():
    snaps, centers = churn_snapshots(N_HALOS, N_PART, N_SNAP, box_size=BOX,
                                     seed=11)
    regions, loader = make_callbacks(snaps, centers, box_size=BOX)
    return snaps, regions, loader


def _track(churn, **kw):
    _, regions, loader = churn
    kw.setdefault("join_impl", "aligned")
    track_orbits(np.arange(N_SNAP), np.tile(np.arange(N_HALOS), (N_SNAP, 1)),
                 regions, loader, "run.h5", verbose=False, device="cpu",
                 writer=MemoryWriter(), **kw)


def _staged_bytes(capacity, join):
    """Bytes the staging hands to the device a snapshot: per slot an ID,
    a position, a velocity, a mass (4 + 12 + 12 + 4 B) and, on the
    aligned and sorted engines, a load slot (4 B); the [H, 3] centres."""
    slot = 36 if join in ("aligned", "sorted") else 32
    return N_HALOS * capacity * slot + N_HALOS * 3 * 4


@pytest.mark.parametrize("join", ["aligned", "general", "sorted"])
def test_records_account_for_the_call(churn, join):
    """Every record carries the accounting's keys, each phase is within
    its parent, every self time is non-negative, ``lead_s`` is on the
    first record alone, and the accounted seconds stay inside the call."""
    m = Metrics()
    t0 = time.perf_counter()
    _track(churn, join_impl=join, metrics=m)
    call_s = time.perf_counter() - t0
    assert len(m.records) == N_SNAP - 1
    assert "lead_s" in m.records[0]
    assert not any("lead_s" in r for r in m.records[1:])
    for r in m.records:
        for key in NEW_KEYS + ("load_s", "pack_s", "step_s", "fetch_s",
                               "save_s"):
            assert key in r, (key, r)
        assert ("align_s" in r) == (join == "aligned")
        assert "step_device_s" not in r  # CUDA only
        assert r["stage_s"] + r["issue_s"] <= r["step_s"] + EPS
        assert r.get("align_s", 0.0) <= r["pack_s"] + EPS
        phases = sum(r[k] for k in ("load_s", "pack_s", "step_s", "fetch_s",
                                    "decode_s", "save_s"))
        assert r["snapshot_s"] - phases >= -EPS, r
        assert r["h2d_bytes"] == _staged_bytes(r["capacity"], join)
    accounted = m.records[0]["lead_s"] + sum(r["snapshot_s"]
                                             for r in m.records)
    assert 0.9 * call_s <= accounted <= call_s


def test_lead_reaches_the_first_saved_record(churn):
    """A snapshot with no live branch right after the seed is skipped:
    ``lead_s`` still lands on the first saved record, and only there."""
    _, regions, loader = churn
    branches = np.tile(np.arange(N_HALOS), (N_SNAP, 1))
    branches[1] = -1
    m = Metrics()
    track_orbits(np.arange(N_SNAP), branches, regions, loader, "run.h5",
                 verbose=False, device="cpu", join_impl="aligned",
                 metrics=m, writer=MemoryWriter())
    assert [r["snapshot"] for r in m.records] == list(range(2, N_SNAP))
    assert ["lead_s" in r for r in m.records] == [True] + [False] * (
        N_SNAP - 3)


def test_no_new_timing_without_metrics(churn, monkeypatch):
    """Without ``metrics`` the call times nothing new: the accounting's
    spans take no dict (monkeypatched ``phase_timer`` sees each new
    span's ``out`` as None)."""
    from orbitanalysis_tpu_torch.engine import packing, tracker

    seen = {}
    real = tracker.phase_timer

    def spy(out, name):
        seen.setdefault(name, set()).add(out is None)
        return real(out, name)

    monkeypatch.setattr(tracker, "phase_timer", spy)
    monkeypatch.setattr(packing, "phase_timer", spy)
    _track(churn)
    for name in ("track.lead", "track.snapshot", "track.flush",
                 "track.stage", "track.issue", "track.decode",
                 "track.pack.align"):
        assert seen[name] == {True}, name
    # today's phases keep their dict
    for name in ("track.load", "track.pack", "track.step", "track.fetch",
                 "track.save"):
        assert seen[name] == {False}, name


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


def _inside(ranges, child, parent):
    """Every ``child`` range lies within some ``parent`` range."""
    eps = 1.0  # the export rounds to the microsecond
    for s, e in ranges[child]:
        assert any(ps - eps <= s and e <= pe + eps
                   for ps, pe in ranges[parent]), (child, parent, s, e)


@pytest.mark.parametrize("with_metrics", [False, True])
def test_tracker_ranges_nest(tmp_path, churn, with_metrics):
    """Under a profiler the tracker's ranges nest as its phases:
    load, pack, step within a snapshot, the alignment within the pack,
    staging and issue within the step, fetch, decode and save within a
    flush, the aligned step's stages within the issue; one lead a call,
    one snapshot range an iteration, one flush a snapshot."""
    kw = dict(metrics=Metrics()) if with_metrics else {}
    r = _ranges(tmp_path, lambda: _track(churn, **kw))
    assert len(r["oa.track.lead"]) == 1
    assert len(r["oa.track.snapshot"]) == N_SNAP
    assert len(r["oa.track.flush"]) == N_SNAP
    for child, parent in (
            ("oa.track.load", "oa.track.snapshot"),
            ("oa.track.pack", "oa.track.snapshot"),
            ("oa.track.step", "oa.track.snapshot"),
            ("oa.track.pack.align", "oa.track.pack"),
            ("oa.track.stage", "oa.track.step"),
            ("oa.track.issue", "oa.track.step"),
            ("oa.track.fetch", "oa.track.flush"),
            ("oa.track.decode", "oa.track.flush"),
            ("oa.track.save", "oa.track.flush"),
            ("oa.step.frame", "oa.track.issue"),
            ("oa.step.detect", "oa.track.issue"),
            ("oa.step.compact", "oa.track.issue"),
            ("oa.step.finish", "oa.track.issue")):
        _inside(r, child, parent)
    # the lead holds the seed snapshot and ends before the first saved
    # snapshot's iteration
    (lead_s, lead_e), = r["oa.track.lead"]
    first = min(s for s, _ in r["oa.track.snapshot"])
    assert lead_s <= first <= lead_e + 1.0
    assert sum(lead_s <= s and e <= lead_e + 1.0
               for s, e in r["oa.track.snapshot"]) == 1


def _aligned_scan(device="cpu"):
    from orbitanalysis_tpu_torch.engine.packing import stage_batch_aligned
    from orbitanalysis_tpu_torch.engine.scan import scan_events_aligned
    from orbitanalysis_tpu_torch.models.synthetic import churn_workload
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu_torch.ops.sorted_step import init_aligned_carry

    h, p, s_n = 2, 512, 4
    ids, pos, vel, cen, _ = churn_workload(h, p, s_n, seed=3)
    staged = stage_batch_aligned(SnapshotBatch(
        ids=ids, pos=pos, vel=vel, center=cen), soa=True)
    return s_n, lambda: scan_events_aligned(
        init_aligned_carry(h, p, device=device), staged, 128,
        box_size=100.0, soa_batch=True)


def test_scan_ranges_nest(tmp_path):
    """A profiled ``scan_events_aligned`` run holds one ``oa.scan.step`` a
    step and, within each, the aligned step's four ranges."""
    s_n, run = _aligned_scan()
    r = _ranges(tmp_path, run)
    assert len(r["oa.scan.step"]) == s_n
    for name in ("oa.step.frame", "oa.step.detect", "oa.step.compact",
                 "oa.step.finish"):
        assert len(r[name]) == s_n, name
        _inside(r, name, "oa.scan.step")
    assert not any(n.startswith("oa.track.") for n in r)


@pytest.mark.parametrize("with_metrics", [False, True])
def test_no_range_without_a_profiler(churn, monkeypatch, with_metrics):
    """With no profiler recording, neither the tracker (with or without
    ``metrics``) nor the scan enters ``record_function``, and the
    tracker records no CUDA timing event."""
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    real_event = torch.cuda.Event

    def event(*a, **k):
        if k.get("enable_timing"):
            raise AssertionError("a CUDA timing event with tracing off")
        return real_event(*a, **k)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    if not with_metrics:
        monkeypatch.setattr(torch.cuda, "Event", event)
    m = Metrics() if with_metrics else None
    _track(churn, metrics=m)
    _, run = _aligned_scan()
    run()
    if with_metrics:
        assert len(m.records) == N_SNAP - 1


def test_phase_timer_contract(tmp_path):
    """``phase_timer`` adds into the key of its name's last dotted part,
    accumulates, opens ``oa.<name>`` only under a profiler, and with
    neither a dict nor a profiler returns one shared no-op."""
    d = {}
    with phase_timer(d, "track.pack.align"):
        pass
    with phase_timer(d, "track.pack.align"):
        pass
    with phase_timer(d, "load"):
        pass
    assert set(d) == {"align_s", "load_s"} and d["align_s"] >= 0.0
    assert phase_timer(None, "a") is phase_timer(None, "b")
    r = _ranges(tmp_path, lambda: [phase_timer(None, "x.y").__enter__()
                                   .__exit__(None, None, None),
                                   phase_timer({}, "x.z").__enter__()
                                   .__exit__(None, None, None)])
    assert set(r) == {"oa.x.y", "oa.x.z"}
