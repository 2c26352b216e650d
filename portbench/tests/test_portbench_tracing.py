"""The readers of the tracker's spans and counters (``lead_ms.track`` to
``decode_ms.track``): each returns its hand-computed value on hand-made
``Metrics`` records, and None on calls without records or without its
key (a program that does not write it)."""

from __future__ import annotations

import pytest

from portbench import harness

#: Two calls of two records each, as ``track_orbits`` logs them.
CALLS = [
    {"work": 1, "latency_s": 1.0, "records": [
        {"lead_s": 0.200, "snapshot_s": 0.050, "load_s": 0.001,
         "pack_s": 0.020, "align_s": 0.008, "step_s": 0.006,
         "stage_s": 0.004, "issue_s": 0.0015, "step_device_s": 0.0012,
         "fetch_s": 0.0003, "decode_s": 0.002, "save_s": 0.0007,
         "h2d_bytes": 59_000_000},
        {"snapshot_s": 0.040, "load_s": 0.002, "pack_s": 0.022,
         "align_s": 0.010, "step_s": 0.004, "stage_s": 0.002,
         "issue_s": 0.0017, "step_device_s": 0.0014, "fetch_s": 0.0005,
         "decode_s": 0.004, "save_s": 0.0005, "h2d_bytes": 61_000_000}]},
    {"work": 1, "latency_s": 1.0, "records": [
        {"lead_s": 0.100, "snapshot_s": 0.060, "load_s": 0.003,
         "pack_s": 0.024, "align_s": 0.012, "step_s": 0.008,
         "stage_s": 0.005, "issue_s": 0.0023, "step_device_s": 0.0016,
         "fetch_s": 0.0002, "decode_s": 0.003, "save_s": 0.0008,
         "h2d_bytes": 60_000_000},
        {"snapshot_s": 0.050, "load_s": 0.004, "pack_s": 0.026,
         "align_s": 0.014, "step_s": 0.010, "stage_s": 0.007,
         "issue_s": 0.0025, "step_device_s": 0.0018, "fetch_s": 0.0004,
         "decode_s": 0.001, "save_s": 0.0006, "h2d_bytes": 60_000_000}]},
]

PHASES = ("load_s", "pack_s", "step_s", "fetch_s", "decode_s", "save_s")


def _mean(key, scale=1e3):
    vals = [r[key] for c in CALLS for r in c["records"]]
    return scale * sum(vals) / len(vals)


def _self_ms():
    vals = [r["snapshot_s"] - sum(r[k] for k in PHASES)
            for c in CALLS for r in c["records"]]
    return 1e3 * sum(vals) / len(vals)


#: Each reader's value on ``CALLS``, computed by hand.
WANT = {
    "lead_ms.track": 1e3 * (0.200 + 0.100) / 2,
    "tracker_ms.track": _self_ms(),
    "align_ms.track": _mean("align_s"),
    "stage_ms.track": _mean("stage_s"),
    "h2d_mb.track": (59 + 61 + 60 + 60) / 4,
    "issue_ms.track": _mean("issue_s"),
    "step_device_ms.track": _mean("step_device_s"),
    "decode_ms.track": _mean("decode_s"),
}


def _trace(plain_calls):
    return harness.Trace([], plain_calls, 1.0, 1.0, 0.1, {}, {})


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_hand_made_records(name):
    got = harness.metric_reader(name).read(_trace(CALLS))
    assert got == pytest.approx(WANT[name], rel=1e-12)
    assert WANT[name] > 0


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_without_records_gives_none(name):
    read = harness.metric_reader(name).read
    assert read(_trace([])) is None
    assert read(_trace([{"work": 1, "latency_s": 1.0}])) is None
    # the parent's records: today's keys only
    old = [{"work": 1, "latency_s": 1.0, "records": [
        {k: v for k, v in r.items()
         if k in ("load_s", "pack_s", "step_s", "fetch_s", "save_s")}
        for r in c["records"]]} for c in CALLS]
    assert read(_trace(old)) is None


def test_tracker_self_time_by_hand():
    """The first record's self time, by hand: 50 ms less 1 + 20 + 6 +
    0.3 + 2 + 0.7 ms."""
    one = [{"records": [CALLS[0]["records"][0]]}]
    got = harness.metric_reader("tracker_ms.track").read(_trace(one))
    assert got == pytest.approx(50.0 - 30.0)


def test_new_readers_declared_for_the_track_cell():
    """Each reader is a per-layer metric of the track cell alone, moving
    its rate."""
    from conftest import bench

    metrics = {m["name"]: m for m in bench()["per_layer"]}
    for name in WANT:
        m = metrics[name]
        assert m["workloads"] == ["track.config2"]
        assert m["moves"] == "track_updates_per_s"
    spec = harness.find_cell(bench(), "track.config2")
    assert set(WANT) <= {m["name"] for m in spec.per_layer}
    spec = harness.find_cell(bench(), "scan.config2")
    assert not set(WANT) & {m["name"] for m in spec.per_layer}
