"""The per-layer readers' view of ``track_orbits``' ``Metrics`` records
(``orbitanalysis_tpu_torch/utils/metrics.py``): the records of the
traced calls run without the profiler, one per saved snapshot.  A
program without a key gives no value: the reader returns None."""

from __future__ import annotations

#: The phases a snapshot's ``snapshot_s`` holds besides the tracker's
#: own Python.
PHASES = ("load_s", "pack_s", "step_s", "fetch_s", "decode_s", "save_s")


def records(trace) -> list:
    return [r for c in trace.plain_calls for r in c.get("records", [])]


def mean(trace, key: str, scale: float):
    """``scale`` times the mean ``key`` of the records that have it."""
    vals = [r[key] for r in records(trace) if key in r]
    return scale * sum(vals) / len(vals) if vals else None
