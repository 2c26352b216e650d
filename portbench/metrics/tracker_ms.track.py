"""The tracker's own Python a snapshot, ms: ``snapshot_s`` less the
phases it holds (``records.PHASES``), the mean over ``track_orbits``'s
``Metrics`` records, over the calls run without the profiler."""

from portbench import records


def read(trace):
    keys = ("snapshot_s",) + records.PHASES
    vals = [r["snapshot_s"] - sum(r[k] for k in records.PHASES)
            for r in records.records(trace) if all(k in r for k in keys)]
    return 1e3 * sum(vals) / len(vals) if vals else None
