"""The step's enqueue a snapshot, ms (the engines' ``step`` calls:
``engine/tracker``, ``ops/sorted_step``; within ``step_s``): the mean
``issue_s`` of ``track_orbits``'s ``Metrics`` records, over the calls run
without the profiler."""

from portbench import records


def read(trace):
    return records.mean(trace, "issue_s", 1e3)
