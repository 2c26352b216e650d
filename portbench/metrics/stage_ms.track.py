"""Host-to-device staging a snapshot, ms (``engine/tracker`` ``_stage``:
the pinned copies and their enqueue, within ``step_s``): the mean
``stage_s`` of ``track_orbits``'s ``Metrics`` records, over the calls run
without the profiler."""

from portbench import records


def read(trace):
    return records.mean(trace, "stage_s", 1e3)
