"""The host decode of fetched events a snapshot, ms (ordering and ID
mapping, ``engine/tracker`` ``_aligned_events``, outside ``fetch_s``):
the mean ``decode_s`` of ``track_orbits``'s ``Metrics`` records, over the
calls run without the profiler."""

from portbench import records


def read(trace):
    return records.mean(trace, "decode_s", 1e3)
