"""Bytes staged to the card a snapshot, MB (``engine/tracker``
``_stage``): the mean ``h2d_bytes`` of ``track_orbits``'s ``Metrics``
records over 1e6, over the calls run without the profiler."""

from portbench import records


def read(trace):
    return records.mean(trace, "h2d_bytes", 1e-6)
