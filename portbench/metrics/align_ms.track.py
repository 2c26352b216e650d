"""The stable-layout alignment a snapshot, ms (``engine/packing``
``align_packed``, within ``pack_s``): the mean ``align_s`` of
``track_orbits``'s ``Metrics`` records, over the calls run without the
profiler."""

from portbench import records


def read(trace):
    return records.mean(trace, "align_s", 1e3)
