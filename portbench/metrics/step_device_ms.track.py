"""The step's stretch of the device stream a snapshot, ms: CUDA timing
events after the staging copies and after the step's last launch, the
mean ``step_device_s`` of ``track_orbits``'s ``Metrics`` records, over
the calls run without the profiler.  It reads the device's work where
the device sets the pace, the enqueue (``issue_ms.track``) where the
host does."""

from portbench import records


def read(trace):
    return records.mean(trace, "step_device_s", 1e3)
