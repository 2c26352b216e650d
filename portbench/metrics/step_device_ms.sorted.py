"""Device ms of a step of ``scan_events_sorted`` (``ops/sorted_step``:
the region frame, K16 or the static branch, the finish): the stretches
of the device stream between CUDA timing events around each step, or
around the scan's replay (``sorted_device_s``), over the steps
(``sorted_steps``), in the calls run without the profiler."""


def read(trace):
    ms = [c["metrics"] for c in trace.plain_calls
          if "sorted_device_s" in (c.get("metrics") or {})]
    steps = sum(m["sorted_steps"] for m in ms)
    return 1e3 * sum(m["sorted_device_s"] for m in ms) / steps if steps \
        else None
