"""Device ms of a step of ``scan_label_events`` (``ops/label_step``: the
moments, frame rows, detection and compaction): the stretches of the
device stream between CUDA timing events around each step
(``label_device_s``) over the steps (``label_steps``), in the calls run
without the profiler."""


def read(trace):
    ms = [c["metrics"] for c in trace.plain_calls
          if "label_device_s" in (c.get("metrics") or {})]
    steps = sum(m["label_steps"] for m in ms)
    return 1e3 * sum(m["label_device_s"] for m in ms) / steps if steps \
        else None
