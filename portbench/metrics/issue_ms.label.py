"""Host ms to issue a step of ``scan_label_events`` (``ops/label_step``):
the ``label.step`` span (``step_s``: each step's enqueue) over the steps
(``label_steps``), in the calls run without the profiler."""


def read(trace):
    ms = [c["metrics"] for c in trace.plain_calls
          if "step_s" in (c.get("metrics") or {})]
    steps = sum(m["label_steps"] for m in ms)
    return 1e3 * sum(m["step_s"] for m in ms) / steps if steps else None
