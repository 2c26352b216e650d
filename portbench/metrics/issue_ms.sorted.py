"""Host ms to issue a step of ``scan_events_sorted`` (``engine/scan``,
``ops/sorted_step``): the ``sorted.step`` span (``step_s``: each step's
enqueue, or a replay's with its copies and any capture before it) over
the steps (``sorted_steps``), in the calls run without the profiler."""


def read(trace):
    ms = [c["metrics"] for c in trace.plain_calls
          if "step_s" in (c.get("metrics") or {})]
    steps = sum(m.get("sorted_steps", 0) for m in ms)
    return 1e3 * sum(m["step_s"] for m in ms) / steps if steps else None
