"""Host ms to issue a KDK step of ``simulate_with_tracking``
(``models/nbody``): the ``sim.step`` span (``step_s``: the step's
enqueue, its detection included) over the steps, in the calls run
without the profiler."""


def read(trace):
    vals = [c["metrics"]["step_s"] for c in trace.plain_calls
            if "step_s" in (c.get("metrics") or {})]
    steps = len(vals) * trace.info["steps_per_call"]
    return 1e3 * sum(vals) / steps if steps else None
