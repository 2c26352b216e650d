"""Device ms of a PM force evaluation (``models/pm``: deposit, Poisson
solve, interpolation): the stretches of the device stream between CUDA
timing events around each evaluation (``force_device_s``) over the
evaluations (``force_evals``, the opening one included), in the calls
run without the profiler."""


def read(trace):
    ms = [c["metrics"] for c in trace.plain_calls
          if "force_device_s" in (c.get("metrics") or {})]
    n = sum(m["force_evals"] for m in ms)
    return 1e3 * sum(m["force_device_s"] for m in ms) / n if n else None
