"""Host ms to issue an aligned step (``engine/scan``,
``ops/sorted_step``): the benchmark's span from call to return of
``scan_events_aligned``, before the synchronisation, over its steps,
in the calls run without the profiler."""


def read(trace):
    steps = len(trace.plain_calls) * trace.info["steps_per_call"]
    if steps == 0:
        return None
    return 1e3 * sum(c["host_s"] for c in trace.plain_calls) / steps
