"""Host staging (``engine/packing``, ``native``) a snapshot, ms: the
mean ``pack_s`` of ``track_orbits``'s ``Metrics`` records, over the
calls run without the profiler."""


def read(trace):
    vals = [r["pack_s"] for c in trace.plain_calls
            for r in c.get("records", []) if "pack_s" in r]
    return 1e3 * sum(vals) / len(vals) if vals else None
