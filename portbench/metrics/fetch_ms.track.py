"""``engine/tracker`` ``_Fetch`` a snapshot, ms (the copy to the host
plus the wait for the device): the mean ``fetch_s`` of
``track_orbits``'s ``Metrics`` records, over the
calls run without the profiler."""


def read(trace):
    vals = [r["fetch_s"] for c in trace.plain_calls
            for r in c.get("records", []) if "fetch_s" in r]
    return 1e3 * sum(vals) / len(vals) if vals else None
