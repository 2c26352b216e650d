"""The tracker's lead a call, ms: host seconds from ``track_orbits``'
entry to its first saved snapshot's iteration (checks, engine and writer
set-up, the seed snapshot), the mean ``lead_s`` of each call's first
``Metrics`` record, over the calls run without the profiler."""


def read(trace):
    vals = [c["records"][0]["lead_s"] for c in trace.plain_calls
            if c.get("records") and "lead_s" in c["records"][0]]
    return 1e3 * sum(vals) / len(vals) if vals else None
