"""The whole aligned step against its bound: the bytes a step must move
(``layers.aligned_step_bytes``) at the card's HBM peak, over the device
busy time a step."""

from portbench import layers


def read(trace):
    info = trace.info
    steps = len(trace.calls) * info["steps_per_call"]
    events = sum(c.get("events", 0) for c in trace.calls)
    n_bytes = steps * layers.aligned_step_bytes(
        info["halos"], info["capacity"], 0) + events * \
        layers.ALIGNED_EVENT_BYTES
    return layers.roofline(n_bytes, trace.busy_s)
