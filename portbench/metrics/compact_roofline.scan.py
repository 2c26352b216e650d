"""K1 (``compact_angle_rows``) against its bound: the bytes of every
launch in the traced window at the card's HBM peak, over the device time
of the kernels ``layers.K1_KERNELS`` names."""

from portbench import layers


def read(trace):
    info = trace.info
    n = layers.launches(trace, "compact_angle_rows")
    t = layers.kernel_seconds(trace, layers.K1_KERNELS)
    return layers.roofline(
        n * layers.k1_bytes(info["halos"], info["capacity"],
                            info["event_capacity"]), t)
