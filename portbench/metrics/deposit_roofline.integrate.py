"""K13 (``deposit_sorted``) against its bound: the bytes of every launch
in the traced window (``layers_nbody.k13_bytes``) at the card's HBM
peak, over the device time of the kernels ``layers_nbody.K13_KERNELS``
names."""

from portbench import layers, layers_nbody


def read(trace):
    info = trace.info
    n = layers.launches(trace, "deposit_sorted")
    t = layers.kernel_seconds(trace, layers_nbody.K13_KERNELS)
    return layers.roofline(
        n * layers_nbody.k13_bytes(info["particles"], info["grid"]), t)
