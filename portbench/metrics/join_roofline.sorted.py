"""K16 (``fused_join_detect``) against its bound: the bytes of every
launch in the traced window (``layers_sorted.launch_bytes``) at the
card's HBM peak, over the device time of the kernels
``layers_sorted.TRACE_NAMES`` names."""

from portbench import layers, layers_sorted


def read(trace):
    n_bytes = sum(layers.launches(trace, name)
                  * layers_sorted.launch_bytes(name, trace.info)
                  for name in layers_sorted.KERNELS)
    t = layers.kernel_seconds(trace, layers_sorted.TRACE_NAMES)
    return layers.roofline(n_bytes, t)
