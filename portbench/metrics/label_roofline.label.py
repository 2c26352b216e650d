"""The label step's kernels against their bound: the bytes of every
launch of K7, K6 and K8 (or K9 + K4, or K10 + K5, where those ran in
their place) in the traced window (``layers_label.launch_bytes``) at the
card's HBM peak, over the device time of the kernels
``layers_label.TRACE_NAMES`` names."""

from portbench import layers, layers_label


def read(trace):
    n_bytes = sum(layers.launches(trace, name)
                  * layers_label.launch_bytes(name, trace.info)
                  for name in layers_label.KERNELS)
    t = layers.kernel_seconds(trace, layers_label.TRACE_NAMES)
    return layers.roofline(n_bytes, t)
