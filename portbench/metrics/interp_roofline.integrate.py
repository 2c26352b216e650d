"""The PM force's interpolation kernel (``cic_interpolate``,
``orbitanalysis_tpu_torch/csrc/interp.cu``) against its bound: the bytes
of every launch in the traced window at the card's HBM peak, over the
device time of the kernel :data:`INTERP_KERNELS` names.  A program
without the kernel launches none, and the reader finds nothing."""

from portbench import layers

#: The interpolation kernel in a trace (the words of its name).
INTERP_KERNELS = (("cic_interpolate_kernel",),)


def interp_bytes(particles: int, grid: int) -> int:
    """One launch on ``particles`` positions and a ``[3, grid, grid,
    grid]`` field: each position read once and each acceleration written
    once (12 + 12 B), each field cell read once (12 B)."""
    return 24 * particles + 12 * grid ** 3


def read(trace):
    info = trace.info
    n = layers.launches(trace, "cic_interpolate")
    t = layers.kernel_seconds(trace, INTERP_KERNELS)
    return layers.roofline(
        n * interp_bytes(info["particles"], info["grid"]), t)
