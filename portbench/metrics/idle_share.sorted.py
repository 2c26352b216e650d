"""Percent of the traced window with no device operation running
(the profiler's kernels, copies and fills)."""

from portbench import layers


def read(trace):
    return layers.idle_share(trace)
