"""The yardstick of the sorted cell's kernel reader: the bytes K16
(``fused_join_detect``, ``orbitanalysis_tpu_torch/csrc/merge.cu``) must
move a launch at the cell's shapes, as ``chip_smoke.py`` reckons them
(``:1583-1587``): each input byte read once and each output byte
written once.  And the names its kernel carries in the profiler's
trace."""

from __future__ import annotations

#: ``ops/_cuda.launch_counts`` name -> the words of its kernel's name in
#: a trace.
KERNELS = {"fused_join_detect": (("join_detect_kernel",),)}
TRACE_NAMES = tuple(w for ws in KERNELS.values() for w in ws)


def k128(event_capacity: int, length: int) -> int:
    """The event lists' width: the capacity rounded up to 128 lanes, at
    most the row."""
    return min(-(-event_capacity // 128) * 128, length)


def k16_bytes(halos: int, length: int, event_capacity: int) -> int:
    """``fused_join_detect`` on ``[halos, length]`` rows: the prev key,
    sv, r-hat (3) and angle planes and the cur key, sv and r-hat (3)
    planes read (11 words a slot), the packed carry plane written (1
    word a slot), the ``[H, k128]`` event key, sv and angle lists and the
    ``[H]`` counts written."""
    w = k128(event_capacity, length)
    return 12 * 4 * halos * length + 3 * 4 * halos * w + 4 * halos


def launch_bytes(name: str, info: dict) -> int:
    """Bytes one launch of the kernel ``name`` moves at the cell's shapes
    (the entry's ``layer_info()``)."""
    return {"fused_join_detect": k16_bytes(
        info["halos"], info["capacity"], info["event_capacity"])}[name]
