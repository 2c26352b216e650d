"""The yardstick of the per-layer readers: the card's published peaks,
the bytes each measured kernel and step must move, and the readings
taken from a traced window (``harness.Trace``).

The byte counts are those of ``chip_smoke.py`` (``bound``,
``chip_smoke.py:251``; K1 ``:393``), frozen here:
each input byte read once and each output byte written once.
"""

from __future__ import annotations

#: H100 SXM, NVIDIA's data sheet (``chip_smoke.py:228``): HBM bytes a
#: second.  Every roofline here is bound by bytes.
PEAK_BYTES = 3.35e12

#: The kernels a roofline divides by: a device operation is one of them
#: when its name holds every word of one entry (the port's kernels live
#: in an anonymous namespace, which the profiler's names spell out).
K1_KERNELS = (("compact_tiles_kernel", "AngleWords"),)


def k1_bytes(rows: int, length: int, event_capacity: int) -> int:
    """``compact_angle_rows`` on ``[rows, length]`` angle words: the
    plane read once, the ``[rows, K128]`` lists written once (``K128``
    the capacity rounded up to 128 lanes, at most the row)."""
    k128 = min(-(-event_capacity // 128) * 128, length)
    return rows * length * 4 + rows * k128 * 4


#: Bytes a slot of the aligned step must move: the staged planes read
#: (ID, position, velocity, mass, load slot: 4 + 12 + 12 + 4 + 4), the
#: carry read and written (key, slot and sign, r-hat, angle: 4 + 4 + 12
#: + 4, twice).
ALIGNED_SLOT_BYTES = 36 + 2 * 24
#: Bytes an event of the aligned step writes (position, f16 angle).
ALIGNED_EVENT_BYTES = 6


def aligned_step_bytes(rows: int, length: int, events: float) -> float:
    return rows * length * ALIGNED_SLOT_BYTES + events * ALIGNED_EVENT_BYTES


def kernel_seconds(trace, kernels) -> float:
    """Device seconds of the operations that are one of ``kernels``."""
    return sum(s for op, s in trace.device_ops.items()
               if any(all(w in op for w in words) for words in kernels))


def launches(trace, kernel: str) -> int:
    """Launches of a port kernel (``ops/_cuda.launch_counts``) over the
    traced calls."""
    return sum(c.get("launches", {}).get(kernel, 0) for c in trace.calls)


def roofline(n_bytes: float, seconds: float):
    """Percent of the card's HBM peak: None where nothing ran."""
    if seconds <= 0 or n_bytes <= 0:
        return None
    return 100.0 * n_bytes / PEAK_BYTES / seconds


def idle_share(trace):
    """Percent of the window with no device operation running: the
    traced calls' busy seconds over the same calls' window without the
    profiler (whose host overhead would lengthen it)."""
    if trace.plain_window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s / trace.plain_window_s)
