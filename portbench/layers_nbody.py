"""The yardstick of config 4's kernel reader: the bytes kernel K13
(``deposit_sorted``, ``orbitanalysis_tpu_torch/csrc/deposit.cu``) must
move, as ``chip_smoke.py`` ``_k13_check`` reckons them, and the names
its two launches carry in the profiler's trace."""

from __future__ import annotations

#: K13's kernels in a trace (each entry's words all in the name): the
#: row bounds, then the row walk; ``_cuda.launch_counts`` counts the pair
#: as one launch of ``deposit_sorted``.
K13_KERNELS = (("row_bounds_kernel",), ("deposit_rows_kernel",))


def k13_bytes(particles: int, grid: int) -> int:
    """One K13 call on ``particles`` entries of the sorted stream onto
    the virtual ``(grid + 1)^3`` mesh: each entry's key and four
    fractions read once (4 + 16 B), each virtual cell written once (4
    B)."""
    return 20 * particles + 4 * (grid + 1) ** 3
