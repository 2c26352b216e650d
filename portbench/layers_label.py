"""The yardstick of the label cell's kernel reader: the bytes each kernel
of the label-native step (``ops/label_step``) must move a launch at the
cell's shapes, as ``chip_smoke.py`` reckons them (K6 ``:1061``, K7
``:1092``, K8 and K9 ``:1149-1150``, K10 ``:1181``, K4 ``:398``) with
masses and float32 radial unit vectors, the cell's form: each input
byte read once and each output byte written once.  And the names the
kernels carry in the profiler's trace."""

from __future__ import annotations

#: The step's kernels: ``ops/_cuda.launch_counts`` name -> the words of
#: its kernels' names in a trace (K7 is two kernels a launch; K9 and K10
#: are two forms of one template).
KERNELS = {
    "segment_moments": (("segment_moments_partial_kernel",),
                        ("segment_moments_final_kernel",)),
    "frame_rows": (("frame_rows_kernel",),),
    "detect_label_compact_rows": (("detect_label_compact_kernel",),),
    "detect_label_rows": (("detect_label_kernel",),),
    "fused_label_rows": (("detect_label_kernel",),),
    "compact_payload_rows": (("compact_tiles_kernel", "PayloadWords"),),
}
TRACE_NAMES = tuple(sorted({w for ws in KERNELS.values() for w in ws}))


def detect_bytes(rhat_packed: bool = False) -> int:
    """Bytes a particle of the detect chain: frame rows 24, label 4,
    position 12, velocity 12, ``lab_sv`` 4 and packed angle 4 read;
    ``lab_sv`` and packed angle written; the r-hat carry read and
    written (12 B float32, 4 B octahedral)."""
    return 68 + 2 * (4 if rhat_packed else 12)


def k7_bytes(n: int, halos: int) -> int:
    """``segment_moments``: label 4, velocity 12, mass 4 read a particle;
    the ``[H, 4]`` float32 moments written."""
    return 20 * n + 16 * halos


def k6_bytes(n: int, halos: int) -> int:
    """``frame_rows``: label 4 read, the ``[6, N]`` rows written (24) a
    particle; the ``[H, 6]`` table read."""
    return 28 * n + 24 * halos


def k8_bytes(n: int, rows: int, k128: int) -> int:
    """``detect_label_compact_rows``: the chain, the ``[R, k128]`` event
    words and the ``[R]`` counts written."""
    return n * detect_bytes() + rows * k128 * 4 + rows * 4


def k9_bytes(n: int, rows: int) -> int:
    """``detect_label_rows``: the chain, the ``[R, W]`` payload plane and
    the counts written."""
    return n * (detect_bytes() + 4) + rows * 4


def k10_bytes(n: int, rows: int, halos: int) -> int:
    """``fused_label_rows``: K9 with the frame rows taken from the ``[H,
    6]`` table instead of the rows plane."""
    return n * (detect_bytes() - 20) + rows * 4 + halos * 24


def k4_bytes(rows: int, length: int, k128: int) -> int:
    """``compact_payload_rows``: the ``[R, W]`` payload read, the ``[R,
    k128]`` event words written."""
    return rows * length * 4 + rows * k128 * 4


def launch_bytes(name: str, info: dict) -> int:
    """Bytes one launch of the kernel ``name`` moves at the cell's shapes
    (the entry's ``layer_info()``)."""
    n, h = info["particles"], info["halos"]
    r, w = info["rows"], info["row_width"]
    k128 = min(-(-info["event_capacity"] // 128) * 128, w)
    return {
        "segment_moments": k7_bytes(n, h),
        "frame_rows": k6_bytes(n, h),
        "detect_label_compact_rows": k8_bytes(n, r, k128),
        "detect_label_rows": k9_bytes(n, r),
        "fused_label_rows": k10_bytes(n, r, h),
        "compact_payload_rows": k4_bytes(r, w, k128),
    }[name]
