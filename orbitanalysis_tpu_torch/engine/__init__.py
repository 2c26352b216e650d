from orbitanalysis_tpu_torch.engine.tracker import track_orbits  # noqa: F401
from orbitanalysis_tpu_torch.engine.scan import (  # noqa: F401
    CountingCarry,
    scan_counts,
    scan_events,
    scan_events_compact,
    stack_batches,
)

__all__ = [
    "track_orbits",
    "CountingCarry",
    "scan_counts",
    "scan_events",
    "scan_events_compact",
    "stack_batches",
]
