from orbitanalysis_tpu_torch.engine.tracker import track_orbits  # noqa: F401
from orbitanalysis_tpu_torch.engine.gadget import (  # noqa: F401
    make_gadget_callbacks,
)
from orbitanalysis_tpu_torch.engine.regions import (  # noqa: F401
    RegionExtractor,
    make_region_callbacks,
)
from orbitanalysis_tpu_torch.engine.scan import (  # noqa: F401
    CountingCarry,
    scan_counts,
    scan_events,
    scan_events_compact,
    stack_batches,
)

__all__ = [
    "track_orbits",
    "RegionExtractor",
    "make_gadget_callbacks",
    "make_region_callbacks",
    "CountingCarry",
    "scan_counts",
    "scan_events",
    "scan_events_compact",
    "stack_batches",
]
