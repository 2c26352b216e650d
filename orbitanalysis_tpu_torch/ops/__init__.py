from orbitanalysis_tpu_torch.ops.geometry import RegionFrame, region_frame
from orbitanalysis_tpu_torch.ops.join import (
    MergeJoin,
    SortedRows,
    TwoWayMatch,
    gather_rows,
    match_ids,
    merge_join,
    sort_rows,
    two_way_match,
)
from orbitanalysis_tpu_torch.ops.apsis import (
    Carry,
    SnapshotBatch,
    StepEvents,
    carry_from_numpy,
    carry_to_numpy,
    init_carry,
    make_orbit_step,
    make_static_orbit_step,
    orbit_step,
)

__all__ = [
    "RegionFrame",
    "region_frame",
    "MergeJoin",
    "SortedRows",
    "TwoWayMatch",
    "gather_rows",
    "match_ids",
    "merge_join",
    "sort_rows",
    "two_way_match",
    "Carry",
    "SnapshotBatch",
    "StepEvents",
    "carry_from_numpy",
    "carry_to_numpy",
    "init_carry",
    "make_orbit_step",
    "make_static_orbit_step",
    "orbit_step",
]
