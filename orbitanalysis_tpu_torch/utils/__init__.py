from orbitanalysis_tpu_torch.utils.padding import (
    INVALID_ID,
    invalid_id_for,
    pack_ragged,
    pack_ragged_to,
    round_up,
    round_up_pow2,
    unpack_mask,
)
from orbitanalysis_tpu_torch.utils.metrics import Metrics, phase_timer, trace
from orbitanalysis_tpu_torch.utils.numerics import (
    hubble_parameter,
    myin1d,
    oct_decode,
    oct_encode,
    periodic_displacement,
    recenter_coordinates,
    vector_norm,
)

__all__ = [
    "INVALID_ID",
    "invalid_id_for",
    "pack_ragged",
    "pack_ragged_to",
    "round_up",
    "round_up_pow2",
    "unpack_mask",
    "Metrics",
    "phase_timer",
    "trace",
    "hubble_parameter",
    "myin1d",
    "oct_decode",
    "oct_encode",
    "periodic_displacement",
    "recenter_coordinates",
    "vector_norm",
]
