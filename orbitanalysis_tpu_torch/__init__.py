"""orbitanalysis_tpu_torch — the orbit tracker on PyTorch and CUDA (twin
of ``orbitanalysis_tpu/__init__.py``, the JAX package it is ported from
and checked against).

Finds pericentre and apocentre passages of N-body particles about
moving halo centres and writes the reference-schema apsis catalogs.
Host data is NumPy; device state is ``torch.Tensor`` on an explicit
device (CUDA by default).  The aligned engine's event compaction is a
hand-written CUDA kernel (``csrc/compact.cu``) built with nvcc at first
use.

Public API (the ported part of the JAX package's surface):

- :func:`track_orbits` — offline multi-snapshot orbit tracking;
- the numerics helpers :func:`hubble_parameter`, :func:`myin1d`,
  :func:`recenter_coordinates`, :func:`vector_norm`.

``Apsides``/``OrbitDecomposition``, the on-the-fly driver and the
progenitor tools are not ported yet (ROADMAP.md).
"""

__version__ = "0.1.0"

from orbitanalysis_tpu_torch.engine.tracker import track_orbits
from orbitanalysis_tpu_torch.utils.numerics import (
    hubble_parameter,
    myin1d,
    recenter_coordinates,
    vector_norm,
)

__all__ = [
    "track_orbits",
    "myin1d",
    "vector_norm",
    "recenter_coordinates",
    "hubble_parameter",
    "__version__",
]
