"""orbitanalysis_tpu_torch — the orbit tracker on PyTorch and CUDA (twin
of ``orbitanalysis_tpu/__init__.py``, the JAX package it is ported from
and checked against).

Finds pericentre and apocentre passages of N-body particles about
moving halo centres and writes the reference-schema apsis catalogs.
Host data is NumPy; device state is ``torch.Tensor`` on an explicit
device (CUDA by default).  The JAX package's Pallas kernels are
hand-written CUDA kernels (``csrc/*.cu``) built with nvcc at first use;
on CPU tensors every kernel's plain-torch version runs instead.

Public API (the ported part of the JAX package's surface):

- :func:`track_orbits` — offline multi-snapshot orbit tracking;
- :mod:`orbitanalysis_tpu_torch.models` — the N-body integrator with
  on-the-fly detection (``simulate_with_tracking``,
  ``run_tracked_simulation``) and its forces: direct summation (the
  blocked kernel with ``make_direct_force_fn(use_pallas=True)``), PM
  (``models.pm.make_pm_force_fn``, the sorted deposit kernel on CUDA
  tensors) and P3M.  On the CPU pass ``device='cpu'`` to the state
  constructors; on the card ``chip_smoke.py`` phases 11-13 drive it;
- the numerics helpers :func:`hubble_parameter`, :func:`myin1d`,
  :func:`recenter_coordinates`, :func:`vector_norm`.

``Apsides``/``OrbitDecomposition``, the file-pair on-the-fly driver, the
distributed engines and the progenitor tools are not ported yet
(ROADMAP.md).
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
