"""orbitanalysis_tpu_torch — the orbit tracker on PyTorch and CUDA (twin
of ``orbitanalysis_tpu/__init__.py``, the JAX package it is ported from
and checked against).

Finds pericentre and apocentre passages of N-body particles about
moving halo centres and writes the reference-schema apsis catalogs.
Host data is NumPy; device state is ``torch.Tensor`` on an explicit
device (CUDA by default).  The JAX package's Pallas kernels are
hand-written CUDA kernels (``csrc/*.cu``) built with nvcc at first use;
on CPU tensors every kernel's plain-torch version runs instead.

Public API (the JAX package's surface):

- :func:`track_orbits` — offline multi-snapshot orbit tracking;
- :func:`track_orbits_onthefly` — one snapshot pair a call, for a
  running simulation;
- :class:`Apsides` — collation of the apsis catalogs (on the host, or
  ``collate_apsides(device=...)`` on a torch device);
- :class:`OrbitDecomposition` — one halo's orbit decomposition and its
  plots;
- :func:`get_central_particle_ids`, :func:`get_central_particle_ids_
  device`, :func:`find_main_progenitors` — progenitor linking
  (``progenitors.find_main_progenitors_device`` is the vote's device
  form, not exported here, as in the JAX package);
- :mod:`orbitanalysis_tpu_torch.engine` — the region and Gadget
  callbacks (``RegionExtractor``, ``make_region_callbacks``,
  ``make_gadget_callbacks``) and the sequence drivers;
- :mod:`orbitanalysis_tpu_torch.models` — the N-body integrator with
  on-the-fly detection (``simulate_with_tracking``,
  ``run_tracked_simulation``) and its forces: direct summation (the
  blocked kernel with ``make_direct_force_fn(use_pallas=True)``), PM
  (``models.pm.make_pm_force_fn``, the sorted deposit kernel on CUDA
  tensors), P3M, and the distributed PM and P3M over the ranks of a
  mesh axis (``models.pm_sharded``).  On the CPU pass ``device='cpu'``
  to the state constructors; on the card ``chip_smoke.py`` phases 11-13
  and 15 drive it;
- :mod:`orbitanalysis_tpu_torch.parallel` — the distributed engines,
  one rank of a ``torch.distributed`` world a device: meshes over the
  ranks, ``track_orbits(mesh=...)`` on the halo-sharded engines and
  the hash-sharded particle-pool engine, the sharded sorted, aligned,
  label and hash steps, the sharded direct forces and the multi-process
  helpers (``parallel.multihost``);
- the numerics helpers :func:`hubble_parameter`, :func:`myin1d`,
  :func:`recenter_coordinates`, :func:`vector_norm`.

Every entry point runs on CUDA unless ``device='cpu'`` is passed.  The
card machine has no ``h5py``: pass ``writer=MemoryWriter()``
(``engine/io_hdf5.py``) to the trackers and to ``Apsides`` there.  The
examples are :mod:`orbitanalysis_tpu_torch.examples` (``python -m
orbitanalysis_tpu_torch.examples.<name> [--cpu]``); the flagship step
and the multi-device dry run are in
:mod:`orbitanalysis_tpu_torch.graft_entry`.
"""

__version__ = "0.1.0"

from orbitanalysis_tpu_torch.engine.tracker import track_orbits
from orbitanalysis_tpu_torch.engine.onthefly import (
    track_orbits as track_orbits_onthefly,
)
from orbitanalysis_tpu_torch.postprocessing import Apsides, OrbitDecomposition
from orbitanalysis_tpu_torch.progenitors import (
    find_main_progenitors,
    get_central_particle_ids,
    get_central_particle_ids_device,
)
from orbitanalysis_tpu_torch.utils.numerics import (
    hubble_parameter,
    myin1d,
    recenter_coordinates,
    vector_norm,
)

__all__ = [
    "track_orbits",
    "track_orbits_onthefly",
    "Apsides",
    "OrbitDecomposition",
    "get_central_particle_ids",
    "get_central_particle_ids_device",
    "find_main_progenitors",
    "myin1d",
    "vector_norm",
    "recenter_coordinates",
    "hubble_parameter",
    "__version__",
]
