"""Models of the port (twin of ``orbitanalysis_tpu/models``): the N-body
integrator with on-the-fly orbit detection and its force solvers, and
the synthetic data generators.

- :mod:`~orbitanalysis_tpu_torch.models.nbody`:
  :func:`simulate_with_tracking` (a KDK loop with the static apsis
  detector every ``detect_every`` steps; ``mode='both'``;
  ``track``/``step_offset`` resume), :func:`run_tracked_simulation`
  (``torch.save`` checkpoints, ``resume=True``), the forces
  :func:`direct_forces` (Gram form, full float32: it raises on CUDA
  tensors under TF32), :func:`make_direct_force_fn` (``use_pallas=True``
  is the blocked CUDA kernel K14) and :func:`point_mass_forces`, and the
  JAX state carried across (``nbody_state_from_numpy``,
  ``track_state_from_numpy`` and their ``_to_numpy`` inverses);
- :mod:`~orbitanalysis_tpu_torch.models.pm`: :func:`make_pm_force_fn`
  (``deposit='auto'``: the sorted-stream CUDA kernel K13 on CUDA
  tensors, in a fixed order, ``index_add_`` on CPU ones), :func:`pm_forces`;
- :mod:`~orbitanalysis_tpu_torch.models.p3m`: :func:`make_p3m_force_fn`
  (its long range deposits as ``deposit='auto'`` does);
- :mod:`~orbitanalysis_tpu_torch.models.pm_sharded`: the distributed PM
  over one mesh axis of a ``torch.distributed`` world,
  :func:`make_sharded_pm_grid_solver`, :func:`make_sharded_pm_force_fn`
  (deposits as ``deposit='auto'`` does) and
  ``make_slab_resident_pm_force_fn`` (slab-resident PM and P3M; the slab
  deposit through K13 on CUDA tensors): on the card every default
  deposit adds in a fixed order, so a call gives the same bits twice;
- :mod:`~orbitanalysis_tpu_torch.models.synthetic`: Kepler ensembles,
  churn snapshots and the JAX benchmark's workloads.

On the CPU pass ``device='cpu'`` to the state constructors (they default
to CUDA and raise without it); the CPU tests are
``tests/test_torch_nbody.py``, ``tests/test_torch_pm.py`` and
``tests/test_torch_pm_sharded.py``.
"""

from orbitanalysis_tpu_torch.models import (  # noqa: F401
    nbody,
    p3m,
    pm,
    pm_sharded,
    synthetic,
)
from orbitanalysis_tpu_torch.models.nbody import (  # noqa: F401
    NBodyState,
    OrbitNBodyConfig,
    TrackState,
    direct_forces,
    kdk_step,
    make_direct_force_fn,
    nbody_state_from_numpy,
    nbody_state_to_numpy,
    point_mass_forces,
    run_tracked_simulation,
    simulate_with_tracking,
    track_state_from_numpy,
    track_state_to_numpy,
)
from orbitanalysis_tpu_torch.models.p3m import make_p3m_force_fn  # noqa: F401
from orbitanalysis_tpu_torch.models.pm import (  # noqa: F401
    make_pm_force_fn,
    pm_forces,
)
from orbitanalysis_tpu_torch.models.pm_sharded import (  # noqa: F401
    make_sharded_pm_force_fn,
    make_sharded_pm_grid_solver,
)

__all__ = [
    "nbody",
    "pm",
    "p3m",
    "pm_sharded",
    "synthetic",
    "NBodyState",
    "OrbitNBodyConfig",
    "TrackState",
    "direct_forces",
    "kdk_step",
    "make_direct_force_fn",
    "nbody_state_from_numpy",
    "nbody_state_to_numpy",
    "point_mass_forces",
    "run_tracked_simulation",
    "simulate_with_tracking",
    "track_state_from_numpy",
    "track_state_to_numpy",
    "make_p3m_force_fn",
    "make_pm_force_fn",
    "pm_forces",
    "make_sharded_pm_grid_solver",
    "make_sharded_pm_force_fn",
]
