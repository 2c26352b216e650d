"""The distributed engines (twin of ``orbitanalysis_tpu/parallel/``): one
rank of a ``torch.distributed`` world a device, meshes of named axes
over the ranks, and the halo-, particle- and hash-sharded steps.  See
:mod:`~orbitanalysis_tpu_torch.parallel.mesh` for how a JAX mesh maps
onto a world, and :mod:`~orbitanalysis_tpu_torch.parallel.collectives`
for the transport."""

from orbitanalysis_tpu_torch.parallel.mesh import (
    Mesh,
    make_halo_mesh,
    make_mesh,
)
from orbitanalysis_tpu_torch.parallel.sharding import (
    gather_tree,
    halo_sharding,
    shard_tree,
    tree_sharding_specs,
)
from orbitanalysis_tpu_torch.parallel.nbody_sharded import (
    direct_forces_rect,
    make_sharded_direct_force_fn,
)
from orbitanalysis_tpu_torch.parallel.sorted_sharded import (
    make_sharded_aligned_step,
    make_sharded_sorted_step,
)
from orbitanalysis_tpu_torch.parallel import multihost

__all__ = [
    "Mesh",
    "make_mesh",
    "make_halo_mesh",
    "halo_sharding",
    "shard_tree",
    "gather_tree",
    "tree_sharding_specs",
    "direct_forces_rect",
    "make_sharded_sorted_step",
    "make_sharded_aligned_step",
    "make_sharded_direct_force_fn",
    "multihost",
]
