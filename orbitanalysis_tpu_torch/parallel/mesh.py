"""Device meshes over a ``torch.distributed`` world (twin of
``orbitanalysis_tpu/parallel/mesh.py``).

A JAX ``Mesh`` arranges the devices of one process in named axes and
``shard_map`` runs one program on all of them.  Here one rank of the
world is one device, and a :class:`Mesh` arranges the ranks: a
``torch.distributed.device_mesh.DeviceMesh`` under the same axis names,
this rank's coordinate on each axis, the process group of each axis
(the collectives of :mod:`~orbitanalysis_tpu_torch.parallel.collectives`
run on it) and this rank's device.  The axes the engines read:

- ``('halos',)`` — per-halo data parallelism: each rank holds a block of
  whole halo rows and the step runs with no collective;
- ``('halos', 'particles')`` — the general engine also splits each row's
  particle axis; a step gathers the rows within the ``'particles'``
  group, as XLA inserts the same all-gathers for the JAX mesh;
- ``('shards',)`` — the hash-sharded particle-pool engine
  (:mod:`~orbitanalysis_tpu_torch.parallel.hash_sharded`).

Without a process group the world is this one process: a mesh of size
one, whose collectives are the identity.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from orbitanalysis_tpu_torch.parallel.collectives import group_size
from orbitanalysis_tpu_torch.utils.device import resolve_device


class Mesh:
    """Named axes over the ranks of the world, one rank a device.

    ``axis_names`` and ``shape`` (``{name: size}``) read as a JAX mesh's
    do; :meth:`group` and :meth:`index` give an axis's process group and
    this rank's coordinate on it; ``device`` is this rank's device.
    """

    def __init__(self, axis_shapes: dict, device: torch.device,
                 device_mesh=None):
        self.axis_names = tuple(axis_shapes)
        self.shape = {k: int(v) for k, v in axis_shapes.items()}
        self.device = device
        self.device_mesh = device_mesh

    def group(self, axis: str):
        """The process group of ``axis`` (None in a world of one)."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no {axis!r} axis: {self.axis_names}")
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no {axis!r} axis: {self.axis_names}")
        if self.device_mesh is None:
            return 0
        return int(self.device_mesh.get_local_rank(axis))


def _rank_device(device) -> torch.device:
    """This rank's device of ``device``'s type: for CUDA, the device of
    the rank's local index modulo the device count (raises without
    CUDA)."""
    device = resolve_device(device, "make_mesh")
    if device.type != "cuda" or device.index is not None:
        return device
    from orbitanalysis_tpu_torch.parallel.multihost import local_rank

    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def make_mesh(axis_shapes: Optional[dict] = None, device="cuda") -> Mesh:
    """A mesh of ``{axis_name: size}`` over the ranks of the world
    (default: one axis ``'halos'`` over all of them), on this rank's
    device of ``device``'s type (CUDA unless ``device='cpu'``).

    The mesh spans the world: a shape whose size differs from the
    world's raises ValueError, as a JAX mesh larger than its devices
    does.
    """
    world = group_size()
    if axis_shapes is None:
        axis_shapes = {"halos": world}
    need = int(np.prod(list(axis_shapes.values()), dtype=np.int64))
    if need != world:
        raise ValueError(
            f"mesh shape {tuple(axis_shapes.values())} needs {need} ranks, "
            f"the world has {world} (one rank a device)")
    device = _rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    device_mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh

        device_mesh = init_device_mesh(
            device.type, tuple(int(v) for v in axis_shapes.values()),
            mesh_dim_names=tuple(axis_shapes))
    return Mesh(axis_shapes, device, device_mesh)


def make_halo_mesh(n_devices: Optional[int] = None, device="cuda") -> Mesh:
    """1-D halo-parallel mesh over the world (the common case);
    ``n_devices`` must equal the world's size when given."""
    n = group_size() if n_devices is None else int(n_devices)
    return make_mesh({"halos": n}, device=device)
