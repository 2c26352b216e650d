"""Particle-sharded label-native detection (twin of
``orbitanalysis_tpu/parallel/label_sharded.py``).

The label detector (:mod:`~orbitanalysis_tpu_torch.ops.label_step`) is
elementwise over the particle pool except for the per-halo frame
moments, so the multi-device form splits the pool: each rank detects
over its block, and the one collective a step is the sum of the tiny
``[H, 4]`` bulk-velocity moments.  The centres ``[H, 3]`` are
replicated.

A step on a rank: the local mass-weighted moments through
:func:`~orbitanalysis_tpu_torch.ops.frames.segment_moments` (K7's CUDA
kernel on the card, its plain version on the CPU), one all-reduce, then
the single-device step on the block given those bulk velocities (on the
card under ``frames='auto'``: K6's frame rows and K8's detect and
compaction).  Event indices come back global, the rank's offset in the
pool plus the local index, so consumers never see block coordinates.

``frames`` picks the JAX package's moment implementation (``'auto'``,
``'pallas'``, ``'twolevel'``, ``'matmul'``, ...); the port computes the
same segment sums for all of them, in float64 rounded once a rank, so
only the order of the moments' summation differs.  The local step runs
the route ``frames`` names.
"""

from __future__ import annotations

import torch

from orbitanalysis_tpu_torch.ops.frames import segment_moments
from orbitanalysis_tpu_torch.ops.label_step import (
    LabelCarry,
    make_label_orbit_step,
)
from orbitanalysis_tpu_torch.parallel.collectives import psum
from orbitanalysis_tpu_torch.parallel.sharding import shard_tree
from orbitanalysis_tpu_torch.utils.numerics import div_rn

__all__ = ["make_sharded_label_step", "shard_label_tree"]


def shard_label_tree(mesh, carry: LabelCarry) -> LabelCarry:
    """This rank's block of a :class:`LabelCarry`: its ``[R, W]`` row
    planes split on rows over the mesh's ``'particles'`` axis (rows are
    contiguous particle blocks, so row-sharding is particle-sharding;
    ``R`` must be a multiple of the axis size), on the mesh's device."""
    specs = LabelCarry(
        lab_sv=("particles", None),
        rhat=(("particles", None) if carry.rhat.dim() == 2
              else (None, "particles", None)),
        packed=("particles", None),
    )
    return shard_tree(carry, mesh, specs)


def make_sharded_label_step(mesh, event_capacity: int, n_halos: int,
                            mode: str = "pericentric", box_size=None,
                            row_width: int = 1 << 15, frames: str = "auto"):
    """Particle-sharded label step: ``step(carry, (pos [3, n], vel, label
    [n], centers [H, 3], mass [n] or None, hubble_drag))`` on this rank's
    block of ``n`` pool entries (rank ``i`` of the ``'particles'`` axis
    holds entries ``[i n, (i + 1) n)``).  Returns ``(step, n_shards)``.

    The one collective is the sum of the ``[H, 4]`` mass-weighted
    velocity moments (the reference's bulk velocities,
    ``track_orbits.py:267-284``); event indices are global pool indices.
    """
    if "particles" not in mesh.axis_names:
        raise ValueError("mesh needs a 'particles' axis")
    n_shards = int(mesh.shape["particles"])
    group = mesh.group("particles")
    shard = mesh.index("particles")
    h = int(n_halos)
    local = make_label_orbit_step(
        event_capacity, mode=mode, box_size=box_size, n_halos=h,
        row_width=row_width, frames=frames,
    )

    def step(carry: LabelCarry, inputs):
        pos, vel, label, centers, mass, drag = inputs
        lab_m = torch.where(label >= 0, label,
                            torch.full((), -1, dtype=label.dtype,
                                       device=label.device)).to(torch.int32)
        mom = psum(segment_moments(lab_m, vel, mass, n_halos=h), group)
        bulk = div_rn(mom[:, :3], torch.clamp(mom[:, 3:4], min=1e-30))
        new_carry, ev = local(carry, (pos, vel, label, centers, bulk, mass,
                                      drag))
        n_local = label.numel()
        index = torch.where(ev.index >= 0, ev.index + shard * n_local,
                            ev.index)
        return new_carry, ev._replace(index=index, bulk_vel=bulk)

    return step, n_shards
