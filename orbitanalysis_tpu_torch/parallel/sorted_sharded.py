"""Halo-sharded sorted and aligned steps (twin of
``orbitanalysis_tpu/parallel/sorted_sharded.py``).

Every halo row is independent, so a mesh over the halo axis runs the
single-device step on each rank's block of rows with no collective: the
sorted step's join-and-detect kernel (K16, or K18 on a static step) and
the aligned step's angle compaction (K1/K2, or K3 on rows past
``PAYLOAD_MAX_ROW``) launch on every rank as they do on one device.  The
JAX package wraps its steps in a halo-axis ``shard_map`` because a
``pallas_call`` is opaque to the SPMD partitioner; here the rank's own
block is the step's input (:func:`~orbitanalysis_tpu_torch.parallel.
sharding.shard_tree`), and the step is the single-device one.

The kernels need whole rows on one device: a ``'particles'`` axis is
refused, and the halo count must divide by the ``'halos'`` axis.
"""

from __future__ import annotations

from orbitanalysis_tpu_torch.ops.sorted_step import (
    make_aligned_native_step,
    make_sorted_orbit_step,
)


def check_halo_mesh(mesh):
    """Raise unless ``mesh`` splits the halo axis only."""
    if "halos" not in mesh.axis_names:
        raise ValueError("mesh needs a 'halos' axis")
    if "particles" in mesh.axis_names:
        raise ValueError(
            "the fused kernels need whole rows per device; "
            "shard the halo axis only"
        )


def _shard_step(step, mesh):
    """The single-device ``step``, run by each rank on its rows."""
    check_halo_mesh(mesh)
    return step


def make_sharded_sorted_step(mesh, event_capacity: int, **kwargs):
    """Build a halo-sharded ``step(carry, batch) -> (carry, events)`` on
    this rank's block of rows (:func:`~orbitanalysis_tpu_torch.parallel.
    sharding.shard_tree` of the full carry and batch).

    ``mesh`` must have a ``'halos'`` axis and no ``'particles'`` axis;
    the halo count must divide by the axis size (the blocks are cut by
    ``shard_tree``, which raises where it does not).  Remaining kwargs go
    to :func:`~orbitanalysis_tpu_torch.ops.sorted_step.
    make_sorted_orbit_step`.
    """
    return _shard_step(make_sorted_orbit_step(event_capacity, **kwargs), mesh)


def make_sharded_aligned_step(mesh, event_capacity: int, **kwargs):
    """Halo-sharded stable-layout aligned step (the mesh contract of
    :func:`make_sharded_sorted_step`; kwargs go to
    :func:`~orbitanalysis_tpu_torch.ops.sorted_step.
    make_aligned_native_step`, the carry is an ``AlignedCarry``)."""
    return _shard_step(
        make_aligned_native_step(event_capacity, **kwargs), mesh)
