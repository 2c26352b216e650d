"""Sharding specs for the tracker state over a mesh (twin of
``orbitanalysis_tpu/parallel/sharding.py``).

The JAX package's rule: the halo axis of every state and batch leaf is
split over the mesh's ``'halos'`` axis, and the particle (capacity)
axis over ``'particles'`` where the mesh has one; everything else is
replicated.  A spec here is a tuple of one entry per dimension, the
mesh axis that splits it or None, as a ``PartitionSpec`` lists them.

In the port a sharded tensor is its block: each rank holds the slice
of the full array that its mesh coordinates select, on its device
(:func:`shard_tree`), and :func:`gather_tree` assembles the full array
on every rank again (the tracker's counterpart of the JAX package's
``_fetch_host``).  Trees are NamedTuples, tuples, lists and dicts of
tensors, NumPy arrays and scalars; None stays None.
"""

from __future__ import annotations

import numpy as np
import torch

from orbitanalysis_tpu_torch.parallel.collectives import all_gather


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``); None is an empty subtree, as in ``jax.tree.map``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def _shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def leaf_spec(shape, axis_names) -> tuple:
    """The spec of one leaf of ``shape`` (JAX's rule): axis 0 on
    ``'halos'``; axis 1 on ``'particles'`` where the mesh has one and
    the axis is longer than 4; an SoA vector leaf ``[3, H, P]`` shifts
    both by one (AoS leaves ``[H, P, 3]`` and ``[H, 3]`` are told apart
    by their trailing 3, even where ``H`` is 3); scalars replicated."""
    ndim = len(shape)
    if ndim == 0:
        return ()
    has_particles = "particles" in axis_names
    if ndim >= 3 and shape[0] == 3 and shape[-1] != 3:
        parts = [None, "halos"] + [None] * (ndim - 2)
        if has_particles and shape[2] > 4:
            parts[2] = "particles"
    else:
        parts = ["halos"] + [None] * (ndim - 1)
        if ndim >= 2 and has_particles and shape[1] > 4:
            parts[1] = "particles"
    return tuple(parts)


def tree_sharding_specs(tree, mesh):
    """A matching tree of specs for a state or batch tree."""
    return tree_map(lambda leaf: leaf_spec(_shape(leaf), mesh.axis_names),
                    tree)


def halo_sharding(mesh):
    """The engine's handle on the mesh (the mesh itself, as in JAX)."""
    return mesh


def take_block(x, spec, mesh):
    """This rank's block of ``x`` under ``spec`` (a view or slice, on
    ``x``'s own device).  Raises where a split axis does not divide by
    its mesh axis."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        length = x.shape[dim]
        if length % n:
            raise ValueError(
                f"axis {dim} of length {length} does not divide over the "
                f"{n} ranks of mesh axis {axis!r}")
        b = length // n
        i = mesh.index(axis)
        index = [slice(None)] * x.ndim
        index[dim] = slice(i * b, (i + 1) * b)
        x = x[tuple(index)]
    return x


def gather_block(x: torch.Tensor, spec, mesh, axes=None) -> torch.Tensor:
    """The full tensor from every rank's block ``x`` under ``spec``: an
    all-gather along each split dimension within its mesh axis's group
    (only the mesh axes in ``axes``, when given)."""
    for dim, axis in enumerate(spec):
        if axis is None or (axes is not None and axis not in axes):
            continue
        x = all_gather(x, mesh.group(axis), axis=dim, tiled=True)
    return x


def _to_device(x, device):
    """A block as a contiguous tensor of its own on ``device`` (a block
    cut from a device tensor is copied, so it holds none of the full
    tensor's memory)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return x.to(device, copy=True, memory_format=torch.contiguous_format)


def shard_tree(tree, mesh, specs=None, put=None):
    """This rank's block of every leaf of a host or device tree, on the
    mesh's device (``put(block)`` moves a block there when given).
    Scalar leaves pass through unchanged."""
    specs = tree_sharding_specs(tree, mesh) if specs is None else specs
    put = put or (lambda x: _to_device(x, mesh.device))

    def one(leaf, spec):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return leaf
        return put(take_block(leaf, spec, mesh))

    return tree_map(one, tree, specs)


def gather_tree(tree, mesh, specs=None, axes=None):
    """The full tensors of a sharded tree on every rank (collective:
    every rank of the mesh calls it at the same point).  ``specs`` are
    the full tree's; by default JAX's rule on the blocks' shapes, which
    is the full shapes' rule wherever each split axis keeps more than 4
    entries a block."""
    specs = tree_sharding_specs(tree, mesh) if specs is None else specs

    def one(leaf, spec):
        if not isinstance(leaf, torch.Tensor) or leaf.dim() == 0:
            return leaf
        return gather_block(leaf, spec, mesh, axes)

    return tree_map(one, tree, specs)


def shard_rows(tree, mesh, axis: str):
    """This rank's block of the leading axis of every array leaf, split
    over ``axis`` (the hash engine's ``[D, ...]`` shard rows)."""
    specs = tree_map(lambda leaf: (axis,) + (None,) * (len(_shape(leaf)) - 1)
                     if _shape(leaf) else (), tree)
    return shard_tree(tree, mesh, specs)

