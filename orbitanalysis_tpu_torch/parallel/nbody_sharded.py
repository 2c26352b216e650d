"""Multi-device N-body forces over the particle axis (twin of
``orbitanalysis_tpu/parallel/nbody_sharded.py``).

- *targets* are split over a mesh axis: each rank computes the
  accelerations of its own particle block;
- *sources* are all-gathered once an evaluation (O(N) bytes against the
  O(N^2 / D) operations each rank then does), and so are the blocks'
  accelerations, so the force function takes and returns the global
  arrays as the JAX package's does.

The JAX package computes this pair sum in plain ``jnp`` outside any
Pallas kernel (a Gram matrix product for the free case), so the port's
is plain torch: ``torch.matmul`` for the Gram form, which needs full
float32 products on the card (TF32 raises, as in ``models/nbody.py``).
"""

from __future__ import annotations

import torch

from orbitanalysis_tpu_torch.models.nbody import _check_full_f32_matmul
from orbitanalysis_tpu_torch.ops.deposit import mass_vector
from orbitanalysis_tpu_torch.parallel.collectives import all_gather
from orbitanalysis_tpu_torch.parallel.sharding import take_block
from orbitanalysis_tpu_torch.utils.numerics import periodic_displacement


def direct_forces_rect(targets: torch.Tensor, sources: torch.Tensor,
                       src_mass: torch.Tensor, softening: float = 0.05,
                       G: float = 1.0, box_size=None) -> torch.Tensor:
    """Accelerations ``[T, 3]`` of ``targets [T, 3]`` due to ``sources
    [S, 3]`` of mass ``src_mass [S]`` (the rectangular form of
    :func:`~orbitanalysis_tpu_torch.models.nbody.direct_forces`).

    A target that is also a source contributes nothing to itself: the
    displacement is exactly zero and ``d^2`` is clamped."""
    eps2 = softening * softening
    if box_size is None:
        _check_full_f32_matmul(targets)
        sqt = torch.sum(targets * targets, dim=-1)
        sqs = torch.sum(sources * sources, dim=-1)
        gram = torch.matmul(targets, sources.T)
        d2 = torch.clamp(sqt[:, None] + sqs[None, :] - 2.0 * gram,
                         min=0.0) + eps2
        d2 = torch.clamp(d2, min=1e-18)
        w = src_mass[None, :] * torch.rsqrt(d2) / d2
        return G * (torch.matmul(w, sources)
                    - targets * torch.sum(w, dim=1, keepdim=True))
    dx = periodic_displacement(sources[None, :, :] - targets[:, None, :],
                               box_size)
    d2 = torch.clamp(torch.sum(dx * dx, dim=-1) + eps2, min=1e-18)
    w = src_mass[None, :] * torch.rsqrt(d2) / d2
    return G * torch.sum(w[..., None] * dx, dim=1)


def make_sharded_direct_force_fn(mesh, axis: str = "particles"):
    """A ``force_fn(pos, mass, softening=..., G=..., box_size=...)`` that
    runs the pair sum sharded over ``mesh``'s ``axis``, with the JAX
    package's contract: ``pos [N, 3]`` and ``mass [N]`` are the global
    arrays (the same on every rank of the axis, as
    ``simulate_with_tracking`` holds them), this rank computes the
    accelerations of its block ``[rank * N / D, (rank + 1) * N / D)``
    against all ``N`` sources, and the blocks are all-gathered back to
    the global ``[N, 3]``.

    ``force.local(pos_l, mass_l, ...)`` is the block body, for callers
    that keep the particles sharded: it takes this rank's block and
    returns the block's accelerations (the JAX ``shard_map`` body).
    ``N`` must divide by the axis size (pad with zero-mass particles
    otherwise, as for the blocked kernel)."""
    group = mesh.group(axis)
    n_dev = int(mesh.shape[axis])

    def local(pos_l, mass_l, softening=0.05, G=1.0, box_size=None, **_):
        pos_all = all_gather(pos_l, group, axis=0)
        mass_all = all_gather(mass_l, group, axis=0)
        return direct_forces_rect(pos_l, pos_all, mass_all,
                                  softening=softening, G=G,
                                  box_size=box_size)

    def force(pos, mass, softening=0.05, G=1.0, box_size=None, **_):
        n = pos.shape[0]
        if n % n_dev:
            raise ValueError(
                f"particle count {n} not divisible by mesh axis {n_dev}; "
                "pad with zero-mass particles")
        mass = mass_vector(mass, n, pos)
        acc = local(take_block(pos, (axis,), mesh),
                    take_block(mass, (axis,), mesh), softening=softening,
                    G=G, box_size=box_size)
        return all_gather(acc, group, axis=0)

    force.local = local
    return force
