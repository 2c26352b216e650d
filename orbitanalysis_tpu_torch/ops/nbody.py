"""Blocked direct-summation N-body forces (twin of
``orbitanalysis_tpu/ops/pallas_nbody.py`` ``direct_forces_pallas``, K14).

The Gram form of :func:`orbitanalysis_tpu_torch.models.nbody.direct_forces`
holds the ``[N, N]`` pair matrix in device memory (68.7 GB at N =
131,072); this one never does.  :func:`direct_forces_blocked` launches
the CUDA kernel ``direct_forces`` (``csrc/nbody.cu``: four targets a
thread, source tiles in shared memory, sums in registers; below four
blocks an SM the sources split over blocks and the partial sums add in
a fixed order; no atomics) on CUDA tensors, and its plain-torch version
:func:`direct_forces_blocked_torch` only on CPU tensors; nothing falls
back.

Both compute, for each target i, ``G * sum_j m_j d_ij r^-3`` with
``d_ij = x_j - x_i`` (minimum image ``d - box * round(d * (1/box))``
with a box, rounding half to even), ``r^2 = max(|d|^2 + eps^2, 1e-18)``
and ``r^-3`` as ``rsqrt(r^2)`` cubed.  The kernel's reciprocal root is
the card's approximate one (``rsqrtf``'s, within 2 ulp), it contracts
products and sums into FMAs, and each target adds its sources in index
order within a chunk and the chunks in order; the plain version takes
``torch.rsqrt``, rounds each operation and sums in ``torch.sum``'s
order.  So the two agree to float32 rounding and summation error, not
bit for bit (the kernel is the same bits from run to run): the tests
and ``chip_smoke.py`` hold them to the JAX test's ``max |a1 - a2| /
(|a2| + 1e-3) < 1e-3``.  (The JAX kernel computes ``rsqrt(d2) / d2``.)
"""

from __future__ import annotations

import torch

from orbitanalysis_tpu_torch.ops import _cuda

#: Bound on the ``[targets, N]`` pair planes the plain version builds at
#: once (elements).
_PAIR_ELEMS = 1 << 24


def direct_forces_blocked_torch(pos: torch.Tensor, mass: torch.Tensor,
                                softening: float = 0.05, G: float = 1.0,
                                box_size=None) -> torch.Tensor:
    """Plain-torch twin of the blocked kernel: ``pos [N, 3]``, ``mass
    [N]`` -> ``[N, 3]`` float32 accelerations, targets in blocks so that
    no pair plane exceeds :data:`_PAIR_ELEMS` elements."""
    pos = pos.to(torch.float32)
    mass = mass.reshape(-1).to(torch.float32)
    n = pos.shape[0]
    eps2 = float(softening) * float(softening)
    xs, ys, zs = pos[:, 0], pos[:, 1], pos[:, 2]
    block = max(1, _PAIR_ELEMS // max(n, 1))
    out = []
    for t0 in range(0, n, block):
        t = pos[t0:t0 + block]
        d = [s[None, :] - t[:, c, None] for c, s in enumerate((xs, ys, zs))]
        if box_size is not None:
            box, inv_box = float(box_size), 1.0 / float(box_size)
            d = [x - box * torch.round(x * inv_box) for x in d]
        dx, dy, dz = d
        d2 = torch.clamp(dx * dx + dy * dy + dz * dz + eps2, min=1e-18)
        inv = torch.rsqrt(d2)
        w = mass[None, :] * (inv * inv * inv)
        out.append(torch.stack([torch.sum(w * dx, dim=1),
                                torch.sum(w * dy, dim=1),
                                torch.sum(w * dz, dim=1)], dim=-1))
    if not out:
        return pos.new_zeros((0, 3))
    return float(G) * torch.cat(out)


def direct_forces_blocked(pos: torch.Tensor, mass: torch.Tensor,
                          softening: float = 0.05, G: float = 1.0,
                          box_size=None) -> torch.Tensor:
    """Blocked direct-summation accelerations (K14): the CUDA kernel on
    CUDA tensors, :func:`direct_forces_blocked_torch` on CPU tensors.
    ``box_size`` (a scalar) enables the per-pair minimum image."""
    if _cuda.on_cpu(pos, "direct-force"):
        return direct_forces_blocked_torch(pos, mass, softening, G, box_size)
    return _cuda.direct_forces(
        pos.to(torch.float32).contiguous(),
        mass.reshape(-1).to(torch.float32).contiguous(),
        softening, G, box_size)
