"""Region-frame transform, the per-particle geometry of every step (twin
of ``orbitanalysis_tpu/ops/geometry.py:42`` ``region_frame``).

Operates on the whole padded ``[n_halos, capacity]`` batch at once:
periodic wrap, masked bulk-velocity reduction, Hubble term, radii, unit
vectors and radial velocities.  Coordinates arrive as ``[H, P, 3]`` and
are viewed as structure-of-arrays ``[3, H, P]`` planes, the layout the
carried unit vectors keep.  The arithmetic follows the JAX twin
operation for operation.  Every division and square root goes through
:func:`~orbitanalysis_tpu_torch.utils.numerics.div_rn` /
:func:`~orbitanalysis_tpu_torch.utils.numerics.sqrt_rn`, the IEEE float32
results on every backend (torch's own float32 ``sqrt`` on CUDA is not),
so radii and unit vectors are the same bits on the card and on the CPU.
Only the bulk-velocity sum may reduce in another order (about one f32
ulp); it feeds ``vrad`` and ``bulk_vel``, never ``rhat``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from orbitanalysis_tpu_torch.utils.numerics import div_rn, sqrt_rn

_EPS = 1e-30


class RegionFrame(NamedTuple):
    """Per-particle quantities in each halo's rest frame."""

    radius: torch.Tensor    # [H, P]    distance from halo center
    rhat: torch.Tensor      # [3, H, P] radial unit vector (SoA layout)
    vrad: torch.Tensor      # [H, P]    radial velocity (frame-corrected)
    bulk_vel: torch.Tensor  # [H, 3]    bulk velocity used for each region


def box_f32(box_size):
    """The periodic box as :func:`region_frame` applies it: ``box_size``
    rounded to float32, one float for a scalar box, a tuple of floats for
    a per-axis one."""
    box = np.asarray(box_size, dtype=np.float32)
    if box.ndim == 1:
        return tuple(float(b) for b in box)
    return float(box)


def region_frame(
    pos: torch.Tensor,            # [H, P, 3] (or [3, H, P] with soa=True)
    vel: torch.Tensor,            # [H, P, 3] (or [3, H, P] with soa=True)
    valid: torch.Tensor,          # [H, P] bool
    center: torch.Tensor,         # [H, 3]
    mass: Optional[torch.Tensor] = None,      # [H, P] or None (equal-mass)
    bulk_vel: Optional[torch.Tensor] = None,  # [H, 3] catalog values
    box_size=None,                # scalar / (3,) / None (non-periodic)
    hubble_drag=0.0,              # H(z)/(1+z), scalar or [H, 1]; 0 = off
    soa: bool = False,            # inputs already [3, H, P]
) -> RegionFrame:
    """Transform particles into halo rest frames and compute v_r.

    - coordinates are recentered on ``center`` with a minimum-image wrap
      when ``box_size`` is given;
    - the bulk velocity is the catalog value if supplied, else the
      mass-weighted mean when ``mass`` is given, else the plain mean,
      as masked reductions over the padded particle axis;
    - physical velocity adds the Hubble-flow term ``hubble_drag * r``
      (``hubble_drag`` a scalar, or an ``[H, 1]`` tensor of one value a
      row, as the batched aligned driver passes it);
    - radii are clamped away from zero before the division, so a
      particle exactly at the center gets ``rhat = 0`` instead of NaN.
    """
    dt = pos.dtype
    w = valid.to(dt)
    if soa:
        pos3, vel3 = pos, vel
    else:
        pos3 = torch.movedim(pos, -1, 0)    # [3, H, P]
        vel3 = torch.movedim(vel, -1, 0)
    rel = pos3 - center.T[:, :, None]
    if box_size is not None:
        # the box as a tensor on the data's device, filled there (no
        # host->device copy)
        box = box_f32(box_size)
        if isinstance(box, tuple):
            # per-dimension box against the leading component axis
            box = torch.stack([rel.new_full((), b) for b in box])
            box = box[:, None, None]
        else:
            box = rel.new_full((), box)
        rel = rel - box * torch.round(div_rn(rel, box))
    # zero out padding so garbage slots cannot feed inf/nan into sums
    rel = rel * w[None]

    if bulk_vel is None:
        wm = w * mass if mass is not None else w
        denom = torch.clamp(torch.sum(wm, dim=-1), min=_EPS)     # [H]
        bulk3 = torch.sum(wm[None] * vel3, dim=-1) / denom[None]  # [3, H]
    else:
        bulk3 = bulk_vel.T
    bulk3 = bulk3.to(vel.dtype)

    if isinstance(hubble_drag, torch.Tensor):
        hd = hubble_drag.to(rel.dtype)  # a value a row, [H, 1]
    else:
        hd = float(np.float32(hubble_drag))
    vrel = vel3 - bulk3[:, :, None] + hd * rel

    r2 = rel[0] * rel[0] + rel[1] * rel[1] + rel[2] * rel[2]
    radius = sqrt_rn(r2)
    inv_r = torch.where(radius > 0,
                        div_rn(1.0, torch.clamp(radius, min=_EPS)),
                        torch.zeros_like(radius))
    rhat = rel * inv_r[None]
    vrad = (vrel[0] * rhat[0] + vrel[1] * rhat[1] + vrel[2] * rhat[2]) * w

    return RegionFrame(radius=radius, rhat=rhat, vrad=vrad,
                       bulk_vel=bulk3.T)
