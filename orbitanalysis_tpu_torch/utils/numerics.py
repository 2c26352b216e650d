"""Small numeric utilities shared by host and device code (twin of
``orbitanalysis_tpu/utils/numerics.py``).

The tensor functions take ``torch.Tensor`` on any device and never
mutate their inputs; the host helpers take NumPy arrays.  Packed
32-bit words are carried as ``int32`` tensors holding the uint32 bit
pattern, because torch has no arithmetic on ``uint32``.
"""

from __future__ import annotations

import numpy as np
import torch


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a NumPy dtype (or of anything ``np.dtype``
    accepts); torch dtypes pass through."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in ``[0, 2**32)`` -> int32 tensor with the same low
    32 bits (the uint32 bit pattern)."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on every backend: the
    float64 root rounded once more to float32 is the IEEE float32 root
    (double rounding is innocuous at 53 >= 2 * 24 + 2 bits).  torch's
    own float32 ``sqrt`` on CUDA differs from it in the last bit for
    some inputs; the hand-written kernels use the IEEE one."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def div_rn(a, b: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 quotient ``a / b`` on every backend
    (float64 quotient, rounded once more: innocuous as in
    :func:`sqrt_rn`), whatever torch does for a float32 division by a
    scalar or a reciprocal.  ``a`` may be a Python float."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    return (a.to(torch.float64) / b.to(torch.float64)).to(torch.float32)


def box_tensor(box_size, like: torch.Tensor) -> torch.Tensor:
    """``box_size`` (a scalar or a length-3 vector) as a tensor of
    ``like``'s dtype on its device.  A number is filled there, not copied
    from the host: a copy from pageable host memory waits for the
    device's stream."""
    if isinstance(box_size, torch.Tensor):
        return box_size.to(device=like.device, dtype=like.dtype)
    box = np.asarray(box_size, np.float64)
    if box.ndim == 0:
        return like.new_full((), float(box))
    return torch.stack([like.new_full((), float(b)) for b in box])


def periodic_displacement(dx: torch.Tensor, box_size) -> torch.Tensor:
    """Minimum-image displacement: each component of ``dx`` mapped into
    ``[-L/2, L/2]``, the quotient the IEEE one (:func:`div_rn`).
    ``box_size`` is a scalar or a length-3 vector broadcast against the
    trailing axis."""
    box = box_tensor(box_size, dx)
    return dx - box * torch.round(div_rn(dx, box))


def recenter_coordinates(position: torch.Tensor, box_size) -> torch.Tensor:
    """Reference-compatible alias: wrap ``position`` into ``[-L/2, L/2]``."""
    return periodic_displacement(position, box_size)


def vector_norm(vectors: torch.Tensor, return_norm=True,
                return_unit_vectors=False):
    """Row-wise Euclidean norms and/or unit vectors."""
    vmags = torch.sqrt(torch.sum(vectors * vectors, dim=-1))
    if return_norm and return_unit_vectors:
        return vmags, vectors / vmags[..., None]
    if return_norm:
        return vmags
    if return_unit_vectors:
        return vectors / vmags[..., None]
    raise ValueError("must request the norm and/or the unit vectors")


def hubble_parameter(z, H0, Omega_m, Omega_L, Omega_k=0.0):
    """H(z) for a flat-or-curved FLRW cosmology (host-side float64)."""
    zp1 = 1.0 + np.asarray(z, dtype=np.float64)
    return H0 * np.sqrt(Omega_m * zp1**3 + Omega_k * zp1**2 + Omega_L)


def myin1d(a, b, kind=None):
    """Indices into ``a`` of the values of ``b``, in ``b``'s order (the
    reference's join helper, for user analysis scripts).  Every value of
    ``b`` must be present in ``a``, without duplicates.  Host NumPy."""
    a = np.asarray(a)
    b = np.asarray(b)
    sorter = np.argsort(a, kind="stable")
    return sorter[np.searchsorted(a, b, sorter=sorter)]


def oct_encode(rhat: torch.Tensor) -> torch.Tensor:
    """Octahedral unit-vector compression: ``[3, ...]`` f32 -> ``[...]``
    int32 holding the uint32 word ``qx | qy << 16`` (16 bits per
    octahedral coordinate).  Zero vectors encode to the +z pole."""
    x, y, z = rhat[0], rhat[1], rhat[2]
    s = torch.clamp(x.abs() + y.abs() + z.abs(), min=1e-30)
    px, py = div_rn(x, s), div_rn(y, s)
    one = torch.ones_like(px)
    fx = (1.0 - py.abs()) * torch.where(px >= 0, one, -one)
    fy = (1.0 - px.abs()) * torch.where(py >= 0, one, -one)
    px = torch.where(z < 0, fx, px)
    py = torch.where(z < 0, fy, py)
    qx = torch.clamp(torch.round((px * 0.5 + 0.5) * 65535.0), 0, 65535)
    qy = torch.clamp(torch.round((py * 0.5 + 0.5) * 65535.0), 0, 65535)
    return to_i32_bits(qx.to(torch.int64) | (qy.to(torch.int64) << 16))


def oct_decode(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`oct_encode`: int32 words -> normalized
    ``[3, ...]`` f32."""
    qx = (packed & 0xFFFF).to(torch.float32)
    qy = ((packed >> 16) & 0xFFFF).to(torch.float32)
    px = qx * (2.0 / 65535.0) - 1.0
    py = qy * (2.0 / 65535.0) - 1.0
    z = 1.0 - px.abs() - py.abs()
    t = torch.clamp(-z, min=0.0)
    x = px - torch.where(px >= 0, t, -t)
    y = py - torch.where(py >= 0, t, -t)
    inv = div_rn(1.0, torch.clamp(sqrt_rn(x * x + y * y + z * z),
                                  min=1e-30))
    return torch.stack([x * inv, y * inv, z * inv])
