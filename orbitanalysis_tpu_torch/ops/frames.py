"""Halo frame passes of the label-native detector (twin of
``orbitanalysis_tpu/ops/pallas_frames.py``: ``frame_rows_bf16x3`` (K6)
and ``frame_rows`` (K11), ``segment_moments_bf16x3`` (K7) and
``segment_moments`` (K12)).

The JAX package has two kernels for each pass: the bf16x3 forms of the
``'split'``, ``'pallas2'`` and ``'fused'`` routes and the f32 forms of
the ``'pallas'`` route, which differ only in how the TPU's matrix unit
reaches exactness (a bf16x3 split against f32 HIGHEST) and in the order
of the moment sums.  Here one CUDA kernel serves each pair, on labels of
any shape and length (the JAX f32 forms pad to their block size):

- :func:`frame_rows`: per-particle ``table[label]`` rows in SoA
  ``[C, N]`` layout (the halo centre and bulk velocity each particle's
  geometry is taken against), zeros where the label is outside
  ``[0, H)``.  On the TPU an exact one-hot MXU pass; on the card the
  CUDA kernel ``frame_rows`` (``csrc/frames.cu``) is a direct gather,
  exact by construction, so it equals its plain version bit for bit.
- :func:`segment_moments`: per-halo ``[sum m vx, sum m vy, sum m vz,
  sum m]`` over labels in ``[0, H)`` (``m = 1`` without masses), the
  mass-weighted bulk-velocity frame of the reference
  (``track_orbits.py:267-284``).  The float32 products ``m v`` are
  summed in float64 and rounded once, by the CUDA kernel
  ``segment_moments`` in an order fixed by N and H (no float atomics),
  so a bulk velocity is the same bits on every run, and both the kernel
  and its plain version give the float32 rounding of nearly the exact
  sum.  (A float32 sum of ~3e4 random-sign terms drifts by tens of ulps
  of its result, differently in every order; the TPU summed in float32,
  so the two agree to the tolerance of ``tests/test_label.py``.)

Each entry point launches its CUDA kernel when its inputs lie on a CUDA
device and its plain-torch version only when they lie on the CPU;
nothing falls back.  The plain versions are exposed as ``*_torch``.
"""

from __future__ import annotations

import torch

from orbitanalysis_tpu_torch.ops import _cuda

#: Particles per one-hot product in :func:`segment_moments_torch`.
_MOMENT_CHUNK = 1024
#: Bound on the one-hot block :func:`segment_moments_torch` builds at once.
_ONEHOT_ELEMS = 1 << 24


def frame_rows_torch(table: torch.Tensor, labels: torch.Tensor):
    """Plain-torch twin of the frame-row kernel: ``table [H, C]`` f32,
    ``labels`` any shape (flattened) -> ``[C, N]`` f32 gather, zeros
    where the label is outside ``[0, H)``."""
    h = table.shape[0]
    lab = labels.reshape(-1)
    ok = (lab >= 0) & (lab < h)
    rows = table.to(torch.float32).t()[:, torch.where(ok, lab, 0)]
    return torch.where(ok, rows, torch.zeros((), device=rows.device))


def frame_rows(table: torch.Tensor, labels: torch.Tensor):
    """``table[labels].T`` as SoA ``[C, N]`` f32 (K6, K11): the CUDA kernel
    on CUDA tensors, :func:`frame_rows_torch` on CPU tensors.
    ``labels`` may be any shape; it is flattened."""
    if _cuda.on_cpu(labels, "frame"):
        return frame_rows_torch(table, labels)
    return _cuda.frame_rows(table.to(torch.float32).contiguous(),
                            labels.reshape(-1).contiguous())


def segment_moments_torch(labels: torch.Tensor, vel: torch.Tensor,
                          mass=None, *, n_halos: int) -> torch.Tensor:
    """Plain-torch twin of the moments kernel: ``[H, 4]`` f32.

    The JAX package's ``_segment_moments_matmul`` form: one-hot
    products, deterministic on every backend (``index_add_`` is not on
    the card, which runs it with atomics).  The float32 values ``m v``
    go into batched one-hot products of :data:`_MOMENT_CHUNK` particles
    in float64 (so TF32, a float32 setting, never applies), the chunk
    sums are added by ``torch.sum`` in float64, and the result is
    rounded to float32 once, as the kernel rounds it.
    """
    lab = labels.reshape(-1)
    n, h = lab.shape[0], int(n_halos)
    vel = vel.reshape(3, n).to(torch.float32)
    w = (torch.ones(n, dtype=torch.float32, device=lab.device)
         if mass is None else mass.reshape(n).to(torch.float32))
    ok = (lab >= 0) & (lab < h)
    vals = torch.cat([vel * w, w[None]], dim=0)                 # [4, N]
    vals = torch.where(ok, vals, torch.zeros((), device=lab.device))
    pad = (-n) % _MOMENT_CHUNK
    if pad:
        lab = torch.cat([lab, lab.new_full((pad,), -1)])
        vals = torch.cat([vals, vals.new_zeros((4, pad))], dim=1)
    k = (n + pad) // _MOMENT_CHUNK
    lab = lab.view(k, _MOMENT_CHUNK)
    vals = vals.view(4, k, _MOMENT_CHUNK).permute(1, 2, 0).to(
        torch.float64)                                          # [k, c, 4]
    halos = torch.arange(h, dtype=lab.dtype, device=lab.device)
    step = max(1, _ONEHOT_ELEMS // max(h * _MOMENT_CHUNK, 1))
    parts = [vals.new_zeros((1, h, 4))]
    for s in range(0, k, step):
        onehot = (lab[s:s + step, None, :] == halos[None, :, None]
                  ).to(torch.float64)                           # [b, H, c]
        parts.append(torch.bmm(onehot, vals[s:s + step]))       # [b, H, 4]
    return torch.cat(parts).sum(dim=0).to(torch.float32)


def segment_moments(labels: torch.Tensor, vel: torch.Tensor, mass=None, *,
                    n_halos: int) -> torch.Tensor:
    """Per-halo moments ``[H, 4]`` = ``[sum m v, sum m]`` over labels in
    ``[0, H)`` (K7, K12): the CUDA kernel on CUDA tensors,
    :func:`segment_moments_torch` on CPU tensors.  ``labels``/``mass``
    any shape, ``vel`` ``[3, ...]``, flattened."""
    if _cuda.on_cpu(labels, "frame"):
        return segment_moments_torch(labels, vel, mass, n_halos=n_halos)
    lab = labels.reshape(-1).contiguous()
    n = lab.shape[0]
    return _cuda.segment_moments(
        lab, vel.reshape(3, n).to(torch.float32).contiguous(),
        None if mass is None
        else mass.reshape(n).to(torch.float32).contiguous(), int(n_halos))
