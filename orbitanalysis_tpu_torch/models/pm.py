"""Particle-mesh (PM) gravity solver: FFT Poisson on the card (twin of
``orbitanalysis_tpu/models/pm.py``).

The classic PM pipeline:

  CIC deposit -> 3D real FFT -> Green's function [* deconvolution]
  -> spectral gradient -> inverse FFTs -> CIC interpolation

Deconvolution stays off by default, as in the JAX package (there the
double-CIC-window compensation over-sharpened the two-body force).

Deposit policy (:func:`select_depositor`): ``'auto'`` runs the
sorted-stream deposit of :mod:`orbitanalysis_tpu_torch.ops.deposit`
(kernel K13) on CUDA tensors and the scatter :func:`cic_deposit`
(``index_add_``) on CPU tensors, the choice the JAX package makes
between the accelerator its kernel was written for and the CPU.
Interpolation policy (:func:`select_interpolator`): ``'auto'`` is
``'scalar'``, the JAX answer off a TPU: :func:`cic_interpolate`, which
runs the hand-written kernel ``cic_interpolate`` (``csrc/interp.cu``: a
thread a particle, the field visited by x-slabs that fit the L2) on CUDA
tensors and its plain version :func:`cic_interpolate_torch` (the
corners' ``[8, N]`` indices and weights, then 24 gathers) on CPU
tensors; the two equal bit for bit.  The ``'rows'`` and ``'cells'``
tables exist to cut the TPU's cost per gather index, which the card does
not have; they are plain torch here, for parity.

Where :func:`pm_forces` deposits through the sorted stream and the
interpolation is ``'scalar'``, it interpolates that stream instead of
the positions (:func:`cic_interpolate_stream`): the deposit's keys and
fractions in cell order, each row written at the particle's index
(``order``), so neighbouring threads read neighbouring cells.  Its
kernel is the stream form of ``cic_interpolate``, its plain version
:func:`cic_interpolate_stream_torch`; both equal the positions form bit
for bit, since the stream's fractions are the very floats
:func:`~orbitanalysis_tpu_torch.ops.deposit.cic_base` gives.

Every CIC helper takes the cell index as ``pos / h`` through
:func:`~orbitanalysis_tpu_torch.utils.numerics.div_rn` (``h`` the float32
cell size), the IEEE quotient on every backend; a CUDA division by a CPU
scalar is a reciprocal multiply and moves the base cell of particles on
a cell boundary.  Sums over the 8 corners run in a fixed order.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.ops.deposit import (
    _sorted_stream,
    cic_base,
    cic_deposit_sorted,
    deposit_stream,
    deposit_supported,
    fold_virtual,
    mass_vector,
    stream_base,
)
from orbitanalysis_tpu_torch.utils.metrics import phase_timer
from orbitanalysis_tpu_torch.utils.numerics import box_tensor, div_rn


class PMConfig(NamedTuple):
    grid: int           # cells per dimension
    box_size: float
    G: float = 1.0
    deconvolve: bool = False  # compensate the CIC assignment window twice


_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _corner_weights(f):
    """[N, 8] trilinear weights, corner order (dx, dy, dz) lexicographic
    (dz minor), each product ``(wx * wy) * wz``."""
    wx = torch.stack([1.0 - f[:, 0], f[:, 0]], dim=1)      # [N, 2]
    wy = torch.stack([1.0 - f[:, 1], f[:, 1]], dim=1)
    wz = torch.stack([1.0 - f[:, 2], f[:, 2]], dim=1)
    w = wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]
    return w.reshape(-1, 8)


def _cic_neighbors(pos, grid, box_size):
    """CIC cell indices and weights, 8 neighbours a particle:
    ``(flat [8, N] int64 cell indices, w [8, N])``."""
    return _corners(*cic_base(pos, grid, box_size), grid)


def _corners(i0, f, grid):
    """The 8 corners of base cells ``i0 [N, 3]`` (in ``[0, grid)``) with
    fractions ``f [N, 3]``: ``(flat [8, N] int64, w [8, N])``, each
    weight ``(wx * wy) * wz``."""
    flats, ws = [], []
    for dx, dy, dz in _CORNERS:
        wx = f[:, 0] if dx else 1.0 - f[:, 0]
        wy = f[:, 1] if dy else 1.0 - f[:, 1]
        wz = f[:, 2] if dz else 1.0 - f[:, 2]
        ix = torch.remainder(i0[:, 0] + dx, grid)
        iy = torch.remainder(i0[:, 1] + dy, grid)
        iz = torch.remainder(i0[:, 2] + dz, grid)
        flats.append((ix * grid + iy) * grid + iz)
        ws.append(wx * wy * wz)
    return torch.stack(flats), torch.stack(ws)


def cic_deposit(pos, mass, grid, box_size):
    """Cloud-in-cell mass deposit onto a periodic ``[grid]^3`` mesh, one
    ``index_add_`` of the 8N weights.  ``mass`` a scalar (equal-mass
    species) or ``[N]``.  On the card ``index_add_`` adds with atomics,
    in no fixed order, so two calls may differ in their last bits there.
    ``deposit='scatter'`` selects it on any device; the default deposits
    (``deposit='auto'`` of :func:`make_pm_force_fn`, P3M and the
    distributed psum path, through :func:`cic_deposit_auto`) reach it
    only on CPU tensors or where the grid's flat keys pass int32."""
    pos = pos.to(torch.float32)
    flat, w = _cic_neighbors(pos, grid, box_size)
    m = mass_vector(mass, pos.shape[0], pos)
    rho = torch.zeros(grid ** 3, dtype=pos.dtype, device=pos.device)
    rho.index_add_(0, flat.reshape(-1), (w * m[None, :]).reshape(-1))
    return rho.reshape(grid, grid, grid)


def cic_interpolate(field3, pos, grid, box_size):
    """Interpolate a ``[3, grid, grid, grid]`` vector field to particles:
    ``[N, 3]``, each component's 8 corners added in corner order.  On
    CUDA tensors the kernel ``cic_interpolate`` (``csrc/interp.cu``), on
    CPU tensors its plain version :func:`cic_interpolate_torch`: the two
    equal bit for bit."""
    if _cuda.on_cpu(pos, "cic_interpolate"):
        return cic_interpolate_torch(field3, pos, grid, box_size)
    return _cuda.cic_interpolate(field3.contiguous(),
                                 pos.to(torch.float32).contiguous(), grid,
                                 box_size)


def cic_interpolate_torch(field3, pos, grid, box_size):
    """Plain-torch twin of the interpolation kernel: the 8 corners' flat
    indices and weights (:func:`_cic_neighbors`), then 24 gathers, each
    component's products added in corner order."""
    return _gather_corners(field3, *_cic_neighbors(pos, grid, box_size))


def cic_interpolate_stream(field3, skeys, fracs, order, grid):
    """:func:`cic_interpolate` from the deposit's cell-sorted stream
    (:func:`~orbitanalysis_tpu_torch.ops.deposit._sorted_stream`: keys
    ``[N]`` int32, ``fracs [4, N]``, of which rows 0-2 are read, and
    ``order [N]`` int64): ``[N, 3]`` in particle order, row ``order[i]``
    from entry ``i``.  On CUDA tensors the stream form of the kernel
    ``cic_interpolate``, on CPU tensors
    :func:`cic_interpolate_stream_torch`; both equal
    :func:`cic_interpolate` on the positions the stream was built from,
    bit for bit."""
    if _cuda.on_cpu(skeys, "cic_interpolate"):
        return cic_interpolate_stream_torch(field3, skeys, fracs, order,
                                            grid)
    return _cuda.cic_interpolate_stream(field3.contiguous(), skeys, fracs,
                                        order, grid)


def cic_interpolate_stream_torch(field3, skeys, fracs, order, grid):
    """Plain-torch twin of the stream form: each key's base cell
    (:func:`~orbitanalysis_tpu_torch.ops.deposit.stream_base`) and the
    entry's fractions, the gathers and sums of
    :func:`cic_interpolate_torch`, then ``out[order] = vals``."""
    vals = _gather_corners(field3, *_corners(stream_base(skeys, grid),
                                             fracs[:3].T, grid))
    out = torch.empty_like(vals)
    out[order] = vals
    return out


def _gather_corners(field3, flat, w):
    """``[N, 3]``: each component's 8 corner values times their weights,
    added in corner order."""
    out = []
    for c in range(3):
        f = field3[c].reshape(-1)
        acc = f[flat[0]] * w[0]
        for q in range(1, 8):
            acc = acc + f[flat[q]] * w[q]
        out.append(acc)
    return torch.stack(out, dim=-1)


def cic_deposit_rows(pos, mass, grid, box_size):
    """CIC deposit as one ``[N, 8]`` row scatter-add at the base cell,
    then dense periodic rolls shift each corner channel onto its cell.
    The same adds as :func:`cic_deposit` in another order (the JAX
    package's measured record of a TPU experiment; never auto-selected)."""
    pos = pos.to(torch.float32)
    i0, f = cic_base(pos, grid, box_size)
    w = _corner_weights(f) * mass_vector(mass, pos.shape[0], pos)[:, None]
    base = (i0[:, 0] * grid + i0[:, 1]) * grid + i0[:, 2]
    r8 = torch.zeros((grid ** 3, 8), dtype=pos.dtype, device=pos.device)
    r8.index_add_(0, base, w)
    r8 = r8.reshape(grid, grid, grid, 8)
    rho = torch.zeros((grid, grid, grid), dtype=pos.dtype, device=pos.device)
    for c, (dx, dy, dz) in enumerate(_CORNERS):
        rho = rho + torch.roll(r8[..., c], (dx, dy, dz), dims=(0, 1, 2))
    return rho


#: particles per chunk of :func:`folded_row_interpolate` (the JAX
#: ``lax.map`` chunk)
_ROWS_CHUNK = 1 << 19

#: corner-table bytes above which ``table_dtype='auto'`` stores bfloat16
#: (values quantized, products and sums float32)
_TABLE_BF16_BYTES = 3 << 30


def _table_dtype(table_dtype, n_bytes_f32):
    if table_dtype == "auto":
        return (torch.bfloat16 if n_bytes_f32 > _TABLE_BF16_BYTES
                else torch.float32)
    return table_dtype


def cic_interpolate_rows(field3, pos, grid, box_size, fold=16,
                         table_dtype="auto"):
    """CIC interpolation through a folded corner table: one row gather a
    particle instead of 24 scalar gathers (the TPU's form; the card has
    no cost per gather index, so ``'auto'`` never picks it).

    ``table[r, (comp * 8 + corner) * fold + s]`` holds ``field3[comp]``
    at cell ``r * fold + s`` shifted by the corner offset; each particle
    gathers its base cell's row and selects its ``fold`` lane with a
    one-hot product.  ``table_dtype``: ``'auto'`` keeps float32 until the
    table would pass 3 GiB, then bfloat16, or a torch dtype."""
    g3 = grid ** 3
    while g3 % fold:
        fold //= 2
    table_dtype = _table_dtype(table_dtype, g3 * 24 * 4)
    i0, f = cic_base(pos, grid, box_size)
    w = _corner_weights(f)                                    # [N, 8]
    base = (i0[:, 0] * grid + i0[:, 1]) * grid + i0[:, 2]     # [N]
    table = torch.zeros((g3 // fold, 24 * fold), dtype=table_dtype,
                        device=field3.device)
    for comp in range(3):
        for c, (dx, dy, dz) in enumerate(_CORNERS):
            col = torch.roll(field3[comp], (-dx, -dy, -dz), dims=(0, 1, 2))
            k = (comp * 8 + c) * fold
            table[:, k:k + fold] = col.reshape(g3 // fold, fold)
    return folded_row_interpolate(table, base, w, fold)


def folded_row_interpolate(table, base, w8, fold):
    """Gather-and-reduce half of :func:`cic_interpolate_rows`: ``table``
    ``[n_cells / fold, 24 * fold]``, ``base [N]`` flat cell indices,
    ``w8 [N, 8]`` corner weights -> ``[N, 3]`` float32, particles in
    chunks of :data:`_ROWS_CHUNK`."""
    n = base.shape[0]
    out = []
    lane = torch.arange(fold, device=base.device)
    for s in range(0, n, _ROWS_CHUNK):
        bc, wc = base[s:s + _ROWS_CHUNK], w8[s:s + _ROWS_CHUNK]
        vals = table[bc // fold].reshape(-1, 3, 8, fold).to(torch.float32)
        oh = (lane[None, :] == (bc % fold)[:, None]).to(torch.float32)
        prod = vals * oh[:, None, None, :] * wc[:, None, :, None]
        out.append(torch.sum(prod, dim=(2, 3)))
    if not out:
        return torch.zeros((0, 3), dtype=torch.float32, device=base.device)
    return torch.cat(out)


def pm_forces_grid(rho, grid, box_size, G=1.0, deconvolve=False,
                   smoothing=None):
    """Force field ``[3, G, G, G]`` from a deposited density mesh
    (``torch.fft.rfftn``/``irfftn``, complex64).

    ``smoothing`` (physical length sigma) multiplies the Green's function
    by ``exp(-k_phys^2 sigma^2 / 2)``, the Gaussian-split long range of
    P3M (:mod:`orbitanalysis_tpu_torch.models.p3m`)."""
    dev = rho.device
    f32 = torch.float32
    rho = rho.to(f32)
    rho_k = torch.fft.rfftn(rho)
    two_pi = 2 * math.pi
    kx = torch.fft.fftfreq(grid, dtype=f32, device=dev)[:, None, None] * two_pi
    ky = torch.fft.fftfreq(grid, dtype=f32, device=dev)[None, :, None] * two_pi
    kz = torch.fft.rfftfreq(grid, dtype=f32, device=dev)[None, None, :] * two_pi
    k2 = kx * kx + ky * ky + kz * kz              # (cell units)

    # every quotient below is the IEEE float32 one (div_rn), as in the
    # JAX package; torch takes a scalar's reciprocal instead
    h = div_rn(box_tensor(box_size, rho), rho.new_full((), float(grid)))
    # Green's function: phi_k = -4 pi G rho_k / k_phys^2, k_phys = k / h
    green = torch.where(k2 > 0,
                        div_rn(-4 * math.pi, torch.clamp(k2, min=1e-30)),
                        torch.zeros((), dtype=f32, device=dev))
    green = div_rn(green * (h * h), h * h * h)  # k->physical, ->density
    if smoothing is not None:
        green = green * torch.exp(-k2 * div_rn(float(smoothing), h) ** 2
                                  / 2.0)
    if deconvolve:
        # divide out the CIC window squared: W = prod sinc^2(k_i / 2)
        tp = torch.full((), two_pi, dtype=f32, device=dev)
        wx, wy, wz = (torch.sinc(div_rn(k, tp)) for k in (kx, ky, kz))
        w2 = (wx * wy * wz) ** 2
        green = green / torch.clamp(w2, min=1e-4) ** 2
    phi_k = green * rho_k * G

    forces = []
    for kvec in (kx, ky, kz):
        fk = -1j * kvec / h * phi_k               # physical gradient
        forces.append(torch.fft.irfftn(fk, s=(grid, grid, grid)))
    return torch.stack(forces)


#: particles per chunk of :func:`cic_interpolate_cells`
_CELLS_CHUNK = 1 << 18


def cic_interpolate_cells(field3, pos, grid, box_size, block=4,
                          table_dtype="auto"):
    """CIC interpolation through a supercell-halo corner table: ``block^3``
    cells a row with a one-cell halo, ``[grid^3 / block^3, 3 (block+1)^3]``
    (the JAX package's memory diet for the 512^3 table), each particle's
    24 stencil values selected from its row by three separable exact
    one-hot contractions.  With a float32 table the selection is exact;
    ``table_dtype='auto'`` drops to bfloat16 past 3 GiB."""
    b = block
    while grid % b:
        b //= 2
    bb = b + 1
    s = grid // b
    table_dtype = _table_dtype(table_dtype, grid ** 3 * 3 * bb ** 3
                               // b ** 3 * 4)
    dev = field3.device
    ar = torch.arange(s, device=dev) * b
    table = torch.zeros((s * s * s, 3 * bb ** 3), dtype=table_dtype,
                        device=dev)
    for comp in range(3):
        fx = field3[comp]
        for i in range(bb):
            fxi = torch.index_select(fx, 0, (ar + i) % grid)
            for j in range(bb):
                fxj = torch.index_select(fxi, 1, (ar + j) % grid)
                for k in range(bb):
                    col = torch.index_select(fxj, 2, (ar + k) % grid)
                    table[:, comp * bb ** 3 + (i * bb + j) * bb + k] = \
                        col.reshape(-1)

    i0, f = cic_base(pos, grid, box_size)
    w8 = _corner_weights(f)                                   # [N, 8]
    sc = i0 // b
    row = (sc[:, 0] * s + sc[:, 1]) * s + sc[:, 2]            # [N]
    cin = i0 - sc * b                                         # [N, 3]
    iot = torch.arange(bb, device=dev)
    out = []
    for c0 in range(0, row.shape[0], _CELLS_CHUNK):
        rc = row[c0:c0 + _CELLS_CHUNK]
        cc = cin[c0:c0 + _CELLS_CHUNK]
        wc = w8[c0:c0 + _CELLS_CHUNK]
        vals = table[rc].reshape(-1, 3, bb, bb, bb).to(torch.float32)

        def oh(coord, d):
            return (iot[None, :] == (coord + d)[:, None]).to(torch.float32)

        # separable exact selection: contract z, then y, then x
        az = [torch.sum(vals * oh(cc[:, 2], dz)[:, None, None, None, :],
                        dim=-1) for dz in (0, 1)]
        ay = [[torch.sum(az[dz] * oh(cc[:, 1], dy)[:, None, None, :],
                         dim=-1) for dz in (0, 1)] for dy in (0, 1)]
        corners = [torch.sum(ay[dy][dz] * oh(cc[:, 0], dx)[:, None, :],
                             dim=-1)
                   for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
        vals8 = torch.stack(corners, dim=-1)                  # [c, 3, 8]
        out.append(torch.sum(vals8 * wc[:, None, :], dim=-1))
    if not out:
        return torch.zeros((0, 3), dtype=torch.float32, device=dev)
    return torch.cat(out)


def _interp_choice(assignment: str, grid: int) -> str:
    """``'auto'`` is ``'scalar'``: the JAX package's answer off a TPU,
    and the card has no cost per gather index for the tables to cut."""
    if assignment == "auto":
        return "scalar"
    if assignment not in ("rows", "scalar", "cells"):
        raise ValueError(
            f"assignment must be 'auto', 'rows', 'cells' or 'scalar', "
            f"got {assignment!r}"
        )
    return assignment


def _use_rows(assignment: str) -> bool:
    """The rows-or-scalar form of the policy, for the sharded PM (its
    slab tables never reach the size the ``'cells'`` form exists for, so
    ``'cells'`` reads as ``'rows'``)."""
    return _interp_choice(
        assignment if assignment != "cells" else "rows", 0) != "scalar"


def cic_deposit_auto(pos, mass, grid, box_size):
    """The ``deposit='auto'`` policy at call time: the sorted-stream
    deposit (K13) for CUDA tensors, the scatter :func:`cic_deposit` for
    CPU tensors."""
    if pos.is_cuda:
        return cic_deposit_sorted(pos, mass, grid, box_size)
    return cic_deposit(pos, mass, grid, box_size)


def select_depositor(deposit: str, grid: int):
    """Deposit policy: ``'sorted'`` = the sorted-stream deposit
    (:func:`orbitanalysis_tpu_torch.ops.deposit.cic_deposit_sorted`, K13
    on CUDA tensors, its plain version on CPU tensors), ``'scatter'`` =
    :func:`cic_deposit`, ``'auto'`` = :func:`cic_deposit_auto` (sorted on
    CUDA tensors, scatter on CPU ones) where the grid's flat keys fit
    int32, else scatter."""
    if deposit == "auto":
        return cic_deposit_auto if deposit_supported(grid) else cic_deposit
    if deposit == "sorted":
        if not deposit_supported(grid):
            raise ValueError(
                f"deposit='sorted' needs the virtual {grid + 1}^3 mesh's "
                "flat keys within int32 (single call or slab-partitionable); "
                "this grid exceeds both"
            )
        return cic_deposit_sorted
    if deposit == "scatter":
        return cic_deposit
    raise ValueError(
        f"deposit must be 'auto', 'sorted' or 'scatter', got {deposit!r}"
    )


def select_interpolator(assignment: str, grid: int = 0):
    """The one place the ``assignment`` policy lives (validated eagerly,
    at construction time)."""
    return {
        "rows": cic_interpolate_rows,
        "cells": cic_interpolate_cells,
        "scalar": cic_interpolate,
    }[_interp_choice(assignment, grid)]


def _deposits_sorted(depositor, pos) -> bool:
    """True where ``depositor`` (of :func:`select_depositor`) deposits
    ``pos`` through the sorted stream."""
    return depositor is cic_deposit_sorted or (
        depositor is cic_deposit_auto and pos.is_cuda)


def pm_forces(pos, mass, grid, box_size, G=1.0, deconvolve=False,
              assignment="auto", deposit="auto", metrics=None, **_):
    """PM accelerations ``[N, 3]`` for all particles (signature-compatible
    with :func:`orbitanalysis_tpu_torch.models.nbody.direct_forces`
    given a closure over ``grid``).  ``assignment`` picks the
    interpolation (:func:`select_interpolator`), ``deposit`` the mass
    assignment (:func:`select_depositor`).  Where the deposit is the
    sorted stream's and the interpolation ``'scalar'``, the stream is
    built once, deposited, kept across the solve and interpolated
    (:func:`cic_interpolate_stream`); the same bits as the positions
    form.

    Spans ``pm.deposit``, ``pm.solve`` and ``pm.interp``: host seconds
    into ``metrics`` (``deposit_s``, ``solve_s``, ``interp_s``) and the
    profiler's ranges; ``metrics['deposited']`` counts the particles
    deposited, ``metrics['interp_stream']`` those interpolated from the
    stream."""
    interp = select_interpolator(assignment, grid)
    depositor = select_depositor(deposit, grid)
    stream = (_interp_choice(assignment, grid) == "scalar"
              and _deposits_sorted(depositor, pos))
    with phase_timer(metrics, "pm.deposit"):
        if stream:
            skeys, fracs, order = _sorted_stream(pos, mass, grid, box_size)
            rho = fold_virtual(deposit_stream(skeys, fracs, grid), grid)
        else:
            rho = depositor(pos, mass, grid, box_size)
    with phase_timer(metrics, "pm.solve"):
        field = pm_forces_grid(rho, grid, box_size, G=G,
                               deconvolve=deconvolve)
    with phase_timer(metrics, "pm.interp"):
        if stream:
            acc = cic_interpolate_stream(field, skeys, fracs, order, grid)
        else:
            acc = interp(field, pos, grid, box_size)
    if metrics is not None:
        n = pos.shape[0]
        metrics["deposited"] = metrics.get("deposited", 0) + n
        metrics["interp_stream"] = (metrics.get("interp_stream", 0)
                                    + (n if stream else 0))
    return acc


def make_pm_force_fn(grid: int, deconvolve: bool = False,
                     assignment: str = "auto", deposit: str = "auto"):
    """A ``force_fn(pos, mass, box_size=..., G=..., **ignored)`` for
    :func:`orbitanalysis_tpu_torch.models.nbody.simulate_with_tracking`."""
    select_interpolator(assignment, grid)
    select_depositor(deposit, grid)

    def force(pos, mass, box_size=None, G=1.0, metrics=None, **_):
        if box_size is None:
            raise ValueError("PM forces require a periodic box_size")
        return pm_forces(pos, mass, grid, box_size, G=G,
                         deconvolve=deconvolve, assignment=assignment,
                         deposit=deposit, metrics=metrics)

    return force
