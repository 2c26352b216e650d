"""P3M gravity: Gaussian-split PM long range plus a cell-binned
short-range correction (twin of ``orbitanalysis_tpu/models/p3m.py``).

The potential splits with a Gaussian of scale ``sigma``:

  long range   ``exp(-k^2 sigma^2 / 2)`` on the PM Green's function
               (:func:`~orbitanalysis_tpu_torch.models.pm.pm_forces_grid`
               with ``smoothing=sigma``), the mass deposited by the
               single-device PM's ``deposit='auto'`` (the sorted-stream
               kernel K13 on CUDA tensors, in a fixed order);
  short range  the pairwise erfc-complement force within
               ``r_cut = cutoff_sigmas * sigma``:
               ``|F| = m_i m_j [erfc(u) / r^2 + sqrt(2/pi) e^{-u^2} /
               (sigma r)]``, ``u = r / (sqrt(2) sigma)``.

Particles are binned into a ``[C^3, cap]`` cell layout with cells of at
least ``r_cut``; each cell meets its 27 neighbour cells through
``torch.roll`` over the cell grid, as dense ``[cells, cap, cap]`` pair
batches.  The JAX package computes each neighbour offset for all cells
at once, which XLA fuses; eager torch materialises every intermediate,
so here each offset runs over cells in chunks of at most
:data:`_PAIR_ELEMS` pairs.  Plain torch (``torch.special.erfc``) but for
the deposit.
Overflowing cells give their dropped particles NaN forces (fail loud).
"""

from __future__ import annotations

import math

import torch

from orbitanalysis_tpu_torch.models.pm import (
    pm_forces_grid,
    select_depositor,
    select_interpolator,
)
from orbitanalysis_tpu_torch.ops.deposit import mass_vector

#: Bound on the pairs one short-range batch builds at once.
_PAIR_ELEMS = 1 << 24


def _bin_particles(pos, mass, c_dims, box_size, cap):
    """Scatter particles into a padded ``[C^3, cap]`` cell layout.

    Returns ``(cell_pos [C3, cap, 3], cell_mass [C3, cap], dest [N] flat
    slot of each particle, ok [N])``.  Particles ranked past ``cap`` in
    their cell get ``ok=False`` and stay out of the layout."""
    n = pos.shape[0]
    dev = pos.device
    c3 = c_dims ** 3
    cell = box_size / c_dims
    idx = torch.clamp(torch.floor(pos / cell).to(torch.int64), 0, c_dims - 1)
    cid = (idx[:, 0] * c_dims + idx[:, 1]) * c_dims + idx[:, 2]
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    counts = torch.bincount(cid_s, minlength=c3)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dev) - starts[cid_s]
    ok_s = rank < cap
    dest_s = torch.where(ok_s, cid_s * cap + rank, c3 * cap)
    # the sentinel c3 * cap is masked out before the scatter (the JAX
    # package drops it with mode='drop')
    keep = torch.nonzero(ok_s).reshape(-1)
    cell_pos = torch.zeros((c3 * cap, 3), dtype=pos.dtype, device=dev)
    cell_pos[dest_s[keep]] = pos[order[keep]]
    cell_mass = torch.zeros(c3 * cap, dtype=mass.dtype, device=dev)
    cell_mass[dest_s[keep]] = mass[order[keep]]
    dest = torch.empty(n, dtype=torch.int64, device=dev)
    dest[order] = dest_s
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    ok[order] = ok_s
    return (cell_pos.reshape(c3, cap, 3), cell_mass.reshape(c3, cap), dest,
            ok)


def short_range_pair_block(tgt_pos, src_pos, src_mass, box_size, sigma,
                           r_cut, softening):
    """Erfc-correction acceleration of one target/source cell batch:
    ``tgt_pos [B, T, 3]``, ``src_pos [B, S, 3]``, ``src_mass [B, S]`` ->
    ``[B, T, 3]``.  Self and padded pairs (r2 == 0) and pairs past
    ``r_cut`` add zero; the minimum image is taken per pair."""
    inv_s = 1.0 / (math.sqrt(2.0) * sigma)
    pref = math.sqrt(2.0 / math.pi) / sigma
    eps2 = softening * softening

    d = tgt_pos[:, :, None, :] - src_pos[:, None, :, :]
    d = d - box_size * torch.round(d / box_size)
    r2 = torch.sum(d * d, dim=-1)
    # guarded radius: self/padded pairs (r2 == 0, possibly eps2 == 0
    # too) must give finite garbage, not NaN (0 * nan = nan)
    r = torch.sqrt(torch.clamp(r2 + eps2, min=1e-30))
    u = r * inv_s
    mag = torch.special.erfc(u) / (r * r) + pref * torch.exp(-u * u) / r
    w = ((r2 < r_cut * r_cut) & (r2 > 0)).to(tgt_pos.dtype) \
        * src_mass[:, None, :]
    return -torch.einsum("cts,ctsi->cti", w * mag / r, d)


def _short_range_forces(cell_pos, cell_mass, c_dims, box_size, sigma,
                        r_cut, softening, G):
    """Erfc-correction pair forces over the 27 neighbour-cell rolls:
    ``acc [C3, cap, 3]`` for the binned particles."""
    c3, cap, _ = cell_pos.shape
    grid_pos = cell_pos.reshape(c_dims, c_dims, c_dims, cap, 3)
    grid_mass = cell_mass.reshape(c_dims, c_dims, c_dims, cap)
    # offsets deduplicated mod the grid: for c_dims < 3 several of the
    # 27 rolls alias the same source cells and would double-count
    offsets = sorted({
        (dx % c_dims, dy % c_dims, dz % c_dims)
        for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    })
    batch = max(1, _PAIR_ELEMS // (cap * cap))
    acc = torch.zeros((c3, cap, 3), dtype=cell_pos.dtype,
                      device=cell_pos.device)
    for dx, dy, dz in offsets:
        src_p = torch.roll(grid_pos, (dx, dy, dz), dims=(0, 1, 2)) \
            .reshape(c3, cap, 3)
        src_m = torch.roll(grid_mass, (dx, dy, dz), dims=(0, 1, 2)) \
            .reshape(c3, cap)
        for c0 in range(0, c3, batch):
            sl = slice(c0, c0 + batch)
            acc[sl] = acc[sl] + short_range_pair_block(
                cell_pos[sl], src_p[sl], src_m[sl], box_size, sigma, r_cut,
                softening)
    return G * acc


def make_p3m_force_fn(grid: int, sigma_cells: float = 1.5,
                      cutoff_sigmas: float = 3.5, cell_cap: int | None = None,
                      deconvolve: bool = True, assignment: str = "auto"):
    """A P3M ``force_fn(pos, mass, box_size=..., G=..., softening=...)``
    for :func:`orbitanalysis_tpu_torch.models.nbody.simulate_with_tracking`.

    ``sigma_cells``: the Gaussian split scale in PM cells;
    ``cutoff_sigmas``: the short-range cutoff in sigmas (3.5 leaves an
    erfc tail below 5e-4); ``cell_cap``: particles a short-range cell
    holds, by default room for ~4x the uniform mean.  Overflowing cells
    give their dropped particles NaN forces.  ``deconvolve=True`` divides
    out the assignment windows of the smooth split field."""
    interp = select_interpolator(assignment)
    depositor = select_depositor("auto", grid)

    def force(pos, mass, box_size=None, G=1.0, softening=0.0, **_):
        if box_size is None:
            raise ValueError("P3M forces require a periodic box_size")
        box_size = float(box_size)
        n = pos.shape[0]
        h = box_size / grid
        sigma = sigma_cells * h
        r_cut = cutoff_sigmas * sigma
        if r_cut > box_size / 2:
            # the erfc short range sees only the minimum image per pair
            # while the smoothed k-space long range sums all images
            raise ValueError(
                f"P3M short-range cutoff {r_cut:.3g} exceeds half the "
                f"box ({box_size / 2:.3g}); raise `grid` or lower "
                "`sigma_cells`/`cutoff_sigmas` (same constraint as the "
                "distributed slab-width check)"
            )
        c_dims = max(int(box_size / r_cut), 1)
        if cell_cap is None:
            mean = n / c_dims ** 3
            cap = max(8, int(math.ceil(4.0 * mean / 8.0)) * 8)
        else:
            cap = cell_cap
        mass = mass_vector(mass, n, pos)

        rho = depositor(pos, mass, grid, box_size)
        field = pm_forces_grid(rho, grid, box_size, G=G,
                               deconvolve=deconvolve, smoothing=sigma)
        acc = interp(field, pos, grid, box_size)

        cell_pos, cell_mass, dest, ok = _bin_particles(
            pos, mass, c_dims, box_size, cap)
        acc_sr = _short_range_forces(
            cell_pos, cell_mass, c_dims, box_size, sigma, r_cut, softening,
            G).reshape(c_dims ** 3 * cap, 3)
        nan = torch.full((), float("nan"), dtype=acc.dtype, device=acc.device)
        return acc + torch.where(ok[:, None],
                                 acc_sr[torch.where(ok, dest, 0)], nan)

    return force
