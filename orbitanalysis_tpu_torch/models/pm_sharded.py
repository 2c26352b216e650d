"""Distributed particle-mesh Poisson solve: a slab-decomposed FFT over
the ranks of one mesh axis (twin of ``orbitanalysis_tpu/models/
pm_sharded.py``).

Scales the PM force grid past one card's memory: a ``1024^3`` float32
force field of three components is 12.9 GB, a ``2048^3`` one 103 GB
against the H100's 80 GB.  The classic slab/pencil scheme, each rank of
a ``torch.distributed`` world running the JAX ``shard_map`` body on its
block:

  rho [X, Y, Z] sharded on X
    -> local rFFT over (Y, Z)                     (no communication)
    -> all_to_all: gather X, scatter Y            (one collective)
    -> local FFT over X                           (spectral in all axes)
    -> Green's function x i*k gradient (3 components)
    -> local iFFT over X
    -> all_to_all back: gather Y, scatter X
    -> local irFFT over (Y, Z)

The JAX package computes all of this in plain ``jnp`` (scatter-adds,
FFTs, collectives) outside any Pallas kernel.  The port's solve is plain
torch, ``torch.fft`` and the collectives of
:mod:`~orbitanalysis_tpu_torch.parallel.collectives`, the halo planes
through :func:`~orbitanalysis_tpu_torch.parallel.collectives.ppermute`;
its deposits add in a fixed order on the card, so two calls on the same
inputs on the same world give the same bits: the slab-resident path (and
distributed P3M) deposits through the sorted-stream kernel K13
(:func:`_slab_deposit`), the psum path through
:func:`~orbitanalysis_tpu_torch.models.pm.cic_deposit_auto` (K13 on CUDA
tensors), as the single-device PM does.

Contract.  Every force function takes and returns the global arrays
(``pos [N, 3]``, ``mass [N]`` the same on every rank, as
``simulate_with_tracking`` holds them), computes this rank's block
``[rank * N / D, (rank + 1) * N / D)`` (what ``device_put(P(axis))``
gives a JAX ``shard_map``) and all-gathers the accelerations; its
``.local`` attribute is the block body.  ``solve(rho)`` likewise takes
the global density and returns the global field; ``solve.local_solve``
works on this rank's X-slab.

Where the port differs from the JAX code, with the same results:

- a ``mode='drop'`` scatter writes to one dump element past the end
  (sliced off) and a ``mode='fill'`` gather is masked, since an index out
  of range is a device-side assert on CUDA;
- the slab deposit is the sorted stream of the routed lanes, summed in
  routed-lane order by K13 (the JAX scatter-add's order is XLA's); the
  lanes without mass (bucket padding) or outside the slab take a key
  past the block and deposit nothing, where JAX adds their zeros;
- the P3M cell layout is ``min(cap_sr, most particles in any cell of any
  rank)`` wide, not ``cap_sr``: the overflow mask is JAX's (ranks past
  ``cap_sr``), and the padding slots JAX also computes add exact zeros;
  one all-gather of a count agrees on the width across ranks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from orbitanalysis_tpu_torch.models.p3m import (
    _PAIR_ELEMS,
    short_range_pair_block,
)
from orbitanalysis_tpu_torch.models.pm import (
    _CORNERS,
    _corner_weights,
    _use_rows,
    folded_row_interpolate,
    select_depositor,
    select_interpolator,
)
from orbitanalysis_tpu_torch.ops.deposit import (
    _deposit_x_segments,
    cic_base,
    fold_yz,
    mass_vector,
    past_key,
    strides,
    x_segments,
)
from orbitanalysis_tpu_torch.parallel.collectives import (
    all_gather,
    all_to_all,
    ppermute,
    psum,
)
from orbitanalysis_tpu_torch.parallel.sharding import take_block
from orbitanalysis_tpu_torch.utils.numerics import box_tensor, div_rn

_F32 = torch.float32


def _cell_size(box_size, like: torch.Tensor, grid: int) -> torch.Tensor:
    """``h = box_size / grid`` as a float32 tensor on ``like``'s device
    (the IEEE quotient, as a float32 ``box_size / grid`` in JAX)."""
    return div_rn(box_tensor(box_size, like), like.new_full((), float(grid)))


def _to_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=_F32, device=device)


def make_sharded_pm_grid_solver(
    mesh,
    grid: int,
    axis: str = "x",
    deconvolve: bool = False,
    smoothing_cells: float | None = None,
):
    """Build ``solve(rho, box_size, G) -> force [3, G, G, G]`` with the
    FFT pipeline sharded over ``mesh``'s ``axis``.

    ``grid`` must be divisible by the axis size.  ``rho`` is the global
    ``[G, G, G]`` density (the same on every rank); this rank solves its
    X-slab and the slabs are all-gathered back.  ``solve.local_solve(
    rho_l, box_size)`` maps this rank's ``[G / D, G, G]`` slab to its
    ``[3, G / D, G, G]`` force slab; ``solve.slab`` is ``G / D``.
    """
    n_dev = int(mesh.shape[axis])
    if grid % n_dev != 0:
        raise ValueError(f"grid {grid} not divisible by mesh axis {n_dev}")
    loc = grid // n_dev
    group = mesh.group(axis)

    # spectral coordinates (cell units), float64 on the host then float32
    kx_full = 2 * np.pi * np.fft.fftfreq(grid)
    ky_full = 2 * np.pi * np.fft.fftfreq(grid)
    kz_full = 2 * np.pi * np.fft.rfftfreq(grid)

    def local_solve(rho_l, box_size):
        """``rho_l``: ``[loc, G, G]`` this rank's X-slab; returns the
        three force slabs ``[3, loc, G, G]``."""
        i = mesh.index(axis)
        dev = rho_l.device
        rho_l = rho_l.to(_F32)
        h = _cell_size(box_size, rho_l, grid)

        rk = torch.fft.rfftn(rho_l, dim=(1, 2))            # [loc, G, Z]
        # pencil transpose: X gathered, Y scattered -> [G, loc, Z]
        rk = all_to_all(rk, group, split_axis=1, concat_axis=0)
        rk = torch.fft.fft(rk, dim=0)                       # spectral in X

        kx = _to_f32(kx_full, dev)[:, None, None]
        ky_l = _to_f32(ky_full[i * loc:(i + 1) * loc], dev)[None, :, None]
        kz = _to_f32(kz_full, dev)[None, None, :]
        k2 = kx * kx + ky_l * ky_l + kz * kz

        zero = rho_l.new_zeros(())
        green = div_rn(torch.where(
            k2 > 0, div_rn(-4 * math.pi, torch.clamp(k2, min=1e-30)), zero),
            h)
        if smoothing_cells is not None:
            # Gaussian-split long range (P3M): sigma in cell units, so
            # k (cell units) * sigma_cells == k_phys * sigma_phys
            green = green * torch.exp(
                -k2 * float(smoothing_cells) ** 2 / 2.0)
        if deconvolve:
            tp = rho_l.new_full((), 2 * math.pi)
            sx, sy, sz = (torch.sinc(div_rn(k, tp)) for k in (kx, ky_l, kz))
            w = (sx * sy * sz) ** 2
            green = div_rn(green, torch.clamp(w, min=1e-4) ** 2)
        phi_k = green.to(torch.complex64) * rk

        outs = []
        for kvec in (kx, ky_l, kz):
            grad = div_rn(kvec, h)
            fk = torch.complex(torch.zeros_like(grad), -grad) * phi_k
            fk = torch.fft.ifft(fk, dim=0)                  # back from X
            fk = all_to_all(fk, group, split_axis=0,
                            concat_axis=1)                  # -> [loc, G, Z]
            outs.append(_irfft_yz(fk, grid))
        return torch.stack(outs)                            # [3, loc, G, G]

    def solve(rho, box_size, G=1.0):
        rho = _to_f32(rho, mesh.device)
        out = local_solve(take_block(rho, (axis,), mesh), box_size)
        return G * all_gather(out, group, axis=1)

    solve.local_solve = local_solve  # shared by the full force path
    solve.slab = loc
    return solve


def _irfft_yz(fk: torch.Tensor, grid: int) -> torch.Tensor:
    """``irfftn(fk, s=(grid, grid), dim=(1, 2))`` with NumPy's meaning on
    every backend: the inverse FFT over Y, then the real inverse over Z
    with the imaginary parts of the zero and (even grids) Nyquist Z bins
    ignored, as pocketfft ignores them.  The spectral gradient leaves its
    Nyquist planes non-Hermitian, and cuFFT's one- and two-dimensional
    real inverses read those parts: on an H100 at 256^3 they moved the
    forces by 2e-3 to 4e-2 of their maximum (its three-dimensional one
    agrees with NumPy's)."""
    fk = torch.fft.ifft(fk, dim=1)
    edge = [0] + ([grid // 2] if grid % 2 == 0 else [])
    fk[..., edge] = torch.complex(fk[..., edge].real,
                                  torch.zeros_like(fk[..., edge].real))
    return torch.fft.irfft(fk, n=grid, dim=2)


def _check_global(pos, box_size, n_dev):
    if box_size is None:
        raise ValueError("PM forces require a periodic box_size")
    n = pos.shape[0]
    if n % n_dev != 0:
        raise ValueError(
            f"particle count {n} not divisible by mesh axis {n_dev}; "
            "pad with zero-mass particles")


def _scatter_drop(size: int, dest: torch.Tensor, v: torch.Tensor):
    """``zeros(size).at[dest].set(v, mode='drop')`` where every dropped
    lane has ``dest == size``: the lanes go to one dump element past the
    end, which is sliced off."""
    out = v.new_zeros((size + 1,) + tuple(v.shape[1:]))
    out[dest] = v
    return out[:size]


def _ring(n_dev: int, step: int):
    """The ``(src, dst)`` pairs of the ring ``d -> (d + step) % n_dev``."""
    return [(d, (d + step) % n_dev) for d in range(n_dev)]


def _bucket_cap(bucket_factor: float, n_l: int, n_dev: int) -> int:
    """Lanes a rank sends each slab owner: ``bucket_factor * n_l /
    n_dev`` rounded up to 128, at least 128."""
    return max(128, int(np.ceil(bucket_factor * n_l / n_dev / 128)) * 128)


def _route(pos_l, mass_l, grid, box, loc, n_dev, cap, group):
    """Step 1 of the slab-resident force: each particle to its slab
    owner through one fixed-capacity ``all_to_all`` (stable sort by
    owner, scatter into ``[n_dev, cap]`` buckets, zero-mass padding).
    Returns ``(lanes [n_dev * cap, 4]`` (x, y, z, mass) received, ``ok``
    (the particle fit its bucket), ``slot``, ``idx_s)`` in owner order."""
    dev = pos_l.device
    n_l = pos_l.shape[0]
    nr = n_dev * cap
    owner = cic_base(pos_l, grid, box)[0][:, 0] // loc            # [n_l]
    owner_s, idx_s = torch.sort(owner, stable=True)
    counts = torch.bincount(owner_s, minlength=n_dev)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n_l, device=dev) - starts[owner_s]
    ok = rank < cap                                               # overflow
    slot = torch.where(ok, owner_s * cap + rank, nr)
    payload = torch.cat([pos_l[idx_s], mass_l[idx_s, None]], dim=1)
    # exchange: segment j of the local buffer -> rank j (one collective
    # for the four planes JAX moves one by one)
    lanes = all_to_all(_scatter_drop(nr, slot, payload).reshape(
        n_dev, cap, 4), group).reshape(nr, 4)
    return lanes, ok, slot, idx_s


def _slab_stream(lx0, i0, f, bm, grid, loc):
    """The routed lanes' deposit stream on this rank's slab: ``(skeys
    [nr] int64, fracs [4, nr]`` (fx, fy, fz, m), ``planes, n_seg)``, the
    stream sorted by key and cut into ``n_seg`` x-segments of ``planes``
    planes (:func:`~orbitanalysis_tpu_torch.ops.deposit.x_segments`).

    A live lane (mass, local base plane ``lx0`` in ``[0, loc)``) takes
    the key ``lx0 * sx + by * sy + bz`` on the full grid's virtual
    strides ``(sx, sy) = strides(G)``; a dead one (bucket padding, a
    particle of another slab) a key past the block
    (:func:`~orbitanalysis_tpu_torch.ops.deposit.past_key`), so it sorts
    last, deposits nothing and is never read by K13.  The stable sort
    leaves each cell's lanes in routed-lane order (the all-to-all's
    rank-major segments, each in its source rank's stable owner order),
    fixed for a given world."""
    sx, sy = strides(grid)
    planes, n_seg = x_segments(grid, loc)
    dead = past_key(grid, planes, n_seg)
    live = (bm != 0) & (lx0 >= 0) & (lx0 < loc)
    key = torch.where(live, lx0 * sx + i0[:, 1] * sy + i0[:, 2], dead)
    skeys, order = torch.sort(key, stable=True)
    fracs = torch.stack([f[:, 0], f[:, 1], f[:, 2], bm])[:, order]
    return skeys, fracs, planes, n_seg


def _slab_deposit(lx0, i0, f, bm, grid, loc):
    """Step 2's deposit, in a fixed order: the routed lanes' CIC mass on
    this rank's X-slab and one halo plane, ``[loc + 1, G, G]`` (plane
    ``loc`` is the halo plane the ``+1`` neighbour adds), from each
    lane's base cell ``i0``, local base plane ``lx0``, fractions ``f``
    and mass ``bm``: K13 (CUDA tensors; its plain version on CPU tensors)
    sums the sorted stream (:func:`_slab_stream`) onto the flat ``[loc +
    1, G + 1, G + 1]`` block in x-segments whose keys fit int32, and the
    y and z ``== G`` faces are folded."""
    skeys, fracs, planes, n_seg = _slab_stream(lx0, i0, f, bm, grid, loc)
    flat = _deposit_x_segments(skeys, fracs, grid, planes, n_seg)[0]
    sx = strides(grid)[0]
    return fold_yz(flat[:(loc + 1) * sx].reshape(loc + 1, grid + 1,
                                                 grid + 1))


def make_slab_resident_pm_force_fn(
    mesh,
    grid: int,
    axis: str = "x",
    deconvolve: bool = False,
    bucket_factor: float = 4.0,
    p3m_sigma_cells: float | None = None,
    p3m_cutoff_sigmas: float = 3.5,
    p3m_cell_factor: float = 4.0,
    assignment: str = "auto",
):
    """Fully grid-resident distributed PM: per-rank memory is
    ``O(grid^3 / n_dev)``, the configuration for meshes that cannot be
    held on one card (a ``2048^3`` float32 field of three components is
    103 GB against the H100's 80 GB).

    Pipeline on each rank of ``axis``:

      1. the rank computes its particles' owner slab and routes them
         with one fixed-capacity ``all_to_all`` (stable sort by owner,
         scatter into ``[n_dev, cap]`` buckets, zero-mass padding);
      2. CIC deposit onto the local X-slab ``[loc+1, G, G]`` (one halo
         plane) in a fixed order (:func:`_slab_deposit`, K13 on the
         card), the halo summed into the +1 neighbour by ``ppermute``;
      3. the pencil FFT solve on the slab (``local_solve``);
      4. the neighbour's first force plane is fetched by ``ppermute``
         (reverse direction) so interpolation sees ``[3, loc+1, G, G]``;
      5. forces ride the ``all_to_all`` back and are unsorted to the
         original particle order.

    ``bucket_factor`` scales the per-destination bucket capacity ``cap =
    bucket_factor * n_local / n_dev`` (rounded up to 128).  Particles
    overflowing a bucket are dropped from the solve and receive **NaN**
    force (the NaN reaches their positions on the next integrator step);
    ``force.slab_occupancy(pos, box_size)`` returns the per-slab particle
    counts for sizing it.

    ``p3m_sigma_cells`` switches the solver to distributed **P3M** (pass
    ``deconvolve=True`` with it): the PM long range is Gaussian-smoothed
    and the erfc short-range pair correction is computed on a slab-local
    cell grid whose boundary cell planes are exchanged by ``ppermute``.
    Each rank's slab must be at least one cutoff wide (``box / n_dev >=
    cutoff_sigmas * sigma``).

    ``force(pos, mass, box_size, G=1.0, softening=0.0)`` takes the global
    arrays (see the module's contract); ``force.local`` takes this rank's
    block.
    """
    rows_interp = _use_rows(assignment)

    solver = make_sharded_pm_grid_solver(
        mesh, grid, axis=axis, deconvolve=deconvolve,
        smoothing_cells=p3m_sigma_cells,
    )
    loc = solver.slab
    n_dev = int(mesh.shape[axis])
    group = mesh.group(axis)
    fwd, bwd = _ring(n_dev, 1), _ring(n_dev, -1)

    def local_force(pos_l, mass_l, box_size, softening=0.0):
        i = mesh.index(axis)
        dev = pos_l.device
        n_l = pos_l.shape[0]
        cap = _bucket_cap(bucket_factor, n_l, n_dev)
        nr = n_dev * cap
        box = float(box_size)
        h = _cell_size(box, pos_l, grid)

        # ---- 1. route particles to their slab owner ----
        b, ok, slot, idx_s = _route(pos_l, mass_l, grid, box, loc, n_dev,
                                    cap, group)
        pos_r, bm = b[:, :3], b[:, 3]

        # ---- 2. slab deposit with one halo plane (fixed order) ----
        i0, f = cic_base(pos_r, grid, box)
        lx0 = i0[:, 0] - i * loc                  # [0, loc) for routed
        w8 = _corner_weights(f)                   # [nr, 8]
        rho_ext = _slab_deposit(lx0, i0, f, bm, grid, loc)
        halo = ppermute(rho_ext[loc], group, fwd)
        rho_slab = rho_ext[:loc].clone()
        rho_slab[0] += halo

        # ---- 3. pencil FFT solve on the slab ----
        force_slab = solver.local_solve(rho_slab, box)     # [3, loc, G, G]

        # ---- 4. extend with the neighbour's first plane, interpolate ----
        nxt = ppermute(force_slab[:, 0].contiguous(), group, bwd)
        field_ext = torch.cat([force_slab, nxt[:, None]], dim=1)
        n_loc_cells = loc * grid * grid
        if rows_interp:
            # folded corner-table row gather over the local slab: corner
            # (dx, dy, dz)'s value at local cell (lx, y, z) lives at
            # field_ext[comp, lx+dx, y+dy, z+dz]; y/z rolls are
            # box-periodic, the x shift reads the halo plane
            fold = 16
            while n_loc_cells % fold:
                fold //= 2
            table = torch.zeros((n_loc_cells // fold, 24 * fold),
                                dtype=_F32, device=dev)
            for comp in range(3):
                for ci, (dx, dy, dz) in enumerate(_CORNERS):
                    col = torch.roll(field_ext[comp], (-dy, -dz),
                                     dims=(1, 2))[dx:loc + dx]
                    k = (comp * 8 + ci) * fold
                    table[:, k:k + fold] = col.reshape(-1, fold)
            # each lane's base cell; out-of-slab lanes (bucket padding)
            # clamp: finite garbage in lanes the return path drops
            base = (lx0 * grid + i0[:, 1]) * grid + i0[:, 2]
            acc_r = folded_row_interpolate(
                table, torch.clamp(base, 0, n_loc_cells - 1), w8, fold)
        else:
            fflat = field_ext.reshape(3, -1)
            size = fflat.shape[1]
            acc = []
            for c in range(3):
                a = None
                for q, (dx, dy, dz) in enumerate(_CORNERS):
                    flat = _corner_flat(lx0, i0, grid, (dx, dy, dz))
                    inb = (flat >= 0) & (flat < size)
                    v = torch.where(inb, fflat[c][torch.clamp(
                        flat, 0, size - 1)], 0.0) * w8[:, q]
                    a = v if a is None else a + v
                acc.append(a)
            acc_r = torch.stack(acc, dim=-1)                     # [nr, 3]

        if p3m_sigma_cells is not None:
            acc_r = acc_r + _p3m_short_range(
                pos_r, bm, i0[:, 0] - i * loc, h, box, softening, nr,
                dev)

        # ---- 5. route forces back, restore original order ----
        acc_b = all_to_all(acc_r.reshape(n_dev, cap, 3),
                           group).reshape(nr, 3)
        # overflowed particles were dropped from the solve: NaN (loud,
        # reaches positions at once), never a silently wrong zero
        nan = acc_b.new_full((), float("nan"))
        acc_sorted = torch.where(ok[:, None],
                                 acc_b[torch.where(ok, slot, 0)], nan)
        out = torch.zeros((n_l, 3), dtype=_F32, device=dev)
        out[idx_s] = acc_sorted
        return out

    def _p3m_short_range(pos_r, bm, local_pm, h, box, softening, nr, dev):
        """The erfc short range of the routed lanes on the slab-local
        cell grid: ``[nr, 3]`` (NaN for a real particle past its cell's
        capacity, zero for padding)."""
        i = mesh.index(axis)
        sigma = p3m_sigma_cells * h
        r_cut = p3m_cutoff_sigmas * sigma
        # global SR cell count: divisible by n_dev, cells >= r_cut, from
        # the PM geometry (cells of sr_cells PM cells each)
        sr_cells = int(np.ceil(p3m_cutoff_sigmas * p3m_sigma_cells))
        c_dims = grid // sr_cells
        c_dims = max(n_dev, (c_dims // n_dev) * n_dev)
        if grid / c_dims < p3m_cutoff_sigmas * p3m_sigma_cells:
            raise ValueError(
                f"P3M cell grid {c_dims} too fine for the cutoff "
                f"({p3m_cutoff_sigmas}x{p3m_sigma_cells} PM cells) "
                f"with {n_dev} devices; reduce devices or sigma"
            )
        c_loc = c_dims // n_dev
        mean = nr / (c_loc * c_dims * c_dims)
        cap_sr = max(8, int(np.ceil(p3m_cell_factor * mean / 8)) * 8)

        # slab-aligned binning: the x bin derives from the routing's own
        # floor/mod arithmetic, so every routed real particle is local;
        # the slab's last x-cell absorbs any remainder
        lx = torch.clamp(torch.div(local_pm, sr_cells, rounding_mode="floor"),
                         max=c_loc - 1)
        boxt = box_tensor(box, pos_r)
        gy, gz = (torch.clamp((div_rn(pos_r[:, k], boxt) * c_dims).to(
            torch.int64), max=c_dims - 1) for k in (1, 2))
        lcid = (lx * c_dims + gy) * c_dims + gz
        # zero-mass lanes (bucket padding, zero-mass count padding) take
        # the long range only
        in_slab = (local_pm >= 0) & (local_pm < loc) & (bm > 0)
        c3l = c_loc * c_dims * c_dims
        key = torch.where(in_slab, lcid, c3l)
        lcid_s, order_sr = torch.sort(key, stable=True)
        counts_sr = torch.bincount(lcid_s, minlength=c3l + 1)[:c3l]
        starts_sr = torch.cumsum(counts_sr, 0) - counts_sr
        rank_sr = (torch.arange(nr, device=dev)
                   - starts_sr[torch.clamp(lcid_s, 0, c3l - 1)])
        ok_sr = (rank_sr < cap_sr) & (lcid_s < c3l)
        # the layout's width: the fullest cell of any rank, at most cap_sr
        most = all_gather(counts_sr.max().reshape(1), group)
        width = max(1, min(cap_sr, int(most.max())))
        dest = torch.where(ok_sr, lcid_s * width + rank_sr, c3l * width)

        def to_cells(v):
            return _scatter_drop(c3l * width, dest, v[order_sr])

        cpos = to_cells(pos_r).reshape(c3l, width, 3)
        cmass = to_cells(bm).reshape(c3l, width)

        # extend the slab with the neighbours' boundary cell planes
        gp = cpos.reshape(c_loc, c_dims, c_dims, width, 3)
        gm = cmass.reshape(c_loc, c_dims, c_dims, width)
        left = ppermute(torch.cat([gp[c_loc - 1], gm[c_loc - 1, ..., None]],
                                  dim=-1), group, fwd)
        right = ppermute(torch.cat([gp[0], gm[0, ..., None]], dim=-1),
                         group, bwd)
        ext_p = torch.cat([left[None, ..., :3], gp, right[None, ..., :3]])
        ext_m = torch.cat([left[None, ..., 3], gm, right[None, ..., 3]])

        yz_offsets = sorted({
            (dy % c_dims, dz % c_dims)
            for dy in (-1, 0, 1) for dz in (-1, 0, 1)
        })
        # x offsets deduplicated as p3m's roll offsets: for tiny global
        # cell counts the left and right halo planes alias the same
        # source cells and would double-count
        x_offsets = ((-1, 0, 1) if c_dims >= 3 else (0, 1) if c_dims == 2
                     else (0,))
        batch = max(1, _PAIR_ELEMS // (width * width))
        acc_sr = torch.zeros((c3l, width, 3), dtype=_F32, device=dev)
        for dx in x_offsets:
            sx_p = ext_p[1 + dx:1 + dx + c_loc]
            sx_m = ext_m[1 + dx:1 + dx + c_loc]
            for dy, dz in yz_offsets:
                src_p = torch.roll(sx_p, (dy, dz), dims=(1, 2)).reshape(
                    c3l, width, 3)
                src_m = torch.roll(sx_m, (dy, dz), dims=(1, 2)).reshape(
                    c3l, width)
                for c0 in range(0, c3l, batch):
                    sl = slice(c0, c0 + batch)
                    acc_sr[sl] += short_range_pair_block(
                        cpos[sl], src_p[sl], src_m[sl], boxt, sigma, r_cut,
                        softening)
        acc_sr = acc_sr.reshape(c3l * width, 3)
        bm_s = bm[order_sr]
        zero = bm.new_zeros(())
        sr_sorted = torch.where(
            ok_sr[:, None], acc_sr[torch.where(ok_sr, dest, 0)],
            # cell overflow of a real particle: NaN (loud); padding adds
            # no short range
            torch.where(bm_s[:, None] > 0, float("nan"), zero))
        out = torch.zeros((nr, 3), dtype=_F32, device=dev)
        out[order_sr] = sr_sorted
        return out

    def local(pos_l, mass_l, box_size=None, G=1.0, softening=0.0, **_):
        """The block body: accelerations of this rank's block ``pos_l
        [n_l, 3]`` (``n_l`` the same on every rank)."""
        if box_size is None:
            raise ValueError("PM forces require a periodic box_size")
        pos_l = _to_f32(pos_l, mesh.device)
        mass_l = mass_vector(mass_l, pos_l.shape[0], pos_l).to(_F32)
        return G * local_force(pos_l, mass_l, box_size, softening)

    def force(pos, mass, box_size=None, G=1.0, softening=0.0, **_):
        _check_global(pos, box_size, n_dev)
        pos = _to_f32(pos, mesh.device)
        mass = mass_vector(mass, pos.shape[0], pos)
        acc = local(take_block(pos, (axis,), mesh),
                    take_block(mass, (axis,), mesh), box_size, G=G,
                    softening=softening)
        return all_gather(acc, group, axis=0)

    def slab_occupancy(pos, box_size):
        """Per-slab particle counts (host helper for bucket sizing)."""
        if isinstance(pos, torch.Tensor):
            pos = pos.detach().cpu().numpy()
        h = float(box_size) / grid
        cx = np.mod(np.floor(np.asarray(pos)[:, 0] / h - 0.5), grid)
        return np.bincount((cx // loc).astype(np.int64), minlength=n_dev)

    force.local = local
    force.slab_occupancy = slab_occupancy
    force.slab = loc
    return force


def _corner_flat(lx0, i0, grid, corner):
    """Flat slab index of one CIC corner: local x ``lx0 + dx`` (``loc``
    is the halo plane), y and z periodic."""
    dx, dy, dz = corner
    iy = torch.remainder(i0[:, 1] + dy, grid)
    iz = torch.remainder(i0[:, 2] + dz, grid)
    return ((lx0 + dx) * grid + iy) * grid + iz


def make_sharded_pm_force_fn(
    mesh,
    grid: int,
    axis: str = "x",
    deconvolve: bool = False,
    assignment: str = "auto",
):
    """Fully distributed PM forces: particles and the FFT sharded over
    one mesh axis.

    Each rank CIC-deposits its own block onto a full local mesh (the
    single-device PM's ``deposit='auto'``: K13 on CUDA tensors, in a
    fixed order), a ``psum`` combines the meshes, each rank solves its
    X-slab through the pencil FFT, the force slabs are all-gathered, and
    each rank interpolates its own block.  Per-rank memory is O(grid^3)
    (the mesh) while the particle work is split, the configuration for
    1e8+ particles on moderate grids.

    Returns ``force(pos, mass, box_size=..., G=...)`` on the global
    arrays (see the module's contract; ``force.local`` takes this rank's
    block); the particle count must divide by the axis size.
    """
    cic_interpolate = select_interpolator(assignment)
    depositor = select_depositor("auto", grid)

    solver = make_sharded_pm_grid_solver(
        mesh, grid, axis=axis, deconvolve=deconvolve
    )
    n_dev = int(mesh.shape[axis])
    group = mesh.group(axis)

    def local(pos_l, mass_l, box_size=None, G=1.0, **_):
        if box_size is None:
            raise ValueError("PM forces require a periodic box_size")
        pos_l = _to_f32(pos_l, mesh.device)
        box = float(box_size)
        rho = depositor(pos_l, mass_l, grid, box)
        rho = psum(rho, group)                      # full mesh, all ranks
        force_slab = solver.local_solve(take_block(rho, (axis,), mesh), box)
        field = all_gather(force_slab, group, axis=1)         # [3, G, G, G]
        return G * cic_interpolate(field, pos_l, grid, box)

    def force(pos, mass, box_size=None, G=1.0, **_):
        _check_global(pos, box_size, n_dev)
        pos = _to_f32(pos, mesh.device)
        mass = mass_vector(mass, pos.shape[0], pos)
        acc = local(take_block(pos, (axis,), mesh),
                    take_block(mass, (axis,), mesh), box_size, G=G)
        return all_gather(acc, group, axis=0)

    force.local = local
    return force
