"""Sorted-stream cloud-in-cell deposit (twin of
``orbitanalysis_tpu/ops/pallas_deposit.py``: ``cic_deposit_sorted`` and
``cic_deposit_sorted_slabs``, whose assembly kernel is K13).

The deposit runs in three parts, as in the JAX package:

1. :func:`sorted_stream` (plain torch): each particle's base cell on a
   *virtual* ``(G+1)^3`` grid (corner indices run to ``G`` unwrapped, so
   the 8 corner offsets are one static stride set), the key
   ``bx * sx + by * sy + bz`` with ``(sx, sy) =`` :func:`strides`, the
   fractions toward the +1 neighbours and the mass, sorted by key with a
   stable ``torch.sort`` (the JAX package sorts unstably);
2. :func:`deposit_stream` (K13): the 8 trilinear weights of every entry
   added onto the flat virtual grid.  On CUDA tensors it launches the
   kernel ``deposit_sorted`` (``csrc/deposit.cu``: binary searches find
   where each row of ``G+1`` cells starts in the stream, then a block
   walks a run of rows, sums each run of equal keys in stream order in
   a two-row shared-memory ring and writes each cell's 8 corners in a
   fixed order; no atomics), on CPU tensors its plain version
   :func:`deposit_stream_torch`, which adds in the same orders: the two
   equal bit for bit.  Nothing falls back;
3. :func:`fold_virtual` (plain torch): the three ``== G`` faces folded
   onto plane 0, the real ``[G, G, G]`` density.

The cell index divides by the cell size through
:func:`~orbitanalysis_tpu_torch.utils.numerics.div_rn`, the IEEE float32
quotient on every backend: a CUDA division by a CPU scalar is a
reciprocal multiply, which moves ``floor`` for particles on a cell
boundary.

On the card the virtual grid lies in device memory (0.54 GB at 512^3;
the kernel's scratch is 8 bytes a row of cells), so there is no VMEM
budget and no window loop: :func:`cic_deposit_sorted` runs one kernel
call at every grid whose flat keys fit int32 (``(G+1)^3 < 2^31``, G <=
1289).
:func:`cic_deposit_sorted_slabs` keeps the JAX slab form's results and
overflow contract (NaN when a slab's population exceeds ``headroom * N /
n_slabs``, counted as the JAX package counts it, its chunk padding
included) and runs the same kernel on each slab's segment.
"""

from __future__ import annotations

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.utils.numerics import div_rn

#: The JAX kernel's stream chunk: its padding enters the slab overflow
#: count (``pallas_deposit.py:_CHUNK``).
_CHUNK = 2048


def strides(grid: int) -> tuple[int, int]:
    """Virtual-grid flattening strides (x, y); the z stride is 1."""
    return (grid + 1) * (grid + 1), grid + 1


def _offsets(grid: int) -> tuple[int, ...]:
    """Flat offsets of the 8 corners, (dx, dy, dz) lexicographic."""
    sx, sy = strides(grid)
    return tuple(dx * sx + dy * sy + dz
                 for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))


def deposit_supported(grid: int) -> bool:
    """True when the virtual ``(grid+1)^3`` grid's flat keys fit int32:
    the card's only limit on the single-call deposit (there is no VMEM
    budget; the grid lies in device memory)."""
    gv = grid + 1
    return grid >= 1 and gv * gv * gv < 2**31


def deposit_slab_supported(grid: int) -> bool:
    """True when the slab form applies: the same int32 key range."""
    return deposit_supported(grid)


def mass_vector(mass, n: int, like: torch.Tensor) -> torch.Tensor:
    """``mass`` (a scalar or ``[N]``) as an ``[N]`` tensor of ``like``'s
    dtype on its device; a scalar is filled there (a host copy would
    wait for the stream)."""
    if isinstance(mass, torch.Tensor):
        return mass.to(device=like.device, dtype=like.dtype).reshape(-1) \
            .expand(n)
    m = np.asarray(mass, np.float64)
    if m.ndim == 0:
        return like.new_full((n,), float(m))
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


def cic_base(pos: torch.Tensor, grid: int, box_size):
    """Base (floor) cell of each particle on the periodic grid and its
    fractions toward the +1 neighbours: ``(i0 [N, 3] int64 in [0, grid),
    f [N, 3] float32)``, from the cell-centred coordinates ``pos / h -
    0.5`` with the IEEE quotient (``h`` the float32 cell size)."""
    pos = pos.to(torch.float32)
    x = div_rn(pos, pos.new_full((), float(box_size) / grid)) - 0.5
    i0 = torch.floor(x)
    return torch.remainder(i0.to(torch.int64), grid), x - i0


def sorted_stream(pos: torch.Tensor, mass, grid: int, box_size):
    """Cell-sorted deposit stream: ``(skeys [N] int32, fracs [4, N] f32)``
    (``fx, fy, fz, m``), stably sorted by base-cell key; ``mass`` a
    scalar or ``[N]``."""
    n = pos.shape[0]
    pos = pos.to(torch.float32)
    base, f = cic_base(pos, grid, box_size)
    sx, sy = strides(grid)
    keys = base[:, 0] * sx + base[:, 1] * sy + base[:, 2]
    m = mass_vector(mass, n, pos)
    skeys, order = torch.sort(keys, stable=True)
    fracs = torch.stack([f[:, 0], f[:, 1], f[:, 2], m])[:, order]
    return skeys.to(torch.int32), fracs.contiguous()


def _corner_weights8(fracs: torch.Tensor) -> torch.Tensor:
    """``[8, N]`` weights of the stream entries, each product left to
    right in the kernel's order (``pallas_deposit.py:156-169``)."""
    fx, fy, fz, m = fracs
    wx0, wx1 = (1.0 - fx) * m, fx * m
    wy0, wy1 = 1.0 - fy, fy
    wz0, wz1 = 1.0 - fz, fz
    return torch.stack([
        wx0 * wy0 * wz0, wx0 * wy0 * wz1, wx0 * wy1 * wz0, wx0 * wy1 * wz1,
        wx1 * wy0 * wz0, wx1 * wy0 * wz1, wx1 * wy1 * wz0, wx1 * wy1 * wz1,
    ])


def deposit_stream_torch(skeys: torch.Tensor, fracs: torch.Tensor,
                         grid: int, n_cells: int | None = None):
    """Plain-torch twin of the K13 kernel: the sorted stream's weights
    on the flat virtual grid ``[n_cells]`` f32 (default ``(G+1)^3``).

    Each run of equal keys is summed in stream order starting from 0
    (the entries of rank r in their runs are added together, one
    deterministic scatter to distinct keys per rank), then each cell
    adds its 8 corners in corner order: the kernel's arithmetic.  Keys
    outside ``[0, n_cells)`` deposit nothing."""
    if n_cells is None:
        n_cells = (grid + 1) ** 3
    dev = skeys.device
    keys = skeys.reshape(-1).to(torch.int64)
    n = keys.shape[0]
    w8 = _corner_weights8(fracs.to(torch.float32))
    r8 = torch.zeros((8, n_cells), dtype=torch.float32, device=dev)
    if n:
        idx = torch.arange(n, device=dev)
        head = torch.ones(n, dtype=torch.bool, device=dev)
        head[1:] = keys[1:] != keys[:-1]
        rank = idx - torch.cummax(torch.where(head, idx, 0), dim=0).values
        ok = (keys >= 0) & (keys < n_cells)
        for r in range(int(rank.max()) + 1):
            sel = torch.nonzero((rank == r) & ok).reshape(-1)
            k = keys[sel]
            r8[:, k] = r8[:, k] + w8[:, sel]
    out = torch.zeros(n_cells, dtype=torch.float32, device=dev)
    for q, off in enumerate(_offsets(grid)):
        if off < n_cells:
            out[off:] = out[off:] + r8[q, :n_cells - off]
    return out


def deposit_stream(skeys: torch.Tensor, fracs: torch.Tensor, grid: int,
                   n_cells: int | None = None) -> torch.Tensor:
    """The sorted stream on the flat virtual grid ``[n_cells]`` (K13):
    the CUDA kernel on CUDA tensors, :func:`deposit_stream_torch` on CPU
    tensors."""
    if n_cells is None:
        n_cells = (grid + 1) ** 3
    if _cuda.on_cpu(skeys, "deposit"):
        return deposit_stream_torch(skeys, fracs, grid, n_cells)
    sx, sy = strides(grid)
    return _cuda.deposit_sorted(
        skeys.reshape(-1).to(torch.int32).contiguous(),
        fracs.to(torch.float32).contiguous(), int(n_cells), sx, sy)


def fold_virtual(flat: torch.Tensor, grid: int) -> torch.Tensor:
    """Fold the three ``== G`` faces of the virtual mesh onto plane 0 and
    return the real ``[G, G, G]`` density (x, then y, then z; plane 0
    plus plane G, as the JAX fold adds)."""
    gv = grid + 1
    v = flat[: gv * gv * gv].reshape(gv, gv, gv)
    x = v[:grid].clone()
    x[0] = x[0] + v[grid]
    y = x[:, :grid].clone()
    y[:, 0] = y[:, 0] + x[:, grid]
    z = y[:, :, :grid].clone()
    z[:, :, 0] = z[:, :, 0] + y[:, :, grid]
    return z


def _unsupported(grid: int) -> ValueError:
    gv = grid + 1
    return ValueError(
        f"grid {grid}^3: the virtual {gv}^3 mesh's flat keys exceed int32, "
        "for the single call and the slab partitioning alike; use the "
        "scatter deposit (models.pm.cic_deposit) for this mesh")


def cic_deposit_sorted(pos: torch.Tensor, mass, grid: int, box_size, *,
                       slab_headroom: float = 2.0) -> torch.Tensor:
    """Cloud-in-cell deposit onto a periodic ``[grid]^3`` mesh through the
    sorted-stream kernel: one K13 launch at every supported grid.  Drop-in
    for :func:`orbitanalysis_tpu_torch.models.pm.cic_deposit`, the same
    adds in another order; ``mass`` a scalar or ``[N]``.

    ``slab_headroom`` is the JAX keyword: the ``headroom`` its slab
    fallback gets past the VMEM budget (:func:`cic_deposit_sorted_slabs`).
    The card has no such budget, so this function never takes the slab
    form and the value changes nothing, as it changes nothing in JAX at a
    grid that fits its VMEM."""
    if not deposit_supported(grid):
        raise _unsupported(grid)
    skeys, fracs = sorted_stream(pos, mass, grid, box_size)
    return fold_virtual(deposit_stream(skeys, fracs, grid), grid)


#: The slab count ``n_slabs=None`` takes.
DEFAULT_SLABS = 2


def cic_deposit_sorted_slabs(pos: torch.Tensor, mass, grid: int, box_size,
                             *, n_slabs: int | None = None,
                             headroom: float = 2.0) -> torch.Tensor:
    """The sorted deposit by X-plane slabs of the one sorted stream (the
    JAX package's form for grids past its VMEM budget).

    The cell-major sort groups particles by x-plane, so the stream
    splits into ``n_slabs`` contiguous segments of ``ceil(G / n_slabs)``
    planes each.  Each segment's keys are rebased to its slab, deposited
    by the same kernel onto a slab-sized virtual block (the slab's
    planes plus the corner reach ``sx + sy + 1``) and added into the
    flat virtual grid; neighbouring blocks overlap only in that margin.

    The JAX overflow contract holds: each slab's segment holds at most
    ``headroom * N / n_slabs`` entries (rounded up to the JAX kernel's
    2048-entry chunks, its chunk padding counted in the last slab), and
    a slab past it makes the whole result NaN (fail loud).

    ``n_slabs=None`` takes :data:`DEFAULT_SLABS` (2).  The JAX package
    takes the fewest power of two from 2 up whose slab fits its VMEM
    budget, which is 2 at every grid it can hold whole; the card has no
    such budget (K13's scratch is 8 bytes a row of cells, whatever the
    slab), so the port takes 2 at every grid."""
    if not deposit_slab_supported(grid):
        raise _unsupported(grid)
    if n_slabs is None:
        n_slabs = DEFAULT_SLABS
    sx, sy = strides(grid)
    gv3 = (grid + 1) ** 3
    slab_x = -(-grid // n_slabs)
    reach = sx + sy + 1
    skeys, fracs = sorted_stream(pos, mass, grid, box_size)
    n = skeys.shape[0]
    npad = -(-n // _CHUNK) * _CHUNK
    seg_cap = min(npad, -(-int(npad * headroom) // (n_slabs * _CHUNK))
                  * _CHUNK)
    bounds = torch.arange(1, n_slabs, device=skeys.device) * (slab_x * sx)
    cuts = [0, *torch.searchsorted(skeys.to(torch.int64), bounds).tolist(),
            n]
    pop = [b - a for a, b in zip(cuts[:-1], cuts[1:])]
    pop[-1] += npad - n
    last = (n_slabs - 1) * slab_x * sx
    rho = torch.zeros(max(gv3, last + slab_x * sx + reach),
                      dtype=torch.float32, device=skeys.device)
    for k in range(n_slabs):
        lo = k * slab_x * sx
        v_slab = slab_x * sx + reach
        seg = slice(cuts[k], cuts[k + 1])
        block = deposit_stream(skeys[seg] - lo, fracs[:, seg], grid, v_slab)
        rho[lo:lo + v_slab] = rho[lo:lo + v_slab] + block
    v3 = fold_virtual(rho, grid)
    if max(pop) > seg_cap:
        return torch.full_like(v3, float("nan"))
    return v3
