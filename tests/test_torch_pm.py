"""The port's particle-mesh and P3M solvers (``orbitanalysis_tpu_torch.
models.pm``, ``models.p3m``) and its sorted-stream deposit
(``ops/deposit.py``, whose kernel is K13) against the JAX package on the
CPU.

Inputs are made from seeds with NumPy; the JAX deposit kernel
``cic_deposit_sorted`` runs in interpret mode, as
``tests/test_pallas_deposit.py`` runs it.  Tolerances, with their
reasons:

- deposits: the JAX test's ``rtol = atol = 2e-5`` (the same adds in
  other orders: the JAX kernel sorts unstably and reduces windows with
  one-hot products, the port sums runs in stream order);
- interpolations: 2e-5 (float32 sums of 8 corners in other orders);
  bfloat16 tables 8e-3 of the field's scale (stored-value precision);
- force fields: 1e-4 of the largest acceleration (FFTs of two
  libraries, pocketfft in XLA and in torch, agree to ~1e-6 relative;
  the deposit's order adds ~1e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbitanalysis_tpu.models import p3m as jp3m
from orbitanalysis_tpu.models import pm as jpm
from orbitanalysis_tpu.ops import pallas_deposit as jdep
from orbitanalysis_tpu_torch.models import p3m as tp3m
from orbitanalysis_tpu_torch.models import pm as tpm
from orbitanalysis_tpu_torch.ops import deposit as tdep


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seam_positions(n, grid, box, rng):
    """Random positions with the wrap and cell-boundary cases pinned
    (``tests/test_pallas_deposit.py``'s seams, plus a particle exactly
    at the box edge)."""
    h = box / grid
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    pos[:9] = np.array(
        [
            [0.0, 0.0, 0.0],
            [box - 1e-4, box - 1e-4, box - 1e-4],
            [h / 2, h / 2, h / 2],            # exact cell centre
            [h, h, h],                        # exact cell boundary
            [box - h / 2, 5.0, 5.0],          # wrap seam per axis
            [5.0, box - h / 2, 5.0],
            [5.0, 5.0, box - h / 2],
            [1e-6, box - 1e-6, box / 2],
            [box, box, box],                  # remainder() may return box
        ],
        np.float32,
    )
    return pos


def _assert_close(got, want, tol=2e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_sorted_deposit_matches_jax(rng):
    n, grid, box = 4096, 16, 10.0
    pos = _seam_positions(n, grid, box, rng)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = np.asarray(jdep.cic_deposit_sorted(jnp.asarray(pos),
                                              jnp.asarray(mass), grid, box))
    scatter = np.asarray(jpm.cic_deposit(jnp.asarray(pos), jnp.asarray(mass),
                                         grid, box))
    got = tdep.cic_deposit_sorted(_t(pos), _t(mass), grid, box)
    _assert_close(got, want)
    _assert_close(got, scatter)
    _assert_close(tpm.cic_deposit(_t(pos), _t(mass), grid, box), scatter)
    _assert_close(tpm.cic_deposit_rows(_t(pos), _t(mass), grid, box),
                  scatter)


def test_sorted_deposit_scalar_mass_and_conservation(rng):
    n, grid, box = 2048, 8, 4.0
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    want = np.asarray(jdep.cic_deposit_sorted(jnp.asarray(pos), 1.5, grid,
                                              box))
    got = tdep.cic_deposit_sorted(_t(pos), 1.5, grid, box)
    _assert_close(got, want)
    np.testing.assert_allclose(float(got.sum()), 1.5 * n, rtol=1e-5)


def test_sorted_deposit_ragged(rng):
    """N = 1000: the JAX kernel pads its stream to 2048 entries; the
    port's stream is the N entries."""
    n, grid, box = 1000, 8, 4.0
    pos = rng.uniform(0, box, size=(n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    keys, fracs = tdep.sorted_stream(_t(pos), _t(mass), grid, box)
    assert keys.shape == (n,) and fracs.shape == (4, n)
    assert bool((keys[1:] >= keys[:-1]).all())
    want = np.asarray(jdep.cic_deposit_sorted(jnp.asarray(pos),
                                              jnp.asarray(mass), grid, box))
    _assert_close(tdep.cic_deposit_sorted(_t(pos), _t(mass), grid, box),
                  want)


def test_deposit_stream_twin_against_float64(rng):
    """The kernel's plain version against a float64 NumPy deposit of the
    same stream, with runs of up to 40 equal keys (a clustered cell)."""
    grid, box = 6, 3.0
    pos = rng.uniform(0, box, size=(500, 3)).astype(np.float32)
    pos[:40] = [1.1, 1.2, 1.3]
    keys, fracs = tdep.sorted_stream(_t(pos), 0.7, grid, box)
    flat = tdep.deposit_stream(keys, fracs, grid).numpy()
    want = np.zeros((grid + 1) ** 3)
    f = fracs.numpy().astype(np.float64)
    w8 = tdep._corner_weights8(torch.from_numpy(f)).numpy()
    for q, off in enumerate(tdep._offsets(grid)):
        np.add.at(want, keys.numpy().astype(np.int64) + off, w8[q])
    np.testing.assert_allclose(flat, want, rtol=1e-6, atol=1e-6)
    # keys outside [0, n_cells) deposit nothing; a cell only gathers
    # keys at or below it, so the first 50 cells are unchanged
    short = tdep.deposit_stream(keys, fracs, grid, n_cells=50).numpy()
    np.testing.assert_array_equal(short, flat[:50])


def test_deposit_stream_dead_run_and_x_segments(rng, monkeypatch):
    """Dead entries (one long run of a key past the block) deposit
    nothing and cost no loop of their own in the plain version; the
    x-segment loop with the limit lowered gives the one-call deposit
    within the deposit tolerance."""
    grid, box = 8, 4.0
    pos = rng.uniform(0, box, size=(600, 3)).astype(np.float32)
    keys, fracs = tdep.sorted_stream(_t(pos), 0.9, grid, box)
    flat = tdep.deposit_stream(keys, fracs, grid)
    n_dead = 200000
    sx, sy = tdep.strides(grid)
    # past every key row K13 reads: row j holds [j * sy - 1, (j + 1) * sy)
    past = tdep.past_key(grid, grid, 1)
    v = grid * sx + sx + sy + 1
    assert past >= -(-v // sy) * sy > v
    dead = torch.full((n_dead,), past, dtype=torch.int32)
    padded = tdep.deposit_stream(
        torch.cat([keys, dead]),
        torch.cat([fracs, torch.ones(4, n_dead)], dim=1), grid)
    assert torch.equal(padded, flat)
    assert tdep.x_segments(grid, grid) == (grid, 1)
    monkeypatch.setattr(tdep, "_SEGMENT_CELLS", 3 * sx + sx + 2 * sy)
    planes, n_seg = tdep.x_segments(grid, grid)
    assert (planes, n_seg) == (3, 3)
    seg, cuts = tdep._deposit_x_segments(keys.long(), fracs, grid, planes,
                                         n_seg)
    assert len(cuts) == n_seg + 1 and cuts[-1] == keys.shape[0]
    _assert_close(tdep.fold_virtual(seg, grid), tdep.fold_virtual(flat, grid))


@pytest.mark.parametrize("n_slabs", [2, 4, None])
def test_slab_deposit_matches_jax(rng, n_slabs):
    n, grid, box = 4096, 16, 10.0
    h = box / grid
    pos = _seam_positions(n, grid, box, rng)
    # particles whose +x corner crosses a slab boundary
    for i, bx in enumerate((3, 7, 11, 15)):
        pos[9 + i] = [(bx + 0.9) * h, 5.0, 5.0]
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = np.asarray(jdep.cic_deposit_sorted_slabs(
        jnp.asarray(pos), jnp.asarray(mass), grid, box, n_slabs=n_slabs))
    got = tdep.cic_deposit_sorted_slabs(_t(pos), _t(mass), grid, box,
                                        n_slabs=n_slabs)
    _assert_close(got, want)
    _assert_close(got, tdep.cic_deposit_sorted(_t(pos), _t(mass), grid, box))


def test_slab_count_default_matches_jax(rng):
    """``n_slabs=None``: JAX picks its count by VMEM budget, 2 at this
    grid, and the port takes 2: the same density, and the same overflow
    NaN at a headroom the default count cannot hold."""
    n, grid, box = 4096, 16, 10.0
    pos = _seam_positions(n, grid, box, rng)
    assert jdep._pick_n_slabs(grid) == tdep.DEFAULT_SLABS
    got = tdep.cic_deposit_sorted_slabs(_t(pos), 1.0, grid, box)
    assert torch.equal(got, tdep.cic_deposit_sorted_slabs(
        _t(pos), 1.0, grid, box, n_slabs=2))
    _assert_close(got, np.asarray(jdep.cic_deposit_sorted_slabs(
        jnp.asarray(pos), 1.0, grid, box)))
    crowded = rng.uniform(0, box / 8, size=(n, 3)).astype(np.float32)
    want = np.asarray(jdep.cic_deposit_sorted_slabs(
        jnp.asarray(crowded), 1.0, grid, box, headroom=1.0))
    got = tdep.cic_deposit_sorted_slabs(_t(crowded), 1.0, grid, box,
                                        headroom=1.0)
    assert np.isnan(want).all() and torch.isnan(got).all()


@pytest.mark.parametrize("slab_headroom", [0.5, 2.0, 8.0])
def test_sorted_deposit_slab_headroom_matches_jax(rng, slab_headroom):
    """``cic_deposit_sorted(slab_headroom=)``: at a grid that fits its
    VMEM the JAX call takes the single block and ignores the value, and
    so does the port at every grid (no VMEM budget): the same density as
    the default, and as JAX's with the same argument."""
    n, grid, box = 4096, 16, 10.0
    pos = _seam_positions(n, grid, box, rng)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = np.asarray(jdep.cic_deposit_sorted(
        jnp.asarray(pos), jnp.asarray(mass), grid, box,
        slab_headroom=slab_headroom))
    got = tdep.cic_deposit_sorted(_t(pos), _t(mass), grid, box,
                                  slab_headroom=slab_headroom)
    _assert_close(got, want)
    assert torch.equal(got, tdep.cic_deposit_sorted(_t(pos), _t(mass),
                                                    grid, box))


def test_slab_deposit_overflow_is_nan(rng):
    n, grid, box = 4096, 16, 10.0
    pos = rng.uniform(0, box / 8, size=(n, 3)).astype(np.float32)
    want = np.asarray(jdep.cic_deposit_sorted_slabs(
        jnp.asarray(pos), 1.0, grid, box, n_slabs=4, headroom=1.0))
    got = tdep.cic_deposit_sorted_slabs(_t(pos), 1.0, grid, box, n_slabs=4,
                                        headroom=1.0)
    assert np.isnan(want).all() and torch.isnan(got).all()
    # the default headroom holds the same stream
    ok = tdep.cic_deposit_sorted_slabs(_t(pos), 1.0, grid, box, n_slabs=2,
                                       headroom=2.0)
    assert torch.isfinite(ok).all()


def test_deposit_support_policy():
    assert tdep.deposit_supported(512) and tdep.deposit_supported(1289)
    assert not tdep.deposit_supported(1290)
    assert not tdep.deposit_slab_supported(1536)
    with pytest.raises(ValueError, match="slab"):
        tdep.cic_deposit_sorted(torch.zeros(8, 3), 1.0, 1536, 1.0)
    with pytest.raises(ValueError, match="int32"):
        tdep.cic_deposit_sorted_slabs(torch.zeros(8, 3), 1.0, 1536, 1.0)


def test_select_depositor_policy(rng):
    assert tpm.select_depositor("scatter", 256) is tpm.cic_deposit
    assert tpm.select_depositor("sorted", 512) is tdep.cic_deposit_sorted
    assert tpm.select_depositor("auto", 512) is tpm.cic_deposit_auto
    assert tpm.select_depositor("auto", 1536) is tpm.cic_deposit
    with pytest.raises(ValueError, match="int32"):
        tpm.select_depositor("sorted", 1536)
    with pytest.raises(ValueError, match="deposit must be"):
        tpm.select_depositor("bogus", 64)
    # 'auto' on CPU tensors is the scatter form, exactly
    pos = _t(rng.uniform(0, 4.0, (300, 3)).astype(np.float32))
    assert torch.equal(tpm.cic_deposit_auto(pos, 1.0, 8, 4.0),
                       tpm.cic_deposit(pos, 1.0, 8, 4.0))


def test_select_interpolator_policy():
    assert tpm.select_interpolator("auto", 512) is tpm.cic_interpolate
    assert tpm.select_interpolator("rows") is tpm.cic_interpolate_rows
    assert tpm.select_interpolator("cells") is tpm.cic_interpolate_cells
    with pytest.raises(ValueError, match="assignment must be"):
        tpm.select_interpolator("bogus")
    with pytest.raises(ValueError, match="assignment must be"):
        tpm.make_pm_force_fn(16, assignment="bogus")


def test_interpolations_match_jax(rng):
    n, grid, box = 4096, 16, 10.0
    pos = _seam_positions(n, grid, box, rng)
    field = rng.normal(size=(3, grid, grid, grid)).astype(np.float32)
    jp, jf = jnp.asarray(pos), jnp.asarray(field)
    want = np.asarray(jpm.cic_interpolate(jf, jp, grid, box))
    tp, tf = _t(pos), _t(field)
    _assert_close(tpm.cic_interpolate(tf, tp, grid, box), want)
    _assert_close(tpm.cic_interpolate_rows(tf, tp, grid, box), want)
    np.testing.assert_allclose(
        tpm.cic_interpolate_rows(tf, tp, grid, box).numpy(),
        np.asarray(jpm.cic_interpolate_rows(jf, jp, grid, box)), atol=2e-5)
    for block in (4, 2, 1, 3):
        _assert_close(tpm.cic_interpolate_cells(
            tf, tp, grid, box, block=block, table_dtype=torch.float32), want)
    scale = np.abs(want).max()
    for fn in (tpm.cic_interpolate_rows, tpm.cic_interpolate_cells):
        a16 = fn(tf, tp, grid, box, table_dtype=torch.bfloat16)
        assert a16.dtype == torch.float32
        np.testing.assert_allclose(a16.numpy(), want, atol=8e-3 * scale)
    empty = tpm.cic_interpolate_rows(tf, torch.zeros(0, 3), grid, box)
    assert empty.shape == (0, 3)


def test_constant_field_and_conservation(rng):
    pos = _t(rng.uniform(0, 10.0, size=(200, 3)).astype(np.float32))
    field = torch.stack([torch.full((16,) * 3, v) for v in (1.5, -2.0, 0.25)])
    vals = tpm.cic_interpolate(field, pos, 16, 10.0).numpy()
    np.testing.assert_allclose(vals, np.broadcast_to([1.5, -2.0, 0.25],
                                                     vals.shape), atol=1e-5)
    mass = _t(rng.uniform(0.5, 2.0, 200).astype(np.float32))
    rho = tpm.cic_deposit(pos, mass, 32, 10.0)
    assert float(rho.sum()) == pytest.approx(float(mass.sum()), rel=1e-5)


@pytest.mark.parametrize("deconvolve,smoothing", [(False, None),
                                                   (True, None),
                                                   (True, 0.9)])
def test_pm_forces_grid_matches_jax(rng, deconvolve, smoothing):
    grid, box = 16, 10.0
    rho = rng.uniform(0, 2.0, (grid,) * 3).astype(np.float32)
    want = np.asarray(jpm.pm_forces_grid(
        jnp.asarray(rho), grid, box, G=1.3, deconvolve=deconvolve,
        smoothing=smoothing))
    got = tpm.pm_forces_grid(_t(rho), grid, box, G=1.3,
                             deconvolve=deconvolve, smoothing=smoothing)
    assert got.shape == (3, grid, grid, grid) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("assignment", ["scalar", "rows", "cells"])
def test_pm_forces_match_jax(rng, assignment):
    n, grid, box = 2000, 16, 10.0
    pos = _seam_positions(n, grid, box, rng)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    want = np.asarray(jpm.pm_forces(jnp.asarray(pos), jnp.asarray(mass),
                                    grid, box, assignment="scalar"))
    scale = np.abs(want).max()
    for deposit in ("auto", "sorted", "scatter"):
        got = tpm.pm_forces(_t(pos), _t(mass), grid, box,
                            assignment=assignment, deposit=deposit)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * scale)
    f = tpm.make_pm_force_fn(grid, assignment=assignment)
    np.testing.assert_allclose(f(_t(pos), _t(mass), box_size=box).numpy(),
                               want, atol=1e-4 * scale)
    with pytest.raises(ValueError, match="periodic"):
        f(_t(pos), _t(mass))


def test_pm_inverse_square_two_body():
    grid, box = 64, 100.0
    h = box / grid
    for r, tol in ((6 * h, 0.05), (8 * h, 0.04), (10 * h, 0.03)):
        pos = torch.tensor([[50.0, 50.0, 50.0], [50.0 + r, 50.0, 50.0]])
        acc = tpm.pm_forces(pos, torch.ones(2), grid, box, G=1.0).numpy()
        expect = 1.0 / r ** 2
        assert acc[0, 0] == pytest.approx(expect, rel=tol), r
        assert acc[1, 0] == pytest.approx(-expect, rel=tol), r
        assert np.abs(acc[:, 1:]).max() < 0.05 * expect


def test_pm_momentum_conservation(rng):
    n, grid, box = 300, 32, 50.0
    pos = _t(rng.uniform(0, box, size=(n, 3)).astype(np.float32))
    mass = _t(rng.uniform(0.5, 2.0, n).astype(np.float32))
    for deposit in ("scatter", "sorted"):
        acc = tpm.pm_forces(pos, mass, grid, box, deposit=deposit).numpy()
        m = mass.numpy()[:, None]
        assert np.abs((m * acc).sum(0)).max() < 1e-3 * np.abs(
            m * acc).sum(0).max()


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(7)
    n, box = 400, 20.0
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return pos, mass, box


def test_p3m_matches_jax(cloud):
    pos, mass, box = cloud
    want = np.asarray(jax.jit(
        lambda p, m: jp3m.make_p3m_force_fn(grid=32)(
            p, m, box_size=box, softening=0.05)
    )(jnp.asarray(pos), jnp.asarray(mass)))
    got = tp3m.make_p3m_force_fn(grid=32)(_t(pos), _t(mass), box_size=box,
                                          softening=0.05).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    net = np.abs((mass[:, None] * got).sum(0))
    assert np.all(net < 1e-3 * np.abs(mass[:, None] * got).sum(0))


def test_p3m_deposits_through_cic_deposit_auto(cloud, monkeypatch):
    """``make_p3m_force_fn`` deposits through ``cic_deposit_auto`` (K13
    on CUDA tensors), which on these CPU tensors calls the scatter."""
    pos, mass, box = cloud
    calls = []
    auto, scatter = tpm.cic_deposit_auto, tpm.cic_deposit

    def spy_auto(*args, **kw):
        calls.append("auto")
        return auto(*args, **kw)

    def spy_scatter(*args, **kw):
        calls.append("scatter")
        return scatter(*args, **kw)

    monkeypatch.setattr(tpm, "cic_deposit_auto", spy_auto)
    monkeypatch.setattr(tpm, "cic_deposit", spy_scatter)
    tp3m.make_p3m_force_fn(grid=32)(_t(pos), _t(mass), box_size=box,
                                    softening=0.05)
    assert calls == ["auto", "scatter"]


def test_p3m_through_sorted_deposit_matches_jax(cloud, monkeypatch):
    """P3M with its depositor on K13's arithmetic (``cic_deposit_sorted``,
    the kernel's plain version on the CPU) still matches JAX at
    ``test_p3m_matches_jax``'s tolerance."""
    pos, mass, box = cloud
    calls = []

    def sorted_deposit(*args, **kw):
        calls.append(1)
        return tdep.cic_deposit_sorted(*args, **kw)

    monkeypatch.setattr(tpm, "cic_deposit_auto", sorted_deposit)
    want = np.asarray(jax.jit(
        lambda p, m: jp3m.make_p3m_force_fn(grid=32)(
            p, m, box_size=box, softening=0.05)
    )(jnp.asarray(pos), jnp.asarray(mass)))
    got = tp3m.make_p3m_force_fn(grid=32)(_t(pos), _t(mass), box_size=box,
                                          softening=0.05).numpy()
    assert calls == [1]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_p3m_close_pair_and_overflow():
    box, grid = 20.0, 16
    sep = 0.4 * box / grid
    pos = torch.tensor([[10.0, 10.0, 10.0], [10.0 + sep, 10.0, 10.0]])
    acc = tp3m.make_p3m_force_fn(grid=grid)(pos, torch.ones(2), box_size=box,
                                            softening=0.0).numpy()
    assert abs(abs(acc[0, 0]) - 1.0 / sep ** 2) / (1.0 / sep ** 2) < 0.05
    # more particles in a cell than cell_cap: the dropped ones get NaN,
    # as in the JAX package
    rng = np.random.default_rng(1)
    p = (10.0 + rng.uniform(0, 0.1, (20, 3))).astype(np.float32)
    f = tp3m.make_p3m_force_fn(grid=grid, cell_cap=8)
    got = f(_t(p), torch.ones(20), box_size=box).numpy()
    want = np.asarray(jax.jit(
        lambda q: jp3m.make_p3m_force_fn(grid=grid, cell_cap=8)(
            q, jnp.ones(20), box_size=box))(jnp.asarray(p)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).any() and not np.isnan(got).all()
    with pytest.raises(ValueError, match="half the box"):
        tp3m.make_p3m_force_fn(grid=4)(_t(p), torch.ones(20), box_size=box)
