"""The port's region and Gadget callbacks and its native surface on the
CPU against the JAX package: ``RegionExtractor`` (NumPy index and the
native grid sort past 2**18 particles) selects what JAX's selects and a
brute-force radius cut selects; ``make_region_callbacks`` and
``make_gadget_callbacks`` give JAX's loader dicts and drive the port's
``track_orbits`` to JAX's savefile; ``native.build``, ``load``,
``available`` and ``grid_count_sort_native`` behave as JAX's."""

import h5py
import numpy as np
import pytest
import torch

import orbitanalysis_tpu.engine.gadget as jgadget
import orbitanalysis_tpu.engine.regions as jregions
import orbitanalysis_tpu.native as jnative
import orbitanalysis_tpu_torch.engine as tengine
import orbitanalysis_tpu_torch.native as tnative
from orbitanalysis_tpu import track_orbits as jax_track
from orbitanalysis_tpu_torch import track_orbits

from test_engine import _assert_files_equal
from test_gadget import gadget_files  # noqa: F401
from test_regions import _brute_force

torch.set_num_threads(1)


def _assert_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


def _scene(rng, n, box, span=100.0):
    pos = rng.uniform(0, span, size=(n, 3))
    vel = rng.normal(size=(n, 3)).astype(np.float32)
    ids = rng.permutation(n).astype(np.int64)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    centers = rng.uniform(5, span - 5, size=(5, 3))
    if box is not None:
        centers[0] = [1.0, 1.0, 1.0]  # straddles the periodic boundary
    return ids, pos, vel, mass, centers, rng.uniform(3.0, 12.0, 5)


@pytest.mark.parametrize("box,cell", [(None, None), (100.0, None),
                                      (100.0, 7.0)])
def test_extractor_matches_jax_and_brute_force(rng, box, cell):
    ids, pos, vel, mass, centers, radii = _scene(rng, 20000, box)
    got = tengine.RegionExtractor(ids, pos, vel, masses=mass, box_size=box,
                                  cell_size=cell).extract(centers, radii)
    want = jregions.RegionExtractor(ids, pos, vel, masses=mass, box_size=box,
                                    cell_size=cell).extract(centers, radii)
    _assert_dicts_equal(want, got)
    offs = np.concatenate((got["region_offsets"], [len(got["ids"])]))
    for k, sel in enumerate(_brute_force(pos, centers, radii, box)):
        assert np.array_equal(np.sort(got["ids"][offs[k]:offs[k + 1]]),
                              np.sort(ids[sel])), k


def test_extractor_native_index_past_threshold(rng):
    """Past 2**18 particles the native counting sort builds the index;
    it equals JAX's index and the brute-force cut."""
    if tnative.ensure() is None or jnative.ensure() is None:
        pytest.skip("no compiler")
    n, box = (1 << 18) + 17, 100.0
    ids = np.arange(n, dtype=np.int64)
    pos = rng.uniform(0, box, size=(n, 3))
    vel = rng.normal(size=(n, 3))
    t = tengine.RegionExtractor(ids, pos, vel, box_size=box)
    j = jregions.RegionExtractor(ids, pos, vel, box_size=box)
    assert np.array_equal(t.order, j.order)
    assert np.array_equal(t.cell_starts, j.cell_starts)
    centers = rng.uniform(0, box, size=(3, 3))
    radii = np.full(3, 7.0)
    got = t.extract(centers, radii)
    _assert_dicts_equal(j.extract(centers, radii), got)
    offs = np.concatenate((got["region_offsets"], [len(got["ids"])]))
    for k, sel in enumerate(_brute_force(pos, centers, radii, box)):
        assert set(got["ids"][offs[k]:offs[k + 1]].tolist()) == set(
            ids[sel].tolist())


def test_native_surface_matches_jax(rng):
    if tnative.ensure() is None:
        pytest.skip("no compiler")
    assert tnative.build() and tnative.available()
    assert tnative.load() is tnative.ensure() and tnative.tier() == "native"
    flat = rng.integers(0, 777, 50000)
    starts, order = tnative.grid_count_sort_native(flat, 777)
    exp_order = np.argsort(flat, kind="stable")
    assert np.array_equal(order, exp_order)
    assert np.array_equal(starts, np.searchsorted(flat[exp_order],
                                                  np.arange(778)))
    if jnative.ensure() is not None:
        for a, b in zip(jnative.grid_count_sort_native(flat, 777),
                        (starts, order)):
            assert np.array_equal(a, b)


def _moving_clumps(rng, box=60.0, n=3000, n_snap=5):
    base = rng.uniform(0, box, size=(n, 3))
    snapshots, catalog = {}, {}
    for s in range(n_snap):
        drift = 0.5 * s
        snapshots[s] = dict(ids=np.arange(n),
                            coordinates=np.mod(base + drift, box),
                            velocities=rng.normal(size=(n, 3)), masses=1.0,
                            redshift=0.5, H0=0.1, Omega_m=0.3, Omega_L=0.7)
        catalog[s] = (np.array([7, 3]),
                      np.mod(np.array([[10.0 + drift] * 3,
                                       [40.0 + drift] * 3]), box),
                      np.array([8.0, 8.0]))
    return snapshots, catalog


def test_region_callbacks_match_jax_and_drive_tracker(tmp_path, rng):
    box, n_snap = 60.0, 5
    snapshots, catalog = _moving_clumps(rng, box, n_snap=n_snap)
    t_regions, t_loader = tengine.make_region_callbacks(snapshots, catalog,
                                                        box_size=box)
    j_regions, j_loader = jregions.make_region_callbacks(snapshots, catalog,
                                                         box_size=box)
    for s in range(n_snap):
        halos = np.array([3, 7])
        want, got = j_regions(s, halos), t_regions(s, halos)
        assert all(np.array_equal(a, b) for a, b in zip(want, got))
        _assert_dicts_equal(j_loader(s, *want), t_loader(s, *got))
    with pytest.raises(KeyError, match="not in the snapshot-0 catalog"):
        t_regions(0, np.array([5]))
    branches = np.tile([7, 3], (n_snap, 1))
    ref, got = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    jax_track(np.arange(n_snap), branches, j_regions, j_loader, ref,
              verbose=False)
    track_orbits(np.arange(n_snap), branches, t_regions, t_loader, got,
                 device="cpu", verbose=False)
    _assert_files_equal(ref, got)


def test_gadget_callbacks_match_jax(tmp_path, gadget_files):
    snap_fmt, cat_fmt, snaps, centers, box, n_snap, n_halos = gadget_files
    t_regions, t_loader = tengine.make_gadget_callbacks(snap_fmt, cat_fmt,
                                                        group="PartType1")
    j_regions, j_loader = jgadget.make_gadget_callbacks(snap_fmt, cat_fmt,
                                                        group="PartType1")
    halos = np.arange(n_halos)
    for s in (0, 3):
        want = j_regions(s, halos)
        assert all(np.array_equal(a, b)
                   for a, b in zip(want, t_regions(s, halos)))
        _assert_dicts_equal(j_loader(s, *want), t_loader(s, *want))
    branches = np.tile(halos, (n_snap, 1))
    ref, got = str(tmp_path / "jax.h5"), str(tmp_path / "port.h5")
    jax_track(np.arange(n_snap), branches, j_regions, j_loader, ref,
              verbose=False)
    track_orbits(np.arange(n_snap), branches, t_regions, t_loader, got,
                 device="cpu", verbose=False)
    _assert_files_equal(ref, got)


def test_gadget_flat_layout_and_cosmology(tmp_path):
    """The flat layout with no Masses dataset, a BoxSize on the file, and
    a complete cosmology set forwarded into the loader dict."""
    rng = np.random.default_rng(7)
    box, n = 50.0, 200
    snap_fmt = str(tmp_path / "flat_{:03d}.hdf5")
    cat_fmt = str(tmp_path / "cat_{:03d}.hdf5")
    for s in range(2):
        with h5py.File(snap_fmt.format(s), "w") as hf:
            hf.attrs.update(BoxSize=box, Redshift=1.0, HubbleParam=0.7,
                            Omega0=0.3)
            hf.create_dataset("ParticleIDs", data=np.arange(n))
            hf.create_dataset("Coordinates", data=np.mod(
                25.0 + rng.normal(scale=2.0, size=(n, 3)) + 0.1 * s, box))
            hf.create_dataset("Velocities", data=rng.normal(size=(n, 3)))
        with h5py.File(cat_fmt.format(s), "w") as hf:
            hf.create_dataset("position_of_minimum_potential",
                              data=np.full((1, 3), 25.0))
            hf.create_dataset("R_200crit", data=np.array([5.0]))
    for cosmo in (True, False):
        tr, tl = tengine.make_gadget_callbacks(snap_fmt, cat_fmt,
                                               cosmology_attrs=cosmo)
        jr, jl = jgadget.make_gadget_callbacks(snap_fmt, cat_fmt,
                                               cosmology_attrs=cosmo)
        got = tl(1, *tr(1, np.array([0])))
        _assert_dicts_equal(jl(1, *jr(1, np.array([0]))), got)
        assert got["masses"] == 1.0 and got["box_size"] == box
        assert ("Omega_L" in got) == cosmo
