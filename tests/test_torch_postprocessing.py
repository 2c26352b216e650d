"""The port's postprocessing and progenitor tools on the CPU against the
JAX package: collated catalogs (host and ``device='cpu'`` collation,
halo subsets, mid-sequence stops, final counts) equal JAX's host and
device collation dataset for dataset, from HDF5 files and from a
MemoryWriter; the decomposition equals JAX's and both plots draw; the
progenitor links and central particles equal JAX's host and device
forms, on tied radii, duplicate votes, wide IDs and no matches.
"""

import os

import h5py
import numpy as np
import pytest
import torch

import orbitanalysis_tpu.postprocessing as jpost
import orbitanalysis_tpu.progenitors as jprog
import orbitanalysis_tpu_torch.postprocessing as tpost
import orbitanalysis_tpu_torch.progenitors as tprog
from orbitanalysis_tpu import track_orbits as jax_track
from orbitanalysis_tpu.models.synthetic import churn_snapshots
from orbitanalysis_tpu_torch.engine.io_hdf5 import MemoryWriter

from helpers import make_callbacks
from test_postprocessing import _oracle_collated_counts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tracked(tmp_path_factory):
    """A JAX-tracked savefile (both packages read the same input), and
    the same file loaded into a MemoryWriter."""
    tmp = tmp_path_factory.mktemp("tpost")
    box = 60.0
    n_halos, n_snap = 3, 8
    snaps, centers = churn_snapshots(n_halos, 150, n_snap, box_size=box,
                                     seed=17)
    regions, loader = make_callbacks(snaps, centers, box_size=box)
    save = str(tmp / "orbits.h5")
    jax_track(np.arange(n_snap), np.tile(np.arange(n_halos), (n_snap, 1)),
              regions, loader, save, verbose=False)
    return save, _to_memory(save), snaps, box, n_snap, regions, loader, tmp


def _to_memory(path):
    w = MemoryWriter()
    with h5py.File(path) as hf:
        f = {"attrs": dict(hf.attrs)}
        for k in hf:
            f[k] = {d: hf[k][d][()] for d in hf[k]}
    w.files[path] = f
    return w


def _read(path, writer=None):
    """{group: {dataset: array}} of a collated catalog."""
    if writer is not None:
        return {k: dict(v) for k, v in writer.files[path].items()
                if k != "attrs"}
    with h5py.File(path) as hf:
        return {k: {d: hf[k][d][()] for d in hf[k]} for k in hf}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert sorted(a[k]) == sorted(b[k]), k
        for d in a[k]:
            assert a[k][d].dtype == b[k][d].dtype, (k, d)
            assert np.array_equal(a[k][d], b[k][d]), (k, d)


COLLATIONS = [
    dict(angle_cut=0.1, save_final_counts=True),
    dict(halo_ids=np.array([2, 0]), snapshot_number=5),
    dict(snapshot_number=4, save_final_counts=True),
    dict(angle_cut=0.0, data_type=np.int64),
]


@pytest.mark.parametrize("jax_device", [False, True])
@pytest.mark.parametrize("case", range(len(COLLATIONS)))
def test_collation_matches_jax(tracked, case, jax_device):
    """Port host, port ``device='cpu'`` and the port on a MemoryWriter
    against JAX's host or device collation, bit for bit."""
    save, mem, _, _, _, _, _, tmp = tracked
    kw = dict(COLLATIONS[case], verbose=False)
    ref = str(tmp / f"jax_{case}_{jax_device}.h5")
    jpost.Apsides(save).collate_apsides(savefile=ref, device=jax_device,
                                        **kw)
    want = _read(ref)
    for dev in (False, "cpu"):
        got = str(tmp / f"port_{case}_{jax_device}_{dev}.h5")
        tpost.Apsides(save).collate_apsides(savefile=got, device=dev, **kw)
        _assert_same(want, _read(got))
        tpost.Apsides(save, writer=mem).collate_apsides(
            savefile=got, device=dev, **kw)
        _assert_same(want, _read(got, mem))


def test_collation_counts_match_oracle(tracked):
    save, mem, snaps, box, n_snap, _, _, _ = tracked
    tpost.Apsides(save, writer=mem).collate_apsides(
        savefile="coll", angle_cut=0.1, verbose=False)
    g = mem.files["coll"]["snapshot_%03d" % (n_snap - 1)]
    offs = np.concatenate((g["halo_offsets"], [len(g["particle_IDs"])]))
    for h in range(3):
        exp_ids, exp_counts = _oracle_collated_counts(snaps, box,
                                                      n_snap - 1, 0.1, h)
        assert np.array_equal(g["particle_IDs"][offs[h]:offs[h + 1]],
                              exp_ids), h
        assert np.array_equal(g["pericenter_counts"][offs[h]:offs[h + 1]],
                              exp_counts), h


def test_final_counts_subset_of_snapshots(tracked):
    save, mem, _, _, _, _, _, tmp = tracked
    ref, got = str(tmp / "jfc.h5"), str(tmp / "tfc.h5")
    jpost.Apsides(save).collate_apsides(savefile=ref, verbose=False)
    jpost.Apsides(save).save_final_apsis_counts(
        ref, snapshot_numbers=[2, 5], verbose=False)
    tpost.Apsides(save).collate_apsides(savefile=got, verbose=False)
    tpost.Apsides(save).save_final_apsis_counts(
        got, snapshot_numbers=[2, 5], verbose=False)
    _assert_same(_read(ref), _read(got))
    assert "pericenter_counts_final" in _read(got)["snapshot_002"]
    assert "pericenter_counts_final" not in _read(got)["snapshot_003"]


def test_collate_rejects_unknown_halo_and_existing_group(tracked):
    save, mem, _, _, _, _, _, tmp = tracked
    ap = tpost.Apsides(save, writer=mem)
    with pytest.raises(ValueError, match="not been processed"):
        ap.collate_apsides(halo_ids=np.array([999]), savefile="x")
    assert list(ap.missing_halo_ids) == [999]
    ap.collate_apsides(savefile="twice", verbose=False)
    with pytest.raises(ValueError, match="exists"):
        ap.collate_apsides(savefile="twice", verbose=False)


def test_collation_device_default_needs_cuda(tracked):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpost.Apsides(tracked[0]).collate_apsides(savefile="x", device=True,
                                                  verbose=False)


def test_apsides_reads_jax_metadata(tracked):
    save, mem = tracked[:2]
    j, t, m = jpost.Apsides(save), tpost.Apsides(save), tpost.Apsides(
        save, writer=mem)
    for a in (t, m):
        assert np.array_equal(a.snapshot_numbers, j.snapshot_numbers)
        assert np.array_equal(a.final_halo_ids, j.final_halo_ids)
        assert a.mode == j.mode and a.box_size == j.box_size


@pytest.mark.parametrize("snap", [None, 4])
def test_decomposition_matches_jax_and_plots(tracked, snap):
    save, mem, _, _, n_snap, regions, loader, tmp = tracked
    s = n_snap - 1 if snap is None else snap
    sd = loader(s, *regions(s, np.array([1])))
    j = jpost.OrbitDecomposition(save).get_halo_decomposition_at_snapshot(
        1, snapshot_number=snap, snapshot_data=sd, angle_cut=0.05)
    for od in (tpost.OrbitDecomposition(save),
               tpost.OrbitDecomposition(save, writer=mem)):
        od.get_halo_decomposition_at_snapshot(
            1, snapshot_number=snap, snapshot_data=sd, angle_cut=0.05)
        for name in ("particle_ids", "counts", "coordinates", "velocities",
                     "radii", "radial_velocities", "region_radius",
                     "halo_position", "halo_velocity"):
            assert np.array_equal(getattr(od, name), getattr(j, name)), name
    f1, f2 = str(tmp / f"pos_{snap}.png"), str(tmp / f"phase_{snap}.png")
    od.plot_position_space(savefile=f1, projection="xz")
    od.plot_phase_space(savefile=f2, logr=True, counts_to_plot=[0, 1])
    assert os.path.getsize(f1) > 1000 and os.path.getsize(f2) > 1000


def test_decomposition_without_snapshot_data(tracked):
    save, mem = tracked[:2]
    j = jpost.OrbitDecomposition(save).get_halo_decomposition_at_snapshot(2)
    t = tpost.OrbitDecomposition(save, writer=mem)
    t.get_halo_decomposition_at_snapshot(2)
    assert np.array_equal(t.particle_ids, j.particle_ids)
    assert np.array_equal(t.counts, j.counts)
    with pytest.raises(RuntimeError, match="snapshot_data"):
        t.plot_phase_space()


def test_mid_sequence_final_counts(tmp_path):
    """Distinct halo IDs at every snapshot: the final counts map through
    the z=0 descendant space, as in JAX."""
    box, n_halos, n_snap = 60.0, 3, 6
    snaps, _ = churn_snapshots(n_halos, 120, n_snap, box_size=box, seed=77)
    branches = np.stack([np.arange(n_halos) + 1000 * s
                         for s in range(n_snap)])

    def regions(snapshot_number, halo_ids):
        s = snaps[int(snapshot_number)]
        return (np.stack([s[h]["center"] for h in np.asarray(halo_ids)
                          % 1000]), np.full(len(halo_ids), 50.0))

    def loader(snapshot_number, region_positions, region_radii):
        s = snaps[int(snapshot_number)]
        keys = [h for rp in np.atleast_2d(region_positions) for h in s
                if np.allclose(s[h]["center"], rp, atol=1e-9)]
        return dict(
            ids=np.concatenate([s[h]["ids"] for h in keys]),
            coordinates=np.concatenate([s[h]["pos"] for h in keys]),
            velocities=np.concatenate([s[h]["vel"] for h in keys]),
            region_offsets=np.concatenate(
                ([0], np.cumsum([len(s[h]["ids"]) for h in keys])))[:-1],
            box_size=box)

    save = str(tmp_path / "mid.h5")
    jax_track(np.arange(n_snap), branches, regions, loader, save,
              verbose=False)
    kw = dict(snapshot_number=4, save_final_counts=True, verbose=False)
    jpost.Apsides(save).collate_apsides(savefile=str(tmp_path / "j.h5"),
                                        **kw)
    for dev in (False, "cpu"):
        got = str(tmp_path / f"t_{dev}.h5")
        tpost.Apsides(save).collate_apsides(savefile=got, device=dev, **kw)
        _assert_same(_read(str(tmp_path / "j.h5")), _read(got))
    assert sorted(_read(got))[-1] == "snapshot_004"


# ------------------------------------------------------------ progenitors

def _catalog(rng, n_halos, n_per, scale=2.0, box=None, id_base=0):
    centers = rng.uniform(0, 100, size=(n_halos, 3))
    ids, coords = [], []
    for h in range(n_halos):
        m = n_per - 7 * h
        ids.append(id_base + np.arange(h * 1000, h * 1000 + m))
        coords.append(centers[h] + rng.normal(scale=scale * (1 + 0.2 * h),
                                              size=(m, 3)))
    snap = dict(ids=np.concatenate(ids), coordinates=np.concatenate(coords),
                region_offsets=np.concatenate(
                    ([0], np.cumsum([len(i) for i in ids])))[:-1])
    if box is not None:
        snap["box_size"] = box
        snap["coordinates"] = np.mod(snap["coordinates"], box)
    return snap, centers, ids


@pytest.mark.parametrize("box", [None, 100.0, 30.0])
def test_central_ids_match_jax(box):
    rng = np.random.default_rng(3)
    snap, centers, _ = _catalog(rng, 4, 300, box=box)
    want = jprog.get_central_particle_ids(snap, centers, n=50)
    got = tprog.get_central_particle_ids(snap, centers, n=50)
    for w, g in zip(want, got):
        assert np.array_equal(w, g)
    want_d = jprog.get_central_particle_ids_device(snap, centers, n=50)
    got_d = tprog.get_central_particle_ids_device(snap, centers, n=50,
                                                  device="cpu")
    for w, g in zip(want_d, got_d):
        assert np.array_equal(w, g)
    # with float32 coordinates both forms compute the same radii
    snap32 = dict(snap, coordinates=snap["coordinates"].astype(np.float32))
    c32 = centers.astype(np.float32)
    for w, g in zip(tprog.get_central_particle_ids(snap32, c32, n=50),
                    tprog.get_central_particle_ids_device(snap32, c32, n=50,
                                                          device="cpu")):
        assert np.array_equal(w, g)


def test_central_ids_tied_radii_and_short_halos():
    """Duplicated positions tie exactly: both forms put the lower load
    index first, as lax.top_k and the stable lexsort do; halos shorter
    than n (and empty ones) return all their particles."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(40, 3)).astype(np.float32)
    coords = np.concatenate([base, base[::-1], base[:10], base[:0]])
    ids = np.arange(len(coords)) * 7 + 3
    snap = dict(ids=ids, coordinates=coords,
                region_offsets=np.array([0, 80, 80]), box_size=50.0)
    centers = np.zeros((3, 3), np.float32)
    want = jprog.get_central_particle_ids_device(snap, centers, n=25)
    host = tprog.get_central_particle_ids(snap, centers, n=25)
    dev = tprog.get_central_particle_ids_device(snap, centers, n=25,
                                                device="cpu")
    for w, h, d in zip(want, host, dev):
        assert np.array_equal(w, d) and np.array_equal(h, d)
    assert np.array_equal(dev[1], [0, 25, 25])


def test_central_ids_device_keeps_wide_ids():
    """IDs past int32 come back whole from the device form (the rows hold
    load indices); JAX pads int32 IDs and cannot."""
    rng = np.random.default_rng(6)
    snap, centers, _ = _catalog(rng, 3, 200, id_base=(1 << 40))
    host = tprog.get_central_particle_ids(snap, centers, n=30)
    dev = tprog.get_central_particle_ids_device(snap, centers, n=30,
                                                device="cpu")
    assert dev[0].dtype == np.int64 and dev[0].min() >= (1 << 40)
    assert np.array_equal(host[0], dev[0])


def _vote_case(rng):
    n_halos = int(rng.integers(2, 9))
    n_desc = int(rng.integers(1, 7))
    halo_lens = rng.integers(0, 40, size=n_halos)
    pool = rng.permutation(5000)[: halo_lens.sum()]
    tracked_lens = rng.integers(0, 25, size=n_desc)
    t = []
    for L in tracked_lens:
        members = rng.choice(pool, size=min(max(L // 2, 1), L)) if len(
            pool) else pool[:0]
        misses = rng.integers(6000, 7000, size=L - len(members))
        t.append(np.concatenate([members, misses])[:L])
    tracked = np.concatenate(t).astype(np.int32)
    if len(tracked) > 4:
        tracked[-1] = tracked[0]  # a duplicate votes once
    return (pool.astype(np.int32),
            np.concatenate(([0], np.cumsum(halo_lens)))[:-1], tracked,
            np.concatenate(([0], np.cumsum(tracked_lens)))[:-1])


@pytest.mark.parametrize("seed", range(4))
def test_progenitor_vote_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        args = _vote_case(rng)
        want = jprog.find_main_progenitors(*args)
        assert jprog.find_main_progenitors_device(*args) == want
        assert tprog.find_main_progenitors(*args) == want
        assert tprog.find_main_progenitors_device(*args,
                                                  device="cpu") == want


def test_progenitor_vote_ties_and_shared_particles():
    """A 2-2 tie goes to the smaller halo; a particle in two halos votes
    for the first in catalog order, as the host form's stable sort."""
    halo_pids = np.array([10, 11, 12, 13, 20, 21, 10])
    halo_offsets = np.array([0, 4, 6])       # halo 2 shares particle 10
    tracked = np.array([20, 21, 12, 13, 10, 99])
    tracked_offsets = np.array([0, 4, 5])
    want = jprog.find_main_progenitors(halo_pids, halo_offsets, tracked,
                                       tracked_offsets)
    assert want == [0, 0, -1]
    assert tprog.find_main_progenitors(halo_pids, halo_offsets, tracked,
                                       tracked_offsets) == want
    assert tprog.find_main_progenitors_device(
        halo_pids, halo_offsets, tracked, tracked_offsets,
        device="cpu") == want


def test_progenitor_wide_ids_no_match_and_empty():
    halo_pids = (np.arange(100) + (1 << 40)).astype(np.int64)
    for f in (jprog.find_main_progenitors_device,
              lambda *a: tprog.find_main_progenitors_device(*a,
                                                            device="cpu")):
        assert f(halo_pids, np.array([0, 50]), halo_pids[60:70],
                 np.array([0, 5])) == [1, 1]
        assert f(np.arange(100), np.array([0, 50]), np.arange(1000, 1020),
                 np.array([0, 10])) == [-1, -1]
        assert f(np.zeros(0, np.int64), np.zeros(0, np.int64),
                 np.arange(4), np.array([0, 2])) == [-1, -1]
    assert tprog.find_main_progenitors(
        np.arange(100), np.array([0, 50]), np.arange(1000, 1020),
        np.array([0, 10])) == [-1, -1]


def test_progenitor_vote_routes_to_host_past_63_bits(monkeypatch):
    """Only a vote whose packed key needs more than 63 bits leaves the
    device: the host form answers it."""
    calls = []
    host = tprog.find_main_progenitors

    def spy(*a):
        calls.append(1)
        return host(*a) if len(calls) == 1 else ["host"]

    monkeypatch.setattr(tprog, "find_main_progenitors", spy)
    halo_pids = np.arange(100)
    tracked, t_off = np.arange(60, 70), np.array([0, 5])
    assert tprog.find_main_progenitors_device(
        halo_pids, np.array([0, 50]), tracked, t_off, device="cpu") == [1, 1]
    assert not calls
    # 2**62 halos' worth of halo bits cannot fit beside the count bits
    monkeypatch.setattr(tprog, "_vote_inputs", lambda *a: (
        np.asarray(a[0]), np.asarray(a[2]), np.ones(1 << 20, np.int64),
        np.array([1 << 45, 0]), np.ones(len(a[2]), bool)))
    calls.append(0)
    assert tprog.find_main_progenitors_device(
        halo_pids, np.array([0, 50]), tracked, t_off,
        device="cpu") == ["host"]


def test_progenitor_pipeline(rng):
    """Central particles of one catalog vote for their halos in an
    earlier catalog with the halo order permuted."""
    snap, centers, ids = _catalog(rng, 4, 300)
    central, offsets = tprog.get_central_particle_ids(snap, centers, n=50)
    perm = np.array([2, 0, 3, 1])
    halo_pids = np.concatenate([ids[p] for p in perm])
    halo_offsets = np.concatenate(
        ([0], np.cumsum([len(ids[p]) for p in perm])))[:-1]
    expect = [int(np.where(perm == h)[0][0]) for h in range(4)]
    assert tprog.find_main_progenitors(halo_pids, halo_offsets, central,
                                       offsets) == expect
    assert tprog.find_main_progenitors_device(
        halo_pids, halo_offsets, central, offsets, device="cpu") == expect


def test_progenitor_device_default_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprog.find_main_progenitors_device(np.arange(4), [0], np.arange(2),
                                           [0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprog.get_central_particle_ids_device(
            dict(ids=np.arange(4), coordinates=np.zeros((4, 3)),
                 region_offsets=np.array([0])), np.zeros((1, 3)))
