"""The port's ``track_orbits(mesh=...)`` across ranks against the JAX
package's single-process runs and the port's own unsharded runs.

Two gloo ranks (``tests/torch_ranks.py``) run the halo-sharded engines
(general, sorted, aligned, and an aligned crash-resume) on a
``{'halos': 2}`` mesh (three halos, padded to four rows) and the
hash-sharded engine on a ``{'shards': 2}`` mesh (also ``mode='both'``,
wide 64-bit IDs, the two together, and crash-resume); four ranks run the general engine on
a ``('halos', 'particles')`` mesh.  Rank 0 writes every savefile and
checkpoint.  Halo-sharded files equal the port's unsharded runs bit for
bit; every file equals the JAX package's single-process run under the
repository's cross-engine tolerances (``tests/test_engine.py::
_assert_files_equal``), the hash files JAX's 2-shard hash engine's.
"""

import h5py
import jax
import numpy as np
import pytest
import torch

from orbitanalysis_tpu import track_orbits as jax_track
from orbitanalysis_tpu.models.synthetic import churn_snapshots
from orbitanalysis_tpu.parallel import make_mesh as jax_mesh
from orbitanalysis_tpu_torch import track_orbits
from orbitanalysis_tpu_torch.parallel import make_mesh

from helpers import make_callbacks
from test_engine import _assert_files_equal, _assert_h5_identical
from torch_ranks import (
    TRACKER_RUNS,
    TRACKER_RUNS_2D,
    run_world,
    save_snaps,
)

torch.set_num_threads(1)

BOX = 60.0
N_HALOS, N_SNAP = 3, 8
SHIFT = np.int64(2) ** 33
#: Checkpoint angles of the hash engine against JAX's: the hash step's
#: r-hat differs from JAX's by an ulp where XLA's CPU ``rsqrt`` is not
#: the IEEE one, and near cos = 1 arccos turns an ulp of the cosine into
#: up to sqrt(2 * 2**-24) ~ 3.5e-4 rad a step; the f16 store tolerance of
#: ``_assert_files_equal`` (one f16 ulp, 4e-3) covers a few such steps,
#: as ``tests/test_torch_tracker.py`` holds a resumed JAX checkpoint.
ANGLE_ATOL = 4e-3


def _setup(grow=False):
    """``test_engine``'s ``churn_setup`` snapshots, or with ``grow`` its
    ``growing_setup``'s (each region doubles at snapshot 4)."""
    snaps, centers = churn_snapshots(N_HALOS, 150, N_SNAP, box_size=BOX,
                                     seed=11)
    if grow:
        extra, _ = churn_snapshots(N_HALOS, 150, N_SNAP, box_size=BOX,
                                   seed=12)
        for s, e in zip(snaps[4:], extra[4:]):
            for h in list(s):
                s[h] = dict(
                    ids=np.concatenate([s[h]["ids"],
                                        e[h]["ids"] + 500_000]),
                    **{k: np.concatenate([s[h][k], e[h][k]])
                       for k in ("pos", "vel", "mass")},
                    center=s[h]["center"])
    regions, loader = make_callbacks(snaps, centers, box_size=BOX)
    return snaps, regions, loader


def _wide(loader):
    """``loader`` with every ID shifted past 2**33."""
    def load(s, rp, rr):
        d = dict(loader(s, rp, rr))
        d["ids"] = d["ids"].astype(np.int64) + SHIFT
        return d

    return load


def _run(fn, path, loader=None, grow=False, **kw):
    snaps, regions, base = _setup(grow)
    fn(np.arange(N_SNAP), np.tile(np.arange(N_HALOS), (N_SNAP, 1)),
       regions, loader or base, path, verbose=False, **kw)
    return path


def _checkpoints_equal(a, b, atol=0.0):
    with h5py.File(a + ".checkpoint") as x, h5py.File(b + ".checkpoint") as y:
        assert sorted(x.keys()) == sorted(y.keys())
        assert x.attrs["snapshot_number"] == y.attrs["snapshot_number"]
        for ds in x:
            if atol:
                np.testing.assert_allclose(x[ds][:], y[ds][:], atol=atol)
            else:
                np.testing.assert_array_equal(x[ds][:], y[ds][:])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' savefiles (2 ranks, then 4), and the reference runs
    in this process: JAX's general engine (pericentric with a
    checkpoint, apocentric) and hash engine on 2 devices, and the port's
    unsharded runs."""
    work = tmp_path_factory.mktemp("tracker_world")
    for data in ("churn", "grow"):
        save_snaps(work / f"tracker_{data}_in.npz", _setup(data == "grow")[0],
                   box=BOX)
    run_world("tracker", 2, str(work), timeout=200)
    run_world("tracker2d", 4, str(work), timeout=200)
    ref = tmp_path_factory.mktemp("tracker_refs")
    out = dict(work=work)
    out["jax_general"] = _run(jax_track, str(ref / "jax_general.h5"),
                              join_impl="general", checkpoint=True)
    out["jax_apo"] = _run(jax_track, str(ref / "jax_apo.h5"),
                          join_impl="general", mode="apocentric")
    out["jax_hash"] = _run(jax_track, str(ref / "jax_hash.h5"),
                           mesh=jax_mesh({"shards": 2}, jax.devices()[:2]),
                           checkpoint=True)
    out["jax_hash_both_wide"] = _run(
        jax_track, tuple(str(ref / f"jax_both_wide_{m}.h5")
                         for m in ("peri", "apo")),
        loader=_wide(_setup()[2]), mode="both", id_dtype=np.int64,
        mesh=jax_mesh({"shards": 2}, jax.devices()[:2]), checkpoint=True)
    for join in ("general", "sorted", "aligned"):
        out[f"port_{join}"] = _run(track_orbits, str(ref / f"{join}.h5"),
                                   join_impl=join, checkpoint=True,
                                   device="cpu")
    out["port_shards1"] = _run(
        track_orbits, str(ref / "shards1.h5"), checkpoint=True,
        device="cpu", mesh=make_mesh({"shards": 1}, device="cpu"))
    grow = dict(grow=True, capacity=128, headroom=1.05, checkpoint=True,
                device="cpu")
    for grow_impl in ("keep", "general"):
        out[f"port_grow_{grow_impl}"] = _run(
            track_orbits, str(ref / f"grow_{grow_impl}.h5"),
            join_impl="aligned", grow_impl=grow_impl, **grow)
    out["port_grow_shards1"] = _run(
        track_orbits, str(ref / "grow_shards1.h5"),
        mesh=make_mesh({"shards": 1}, device="cpu"), **dict(grow,
                                                             capacity=200))
    return out


def _path(worlds, name):
    return str(worlds["work"] / f"{name}.h5")


def _assert_grew(worlds, name):
    """Each rank's Metrics show the same capacities, and they grew."""
    caps = [np.load(worlds["work"] / f"tracker_out_{r}.npz")[
        f"{name}_capacity"] for r in range(2)]
    np.testing.assert_array_equal(caps[0], caps[1])
    assert caps[0][-1] > caps[0][0], caps[0]


def test_runs_are_the_listed_ones():
    names = [r[0] for r in TRACKER_RUNS + TRACKER_RUNS_2D]
    assert len(set(names)) == len(names) == 17


@pytest.mark.timeout(300)
@pytest.mark.parametrize("join", ["general", "sorted", "aligned"])
def test_halo_mesh_equals_unsharded_and_jax(worlds, join):
    """Two ranks over the halo axis write the unsharded run's savefile
    and checkpoint bit for bit, and the JAX general engine's savefile
    within the cross-engine tolerances (checkpoint angles within 1e-4,
    as tests/test_torch_tracker.py holds them)."""
    got = _path(worlds, f"halos_{join}")
    _assert_h5_identical(worlds[f"port_{join}"], got)
    _checkpoints_equal(worlds[f"port_{join}"], got)
    _assert_files_equal(worlds["jax_general"], got)
    with h5py.File(worlds["jax_general"] + ".checkpoint") as a, \
            h5py.File(got + ".checkpoint") as b:
        np.testing.assert_allclose(a["angles"][:], b["angles"][:], atol=1e-4)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("join", ["general", "aligned"])
def test_halo_mesh_event_overflow(worlds, join):
    """Event lists of 4 on two ranks: rows with more events take the
    gathered full masks (general) or the gathered payload plane
    (aligned, which then grows its lists), and the savefile is the
    unsharded run's, bit for bit."""
    got = _path(worlds, f"halos_{join}_spill")
    _assert_h5_identical(worlds[f"port_{join}"], got)
    with h5py.File(got) as hf:
        most = max(int(np.diff(hf[g]["region_offsets"][:]).max(initial=0))
                   for g in hf if g.startswith("snapshot_"))
    assert most > 4
    caps = np.load(worlds["work"] / "tracker_out_1.npz")[
        f"halos_{join}_spill_event_capacity"]
    # the aligned engine grew its lists at the first snapshot it saved
    assert (caps > 4).all() if join == "aligned" else (caps == 4).all()


@pytest.mark.timeout(300)
@pytest.mark.parametrize("grow_impl", ["keep", "general"])
def test_halo_mesh_capacity_growth(worlds, grow_impl):
    """Regions double at snapshot 4: two ranks grow the aligned engine in
    place (the carry gathered, re-padded and cut again) or convert it to
    the general engine, as the unsharded run does, bit for bit, and the
    capacity grew on every rank."""
    got = _path(worlds, f"grow_{grow_impl}")
    _assert_h5_identical(worlds[f"port_grow_{grow_impl}"], got)
    if grow_impl == "keep":
        _checkpoints_equal(worlds["port_grow_keep"], got)
    _assert_grew(worlds, f"grow_{grow_impl}")


@pytest.mark.timeout(300)
def test_shards_mesh_capacity_growth(worlds):
    """The hash engine's shard capacity grows when a bucket outgrows it,
    on both ranks alike: the one-rank run's savefile within the
    cross-engine tolerances, its checkpoint bit for bit."""
    got = _path(worlds, "grow_shards")
    _assert_files_equal(worlds["port_grow_shards1"], got)
    _checkpoints_equal(worlds["port_grow_shards1"], got)
    _assert_grew(worlds, "grow_shards")


@pytest.mark.timeout(300)
def test_halo_mesh_crash_resume(worlds):
    """The aligned engine on two ranks, crashed at snapshot 5 and
    resumed (rank 0 reads the savefile and sidecar, every rank gets
    them), ends with the straight run's savefile and checkpoint."""
    straight = _path(worlds, "halos_aligned")
    resumed = _path(worlds, "halos_aligned_resume")
    _assert_h5_identical(straight, resumed)
    _checkpoints_equal(straight, resumed)


@pytest.mark.timeout(300)
def test_halo_particles_mesh_equals_unsharded(worlds):
    """Four ranks, ('halos', 'particles') = (2, 2), the general engine
    gathering each row from its particle group: the unsharded run's
    savefile and checkpoint bit for bit."""
    got = _path(worlds, "halos_particles")
    _assert_h5_identical(worlds["port_general"], got)
    _checkpoints_equal(worlds["port_general"], got)


@pytest.mark.timeout(300)
def test_shards_mesh_equals_jax_hash_and_world_of_one(worlds):
    """The hash engine on two ranks: JAX's 2-shard hash run's savefile
    within the cross-engine tolerances and its checkpoint angles within
    ANGLE_ATOL; the port's one-rank hash run's savefile likewise (the
    moments split over two shards round once more) and its checkpoint
    bit for bit; the JAX general engine's events."""
    got = _path(worlds, "shards")
    _assert_files_equal(worlds["jax_hash"], got)
    _assert_files_equal(worlds["port_shards1"], got)
    _assert_files_equal(worlds["jax_general"], got)
    _checkpoints_equal(worlds["jax_hash"], got, atol=ANGLE_ATOL)
    _checkpoints_equal(worlds["port_shards1"], got)


@pytest.mark.timeout(300)
def test_shards_mesh_both_mode(worlds):
    """mode='both' on two ranks: the pericentric file is the
    single-mode run's, bit for bit; the apocentric one the JAX general
    engine's apocentric catalog."""
    _assert_h5_identical(_path(worlds, "shards"),
                         _path(worlds, "peri_shards_both"))
    _assert_files_equal(worlds["jax_apo"], _path(worlds, "apo_shards_both"))


@pytest.mark.timeout(300)
def test_shards_mesh_wide_ids(worlds):
    """IDs shifted past 2**33 through WideIdMap handles on every rank:
    the savefile carries the real int64 IDs, otherwise equal to the
    int32 run's (the handles split the particles over the shards
    otherwise than the IDs do, so the bulk velocities' partial sums
    round differently: one f32 ulp, as in the JAX package's
    ``tests/test_tracker_hash.py``)."""
    wide, narrow = _path(worlds, "shards_wide"), _path(worlds, "shards")
    total = 0
    with h5py.File(wide) as a, h5py.File(narrow) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in a[k]:
                va, vb = a[k][ds][:], b[k][ds][:]
                if ds.endswith("center_IDs"):
                    assert va.dtype == np.int64, (k, ds)
                    np.testing.assert_array_equal(va, vb + SHIFT)
                    total += va.size
                elif ds == "bulk_velocities":
                    np.testing.assert_allclose(va, vb, rtol=2e-6, atol=1e-6)
                else:
                    np.testing.assert_array_equal(va, vb, err_msg=ds)
    assert total > 0


@pytest.mark.timeout(300)
def test_shards_mesh_both_mode_wide_ids(worlds):
    """mode='both' with wide IDs on two ranks (both engines unmap their
    events through the pair's one ID map): each file and checkpoint is
    JAX's 2-shard run's under the cross-engine tolerances, the
    pericentric file the single-mode wide run's bit for bit."""
    for m, ref in zip(("peri", "apo"), worlds["jax_hash_both_wide"]):
        got = _path(worlds, f"{m}_shards_both_wide")
        _assert_files_equal(ref, got)
        _checkpoints_equal(ref, got, atol=ANGLE_ATOL)
    _assert_h5_identical(_path(worlds, "shards_wide"),
                         _path(worlds, "peri_shards_both_wide"))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["shards", "shards_wide",
                                  "peri_shards_both_wide",
                                  "apo_shards_both_wide"])
def test_shards_mesh_crash_resume(worlds, name):
    """Crashed at snapshot 5 and resumed on two ranks (also each file of
    a mode='both' run with wide IDs): the straight run's savefile and
    checkpoint, bit for bit.  Wide IDs take new handles from the resume
    snapshot on (handles never cross runs), so their partition and the
    bulk velocities' last bit may differ: the cross-engine tolerances
    there, as the JAX package's test."""
    straight, resumed = _path(worlds, name), _path(worlds, f"{name}_resume")
    if name == "shards":
        _assert_h5_identical(straight, resumed)
        _checkpoints_equal(straight, resumed)
    else:
        _assert_files_equal(straight, resumed)
        _checkpoints_equal(straight, resumed, atol=ANGLE_ATOL)


def test_mesh_rejections(tmp_path):
    """A 'particles' axis with the sorted or aligned engine raises, as
    does a 'shards' mesh with either, a mesh without a 'halos' or
    'shards' axis, and a mesh that is not the port's."""
    mesh2d = make_mesh({"halos": 1, "particles": 1}, device="cpu")
    for join in ("sorted", "aligned"):
        with pytest.raises(ValueError, match="halo axis only"):
            _run(track_orbits, str(tmp_path / f"{join}.h5"), device="cpu",
                 mesh=mesh2d, join_impl=join)
        with pytest.raises(ValueError, match="'shards' mesh"):
            _run(track_orbits, str(tmp_path / f"s{join}.h5"), device="cpu",
                 mesh=make_mesh({"shards": 1}, device="cpu"), join_impl=join)
    with pytest.raises(ValueError, match="'halos' or a 'shards'"):
        _run(track_orbits, str(tmp_path / "p.h5"), device="cpu",
             mesh=make_mesh({"particles": 1}, device="cpu"))
    with pytest.raises(TypeError, match="Mesh"):
        _run(track_orbits, str(tmp_path / "j.h5"), device="cpu",
             mesh=jax_mesh({"halos": 1}, jax.devices()[:1]))
