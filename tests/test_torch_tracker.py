"""The port's ``track_orbits`` end to end on the CPU against the JAX
package: savefiles equal the JAX general engine's under the repo's
cross-engine tolerances (tests/test_engine.py::_assert_files_equal),
event sets equal the oracle's, and resume, growth, overflow recovery,
wide IDs, ``mode='both'`` and a resume from a JAX checkpoint behave as
in the JAX package.
"""

import h5py
import numpy as np
import pytest
import torch

from orbitanalysis_tpu import track_orbits as jax_track
from orbitanalysis_tpu_torch import track_orbits
from orbitanalysis_tpu_torch.engine.io_hdf5 import H5Writer, MemoryWriter
from orbitanalysis_tpu_torch.utils.metrics import Metrics

from helpers import make_callbacks
from test_engine import (  # noqa: F401
    _assert_files_equal,
    _assert_h5_identical,
    _capacities,
    _check_file_vs_oracle,
    _oracle_sets,
    churn_setup,
    growing_setup,
)

torch.set_num_threads(1)

JOINS = ["aligned", "general"]


def _run(setup, path, **kw):
    box, snaps, regions, loader, snap_nums, branches = setup
    kw.setdefault("verbose", False)
    kw.setdefault("device", "cpu")
    track_orbits(snap_nums, branches, regions, kw.pop("loader", loader),
                 path, **kw)
    return path


def _crashing(loader, at):
    state = {"crashed": False}

    def loader_crash(s, rp, rr):
        if s == at and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("simulated crash")
        return loader(s, rp, rr)

    return loader_crash


@pytest.mark.parametrize("join", JOINS)
def test_matches_jax_general_and_oracle(tmp_path, churn_setup, join):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    ref = str(tmp_path / "jax_general.h5")
    jax_track(snap_nums, branches, regions, loader, ref, join_impl="general",
              checkpoint=True, verbose=False)
    got = _run(churn_setup, str(tmp_path / f"port_{join}.h5"),
               join_impl=join, checkpoint=True)
    _assert_files_equal(ref, got)
    _check_file_vs_oracle(got, snaps, _oracle_sets(snaps, box), 3)
    with h5py.File(ref + ".checkpoint") as a, \
            h5py.File(got + ".checkpoint") as b:
        np.testing.assert_allclose(a["angles"][:], b["angles"][:],
                                   atol=1e-4)


@pytest.mark.parametrize("join", JOINS)
def test_apocentric_and_halo_birth(tmp_path, churn_setup, join):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    born = branches.copy()
    born[:4, 1] = -1  # halo 1 not born until snapshot 4
    ref = str(tmp_path / "jax.h5")
    jax_track(snap_nums, born, regions, loader, ref, mode="apocentric",
              join_impl="general", verbose=False)
    got = str(tmp_path / "port.h5")
    track_orbits(snap_nums, born, regions, loader, got, mode="apocentric",
                 join_impl=join, device="cpu", verbose=False)
    _assert_files_equal(ref, got)


@pytest.mark.parametrize("join", JOINS)
def test_both_mode_matches_single_runs(tmp_path, churn_setup, join):
    peri1 = _run(churn_setup, str(tmp_path / "peri1.h5"), join_impl=join)
    apo1 = _run(churn_setup, str(tmp_path / "apo1.h5"), join_impl=join,
                mode="apocentric")
    peri2, apo2 = str(tmp_path / "peri2.h5"), str(tmp_path / "apo2.h5")
    _run(churn_setup, (peri2, apo2), join_impl=join, mode="both")
    _assert_h5_identical(peri1, peri2)
    _assert_h5_identical(apo1, apo2)
    with pytest.raises(ValueError, match="two"):
        _run(churn_setup, str(tmp_path / "x.h5"), mode="both")


@pytest.mark.parametrize("join", JOINS)
def test_crash_resume_bit_identical(tmp_path, churn_setup, join):
    straight = _run(churn_setup, str(tmp_path / "straight.h5"),
                    join_impl=join, checkpoint=True)
    resumed = str(tmp_path / "resumed.h5")
    crash = _crashing(churn_setup[3], at=5)
    with pytest.raises(RuntimeError, match="simulated"):
        _run(churn_setup, resumed, join_impl=join, checkpoint=True,
             loader=crash)
    _run(churn_setup, resumed, join_impl=join, checkpoint=True,
         resume=True, loader=crash)
    _assert_h5_identical(straight, resumed)


@pytest.mark.parametrize("grow_impl,joins", [("keep", {"aligned"}),
                                             ("general",
                                              {"aligned", "general"})])
def test_capacity_growth(tmp_path, growing_setup, grow_impl, joins):
    """Membership doubles at snapshot 4: the run must grow (the metrics
    prove it), in place or by converting to the general engine, and
    still equal the JAX general engine's savefile."""
    box, snaps, regions, loader, snap_nums, branches = growing_setup
    ref = str(tmp_path / "jax.h5")
    jax_track(snap_nums, branches, regions, loader, ref, join_impl="general",
              verbose=False)
    m = Metrics()
    got = _run(growing_setup, str(tmp_path / "grown.h5"),
               join_impl="aligned", grow_impl=grow_impl, capacity=128,
               headroom=1.05, metrics=m)
    caps = _capacities(m)
    assert caps[0] == 128 and caps[-1] > 128, caps
    assert {r["join"] for r in m.records} == joins
    _assert_files_equal(ref, got)


@pytest.mark.parametrize("join", JOINS)
def test_event_capacity_overflow_recovered(tmp_path, join):
    """One halo emits ~n_part pericentres in one step, far past
    event_capacity=128: the aligned engine recovers every event from the
    payload plane and grows its event buffer, the general engine falls
    back to the full masks; both equal a run that never overflows."""
    n_part, n_snap = 512, 6
    rng = np.random.default_rng(3)
    centers = np.array([[50.0, 50, 50], [20.0, 20, 20]], np.float32)
    u = rng.normal(size=(n_part, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    radii = [3.0, 2.5, 2.0, 2.5, 3.0, 3.5]
    vr = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
    snaps = [{
        0: dict(ids=np.arange(n_part, dtype=np.int64),
                pos=centers[0] + radii[s] * u,
                vel=(vr[s] * u).astype(np.float32), center=centers[0]),
        1: dict(ids=np.arange(n_part, dtype=np.int64) + 10_000,
                pos=centers[1] + (2.0 + 0.3 * s) * u,
                vel=(0.3 * u).astype(np.float32), center=centers[1]),
    } for s in range(n_snap)]
    regions, loader = make_callbacks(snaps, centers, box_size=100.0,
                                     mass=False)
    setup = (100.0, snaps, regions, loader, np.arange(n_snap),
             np.tile(np.arange(2), (n_snap, 1)))
    m = Metrics()
    got = _run(setup, str(tmp_path / "spike.h5"), join_impl=join,
               event_capacity=128, metrics=m)
    roomy = _run(setup, str(tmp_path / "roomy.h5"), join_impl=join,
                 event_capacity=n_part)
    _assert_h5_identical(roomy, got)
    if join == "aligned":
        ev_caps = [r["event_capacity"] for r in m.records]
        assert ev_caps[0] == 128 and ev_caps[-1] >= n_part, ev_caps
    with h5py.File(got) as hf:
        g = hf["snapshot_003"]
        offs = g["region_offsets"][:]
        assert offs[1] - offs[0] == n_part
        np.testing.assert_array_equal(
            np.sort(g["pericenter_IDs"][offs[0]:offs[1]]), np.arange(n_part))


def test_wide_ids_match_int32_run(tmp_path, churn_setup):
    """int64 IDs shifted by 2**33 ride the 32-bit position surrogate on
    the aligned engine: every dataset equals the int32 run's, IDs modulo
    the shift."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    narrow = _run(churn_setup, str(tmp_path / "narrow.h5"),
                  join_impl="aligned", checkpoint=True)
    shift = np.int64(2) ** 33
    for s in snaps:
        for h in s:
            s[h]["ids"] = s[h]["ids"].astype(np.int64) + shift
    wide = _run(churn_setup, str(tmp_path / "wide.h5"), join_impl="aligned",
                id_dtype=np.int64, checkpoint=True)
    with h5py.File(narrow) as a, h5py.File(wide) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            for ds in a[k]:
                va, vb = a[k][ds][:], b[k][ds][:]
                if ds.endswith("center_IDs"):
                    assert vb.dtype == np.int64
                    np.testing.assert_array_equal(va.astype(np.int64) + shift,
                                                  vb)
                else:
                    np.testing.assert_array_equal(va, vb, err_msg=(k, ds))
    with h5py.File(narrow + ".checkpoint") as a, \
            h5py.File(wide + ".checkpoint") as b:
        np.testing.assert_array_equal(a["angles"][:], b["angles"][:])


def test_resume_from_jax_checkpoint(tmp_path, churn_setup):
    """The JAX aligned engine checkpoints and crashes at snapshot 5; the
    port resumes the same savefile (angles and stable layout from the
    sidecar) and ends equal to the straight JAX run."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    straight = str(tmp_path / "jax_straight.h5")
    jax_track(snap_nums, branches, regions, loader, straight,
              join_impl="aligned", checkpoint=True, verbose=False)
    resumed = str(tmp_path / "resumed.h5")
    crash = _crashing(loader, at=5)
    with pytest.raises(RuntimeError, match="simulated"):
        jax_track(snap_nums, branches, regions, crash, resumed,
                  join_impl="aligned", checkpoint=True, verbose=False)
    with h5py.File(resumed) as hf:
        assert "snapshot_005" not in hf
    _run(churn_setup, resumed, join_impl="aligned", checkpoint=True,
         resume=True, loader=crash)
    _assert_files_equal(straight, resumed)
    with h5py.File(straight + ".checkpoint") as a, \
            h5py.File(resumed + ".checkpoint") as b:
        np.testing.assert_array_equal(a["layout_positions"][:],
                                      b["layout_positions"][:])
        np.testing.assert_allclose(a["angles"][:], b["angles"][:],
                                   atol=4e-3)


def test_memory_writer_receives_what_h5_writer_writes(tmp_path, churn_setup):
    """The in-memory writer gets the same arrays, dtypes and attributes
    the HDF5 writer stores, checkpoint sidecar included."""
    path = str(tmp_path / "run.h5")
    _run(churn_setup, path, join_impl="aligned", checkpoint=True,
         writer=H5Writer())
    mem = MemoryWriter()
    _run(churn_setup, path, join_impl="aligned", checkpoint=True,
         writer=mem)
    f = mem.files[path]
    with h5py.File(path) as hf:
        assert dict(hf.attrs) == f["attrs"]
        assert sorted(hf.keys()) == sorted(k for k in f if k != "attrs")
        for k in hf:
            assert list(hf[k].keys()) == sorted(f[k]), k
            for ds in hf[k]:
                assert hf[k][ds].dtype == f[k][ds].dtype, (k, ds)
                np.testing.assert_array_equal(hf[k][ds][:], f[k][ds])
    ck = mem.checkpoints[path]
    with h5py.File(path + ".checkpoint") as hf:
        assert hf.attrs["snapshot_number"] == ck["snapshot_number"]
        np.testing.assert_array_equal(hf["angles"][:], ck["angles"])
        np.testing.assert_array_equal(hf["layout_positions"][:],
                                      ck["layout_positions"])
    assert mem.last_snapshot_number(path) == H5Writer().last_snapshot_number(
        path)


def test_default_device_needs_cuda(tmp_path, churn_setup, monkeypatch):
    """Without CUDA the default device raises and names device='cpu'; it
    never moves to the CPU by itself."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        track_orbits(snap_nums, branches, regions, loader,
                     str(tmp_path / "x.h5"), verbose=False)


def test_auto_picks_general_off_cuda(tmp_path, churn_setup):
    m = Metrics()
    _run(churn_setup, str(tmp_path / "auto.h5"), metrics=m)
    assert {r["join"] for r in m.records} == {"general"}


PARTICLES = ("halos", "particles")

#: (join_impl, device type, mesh axes, ID dtype, angle dtype, seed
#: capacity) -> the engine's ``join``, or the text of the ValueError.
PICKS = [
    ("auto", "cuda", (), np.int32, np.float32, 1024, "aligned"),
    ("auto", "cpu", (), np.int32, np.float32, 1024, "general"),
    ("auto", "cuda", (), np.int32, np.float16, 1024, "general"),
    ("auto", "cuda", (), np.uint32, np.float32, 1024, "general"),
    ("auto", "cuda", PARTICLES, np.int32, np.float32, 1024, "general"),
    ("auto", "cuda", ("shards",), np.int32, np.float32, 1024, "hash"),
    ("sorted", "cuda", ("shards",), np.int32, np.float32, None,
     "'shards' mesh"),
    ("auto", "cuda", (), np.int32, np.float32, 65536, "aligned"),
    ("auto", "cuda", (), np.int32, np.float32, 131072, "general"),
    ("auto", "cuda", (), np.int64, np.float32, 131072, "aligned"),
    ("sorted", "cuda", (), np.int32, np.float32, 262144, "capacities up to"),
    ("aligned", "cpu", PARTICLES, np.int32, np.float32, None,
     "halo axis only"),
    ("hash", "cpu", (), np.int32, np.float32, None, "join_impl"),
]


@pytest.mark.parametrize("join_impl,device,axes,ids,angles,capacity,want",
                         PICKS)
def test_picker_decision_table(join_impl, device, axes, ids, angles,
                               capacity, want):
    """The engine picker is a pure function of its arguments: it answers
    for a 'cuda' device type on a host without CUDA, and raises what
    ``track_orbits`` raises."""
    from orbitanalysis_tpu_torch.engine.tracker import _pick_engine

    args = (join_impl, device, axes, ids, angles, capacity)
    if want in ("aligned", "general", "sorted", "hash"):
        assert _pick_engine(*args).join == want
    else:
        with pytest.raises(ValueError, match=want):
            _pick_engine(*args)


def test_unported_paths_raise(tmp_path, churn_setup):
    """mesh= is ported: a world-of-one mesh runs and writes the unsharded
    savefile, and a mesh that is not the port's raises TypeError
    (tests/test_torch_tracker_mesh.py runs it across ranks);
    join_impl='sorted' is ported and runs (tests/test_torch_sorted.py
    holds it against the JAX package)."""
    from orbitanalysis_tpu_torch.parallel import make_mesh

    with pytest.raises(TypeError, match="Mesh"):
        _run(churn_setup, str(tmp_path / "a.h5"), mesh=object())
    _assert_h5_identical(
        _run(churn_setup, str(tmp_path / "m.h5"), join_impl="general",
             mesh=make_mesh({"halos": 1}, device="cpu")),
        _run(churn_setup, str(tmp_path / "u.h5"), join_impl="general"))
    m = Metrics()
    sorted_run = _run(churn_setup, str(tmp_path / "b.h5"),
                      join_impl="sorted", metrics=m)
    assert {r["join"] for r in m.records} == {"sorted"}
    _assert_files_equal(_run(churn_setup, str(tmp_path / "g.h5"),
                             join_impl="general"), sorted_run)
    with pytest.raises(ValueError, match="join_impl"):
        _run(churn_setup, str(tmp_path / "c.h5"), join_impl="hash")


@pytest.mark.parametrize("join", JOINS)
def test_cosmology_and_catalog_bulk_match_jax(tmp_path, churn_setup, join):
    """The Hubble-flow term (loader cosmology keys) and catalog bulk
    velocities (3-tuple ``regions``) go through both packages alike."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    cosmo = dict(redshift=0.3, H0=0.2, Omega_m=0.3, Omega_L=0.7)
    _, loader_h = make_callbacks(snaps, None, box_size=box, cosmology=cosmo)
    rng = np.random.default_rng(8)
    bulk = rng.normal(scale=0.2, size=(len(snaps), 3, 3))

    def regions3(s, halo_ids):
        pos, rad = regions(s, halo_ids)
        return pos, rad, bulk[s][np.asarray(halo_ids)]

    ref = str(tmp_path / "jax.h5")
    jax_track(snap_nums, branches, regions3, loader_h, ref,
              join_impl="general", verbose=False)
    got = str(tmp_path / "port.h5")
    track_orbits(snap_nums, branches, regions3, loader_h, got,
                 join_impl=join, device="cpu", verbose=False)
    _assert_files_equal(ref, got)
    with h5py.File(got) as hf:
        np.testing.assert_allclose(hf["snapshot_003"]["bulk_velocities"][:],
                                   bulk[3], rtol=1e-6)


def test_float16_angle_carry_matches_jax(tmp_path, churn_setup):
    """``angle_dtype=float16`` (the reference's own angle carry) on the
    general engine, as in the JAX package."""
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    ref = str(tmp_path / "jax.h5")
    jax_track(snap_nums, branches, regions, loader, ref, join_impl="general",
              angle_dtype=np.float16, verbose=False)
    got = _run(churn_setup, str(tmp_path / "port.h5"),
               angle_dtype=np.float16)
    _assert_files_equal(ref, got)


@pytest.mark.parametrize("join", JOINS)
def test_prefetch_depths_identical(tmp_path, churn_setup, join):
    """The prefetch thread changes no output and keeps the callbacks
    sequential; a loader exception reaches the caller."""
    import threading

    box, snaps, regions, loader, snap_nums, branches = churn_setup
    active = {"n": 0, "max": 0}
    lock = threading.Lock()

    def loader_seq(s, rp, rr):
        with lock:
            active["n"] += 1
            active["max"] = max(active["max"], active["n"])
        try:
            return loader(s, rp, rr)
        finally:
            with lock:
                active["n"] -= 1

    files = [_run(churn_setup, str(tmp_path / f"pf{d}.h5"), join_impl=join,
                  prefetch=d, checkpoint=True, loader=loader_seq)
             for d in (0, 1, 3)]
    assert active["max"] == 1
    for f in files[1:]:
        _assert_h5_identical(files[0], f)

    def loader_boom(s, rp, rr):
        if s == 3:
            raise RuntimeError("boom at 3")
        return loader(s, rp, rr)

    with pytest.raises(RuntimeError, match="boom at 3"):
        _run(churn_setup, str(tmp_path / "boom.h5"), join_impl=join,
             prefetch=2, loader=loader_boom)


def test_input_validation(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    save = str(tmp_path / "x.h5")
    with pytest.raises(ValueError, match="mode"):
        _run(churn_setup, save, mode="bogus")
    with pytest.raises(ValueError, match="len"):
        track_orbits(snap_nums[:-1], branches, regions, loader, save,
                     device="cpu", verbose=False)
    with pytest.raises(ValueError, match="grow_impl"):
        _run(churn_setup, save, grow_impl="bogus")

    def loader_negative(s, rp, rr):
        out = loader(s, rp, rr)
        out["ids"] = out["ids"] - 10**7
        return out

    for join in JOINS:
        with pytest.raises(ValueError, match="negative"):
            _run(churn_setup, save, join_impl=join, loader=loader_negative)


def test_metrics_profile_and_event_capacity_clamp(tmp_path, churn_setup):
    """Metrics records carry the phase timers; ``profile_dir`` writes a
    torch.profiler trace; an event capacity above the particle capacity
    clamps instead of failing."""
    import json
    import os

    jl = str(tmp_path / "metrics.jsonl")
    m = Metrics(jsonl_path=jl)
    got = _run(churn_setup, str(tmp_path / "m.h5"), join_impl="aligned",
               capacity=256, event_capacity=4096, metrics=m,
               profile_dir=str(tmp_path / "prof"))
    assert len(m.records) == len(churn_setup[4]) - 1
    for key in ("snapshot", "n_halos_active", "n_particles", "n_events",
                "join", "capacity", "event_capacity", "load_s", "pack_s",
                "step_s", "fetch_s", "save_s"):
        assert key in m.records[0], key
    assert {r["event_capacity"] for r in m.records} == {256}
    assert m.summary()["step_s"]["n"] == len(m.records)
    with open(jl) as f:
        assert len([json.loads(line) for line in f]) == len(m.records)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    ref = _run(churn_setup, str(tmp_path / "ref.h5"), join_impl="aligned")
    _assert_h5_identical(ref, got)
