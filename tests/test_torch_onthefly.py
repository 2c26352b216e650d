"""The port's on-the-fly driver and savefile functions on the CPU against
the JAX package: ``track_orbits_onthefly`` files equal JAX's (ID sets and
offsets exact, angle changes within 1e-4 rad, bulk velocities within
rtol 2e-6, NaN rows in the same places), in single mode and
``mode='both'``, with missing progenitors, read back from HDF5 and from
a MemoryWriter; the ``io_hdf5`` module functions write what JAX's write.
"""

import h5py
import numpy as np
import pytest
import torch

import orbitanalysis_tpu.engine.io_hdf5 as jio
import orbitanalysis_tpu_torch.engine.io_hdf5 as tio
from orbitanalysis_tpu import track_orbits_onthefly as jax_otf
from orbitanalysis_tpu_torch import track_orbits_onthefly as otf
from orbitanalysis_tpu_torch.engine.io_hdf5 import H5Writer, MemoryWriter

from oracle import OracleTracker
from test_engine import churn_setup  # noqa: F401

torch.set_num_threads(1)


def _flat(path):
    with h5py.File(path) as hf:
        return ({k: hf[k][()] for k in hf}, dict(hf.attrs))


def _assert_otf_close(want, got):
    """JAX's on-the-fly file against the port's: everything exact but
    the angle changes (1e-4 rad) and bulk velocities (rtol 2e-6)."""
    (wd, wa), (gd, ga) = want, got
    assert sorted(wd) == sorted(gd) and wa == ga
    for k in wd:
        assert wd[k].dtype == gd[k].dtype and wd[k].shape == gd[k].shape, k
        if k == "angles":
            np.testing.assert_allclose(gd[k], wd[k], rtol=0, atol=1e-4)
        elif k == "bulk_velocities":
            assert np.array_equal(np.isnan(wd[k]), np.isnan(gd[k]))
            np.testing.assert_allclose(gd[k], wd[k], rtol=2e-6, atol=1e-6)
        else:
            assert np.array_equal(wd[k], gd[k]), k


def _links(branches, missing=None):
    links = np.stack([branches[4], branches[3]])
    if missing is not None:
        links[1, missing] = -1
    return links


@pytest.mark.parametrize("mode,missing", [("pericentric", None),
                                          ("apocentric", None),
                                          ("pericentric", 1)])
def test_onthefly_matches_jax(tmp_path, churn_setup, mode, missing):
    box, snaps, regions, loader, _, branches = churn_setup
    links = _links(branches, missing)
    ref, got = str(tmp_path / "jax_{}.h5"), str(tmp_path / "port_{}.h5")
    jax_otf(4, links, regions, loader, ref, mode=mode, verbose=False)
    otf(4, links, regions, loader, got, mode=mode, device="cpu",
        verbose=False)
    want = _flat(ref.format("004"))
    _assert_otf_close(want, _flat(got.format("004")))
    mem = MemoryWriter()
    otf(4, links, regions, loader, "m_{}", mode=mode, device="cpu",
        verbose=False, writer=mem)
    f = mem.files["m_004"]
    _assert_otf_close(want, (mem.read_group("m_004"), f["attrs"]))
    if missing is not None:
        offs = f["pericenter_offsets"]
        assert len(offs) == 4 and offs[2] == offs[1]
        assert np.isnan(f["bulk_velocities"][1, 1]).all()
        assert np.isfinite(f["bulk_velocities"][0]).all()


def test_onthefly_sets_match_oracle(tmp_path, churn_setup):
    box, snaps, regions, loader, _, branches = churn_setup
    mem = MemoryWriter()
    otf(4, _links(branches), regions, loader, "o_{}", device="cpu",
        verbose=False, writer=mem)
    f = mem.read_group("o_004")
    oracle = OracleTracker(mode="pericentric", box_size=box)
    oracle.step(snaps[3])
    ev = oracle.step(snaps[4])
    for h in range(3):
        sl = slice(*f["pericenter_offsets"][h:h + 2])
        assert np.array_equal(np.sort(f["pericenter_IDs"][sl]),
                              np.sort(ev[h][0])), h
        prev, cur = (set(snaps[s][h]["ids"].tolist()) for s in (3, 4))
        assert set(f["entered_IDs"][slice(
            *f["entered_offsets"][h:h + 2])].tolist()) == cur - prev
        assert set(f["departed_IDs"][slice(
            *f["departed_offsets"][h:h + 2])].tolist()) == prev - cur


@pytest.mark.parametrize("writer", ["h5", "memory"])
def test_onthefly_both_mode_matches_single_runs(tmp_path, churn_setup,
                                                writer):
    box, snaps, regions, loader, _, branches = churn_setup
    links = _links(branches, missing=2)
    w = H5Writer() if writer == "h5" else MemoryWriter()
    p = [str(tmp_path / f"{n}_{{}}.h5") for n in ("p1", "a1", "p2", "a2")]
    kw = dict(device="cpu", verbose=False, writer=w)
    otf(4, links, regions, loader, p[0], mode="pericentric", **kw)
    otf(4, links, regions, loader, p[1], mode="apocentric", **kw)
    otf(4, links, regions, loader, (p[2], p[3]), mode="both", **kw)
    for single, both in ((p[0], p[2]), (p[1], p[3])):
        a = w.read_group(single.format("004"))
        b = w.read_group(both.format("004"))
        assert sorted(a) == sorted(b)
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), k
        assert w.read_attrs(single.format("004")) == w.read_attrs(
            both.format("004"))
    if writer == "h5":
        jax_otf(4, links, regions, loader, (p[0] + ".j", p[1] + ".j"),
                mode="both", verbose=False)
        _assert_otf_close(_flat(p[1].format("004") + ".j"),
                          _flat(p[3].format("004")))


def test_onthefly_validation(tmp_path, churn_setup):
    box, snaps, regions, loader, _, branches = churn_setup
    with pytest.raises(ValueError, match="not recognized"):
        otf(4, np.zeros((2, 1), np.int64), regions, loader, "x",
            mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="two"):
        otf(4, _links(branches), regions, loader, "x", mode="both",
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            otf(4, _links(branches), regions, loader, "x")


def test_io_module_functions_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    args = (7, "apocentric", np.arange(5, dtype=np.int32),
            np.array([0, 2, 5]), rng.uniform(0, 3, 5).astype(np.float32),
            np.array([0, 1]), np.array([4, 5]), np.ones(2),
            rng.normal(size=(2, 3)), rng.normal(size=(2, 3)))
    files = {}
    for name, io in (("jax", jio), ("port", tio)):
        f = str(tmp_path / name / "save.h5")
        io.initialize_savefile(f, "apocentric", 25.0, verbose=False)
        io.append_snapshot(f, *args, verbose=False)
        io.append_snapshot(f, 9, *args[1:6], None, *args[7:],
                           verbose=False, angle_store_dtype=np.float32)
        io.write_checkpoint(f, args[4], 9,
                            layout_positions=np.arange(5))
        assert io.last_snapshot_number(f) == 9
        ang, snap, lay = io.read_checkpoint(f, with_layout=True)
        assert snap == 9 and np.array_equal(lay, np.arange(5))
        assert ang.dtype == np.float16
        assert io.read_checkpoint(f)[1] == 9
        files[name] = f
    with h5py.File(files["jax"]) as a, h5py.File(files["port"]) as b:
        assert dict(a.attrs) == dict(b.attrs)
        assert sorted(a) == sorted(b) == ["snapshot_007", "snapshot_009"]
        for g in a:
            assert sorted(a[g]) == sorted(b[g]), g
            for d in a[g]:
                assert a[g][d].dtype == b[g][d].dtype, (g, d)
                assert np.array_equal(a[g][d][()], b[g][d][()]), (g, d)


@pytest.mark.parametrize("writer", ["h5", "memory"])
def test_writer_read_and_amend(tmp_path, writer):
    """The read and amend methods behave alike on both writers."""
    w = H5Writer() if writer == "h5" else MemoryWriter()
    f, flat = str(tmp_path / "c.h5"), str(tmp_path / "flat.h5")
    w.add_group(f, "snapshot_002", {"a": np.arange(3)})
    w.add_group(f, "snapshot_010", {"a": np.arange(2)})
    with pytest.raises(ValueError):
        w.add_group(f, "snapshot_002", {"a": np.arange(3)})
    w.add_dataset(f, "snapshot_002", "b", np.ones(3, np.int64))
    with pytest.raises(ValueError):
        w.add_dataset(f, "snapshot_002", "b", np.ones(3))
    assert sorted(w.list_groups(f)) == ["snapshot_002", "snapshot_010"]
    g = w.read_group(f, "snapshot_002")
    assert sorted(g) == ["a", "b"] and g["b"].dtype == np.int64
    w.write_flat(flat, {"x": np.arange(4.0)}, {"box_size": 5.0})
    assert w.read_attrs(flat) == {"box_size": 5.0}
    assert np.array_equal(w.read_group(flat)["x"], np.arange(4.0))
    assert w.list_groups(flat) == []
    w.initialize(str(tmp_path / "s.h5"), "pericentric", None, verbose=False)
    assert w.read_attrs(str(tmp_path / "s.h5")) == {"mode": "pericentric"}
