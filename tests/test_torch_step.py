"""The port's geometry, numerics, staging and per-snapshot steps
(orbitanalysis_tpu_torch.ops / engine.packing / utils) against the JAX
package on the CPU, plus the import boundary: the port runs with jax
unavailable.

Inputs come from seeded NumPy and reach both packages as the same
bits; the JAX Pallas compaction runs in interpret mode.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbitanalysis_tpu.engine import packing as jpk
from orbitanalysis_tpu.models.synthetic import churn_snapshots
from orbitanalysis_tpu.ops import apsis as japsis
from orbitanalysis_tpu.ops import geometry as jgeo
from orbitanalysis_tpu.ops import sorted_step as jss
from orbitanalysis_tpu.utils import numerics as jnum
from orbitanalysis_tpu.utils import padding as jpad
from orbitanalysis_tpu_torch.engine import packing as tpk
from orbitanalysis_tpu_torch.ops import apsis as tapsis
from orbitanalysis_tpu_torch.ops import geometry as tgeo
from orbitanalysis_tpu_torch.ops import sorted_step as tss
from orbitanalysis_tpu_torch.utils import numerics as tnum
from orbitanalysis_tpu_torch.utils import padding as tpad

from helpers import make_callbacks

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# ----------------------------------------------------------------------
# geometry and numerics
# ----------------------------------------------------------------------

@pytest.mark.parametrize("box,mass,bulk,hubble", [
    (None, False, False, 0.0),
    (40.0, True, False, 0.0),
    (40.0, False, True, 0.07),
    ((40.0, 30.0, 50.0), True, False, 0.07),
    (None, True, True, 0.3),
])
def test_region_frame_matches_jax(box, mass, bulk, hubble):
    rng = np.random.default_rng(0)
    h, p = 4, 256
    pos = rng.uniform(0, 40, (h, p, 3)).astype(np.float32)
    vel = rng.normal(size=(h, p, 3)).astype(np.float32)
    valid = rng.random((h, p)) < 0.8
    center = rng.uniform(0, 40, (h, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2, (h, p)).astype(np.float32) if mass else None
    bv = rng.normal(size=(h, 3)).astype(np.float32) if bulk else None
    want = jgeo.region_frame(_j(pos), _j(vel), _j(valid), _j(center),
                             mass=_j(m), bulk_vel=_j(bv), box_size=box,
                             hubble_drag=jnp.float32(hubble))
    got = tgeo.region_frame(_t(pos), _t(vel), _t(valid), _t(center),
                            mass=_t(m), bulk_vel=_t(bv), box_size=box,
                            hubble_drag=hubble)
    for name in ("radius", "rhat", "vrad"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    # the masked mean reduces in another order: about one f32 ulp
    np.testing.assert_allclose(got.bulk_vel.numpy(),
                               np.asarray(want.bulk_vel),
                               rtol=2e-6, atol=1e-6)


def test_numerics_match_jax():
    rng = np.random.default_rng(1)
    dx = rng.uniform(-80, 80, (100, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tnum.periodic_displacement(_t(dx), 50.0).numpy(),
        np.asarray(jnum.periodic_displacement(_j(dx), 50.0)))
    np.testing.assert_allclose(
        tnum.vector_norm(_t(dx)).numpy(),
        np.asarray(jnum.vector_norm(_j(dx))), rtol=1e-6)
    assert tnum.hubble_parameter(0.5, 70, 0.3, 0.7) == \
        jnum.hubble_parameter(0.5, 70, 0.3, 0.7)
    a = rng.permutation(1000)
    b = rng.choice(a, 50, replace=False)
    np.testing.assert_array_equal(tnum.myin1d(a, b), jnum.myin1d(a, b))

    v = rng.normal(size=(3, 500)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0)
    v[:, 0] = 0.0  # zero vector: the +z pole
    enc = tnum.oct_encode(_t(v))
    np.testing.assert_array_equal(
        enc.numpy().view(np.uint32), np.asarray(jnum.oct_encode(_j(v))))
    np.testing.assert_allclose(
        tnum.oct_decode(enc).numpy(),
        np.asarray(jnum.oct_decode(jnp.asarray(enc.numpy().view(np.uint32)))),
        rtol=1e-6, atol=1e-6)


def test_padding_helpers_match_jax():
    rng = np.random.default_rng(2)
    lens = np.array([5, 0, 9, 3])
    vals = rng.normal(size=(lens.sum(), 3)).astype(np.float32)
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    rows = np.array([0, 2, 3, 5])
    got = tpad.pack_ragged(vals, offs, 6, 16, rows=rows, fill=-1.0)
    np.testing.assert_array_equal(
        got, jpad.pack_ragged(vals, offs, 6, 16, rows=rows, fill=-1.0))
    mask = rng.random((6, 16)) < 0.4
    arr = rng.normal(size=(6, 16))
    for r in (None, np.array([1, 3, 4])):
        for g, w in zip(tpad.unpack_mask(mask, arr, rows=r),
                        jpad.unpack_mask(mask, arr, rows=r)):
            np.testing.assert_array_equal(g, w)
    for n in (0, 1, 127, 128, 129, 70000):
        assert tpad.round_up(n) == jpad.round_up(n)
        assert tpad.round_up_pow2(n) == jpad.round_up_pow2(n)


@pytest.mark.parametrize("tier", ["native", "numpy"])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_stable_layout_matches_jax(monkeypatch, id_dtype, tier):
    """Same staged IDs, positions, slot permutations and FRESH flags as
    the JAX package's staging, on the native and on the NumPy host tier."""
    from orbitanalysis_tpu_torch import native

    if tier == "numpy":
        monkeypatch.setattr(native, "stable_align_native",
                            lambda *a, **k: None)
    elif native.ensure() is None:
        pytest.skip("no C++ compiler for the native host tier")
    rng = np.random.default_rng(3)
    h, p = 3, 64
    inv = np.iinfo(id_dtype).max
    base = np.int64(2) ** 40 if np.dtype(id_dtype).itemsize == 8 else 0
    lay_t = tpk.StableLayout(h, p, id_dtype)
    lay_j = jpk.StableLayout(h, p, id_dtype)
    for _ in range(6):
        ids = np.full((h, p), inv, id_dtype)
        for r in range(h):
            k = int(rng.integers(1, p + 1))
            ids[r, :k] = rng.choice(200, k, replace=False) + base
        pos = rng.normal(size=(h, p, 3)).astype(np.float32)
        vel = rng.normal(size=(h, p, 3)).astype(np.float32)
        mass = rng.uniform(0.5, 2, (h, p)).astype(np.float32)
        got = tpk.align_packed(lay_t, ids, pos, vel, mass)
        want = jpk.align_packed(lay_j, ids, pos, vel, mass)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(lay_t.layout, lay_j.layout)


# ----------------------------------------------------------------------
# steps
# ----------------------------------------------------------------------

@pytest.fixture
def churn():
    box = 60.0
    snaps, centers = churn_snapshots(3, 150, 8, box_size=box, seed=11)
    regions, loader = make_callbacks(snaps, centers, box_size=box)
    branches = np.tile(np.arange(3), (8, 1))
    loaded = []
    for s in range(8):
        rp, rr = regions(s, branches[s])
        loaded.append((rp, loader(s, rp, rr)))
    return box, loaded


def _batches(pk, hubble=0.0):
    jb = japsis.SnapshotBatch(
        ids=_j(pk.ids), pos=_j(pk.pos), vel=_j(pk.vel),
        center=_j(pk.center), mass=_j(pk.mass), bulk_vel=_j(pk.bulk_vel),
        hubble_drag=jnp.float32(hubble), slot=_j(pk.slot))
    tb = tapsis.SnapshotBatch(
        ids=_t(pk.ids), pos=_t(pk.pos), vel=_t(pk.vel), center=_t(pk.center),
        mass=_t(pk.mass), bulk_vel=_t(pk.bulk_vel), hubble_drag=hubble,
        slot=_t(pk.slot))
    return jb, tb


@pytest.mark.parametrize("mode", ["pericentric", "apocentric"])
def test_general_step_matches_jax(churn, mode):
    box, loaded = churn
    rows, P = np.arange(3), 256
    jstep = jax.jit(japsis.make_orbit_step(mode=mode, box_size=box,
                                           event_capacity=P))
    tstep = tapsis.make_orbit_step(mode=mode, box_size=box,
                                   event_capacity=P)
    jc, tc = japsis.init_carry(3, P), tapsis.init_carry(3, P, device="cpu")
    total = 0
    for rp, snap in loaded:
        pk = tpk.pack_snapshot(snap, rows, 3, P, rp)
        jb, tb = _batches(pk)
        jc, je = jstep(jc, jb)
        tc, te = tstep(tc, tb)
        count = te.ev_count.numpy()
        np.testing.assert_array_equal(count, np.asarray(je.ev_count))
        np.testing.assert_array_equal(te.apsis.numpy(), np.asarray(je.apsis))
        np.testing.assert_array_equal(te.matched_prev.numpy(),
                                      np.asarray(je.matched_prev))
        np.testing.assert_array_equal(te.entered.numpy(),
                                      np.asarray(je.entered))
        for h in range(3):
            n = count[h]
            total += n
            np.testing.assert_array_equal(te.ev_ids.numpy()[h, :n],
                                          np.asarray(je.ev_ids)[h, :n])
            _assert_angles_close(te.ev_angles.numpy()[h, :n],
                                 np.asarray(je.ev_angles)[h, :n], f16=True)
        np.testing.assert_array_equal(tc.ids.numpy(), np.asarray(jc.ids))
    assert total > 0


def test_static_step_matches_jax(churn):
    box, loaded = churn
    rows, P = np.arange(3), 256
    rp, snap = loaded[0]
    pk = tpk.pack_snapshot(snap, rows, 3, P, rp)
    jstep = jax.jit(japsis.make_static_orbit_step(box_size=box,
                                                  event_capacity=128))
    tstep = tapsis.make_static_orbit_step(box_size=box, event_capacity=128)
    jc, tc = japsis.init_carry(3, P), tapsis.init_carry(3, P, device="cpu")
    rng = np.random.default_rng(4)
    for s in range(4):
        pk = pk._replace(vel=pk.vel * np.float32(-1) + rng.normal(
            scale=0.1, size=pk.vel.shape).astype(np.float32))
        jb, tb = _batches(pk)
        jc, je = jstep(jc, jb)
        tc, te = tstep(tc, tb)
        np.testing.assert_array_equal(te.ev_count.numpy(),
                                      np.asarray(je.ev_count))
        np.testing.assert_array_equal(te.apsis.numpy(), np.asarray(je.apsis))


#: Absolute angle tolerance (rad).  XLA on the CPU contracts some a*b+c
#: into FMAs in region_frame and the Cephes arccos, eager torch does
#: not, so rhat and cos(dtheta) differ by a few f32 ulps; near
#: cos = 1 one ulp (2**-24) moves arccos by 2**-24 / sin(dtheta) —
#: f32 resolves such angles only to sqrt(2 * 2**-24) ~ 3.5e-4 rad.
ANGLE_ATOL = 1e-4


def _assert_angles_close(got, want, f16=False):
    """Angles agree to ANGLE_ATOL (plus rtol 1e-6 for large accumulated
    angles); f16-stored angles also pass within one f16 ulp."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    tol = ANGLE_ATOL + 1e-6 * np.abs(want)
    if f16:
        got = got.astype(np.float16).astype(np.float32)
        want = want.astype(np.float16).astype(np.float32)
        tol = np.maximum(tol, np.spacing(np.maximum(
            np.abs(got), np.abs(want)).astype(np.float16)).astype(np.float32))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _check_aligned_step(tev, jev, tcarry, jcarry, step):
    count = tev.count.numpy()
    np.testing.assert_array_equal(count, np.asarray(jev.count), err_msg=step)
    t_ids, j_ids = tev.ids.numpy(), np.asarray(jev.ids)
    t_ang, j_ang = tev.angles.numpy(), np.asarray(jev.angles)
    for h, n in enumerate(count):
        n = min(n, t_ids.shape[1])
        np.testing.assert_array_equal(t_ids[h, :n], j_ids[h, :n])
        _assert_angles_close(t_ang[h, :n], j_ang[h, :n], f16=True)
    tc = tss.aligned_carry_to_numpy(tcarry)
    jc = jax.tree.map(np.asarray, jcarry)
    np.testing.assert_array_equal(tc.key, jc.key)
    np.testing.assert_array_equal(tc.sv, jc.sv)
    np.testing.assert_array_equal(tc.packed >> 31, jc.packed >> 31)
    _assert_angles_close((tc.packed & np.uint32(0x7FFFFFFF)).view(np.float32),
                         (jc.packed & np.uint32(0x7FFFFFFF)).view(np.float32))
    np.testing.assert_allclose(tc.rhat, jc.rhat, rtol=1e-6, atol=1e-6)
    return int(count.sum())


@pytest.mark.parametrize("mode,hubble", [("pericentric", 0.0),
                                         ("apocentric", 0.05)])
def test_aligned_step_matches_jax(churn, mode, hubble):
    """8 churn snapshots, each package staging with its own
    pack_snapshot_aligned: identical staged tables, identical event
    positions and counts, identical carry keys, slots and match bits;
    angles within ANGLE_ATOL (f16 event angles also within one ulp)."""
    box, loaded = churn
    rows, P, K = np.arange(3), 256, 128
    lay_t, lay_j = tpk.StableLayout(3, P), jpk.StableLayout(3, P)
    jstep = jax.jit(jss.make_aligned_native_step(K, mode=mode, box_size=box))
    tstep = tss.make_aligned_native_step(K, mode=mode, box_size=box)
    jc, tc = jss.init_aligned_carry(3, P), tss.init_aligned_carry(
        3, P, device="cpu")
    total = 0
    for s, (rp, snap) in enumerate(loaded):
        pk = tpk.pack_snapshot_aligned(snap, rows, 3, lay_t, rp)
        pk_j = jpk.pack_snapshot_aligned(snap, rows, 3, lay_j, rp)
        np.testing.assert_array_equal(pk.ids, pk_j.ids)
        np.testing.assert_array_equal(pk.slot, pk_j.slot)
        np.testing.assert_array_equal(pk.pos, pk_j.pos)
        jb, tb = _batches(pk, hubble)
        jc, je = jstep(jc, jb)
        tc, te = tstep(tc, tb)
        total += _check_aligned_step(te, je, tc, jc, s)
    assert total > 0


def test_aligned_carry_crosses_from_jax(churn):
    """Run JAX for 4 steps, hand its carry to the port through
    aligned_carry_from_numpy, continue both: same events and carries."""
    box, loaded = churn
    rows, P, K = np.arange(3), 256, 128
    lay = tpk.StableLayout(3, P)
    jstep = jax.jit(jss.make_aligned_native_step(K, box_size=box))
    tstep = tss.make_aligned_native_step(K, box_size=box)
    jc = jss.init_aligned_carry(3, P)
    tc = None
    total = 0
    for s, (rp, snap) in enumerate(loaded):
        pk = tpk.pack_snapshot_aligned(snap, rows, 3, lay, rp)
        jb, tb = _batches(pk)
        if s == 4:
            tc = tss.aligned_carry_from_numpy(
                *jax.tree.map(np.asarray, jc), device="cpu")
            back = tss.aligned_carry_to_numpy(tc)
            for a, b in zip(back, jax.tree.map(np.asarray, jc)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        jc, je = jstep(jc, jb)
        if tc is not None:
            tc, te = tstep(tc, tb)
            total += _check_aligned_step(te, je, tc, jc, s)
    assert total > 0
    # the host codecs agree with the JAX package's, bit for bit
    jnp_carry = jax.tree.map(np.asarray, jc)
    dec = tss.decode_aligned_carry(jnp_carry)
    jdec = jss.decode_aligned_carry(jnp_carry)
    for a, b in zip(dec, jdec):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tss.encode_aligned_carry(dec),
                    jss.encode_aligned_carry(jdec)):
        np.testing.assert_array_equal(a, b)


def test_general_carry_crosses_from_jax(churn):
    box, loaded = churn
    rows, P = np.arange(3), 256
    jstep = jax.jit(japsis.make_orbit_step(box_size=box, event_capacity=P))
    tstep = tapsis.make_orbit_step(box_size=box, event_capacity=P)
    jc = japsis.init_carry(3, P)
    tc = None
    for s, (rp, snap) in enumerate(loaded):
        pk = tpk.pack_snapshot(snap, rows, 3, P, rp)
        jb, tb = _batches(pk)
        if s == 3:
            tc = tapsis.carry_from_numpy(*jax.tree.map(np.asarray, jc),
                                         device="cpu")
            for a, b in zip(tapsis.carry_to_numpy(tc),
                            jax.tree.map(np.asarray, jc)):
                np.testing.assert_array_equal(a, b)
        jc, je = jstep(jc, jb)
        if tc is not None:
            tc, te = tstep(tc, tb)
            np.testing.assert_array_equal(te.ev_count.numpy(),
                                          np.asarray(je.ev_count))
            np.testing.assert_array_equal(te.apsis.numpy(),
                                          np.asarray(je.apsis))


def _ceiling_batch(slot, vx, fresh):
    """[1, P] batch: particles at +x radius 1, radial velocity vx."""
    p = len(vx)
    pos = np.zeros((1, p, 3), np.float32)
    pos[0, :, 0] = 1.0
    vel = np.zeros((1, p, 3), np.float32)
    vel[0, :, 0] = vx
    return tpk.PackedSnapshot(
        ids=np.arange(p, dtype=np.int32)[None], pos=pos, vel=vel, mass=None,
        center=np.zeros((1, 3), np.float32),
        bulk_vel=np.zeros((1, 3), np.float32), lengths=np.array([p]),
        rows=np.array([0]),
        slot=slot[None] | (tpk.FRESH_BIT if fresh else np.int32(0)))


@pytest.mark.parametrize("p", [1 << 16, 1 << 17])
def test_aligned_step_last_position_event(p):
    """Events at the last row position decode exactly on both payload
    formats: at P = 65536 the single word's top bit is set for the last
    positions (the int32 decode must mask after its shift); at P = 131072
    pos + 1 = 2**17 does not fit the word and the step takes the pair
    compaction — as the JAX step does."""
    fire = np.array([0, 12345, p - 1])
    slot = np.arange(p, dtype=np.int32)
    vx0 = np.full(p, -1.0, np.float32)
    vx1 = vx0.copy()
    vx1[fire] = 1.0
    jstep = jss.make_aligned_native_step(256)
    tstep = tss.make_aligned_native_step(256, emit_payload=True)
    jc, tc = jss.init_aligned_carry(1, p), tss.init_aligned_carry(
        1, p, device="cpu")
    for vx, fresh in ((vx0, True), (vx1, False)):
        jb, tb = _batches(_ceiling_batch(slot, vx, fresh))
        jc, je = jstep(jc, jb)
        tc, te = tstep(tc, tb)
    assert int(te.count[0]) == len(fire) == int(np.asarray(je.count)[0])
    np.testing.assert_array_equal(te.ids.numpy()[0, :3], fire)
    np.testing.assert_array_equal(np.asarray(je.ids)[0, :3], fire)
    assert isinstance(te.payload, tuple) == (p > tss.PAYLOAD_MAX_ROW)


def test_aligned_step_rejects_what_it_cannot_run():
    with pytest.raises(NotImplementedError, match="K17"):
        tss.make_aligned_native_step(128, detect_impl="pallas")
    with pytest.raises(ValueError, match="float32"):
        tss.make_aligned_native_step(128, angle_dtype=np.float16)
    with pytest.raises(ValueError, match="32-bit"):
        tss.make_aligned_native_step(128, id_dtype=np.int64)


def test_port_runs_without_jax(tmp_path):
    """With jax, the JAX package and h5py blocked, the port imports and
    runs its public surface (the three engines, in-memory savefiles, a
    small label-native scan and a small sorted scan)."""
    script = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "orbitanalysis_tpu", "h5py"):
            sys.modules[name] = None
        sys.path[:0] = [{REPO!r}, {os.path.join(REPO, "tests")!r}]
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import orbitanalysis_tpu_torch as ot
        from orbitanalysis_tpu_torch.engine.io_hdf5 import MemoryWriter
        from orbitanalysis_tpu_torch.models.synthetic import churn_snapshots
        from helpers import make_callbacks

        assert ot.myin1d([5, 3, 9], [9, 5]).tolist() == [2, 0]
        assert ot.hubble_parameter(0.0, 70.0, 0.3, 0.7) == 70.0
        ot.vector_norm(torch.ones(2, 3))
        ot.recenter_coordinates(torch.ones(2, 3), 1.5)
        snaps, centers = churn_snapshots(2, 60, 4, box_size=30.0, seed=1)
        regions, loader = make_callbacks(snaps, centers, box_size=30.0)
        files = []
        for join in ("aligned", "general", "sorted"):
            w = MemoryWriter()
            ot.track_orbits(np.arange(4), np.tile(np.arange(2), (4, 1)),
                            regions, loader, "mem.h5", verbose=False,
                            join_impl=join, device="cpu", writer=w)
            files.append(w.files["mem.h5"])
        a = files[0]
        for b in files[1:]:
            assert sorted(a) == sorted(b)
            for g in a:
                if g != "attrs":
                    assert np.array_equal(a[g]["pericenter_IDs"],
                                          b[g]["pericenter_IDs"])
        # the sorted engine's scan on the bench's ID-form sequence
        from orbitanalysis_tpu_torch.engine.scan import scan_events_sorted
        from orbitanalysis_tpu_torch.models.synthetic import churn_workload
        from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch
        from orbitanalysis_tpu_torch.ops import sorted_step as ss
        ids, pos, vel, cen, _ = churn_workload(2, 256, 4)
        staged = ss.presort_snapshot(
            SnapshotBatch(ids=ids, pos=pos, vel=vel, center=cen), soa=True)
        sc = []
        for kw in (dict(fused=True), dict(merge_impl="pallas",
                                          compact_impl="pallas")):
            _, (cnt, _, _) = scan_events_sorted(
                ss.init_sorted_carry(2, 256, device="cpu"), staged, 128,
                box_size=100.0, cur_presorted=True, soa_batch=True, **kw)
            sc.append(cnt.numpy())
        assert sc[0].sum() > 0 and np.array_equal(sc[0], sc[1])
        # the label-native detector, through every route it ports
        from orbitanalysis_tpu_torch.models.synthetic import (
            label_churn_workload)
        from orbitanalysis_tpu_torch.ops import label_step as ls
        lab, pos, vel, cen, _ = label_churn_workload(2, 512, 4)
        counts = []
        for frames in ("auto", "split", "pallas2", "twolevel", "matmul"):
            c = ls.init_label_carry(lab.shape[1], row_width=512,
                                    rhat_packed=True, device="cpu")
            c, ev = ls.scan_label_events(
                c, pos, vel, lab, cen, event_capacity=64, box_size=100.0,
                row_width=512, frames=frames, rhat_packed=True)
            counts.append(ev.count.numpy())
        assert counts[0].sum() > 0
        assert all(np.array_equal(c, counts[0]) for c in counts)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "orbitanalysis_tpu", "h5py")
               and sys.modules[m] is not None]
        assert not bad, bad
        print("PORT_OK")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "PORT_OK" in out.stdout
