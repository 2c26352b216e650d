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
from orbitanalysis_tpu.ops import pallas_step as jps
from orbitanalysis_tpu.ops import sorted_step as jss
from orbitanalysis_tpu.utils import numerics as jnum
from orbitanalysis_tpu.utils import padding as jpad
from orbitanalysis_tpu_torch.engine import packing as tpk
from orbitanalysis_tpu_torch.ops import apsis as tapsis
from orbitanalysis_tpu_torch.ops import geometry as tgeo
from orbitanalysis_tpu_torch.ops import sorted_step as tss
from orbitanalysis_tpu_torch.ops import step as tstep_mod
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
    """The JAX package's errors: float32 angles and 32-bit IDs only, and
    no r-hat words or payload plane on the fused detect kernel."""
    for make in (tss.make_aligned_native_step, tss.make_aligned_orbit_step,
                 jss.make_aligned_native_step):
        with pytest.raises(ValueError, match="float32"):
            make(128, angle_dtype=np.float16)
        with pytest.raises(ValueError, match="32-bit"):
            make(128, id_dtype=np.int64)
    for make in (tss.make_aligned_native_step, jss.make_aligned_native_step):
        with pytest.raises(ValueError, match="rhat_packed requires"):
            make(128, detect_impl="pallas", rhat_packed=True)
        with pytest.raises(ValueError, match="emit_payload requires"):
            make(128, detect_impl="pallas", emit_payload=True)
        with pytest.raises(ValueError, match="unknown detect_impl"):
            make(128, detect_impl="cuda")


# ----------------------------------------------------------------------
# the aligned detect kernel (K17) and the steps that run it
# ----------------------------------------------------------------------

def _static_inputs(seed, native, pericentric, h=5, p=256):
    """Aligned prev/cur planes of one K17 call, as uint32/f32 NumPy: cur
    keys with padding (the sentinel key) and IDs near 2**31, random sign
    bits, FRESH on ~10 % of lanes (bit 27 of the cur sv when native,
    else of the prev sv), accumulated prev angles (native: packed carry
    words with random match bits), unit r-hat.  Row 1 is a full row:
    every lane valid, unfresh and flipping in the ``pericentric`` mode's
    sense, so its count is P."""
    rng = np.random.default_rng(seed)
    inv = np.iinfo(np.int32).max
    ids = rng.choice(2**31 - 2, size=(h, p), replace=False).astype(np.int64)
    ids[0, -16:] = 2**31 - 2 - np.arange(16)       # keys past 2**31
    pad = rng.random((h, p)) < 0.15
    pad[1] = False
    ids = np.where(pad, inv, ids)
    ck = ((ids.astype(np.uint64) << 1) | 1).astype(np.uint32)

    def sv():
        return (rng.permutation(p * h).reshape(h, p).astype(np.int32) % p
                | (rng.integers(0, 4, (h, p)).astype(np.int32) << 24))

    psv, csv = sv(), sv()
    fresh = rng.random((h, p)) < 0.1
    fresh[1] = False
    if native:
        csv |= fresh.astype(np.int32) << 27
    else:
        psv |= fresh.astype(np.int32) << 27
    before, now = (1, 2) if pericentric else (2, 1)
    psv[1] = (psv[1] & 0xFFFFFF) | (before << 24)
    csv[1] = (csv[1] & 0xFFFFFF) | (now << 24)

    def unit():
        v = rng.normal(size=(3, h, p)).astype(np.float32)
        return v / np.linalg.norm(v, axis=0)

    prh, crh = unit(), unit()
    ang = rng.uniform(0, 9, (h, p)).astype(np.float32)
    pang = (ang.view(np.uint32) | (rng.integers(0, 2, (h, p)).astype(
        np.uint32) << np.uint32(31))) if native else ang
    pk = (ids.astype(np.uint64) << 1).astype(np.uint32)
    return (pk, psv, *prh, pang), (ck, csv, *crh)


def _np_i32(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("pericentric", [True, False])
@pytest.mark.parametrize("native", [True, False])
def test_static_detect_matches_jax(native, pericentric):
    """K17: the plain version against the JAX kernel (interpret mode) in
    both modes, FRESH lanes, padding keys and a full row included: the
    packed carry's match bits, counts, event keys and prev sv exact;
    angles within ANGLE_ATOL."""
    prev, cur = _static_inputs(3 + native + 2 * pericentric, native,
                               pericentric)
    inv = np.iinfo(np.int32).max
    k = 128
    want = [np.asarray(x) for x in jps.fused_static_detect(
        tuple(map(jnp.asarray, prev)), tuple(map(jnp.asarray, cur)),
        pericentric, inv, k, native=native)]
    got = tstep_mod.fused_static_detect(
        tuple(map(_np_i32, prev)), tuple(map(_np_i32, cur)), pericentric,
        inv, k, native=native)
    assert torch.equal(got[0], tstep_mod.fused_static_detect_torch(
        tuple(map(_np_i32, prev)), tuple(map(_np_i32, cur)), pericentric,
        inv, k, native=native)[0])
    count = got[4].numpy()
    np.testing.assert_array_equal(count, want[4])
    assert count[1] == prev[0].shape[1] > k and count.sum() > count[1]
    packed = got[0].numpy().view(np.uint32)
    np.testing.assert_array_equal(packed >> 31, want[0] >> 31)
    _assert_angles_close((packed & np.uint32(0x7FFFFFFF)).view(np.float32),
                         (want[0] & np.uint32(0x7FFFFFFF)).view(np.float32))
    for h, n in enumerate(np.minimum(count, k)):
        np.testing.assert_array_equal(
            got[1].numpy()[h, :n].view(np.uint32), want[1][h, :n])
        np.testing.assert_array_equal(got[2].numpy()[h, :n], want[2][h, :n])
        _assert_angles_close(got[3].numpy()[h, :n], want[3][h, :n])
        assert (got[1].numpy()[h, n:] == 0).all()


def _staged(loaded, lay, rows, soa=False):
    """Each loaded snapshot staged aligned: (PackedSnapshot, JAX batch,
    port batch); ``soa`` stages pos/vel as [3, H, P] planes."""
    out = []
    for rp, snap in loaded:
        pk = tpk.pack_snapshot_aligned(snap, rows, 3, lay, rp)
        if soa:
            pk = pk._replace(
                pos=np.ascontiguousarray(np.moveaxis(pk.pos, -1, 0)),
                vel=np.ascontiguousarray(np.moveaxis(pk.vel, -1, 0)))
        out.append((pk, *_batches(pk)))
    return out


@pytest.mark.parametrize("id_order", [True, False])
@pytest.mark.parametrize("mode", ["pericentric", "apocentric"])
def test_aligned_pallas_step_matches_jax(churn, mode, id_order):
    """make_aligned_native_step(detect_impl='pallas') on 8 churn
    snapshots: counts, event positions and prev load slots exact, carry
    keys, sv and match bits exact, angles within ANGLE_ATOL."""
    box, loaded = churn
    P, K = 256, 128
    kw = dict(mode=mode, box_size=box, detect_impl="pallas",
              events_id_order=id_order)
    jstep = jax.jit(jss.make_aligned_native_step(K, **kw))
    tstep = tss.make_aligned_native_step(K, **kw)
    jc, tc = jss.init_aligned_carry(3, P), tss.init_aligned_carry(
        3, P, device="cpu")
    total = 0
    for s, (pk, jb, tb) in enumerate(_staged(loaded, tpk.StableLayout(3, P),
                                             np.arange(3))):
        jc, je = jstep(jc, jb)
        tc, te = tstep(tc, tb)
        total += _check_aligned_step(te, je, tc, jc, s)
        if id_order:
            for h, n in enumerate(te.count.numpy()):
                np.testing.assert_array_equal(te.slots.numpy()[h, :n],
                                              np.asarray(je.slots)[h, :n])
        else:
            assert te.slots is None and je.slots is None
    assert total > 0


@pytest.mark.parametrize("id_order", [True, False])
def test_legacy_aligned_step_matches_jax(churn, id_order):
    """The legacy select-staged step (SortedCarry, K17 with native=False)
    on 8 churn snapshots: counts, event IDs and prev load slots exact,
    carry IDs, slots and sign/match bits exact, angles and r-hat within
    ANGLE_ATOL."""
    box, loaded = churn
    P, K = 256, 128
    kw = dict(box_size=box, events_id_order=id_order)
    jstep = jax.jit(jss.make_aligned_orbit_step(K, **kw))
    tstep = tss.make_aligned_orbit_step(K, **kw)
    jc = jss.init_sorted_carry(3, P)
    tc = tss.init_sorted_carry(3, P, device="cpu")
    total = 0
    for pk, jb, tb in _staged(loaded, tpk.StableLayout(3, P), np.arange(3)):
        jc, je = jstep(jc, jb)
        tc, te = tstep(tc, tb)
        count = te.count.numpy()
        np.testing.assert_array_equal(count, np.asarray(je.count))
        for h, n in enumerate(count):
            total += n
            np.testing.assert_array_equal(te.ids.numpy()[h, :n],
                                          np.asarray(je.ids)[h, :n])
            _assert_angles_close(te.angles.numpy()[h, :n],
                                 np.asarray(je.angles)[h, :n])
            if id_order:
                np.testing.assert_array_equal(te.slots.numpy()[h, :n],
                                              np.asarray(je.slots)[h, :n])
        got = tss.sorted_carry_to_numpy(tc)
        want = jax.tree.map(np.asarray, jc)
        for f in ("ids", "slot", "vrb"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        _assert_angles_close(got.angles, want.angles)
        np.testing.assert_allclose(got.rhat, want.rhat, rtol=1e-6, atol=1e-6)
    assert total > 0


@pytest.mark.parametrize("rhat_packed,soa", [(True, False), (False, True)])
def test_aligned_step_options_match_jax(churn, rhat_packed, soa):
    """The default step with octahedral r-hat words in the carry, and
    with SoA-staged batches: the JAX step's events and carries."""
    box, loaded = churn
    P, K = 256, 128
    kw = dict(box_size=box, rhat_packed=rhat_packed, soa_batch=soa)
    jstep = jax.jit(jss.make_aligned_native_step(K, **kw))
    tstep = tss.make_aligned_native_step(K, **kw)
    jc = jss.init_aligned_carry(3, P, rhat_packed=rhat_packed)
    tc = tss.init_aligned_carry(3, P, rhat_packed=rhat_packed, device="cpu")
    total = 0
    for s, (pk, jb, tb) in enumerate(_staged(
            loaded, tpk.StableLayout(3, P), np.arange(3), soa=soa)):
        jc, je = jstep(jc, jb)
        tc, te = tstep(tc, tb)
        if rhat_packed:
            got = tss.aligned_carry_to_numpy(tc).rhat
            want = np.asarray(jc.rhat)
            assert got.dtype == want.dtype == np.uint32
            np.testing.assert_allclose(
                tnum.oct_decode(_np_i32(got)).numpy(),
                np.asarray(jnum.oct_decode(jnp.asarray(want))), atol=1e-4)
            tc_cmp = tc._replace(rhat=torch.zeros(3, 3, P))
            jc_cmp = jc._replace(rhat=jnp.zeros((3, 3, P)))
        else:
            tc_cmp, jc_cmp = tc, jc
        total += _check_aligned_step(te, je, tc_cmp, jc_cmp, s)
    assert total > 0


@pytest.mark.parametrize("pos_dtype", [np.float32, np.float16])
def test_aligned_carry_pos_dtype_matches_jax(churn, pos_dtype):
    """``init_aligned_carry(pos_dtype=)``, positionally as JAX takes it:
    the same r-hat planes (dtype and zeros), and the steps from that
    carry give the JAX steps' events and carries."""
    box, loaded = churn
    P, K = 256, 128
    jc = jss.init_aligned_carry(3, P, pos_dtype)
    tc = tss.init_aligned_carry(3, P, pos_dtype, device="cpu")
    want = jax.tree.map(np.asarray, jc)
    got = tss.aligned_carry_to_numpy(tc)
    assert got.rhat.dtype == want.rhat.dtype == np.dtype(pos_dtype)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    jstep = jax.jit(jss.make_aligned_native_step(K, box_size=box))
    tstep = tss.make_aligned_native_step(K, box_size=box)
    total = 0
    for s, (pk, jb, tb) in enumerate(_staged(
            loaded[:4], tpk.StableLayout(3, P), np.arange(3))):
        jc, je = jstep(jc, jb)
        tc, te = tstep(tc, tb)
        total += _check_aligned_step(te, je, tc, jc, s)
    assert total > 0


def test_port_runs_without_jax(tmp_path):
    """With jax, the JAX package and h5py blocked, the port imports and
    runs its public surface (the three engines, in-memory savefiles, a
    small label-native scan, a small sorted scan, a 'fused' label step,
    a legacy aligned step, and the distributed engines in a world of
    one: ``parallel``'s sharded sorted and hash steps and
    ``track_orbits(mesh=)``)."""
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
        c = ls.init_label_carry(lab.shape[1], row_width=512, device="cpu")
        fused = ls.make_label_orbit_step(64, box_size=100.0, row_width=512,
                                         frames="fused")
        for s in range(2):
            c, ev = fused(c, (torch.from_numpy(pos[s]),
                              torch.from_numpy(vel[s]),
                              torch.from_numpy(lab[s]),
                              torch.from_numpy(cen[s]), None, None, 0.0))
        assert ev.count.shape == (2,)
        # the legacy aligned step on the same ID-form sequence, staged in
        # the stable layout
        from orbitanalysis_tpu_torch.engine.packing import (
            StableLayout, align_packed)
        ids, pos, vel, cen, _ = churn_workload(2, 256, 4)
        lay = StableLayout(2, 256)
        legacy = ss.make_aligned_orbit_step(128, box_size=100.0)
        lc = ss.init_sorted_carry(2, 256, device="cpu")
        n_legacy = 0
        for s in range(4):
            a_ids, a_pos, a_vel, _, a_slot = align_packed(
                lay, ids[s], pos[s], vel[s])
            lc, lev = legacy(lc, SnapshotBatch(
                ids=torch.from_numpy(a_ids), pos=torch.from_numpy(a_pos),
                vel=torch.from_numpy(a_vel), center=torch.from_numpy(cen[s]),
                slot=torch.from_numpy(a_slot)))
            n_legacy += int(lev.count.sum())
        assert n_legacy == int(sc[0].sum())
        # the distributed engines: a world of one (no process group)
        # runs a halo-sharded sorted step, a hash-sharded step and
        # track_orbits(mesh=) on the halo and the shards axis
        from orbitanalysis_tpu_torch import parallel
        from orbitanalysis_tpu_torch.parallel import hash_sharded as hs
        mesh = parallel.make_mesh({{"halos": 1}}, device="cpu")
        sstep = parallel.make_sharded_sorted_step(
            mesh, 128, box_size=100.0, fused=True, cur_presorted=True,
            soa_batch=True)
        carry = parallel.shard_tree(ss.init_sorted_carry(2, 256,
                                                         device="cpu"), mesh)
        n_sharded = 0
        for s in range(4):
            carry, ev = sstep(carry, parallel.shard_tree(SnapshotBatch(
                ids=staged.ids[s], pos=staged.pos[s], vel=staged.vel[s],
                center=staged.center[s], slot=staged.slot[s]), mesh))
            n_sharded += int(ev.count.sum())
        assert n_sharded == int(sc[0].sum())
        hmesh = parallel.make_mesh({{"shards": 1}}, device="cpu")
        hstep = hs.make_hash_sharded_step(hmesh, 2, 256, box_size=30.0)
        flat = dict(halo=np.zeros(60, np.int32), ids=np.arange(60),
                    pos=np.random.default_rng(0).normal(size=(60, 3)),
                    vel=np.random.default_rng(1).normal(size=(60, 3)))
        hc, hev = hstep(
            hs.init_hash_carry(1, 256, 2, device="cpu"),
            parallel.sharding.shard_rows(hs.route_flat(flat, 1, 256), hmesh,
                                         "shards"),
            torch.zeros(2, 3))
        assert int(hev.count[0]) == 0 and hc.ids.shape == (1, 256)
        for m in (mesh, hmesh):
            w = MemoryWriter()
            ot.track_orbits(np.arange(4), np.tile(np.arange(2), (4, 1)),
                            regions, loader, "mem.h5", verbose=False,
                            device="cpu", writer=w, mesh=m,
                            join_impl="general" if m is mesh else "auto")
            for g in files[1]:
                if g != "attrs":
                    assert np.array_equal(w.files["mem.h5"][g]["pericenter_IDs"],
                                          files[1][g]["pericenter_IDs"])
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
