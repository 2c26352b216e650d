"""The port's label-native detector (orbitanalysis_tpu_torch.ops.
label_step, frames, label, compact) against the JAX package on the CPU.

The JAX Pallas kernels run in interpret mode, as tests/test_label.py runs
them; the port's kernels run their plain-torch versions (the CUDA kernels
are held against these on the card by tests/test_torch_cuda.py).  Inputs
come from seeded NumPy and reach both packages as the same bits.

Tolerances: counts, event positions, ``lab_sv`` and the matched bit are
exact.  Angles and radial unit vectors agree to 1e-4 rad or one f16 ulp:
XLA on the CPU contracts some a*b+c into FMAs and eager torch does not
(ANGLE_ATOL in tests/test_torch_step.py), and the octahedral r-hat
quantizes the carried direction.  Bulk-velocity moments agree to
rtol = atol = 2e-6, the class of tests/test_label.py: the sums are taken
in another order.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbitanalysis_tpu.ops import label_step as jls
from orbitanalysis_tpu.ops import pallas_compact as jpc
from orbitanalysis_tpu.ops import pallas_frames as jpf
from orbitanalysis_tpu.ops import pallas_label as jpl
from orbitanalysis_tpu.utils import numerics as jnum
from orbitanalysis_tpu_torch.ops import compact as tc
from orbitanalysis_tpu_torch.ops import frames as tf
from orbitanalysis_tpu_torch.ops import label as tl
from orbitanalysis_tpu_torch.ops import label_step as tls

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, R, W, S = 7, 4, 1024, 6
N = R * W
ANGLE_ATOL = 1e-4


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(x):
    return np.asarray(x)


def _pool(seed=0, h=H, r=R, w=W, s=S, burst=False):
    """Uniform positions, normal velocities, labels that keep 90 % of
    their value per snapshot; ``burst`` makes snapshots 2-3 flip every
    particle of halo 0 inward -> outward at once (dense event rows).  The
    burst moves each particle off its radial line a little, so no angle
    sits at arccos(1), where float32 resolves only ~3.5e-4 rad."""
    rng = np.random.default_rng(seed)
    n = r * w
    pos = rng.uniform(0, 100, (s, 3, n)).astype(np.float32)
    vel = rng.normal(size=(s, 3, n)).astype(np.float32)
    lab = rng.integers(-1, h, (s, n)).astype(np.int32)
    cen = rng.uniform(20, 80, (s, h, 3)).astype(np.float32)
    for i in range(1, s):
        keep = rng.random(n) < 0.9
        lab[i] = np.where(keep, lab[i - 1], lab[i])
    if burst:
        u = rng.normal(size=(n, 3)).astype(np.float32)
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        lab[2] = lab[3] = 0
        pos[2] = (cen[2, 0] + 3.0 * u).T
        vel[2] = (-1.0 * u).T
        off = rng.normal(scale=0.3, size=(n, 3)).astype(np.float32)
        pos[3] = (cen[3, 0] + 2.5 * u + off).T
        vel[3] = (1.0 * u).T
    return pos, vel, lab, cen


def _f16_close(got, want):
    """Within ANGLE_ATOL, or within one f16 ulp of each other."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)).astype(np.float16))
    ok = np.abs(got - want) <= np.maximum(ANGLE_ATOL, ulp.astype(np.float32))
    assert ok.all(), np.abs(got - want).max()


def _rhat_close(got, want, packed):
    """Carried r-hat: f32 planes within ANGLE_ATOL, octahedral words
    within ANGLE_ATOL once decoded."""
    got, want = np.asarray(got), np.asarray(want)
    if packed:
        got = np.asarray(jnum.oct_decode(jnp.asarray(got.view(np.uint32))))
        want = np.asarray(jnum.oct_decode(jnp.asarray(want.view(np.uint32))))
    np.testing.assert_allclose(got, want, rtol=0, atol=ANGLE_ATOL)


def _check_carry(tcarry, jcarry, packed):
    got = tls.label_carry_to_numpy(tcarry)
    want = jax.tree.map(np.asarray, jcarry)
    np.testing.assert_array_equal(got.lab_sv, want.lab_sv)
    np.testing.assert_array_equal(got.packed >> 31, want.packed >> 31)
    _f16_close((got.packed & np.uint32(0x7FFFFFFF)).view(np.float32),
               (want.packed & np.uint32(0x7FFFFFFF)).view(np.float32))
    _rhat_close(got.rhat, want.rhat, packed)


def _check_events(tev, jev, bulk_rtol=2e-6):
    count = tev.count.numpy()
    np.testing.assert_array_equal(count, _np(jev.count))
    np.testing.assert_array_equal(tev.index.numpy(), _np(jev.index))
    _f16_close(tev.angle.numpy(), _np(jev.angle))
    np.testing.assert_allclose(tev.bulk_vel.numpy(), _np(jev.bulk_vel),
                               rtol=bulk_rtol, atol=bulk_rtol)
    return int(count.sum())


# ----------------------------------------------------------------------
# kernels' plain versions against the JAX kernels
# ----------------------------------------------------------------------

@pytest.mark.parametrize("density", [0.0, 0.017, 0.07, 0.5, 1.0, "burst"])
def test_payload_compaction_matches_jax(density):
    """K4/K5: compact_payload_torch against compact_payload and
    compact_payload_blocked, events front-packed in position order."""
    rng = np.random.default_rng(7)
    h, p, k = 3, 2048, 256
    if density == "burst":
        sel = rng.random((h, p)) < 0.01
        sel[0, 300:340] = True           # more than BLOCK_CAP in one block
        sel[2, 1024:] = True
    else:
        sel = rng.random((h, p)) < density
    ang = rng.integers(0, 0x7BFF, (h, p)).astype(np.uint32)
    pos1 = np.arange(1, p + 1, dtype=np.uint32)
    pay = np.where(sel, (pos1 << np.uint32(15)) | ang, np.uint32(0))
    got = tc.compact_payload_torch(_i32(pay), k).numpy().view(np.uint32)
    counts = np.minimum(sel.sum(axis=1), got.shape[1])
    for entry in (jpc.compact_payload, jpc.compact_payload_blocked):
        want = np.asarray(entry(jnp.asarray(pay), k))
        assert want.shape == got.shape
        for r, n in enumerate(counts):
            np.testing.assert_array_equal(got[r, :n], want[r, :n])
            assert (got[r, n:] == 0).all()
    for entry in (tc.compact_payload, tc.compact_payload_blocked):
        assert torch.equal(entry(_i32(pay), k),
                           tc.compact_payload_torch(_i32(pay), k))


def test_frame_rows_matches_jax():
    """K6: the plain gather equals the bf16x3 one-hot kernel bit for bit,
    over a wide exponent range, with -1 labels and labels past H."""
    rng = np.random.default_rng(1)
    table = (rng.normal(size=(H, 6))
             * np.exp2(rng.integers(-40, 40, size=(H, 6)))).astype(np.float32)
    idx = rng.integers(-1, H + 2, size=N).astype(np.int32)
    want = np.asarray(jpf.frame_rows_bf16x3(jnp.asarray(table),
                                            jnp.asarray(idx)))
    got = tf.frame_rows(_t(table), _t(idx.reshape(R, W))).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tf.frame_rows_torch(_t(table), _t(idx)),
                                  got)


@pytest.mark.parametrize("mass", [False, True])
def test_segment_moments_match_jax(mass):
    """K7: the chunked one-hot moments against segment_moments_bf16x3."""
    rng = np.random.default_rng(2)
    idx = rng.integers(-1, H + 1, size=N).astype(np.int32)
    vel = rng.normal(size=(3, N)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, size=N).astype(np.float32) if mass else None
    want = np.asarray(jpf.segment_moments_bf16x3(
        jnp.asarray(idx), jnp.asarray(vel),
        None if m is None else jnp.asarray(m), n_halos=H))
    got = tf.segment_moments(_t(idx), _t(vel), _t(m), n_halos=H).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    # and against a float64 NumPy segment sum
    ok = (idx >= 0) & (idx < H)
    w = np.ones(N) if m is None else m.astype(np.float64)
    for h in range(H):
        sel = ok & (idx == h)
        ref = np.concatenate([(vel[:, sel] * w[sel]).sum(1), [w[sel].sum()]])
        np.testing.assert_allclose(got[h], ref, rtol=2e-6, atol=2e-6)


def _detect_inputs(seed, packed, steps=3, h=H, r=R, w=W):
    """Frame rows and carry planes after ``steps`` JAX 'matmul' steps, so
    matched lanes exist, for ``h`` halos on ``[r, w]`` rows; returns (JAX
    carry, rows, lab, pos, vel, table)."""
    pos, vel, lab, cen = _pool(seed, h=h, r=r, w=w)
    step = jax.jit(jls.make_label_orbit_step(
        128, box_size=100.0, row_width=w, frames="matmul",
        rhat_packed=packed))
    c = jls.init_label_carry(r * w, row_width=w, rhat_packed=packed)
    bulk = np.random.default_rng(seed).normal(size=(h, 3)).astype(np.float32)
    for s in range(steps):
        c, _ = step(c, (jnp.asarray(pos[s].reshape(3, r, w)),
                        jnp.asarray(vel[s].reshape(3, r, w)),
                        jnp.asarray(lab[s].reshape(r, w)),
                        jnp.asarray(cen[s]), jnp.asarray(bulk), None,
                        jnp.float32(0.01)))
    s = steps
    table = np.concatenate([cen[s], bulk], axis=1)
    rows = np.asarray(jpf.frame_rows_bf16x3(jnp.asarray(table),
                                            jnp.asarray(lab[s])))
    return (c, rows.reshape(6, r, w), lab[s].reshape(r, w),
            pos[s].reshape(3, r, w), vel[s].reshape(3, r, w), table)


@pytest.mark.parametrize("mode", ["pericentric", "apocentric"])
@pytest.mark.parametrize("packed", [False, True])
def test_detect_kernels_match_jax(mode, packed):
    """K8/K9: the plain detect chain against detect_label_pallas and
    detect_label_compact_pallas on a carry with matched lanes."""
    jc, rows, lab, pos, vel, _ = _detect_inputs(3, packed)
    kw = dict(pericentric=mode == "pericentric", box_size=100.0,
              rhat_packed=packed)
    jin = [jnp.asarray(a) for a in (rows, lab, pos, vel)] + list(jc)
    tcarry = tls.label_carry_from_numpy(*jax.tree.map(np.asarray, jc),
                                        device="cpu")
    tin = [_t(a) for a in (rows, lab, pos, vel)] + list(tcarry)
    j9 = jax.tree.map(np.asarray, jpl.detect_label_pallas(
        *jin, jnp.float32(0.01), **kw))
    t9 = tl.detect_label(*tin, 0.01, **kw)
    j8 = jax.tree.map(np.asarray, jpl.detect_label_compact_pallas(
        *jin, jnp.float32(0.01), event_capacity=128, **kw))
    t8 = tl.detect_label_compact(*tin, 0.01, event_capacity=128, **kw)
    assert int(j9[4].sum()) > 0
    np.testing.assert_array_equal(t9[4].numpy(), j9[4])
    np.testing.assert_array_equal(t8[4].numpy(), j8[5])
    np.testing.assert_array_equal(t9[0].numpy(), j9[0])
    np.testing.assert_array_equal(t8[0].numpy(), j8[0])
    # payload plane: positions exact, angle bits within one f16 ulp
    got_pay, want_pay = t9[3].numpy().view(np.uint32), j9[3]
    np.testing.assert_array_equal(got_pay >> 15, want_pay >> 15)
    assert np.abs((got_pay & 0x7FFF).astype(np.int64)
                  - (want_pay & 0x7FFF)).max() <= 1
    ev = t8[3].numpy().view(np.uint32)
    # the JAX kernel's own events hold only where no block overflowed;
    # else its step reroutes through compact_payload (lax.cond)
    want_ev = (j8[4] if j8[6].max() <= jpc.BLOCK_CAP else
               np.asarray(jpc.compact_payload(jnp.asarray(j8[3]), 128)))
    for r, n in enumerate(np.minimum(j8[5], ev.shape[1])):
        np.testing.assert_array_equal(ev[r, :n] >> 15, want_ev[r, :n] >> 15)
        assert (ev[r, n:] == 0).all()
    for t, j in ((t9, j9), (t8, j8)):
        _check_carry(tls.LabelCarry(t[0], t[1], t[2]),
                     jls.LabelCarry(j[0], j[1], j[2]), packed)


@pytest.mark.parametrize("packed", [False, True])
def test_fused_detect_matches_jax(packed):
    """K10: the plain fused pass (frame rows gathered from the table, then
    the detect chain) against fused_label_detect, labels past H included:
    counts, lab_sv and matched bits exact, payload positions exact and
    angle bits within one f16 ulp; and the same bits as K6 then K9."""
    jc, rows, lab, pos, vel, table = _detect_inputs(5, packed)
    lab = np.where(np.arange(N).reshape(R, W) % 97 == 0, H + 1, lab)
    _check_fused_against_jax(jc, lab, pos, vel, table, packed)


def test_fused_detect_many_halos_matches_jax():
    """K10 with 4096 halos on [8, 128] rows, a table past the 48 KB a
    block's shared memory holds by default, which JAX accepts (its limit
    is a 32 MiB one-hot block): the port runs it and agrees."""
    h, r, w = 4096, 8, 128
    jc, _, lab, pos, vel, table = _detect_inputs(7, False, h=h, r=r, w=w)
    _check_fused_against_jax(jc, lab, pos, vel, table, False)


def _check_fused_against_jax(jc, lab, pos, vel, table, packed):
    """The port's fused pass against JAX's on the same planes: counts,
    lab_sv and matched bits exact, payload positions exact and angle
    bits within one f16 ulp, the carry as :func:`_check_carry`; and the
    same bits as the frame rows gathered from the table, then K9."""
    r, w = lab.shape
    kw = dict(pericentric=True, box_size=100.0, rhat_packed=packed)
    tcarry = tls.label_carry_from_numpy(*jax.tree.map(np.asarray, jc),
                                        device="cpu")
    want = jax.tree.map(np.asarray, jpl.fused_label_detect(
        jnp.asarray(table), jnp.asarray(lab), jnp.asarray(pos),
        jnp.asarray(vel), *jc, jnp.float32(0.01), **kw))
    got = tl.fused_label_detect(_t(table), _t(lab), _t(pos), _t(vel),
                                *tcarry, 0.01, **kw)
    assert int(want[4].sum()) > 0
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    got_pay, want_pay = got[3].numpy().view(np.uint32), want[3]
    np.testing.assert_array_equal(got_pay >> 15, want_pay >> 15)
    assert np.abs((got_pay & 0x7FFF).astype(np.int64)
                  - (want_pay & 0x7FFF)).max() <= 1
    _check_carry(tls.LabelCarry(*got[:3]), jls.LabelCarry(*want[:3]), packed)
    rows = tf.frame_rows_torch(_t(table), _t(lab)).reshape(6, r, w)
    split = tl.detect_label(rows, _t(lab), _t(pos), _t(vel), *tcarry, 0.01,
                            **kw)
    for a, b in zip(got, split):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1000, 4096 + 77])
def test_f32_frame_kernels_match_jax(n):
    """K11/K12 (frames='pallas'): the port's frame rows and moments on
    flat [N] labels of a length JAX pads to its block size, against
    pallas_frames.frame_rows (bit for bit) and segment_moments, with and
    without masses.  The port's moments are the float32 rounding of a
    float64 sum (rtol = atol = 2e-6 against NumPy's float64 sum); the
    JAX kernel sums in float32, so the two agree to float32 summation
    error: 4 eps32 of the halo's sum of |m v|."""
    rng = np.random.default_rng(n)
    table = (rng.normal(size=(H, 6))
             * np.exp2(rng.integers(-20, 20, size=(H, 6)))).astype(np.float32)
    idx = rng.integers(-1, H + 2, size=n).astype(np.int32)
    vel = rng.normal(size=(3, n)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    want = np.asarray(jpf.frame_rows(jnp.asarray(table), jnp.asarray(idx)))
    got = tf.frame_rows(_t(table), _t(idx)).numpy()
    assert got.shape == want.shape == (6, n)
    np.testing.assert_array_equal(got, want)
    ok = (idx >= 0) & (idx < H)
    for mass in (None, m):
        want = np.asarray(jpf.segment_moments(
            jnp.asarray(idx), jnp.asarray(vel), _j(mass), n_halos=H))
        got = tf.segment_moments(_t(idx), _t(vel), _t(mass),
                                 n_halos=H).numpy()
        w = np.ones(n) if mass is None else mass.astype(np.float64)
        terms = np.concatenate([vel * w, w[None]]).astype(np.float64)
        for h in range(H):
            sel = ok & (idx == h)
            exact = terms[:, sel].sum(axis=1)
            np.testing.assert_allclose(got[h], exact, rtol=2e-6, atol=2e-6)
            f32_err = 4 * np.finfo(np.float32).eps * np.abs(
                terms[:, sel]).sum(axis=1)
            assert np.all(np.abs(got[h] - want[h]) <= f32_err), h


# ----------------------------------------------------------------------
# the step, the scan and the carry against the JAX package
# ----------------------------------------------------------------------

#: (frames, row_width, event capacity): 'split' with W = 1024 and K = 128
#: takes the detect-and-compact pass (blocked_ok), with K = 512 the
#: detect pass and the payload compaction.
ROUTES = [("split", 128), ("split", 512), ("pallas2", 128),
          ("twolevel", 128), ("matmul", 128), ("fused", 128),
          ("pallas", 128)]
#: (mode, rhat_packed, box, hubble, bulk given): two settings per route
#: cover both values of every option.
SETTINGS = [("pericentric", False, 100.0, 0.01, False),
            ("apocentric", True, None, 0.0, True)]


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("frames,k", ROUTES)
def test_label_step_matches_jax(frames, k, setting):
    mode, packed, box, hub, given = setting
    pos, vel, lab, cen = _pool(11, burst=True)
    bulk = (np.random.default_rng(5).normal(size=(S, H, 3))
            .astype(np.float32) if given else None)
    kw = dict(mode=mode, box_size=box, row_width=W, frames=frames,
              rhat_packed=packed)
    jstep = jax.jit(jls.make_label_orbit_step(k, **kw))
    tstep = tls.make_label_orbit_step(k, **kw)
    jc = jls.init_label_carry(N, row_width=W, rhat_packed=packed)
    tcarry = tls.init_label_carry(N, row_width=W, rhat_packed=packed,
                                  device="cpu")
    total = 0
    for s in range(S):
        b = None if bulk is None else bulk[s]
        jc, je = jstep(jc, (jnp.asarray(pos[s].reshape(3, R, W)),
                            jnp.asarray(vel[s].reshape(3, R, W)),
                            jnp.asarray(lab[s].reshape(R, W)),
                            jnp.asarray(cen[s]), _j(b), None,
                            jnp.float32(hub)))
        tcarry, te = tstep(tcarry, (_t(pos[s].reshape(3, R, W)),
                                    _t(vel[s].reshape(3, R, W)),
                                    _t(lab[s].reshape(R, W)), _t(cen[s]),
                                    _t(b), None, hub))
        total += _check_events(te, jax.tree.map(np.asarray, je))
        _check_carry(tcarry, jc, packed)
    assert total > 0


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("mass", [False, True])
def test_scan_label_events_matches_jax(mass):
    """The scan over 1-D [S, N] sequences (bulk estimated in-step, K7's
    plain version), with per-particle masses or without."""
    pos, vel, lab, cen = _pool(13)
    m = (np.random.default_rng(4).uniform(0.5, 2.0, N).astype(np.float32)
         if mass else None)
    kw = dict(event_capacity=128, box_size=100.0, row_width=W,
              hubble_drag=0.02)
    jc, jev = jls.scan_label_events(
        jls.init_label_carry(N, row_width=W), jnp.asarray(pos),
        jnp.asarray(vel), jnp.asarray(lab), jnp.asarray(cen), mass=_j(m),
        **kw)
    tcarry, tev = tls.scan_label_events(
        tls.init_label_carry(N, row_width=W, device="cpu"), pos, vel, lab,
        cen, mass=m, **kw)
    jev = jax.tree.map(np.asarray, jev)
    assert tev.count.shape == jev.count.shape == (S, R)
    assert _check_events(tev, jev) > 0
    _check_carry(tcarry, jc, False)


@pytest.mark.parametrize("packed", [False, True])
def test_label_carry_crosses_from_jax(packed):
    """3 JAX steps, the carry handed to the port bit for bit, 3 more
    steps on both sides: the same events and carries."""
    pos, vel, lab, cen = _pool(17)
    kw = dict(box_size=100.0, row_width=W, rhat_packed=packed,
              frames="split")
    jstep = jax.jit(jls.make_label_orbit_step(128, **kw))
    tstep = tls.make_label_orbit_step(128, **kw)
    jc = jls.init_label_carry(N, row_width=W, rhat_packed=packed)
    tcarry = None
    total = 0
    for s in range(S):
        jin = (jnp.asarray(pos[s]), jnp.asarray(vel[s]),
               jnp.asarray(lab[s]), jnp.asarray(cen[s]), None, None,
               jnp.float32(0.0))
        if s == 3:
            host = jax.tree.map(np.asarray, jc)
            tcarry = tls.label_carry_from_numpy(*host, device="cpu")
            for a, b in zip(tls.label_carry_to_numpy(tcarry), host):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        jc, je = jstep(jc, jin)
        if tcarry is not None:
            tcarry, te = tstep(tcarry, (_t(pos[s]), _t(vel[s]), _t(lab[s]),
                                        _t(cen[s]), None, None, 0.0))
            total += _check_events(te, jax.tree.map(np.asarray, je))
            _check_carry(tcarry, jc, packed)
    assert total > 0


@pytest.mark.parametrize("box", [None, 50.0])
def test_assign_regions_matches_jax(box):
    rng = np.random.default_rng(8)
    centers = rng.uniform(0, 50, size=(5, 3)).astype(np.float32)
    radii = rng.uniform(3.0, 12.0, size=5).astype(np.float32)
    pos = rng.uniform(0, 50, size=(4096, 3)).astype(np.float32)
    want = np.asarray(jls.assign_regions(jnp.asarray(pos), centers, radii,
                                         box_size=box))
    got = tls.assign_regions(_t(pos), centers, radii, box_size=box)
    np.testing.assert_array_equal(got.numpy(), want)
    got_soa = tls.assign_regions(_t(pos.T), centers, radii, box_size=box,
                                 soa=True)
    np.testing.assert_array_equal(got_soa.numpy(), want)
    assert (want >= 0).any() and (want < 0).any()


def test_label_churn_workload_matches_bench():
    """models.synthetic.label_churn_workload draws what bench.py's
    generators draw, array for array."""
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    from orbitanalysis_tpu_torch.models.synthetic import label_churn_workload

    h, p, s = 4, 1024, 6
    orbits = bench.make_orbits(h, p, s, seed=0)
    *_, members = bench.make_churn_sequence(orbits, 0.07,
                                            return_members=True)
    want = bench.make_label_sequence(orbits, members)
    got = label_churn_workload(h, p, s, seed=0, churn=0.07)
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[4] == want[4] == int(p * 0.9) * h


def test_unported_frames_raise():
    """Every route of the JAX package builds (none is left unported); an
    unknown one raises ValueError, and so does a fused pass whose one-hot
    block the JAX package refuses (H * W * 2 past 32 MiB), where JAX
    does."""
    for frames in tls._FRAMES:
        assert callable(tls.make_label_orbit_step(128, frames=frames))
    with pytest.raises(ValueError, match="unknown frames"):
        tls.make_label_orbit_step(128, frames="nope")
    h = (1 << 17) + 1
    lab = np.zeros((1, 128), dtype=np.int32)
    with pytest.raises(ValueError, match="32 MiB"):
        tl.fused_label_detect(torch.zeros((h, 6)), _t(lab), *([None] * 6),
                              pericentric=True, box_size=None)
    with pytest.raises(ValueError, match="VMEM"):
        jpl.fused_label_detect(jnp.zeros((h, 6)), jnp.asarray(lab),
                               *([None] * 6), pericentric=True,
                               box_size=None)


def test_wrappers_serve_only_cpu_and_cuda():
    """A tensor on another device is refused, not computed."""
    lab = torch.zeros(256, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no frame kernel"):
        tf.frame_rows(torch.zeros((2, 6), device="meta"), lab)
    with pytest.raises(ValueError, match="no detect kernel"):
        tl.detect_label(torch.zeros((6, 1, 256), device="meta"),
                        lab.view(1, 256), *([None] * 6),
                        pericentric=True, box_size=None)


# ----------------------------------------------------------------------
# repairs: CUDA by default, and the port's own native source
# ----------------------------------------------------------------------

def test_constructors_default_to_cuda(monkeypatch):
    """Given no device, every carry constructor runs on CUDA and raises
    without it, naming device='cpu'; nothing falls back."""
    from orbitanalysis_tpu_torch.ops import apsis, sorted_step

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: apsis.init_carry(2, 128),
        lambda: apsis.carry_from_numpy(
            np.zeros((2, 4), np.int32), np.zeros((3, 2, 4), np.float32),
            np.zeros((2, 4), np.float32), np.zeros((2, 4), np.float32)),
        lambda: sorted_step.init_aligned_carry(2, 128),
        lambda: sorted_step.aligned_carry_from_numpy(
            np.zeros((2, 4), np.uint32), np.zeros((2, 4), np.int32),
            np.zeros((3, 2, 4), np.float32), np.zeros((2, 4), np.uint32)),
        lambda: tls.init_label_carry(256, row_width=128),
        lambda: tls.label_carry_from_numpy(
            np.zeros((2, 4), np.int32), np.zeros((2, 4), np.uint32),
            np.zeros((2, 4), np.uint32)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert tls.init_label_carry(256, row_width=128,
                                device="cpu").lab_sv.device.type == "cpu"


def test_native_source_is_the_ports_own():
    from orbitanalysis_tpu_torch import native
    from orbitanalysis_tpu_torch.ops import _cuda

    pkg = os.path.join(REPO, "orbitanalysis_tpu_torch") + os.sep
    assert os.path.abspath(native.SOURCE).startswith(pkg)
    assert os.path.exists(native.SOURCE)
    assert _cuda.sources() and all(
        os.path.abspath(s).startswith(pkg) for s in _cuda.sources())
    with open(native.SOURCE) as a, open(os.path.join(
            REPO, "orbitanalysis_tpu", "native", "packing.cpp")) as b:
        mine, theirs = a.read(), b.read()
    # the same code as the JAX package's; only the header comment differs
    body = mine[mine.index("#include"):]
    assert body == theirs[theirs.index("#include"):]
