"""The port's sequence drivers and aligned batch staging on the CPU
against the JAX package: ``engine/scan.py`` (``scan_events``,
``scan_events_compact``, ``scan_counts``, ``scan_events_aligned`` per
step and batched), the step outputs they need (``merge_join``'s
cur->prev slot map, ``gather_rows``, ``make_orbit_step(with_prev_slot=
True)``), and the staging (``pack_ragged_to``, the native
``stable_align_native(out=, soa=)`` and ``stable_align_seq_native``,
``align_packed(out=, soa=)``, ``stage_batch_aligned`` on the native tier
and on the NumPy loop).

Inputs come from seeded NumPy (the JAX benchmark's ID-form churn
generator at 3-4 halos of 256-512 slots and 5-6 snapshots) and reach
both packages as the same bits; JAX's Pallas compactions run in
interpret mode, as the JAX package's own CPU tests run them.  Event
sets, counts, staged arrays and slot maps are exact; angles agree to
1e-4 rad or one f16 ulp (``test_torch_step._assert_angles_close``: XLA
on the CPU contracts FMAs that eager torch does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbitanalysis_tpu import native as jnative
from orbitanalysis_tpu.engine import packing as jpk
from orbitanalysis_tpu.engine import scan as jscan
from orbitanalysis_tpu.ops import apsis as japsis
from orbitanalysis_tpu.ops import join as jjoin
from orbitanalysis_tpu.ops import sorted_step as jss
from orbitanalysis_tpu.utils import padding as jpad
from orbitanalysis_tpu_torch import engine as tengine
from orbitanalysis_tpu_torch import native as tnative
from orbitanalysis_tpu_torch import utils as tutils
from orbitanalysis_tpu_torch.engine import packing as tpk
from orbitanalysis_tpu_torch.engine import scan as tscan
from orbitanalysis_tpu_torch.models import synthetic as tsyn
from orbitanalysis_tpu_torch.ops import apsis as tapsis
from orbitanalysis_tpu_torch.ops import join as tjoin
from orbitanalysis_tpu_torch.ops import sorted_step as tss

from test_torch_step import _assert_angles_close

torch.set_num_threads(1)

INVALID = np.iinfo(np.int32).max
BOX = 100.0


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _rows(rng, n_rows, cap, fill_frac=0.7, id_dtype=np.int32):
    """Rows of unique IDs in front, the dtype max after (the cases of
    ``tests/test_merge_join.py``)."""
    invalid = np.iinfo(id_dtype).max
    ids = np.full((n_rows, cap), invalid, dtype=id_dtype)
    for h in range(n_rows):
        n = rng.integers(0, int(cap * fill_frac) + 1)
        ids[h, :n] = rng.choice(np.arange(10 * cap), size=n, replace=False)
    return ids


def _same(got, want):
    """Bit-equal arrays (or both None)."""
    if want is None:
        assert got is None
        return
    want = np.asarray(want)
    got = _np(got)
    assert got.shape == want.shape
    if want.dtype == np.bool_:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(
            got.view(f"u{got.dtype.itemsize}"),
            want.view(f"u{want.dtype.itemsize}"))


# ----------------------------------------------------------------------
# the step outputs the drivers need
# ----------------------------------------------------------------------

@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("with_prev_slot", [True, False])
def test_merge_join_prev_slot_matches_jax(id_dtype, with_prev_slot):
    """Random rows, permuted rows, an empty row set and disjoint rows:
    masks, the cur->prev slot map and the exchanged payloads bit-equal
    to JAX's."""
    rng = np.random.default_rng(11)
    invalid = np.iinfo(id_dtype).max
    a = _rows(rng, 6, 64, id_dtype=id_dtype)
    b = _rows(rng, 6, 64, id_dtype=id_dtype)
    full = _rows(rng, 3, 64, fill_frac=1.0, id_dtype=id_dtype)
    disjoint = a.copy()
    disjoint[disjoint != invalid] += 10 * 64 + 7
    cases = [(a, b), (full, np.roll(full, 5, axis=1)),
             (np.full((2, 64), invalid, id_dtype), a[:2]), (a, disjoint)]
    for prev, cur in cases:
        pv = rng.normal(size=prev.shape).astype(np.float32)
        cv = rng.normal(size=prev.shape).astype(np.float32)
        with jax.enable_x64(id_dtype == np.int64):
            want = jax.tree.map(np.asarray, jjoin.merge_join(
                prev, cur, invalid, values=((pv, cv),),
                with_prev_slot=with_prev_slot))
        got = tjoin.merge_join(_t(prev), _t(cur), invalid,
                               values=((_t(pv), _t(cv)),),
                               with_prev_slot=with_prev_slot)
        _same(got.matched_prev, want.matched_prev)
        _same(got.matched_cur, want.matched_cur)
        _same(got.prev_slot_of_cur, want.prev_slot_of_cur)
        for g, w in zip(got.to_prev + got.to_cur, want.to_prev + want.to_cur):
            _same(g, w)
    assert tjoin.merge_join(_t(a), _t(b), INVALID).prev_slot_of_cur is not None


def test_gather_rows_matches_jax():
    """``tests/test_join.py``'s case (scalar and vector values, -1 slots)
    and random slot maps with a fill, bit-equal to JAX's."""
    rng = np.random.default_rng(3)
    vals = rng.normal(size=(2, 8)).astype(np.float32)
    vecs = rng.normal(size=(2, 8, 3)).astype(np.float32)
    slots = np.array([[3, -1, 0, 7, 2, -1, 1, 4], [0, 1, 2, 3, 4, 5, 6, 7]],
                     dtype=np.int32)
    counts = rng.integers(0, 9, (4, 256)).astype(np.int32)
    rand_slots = np.where(rng.random((4, 256)) < 0.2, -1,
                          rng.integers(0, 256, (4, 256))).astype(np.int32)
    for v, s, fill in ((vals, slots, 0), (vecs, slots, 0),
                       (counts, rand_slots, 0), (counts, rand_slots, 7),
                       (vals, slots, -2.5)):
        want = jjoin.gather_rows(jnp.asarray(v), jnp.asarray(s), fill=fill)
        got = tjoin.gather_rows(_t(v), _t(s), fill=fill)
        assert got.dtype == _t(v).dtype
        _same(got, want)
    g = tjoin.gather_rows(_t(vecs), _t(slots))
    np.testing.assert_array_equal(g[0, 3].numpy(), vecs[0, 7])
    assert not g[0, 1].any()


def _churn(h=3, p=256, s=6, seed=1):
    return tsyn.churn_workload(h, p, s, seed=seed)


def _load_batches(ids, pos, vel, cen, hubble=0.0):
    """``(jax stacked batch, port stacked batch)`` of the load-order
    ID-form sequence (hubble_drag ``[S]``)."""
    drag = np.full(ids.shape[0], hubble, np.float32)
    jb = japsis.SnapshotBatch(ids=jnp.asarray(ids), pos=jnp.asarray(pos),
                              vel=jnp.asarray(vel), center=jnp.asarray(cen),
                              hubble_drag=jnp.asarray(drag))
    tb = tapsis.SnapshotBatch(ids=ids, pos=pos, vel=vel, center=cen,
                              hubble_drag=drag)
    return jb, tb


def test_orbit_step_prev_slot_matches_jax():
    """``make_orbit_step(with_prev_slot=True)``: the cur->prev slot map of
    every churn step equals JAX's (-1 for entrants and padding); without
    it the field is None; ``with_dtheta=True`` (the on-the-fly writer's
    channel) gives JAX's angle changes to 1e-4 rad."""
    ids, pos, vel, cen, _ = _churn(seed=4)
    jstep = jax.jit(japsis.make_orbit_step(box_size=BOX,
                                           with_prev_slot=True))
    tstep = tapsis.make_orbit_step(box_size=BOX, with_prev_slot=True)
    jc = japsis.init_carry(3, 256)
    tc = tapsis.init_carry(3, 256, device="cpu")
    for s in range(ids.shape[0]):
        jc, je = jstep(jc, japsis.SnapshotBatch(
            ids=ids[s], pos=pos[s], vel=vel[s], center=cen[s]))
        tc, te = tstep(tc, tapsis.SnapshotBatch(
            ids=_t(ids[s]), pos=_t(pos[s]), vel=_t(vel[s]),
            center=_t(cen[s])))
        _same(te.prev_slot, je.prev_slot)
        _same(te.apsis, je.apsis)
        if s:
            assert (te.prev_slot >= 0).any() and (te.prev_slot < 0).any()
    plain = tapsis.make_orbit_step(box_size=BOX)
    _, ev = plain(tapsis.init_carry(3, 256, device="cpu"),
                  tapsis.SnapshotBatch(ids=_t(ids[0]), pos=_t(pos[0]),
                                       vel=_t(vel[0]), center=_t(cen[0])))
    assert ev.prev_slot is None and ev.dtheta is None
    jstep = jax.jit(japsis.make_orbit_step(box_size=BOX, with_dtheta=True))
    tstep = tapsis.make_orbit_step(box_size=BOX, with_dtheta=True)
    jc = japsis.init_carry(3, 256)
    tc = tapsis.init_carry(3, 256, device="cpu")
    for s in range(ids.shape[0]):
        jc, je = jstep(jc, japsis.SnapshotBatch(
            ids=ids[s], pos=pos[s], vel=vel[s], center=cen[s]))
        tc, te = tstep(tc, tapsis.SnapshotBatch(
            ids=_t(ids[s]), pos=_t(pos[s]), vel=_t(vel[s]),
            center=_t(cen[s])))
        np.testing.assert_allclose(te.dtheta.numpy(), np.asarray(je.dtheta),
                                   rtol=0, atol=1e-4)
        assert not te.dtheta[~te.matched_prev].any()


# ----------------------------------------------------------------------
# the general-step drivers
# ----------------------------------------------------------------------

def test_scan_events_matches_jax():
    """``scan_events`` (full masks) and ``scan_events_compact`` (K = 128)
    over 6 churn snapshots: apsis masks, counts and event IDs exact,
    angles within tolerance, the final carries' IDs equal."""
    ids, pos, vel, cen, _ = _churn()
    jb, tb = _load_batches(ids, pos, vel, cen)
    jc, (japs, jang) = jscan.scan_events(japsis.init_carry(3, 256), jb,
                                         box_size=BOX)
    tc, (taps, tang) = tscan.scan_events(
        tapsis.init_carry(3, 256, device="cpu"), tb, box_size=BOX)
    _same(taps, japs)
    assert int(taps.sum()) > 0
    sel = np.asarray(japs)
    _assert_angles_close(tang.numpy()[sel], np.asarray(jang)[sel])
    assert not tang.numpy()[~sel].any()
    _same(tc.ids, jc.ids)

    jc, (jcnt, jids, jev) = jscan.scan_events_compact(
        japsis.init_carry(3, 256), jb, 128, box_size=BOX)
    tc, (tcnt, tids, tev) = tscan.scan_events_compact(
        tapsis.init_carry(3, 256, device="cpu"), tb, 128, box_size=BOX)
    _same(tcnt, jcnt)
    np.testing.assert_array_equal(tcnt.numpy(), sel.sum(axis=-1))
    for s in range(ids.shape[0]):
        for h in range(3):
            n = int(tcnt[s, h])
            _same(tids[s, h, :n], np.asarray(jids)[s, h, :n])
            _assert_angles_close(tev.numpy()[s, h, :n],
                                 np.asarray(jev)[s, h, :n])


@pytest.mark.parametrize("angle_cut", [0.0, 0.5])
def test_scan_counts_matches_jax(angle_cut):
    """``scan_counts`` from a zero counter: per-step totals and the final
    per-slot counts equal JAX's; at ``angle_cut=0`` the totals are the
    step's apsides (every accumulated angle is positive)."""
    ids, pos, vel, cen, _ = _churn(h=4, p=256, s=6, seed=2)
    jb, tb = _load_batches(ids, pos, vel, cen, hubble=0.02)
    jc, jtot = jscan.scan_counts(
        jscan.CountingCarry(track=japsis.init_carry(4, 256),
                            counts=jnp.zeros((4, 256), jnp.int32)),
        jb, box_size=BOX, angle_cut=angle_cut)
    tc, ttot = tscan.scan_counts(
        tengine.CountingCarry(
            track=tapsis.init_carry(4, 256, device="cpu"),
            counts=torch.zeros((4, 256), dtype=torch.int32)),
        tb, box_size=BOX, angle_cut=angle_cut)
    assert ttot.dtype == torch.int32 and ttot.shape == (6,)
    _same(ttot, jtot)
    _same(tc.counts, jc.counts)
    _same(tc.track.ids, jc.track.ids)
    assert int(ttot.sum()) > 0
    if angle_cut == 0.0:
        _, (aps, _) = tscan.scan_events(
            tapsis.init_carry(4, 256, device="cpu"), tb, box_size=BOX)
        np.testing.assert_array_equal(ttot.numpy(),
                                      aps.sum(dim=(1, 2)).numpy())
        # a particle's count follows it: it never exceeds its snapshots
        assert int(tc.counts.max()) <= 5


# ----------------------------------------------------------------------
# aligned staging
# ----------------------------------------------------------------------

def test_pack_ragged_to_matches_jax():
    rng = np.random.default_rng(5)
    lens = np.array([3, 0, 7, 5])
    offsets = np.concatenate(([0], np.cumsum(lens)[:-1]))
    for values, fill in ((rng.integers(0, 99, lens.sum()).astype(np.int32),
                          INVALID),
                         (rng.normal(size=(lens.sum(), 3)).astype(
                             np.float32), 0.0)):
        for rows in (None, np.array([5, 1, 0, 3])):
            shape = (6, 8) + values.shape[1:]
            want = jpad.pack_ragged_to(np.full(shape, 9, values.dtype),
                                       values, offsets, rows=rows, fill=fill)
            buf = np.full(shape, 9, values.dtype)
            got = tutils.pack_ragged_to(buf, values, offsets, rows=rows,
                                        fill=fill)
            assert got is buf
            _same(got, want)


def _load_rows(s=5, h=3, p=512, seed=3, mass=False):
    """The churn sequence as stacked front-packed load-order rows, with
    per-particle masses where asked."""
    ids, pos, vel, cen, _ = _churn(h=h, p=p, s=s, seed=seed)
    m = None
    if mass:
        m = np.where(ids != INVALID, np.random.default_rng(seed).uniform(
            0.5, 2.0, ids.shape), 0.0).astype(np.float32)
    return ids, pos, vel, cen, m


@pytest.mark.parametrize("soa", [False, True])
@pytest.mark.parametrize("mass", [False, True])
def test_native_alignment_matches_jax(soa, mass):
    """The port's native bindings against the JAX package's on the same
    library source: ``stable_align_native(out=, soa=)`` one snapshot at
    a time and ``stable_align_seq_native`` over the sequence give the
    same arrays and the same final layout; a buffer of the wrong shape
    is refused, the wrong dtypes return None."""
    if tnative.ensure() is None or jnative.ensure() is None:
        pytest.skip("the native packer did not build here")
    ids, pos, vel, _, m = _load_rows(mass=mass)
    S, H, P = ids.shape
    vshape = (3, H, P) if soa else (H, P, 3)

    def bufs(lead=()):
        return (np.zeros(lead + (H, P), np.int32),
                np.zeros(lead + vshape, np.float32),
                np.zeros(lead + vshape, np.float32),
                None if m is None else np.zeros(lead + (H, P), np.float32),
                np.zeros(lead + (H, P), np.int32))

    lay_t = np.full((H, P), INVALID, np.int32)
    lay_j = lay_t.copy()
    for s in range(S):
        ms = None if m is None else m[s]
        out_t = bufs()
        got = tnative.stable_align_native(lay_t, ids[s], pos[s], vel[s], ms,
                                          INVALID, out=out_t, soa=soa)
        want = jnative.stable_align_native(lay_j, ids[s], pos[s], vel[s],
                                           ms, INVALID, out=bufs(), soa=soa)
        assert all(g is o for g, o in zip(got, out_t))
        for g, w in zip(got, want):
            _same(g, w)
        _same(lay_t, lay_j)
        fresh = tnative.stable_align_native(
            np.full((H, P), INVALID, np.int32), ids[s], pos[s], vel[s], ms,
            INVALID, soa=soa)
        assert fresh[1].shape == vshape

    lay_t = np.full((H, P), INVALID, np.int32)
    lay_j = lay_t.copy()
    out_t, out_j = bufs((S,)), bufs((S,))
    assert tnative.stable_align_seq_native(
        lay_t, ids, pos, vel, m, INVALID, out=out_t, soa=soa) is out_t
    jnative.stable_align_seq_native(lay_j, ids, pos, vel, m, INVALID,
                                    out=out_j, soa=soa)
    for g, w in zip(out_t, out_j):
        _same(g, w)
    _same(lay_t, lay_j)

    bad = bufs()
    with pytest.raises(ValueError, match="out buffer"):
        tnative.stable_align_native(
            np.full((H, P), INVALID, np.int32), ids[0], pos[0], vel[0],
            None if m is None else m[0], INVALID,
            out=(bad[0][:, :-1],) + bad[1:], soa=soa)
    seq_bad = bufs((S,))
    with pytest.raises(ValueError, match="mass_o" if m is None else "out "):
        tnative.stable_align_seq_native(
            lay_t, ids, pos, vel, m, INVALID, soa=soa,
            out=seq_bad[:3] + (np.zeros((S, H, P - 1), np.float32),)
            + seq_bad[4:])
    assert tnative.stable_align_seq_native(
        lay_t, ids.astype(np.int64), pos, vel, m, INVALID, out=out_t) is None
    assert tnative.stable_align_native(
        lay_t, ids[0], pos[0].astype(np.float64), vel[0], None,
        INVALID) is None


def _numpy_tier(monkeypatch):
    """Route the port's alignment through its NumPy path."""
    monkeypatch.setattr(tnative, "stable_align_native",
                        lambda *a, **k: None)
    monkeypatch.setattr(tnative, "stable_align_seq_native",
                        lambda *a, **k: None)


@pytest.mark.parametrize("tier", ["native", "numpy"])
@pytest.mark.parametrize("soa", [False, True])
def test_align_packed_out_matches_jax(monkeypatch, tier, soa):
    """``align_packed(out=, soa=)`` snapshot by snapshot into slices of
    one stacked buffer, on the native tier and on the NumPy path: the
    same arrays as JAX's ``align_packed`` and the buffer's own slices
    returned."""
    if tier == "numpy":
        _numpy_tier(monkeypatch)
    ids, pos, vel, _, m = _load_rows(s=4, mass=True)
    S, H, P = ids.shape
    vshape = (S, 3, H, P) if soa else (S, H, P, 3)
    out = (np.zeros((S, H, P), np.int32), np.zeros(vshape, np.float32),
           np.zeros(vshape, np.float32), np.zeros((S, H, P), np.float32),
           np.zeros((S, H, P), np.int32))
    lay_t, lay_j = tpk.StableLayout(H, P), jpk.StableLayout(H, P)
    for s in range(S):
        got = tpk.align_packed(lay_t, ids[s], pos[s], vel[s], m[s],
                               out=tuple(o[s] for o in out), soa=soa)
        want = jpk.align_packed(lay_j, ids[s], pos[s], vel[s], m[s], soa=soa)
        assert all(np.shares_memory(g, o) for g, o in zip(got, out))
        for g, w in zip(got, want):
            _same(g, w)
        _same(lay_t.layout, lay_j.layout)
    plain = tpk.align_packed(tpk.StableLayout(H, P), ids[0], pos[0], vel[0])
    assert plain[3] is None and plain[1].shape == (H, P, 3)


@pytest.mark.parametrize("tier", ["native", "numpy"])
@pytest.mark.parametrize("soa", [False, True])
@pytest.mark.parametrize("stacked", [True, False])
def test_stage_batch_aligned_matches_jax(monkeypatch, tier, soa, stacked):
    """``stage_batch_aligned`` of the stacked churn sequence (and of one
    snapshot) on the native sequence pass and on the per-snapshot NumPy
    loop: every staged array bit-equal to JAX's, the other fields passed
    through, and the staged slots a permutation with FRESH flags on the
    entrants."""
    if tier == "numpy":
        _numpy_tier(monkeypatch)
    ids, pos, vel, cen, m = _load_rows(mass=True)
    if not stacked:
        ids, pos, vel, cen, m = ids[2], pos[2], vel[2], cen[2], m[2]
    jb = japsis.SnapshotBatch(ids=ids, pos=pos, vel=vel, center=cen, mass=m)
    tb = tapsis.SnapshotBatch(ids=ids, pos=pos, vel=vel, center=cen, mass=m)
    want = jpk.stage_batch_aligned(jb, soa=soa)
    lay = tpk.StableLayout(*ids.shape[-2:])
    got = tpk.stage_batch_aligned(tb, layout=lay, soa=soa)
    for f in ("ids", "pos", "vel", "mass", "slot"):
        _same(getattr(got, f), getattr(want, f))
    assert got.center is cen and got.bulk_vel is None
    slot = np.asarray(got.slot).reshape(-1, ids.shape[-1])
    np.testing.assert_array_equal(
        np.sort(slot & tpk.SLOT_MASK, axis=-1),
        np.broadcast_to(np.arange(ids.shape[-1]), slot.shape))
    if stacked:
        assert ((got.slot[1:] & tpk.FRESH_BIT) != 0).any()
        # the layout ends as after the last snapshot
        _same(lay.layout, got.ids[-1])


# ----------------------------------------------------------------------
# the aligned drivers
# ----------------------------------------------------------------------

def _aligned_stacks(h, p, s, seed, soa, hubble=0.0):
    ids, pos, vel, cen, _ = _churn(h=h, p=p, s=s, seed=seed)
    drag = np.full(s, hubble, np.float32)
    staged = tpk.stage_batch_aligned(tapsis.SnapshotBatch(
        ids=ids, pos=pos, vel=vel, center=cen, hubble_drag=drag), soa=soa)
    jstaged = jpk.stage_batch_aligned(japsis.SnapshotBatch(
        ids=ids, pos=pos, vel=vel, center=cen, mass=None, bulk_vel=None,
        hubble_drag=drag), soa=soa)
    return staged, jax.tree.map(jnp.asarray, jstaged)


def _check_aligned_scan(got, want, K):
    (tc, (tcnt, tids, tang)), (jc, (jcnt, jids, jang)) = got, want
    _same(tcnt, jcnt)
    assert int(tcnt.sum()) > 0
    S, H = tcnt.shape
    assert tids.shape == (S, H, min(K, tids.shape[2]))
    for s in range(S):
        for h in range(H):
            n = min(int(tcnt[s, h]), tids.shape[2])
            _same(tids[s, h, :n], np.asarray(jids)[s, h, :n])
            _assert_angles_close(tang.numpy()[s, h, :n],
                                 np.asarray(jang)[s, h, :n], f16=True)
            assert (tids.numpy()[s, h, n:] == INVALID).all()
    tcn = tss.aligned_carry_to_numpy(tc)
    jcn = jax.tree.map(np.asarray, jc)
    np.testing.assert_array_equal(tcn.key, jcn.key)
    np.testing.assert_array_equal(tcn.sv, jcn.sv)
    np.testing.assert_array_equal(tcn.packed >> 31, jcn.packed >> 31)
    _assert_angles_close(
        (tcn.packed & np.uint32(0x7FFFFFFF)).view(np.float32),
        (jcn.packed & np.uint32(0x7FFFFFFF)).view(np.float32))
    np.testing.assert_allclose(tcn.rhat, jcn.rhat, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("soa,mode,hubble", [
    (True, "pericentric", 0.0), (False, "apocentric", 0.05)])
def test_scan_events_aligned_matches_jax(batched, soa, mode, hubble):
    """``scan_events_aligned`` per step (the angle-word compaction) and
    batched (one payload compaction over all S*H rows) on 6 churn
    snapshots staged by each package's ``stage_batch_aligned``: counts
    and event positions exact, f16 angles within one ulp, the final
    carries' keys, slots and match bits equal."""
    staged, jstaged = _aligned_stacks(3, 256, 6, 1, soa, hubble)
    kw = dict(mode=mode, box_size=BOX, soa_batch=soa, batched=batched)
    want = jscan.scan_events_aligned(jss.init_aligned_carry(3, 256), jstaged,
                                     128, **kw)
    got = tscan.scan_events_aligned(
        tss.init_aligned_carry(3, 256, device="cpu"), staged, 128, **kw)
    _check_aligned_scan(got, want, 128)


def test_scan_events_aligned_batched_equals_per_step():
    """On the port, the batched driver gives the per-step driver's events
    bit for bit (both stage the same arrays, every plane is computed
    element by element), also with rows cut at K and a carry handed on
    from a first half of the sequence."""
    staged, _ = _aligned_stacks(4, 512, 6, 5, True)
    for K in (128, 2048):
        outs = [tscan.scan_events_aligned(
            tss.init_aligned_carry(4, 512, device="cpu"), staged, K,
            box_size=BOX, soa_batch=True, batched=b) for b in (False, True)]
        (c0, e0), (c1, e1) = outs
        for a, b in zip(e0, e1):
            _same(a, b)
        for a, b in zip(c0, c1):
            _same(a, b)
    assert int(e0[0].max()) > 0
    half = staged._replace(**{f: getattr(staged, f)[:3] for f in (
        "ids", "pos", "vel", "center", "slot", "hubble_drag")})
    rest = staged._replace(**{f: getattr(staged, f)[3:] for f in (
        "ids", "pos", "vel", "center", "slot", "hubble_drag")})
    c, _ = tscan.scan_events_aligned(
        tss.init_aligned_carry(4, 512, device="cpu"), half, 128,
        box_size=BOX, soa_batch=True)
    ends = [tscan.scan_events_aligned(c, rest, 128, box_size=BOX,
                                      soa_batch=True, batched=b)[1]
            for b in (False, True)]
    for a, b in zip(*ends):
        _same(a, b)


def test_scan_events_aligned_wide_rows_take_the_pair_compaction():
    """Rows past ``PAYLOAD_MAX_ROW`` take the position/angle pair
    compaction in the batched driver; its events equal the per-step
    driver's (which takes it too)."""
    from orbitanalysis_tpu_torch.ops.compact import PAYLOAD_MAX_ROW

    p = 1 << 17
    assert p > PAYLOAD_MAX_ROW
    staged, _ = _aligned_stacks(1, p, 3, 7, True)
    outs = [tscan.scan_events_aligned(
        tss.init_aligned_carry(1, p, device="cpu"), staged, 4096,
        box_size=BOX, soa_batch=True, batched=b)[1] for b in (False, True)]
    assert int(outs[0][0].sum()) > 0
    for a, b in zip(*outs):
        _same(a, b)


def test_scan_events_aligned_errors_match_jax():
    """The ValueErrors of JAX's batched driver: ``rhat_packed`` with
    ``batched``, a bad mode, a missing slot, non-32-bit IDs."""
    staged, jstaged = _aligned_stacks(2, 256, 2, 1, True)
    jc, tc = jss.init_aligned_carry(2, 256), tss.init_aligned_carry(
        2, 256, device="cpu")
    cases = [
        (dict(batched=True, rhat_packed=True), {}, "rhat_packed"),
        (dict(batched=True, mode="both"), {}, "mode not recognized"),
        (dict(batched=True), dict(slot=None), "slot"),
        (dict(batched=True, id_dtype=np.int64), {}, "32-bit signed"),
    ]
    for kw, repl, msg in cases:
        for fn, c, st in ((jscan.scan_events_aligned, jc, jstaged),
                          (tscan.scan_events_aligned, tc, staged)):
            with pytest.raises(ValueError, match=msg):
                fn(c, st._replace(**repl), 128, soa_batch=True, **kw)


def test_engine_exports_match_jax():
    """``engine`` exports what JAX's exports from ``scan``."""
    from orbitanalysis_tpu import engine as jengine

    for name in ("CountingCarry", "scan_counts", "scan_events",
                 "scan_events_compact", "stack_batches"):
        assert name in tengine.__all__ and name in jengine.__all__
        assert getattr(tengine, name) is getattr(tscan, name)
    assert "pack_ragged_to" in tutils.__all__
