"""The port's searchsorted join forms (``sort_rows``, ``match_ids``,
``two_way_match``, ``gather_rows``) and ``orbit_step`` /
``make_orbit_step(with_dtheta=True)`` on the CPU against the JAX package
and NumPy set logic (the cases of tests/test_join.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orbitanalysis_tpu.ops.apsis as japsis
import orbitanalysis_tpu.ops.join as jjoin
import orbitanalysis_tpu_torch.ops as tops
from orbitanalysis_tpu_torch.ops import apsis as tapsis
from orbitanalysis_tpu_torch.utils import INVALID_ID

torch.set_num_threads(1)


def _random_rows(rng, n_rows, cap, fill_frac=0.7, dtype=np.int32):
    ids = np.full((n_rows, cap), np.iinfo(dtype).max, dtype=dtype)
    for h in range(n_rows):
        n = rng.integers(0, int(cap * fill_frac) + 1)
        ids[h, :n] = rng.choice(np.arange(10 * cap), size=n, replace=False)
    return ids


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("cap,fill", [(64, 0.7), (128, 1.0), (32, 0.0)])
def test_match_ids_against_numpy_and_jax(rng, cap, fill):
    a = _random_rows(rng, 8, cap, fill)
    b = _random_rows(rng, 8, cap, fill)
    sb = tops.sort_rows(_t(b))
    jb = jjoin.sort_rows(jnp.asarray(b))
    assert np.array_equal(sb.ids.numpy(), np.asarray(jb.ids))
    assert np.array_equal(sb.order.numpy(), np.asarray(jb.order))
    assert sb.order.dtype == torch.int32
    j = tops.match_ids(_t(a), sb, INVALID_ID).numpy()
    assert np.array_equal(j, np.asarray(jjoin.match_ids(a, jb, INVALID_ID)))
    for h in range(8):
        for i in range(cap):
            where = np.where(b[h] == a[h, i])[0]
            want = where[0] if a[h, i] != INVALID_ID and len(where) else -1
            assert j[h, i] == want


def test_match_roundtrip_identity_and_empty_rows(rng):
    ids = _random_rows(rng, 4, 128, fill_frac=1.0)
    j = tops.match_ids(_t(ids), tops.sort_rows(_t(ids)), INVALID_ID).numpy()
    rows, cols = np.nonzero(ids != INVALID_ID)
    assert np.array_equal(j[rows, cols], cols)
    empty = np.full((3, 32), INVALID_ID, dtype=np.int32)
    assert np.all(tops.match_ids(_t(empty), tops.sort_rows(_t(empty)),
                                 INVALID_ID).numpy() == -1)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_two_way_match_matches_jax(rng, dtype):
    cur = _random_rows(rng, 6, 96, dtype=dtype)
    prev = cur.copy()
    # churn: replace a third of each row's entries
    for h in range(6):
        k = np.flatnonzero(prev[h] != np.iinfo(dtype).max)[::3]
        prev[h, k] = 5000 + rng.permutation(len(k)) + 100 * h
    inv = int(np.iinfo(dtype).max)
    got = tops.two_way_match(_t(cur), tops.sort_rows(_t(cur)), _t(prev),
                             tops.sort_rows(_t(prev)), inv)
    if dtype == np.int32:
        want = jjoin.two_way_match(cur, jjoin.sort_rows(jnp.asarray(cur)),
                                   prev, jjoin.sort_rows(jnp.asarray(prev)),
                                   inv)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    for h in range(6):
        for i, pid in enumerate(cur[h]):
            hit = np.flatnonzero((prev[h] == pid) & (pid != inv))
            assert got.prev_slot_of_cur[h, i] == (hit[0] if len(hit) else -1)


def test_gather_rows_scalar_and_vector(rng):
    vals = rng.normal(size=(2, 8)).astype(np.float32)
    vecs = rng.normal(size=(2, 8, 3)).astype(np.float32)
    slots = np.array([[3, -1, 0, 7, 2, -1, 1, 4], [0, 1, 2, 3, 4, 5, 6, 7]],
                     dtype=np.int32)
    for v in (vals, vecs):
        assert np.array_equal(tops.gather_rows(_t(v), _t(slots)).numpy(),
                              np.asarray(jjoin.gather_rows(v, slots)))


def _batch(rng, n_halos, cap, n, shift=0, drop=0):
    ids = np.full((n_halos, cap), INVALID_ID, np.int32)
    ids[:, :n] = np.arange(n_halos * n).reshape(n_halos, n) + shift
    ids[:, :drop] = INVALID_ID
    return japsis.SnapshotBatch(
        ids=ids,
        pos=rng.uniform(0, 100.0, size=(n_halos, cap, 3)).astype(np.float32),
        vel=rng.normal(size=(n_halos, cap, 3)).astype(np.float32),
        center=rng.uniform(0, 100.0, size=(n_halos, 3)).astype(np.float32),
        mass=None, bulk_vel=None, hubble_drag=0.0)


def _port_batch(b):
    return tapsis.SnapshotBatch(ids=_t(b.ids), pos=_t(b.pos), vel=_t(b.vel),
                                center=_t(b.center))


def test_orbit_step_vector_box_matches_jax(rng):
    """A (3,) box through ``orbit_step`` equals the scalar box and JAX."""
    b = _batch(rng, 2, 128, 100)
    c0 = tapsis.init_carry(2, 128, device="cpu")
    c_vec, _ = tops.orbit_step(c0, _port_batch(b),
                               box_size=np.array([100.0] * 3))
    c_scal, ev = tops.orbit_step(c0, _port_batch(b), box_size=100.0)
    assert torch.equal(c_vec.vrad, c_scal.vrad)
    j_carry, j_ev = japsis.orbit_step(japsis.init_carry(2, 128), b,
                                      box_size=100.0)
    np.testing.assert_allclose(c_scal.vrad.numpy(), np.asarray(j_carry.vrad),
                               rtol=0, atol=1e-5)
    assert ev.dtheta is None


@pytest.mark.parametrize("mode", ["pericentric", "apocentric"])
def test_with_dtheta_matches_jax(rng, mode):
    """``with_dtheta=True``: the per-pair angle change in prev layout,
    within 1e-4 rad of JAX's, zero off the matched pairs, and the other
    outputs as without it."""
    b0 = _batch(rng, 3, 256, 200)
    b1 = _batch(rng, 3, 256, 200, shift=40, drop=10)
    jstep = japsis.make_orbit_step(mode=mode, box_size=100.0,
                                   with_dtheta=True)
    jc, _ = jstep(japsis.init_carry(3, 256), b0)
    _, jev = jstep(jc, b1)
    for with_dtheta in (True, False):
        step = tapsis.make_orbit_step(mode=mode, box_size=100.0,
                                      with_dtheta=with_dtheta)
        c, _ = step(tapsis.init_carry(3, 256, device="cpu"), _port_batch(b0))
        _, ev = step(c, _port_batch(b1))
        assert np.array_equal(ev.apsis.numpy(), np.asarray(jev.apsis))
        assert np.array_equal(ev.matched_prev.numpy(),
                              np.asarray(jev.matched_prev))
        if not with_dtheta:
            assert ev.dtheta is None
            continue
        got, want = ev.dtheta.numpy(), np.asarray(jev.dtheta)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert np.all(got[~ev.matched_prev.numpy()] == 0)
        assert (got > 0).sum() > 100
