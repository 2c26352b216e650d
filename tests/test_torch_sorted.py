"""The port's sorted merge-join engine (``join_impl='sorted'``) on the CPU
against the JAX package: the four kernels' plain versions (K15 merge,
K16 join-and-detect, K18 event compaction, K19 two-group compaction)
against the JAX kernels in interpret mode, ``make_sorted_orbit_step``
with every option, ``scan_events_sorted``, the carry codecs, the
ID-sorted staging, and ``track_orbits(join_impl='sorted')`` savefiles
against the JAX general engine's.

Inputs come from seeded NumPy and reach both packages as the same bits.
Counts, IDs, slots and carry IDs are exact; angles agree to 1e-4 rad or
one f16 ulp (XLA on the CPU contracts FMAs that eager torch does not).
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbitanalysis_tpu import track_orbits as jax_track
from orbitanalysis_tpu.engine import packing as jpk
from orbitanalysis_tpu.engine import scan as jscan
from orbitanalysis_tpu.models.synthetic import churn_snapshots
from orbitanalysis_tpu.ops import apsis as japsis
from orbitanalysis_tpu.ops import pallas_compact as jcompact
from orbitanalysis_tpu.ops import pallas_merge as jmerge
from orbitanalysis_tpu.ops import pallas_step as jpstep
from orbitanalysis_tpu.ops import sorted_step as jss
from orbitanalysis_tpu_torch import track_orbits
from orbitanalysis_tpu_torch.engine import packing as tpk
from orbitanalysis_tpu_torch.engine import scan as tscan
from orbitanalysis_tpu_torch.models import synthetic as tsyn
from orbitanalysis_tpu_torch.ops import apsis as tapsis
from orbitanalysis_tpu_torch.ops import compact as tcompact
from orbitanalysis_tpu_torch.ops import merge as tmerge
from orbitanalysis_tpu_torch.ops import sorted_step as tss
from orbitanalysis_tpu_torch.ops import step as tstep_mod
from orbitanalysis_tpu_torch.utils.metrics import Metrics
from orbitanalysis_tpu_torch.utils.numerics import torch_dtype

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
from test_torch_step import _assert_angles_close

torch.set_num_threads(1)

INVALID = np.iinfo(np.int32).max


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _bits(a):
    """int32 tensor of a uint32 (or any 32-bit) array's bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


# ----------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels (interpret mode)
# ----------------------------------------------------------------------

def _rows(rng, h, p, n_valid, side):
    """``[h, p]`` uint32 keys ``(id << 1) | side`` of ``n_valid[r]``
    unique IDs from ``[0, 3p)`` a row, ascending, sentinel-padded
    (``0xFFFFFFFE | side``)."""
    keys = np.full((h, p), (np.uint32(INVALID) << np.uint32(1))
                   | np.uint32(side), np.uint32)
    for r in range(h):
        ids = np.sort(rng.choice(3 * p, n_valid[r], replace=False))
        keys[r, :n_valid[r]] = (ids.astype(np.uint32) << np.uint32(1)) \
            | np.uint32(side)
    return keys


def _join_inputs(seed, h=3, p=256, padded=True):
    """Prev (ascending) and cur (descending) operand planes of a join,
    with shared IDs, random v_r sign bits and unit vectors."""
    rng = np.random.default_rng(seed)
    n_prev = rng.integers(p // 2, p + 1, h) if padded else np.full(h, p)
    n_cur = rng.integers(p // 2, p + 1, h) if padded else np.full(h, p)
    pk = np.full((h, p), np.uint32(0xFFFFFFFE), np.uint32)
    ck = np.full((h, p), np.uint32(0xFFFFFFFF), np.uint32)
    for r in range(h):
        pool = rng.permutation(2 * p)
        a = np.sort(pool[:n_prev[r]])
        b = np.sort(np.concatenate([
            rng.choice(a, n_cur[r] // 2, replace=False),
            pool[p + 1:p + 1 + n_cur[r] - n_cur[r] // 2]]))
        pk[r, :len(a)] = a.astype(np.uint32) << np.uint32(1)
        ck[r, :len(b)] = (b.astype(np.uint32) << np.uint32(1)) | np.uint32(1)
    ck = ck[:, ::-1].copy()

    def unit(n):
        v = rng.normal(size=(3, h, n)).astype(np.float32)
        return (v / np.linalg.norm(v, axis=0)).astype(np.float32)

    def sv():
        return (rng.permutation(np.tile(np.arange(p, dtype=np.int32), (h, 1)),
                                axis=1)
                | (rng.integers(0, 8, (h, p)).astype(np.int32) << 24))

    prx, crx = unit(p), unit(p)
    prev = (pk, sv(), prx[0], prx[1], prx[2],
            rng.uniform(0, 5, (h, p)).astype(np.float32))
    cur = (ck, sv(), crx[0], crx[1], crx[2])
    return prev, cur


@pytest.mark.parametrize("p,padded,n_pay", [
    pytest.param(128, False, 2, id="128-False"),
    pytest.param(512, True, 2, id="512-True"),
    # every row half padding: sentinel runs of P / 2 = 2048 on each side,
    # two tiles of the CUDA kernel (1024 merged positions, csrc/merge.cu
    # kMergeTile); the key alone and six channels
    pytest.param(4096, "half", 0, id="4096-half-1chan"),
    pytest.param(4096, "half", 5, id="4096-half-6chan"),
])
def test_merge_rows_matches_jax(p, padded, n_pay):
    """K15: the merged keys equal the JAX bitonic merge's; payloads too,
    except among the sentinel ties, whose order the JAX network leaves
    open (the port's is a stable sort's: prev before cur, index order)."""
    rng = np.random.default_rng(p)
    h = 3
    if padded == "half":
        n_valid = np.full(h, p // 2)
    else:
        n_valid = rng.integers(p // 2, p + 1, h) if padded else np.full(h, p)
    pk = _rows(rng, h, p, n_valid, 0)
    ck = _rows(rng, h, p, n_valid[::-1], 1)[:, ::-1].copy()
    pay = [rng.integers(0, 2**31, (2, h, p)).astype(np.int32) if c % 2 == 0
           else rng.normal(size=(2, h, p)).astype(np.float32)
           for c in range(n_pay)]
    prev = (pk, *(x[0] for x in pay))
    cur = (ck, *(x[1] for x in pay))
    want = jmerge.merge_rows(tuple(map(jnp.asarray, prev)),
                             tuple(map(jnp.asarray, cur)))
    got = tmerge.merge_rows((_bits(pk), *(_t(x[0]) for x in pay)),
                            (_bits(ck), *(_t(x[1]) for x in pay)))
    keys = _u32(got[0])
    np.testing.assert_array_equal(keys, np.asarray(want[0]))
    assert np.all(np.diff(keys.astype(np.int64), axis=1) >= 0)
    real = (keys >> np.uint32(1)) != np.uint32(INVALID)
    if padded == "half":
        assert (~real).sum(axis=1).min() == p
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy()[real], np.asarray(w)[real])
    # the plain version is the stable sort of the concatenation
    cat = np.concatenate([pk, ck], axis=1)
    order = np.argsort(cat, axis=1, kind="stable")
    for g, x in zip(got[1:], pay):
        np.testing.assert_array_equal(
            g.numpy(), np.take_along_axis(np.concatenate(x, axis=1), order, 1))


def test_merge_rows_argument_checks_match_jax():
    k = torch.zeros((2, 128), dtype=torch.int32)
    f = torch.zeros((2, 128), dtype=torch.float32)
    with pytest.raises(NotImplementedError, match="single packed"):
        tmerge.merge_rows((k,), (k,), num_keys=2)
    with pytest.raises(ValueError, match="count mismatch"):
        tmerge.merge_rows((k, k), (k,))
    with pytest.raises(TypeError, match="uint32"):
        tmerge.merge_rows((f,), (f,))
    with pytest.raises(ValueError, match="power of two"):
        tmerge.merge_rows((k[:, :96],), (k[:, :96],))
    with pytest.raises(TypeError, match="32-bit"):
        tmerge.merge_rows((k, f), (k, k))


def test_sort_descending_matches_jax():
    rng = np.random.default_rng(5)
    key = np.stack([rng.permutation(2**32 - 1 - np.arange(256, dtype=np.int64))
                    for _ in range(3)]).astype(np.uint32)
    pay = rng.normal(size=(3, 256)).astype(np.float32)
    wk, wp = jmerge.sort_descending_u32(jnp.asarray(key), jnp.asarray(pay))
    gk, gp = tmerge.sort_descending_u32(_bits(key), _t(pay))
    np.testing.assert_array_equal(_u32(gk), np.asarray(wk))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))


@pytest.mark.parametrize("pericentric", [True, False])
@pytest.mark.parametrize("k", [128, 512])
def test_fused_join_detect_matches_jax(pericentric, k):
    """K16: counts, events (prev key, prev sv) and the packed match bits
    exact; angles to 1e-4 rad."""
    prev, cur = _join_inputs(7 + k + pericentric, p=512)
    want = jpstep.fused_join_detect(tuple(map(jnp.asarray, prev)),
                                    tuple(map(jnp.asarray, cur)),
                                    pericentric, INVALID, k)
    got = tstep_mod.fused_join_detect(
        tuple(_bits(x) if x.dtype != np.float32 else _t(x) for x in prev),
        tuple(_bits(x) if x.dtype != np.float32 else _t(x) for x in cur),
        pericentric, INVALID, k)
    packed, evk, evsv, evang, count = got
    w_packed, w_evk, w_evsv, w_evang, w_count = map(np.asarray, want)
    np.testing.assert_array_equal(count.numpy(), w_count)
    assert count.sum() > 0
    gp = _u32(packed)
    np.testing.assert_array_equal(gp >> np.uint32(31),
                                  w_packed >> np.uint32(31))
    _assert_angles_close((gp & np.uint32(0x7FFFFFFF)).view(np.float32),
                         (w_packed & np.uint32(0x7FFFFFFF)).view(np.float32))
    for r, n in enumerate(count.numpy()):
        n = min(n, evk.shape[1])
        np.testing.assert_array_equal(_u32(evk)[r, :n], w_evk[r, :n])
        np.testing.assert_array_equal(evsv.numpy()[r, :n], w_evsv[r, :n])
        _assert_angles_close(evang.numpy()[r, :n], w_evang[r, :n])
        assert not np.any(_u32(evk)[r, n:])  # the port zero-fills


@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
@pytest.mark.parametrize("h,p,k", [(3, 512, 200),
                                   # a row of six CUDA tiles and more
                                   (2, 3 * 4096 + 256, 1000)])
def test_compact_events_matches_jax(density, h, p, k):
    rng = np.random.default_rng(int(density * 100))
    sel = rng.random((h, p)) < density
    ang = rng.uniform(0, 7, (h, p)).astype(np.float32)
    packed = np.where(sel, ang.view(np.uint32) | np.uint32(1 << 31),
                      np.uint32(0))
    key = rng.integers(0, 2**32, (h, p), dtype=np.uint64).astype(np.uint32)
    sv = rng.integers(0, 2**31, (h, p)).astype(np.int32)
    want = jcompact.compact_events(jnp.asarray(packed), jnp.asarray(key),
                                   jnp.asarray(sv), k)
    got = tcompact.compact_events(_bits(packed), _bits(key), _t(sv), k)
    count = sel.sum(axis=1)
    k128 = tcompact._k128(k, p)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (h, k128)
        g = np.ascontiguousarray(g.numpy()).view(np.asarray(w).dtype)
        for r in range(h):
            n = min(count[r], k128)
            np.testing.assert_array_equal(g[r, :n], np.asarray(w)[r, :n])
            assert not np.any(g[r, n:])


@pytest.mark.parametrize("n_a", [1, 6])
def test_compact_rows_matches_jax(n_a):
    rng = np.random.default_rng(n_a)
    h, n = 3, 512
    sel_a = (rng.random((h, n)) < 0.5).astype(np.int32)
    sel_b = (rng.random((h, n)) < 0.03).astype(np.int32)
    sel_b[0, :200] = 1
    ops_a = tuple(rng.normal(size=(h, n)).astype(np.float32) if c % 2
                  else rng.integers(0, 2**31, (h, n)).astype(np.int32)
                  for c in range(n_a))
    ops_b = (rng.integers(0, 2**31, (h, n)).astype(np.int32),
             rng.integers(0, 2**24, (h, n)).astype(np.int32),
             rng.uniform(0, 7, (h, n)).astype(np.float32))
    want = jcompact.compact_rows(jnp.asarray(sel_a),
                                 tuple(map(jnp.asarray, ops_a)), 256,
                                 jnp.asarray(sel_b),
                                 tuple(map(jnp.asarray, ops_b)), 128)
    got = tcompact.compact_rows(_t(sel_a), tuple(map(_t, ops_a)), 256,
                                _t(sel_b), tuple(map(_t, ops_b)), 128)
    for sel, gs, ws, ln in ((sel_a, got[0], want[0], 256),
                            (sel_b, got[1], want[1], 128)):
        for g, w in zip(gs, ws):
            assert g.dtype == torch_dtype(np.asarray(w).dtype)
            assert tuple(g.shape) == (h, ln)
            for r in range(h):
                c = min(int(sel[r].sum()), ln)
                np.testing.assert_array_equal(g.numpy()[r, :c],
                                              np.asarray(w)[r, :c])
    with pytest.raises(ValueError, match="multiples"):
        tcompact.compact_rows(_t(sel_a), tuple(map(_t, ops_a)), 200,
                              _t(sel_b), tuple(map(_t, ops_b)), 128)
    with pytest.raises(TypeError, match="32-bit"):
        tcompact.compact_rows(_t(sel_a), (_t(ops_b[0]).long(),), 256,
                              _t(sel_b), tuple(map(_t, ops_b)), 128)


def _half_selected(rng, h, n, bursts):
    """``[h, n]`` int32 0/1 rows with exactly ``n // 2`` ones each (the
    unfused route's group a: the cur half of a merged row), runs of ones
    across each of ``bursts`` and the rest drawn at random."""
    sel = np.zeros((h, n), np.int32)
    for r in range(h):
        for edge in bursts:
            sel[r, edge - 60:edge + 70] = 1
        free = np.flatnonzero(sel[r] == 0)
        sel[r, rng.choice(free, n // 2 - int(sel[r].sum()),
                          replace=False)] = 1
    return sel


@pytest.mark.parametrize("n_a", [1, 6])
def test_compact_rows_route_structure_matches_jax(n_a):
    """K19's plain version against JAX with the unfused route's traffic:
    group a selects exactly half of each merged row of 2N (its output of
    N is full), group b about 1 %, with runs across the 1024- and
    2048-entry tile edges and, in one row, more than its output holds."""
    rng = np.random.default_rng(40 + n_a)
    h, n = 2, 2 * (4096 + 128)
    edges = (1024, 2048, 4096, 3 * 2048)
    sel_a = _half_selected(rng, h, n, edges)
    sel_b = (rng.random((h, n)) < 0.01).astype(np.int32)
    sel_b[:, 2048 - 20:2048 + 20] = 1
    sel_b[1, 3000:3400] = 1
    ops_a = tuple(rng.normal(size=(h, n)).astype(np.float32) if c % 2
                  else rng.integers(0, 2**31, (h, n)).astype(np.int32)
                  for c in range(n_a))
    ops_b = (rng.integers(0, 2**31, (h, n)).astype(np.int32),
             rng.integers(0, 2**24, (h, n)).astype(np.int32),
             rng.uniform(0, 7, (h, n)).astype(np.float32))
    len_a, len_b = n // 2, 256
    want = jcompact.compact_rows(jnp.asarray(sel_a),
                                 tuple(map(jnp.asarray, ops_a)), len_a,
                                 jnp.asarray(sel_b),
                                 tuple(map(jnp.asarray, ops_b)), len_b)
    got = tcompact.compact_rows(_t(sel_a), tuple(map(_t, ops_a)), len_a,
                                _t(sel_b), tuple(map(_t, ops_b)), len_b)
    assert (sel_a.sum(axis=1) == len_a).all()
    assert sel_b[1].sum() > len_b > sel_b[0].sum()
    for sel, gs, ws, ln in ((sel_a, got[0], want[0], len_a),
                            (sel_b, got[1], want[1], len_b)):
        for g, w in zip(gs, ws):
            assert g.dtype == torch_dtype(np.asarray(w).dtype)
            for r in range(h):
                c = min(int(sel[r].sum()), ln)
                np.testing.assert_array_equal(g.numpy()[r, :c],
                                              np.asarray(w)[r, :c])
                assert not g.view(torch.int32).numpy()[r, c:].any()


# ----------------------------------------------------------------------
# the aligned detect chain in the JAX signature
# ----------------------------------------------------------------------

def _detect_math_inputs(rhat_packed, seed=31):
    """A seeded aligned carry and frame at [3, 384], as the same bits for
    both packages: valid and padding lanes, FRESH lanes, stale FRESH bits
    in the carry's sv, every sign of the radial velocity (signed zeros
    too), and f32 or octahedral prev r-hat."""
    from orbitanalysis_tpu.utils.numerics import oct_encode as j_oct

    rng = np.random.default_rng(seed + rhat_packed)
    h, p = 3, 384

    def unit():
        v = rng.normal(size=(3, h, p))
        return (v / np.linalg.norm(v, axis=0)).astype(np.float32)

    valid = rng.random((h, p)) < 0.85
    fresh = np.where(rng.random((h, p)) < 0.1, 1 << 27, 0)
    slot = (rng.integers(0, 1 << 24, (h, p)) | fresh).astype(np.int32)
    vrad = rng.normal(size=(h, p)).astype(np.float32)
    vrad[0, :4] = [0.0, -0.0, 1e-30, -1e-30]
    key = np.broadcast_to((np.arange(p, dtype=np.uint32) << np.uint32(1))
                          | np.uint32(1), (h, p)).copy()
    sv = (rng.integers(0, 1 << 24, (h, p))
          | (rng.integers(0, 16, (h, p)) << 24)).astype(np.int32)
    ang = rng.uniform(0.0, 7.0, (h, p)).astype(np.float32)
    packed = ang.view(np.uint32) | (
        (rng.random((h, p)) < 0.7).astype(np.uint32) << np.uint32(31))
    prev = unit()
    rhat = np.array(j_oct(jnp.asarray(prev))) if rhat_packed else prev
    return valid, slot, vrad, unit(), (key, sv, rhat, packed)


def _detect_math_pair(rhat_packed):
    """The inputs of :func:`_detect_math_inputs` as ``(jax_args,
    torch_args)``: ``(carry, valid_cur, slot, frame)`` of each package."""
    from orbitanalysis_tpu.ops.geometry import RegionFrame as JFrame
    from orbitanalysis_tpu_torch.ops.geometry import RegionFrame as TFrame

    valid, slot, vrad, rhat, carry = _detect_math_inputs(rhat_packed)
    key, sv, prev_rhat, packed = carry
    radius = np.ones_like(vrad)
    bulk = np.zeros((valid.shape[0], 3), np.float32)
    jargs = (jss.AlignedCarry(key=_j(key), sv=_j(sv), rhat=_j(prev_rhat),
                              packed=_j(packed)),
             _j(valid), _j(slot),
             JFrame(radius=_j(radius), rhat=_j(rhat), vrad=_j(vrad),
                    bulk_vel=_j(bulk)))
    targs = (tss.AlignedCarry(key=_bits(key), sv=_t(sv),
                              rhat=_bits(prev_rhat) if rhat_packed
                              else _t(prev_rhat), packed=_bits(packed)),
             _t(valid), _t(slot),
             TFrame(radius=_t(radius), rhat=_t(rhat), vrad=_t(vrad),
                    bulk_vel=_t(bulk)))
    return jargs, targs


def _f16_as_f32(bits):
    return (np.asarray(bits).astype(np.uint16).view(np.float16)
            .astype(np.float32))


def _assert_detect_math_equal(got, want):
    """The eight outputs: keys, sv, apsis flags, counts, positions and
    the packed words' match bits exact; the accumulated angles (in
    ``angle_acc``, in the packed words and as f16 bits) to the
    tolerance of the aligned step's parity tests."""
    (cur_key, cur_sv, apsis, angle_acc, packed, ang16, count,
     pos_iota) = got
    want = [np.asarray(w) for w in want]
    np.testing.assert_array_equal(_u32(cur_key), want[0])
    np.testing.assert_array_equal(cur_sv.numpy(), want[1])
    np.testing.assert_array_equal(apsis.numpy(), want[2])
    _assert_angles_close(angle_acc.numpy(), want[3])
    np.testing.assert_array_equal(_u32(packed) >> 31, want[4] >> 31)
    _assert_angles_close(
        (_u32(packed) & np.uint32(0x7FFFFFFF)).view(np.float32),
        (want[4] & np.uint32(0x7FFFFFFF)).view(np.float32))
    _assert_angles_close(_f16_as_f32(ang16.numpy()), _f16_as_f32(want[5]),
                         f16=True)
    np.testing.assert_array_equal(count.numpy(), want[6])
    assert int(count.sum()) > 0
    np.testing.assert_array_equal(pos_iota.numpy(), want[7])


@pytest.mark.parametrize("rhat_packed", [False, True])
@pytest.mark.parametrize("form", ["positional", "keyword", "share_angles"])
def test_aligned_detect_math_matches_jax(form, rhat_packed):
    """The port's aligned detect chain takes JAX's arguments in JAX's
    places: ``invalid`` sixth (JAX's own call form,
    benchmarks/aligned_ablation.py, with the int32 sentinel), by keyword,
    and with ``share_angles`` (an XLA fusion barrier, accepted and
    ignored); every output equals JAX's."""
    jargs, targs = _detect_math_pair(rhat_packed)
    peri = form != "keyword"
    if form == "positional":
        got = tss.aligned_detect_math(*targs, peri, INVALID, rhat_packed)
        want = jss.aligned_detect_math(*jargs, peri, INVALID, rhat_packed)
    elif form == "keyword":
        got = tss.aligned_detect_math(*targs, pericentric=peri,
                                      invalid=INVALID,
                                      rhat_packed=rhat_packed)
        want = jss.aligned_detect_math(*jargs, pericentric=peri,
                                       invalid=INVALID,
                                       rhat_packed=rhat_packed)
    else:
        got = tss.aligned_detect_math(*targs, peri, INVALID,
                                      rhat_packed=rhat_packed,
                                      share_angles=True)
        want = jss.aligned_detect_math(*jargs, peri, INVALID,
                                       rhat_packed=rhat_packed,
                                       share_angles=True)
    _assert_detect_math_equal(got, want)


@pytest.mark.parametrize("invalid", [INVALID, 1000, (1 << 30) + 5])
def test_aligned_detect_math_invalid_key_matches_jax(invalid):
    """The padding key is JAX's ``(uint32(invalid) << 1) | 1`` modulo
    2**32 for any sentinel (-1 for the int32 one), and the two packages
    name the parameters alike, in the same order."""
    import inspect

    jargs, targs = _detect_math_pair(False)
    got = tss.aligned_detect_math(*targs, True, invalid)
    want = jss.aligned_detect_math(*jargs, True, invalid)
    _assert_detect_math_equal(got, want)
    valid = targs[1].numpy()
    key = np.uint32(((invalid << 1) | 1) & 0xFFFFFFFF)
    assert (_u32(got[0])[~valid] == key).all()
    assert list(inspect.signature(tss.aligned_detect_math).parameters) == \
        list(inspect.signature(jss.aligned_detect_math).parameters)


# ----------------------------------------------------------------------
# the step
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def churn():
    box = 60.0
    snaps, centers = churn_snapshots(3, 150, 8, box_size=box, seed=11)
    regions, loader = make_callbacks(snaps, centers, box_size=box)
    loaded = []
    for s in range(8):
        rp, rr = regions(s, np.arange(3))
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


def _reference_order(ev):
    """Events of an ``events_id_order`` step in reference (previous load
    slot) order, as the tracker restores them on the host."""
    count = ev.count.numpy()
    ids, ang = ev.ids.numpy(), ev.angles.numpy()
    if ev.slots is None:
        return count, ids, ang
    sel = np.arange(ids.shape[1])[None, :] < count[:, None]
    order = np.argsort(np.where(sel, ev.slots.numpy(), INVALID), axis=-1,
                       kind="stable")
    return (count, np.take_along_axis(ids, order, -1),
            np.take_along_axis(ang, order, -1))


def _check_step(tev, jev, tcarry, jcarry, invalid=INVALID):
    count, ids, ang = _reference_order(tev)
    np.testing.assert_array_equal(count, np.asarray(jev.count))
    j_ids, j_ang = np.asarray(jev.ids), np.asarray(jev.angles)
    for h, n in enumerate(count):
        np.testing.assert_array_equal(ids[h, :n], j_ids[h, :n])
        _assert_angles_close(ang[h, :n], j_ang[h, :n], f16=True)
    tc = tss.sorted_carry_to_numpy(tcarry)
    jc = jax.tree.map(np.asarray, jcarry)
    np.testing.assert_array_equal(tc.ids, jc.ids)
    valid = tc.ids != invalid
    np.testing.assert_array_equal(tc.slot[valid], jc.slot[valid])
    np.testing.assert_array_equal(tc.vrb[valid], jc.vrb[valid])
    _assert_angles_close(tc.angles[valid], jc.angles[valid])
    np.testing.assert_allclose(tc.rhat, jc.rhat, rtol=1e-6, atol=1e-6)
    return int(count.sum())


#: (merge_impl, compact_impl, cur_presorted, fused, events_id_order)
CONFIGS = [
    ("lax_sort", "lax_sort", False, False, False),
    ("pallas", "lax_sort", False, False, False),
    ("lax_sort", "pallas", False, False, False),
    ("pallas", "pallas", False, False, False),
    ("pallas", "pallas", True, False, False),
    ("pallas", "lax_sort", True, False, False),
    ("pallas", "pallas", False, True, False),
    ("pallas", "pallas", True, True, False),
    ("pallas", "pallas", True, True, True),
]


@pytest.mark.parametrize("mode,hubble", [("pericentric", 0.0),
                                         ("apocentric", 0.05)])
def test_sorted_step_configs_match_jax(churn, mode, hubble):
    """Every merge_impl x compact_impl, fused with and without
    cur_presorted, events_id_order: 8 churn snapshots against the JAX
    package's lax_sort step (which its own tests hold equal to its
    Pallas paths)."""
    box, loaded = churn
    rows, P, K = np.arange(3), 256, 128
    jstep = jax.jit(jss.make_sorted_orbit_step(K, mode=mode, box_size=box))
    for merge, compact, pre, fused, id_order in CONFIGS:
        tstep = tss.make_sorted_orbit_step(
            K, mode=mode, box_size=box, merge_impl=merge,
            compact_impl=compact, cur_presorted=pre, fused=fused,
            events_id_order=id_order)
        jc = jss.init_sorted_carry(3, P)
        tc = tss.init_sorted_carry(3, P, device="cpu")
        total = 0
        for rp, snap in loaded:
            pk = tpk.pack_snapshot(snap, rows, 3, P, rp, sort_ids=pre)
            jb, tb = _batches(pk, hubble)
            jc, je = jstep(jc, jb)
            tc, te = tstep(tc, tb)
            total += _check_step(te, je, tc, jc)
        assert total > 0


def test_fused_step_matches_jax_fused(churn):
    """The tracker's configuration (fused, presorted, ID-order events with
    slots) against the JAX fused step, Pallas kernels in interpret
    mode."""
    box, loaded = churn
    rows, P, K = np.arange(3), 256, 256
    kw = dict(box_size=box, fused=True, cur_presorted=True,
              events_id_order=True)
    jstep = jax.jit(jss.make_sorted_orbit_step(K, **kw))
    tstep = tss.make_sorted_orbit_step(K, **kw)
    jc, tc = jss.init_sorted_carry(3, P), tss.init_sorted_carry(
        3, P, device="cpu")
    total = 0
    for rp, snap in loaded[:5]:
        pk = tpk.pack_snapshot(snap, rows, 3, P, rp, sort_ids=True)
        jb, tb = _batches(pk)
        jc, je = jstep(jc, jb)
        tc, te = tstep(tc, tb)
        count = te.count.numpy()
        np.testing.assert_array_equal(count, np.asarray(je.count))
        for h, n in enumerate(count):
            np.testing.assert_array_equal(te.ids.numpy()[h, :n],
                                          np.asarray(je.ids)[h, :n])
            np.testing.assert_array_equal(te.slots.numpy()[h, :n],
                                          np.asarray(je.slots)[h, :n])
            _assert_angles_close(te.angles.numpy()[h, :n],
                                 np.asarray(je.angles)[h, :n])
        total += int(count.sum())
        tcn = tss.sorted_carry_to_numpy(tc)
        np.testing.assert_array_equal(tcn.ids, np.asarray(jc.ids))
        np.testing.assert_array_equal(tcn.slot, np.asarray(jc.slot))
        np.testing.assert_array_equal(tcn.vrb, np.asarray(jc.vrb))
    assert total > 0


def test_static_branch_matches_jax(monkeypatch):
    """Fixed membership: the fused presorted step takes the static branch
    (elementwise detect + K18) on every step after the first, as the JAX
    lax.cond does, and gives the JAX step's events."""
    ids, pos, vel, cen, _ = tsyn.static_workload(2, 256, 5, seed=4)
    calls = []
    real = tss._static_detect
    monkeypatch.setattr(tss, "_static_detect",
                        lambda *a: calls.append(1) or real(*a))
    kw = dict(box_size=100.0, fused=True, cur_presorted=True,
              events_id_order=True)
    jstep = jax.jit(jss.make_sorted_orbit_step(256, **kw))
    tstep = tss.make_sorted_orbit_step(256, **kw)
    jc, tc = jss.init_sorted_carry(2, 256), tss.init_sorted_carry(
        2, 256, device="cpu")
    total = 0
    for s in range(5):
        b = tss.presort_snapshot(tapsis.SnapshotBatch(
            ids=ids[s], pos=pos[s], vel=vel[s], center=cen[s]))
        jb = japsis.SnapshotBatch(
            ids=_j(b.ids), pos=_j(b.pos), vel=_j(b.vel), center=_j(b.center),
            hubble_drag=jnp.float32(0), slot=_j(b.slot))
        tb = b._replace(**{k: _t(getattr(b, k))
                           for k in ("ids", "pos", "vel", "center", "slot")})
        jc, je = jstep(jc, jb)
        tc, te = tstep(tc, tb)
        count = te.count.numpy()
        np.testing.assert_array_equal(count, np.asarray(je.count))
        for h, n in enumerate(count):
            np.testing.assert_array_equal(te.ids.numpy()[h, :n],
                                          np.asarray(je.ids)[h, :n])
            np.testing.assert_array_equal(te.slots.numpy()[h, :n],
                                          np.asarray(je.slots)[h, :n])
        total += int(count.sum())
    assert len(calls) == 4  # the first step joins against an empty carry
    assert total > 0


def test_wide_ids_on_lax_sort_match_jax(churn):
    """64-bit IDs shifted past 2**33 through the lax_sort paths (two sort
    keys), against the JAX step under x64."""
    box, loaded = churn
    rows, P, K = np.arange(3), 256, 128
    shift = np.int64(2) ** 33
    with jax.enable_x64(True):
        for pre in (False, True):
            kw = dict(box_size=box, id_dtype=np.int64, cur_presorted=pre)
            jstep = jax.jit(jss.make_sorted_orbit_step(K, **kw))
            tstep = tss.make_sorted_orbit_step(K, **kw)
            jc = jss.init_sorted_carry(3, P, id_dtype=jnp.int64)
            tc = tss.init_sorted_carry(3, P, id_dtype=np.int64, device="cpu")
            total = 0
            for rp, snap in loaded:
                snap = dict(snap, ids=snap["ids"].astype(np.int64) + shift)
                pk = tpk.pack_snapshot(snap, rows, 3, P, rp,
                                       id_dtype=np.int64, sort_ids=pre)
                jb, tb = _batches(pk)
                jc, je = jstep(jc, jb)
                tc, te = tstep(tc, tb)
                total += _check_step(te, je, tc, jc,
                                     invalid=np.iinfo(np.int64).max)
            assert total > 0
            assert int(tc.ids[tc.ids != np.iinfo(np.int64).max].min()) >= shift


def test_sorted_step_rejects_what_jax_rejects():
    make = tss.make_sorted_orbit_step
    with pytest.raises(ValueError, match="mode"):
        make(128, mode="bogus")
    with pytest.raises(ValueError, match="merge_impl"):
        make(128, merge_impl="bogus")
    with pytest.raises(ValueError, match="compact_impl"):
        make(128, compact_impl="bogus")
    with pytest.raises(ValueError, match="events_id_order"):
        make(128, events_id_order=True)
    with pytest.raises(ValueError, match="float32"):
        make(128, compact_impl="pallas", angle_dtype=np.float16)
    with pytest.raises(ValueError, match="32-bit"):
        make(128, compact_impl="pallas", id_dtype=np.int64)
    with pytest.raises(ValueError, match="signed"):
        make(128, merge_impl="pallas", id_dtype=np.int64)
    with pytest.raises(ValueError, match="32-bit"):
        make(128, fused=True, id_dtype=np.int64)


def test_carry_crosses_from_jax(churn):
    """JAX runs 4 fused steps; the port continues from its carry (through
    sorted_carry_from_numpy) and stays equal; the codecs round-trip bit
    for bit."""
    box, loaded = churn
    rows, P, K = np.arange(3), 256, 128
    jstep = jax.jit(jss.make_sorted_orbit_step(K, box_size=box))
    tstep = tss.make_sorted_orbit_step(K, box_size=box, fused=True,
                                       cur_presorted=True)
    jc = jss.init_sorted_carry(3, P)
    tc = None
    total = 0
    for s, (rp, snap) in enumerate(loaded):
        pk = tpk.pack_snapshot(snap, rows, 3, P, rp, sort_ids=True)
        jb, tb = _batches(pk)
        if s == 4:
            host = jax.tree.map(np.asarray, jc)
            tc = tss.sorted_carry_from_numpy(*host, device="cpu")
            for a, b in zip(tss.sorted_carry_to_numpy(tc), host):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        jc, je = jstep(jc, jb)
        if tc is not None:
            tc, te = tstep(tc, tb)
            total += _check_step(te, je, tc, jc)
    assert total > 0


def test_scan_events_sorted_matches_jax():
    """The bench's ID-form churn sequence, presorted and SoA-staged on the
    host: the port's fused scan against the JAX scan (lax_sort)."""
    ids, pos, vel, cen, _ = tsyn.churn_workload(3, 256, 6, seed=1)
    jb = japsis.SnapshotBatch(ids=ids, pos=pos, vel=vel, center=cen,
                              hubble_drag=np.zeros(6, np.float32))
    staged_j = jss.presort_snapshot(jb, soa=True)
    staged_t = tss.presort_snapshot(
        tapsis.SnapshotBatch(ids=ids, pos=pos, vel=vel, center=cen), soa=True)
    for f in ("ids", "pos", "vel", "slot"):
        np.testing.assert_array_equal(getattr(staged_t, f),
                                      np.asarray(getattr(staged_j, f)))
    kw = dict(box_size=100.0, cur_presorted=True, soa_batch=True)
    jc, (jcnt, jids, jang) = jscan.scan_events_sorted(
        jss.init_sorted_carry(3, 256), jax.tree.map(jnp.asarray, staged_j),
        128, **kw)
    tc, (cnt, tids, tang) = tscan.scan_events_sorted(
        tss.init_sorted_carry(3, 256, device="cpu"), staged_t, 128,
        fused=True, **kw)
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert int(cnt.sum()) > 0
    for s in range(6):
        for h in range(3):
            n = int(cnt[s, h])
            np.testing.assert_array_equal(tids.numpy()[s, h, :n],
                                          np.asarray(jids)[s, h, :n])
            _assert_angles_close(tang.numpy()[s, h, :n],
                                 np.asarray(jang)[s, h, :n], f16=True)
    np.testing.assert_array_equal(tc.ids.numpy(), np.asarray(jc.ids))
    # stack_batches + per-snapshot presort give the same staged stack
    stacked = tscan.stack_batches([
        tss.presort_snapshot(tapsis.SnapshotBatch(
            ids=ids[s], pos=pos[s], vel=vel[s], center=cen[s]), soa=True)
        for s in range(6)])
    for f in ("ids", "pos", "vel", "slot", "center"):
        np.testing.assert_array_equal(getattr(stacked, f),
                                      getattr(staged_t, f))


def test_pack_snapshot_sort_ids_matches_jax(churn):
    box, loaded = churn
    rows = np.array([0, 2])
    for rp, snap in loaded[:3]:
        offs = snap["region_offsets"]
        sub = dict(snap, region_offsets=offs[:2])
        n = offs[2]
        for k in ("ids", "coordinates", "velocities", "masses"):
            sub[k] = snap[k][:n]
        got = tpk.pack_snapshot(sub, rows, 3, 256, rp[:2], sort_ids=True)
        want = jpk.pack_snapshot(sub, rows, 3, 256, rp[:2], sort_ids=True)
        for f in got._fields:
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), f
            if g is not None:
                np.testing.assert_array_equal(g, w, err_msg=f)
        assert np.all(np.diff(got.ids.astype(np.int64), axis=1) >= 0)


# ----------------------------------------------------------------------
# track_orbits(join_impl='sorted')
# ----------------------------------------------------------------------

def _run(setup, path, **kw):
    box, snaps, regions, loader, snap_nums, branches = setup
    kw.setdefault("verbose", False)
    kw.setdefault("device", "cpu")
    kw.setdefault("join_impl", "sorted")
    track_orbits(snap_nums, kw.pop("branches", branches), regions,
                 kw.pop("loader", loader), path, **kw)
    return path


def test_tracker_matches_jax_general_and_oracle(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    ref = str(tmp_path / "jax.h5")
    jax_track(snap_nums, branches, regions, loader, ref, join_impl="general",
              checkpoint=True, verbose=False)
    m = Metrics()
    got = _run(churn_setup, str(tmp_path / "sorted.h5"), checkpoint=True,
               metrics=m)
    assert {r["join"] for r in m.records} == {"sorted"}
    _assert_files_equal(ref, got)
    _check_file_vs_oracle(got, snaps, _oracle_sets(snaps, box), 3)
    with h5py.File(ref + ".checkpoint") as a, \
            h5py.File(got + ".checkpoint") as b:
        np.testing.assert_allclose(a["angles"][:], b["angles"][:],
                                   atol=1e-4)


@pytest.mark.parametrize("grow_impl,joins", [("keep", {"sorted"}),
                                             ("general",
                                              {"sorted", "general"})])
def test_tracker_growth(tmp_path, growing_setup, grow_impl, joins):
    """Membership doubles at snapshot 4: the sorted run grows in place or
    by converting its carry to the general engine (the metrics prove it)
    and still equals the JAX general engine's savefile."""
    box, snaps, regions, loader, snap_nums, branches = growing_setup
    ref = str(tmp_path / "jax.h5")
    jax_track(snap_nums, branches, regions, loader, ref, join_impl="general",
              verbose=False)
    m = Metrics()
    got = _run(growing_setup, str(tmp_path / "grown.h5"), grow_impl=grow_impl,
               capacity=128, headroom=1.05, metrics=m)
    caps = _capacities(m)
    assert caps[0] == 128 and caps[-1] > 128, caps
    assert {r["join"] for r in m.records} == joins
    _assert_files_equal(ref, got)


def test_tracker_crash_resume_bit_identical(tmp_path, churn_setup):
    loader = churn_setup[3]
    straight = _run(churn_setup, str(tmp_path / "straight.h5"),
                    checkpoint=True)
    resumed = str(tmp_path / "resumed.h5")
    state = {"crashed": False}

    def crash(s, rp, rr):
        if s == 5 and not state["crashed"]:
            state["crashed"] = True
            raise RuntimeError("simulated crash")
        return loader(s, rp, rr)

    with pytest.raises(RuntimeError, match="simulated"):
        _run(churn_setup, resumed, checkpoint=True, loader=crash)
    with h5py.File(resumed) as hf:
        assert "snapshot_005" not in hf
    _run(churn_setup, resumed, checkpoint=True, resume=True, loader=crash)
    _assert_h5_identical(straight, resumed)


def test_tracker_halo_birth_apocentric(tmp_path, churn_setup):
    box, snaps, regions, loader, snap_nums, branches = churn_setup
    born = branches.copy()
    born[:4, 1] = -1  # halo 1 is not born until snapshot 4
    ref = str(tmp_path / "jax.h5")
    jax_track(snap_nums, born, regions, loader, ref, mode="apocentric",
              join_impl="general", verbose=False)
    got = _run(churn_setup, str(tmp_path / "port.h5"), branches=born,
               mode="apocentric")
    _assert_files_equal(ref, got)


def test_tracker_both_mode_matches_single_runs(tmp_path, churn_setup):
    peri1 = _run(churn_setup, str(tmp_path / "peri1.h5"))
    apo1 = _run(churn_setup, str(tmp_path / "apo1.h5"), mode="apocentric")
    peri2, apo2 = str(tmp_path / "peri2.h5"), str(tmp_path / "apo2.h5")
    _run(churn_setup, (peri2, apo2), mode="both", checkpoint=True)
    _assert_h5_identical(peri1, peri2)
    _assert_h5_identical(apo1, apo2)


def test_tracker_sorted_rejects_what_jax_rejects(tmp_path, churn_setup):
    with pytest.raises(ValueError, match="capacities up to"):
        _run(churn_setup, str(tmp_path / "a.h5"), capacity=1 << 18)
    with pytest.raises(ValueError, match="float32"):
        _run(churn_setup, str(tmp_path / "b.h5"), angle_dtype=np.float16)
