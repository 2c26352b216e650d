"""The port's hash-sharded engine (``orbitanalysis_tpu_torch/parallel/
hash_sharded.py``) against the JAX package's.

The host parts (``WideIdMap``, ``route_flat``, ``flat_to_position_shards``,
``events_to_reference_order``) run here in the test process and must be
bit-equal to JAX's.  The sharded step, the scan with its all-to-all
router, the router against the host router and router overflow run on a
world of 2 gloo ranks (``tests/torch_ranks.py``), against JAX on 2 of the
conftest's virtual CPU devices, from the same carry
(``hash_carry_from_numpy``): integer planes and event sets exact, bulk
velocities to about one f32 ulp, angles within the cross-package angle
tolerance of ``tests/test_torch_step.py`` (JAX's CPU ``rsqrt`` is not
the IEEE one, so one r-hat in seven differs by an ulp and arccos near 0
amplifies it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbitanalysis_tpu.models.synthetic import churn_snapshots
from orbitanalysis_tpu.parallel import make_mesh as jax_mesh
from orbitanalysis_tpu.parallel import hash_sharded as jhs
from orbitanalysis_tpu_torch.parallel import hash_sharded as ths
from orbitanalysis_tpu_torch.parallel import make_mesh

from oracle import OracleTracker
from test_hash_sharded import _flatten
from test_torch_step import _assert_angles_close
from torch_ranks import run_world

torch.set_num_threads(1)

D = 2
BOX = 60.0


def test_wide_id_map_matches_jax():
    rng = np.random.default_rng(7)
    a = rng.choice(2**40, size=500, replace=False).astype(np.int64)
    b = np.concatenate([a[100:200], a[300:] + 1])
    jm, tm = jhs.WideIdMap(), ths.WideIdMap()
    for ids in (a, b, a[::3]):
        h = tm.map(ids)
        np.testing.assert_array_equal(h, jm.map(ids))
        np.testing.assert_array_equal(tm.unmap(h), ids)
    np.testing.assert_array_equal(tm.inverse, jm.inverse)
    with pytest.raises(ValueError, match="negative"):
        tm.map(np.array([-1], np.int64))


def _random_flat(rng, n, with_mass=True):
    flat = dict(
        halo=rng.integers(0, 3, n).astype(np.int32),
        ids=rng.permutation(5000)[:n].astype(np.int64),
        pos=rng.normal(size=(n, 3)).astype(np.float32),
        vel=rng.normal(size=(n, 3)).astype(np.float32),
    )
    if with_mass:
        flat["mass"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return flat


@pytest.mark.parametrize("n_shards,with_mass", [(2, True), (8, False)])
def test_host_routing_matches_jax(n_shards, with_mass):
    """route_flat (with and without a WideIdMap) and
    flat_to_position_shards bit-equal to JAX's."""
    rng = np.random.default_rng(5)
    flat = _random_flat(rng, 1000, with_mass)
    cap = 1000 // n_shards + 64
    for id_map in (None, "wide"):
        jm = jhs.WideIdMap() if id_map else None
        tm = ths.WideIdMap() if id_map else None
        f = dict(flat, ids=flat["ids"] + (2**35 if id_map else 0))
        want = jhs.route_flat(f, n_shards, cap, id_map=jm)
        got = ths.route_flat(f, n_shards, cap, id_map=tm)
        for name in ths.HashBatch._fields:
            a, b = getattr(want, name), getattr(got, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
    for pad_to in (None, 700):
        want = jhs.flat_to_position_shards(flat, n_shards, pad_to=pad_to)
        got = ths.flat_to_position_shards(flat, n_shards, pad_to=pad_to)
        for name in ths.FlatRecords._fields:
            a, b = getattr(want, name), getattr(got, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)


def test_route_flat_capacity_guard():
    flat = dict(
        halo=np.zeros(16, np.int32),
        ids=np.arange(16) * 8,  # all land on shard 0
        pos=np.zeros((16, 3), np.float32),
        vel=np.zeros((16, 3), np.float32),
    )
    with pytest.raises(ValueError, match="shard capacity"):
        ths.route_flat(flat, 8, 8)
    with pytest.raises(ValueError, match="int32"):
        ths.route_flat(dict(flat, ids=flat["ids"] + 2**33), 8, 64)
    with pytest.raises(ValueError, match="too small"):
        ths.flat_to_position_shards(flat, 2, pad_to=4)


def test_events_to_reference_order_matches_jax():
    rng = np.random.default_rng(11)
    H, K = 5, 64
    count = rng.integers(0, K, D * 2)
    halo = rng.integers(0, H, (D * 2, K)).astype(np.int32)
    ids = rng.integers(0, 10**6, (D * 2, K)).astype(np.int32)
    slot = rng.permutation(D * 2 * K).reshape(D * 2, K).astype(np.int32)
    ang = rng.uniform(0, 7, (D * 2, K)).astype(np.float32)
    want = jhs.events_to_reference_order(count, halo, ids, slot, ang, H)
    got = ths.events_to_reference_order(count, halo, ids, slot, ang, H)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_carry_round_trip_and_world_of_one():
    """hash_carry_from_numpy / to_numpy carry a JAX carry across exactly;
    a world of one takes the whole [1, C] row; the 'shards' axis is
    required."""
    jc = jhs.init_hash_carry(D, 64, 3)
    tc = ths.hash_carry_from_numpy(jax.tree.map(np.asarray, jc),
                                   device="cpu")
    back = ths.hash_carry_to_numpy(tc)
    for name, a, b in zip(ths.HashCarry._fields, jc, back):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
        assert np.asarray(a).dtype == b.dtype, name
    for a, b in zip(back, ths.hash_carry_to_numpy(
            ths.init_hash_carry(D, 64, 3, device="cpu"))):
        np.testing.assert_array_equal(a, b)
    mesh = make_mesh({"shards": 1}, device="cpu")
    assert mesh.index("shards") == 0 and mesh.group("shards") is None
    with pytest.raises(ValueError, match="'shards'"):
        ths.make_hash_sharded_step(make_mesh({"halos": 1}, device="cpu"),
                                   3, 64)


def _jax_run(snaps, H, K, cap, carry, masses=False, bulk=None):
    """JAX's 2-shard step over ``snaps`` from ``carry`` ([D, C] host
    arrays): events per snapshot and the final carry, as NumPy."""
    mesh = jax_mesh({"shards": D}, jax.devices()[:D])
    step = jax.jit(jhs.make_hash_sharded_step(mesh, H, K, box_size=BOX))
    c = jhs.HashCarry(*(jnp.asarray(x) for x in carry))
    evs = []
    for s, snap in enumerate(snaps):
        flat = _flatten(snap, H)
        b = None if bulk is None else jnp.asarray(bulk[s])
        c, ev = step(c, jhs.route_flat(flat, D, cap), flat["centers"], b)
        evs.append(jax.tree.map(np.asarray, ev))
    return evs, jax.tree.map(np.asarray, c)


def _add_masses(snaps, seed):
    rng = np.random.default_rng(seed)
    for snap in snaps:
        for h in snap:
            snap[h]["mass"] = rng.uniform(
                0.5, 4.0, len(snap[h]["ids"])).astype(np.float32)
    return snaps


@pytest.fixture(scope="module")
def hash_world(tmp_path_factory):
    """One world of 2 ranks for every multi-process check of this file:
    the inputs, JAX's results on the same inputs, and each rank's
    outputs."""
    work = tmp_path_factory.mktemp("hash_world")
    H, K, cap = 3, 256, 256
    snaps, _ = churn_snapshots(H, 150, 6, box_size=BOX, seed=13)
    msnaps, _ = churn_snapshots(2, 120, 4, box_size=BOX, seed=29)
    msnaps = _add_masses(msnaps, 3)
    # the same carry for both packages: JAX's after the first snapshots
    lead = 2
    _, carry0 = _jax_run(snaps[:lead], H, K, cap,
                         jhs.init_hash_carry(D, cap, H))
    inp = dict(K=K, cap=cap, box=BOX, plain_S=len(snaps) - lead,
               mass_S=len(msnaps), plain_H=H, mass_H=2)
    for f, v in zip(ths.HashCarry._fields, carry0):
        inp[f"plain_carry_{f}"] = v
    for f, v in zip(ths.HashCarry._fields, ths.hash_carry_to_numpy(
            ths.init_hash_carry(D, cap, H, device="cpu"))):
        # the mass sequence runs 2 halos; its padding halo is 2
        inp[f"mass_carry_{f}"] = np.full_like(v, 2) if f == "halo" else v
    for tag, seq in (("plain", snaps[lead:]), ("mass", msnaps)):
        h = 2 if tag == "mass" else H
        for s, snap in enumerate(seq):
            flat = _flatten(snap, h)
            for k in ("halo", "ids", "pos", "vel", "mass", "centers"):
                if k in flat:
                    inp[f"{tag}_{k}_{s}"] = flat[k]
    # the scan runs the whole plain sequence from an empty carry
    flats = [_flatten(s, H) for s in snaps]
    inp["scan_L"] = -(-max(len(f["ids"]) for f in flats) // D)
    rng = np.random.default_rng(5)
    rflat = _random_flat(rng, 1000)
    for k, v in rflat.items():
        inp[f"router_{k}"] = v
    inp["router_cap"] = 600
    inp["overflow_n"] = 64
    np.savez(work / "hash_in.npz", **inp)
    outs = run_world("hash", D, str(work), timeout=150)
    return dict(inp=inp, outs=outs, snaps=snaps, msnaps=msnaps, lead=lead,
                carry0=carry0, H=H, K=K, cap=cap, rflat=rflat)


def _rows(outs, key):
    """Every rank's [1, ...] row of ``key``, stacked [D, ...]."""
    return np.concatenate([o[key] for o in outs], axis=0)


def _check_step(got_ev, want_ev, where):
    count = got_ev["count"]
    np.testing.assert_array_equal(count, want_ev.count, err_msg=where)
    for d in range(D):
        k = int(count[d])
        for f in ("halo", "ids", "slots"):
            np.testing.assert_array_equal(
                got_ev[f][d, :k], getattr(want_ev, f)[d, :k],
                err_msg=f"{where} {f}")
        _assert_angles_close(got_ev["angles"][d, :k], want_ev.angles[d, :k])
    np.testing.assert_allclose(got_ev["bulk_vel"], want_ev.bulk_vel,
                               rtol=2e-6, atol=1e-6, err_msg=where)


def _check_carry(outs, tag, want):
    for f, w in zip(ths.HashCarry._fields, want):
        got = _rows(outs, f"{tag}_carry_{f}")
        if f in ("halo", "ids", "slot"):
            np.testing.assert_array_equal(got, w, err_msg=f)
        elif f == "angles":
            _assert_angles_close(got, w)
        else:
            np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-6,
                                       err_msg=f)


def _events_of(outs, prefix, s):
    ev = {}
    for f in ths.HashEvents._fields:
        rows = [o[f"{prefix}_{f}_{s}"] for o in outs]
        ev[f] = rows[0] if f == "bulk_vel" else np.concatenate(rows)
    for o in outs[1:]:
        # the bulk velocities are replicated: the same bits on every rank
        np.testing.assert_array_equal(o[f"{prefix}_bulk_vel_{s}"],
                                      ev["bulk_vel"])
    return ev


@pytest.mark.timeout(240)
def test_sharded_step_matches_jax_from_same_carry(hash_world):
    """Two ranks continue JAX's carry: every step's events and the final
    carry equal JAX's 2-shard step's; the events equal the oracle's."""
    w = hash_world
    seq = w["snaps"][w["lead"]:]
    want, wcarry = _jax_run(seq, w["H"], w["K"], w["cap"], w["carry0"])
    for s, wev in enumerate(want):
        _check_step(_events_of(w["outs"], "plain_ev", s), wev, f"step {s}")
    _check_carry(w["outs"], "plain", wcarry)
    # the oracle agrees on the event sets of the whole sequence
    oracle = OracleTracker(mode="pericentric", box_size=BOX)
    for s, snap in enumerate(w["snaps"]):
        expected = oracle.step(snap)
        if s < w["lead"]:
            continue
        ev = _events_of(w["outs"], "plain_ev", s - w["lead"])
        offs, ids, _ = ths.events_to_reference_order(
            ev["count"], ev["halo"], ev["ids"], ev["slots"], ev["angles"],
            w["H"])
        for h in range(w["H"]):
            np.testing.assert_array_equal(
                np.sort(ids[offs[h]:offs[h + 1]]),
                np.sort(np.asarray(expected[h][0])))


@pytest.mark.timeout(240)
def test_sharded_step_mass_weighted_bulk(hash_world):
    """Per-particle masses through the summed moments: the
    mass-weighted bulk velocity of JAX's step, and its events."""
    w = hash_world
    want, wcarry = _jax_run(
        w["msnaps"], 2, w["K"], w["cap"],
        [w["inp"][f"mass_carry_{f}"] for f in ths.HashCarry._fields])
    total = 0
    for s, wev in enumerate(want):
        _check_step(_events_of(w["outs"], "mass_ev", s), wev, f"step {s}")
        total += int(wev.count.sum())
    _check_carry(w["outs"], "mass", wcarry)
    assert total > 0


@pytest.mark.timeout(240)
def test_hash_scan_matches_jax(hash_world):
    """The scan (all-to-all routing and the step a snapshot on each
    rank) equals JAX's make_hash_scan on the same sequence, and drops
    nothing."""
    w = hash_world
    inp = w["inp"]
    S = int(inp["plain_S"])
    flats = [{k: inp[f"plain_{k}_{s}"]
              for k in ("halo", "ids", "pos", "vel", "mass")}
             for s in range(S)]
    seqs = [jhs.flat_to_position_shards(f, D, pad_to=int(inp["scan_L"]))
            for f in flats]
    flat_seq = jax.tree.map(lambda *xs: jnp.stack(xs), *seqs)
    centers = np.stack([inp[f"plain_centers_{s}"] for s in range(S)])
    mesh = jax_mesh({"shards": D}, jax.devices()[:D])
    scan = jax.jit(jhs.make_hash_scan(mesh, w["H"], w["K"], w["cap"],
                                      box_size=BOX))
    _, evs, dropped = scan(jhs.init_hash_carry(D, w["cap"], w["H"]),
                           flat_seq, centers)
    evs = jax.tree.map(np.asarray, evs)
    assert int(np.asarray(dropped).sum()) == 0
    np.testing.assert_array_equal(_rows_seq(w["outs"], "scan_dropped"),
                                  np.asarray(dropped))
    for s in range(S):
        got = {f: (w["outs"][0][f"scan_{f}"][s] if f == "bulk_vel"
                   else _rows_seq(w["outs"], f"scan_{f}")[s])
               for f in ths.HashEvents._fields}
        _check_step(got, jhs.HashEvents(*(getattr(evs, f)[s]
                                          for f in jhs.HashEvents._fields)),
                    f"scan step {s}")


def _rows_seq(outs, key):
    """Every rank's ``[S, 1, ...]`` rows of ``key`` as ``[S, D, ...]``."""
    return np.concatenate([o[key] for o in outs], axis=1)


@pytest.mark.timeout(240)
def test_device_router_matches_host_router(hash_world):
    """The all-to-all router gives route_flat's blocks bit for bit (and
    JAX's router's), dropping nothing."""
    w = hash_world
    host = ths.route_flat(w["rflat"], D, int(w["inp"]["router_cap"]))
    assert int(_rows(w["outs"], "router_dropped").sum()) == 0
    for name in ths.HashBatch._fields:
        np.testing.assert_array_equal(
            _rows(w["outs"], f"router_{name}"), getattr(host, name),
            err_msg=name)
    mesh = jax_mesh({"shards": D}, jax.devices()[:D])
    jb, _ = jax.jit(jhs.make_device_router(mesh, int(w["inp"]["router_cap"])))(
        jhs.flat_to_position_shards(w["rflat"], D))
    for name in ths.HashBatch._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)),
                                      getattr(host, name), err_msg=name)


@pytest.mark.timeout(240)
def test_device_router_overflow_fail_loud(hash_world):
    """Bucket overflow is reported in ``dropped``: every ID on shard 0,
    buckets of exactly the size fit, half of that drops the rest."""
    w = hash_world
    n = int(w["inp"]["overflow_n"])
    assert int(_rows(w["outs"], "overflow_fits").sum()) == 0
    assert int(_rows(w["outs"], "overflow_over").sum()) == n - D * (
        n // (2 * D))
    flat = dict(halo=np.zeros(4, np.int32), ids=np.arange(4),
                pos=np.zeros((4, 3), np.float32),
                vel=np.zeros((4, 3), np.float32))
    fl = ths.FlatRecords(*(None if x is None else torch.from_numpy(x)
                           for x in ths.flat_to_position_shards(flat, 1)))
    route = ths.make_device_router(make_mesh({"shards": 1}, device="cpu"),
                                   cap=64, block=8)
    with pytest.raises(ValueError, match="too small"):
        route(fl)
