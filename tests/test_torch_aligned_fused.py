"""The aligned step's fused frame-and-detect kernels (``csrc/static.cu``
``aligned_moments`` and ``aligned_frame_detect``) on the card, against
the plain chain they replace (``ops/sorted_step.py``
``aligned_chain_torch``) on the CPU and on the same CUDA tensors.

Given the plain chain's bulk velocity the kernels' outputs are the same
bits; their own bulk velocity sums in float64, so it is held to the
float64 sum of the same float32 products (torch's float32 ``sum`` of
config 2's near-zero bulk velocities is itself thousands of ulps from
it).  Every test here needs a CUDA device and skips without one; the
file imports nothing of JAX, so run it on the card without the repo's
conftest:

    python -m pytest --noconftest -q tests/test_torch_aligned_fused.py
"""

import numpy as np
import pytest
import torch

from orbitanalysis_tpu_torch.engine.packing import StableLayout, align_packed
from orbitanalysis_tpu_torch.models.synthetic import churn_workload
from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.ops import sorted_step as tss
from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch
from orbitanalysis_tpu_torch.ops.compact import PAYLOAD_MAX_ROW
from orbitanalysis_tpu_torch.utils.numerics import hubble_parameter

pytestmark = pytest.mark.cuda

INVALID = np.iinfo(np.int32).max

#: config 2's Hubble term H(z) / (1 + z) (portbench/configs/config2.json).
CONFIG2_DRAG = float(hubble_parameter(0.5, 0.1, 0.3, 0.7) / 1.5)

BOXES = {"none": None, "scalar": 100.0, "vector": (100.0, 90.0, 110.0)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _snapshots(h, p, n_snap, soa, mass, drag, seed=2):
    """The churn sequence in the stable layout: one CPU SnapshotBatch a
    snapshot (FRESH slots, invalid padding, masses when asked)."""
    ids, pos, vel, cen, _ = churn_workload(h, p, n_snap, seed=seed)
    rng = np.random.default_rng(seed)
    lay = StableLayout(h, p)
    out = []
    for s in range(n_snap):
        m = (rng.uniform(0.5, 2.0, (h, p)).astype(np.float32) if mass
             else None)
        a_ids, a_pos, a_vel, a_m, slot = align_packed(
            lay, ids[s], pos[s], vel[s], m, soa=soa)
        t = {k: None if v is None else torch.from_numpy(
            np.ascontiguousarray(v)) for k, v in dict(
                ids=a_ids, pos=a_pos, vel=a_vel, center=cen[s], mass=a_m,
                slot=slot).items()}
        out.append(SnapshotBatch(**t, hubble_drag=drag))
    return out


def _on(x, d):
    if isinstance(x, tuple):
        moved = (_on(t, d) for t in x)
        return type(x)(*moved) if hasattr(x, "_fields") else tuple(moved)
    if isinstance(x, torch.Tensor):
        return x.to(d)
    return x


def _snap_on(snap, d):
    return snap._replace(**{f: _on(getattr(snap, f), d) for f in (
        "ids", "pos", "vel", "center", "mass", "slot", "bulk_vel")})


def _carry_before(snaps, box, pericentric, soa, packed):
    """The carry after the plain step over all but the last snapshot
    (CPU), so the last step meets matched lanes, angles and sign bits."""
    h, p = snaps[0].ids.shape
    step = tss.make_aligned_native_step(
        128, mode="pericentric" if pericentric else "apocentric",
        box_size=box, soa_batch=soa, rhat_packed=packed)
    carry = tss.init_aligned_carry(h, p, rhat_packed=packed, device="cpu")
    for snap in snaps[:-1]:
        carry, _ = step(carry, snap)
    return carry


def _bits(t):
    t = t.cpu()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_chain_equal(got, want):
    """Every output of the chain the same bits: key, sv, r-hat, packed,
    the words (one plane or the pair), count, bulk velocity."""
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _assert_chain_equal(g, w)
        else:
            assert g.shape == w.shape
            assert torch.equal(_bits(g), _bits(w))


def _exact_bulk(snap, soa):
    """The float64 sum of the float32 products ``w m v`` over the float64
    sum of ``w m``, rounded to float32: ``[H, 3]``."""
    w = (snap.ids != INVALID).to(torch.float32)
    wm = w if snap.mass is None else w * snap.mass
    vel = snap.vel if soa else snap.vel.movedim(-1, 0)
    prod = (wm[None] * vel).to(torch.float64)
    return (prod.sum(-1) / wm.to(torch.float64).sum(-1)).T.to(torch.float32)


def _ulps(a, b):
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("pericentric", [True, False])
@pytest.mark.parametrize("drag", [0.0, CONFIG2_DRAG])
@pytest.mark.parametrize("box", list(BOXES))
@pytest.mark.parametrize("mass", [False, True])
@pytest.mark.parametrize("soa", [False, True])
def test_fused_chain_matches_plain(dev, soa, mass, box, drag, pericentric,
                                   packed):
    """Rows of 4480 slots (not a multiple of the 1024-slot tile) with
    FRESH slots and padding.  Fed the plain chain's bulk velocity, the
    kernel's outputs equal the plain chain's on the CPU and on the same
    CUDA tensors, bit for bit.  Left to estimate it, the moments kernel
    gives the float64 sum's bulk velocity to 2 ulp, torch's to its
    float32 rounding, the same bits on a second run, and one launch of
    each kernel a call."""
    h, p = 5, 4480
    box_size = BOXES[box]
    snaps = _snapshots(h, p, 3, soa, mass, drag)
    carry = _carry_before(snaps, box_size, pericentric, soa, packed)
    snap = snaps[-1]
    args = (box_size, pericentric, INVALID)
    kw = dict(soa=soa, rhat_packed=packed)
    plain = tss.aligned_chain_torch(carry, snap, *args, **kw)
    assert int(plain[5].sum()) > 0
    assert bool(((snap.slot & (1 << 27)) != 0).any())
    assert bool((snap.ids == INVALID).any())

    fed = snap._replace(bulk_vel=plain[6].contiguous())
    carry_d, fed_d = _on(carry, dev), _snap_on(fed, dev)
    _cuda.reset_launch_counts()
    got = tss.aligned_chain(carry_d, fed_d, *args, **kw)
    plain_cuda = tss.aligned_chain_torch(carry_d, fed_d, *args, **kw)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["aligned_frame_detect"] == 1
    assert _cuda.launch_counts()["aligned_moments"] == 0
    _assert_chain_equal(got, plain)
    _assert_chain_equal(got, plain_cuda)

    snap_d = _snap_on(snap, dev)
    est = tss.aligned_chain(carry_d, snap_d, *args, **kw)
    again = tss.aligned_chain(carry_d, snap_d, *args, **kw)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["aligned_moments"] == 2
    _assert_chain_equal(again, est)
    bulk = est[6].cpu()
    assert int(_ulps(bulk, _exact_bulk(snap, soa)).max()) <= 2
    np.testing.assert_allclose(bulk.numpy(), plain[6].numpy(), rtol=2e-6,
                               atol=1e-6)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("soa", [False, True])
def test_fused_chain_wide_rows(dev, soa, packed):
    """Rows past PAYLOAD_MAX_ROW: the kernel writes K3's position and f16
    planes in place of the angle word, the plain chain's bits."""
    h, p = 2, PAYLOAD_MAX_ROW + 129
    snaps = _snapshots(h, p, 3, soa, True, CONFIG2_DRAG)
    carry = _carry_before(snaps, 100.0, True, soa, packed)
    snap = snaps[-1]
    args = (100.0, True, INVALID)
    kw = dict(soa=soa, rhat_packed=packed)
    plain = tss.aligned_chain_torch(carry, snap, *args, **kw)
    assert isinstance(plain[4], tuple) and int(plain[5].sum()) > 0
    fed = _snap_on(snap._replace(bulk_vel=plain[6].contiguous()), dev)
    got = tss.aligned_chain(_on(carry, dev), fed, *args, **kw)
    torch.cuda.synchronize()
    _assert_chain_equal(got, plain)


@pytest.mark.parametrize("emit_payload", [False, True])
@pytest.mark.parametrize("soa", [False, True])
@pytest.mark.parametrize("bulk", ["catalog", "estimated"])
def test_aligned_step_on_cuda(dev, soa, emit_payload, bulk):
    """The whole 'xla' step on the card, a few steps from a fresh carry:
    each step launches the fused pass once, K1 once and the moments
    kernel once when no catalog bulk velocity comes.  With the catalog's
    bulk velocities, carries, events and payload equal the CPU step's
    bits; estimated, the counts and positions equal the CPU step's on
    this sequence."""
    h, p, k = 6, 4096, 256
    snaps = _snapshots(h, p, 4, soa, True, CONFIG2_DRAG, seed=5)
    if bulk == "catalog":
        rng = np.random.default_rng(1)
        snaps = [s._replace(bulk_vel=torch.from_numpy(
            rng.normal(scale=0.05, size=(h, 3)).astype(np.float32)))
            for s in snaps]
    step = tss.make_aligned_native_step(k, box_size=100.0, soa_batch=soa,
                                        emit_payload=emit_payload)
    runs = {}
    for d in (dev, "cpu"):
        _cuda.reset_launch_counts()
        carry, evs = tss.init_aligned_carry(h, p, device=d), []
        for s in snaps:
            carry, ev = step(carry, _snap_on(s, d))
            evs.append(ev)
        if d == dev:
            torch.cuda.synchronize()
            counts = {n: c for n, c in _cuda.launch_counts().items() if c}
            want = {"aligned_frame_detect": len(snaps),
                    "compact_angle_rows": len(snaps)}
            if bulk == "estimated":
                want["aligned_moments"] = len(snaps)
            assert counts == want
        runs[str(d)] = carry, evs
    (c_gpu, e_gpu), (c_cpu, e_cpu) = runs[str(dev)], runs["cpu"]
    exact = bulk == "catalog"
    for f in c_cpu._fields:
        if exact or f in ("key",):
            assert torch.equal(_bits(getattr(c_gpu, f)),
                               _bits(getattr(c_cpu, f)))
    total = 0
    for g, c in zip(e_gpu, e_cpu):
        assert torch.equal(g.count.cpu(), c.count)
        assert torch.equal(g.ids.cpu(), c.ids)
        total += int(c.count.sum())
        if exact:
            assert torch.equal(_bits(g.angles), _bits(c.angles))
            assert torch.equal(_bits(g.bulk_vel), _bits(c.bulk_vel))
            if emit_payload:
                assert torch.equal(g.payload.cpu(), c.payload)
        assert (g.payload is None) == (not emit_payload)
    assert total > 0


def test_config2_step_kernels_a_step(dev):
    """One config-2-shaped aligned step ([100, 16384] SoA rows with masses,
    box 25, config 2's Hubble term, bulk velocities estimated), as the
    scan runs it, under torch.profiler: at most 20 device kernels (the
    eager chain it replaced launched ~170), one launch each of the fused
    pass, the moments kernel and K1, and the same in launch_counts."""
    from torch.profiler import ProfilerActivity, profile

    h, p = 100, 16384
    snaps = [_snap_on(s, dev) for s in _snapshots(h, p, 3, True, True,
                                                  CONFIG2_DRAG)]
    step = tss.make_aligned_native_step(1024, box_size=25.0, soa_batch=True)
    carry = tss.init_aligned_carry(h, p, device=dev)
    for s in snaps[:2]:
        carry, _ = step(carry, s)
    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        carry, ev = step(carry, snaps[2])
        torch.cuda.synchronize()
    assert int(ev.count.sum()) > 0
    assert {n: c for n, c in _cuda.launch_counts().items() if c} == {
        "aligned_moments": 1, "aligned_frame_detect": 1,
        "compact_angle_rows": 1}
    # the device events less copies, fills of memory and the step's own
    # oa.step.* ranges
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith(("Memset", "Memcpy", "oa."))]
    assert len(kernels) <= 20, kernels
    assert sum("aligned_frame_detect_kernel" in n for n in kernels) == 1
    assert sum("aligned_moments_kernel" in n for n in kernels) == 1
    assert sum("compact_tiles_kernel" in n and "AngleWords" in n
               for n in kernels) == 1


def test_fused_chain_refuses_bad_inputs(dev):
    """The wrappers check dtypes and shapes before a launch: float64
    coordinates and a mismatched carry raise, and nothing is counted."""
    h, p = 2, 1024
    snap = _snap_on(_snapshots(h, p, 1, False, False, 0.0)[0], dev)
    carry = tss.init_aligned_carry(h, p, device=dev)
    _cuda.reset_launch_counts()
    with pytest.raises(ValueError, match="float32"):
        tss.aligned_chain(carry, snap._replace(pos=snap.pos.double(),
                                               vel=snap.vel.double()),
                          None, True, INVALID)
    catalog = snap._replace(bulk_vel=torch.zeros(h, 3, device=dev))
    with pytest.raises(ValueError, match="int32"):
        tss.aligned_chain(carry, catalog, None, True, INVALID,
                          rhat_packed=True)
    assert set(_cuda.launch_counts().values()) == {0}
