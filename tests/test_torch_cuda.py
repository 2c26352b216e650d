"""The port's hand-written CUDA kernels on the card, against their
plain-torch twins, and the port's main paths (the tracker's aligned and
sorted engines, the label-native detector, the sorted scan, the N-body
integrator with PM and direct forces) on CUDA against the same paths on
the CPU.

Every test here needs a CUDA device and skips without one.  The file
imports nothing of JAX (the machine with the card has none), so run it
there without the repo's conftest, which imports jax:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from orbitanalysis_tpu_torch import track_orbits
from orbitanalysis_tpu_torch.engine.io_hdf5 import MemoryWriter
from orbitanalysis_tpu_torch.models.synthetic import churn_snapshots
from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.ops import compact as tc
from orbitanalysis_tpu_torch.ops import frames as tf
from orbitanalysis_tpu_torch.ops import label as tl
from orbitanalysis_tpu_torch.ops import label_step as tls
from orbitanalysis_tpu_torch.ops import merge as tm
from orbitanalysis_tpu_torch.ops import sorted_step as tss
from orbitanalysis_tpu_torch.ops import step as ts
from orbitanalysis_tpu_torch.probes import detect_probe as tdp
from orbitanalysis_tpu_torch.probes import dma_probe as tdm
from orbitanalysis_tpu_torch.utils.metrics import Metrics

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _angle_words(rng, h, p, density):
    ang = rng.uniform(0.0, 7.0, (h, p)).astype(np.float32)
    sel = rng.random((h, p)) < density
    return ang.view(np.uint32) | (sel.astype(np.uint32) << np.uint32(31))


#: Words of one tile of K1/K2 and K4/K5 (``csrc/compact.cu`` kTileWords).
K1_TILE = 4096


@pytest.mark.parametrize("h,p,k", [
    (64, 32768, 2048), (3, 256, 256), (5, 131072 - 128, 4096), (2, 4096, 128),
    # rows at and around K1's tile: one row of lanes, one tile less and
    # one more row of lanes, and 4096 short rows
    (3, 128, 128), (3, K1_TILE - 128, 256), (3, K1_TILE + 128, 256),
    (4096, 128, 128)])
@pytest.mark.parametrize("density", [0.0, 0.017, 0.07, 0.5, 1.0])
def test_angle_kernel_matches_twin(dev, h, p, k, density):
    """K1/K2 bit-equal to the plain version on the card and on the CPU,
    with a clustered block, the f16 clamp lanes at the row's end and, on
    rows of more than one tile, a burst of events and the clamp lanes
    across a tile edge; at density 1 the counts pass k128 on rows of
    several tiles."""
    rng = np.random.default_rng(int(density * 100) + p)
    aw = _angle_words(rng, h, p, density)
    aw[0, 1000 % p:1000 % p + 100] |= np.uint32(1 << 31)  # clustered block
    aw[-1, -1] = np.float32(65520.0).view(np.uint32) | np.uint32(1 << 31)
    if p > K1_TILE:
        aw[-1, K1_TILE - 300:K1_TILE + 200] |= np.uint32(1 << 31)
        aw[0, K1_TILE - 2:K1_TILE + 2] = np.array(
            [65504.0, 65519.0, 65520.0, 1e30], np.float32).view(
                np.uint32) | np.uint32(1 << 31)
    x = _i32(aw)
    k128 = tc._k128(k, p)
    _poison((h, k128))
    got = tc.compact_angle_blocked(x.to(dev), k)
    plain_cuda = tc.compact_angle_blocked_torch(x.to(dev), k)
    torch.cuda.synchronize()
    want = tc.compact_angle_blocked_torch(x, k)
    if density == 1.0 and p > K1_TILE:
        assert int(((x >> 31) != 0).sum(1).min()) > k128
    assert torch.equal(got, plain_cuda)
    assert torch.equal(got.cpu(), want)


#: Words of one tile of K3 (``csrc/compact.cu`` kTileThreads * kPairVT).
K3_TILE = 2048


def _pair_planes(rng, h, p, density):
    """K3's ``posw``/``angw`` ``[h, p]`` planes at ``density``, with
    bursts of events across tile edges of K3 and K4 (row 0 around
    ``3 * K3_TILE``, the last row around ``4096 * 5``), an event at every
    row's last position and the f16 clamp word among the angles."""
    sel = rng.random((h, p)) < density
    sel[0, 3 * K3_TILE - 300:3 * K3_TILE + 200] = True
    sel[-1, 4096 * 5 - 150:4096 * 5 + 100] = True
    sel[:, p - 1] = True
    posw = np.where(sel, np.arange(p, dtype=np.uint32) + 1, np.uint32(0))
    angw = np.where(sel, rng.integers(0, 0x7BFF, (h, p)).astype(np.uint32),
                    np.uint32(0))
    angw[:, p - 1] = 0x7BFF
    return _i32(posw), _i32(angw), sel


@pytest.mark.parametrize("p,k", [(131200, 2048), (1 << 17, 128),
                                 (1 << 18, 16384), (1 << 19, 4096)])
@pytest.mark.parametrize("h", [1, 2, 4])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 1.0])
def test_pair_kernel_matches_twin(dev, p, k, h, density):
    """K3 on the aligned step's wide rows (one to four halos past
    PAYLOAD_MAX_ROW, up to MAX_ALIGNED_CAPACITY): bit-equal to the plain
    version on the same CUDA tensors and on the CPU, outputs poisoned
    first, with bursts across tile edges, the last position kept, and
    counts past k128 at densities 0.5 and 1."""
    rng = np.random.default_rng(p + h + int(density * 100))
    posw, angw, sel = _pair_planes(rng, h, p, density)
    k128 = tc._k128(k, p)
    _poison((h, k128), (h, k128))
    xp, xa = posw.to(dev), angw.to(dev)
    got = tc.compact_payload_pair(xp, xa, k)
    plain_cuda = tc.compact_payload_pair_torch(xp, xa, k)
    want = tc.compact_payload_pair_torch(posw, angw, k)
    torch.cuda.synchronize()
    if density >= 0.5:
        assert int(sel.sum(1).min()) > k128
    for g, c, w in zip(got, plain_cuda, want):
        assert torch.equal(g, c)
        assert torch.equal(g.cpu(), w)
    if sel.sum(1).max() <= k128:
        assert int(got[0][0, int(sel[0].sum()) - 1]) == p


def test_launch_counts_and_input_checks(dev):
    _cuda.reset_launch_counts()
    x = torch.zeros((2, 256), dtype=torch.int32, device=dev)
    tc.compact_angle_blocked(x, 128)
    tc.compact_payload_pair(x, x, 128)
    tc.compact_angle_blocked_torch(x, 128)  # the twin is not counted
    counts = _cuda.launch_counts()
    assert counts.pop("compact_angle_rows") == 1
    assert counts.pop("compact_pair_rows") == 1
    assert set(counts.values()) == {0}
    with pytest.raises(ValueError, match="int32"):
        tc.compact_angle_blocked(x.long(), 128)
    with pytest.raises(ValueError, match="contiguous"):
        tc.compact_angle_blocked(
            torch.zeros((256, 2), dtype=torch.int32, device=dev).T, 128)


def _setup(n_halos=4, n_part=3000, n_snap=6, box=40.0):
    snaps, centers = churn_snapshots(n_halos, n_part, n_snap, box_size=box,
                                     churn=0.07, seed=7)

    def regions(s, halo_ids):
        return centers[halo_ids], np.full(len(halo_ids), 50.0)

    def load(s, rp, rr):
        d = snaps[s]
        lens = [len(d[h]["ids"]) for h in range(n_halos)]
        return dict(
            ids=np.concatenate([d[h]["ids"] for h in range(n_halos)]),
            coordinates=np.concatenate([d[h]["pos"] for h in range(n_halos)]),
            velocities=np.concatenate([d[h]["vel"] for h in range(n_halos)]),
            masses=np.concatenate([d[h]["mass"] for h in range(n_halos)]),
            region_offsets=np.concatenate(([0], np.cumsum(lens)[:-1])),
            box_size=box,
        )

    return (np.arange(n_snap), np.tile(np.arange(n_halos), (n_snap, 1)),
            regions, load)


def test_main_path_on_cuda_matches_cpu(dev):
    """track_orbits on the card (auto -> aligned, through the kernel)
    writes the catalog the CPU run writes: event IDs exact, angles to
    one f16 ulp, bulk velocities to about one f32 ulp."""
    args = _setup()
    _cuda.reset_launch_counts()
    m = Metrics()
    w_gpu, w_cpu = MemoryWriter(), MemoryWriter()
    track_orbits(*args, "run.h5", verbose=False, metrics=m, writer=w_gpu)
    assert {r["join"] for r in m.records} == {"aligned"}
    assert _cuda.launch_counts()["compact_angle_rows"] == len(m.records) + 1
    track_orbits(*args, "run.h5", verbose=False, device="cpu",
                 join_impl="aligned", writer=w_cpu)
    a, b = w_gpu.files["run.h5"], w_cpu.files["run.h5"]
    assert sorted(a) == sorted(b)
    n_events = 0
    for g in a:
        if g == "attrs":
            continue
        for ds in a[g]:
            if ds == "angles":
                np.testing.assert_allclose(a[g][ds].astype(np.float32),
                                           b[g][ds].astype(np.float32),
                                           atol=4e-3)
            elif ds == "bulk_velocities":
                np.testing.assert_allclose(a[g][ds], b[g][ds], rtol=2e-6,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(a[g][ds], b[g][ds])
        n_events += len(a[g]["pericenter_IDs"])
    assert n_events > 0


def test_tracker_accounting_on_cuda(dev, monkeypatch):
    """With ``metrics`` every record of the card's aligned run holds the
    step's device seconds (CUDA timing events read after the fetch),
    positive and inside the call, and the staged bytes; the accounted
    seconds stay inside the call.  With tracing off no CUDA timing event
    is made and no profiler range is entered."""
    import time

    args = _setup()
    m = Metrics()
    t0 = time.perf_counter()
    track_orbits(*args, "run.h5", verbose=False, metrics=m,
                 writer=MemoryWriter())
    call_s = time.perf_counter() - t0
    assert {r["join"] for r in m.records} == {"aligned"}
    for r in m.records:
        assert 0.0 < r["step_device_s"] < call_s
        assert r["stage_s"] + r["issue_s"] <= r["step_s"] + 1e-6
        assert r["h2d_bytes"] > 36 * r["capacity"]
    assert m.records[0]["lead_s"] + sum(
        r["snapshot_s"] for r in m.records) <= call_s

    real = torch.cuda.Event

    def event(*a, **k):
        if k.get("enable_timing"):
            raise AssertionError("a CUDA timing event with tracing off")
        return real(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.cuda, "Event", event)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    track_orbits(*args, "run.h5", verbose=False, writer=MemoryWriter())
    torch.cuda.synchronize()


# ----------------------------------------------------------------------
# the label-native detector's kernels (K4-K9) and its step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("h,p,k", [(64, 32768, 2048), (3, 1024, 128),
                                   (4, 32768, 8192)])
@pytest.mark.parametrize("density", [0.0, 0.017, 0.07, 0.5, 1.0])
def test_payload_kernel_matches_twin(dev, h, p, k, density):
    rng = np.random.default_rng(int(density * 100) + p + 3)
    sel = rng.random((h, p)) < density
    sel[0, 100:400] = True                      # a clustered burst
    ang = rng.integers(0, 0x7BFF, (h, p)).astype(np.uint32)
    pos1 = np.arange(1, p + 1, dtype=np.uint32)
    pay = _i32(np.where(sel, (pos1 << np.uint32(15)) | ang, np.uint32(0)))
    for entry in (tc.compact_payload, tc.compact_payload_blocked):
        got = entry(pay.to(dev), k)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), tc.compact_payload_torch(pay, k))


#: Words of one tile of K4/K5 (``csrc/compact.cu`` kPayTile) and
#: positions of one tile of K8 (``csrc/label.cu`` kCompactTile): the row
#: lengths of the tile-edge cases.
K4_TILE, K8_TILE = 4096, 1024


def _poison(*shapes):
    """Allocate int32 blocks of ``shapes`` filled with -1 and free them,
    so that the caching allocator hands them to the next outputs of those
    sizes: a lane a kernel fails to write then shows."""
    junk = [torch.full(s, -1, dtype=torch.int32, device="cuda")
            for s in shapes]
    del junk


def _payload_plane(rng, h, p, density, burst_at=None):
    """Payload words ``((pos + 1) << 15) | f16`` of ``[h, p]`` rows at
    ``density``, row 0 with a run of events around ``burst_at``."""
    sel = rng.random((h, p)) < density
    if burst_at is not None:
        sel[0, max(0, burst_at - 300):burst_at + 200] = True
    ang = rng.integers(0, 0x7BFF, (h, p)).astype(np.uint32)
    pos1 = np.arange(1, p + 1, dtype=np.uint32)
    return _i32(np.where(sel, (pos1 << np.uint32(15)) | ang, np.uint32(0)))


@pytest.mark.parametrize("h,p,k", [
    (3, 1, 128), (3, 127, 128), (3, K4_TILE, 128), (3, K4_TILE + 1, 256),
    (64, 32768, 2048), (2, tc.PAYLOAD_MAX_ROW, 4096), (4096, 128, 128)])
@pytest.mark.parametrize("density", [0.0, 0.017, 1.0])
def test_payload_kernel_tile_edges(dev, h, p, k, density):
    """K4/K5 at rows around its tile (one word, a partial tile, one tile,
    one word past it), at the bench shape, at the widest single-word row
    and on 4096 short rows: bit-equal to the plain front-pack on the same
    CUDA tensors and on the CPU, with a burst across a tile edge, counts
    past k128 at density 1 and rows without events at density 0.  Rows
    that are not a multiple of 128 go to the kernel's wrapper directly:
    the entry point refuses them, the kernel does not."""
    rng = np.random.default_rng(p + h + int(density * 100))
    burst = min(K4_TILE, p - 1) if p > 64 and density < 1.0 else None
    x = _payload_plane(rng, h, p, density, burst)
    k128 = tc._k128(k, p)
    xd = x.to(dev)
    _poison((h, k128))
    got = _cuda.compact_payload_rows(xd, k128)
    plain_cuda = tc._front_pack((xd >> 15) != 0, [xd], k128)[0]
    plain_cpu = tc._front_pack((x >> 15) != 0, [x], k128)[0]
    torch.cuda.synchronize()
    if p % 128 == 0:
        assert torch.equal(plain_cpu, tc.compact_payload_torch(x, k))
    if density == 1.0 and p > k128:
        assert int(((x >> 15) != 0).sum(1).min()) > k128
    assert torch.equal(got, plain_cuda)
    assert torch.equal(got.cpu(), plain_cpu)


@pytest.mark.parametrize("n,h", [(1 << 21, 64), (5000, 7), (4096, 300)])
def test_frame_rows_kernel_exact(dev, n, h):
    rng = np.random.default_rng(n + h)
    table = (rng.normal(size=(h, 6))
             * np.exp2(rng.integers(-40, 40, size=(h, 6)))).astype(np.float32)
    lab = rng.integers(-1, h + 2, size=n).astype(np.int32)
    got = tf.frame_rows(torch.from_numpy(table).to(dev),
                        torch.from_numpy(lab).to(dev))
    torch.cuda.synchronize()
    want = tf.frame_rows_torch(torch.from_numpy(table), torch.from_numpy(lab))
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n,h", [(1 << 21, 64), (5000, 7), (40000, 300),
                                 (3000, 4000)])
@pytest.mark.parametrize("mass", [False, True])
def test_moments_kernel_matches_twin(dev, n, h, mass):
    """rtol = atol = 2e-6 against the plain one-hot sums (another order
    of summation); the kernel's own bits repeat from run to run."""
    rng = np.random.default_rng(n + h + mass)
    lab = np.repeat(rng.integers(-1, h + 1, size=n // 50 + 1), 50)[:n]
    lab = np.where(rng.random(n) < 0.1, rng.integers(-1, h, size=n), lab)
    args = (torch.from_numpy(lab.astype(np.int32)).to(dev),
            torch.from_numpy(rng.normal(size=(3, n)).astype(np.float32)
                             ).to(dev),
            torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32)
                             ).to(dev) if mass else None)
    got = tf.segment_moments(*args, n_halos=h)
    again = tf.segment_moments(*args, n_halos=h)
    want = tf.segment_moments_torch(*args, n_halos=h)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-6, atol=2e-6)


def _label_planes(dev, r, w, h, seed, packed, steps=3):
    """Inputs of one detect pass on a carry after ``steps`` steps of the
    CPU label step (so matched lanes exist), on the CPU and on ``dev``,
    and the frame table the rows plane was gathered from."""
    rng = np.random.default_rng(seed)
    n = r * w
    step = tls.make_label_orbit_step(128, box_size=100.0, row_width=w,
                                     frames="matmul", rhat_packed=packed)
    c = tls.init_label_carry(n, row_width=w, rhat_packed=packed,
                             device="cpu")
    lab = rng.integers(-1, h, n).astype(np.int32)
    cen = rng.uniform(20, 80, (h, 3)).astype(np.float32)
    bulk = rng.normal(size=(h, 3)).astype(np.float32)
    pos = vel = None
    for s in range(steps + 1):
        pos = rng.uniform(0, 100, (3, r, w)).astype(np.float32)
        vel = rng.normal(size=(3, r, w)).astype(np.float32)
        lab = np.where(rng.random(n) < 0.9, lab,
                       rng.integers(-1, h, n)).astype(np.int32)
        if s < steps:
            c, _ = step(c, tuple(map(torch.from_numpy, (
                pos, vel, lab.reshape(r, w), cen, bulk))) + (None, 0.01))
    table = torch.from_numpy(np.concatenate([cen, bulk], axis=1))
    rows = tf.frame_rows_torch(table, torch.from_numpy(lab)).reshape(6, r, w)
    cpu = [rows, torch.from_numpy(lab.reshape(r, w)),
           torch.from_numpy(pos), torch.from_numpy(vel), *c]
    return cpu, [t.to(dev) for t in cpu], table


def _assert_detect_equal(got, want, packed):
    """Counts, lab_sv, the matched bit and the payload positions exact;
    angles within one f16 ulp or 2e-3 rad."""
    got = [t.cpu() for t in got]
    want = [t.cpu() for t in want]
    assert torch.equal(got[4], want[4])                 # count
    assert torch.equal(got[0], want[0])                 # lab_sv
    assert torch.equal(got[2] < 0, want[2] < 0)         # matched bit
    gp, wp = got[3], want[3]
    assert torch.equal((gp >> 15) & 0x1FFFF, (wp >> 15) & 0x1FFFF)
    assert int(((gp & 0x7FFF) - (wp & 0x7FFF)).abs().max()) <= 1
    ga = (got[2] & 0x7FFFFFFF).view(torch.float32)
    wa = (want[2] & 0x7FFFFFFF).view(torch.float32)
    assert float((ga - wa).abs().max()) <= 2e-3
    if not packed:
        assert float((got[1] - want[1]).abs().max()) <= 1e-6


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("r,w", [(64, 32768), (4, 1024)])
def test_detect_kernels_match_twin(dev, r, w, packed):
    cpu, cuda, _ = _label_planes(dev, r, w, 64, r + w, packed)
    kw = dict(pericentric=True, box_size=100.0, rhat_packed=packed)
    k9 = tl.detect_label(*cuda, 0.01, **kw)
    k8 = tl.detect_label_compact(*cuda, 0.01, event_capacity=2048, **kw)
    plain_cuda = tl.detect_label_torch(*cuda, 0.01, **kw)
    plain_cpu = tl.detect_label_torch(*cpu, 0.01, **kw)
    torch.cuda.synchronize()
    assert int(plain_cpu[4].sum()) > 0
    for want in (plain_cuda, plain_cpu):
        _assert_detect_equal(k9, want, packed)
        ev = tc.compact_payload_torch(want[3].cpu(), 2048)
        _assert_detect_equal(
            (k8[0], k8[1], k8[2], k8[3], k8[4]),
            (want[0], want[1], want[2], ev.to(k8[3].device), want[4]),
            packed)


def _burst_row(planes, pericentric):
    """Row 0 of the CPU detect inputs ``planes`` rebuilt so that every
    tracked lane fires: the carry says matched and moving inward
    (outward when apocentric), the particle sits within 5 of its frame's
    centre (no periodic wrap) and moves outward (inward)."""
    rows, lab, pos, vel, sv, rhat, packed = planes
    rng = np.random.default_rng(int(lab.shape[1]))
    tracked = lab[0] >= 0
    off = torch.from_numpy(rng.uniform(-5, 5, (3, lab.shape[1])).astype(
        np.float32))
    pos[:, 0] = rows[:3, 0] + off
    vel[:, 0] = rows[3:, 0] + (2.0 if pericentric else -2.0) * off
    prev_vrb = 1 if pericentric else 2
    sv[0] = torch.where(tracked, (lab[0] + 1) | (prev_vrb << 28), 0).int()
    packed[0] = torch.where(tracked, packed[0] | -(1 << 31), packed[0])


@pytest.mark.parametrize("w,k", [
    (128, 128), (K8_TILE - 128, 128), (K8_TILE + 128, 128), (32768, 2048),
    ((1 << 17) - 128, 2048)])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("pericentric", [True, False])
def test_detect_compact_kernel_tile_edges(dev, w, k, packed, pericentric):
    """K8 at rows below one tile, around it, at the bench width and at the
    widest label row (``label_step``'s row_width limit), packed and f32
    r-hat, pericentric and apocentric, row 0 a burst whose events exceed
    k128 (but at W = 128): every output bit-equal to the plain version
    on the same CUDA tensors (zeros past the counts, counts past k128),
    and to the plain version on the CPU as the detect tests compare it."""
    r = 3
    cpu, _, _ = _label_planes("cpu", r, w, 16, w + packed, packed)
    _burst_row(cpu, pericentric)
    cuda = [t.to(dev) for t in cpu]
    kw = dict(pericentric=pericentric, box_size=100.0, rhat_packed=packed,
              event_capacity=k)
    k128 = tc._k128(k, w)
    _poison((r, k128), (r,))
    got = tl.detect_label_compact(*cuda, 0.01, **kw)
    plain_cuda = tl.detect_label_compact_torch(*cuda, 0.01, **kw)
    plain_cpu = tl.detect_label_compact_torch(*cpu, 0.01, **kw)
    torch.cuda.synchronize()
    n_tracked = int((cpu[1][0] >= 0).sum())
    assert int(plain_cpu[4][0]) == n_tracked
    if w > k128:
        assert n_tracked > k128
    for g, want in zip(got, plain_cuda):
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))
    _assert_detect_equal(got, plain_cpu, packed)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("r,w,h", [(64, 32768, 64), (4, 1024, 7),
                                   (2, 1024, 2048)])
@pytest.mark.parametrize("labels", ["carried", "untracked", "past_h",
                                    "burst"])
def test_fused_label_kernel_matches_plain(dev, r, w, h, packed, labels):
    """K10 against its plain version (K6's gather then K9's chain) on the
    card and on the CPU, every output bit for bit: labels carried from
    three steps (about 10 % changed), all untracked (-1), a third past
    the table (frame rows of zeros), and a burst where every tracked
    particle moves outward (every inward one flips: counts of W / 3 and
    more); H = 2048 fills the table's 48 KB."""
    cpu, cuda, table = _label_planes(dev, r, w, min(h, 64), r + w + h,
                                     packed)
    rng = np.random.default_rng(r + w)
    if h > 64:
        extra = rng.normal(size=(h - 64, 6)).astype(np.float32)
        table = torch.cat([table, torch.from_numpy(extra)])
    lab = cpu[1].clone()
    if labels == "untracked":
        lab[:] = -1
    elif labels == "past_h":
        lab = torch.where(torch.rand(lab.shape, generator=torch.Generator(
        ).manual_seed(1)) < 0.3, torch.full_like(lab, h + 5), lab)
    elif labels == "burst":
        # each particle moves outward along the r-hat it carries (cos = 1)
        from orbitanalysis_tpu_torch.utils.numerics import oct_decode

        cen = table[lab.clamp(min=0).long(), :3].permute(2, 0, 1)
        prev = oct_decode(cpu[5]) if packed else cpu[5]
        cpu[2] = (cen + 3.0 * prev).contiguous()
        cpu[3] = (table[lab.clamp(min=0).long(), 3:].permute(2, 0, 1)
                  + prev).contiguous()
    cpu[1] = lab
    args = cpu[1:]
    kw = dict(pericentric=True, box_size=100.0, rhat_packed=packed)
    got = tl.fused_label_detect(table.to(dev), *(t.to(dev) for t in args),
                                0.01, **kw)
    plain_cuda = tl.fused_label_detect_torch(
        table.to(dev), *(t.to(dev) for t in args), 0.01, **kw)
    plain_cpu = tl.fused_label_detect_torch(table, *args, 0.01, **kw)
    torch.cuda.synchronize()
    if labels == "burst":
        assert int(plain_cpu[4].max()) > w // 4
    for want in (plain_cuda, plain_cpu):
        for g, v in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32),
                               v.cpu().view(torch.int32))


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("h", [4096, 12000])
def test_fused_label_kernel_large_tables(dev, h, packed):
    """K10 with labels spread over tables past the 2048 halos it once
    took: 4096 halos (98 KB) and 12,000 (288 KB, more than a block's
    shared memory could hold), every output bit for bit against the
    plain version on the card and on the CPU."""
    cpu, cuda, table = _label_planes(dev, 2, 1024, h, 11, packed)
    kw = dict(pericentric=True, box_size=100.0, rhat_packed=packed)
    got = tl.fused_label_detect(table.to(dev), *cuda[1:], 0.01, **kw)
    plain_cuda = tl.fused_label_detect_torch(table.to(dev), *cuda[1:], 0.01,
                                             **kw)
    plain_cpu = tl.fused_label_detect_torch(table, *cpu[1:], 0.01, **kw)
    torch.cuda.synchronize()
    assert int(plain_cpu[4].sum()) > 0
    for want in (plain_cuda, plain_cpu):
        for g, v in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32),
                               v.cpu().view(torch.int32))


def test_fused_label_kernel_counts_launches(dev):
    """K10 launches once a call, at any table the JAX package takes (past
    the 2048 halos of the default 48 KB too), and refuses a one-hot block
    past the JAX 32 MiB budget, as JAX does; its plain version launches
    nothing."""
    cpu, cuda, table = _label_planes(dev, 2, 1024, 7, 3, False)
    _cuda.reset_launch_counts()
    tl.fused_label_detect(table.to(dev), *cuda[1:], 0.0, pericentric=True,
                          box_size=None)
    tl.fused_label_detect_torch(table.to(dev), *cuda[1:], 0.0,
                                pericentric=True, box_size=None)
    tl.fused_label_detect(torch.zeros((2049, 6), device=dev), *cuda[1:],
                          0.0, pericentric=True, box_size=None)
    assert {n: c for n, c in _cuda.launch_counts().items() if c} == {
        "fused_label_rows": 2}
    with pytest.raises(ValueError, match="32 MiB"):
        tl.fused_label_detect(torch.zeros((16385, 6), device=dev),
                              *cuda[1:], 0.0, pericentric=True,
                              box_size=None)


@pytest.mark.parametrize("frames,k", [("split", 128), ("split", 2048),
                                      ("pallas2", 128), ("twolevel", 128),
                                      ("fused", 128), ("pallas", 128)])
def test_label_step_on_cuda_matches_cpu(dev, frames, k):
    """The label scan on the card (through K6-K9 and K4/K5) against the
    CPU scan, with the bulk velocities given: counts and positions
    exact, angles within one f16 ulp or 2e-3 rad."""
    from orbitanalysis_tpu_torch.models.synthetic import label_churn_workload

    lab, pos, vel, cen, _ = label_churn_workload(4, 4096, 6, seed=1)
    bulk = np.random.default_rng(0).normal(scale=0.01, size=(6, 4, 3))
    kw = dict(event_capacity=k, box_size=100.0, row_width=4096,
              frames=frames, rhat_packed=True, bulk_vel_seq=bulk)
    _cuda.reset_launch_counts()
    _, e_gpu = tls.scan_label_events(
        tls.init_label_carry(lab.shape[1], True, 4096), pos, vel, lab, cen,
        **kw)
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    _, e_cpu = tls.scan_label_events(
        tls.init_label_carry(lab.shape[1], True, 4096, device="cpu"), pos,
        vel, lab, cen, **kw)
    assert torch.equal(e_gpu.count.cpu(), e_cpu.count)
    assert torch.equal(e_gpu.index.cpu(), e_cpu.index)
    diff = (e_gpu.angle.cpu() - e_cpu.angle).abs()
    assert float(diff.max()) <= 2e-3
    assert int(e_cpu.count.sum()) > 0
    # 'split' compacts inside the detect pass when K fits the block
    # fronts of a 4096-wide row (32 blocks x 16), as the JAX step does
    blocked = min(-(-k // 128) * 128, 4096) <= (4096 // 128) * 16
    want = {"split": ({"frame_rows", "detect_label_compact_rows"} if blocked
                      else {"frame_rows", "detect_label_rows",
                            "compact_payload_rows"}),
            "pallas2": {"frame_rows", "compact_payload_rows"},
            "twolevel": {"compact_payload_rows"},
            "fused": {"fused_label_rows", "compact_payload_rows"},
            "pallas": {"frame_rows", "compact_payload_rows"}}[frames]
    assert {n for n, c in counts.items() if c} == want


@pytest.mark.parametrize("frames", ["fused", "pallas"])
def test_label_routes_estimate_bulk_on_cuda(dev, frames):
    """With the bulk velocities estimated on the card, 'fused' and
    'pallas' launch the moments kernel once a step and find the events
    'split' finds."""
    from orbitanalysis_tpu_torch.models.synthetic import label_churn_workload

    lab, pos, vel, cen, _ = label_churn_workload(4, 4096, 6, seed=2)
    kw = dict(event_capacity=128, box_size=100.0, row_width=4096,
              rhat_packed=True)
    _, e_split = tls.scan_label_events(
        tls.init_label_carry(lab.shape[1], True, 4096), pos, vel, lab, cen,
        frames="split", **kw)
    _cuda.reset_launch_counts()
    _, e = tls.scan_label_events(
        tls.init_label_carry(lab.shape[1], True, 4096), pos, vel, lab, cen,
        frames=frames, **kw)
    torch.cuda.synchronize()
    assert _cuda.launch_counts()["segment_moments"] == 6
    assert torch.equal(e.count, e_split.count) and int(e.count.sum()) > 0
    assert torch.equal(e.index, e_split.index)


# ----------------------------------------------------------------------
# the sorted engine's kernels (K15, K16, K18, K19) and its step
# ----------------------------------------------------------------------

def _keys(rng, h, p, n_valid, side, pool):
    """``[h, p]`` int32 bit patterns of uint32 keys ``(id << 1) | side``
    of ``n_valid[r]`` unique IDs from ``pool[r]``, ascending, then the
    padding sentinel ``0xFFFFFFFE | side``."""
    keys = np.full((h, p), np.uint32(0xFFFFFFFE) | np.uint32(side),
                   np.uint32)
    for r in range(h):
        ids = np.sort(rng.choice(pool[r], n_valid[r], replace=False))
        keys[r, :n_valid[r]] = (ids.astype(np.uint32) << np.uint32(1)) \
            | np.uint32(side)
    return keys


#: Merged positions (prev and cur entries) of one tile of K16
#: (``csrc/merge.cu`` kJoinTile) and lanes of one tile of K17
#: (``csrc/static.cu`` kTile): the row lengths of the tile-edge cases.
K16_TILE, K17_TILE = 1024, 2048


def _join_planes(rng, h, p, kind):
    """Prev (ascending) and cur (descending) planes of one join.
    ``kind``: 'churn' (half the cur IDs shared, padding on both sides),
    'static' (the same IDs, no padding), 'disjoint' (no ID shared),
    'big' (IDs near 2**31, so the keys' top bit is set), 'straddle'
    (every ID shared but one unmatched prev ID below them all and one
    cur ID above: each pair sits at merged positions (2m - 1, 2m), so the
    pairs at multiples of K16's tile straddle two tiles), 'clustered'
    (all prev IDs; the cur IDs, at most 64, a contiguous run in the
    middle, so every cur key falls inside one prev tile), 'padding'
    (the churn planes with the first row all padding on both sides)."""
    n_prev = rng.integers(p // 2, p + 1, h)
    n_cur = rng.integers(p // 2, p + 1, h)
    if kind in ("static", "straddle", "clustered"):
        n_prev = n_cur = np.full(h, p)
    base = (1 << 31) - 4 * p if kind == "big" else 0
    pools = [base + rng.permutation(3 * p) for _ in range(h)]
    if kind in ("straddle", "clustered"):
        pools = [np.arange(3 * p) for _ in range(h)]
    pk = _keys(rng, h, p, n_prev, 0, [q[:p] for q in pools])
    if kind == "static":
        ck = pk | np.uint32(1)
    elif kind == "disjoint":
        ck = _keys(rng, h, p, n_cur, 1, [q[p:] for q in pools])
    elif kind == "straddle":
        ck = np.concatenate([pk[:, 1:] | np.uint32(1),
                             np.full((h, 1), (2 * p + 5) << 1 | 1,
                                     np.uint32)], axis=1)
    elif kind == "clustered":
        n = min(64, p // 2)
        ck = _keys(rng, h, p, np.full(h, n), 1,
                   [np.arange(p // 2 - n // 2, p // 2 + n) for _ in range(h)])
    else:
        shared = [np.concatenate([(pk[r, :n_prev[r]] >> np.uint32(1))[
            : n_cur[r] // 2], q[p:2 * p]]) for r, q in enumerate(pools)]
        ck = _keys(rng, h, p, np.minimum(n_cur, p), 1, shared)
    if kind == "padding":
        pk[0] = 0xFFFFFFFE
        ck[0] = 0xFFFFFFFF
    ck = np.ascontiguousarray(ck[:, ::-1])

    def unit():
        v = rng.normal(size=(3, h, p)).astype(np.float32)
        return (v / np.linalg.norm(v, axis=0)).astype(np.float32)

    def sv():
        return (np.argsort(rng.random((h, p)), axis=1).astype(np.int32)
                | (rng.integers(0, 8, (h, p)).astype(np.int32) << 24))

    pr, cr = unit(), unit()
    prev = [_i32(pk), torch.from_numpy(sv()), *map(torch.from_numpy, pr),
            torch.from_numpy(rng.uniform(0, 9, (h, p)).astype(np.float32))]
    cur = [_i32(ck), torch.from_numpy(sv()), *map(torch.from_numpy, cr)]
    return prev, cur


#: Merged positions of one tile of K15 (``csrc/merge.cu`` kMergeTile).
K15_TILE = 1024


def _merge_planes(rng, h, p, kind, n_chan):
    """K15's ``n_chan`` prev and cur planes: ``_join_planes`` with the
    cur angles a zero plane, or for kind 'runs' keys drawn from seven
    values (the top bit set in four, the two sentinels among them), so
    that runs of equal keys on both sides cross many tiles and prev and
    cur keys tie."""
    prev, cur = _join_planes(rng, h, p, "churn" if kind == "runs" else kind)
    prev[5] = prev[5].view(torch.int32)
    cur.append(torch.zeros_like(prev[5]))
    if kind == "runs":
        vals = np.array([3, 4, 9, 2**31 - 1, 2**31, 0xFFFFFFFE, 0xFFFFFFFF],
                        np.uint32)
        pk = np.sort(rng.choice(vals, (h, p)), axis=1)
        ck = np.sort(rng.choice(vals, (h, p)), axis=1)[:, ::-1]
        prev[0], cur[0] = _i32(pk), _i32(ck)
    return prev[:n_chan], cur[:n_chan]


@pytest.mark.parametrize("h,p", [
    (64, 32768), (3, 128), (5, 4096),
    # rows of 2P = 1/4, 1/2, 1 and 2 of K15's tiles, the widest rows and
    # many short rows
    (2, K15_TILE // 8), (2, K15_TILE // 4), (2, K15_TILE // 2), (2, K15_TILE),
    (2, 1 << 17), (4096, 128)])
@pytest.mark.parametrize("kind", ["churn", "static", "disjoint", "big",
                                  "padding", "straddle", "clustered", "runs"])
@pytest.mark.parametrize("n_chan", [1, 6])
def test_merge_kernel_matches_plain(dev, h, p, kind, n_chan):
    """K15 equals the stable sort of the concatenation on every channel,
    on the card and on the CPU: the ties among padding sentinels
    included ('padding' has a first row of sentinels only, a run of P on
    each side that crosses several tiles from P = 1024 on), and any run
    of equal keys on either side, ties across the sides too ('runs')."""
    rng = np.random.default_rng(p + h)
    prev, cur = _merge_planes(rng, h, p, kind, n_chan)
    xp, xc = tuple(t.to(dev) for t in prev), tuple(t.to(dev) for t in cur)
    _poison(*[(h, 2 * p)] * n_chan)
    got = tm.merge_rows(xp, xc)
    plain_cuda = tm.merge_rows_torch(xp, xc)
    want = tm.merge_rows_torch(tuple(prev), tuple(cur))
    torch.cuda.synchronize()
    assert len(got) == n_chan
    if kind == "padding":
        assert bool((want[0][0] < 0).all())  # row 0: sentinels only
    for g, c, w in zip(got, plain_cuda, want):
        assert torch.equal(g.view(torch.int32), c.view(torch.int32))
        assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("h,p,k", [
    (64, 32768, 2048), (3, 128, 128), (5, 4096, 4096),
    # rows at and around K16's tile (P = K16_TILE / 2 fills one tile of
    # 2P merged positions), many short rows, the aligned engine's widest
    # row, and counts past k128 on rows of several tiles
    (2, K16_TILE // 4, 128), (2, K16_TILE // 2, 256), (2, K16_TILE, 128),
    (3, 2 * K16_TILE, 128), (4096, 128, 128), (1, 1 << 19, 2048)])
@pytest.mark.parametrize("kind", ["churn", "static", "disjoint", "big",
                                  "straddle", "clustered", "padding"])
@pytest.mark.parametrize("pericentric", [True, False])
def test_join_detect_kernel_matches_plain(dev, h, p, k, kind, pericentric):
    """K16 against its merged-domain plain version, on the CPU and on the
    card: every output bit for bit (both zero-fill past the counts)."""
    rng = np.random.default_rng(p + h + k)
    prev, cur = _join_planes(rng, h, p, kind)
    args = (pericentric, np.iinfo(np.int32).max, k)
    got = ts.fused_join_detect(tuple(t.to(dev) for t in prev),
                               tuple(t.to(dev) for t in cur), *args)
    plain_cuda = ts.fused_join_detect_torch(
        tuple(t.to(dev) for t in prev), tuple(t.to(dev) for t in cur), *args)
    plain_cpu = ts.fused_join_detect_torch(tuple(prev), tuple(cur), *args)
    torch.cuda.synchronize()
    if kind != "disjoint" and (kind, h) != ("padding", 1):
        assert int(plain_cpu[4].sum()) > 0
    if kind == "padding":
        assert int(plain_cpu[4][0]) == 0
    if kind in ("static", "straddle") and p >= 8 * k:
        assert int(plain_cpu[4].max()) > k
    for want in (plain_cuda, plain_cpu):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32),
                               w.cpu().view(torch.int32))


#: Words of one tile of K18 (``csrc/compact.cu`` kTileThreads * kEventVT).
K18_TILE = 2048


def _event_planes(rng, h, p, density):
    """K18's ``packed`` (bit 31 set at the events, f32 angle bits below),
    ``key`` (any uint32 word) and ``sv`` ``[h, p]`` planes at
    ``density``, with a run of events in row 0 and one across the first
    tile edge of the last row where the row has one."""
    sel = rng.random((h, p)) < density
    sel[0, 10:200] = True
    if p > K18_TILE:
        sel[-1, K18_TILE - 300:K18_TILE + 200] = True
    ang = rng.uniform(0, 7, (h, p)).astype(np.float32)
    packed = _i32(np.where(sel, ang.view(np.uint32) | np.uint32(1 << 31),
                           np.uint32(0)))
    key = _i32(rng.integers(0, 2**32, (h, p), dtype=np.uint64).astype(
        np.uint32))
    sv = torch.from_numpy(rng.integers(0, 2**31, (h, p)).astype(np.int32))
    return packed, key, sv, sel


@pytest.mark.parametrize("h,p,k", [
    (64, 32768, 2048), (3, 256, 256),
    # rows of 1/8 of a tile, one tile, one tile and a row of lanes (k128
    # equal to P), several tiles, and 4096 rows of one row of lanes
    (3, K18_TILE // 8, 128), (3, K18_TILE, 256),
    (3, K18_TILE + 128, K18_TILE + 128), (2, 5 * K18_TILE + 128, 1024),
    (4096, 128, 128)])
@pytest.mark.parametrize("density", [0.0, 0.017, 0.07, 0.5, 1.0])
def test_compact_events_kernel_matches_plain(dev, h, p, k, density):
    """K18 bit-equal to its plain version on the same CUDA tensors and on
    the CPU, outputs poisoned first (int32 outputs, as before); at
    density 1 the counts pass k128 on rows longer than k128, and where
    k128 is P every event is kept."""
    rng = np.random.default_rng(int(density * 100) + p + h)
    packed, key, sv, sel = _event_planes(rng, h, p, density)
    k128 = tc._k128(k, p)
    _poison((h, k128), (h, k128), (h, k128))
    x = (packed.to(dev), key.to(dev), sv.to(dev))
    got = tc.compact_events(*x, k)
    plain_cuda = tc.compact_events_torch(*x, k)
    want = tc.compact_events_torch(packed, key, sv, k)
    torch.cuda.synchronize()
    if density == 1.0 and p > k128:
        assert int(sel.sum(1).min()) > k128
    if k128 == p:
        assert int((got[2] != 0).sum()) == int(sel.sum())
    for g, c, w in zip(got, plain_cuda, want):
        assert g.dtype == torch.int32 and g.shape == (h, k128)
        assert torch.equal(g, c)
        assert torch.equal(g.cpu(), w)


#: Entries of one tile of K19 (``csrc/compact.cu`` kGroupTile).
K19_TILE = 2048


def _half_rows(rng, h, n):
    """``[h, n]`` 0/1 rows with exactly ``n // 2`` ones each, as the
    unfused sorted route's group a (the cur half of a merged row), with
    a run of ones across the second tile edge where the row has one."""
    sel = np.zeros((h, n), np.int32)
    for r in range(h):
        if n > 2 * K19_TILE:
            sel[r, 2 * K19_TILE - 100:2 * K19_TILE + 100] = 1
        free = np.flatnonzero(sel[r] == 0)
        sel[r, rng.choice(free, n // 2 - int(sel[r].sum()),
                          replace=False)] = 1
    return sel


@pytest.mark.parametrize("h,n,len_b", [
    (64, 65536, 2048), (3, 256, 128),
    # rows of 1/4, 1 and 2 tiles, two tiles and two rows of lanes more
    # (so that half a row is a multiple of 128), and many short rows
    (3, K19_TILE // 4, 128), (3, K19_TILE, 128), (3, 2 * K19_TILE, 256),
    (3, 2 * K19_TILE + 256, 256), (4096, 128, 128)])
@pytest.mark.parametrize("n_a", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 1.0])
@pytest.mark.parametrize("group_a", ["random", "half", "short"])
def test_compact_rows_kernel_matches_plain(dev, h, n, len_b, n_a, density,
                                           group_a):
    """K19 bit-equal to the plain version on the same CUDA tensors and on
    the CPU, outputs poisoned first, float and int channels.  Group a
    selects about half of a row ('random', output n / 2), exactly half
    ('half': the unfused route's full output) or about half into an
    output of n / 4 ('short': its length below the count), outputs at
    least 128 long; group b at
    ``density``, with a burst across a tile edge and, at density 1, more
    entries than its output holds."""
    rng = np.random.default_rng(n + n_a + int(density * 100))
    if group_a == "half":
        sel_a = torch.from_numpy(_half_rows(rng, h, n))
    else:
        sel_a = torch.from_numpy((rng.random((h, n)) < 0.5).astype(np.int32))
    len_a = max(128, (n // 4 if group_a == "short" else n // 2) // 128 * 128)
    sel_b = torch.from_numpy((rng.random((h, n)) < density).astype(np.int32))
    if group_a != "random" and n > K19_TILE:
        sel_b[0, K19_TILE - 40:K19_TILE + 40] = 1
    ops_a = tuple(torch.from_numpy(rng.normal(size=(h, n)).astype(np.float32))
                  if c % 2 else torch.from_numpy(
                      rng.integers(0, 2**31, (h, n)).astype(np.int32))
                  for c in range(n_a))
    ops_b = (torch.from_numpy(rng.integers(0, 2**31, (h, n)).astype(np.int32)),
             torch.from_numpy(rng.integers(0, 2**24, (h, n)).astype(np.int32)),
             torch.from_numpy(rng.uniform(0, 7, (h, n)).astype(np.float32)))
    if group_a != "random":
        _poison(*[(h, len_a)] * n_a, *[(h, len_b)] * 3)
    args = (sel_a.to(dev), tuple(t.to(dev) for t in ops_a), len_a,
            sel_b.to(dev), tuple(t.to(dev) for t in ops_b), len_b)
    got = tc.compact_rows(*args)
    plain_cuda = tc.compact_rows_torch(*args)
    want = tc.compact_rows_torch(sel_a, ops_a, len_a, sel_b, ops_b, len_b)
    torch.cuda.synchronize()
    if group_a == "half" and n >= 256:
        assert bool((sel_a.sum(1) == len_a).all())
    if group_a == "short" and n >= K19_TILE:
        assert int(sel_a.sum(1).min()) > len_a
    for gs, cs_, ws in zip(got, plain_cuda, want):
        for g, c, w in zip(gs, cs_, ws):
            assert g.dtype == w.dtype
            assert torch.equal(g.view(torch.int32), c.view(torch.int32))
            assert torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))


def _bench_batches(h, c, s, static=False):
    from orbitanalysis_tpu_torch.models.synthetic import (
        churn_workload,
        static_workload,
    )
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch

    make = static_workload if static else churn_workload
    ids, pos, vel, cen, _ = make(h, c, s, seed=2)
    return tss.presort_snapshot(
        SnapshotBatch(ids=ids, pos=pos, vel=vel, center=cen), soa=True)


@pytest.mark.parametrize("kw", [
    dict(fused=True), dict(merge_impl="pallas", compact_impl="pallas"),
    dict(merge_impl="pallas", compact_impl="lax_sort"),
    dict(merge_impl="lax_sort", compact_impl="pallas")])
@pytest.mark.parametrize("static", [False, True])
def test_sorted_scan_on_cuda_matches_cpu(dev, kw, static):
    """The sorted scan on the card (through K15/K16/K18/K19) against the
    CPU scan: counts and event IDs exact, angles within one f16 ulp or
    2e-3 rad; the kernels on the path each launched."""
    from orbitanalysis_tpu_torch.engine.scan import scan_events_sorted

    staged = _bench_batches(4, 4096, 5, static)
    args = dict(box_size=100.0, cur_presorted=True, soa_batch=True, **kw)
    _cuda.reset_launch_counts()
    c_gpu, ev_gpu = scan_events_sorted(
        tss.init_sorted_carry(4, 4096, device=dev), staged, 512, **args)
    torch.cuda.synchronize()
    counts = _cuda.launch_counts()
    c_cpu, ev_cpu = scan_events_sorted(
        tss.init_sorted_carry(4, 4096, device="cpu"), staged, 512, **args)
    cnt = ev_cpu[0]
    assert torch.equal(ev_gpu[0].cpu(), cnt) and int(cnt.sum()) > 0
    sel = torch.arange(ev_cpu[1].shape[-1])[None, None, :] < cnt[..., None]
    assert torch.equal(ev_gpu[1].cpu()[sel], ev_cpu[1][sel])
    assert float((ev_gpu[2].cpu() - ev_cpu[2]).abs().max()) <= 2e-3
    assert torch.equal(c_gpu.ids.cpu(), c_cpu.ids)
    if kw.get("fused"):
        want = ({"fused_join_detect": 1, "compact_events_rows": 4} if static
                else {"fused_join_detect": 5})
    else:
        want = {}
        if kw["merge_impl"] == "pallas":
            want["merge_rows"] = 5
        if kw["compact_impl"] == "pallas":
            want["compact_rows_groups"] = 5
    assert {n: c for n, c in counts.items() if c} == want


def test_sorted_tracker_on_cuda_matches_cpu(dev):
    """track_orbits(join_impl='sorted') on the card launches K16 or K18
    every step and writes the catalog the CPU run writes."""
    args = _setup()
    _cuda.reset_launch_counts()
    m = Metrics()
    w_gpu, w_cpu = MemoryWriter(), MemoryWriter()
    track_orbits(*args, "run.h5", verbose=False, metrics=m, writer=w_gpu,
                 join_impl="sorted")
    counts = _cuda.launch_counts()
    assert {r["join"] for r in m.records} == {"sorted"}
    assert (counts["fused_join_detect"] + counts["compact_events_rows"]
            == len(m.records) + 1)
    track_orbits(*args, "run.h5", verbose=False, device="cpu",
                 join_impl="sorted", writer=w_cpu)
    a, b = w_gpu.files["run.h5"], w_cpu.files["run.h5"]
    assert sorted(a) == sorted(b)
    for g in a:
        if g == "attrs":
            continue
        for ds in a[g]:
            if ds == "angles":
                np.testing.assert_allclose(a[g][ds].astype(np.float32),
                                           b[g][ds].astype(np.float32),
                                           atol=4e-3)
            elif ds == "bulk_velocities":
                np.testing.assert_allclose(a[g][ds], b[g][ds], rtol=2e-6,
                                           atol=1e-6)
            else:
                np.testing.assert_array_equal(a[g][ds], b[g][ds])


# ----------------------------------------------------------------------
# the aligned detect kernel (K17) and the aligned steps that run it
# ----------------------------------------------------------------------

def _static_planes(rng, h, p, native, density, kind):
    """Aligned prev/cur planes of one K17 call: ``density`` of the valid
    lanes flip (pericentric), FRESH on ~5 % of lanes (cur sv bit 27 when
    native, else prev sv), ``kind`` 'pad' puts the padding sentinel key
    on ~20 % of lanes, 'padding' does so too and pads the whole first
    row, and 'big' uses IDs near 2**31 (keys with their top bit set); a
    third of the r-hat lanes repeat the prev vector (cos = 1)."""
    inv = np.iinfo(np.int32).max
    base = 2**31 - 4 * p * h if kind == "big" else 0
    ids = (base + rng.permutation(2 * p * h)[:h * p]).reshape(h, p)
    if kind in ("pad", "padding"):
        ids = np.where(rng.random((h, p)) < 0.2, inv, ids)
    if kind == "padding":
        ids[0] = inv
    ck = ((ids.astype(np.uint64) << 1) | 1).astype(np.uint32)
    flip = rng.random((h, p)) < density
    vp = np.where(flip, 1, rng.integers(0, 4, (h, p)))
    vc = np.where(flip, 2, rng.integers(0, 2, (h, p)))
    slots = np.argsort(rng.random((h, p)), axis=1).astype(np.int32)
    psv = slots | (vp.astype(np.int32) << 24)
    csv = slots | (vc.astype(np.int32) << 24)
    fresh = (rng.random((h, p)) < 0.05).astype(np.int32) << 27
    if native:
        csv |= fresh
    else:
        psv |= fresh

    def unit():
        v = rng.normal(size=(3, h, p)).astype(np.float32)
        return (v / np.linalg.norm(v, axis=0)).astype(np.float32)

    prh, crh = unit(), unit()
    same = rng.random((h, p)) < 0.33
    crh = np.where(same[None], prh, crh)
    ang = rng.uniform(0, 9, (h, p)).astype(np.float32)
    pang = (_i32(ang.view(np.uint32) | (rng.integers(0, 2, (h, p)).astype(
        np.uint32) << np.uint32(31))) if native
        else torch.from_numpy(ang))
    prev = [_i32((ids.astype(np.uint64) << 1).astype(np.uint32)),
            torch.from_numpy(psv), *map(torch.from_numpy, prh), pang]
    cur = [_i32(ck), torch.from_numpy(csv), *map(torch.from_numpy, crh)]
    return prev, cur


@pytest.mark.parametrize("h,p,k", [
    (64, 32768, 2048), (3, 256, 128), (5, 4096, 128),
    # rows at and around K17's tile, many short rows and the aligned
    # engine's widest row (MAX_ALIGNED_CAPACITY)
    (2, K17_TILE // 2, 128), (2, K17_TILE, 128), (3, 2 * K17_TILE, 256),
    (4096, 128, 128), (1, 1 << 19, 2048)])
@pytest.mark.parametrize("density", [0.0, 0.017, 0.5, 1.0])
@pytest.mark.parametrize("kind", ["pad", "big", "padding"])
@pytest.mark.parametrize("native", [True, False])
def test_static_detect_kernel_matches_plain(dev, h, p, k, density, kind,
                                            native):
    """K17 against its plain version on the card and on the CPU, every
    output bit for bit (both zero-fill past the counts), counts past
    k128 included."""
    rng = np.random.default_rng(p + h + int(density * 100) + native)
    prev, cur = _static_planes(rng, h, p, native, density, kind)
    args = (True, np.iinfo(np.int32).max, k)
    got = ts.fused_static_detect(tuple(t.to(dev) for t in prev),
                                 tuple(t.to(dev) for t in cur), *args,
                                 native=native)
    plain_cuda = ts.fused_static_detect_torch(
        tuple(t.to(dev) for t in prev), tuple(t.to(dev) for t in cur), *args,
        native=native)
    plain_cpu = ts.fused_static_detect_torch(tuple(prev), tuple(cur), *args,
                                             native=native)
    torch.cuda.synchronize()
    if density == 1.0 and p > k and (kind, h) != ("padding", 1):
        assert int(plain_cpu[4].max()) > k
    if kind == "padding":
        assert int(plain_cpu[4][0]) == 0
    for want in (plain_cuda, plain_cpu):
        for g, w in zip(got, want):
            assert torch.equal(g.cpu().view(torch.int32),
                               w.cpu().view(torch.int32))


def _stream_calls(dev, rng, which):
    """Two calls of one kernel on two inputs with a row whose events
    exceed the capacity k (K16, K17 and K4 at density 0.5 and the 'big'
    keys, K8 on two carries with a burst row, K1 on angle words with a
    burst row), the kernel's counter name, and a check that a call's
    result holds such a row; for K15, two six-channel merges whose first
    row is padding only (runs of sentinels across several tiles) and a
    check that the merged row holds them."""
    h, k, invalid = 8, 256, np.iinfo(np.int32).max
    calls = []
    if which == "K1":
        for density in (0.5, 0.03):
            aw = _angle_words(rng, h, 8 * K1_TILE, density)
            aw[0, 3 * K1_TILE - 300:3 * K1_TILE + 200] |= np.uint32(1 << 31)
            x = _i32(aw).to(dev)
            calls.append(lambda x=x: (tc.compact_angle_blocked(x, k),))
        return calls, "compact_angle_rows", k, lambda out: bool(
            (out[0][0] != 0).all())
    if which == "K3":
        for density in (0.5, 0.03):
            posw, angw, _ = _pair_planes(rng, 2, 1 << 18, density)
            x = (posw.to(dev), angw.to(dev))
            calls.append(lambda x=x: tc.compact_payload_pair(*x, k))
        return calls, "compact_pair_rows", k, lambda out: bool(
            (out[0][0] != 0).all())
    if which == "K18":
        for density in (0.5, 0.03):
            packed, key, sv, _ = _event_planes(rng, h, 8 * K18_TILE, density)
            x = (packed.to(dev), key.to(dev), sv.to(dev))
            calls.append(lambda x=x: tc.compact_events(*x, k))
        return calls, "compact_events_rows", k, lambda out: bool(
            (out[2][0] != 0).all())
    if which == "K19":
        for n_a in (6, 1):
            n = 8 * K19_TILE
            sel_a = torch.from_numpy(_half_rows(rng, h, n)).to(dev)
            sel_b = torch.from_numpy(
                (rng.random((h, n)) < 0.02).astype(np.int32)).to(dev)
            sel_b[0, :2 * k] = 1
            ops = tuple(torch.from_numpy(rng.integers(
                0, 2**31, (h, n)).astype(np.int32)).to(dev)
                for _ in range(n_a + 3))
            x = (sel_a, ops[:n_a], n // 2, sel_b, ops[n_a:], k)
            calls.append(lambda x=x: sum(tc.compact_rows(*x), ()))
        return calls, "compact_rows_groups", k, lambda out: bool(
            (out[-1][0] != 0).all())
    if which == "K15":
        for seed in (1, 2):
            prev, cur = _merge_planes(np.random.default_rng(seed), h,
                                      4 * K15_TILE, "padding", 6)
            x = (tuple(t.to(dev) for t in prev), tuple(t.to(dev) for t in cur))
            calls.append(lambda x=x: tm.merge_rows(*x))
        return calls, "merge_rows", k, lambda out: bool(
            (out[0][0] < 0).all())
    if which == "K4":
        for density in (0.5, 0.03):
            x = _payload_plane(rng, h, 8 * K4_TILE, density, 3 * K4_TILE).to(
                dev)
            calls.append(lambda x=x: (tc.compact_payload(x, k),))
        return calls, "compact_payload_rows", k, lambda out: bool(
            (out[0][0] != 0).all())
    if which == "K8":
        for packed in (True, False):
            cpu, _, _ = _label_planes("cpu", h, 8 * K8_TILE, 16,
                                      int(rng.integers(1 << 16)), packed)
            _burst_row(cpu, True)
            x = [t.to(dev) for t in cpu]
            calls.append(lambda x=x, packed=packed: tl.detect_label_compact(
                *x, 0.01, pericentric=True, box_size=100.0,
                rhat_packed=packed, event_capacity=k))
        return calls, "detect_label_compact_rows", k, lambda out: int(
            out[4].max()) > k
    p = 8 * K16_TILE
    for kind in ("churn", "big"):
        if which == "K16":
            prev, cur = _join_planes(rng, h, p, kind)
        else:
            prev, cur = _static_planes(rng, h, p, True, 0.5,
                                       "pad" if kind == "churn" else kind)
        x = (tuple(t.to(dev) for t in prev), tuple(t.to(dev) for t in cur))
        if which == "K16":
            calls.append(lambda x=x: ts.fused_join_detect(*x, True, invalid,
                                                          k))
        else:
            calls.append(lambda x=x: ts.fused_static_detect(
                *x, True, invalid, k, native=True))
    name = "fused_join_detect" if which == "K16" else "static_detect_rows"
    return calls, name, k, lambda out: int(out[4].max()) > k


@pytest.mark.parametrize("which", ["K16", "K17", "K4", "K8", "K1", "K15",
                                   "K3", "K18", "K19"])
def test_detect_kernels_streams_and_repeats(dev, which):
    """K16, K17, K4, K8, K1, K15, K3, K18 and K19 issued at once on two CUDA
    streams give what they give one after the other, two calls give the
    same bits, and each call is one counted launch (each call's look-back
    scratch is its own; K15 has none)."""
    rng = np.random.default_rng(8)
    calls, name, k, overflows = _stream_calls(dev, rng, which)
    _cuda.reset_launch_counts()
    serial = [c() for c in calls]
    again = [c() for c in calls]
    torch.cuda.synchronize()
    assert _cuda.launch_counts()[name] == 4
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    concurrent = [None, None]
    for _ in range(3):
        for i, (st, c) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(st):
                concurrent[i] = c()
        torch.cuda.synchronize()
        for outs in (again, concurrent):
            for got, want in zip(outs, serial):
                for g, w in zip(got, want):
                    assert torch.equal(g.view(torch.int32),
                                       w.view(torch.int32))
    assert all(overflows(out) for out in serial)


def _aligned_batches(h, c, s, static=False):
    """The bench's ID-form sequence staged in the stable layout, one
    SnapshotBatch of NumPy arrays a snapshot."""
    from orbitanalysis_tpu_torch.engine.packing import (
        StableLayout,
        align_packed,
    )
    from orbitanalysis_tpu_torch.models.synthetic import (
        churn_workload,
        static_workload,
    )
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch

    make = static_workload if static else churn_workload
    ids, pos, vel, cen, _ = make(h, c, s, seed=2)
    lay = StableLayout(h, c)
    out = []
    for i in range(s):
        a_ids, a_pos, a_vel, _, slot = align_packed(lay, ids[i], pos[i],
                                                    vel[i])
        out.append(SnapshotBatch(ids=a_ids, pos=a_pos, vel=a_vel,
                                 center=cen[i], slot=slot))
    return out


def _on(batch, d):
    return batch._replace(**{f: torch.from_numpy(np.ascontiguousarray(
        getattr(batch, f))).to(d) for f in ("ids", "pos", "vel", "center",
                                            "slot")})


@pytest.mark.parametrize("static", [False, True])
def test_aligned_steps_on_cuda_match_cpu(dev, static):
    """The aligned step with detect_impl='pallas' and the legacy step on
    the card (K17 once a step) against the same steps on the CPU, and
    against the default step's events: counts and positions (IDs for the
    legacy step) exact, angles within one f16 ulp or 2e-3 rad."""
    batches = _aligned_batches(4, 4096, 5, static)
    steps = dict(
        xla=(tss.make_aligned_native_step(512, box_size=100.0),
             lambda d: tss.init_aligned_carry(4, 4096, device=d)),
        pallas=(tss.make_aligned_native_step(512, box_size=100.0,
                                             detect_impl="pallas"),
                lambda d: tss.init_aligned_carry(4, 4096, device=d)),
        legacy=(tss.make_aligned_orbit_step(512, box_size=100.0),
                lambda d: tss.init_sorted_carry(4, 4096, device=d)))
    events = {}
    for name, (step, init) in steps.items():
        for d in (dev, "cpu"):
            _cuda.reset_launch_counts()
            carry, evs = init(d), []
            for b in batches:
                carry, ev = step(carry, _on(b, d))
                evs.append(ev)
            torch.cuda.synchronize()
            if d == dev:
                want = 0 if name == "xla" else len(batches)
                assert _cuda.launch_counts()["static_detect_rows"] == want
            events[name, str(d)] = evs
    total = 0
    for i, b in enumerate(batches):
        x = events["xla", "cpu"][i]
        cnt = x.count
        total += int(cnt.sum())
        sel = torch.arange(512)[None, :] < cnt[:, None]
        pos_ids = torch.from_numpy(b.ids).gather(
            1, torch.where(sel, x.ids, 0).long())
        for key in events:
            e = events[key][i]
            assert torch.equal(e.count.cpu(), cnt)
            want = pos_ids if key[0] == "legacy" else x.ids
            assert torch.equal(e.ids.cpu()[sel], want[sel])
            a = e.angles.cpu()[sel]
            ulp = (a.to(torch.float16).view(torch.int16).int()
                   - x.angles[sel].to(torch.float16).view(torch.int16).int())
            assert bool(((ulp.abs() <= 1) | ((a - x.angles[sel]).abs()
                                             <= 2e-3)).all())
    assert total > 0


@pytest.mark.parametrize("p,soa", [(4096, True), (4096, False),
                                   (1 << 17, True)])
def test_aligned_scan_batched_on_cuda(dev, p, soa):
    """``scan_events_aligned(batched=True)`` on the card (one payload
    compaction over all S*H rows; the pair compaction for rows past
    PAYLOAD_MAX_ROW) against ``batched=False`` on the card (the fused
    frame-and-detect pass and its moments, then the angle-word
    compaction, or the pair compaction, once a step) and the
    batched driver on the CPU: counts and positions exact, angles within
    one f16 ulp, the final carries' keys and slots equal."""
    from orbitanalysis_tpu_torch.engine.packing import stage_batch_aligned
    from orbitanalysis_tpu_torch.engine.scan import scan_events_aligned
    from orbitanalysis_tpu_torch.models.synthetic import churn_workload
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch

    h, s_n, k = (4, 6, 512) if p == 4096 else (1, 3, 4096)
    ids, pos, vel, cen, _ = churn_workload(h, p, s_n, seed=3)
    staged = stage_batch_aligned(SnapshotBatch(
        ids=ids, pos=pos, vel=vel, center=cen), soa=soa)
    kw = dict(box_size=100.0, soa_batch=soa)
    runs = {}
    for d, batched in ((dev, True), (dev, False), ("cpu", True)):
        _cuda.reset_launch_counts()
        runs[str(d), batched] = scan_events_aligned(
            tss.init_aligned_carry(h, p, device=d), staged, k,
            batched=batched, **kw)
        torch.cuda.synchronize()
        if d == dev:
            name = ("compact_payload_rows" if p <= tc.PAYLOAD_MAX_ROW
                    else "compact_pair_rows")
            if batched or p > tc.PAYLOAD_MAX_ROW:
                want = {name: 1 if batched else s_n}
            else:
                want = {"compact_angle_rows": s_n}
            if not batched:
                # the per-step route's fused frame-and-detect pass, with
                # its moments (no catalog bulk velocities here)
                want.update(aligned_moments=s_n, aligned_frame_detect=s_n)
            assert {n: c for n, c in _cuda.launch_counts().items()
                    if c} == want
    carry, (cnt, ids_b, ang) = runs[str(dev), True]
    assert int(cnt.sum()) > 0
    for key in ((str(dev), False), ("cpu", True)):
        c2, (cnt2, ids2, ang2) = runs[key]
        assert torch.equal(cnt2.cpu(), cnt.cpu())
        assert torch.equal(ids2.cpu(), ids_b.cpu())
        ulp = (ang2.cpu().to(torch.float16).view(torch.int16).int()
               - ang.cpu().to(torch.float16).view(torch.int16).int())
        assert int(ulp.abs().max()) <= 1
        for f in ("key", "sv"):
            assert torch.equal(getattr(c2, f).cpu(), getattr(carry, f).cpu())


# ---------------------------------------------------------------- K13, K14

def _rel(a1, a2):
    """The JAX test's force measure: max |a1 - a2| / (|a2| + 1e-3)."""
    a1, a2 = a1.double().cpu(), a2.double().cpu()
    return float(((a1 - a2).abs()
                  / (a2.norm(dim=1, keepdim=True) + 1e-3)).max())


@pytest.mark.parametrize("n", [1, 127, 128, 1000, 4099, 16384])
@pytest.mark.parametrize("box", [None, 10.0])
def test_direct_forces_kernel_matches_twin(dev, n, box):
    """K14 against its plain version on the card and on the CPU; a second
    call on the same inputs gives the same bits (the source chunks'
    partial sums are added in a fixed order, no atomics), and each call
    counts one launch, whatever its passes."""
    from orbitanalysis_tpu_torch.ops import nbody as tn

    rng = np.random.default_rng(n)
    pos = (rng.uniform(0, 10.0, (n, 3)) if box else rng.normal(size=(n, 3))
           ).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mass[::7] = 0.0                                   # zero-mass sources
    p, m = torch.from_numpy(pos), torch.from_numpy(mass)
    _cuda.reset_launch_counts()
    got = tn.direct_forces_blocked(p.to(dev), m.to(dev), softening=0.1,
                                   G=1.5, box_size=box)
    again = tn.direct_forces_blocked(p.to(dev), m.to(dev), softening=0.1,
                                     G=1.5, box_size=box)
    torch.cuda.synchronize()
    assert got.shape == (n, 3) and got.is_cuda
    assert torch.equal(got, again)
    assert _cuda.launch_counts()["direct_forces"] == 2
    assert _rel(got, tn.direct_forces_blocked_torch(
        p.to(dev), m.to(dev), 0.1, 1.5, box)) < 1e-3
    assert _rel(got, tn.direct_forces_blocked_torch(p, m, 0.1, 1.5,
                                                    box)) < 1e-3


def _split_sides(dev):
    """The largest N that K14 splits over source chunks on this card,
    and the next N, which it does not."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n = _cuda.K14_BLOCKS_PER_SM * n_sm * _cuda.K14_BLOCK_TARGETS
    n -= _cuda.K14_BLOCK_TARGETS
    assert _cuda.direct_force_split(n, n_sm)[0] > 1
    assert _cuda.direct_force_split(n + 1, n_sm)[0] == 1
    return n, n + 1


@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("box", [None, 10.0])
def test_direct_forces_kernel_split_threshold(dev, side, box):
    """K14 on both sides of its source-split threshold (the last N that
    splits the sources over blocks, and the first that does not) against
    its plain version on the card, free and periodic."""
    from orbitanalysis_tpu_torch.ops import nbody as tn

    n = _split_sides(dev)[side]
    rng = np.random.default_rng(side)
    pos = (rng.uniform(0, 10.0, (n, 3)) if box else rng.normal(size=(n, 3))
           ).astype(np.float32)
    p = torch.from_numpy(pos).to(dev)
    m = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)).to(dev)
    got = tn.direct_forces_blocked(p, m, softening=0.1, box_size=box)
    want = tn.direct_forces_blocked_torch(p, m, 0.1, 1.0, box)
    torch.cuda.synchronize()
    assert _rel(got, want) < 1e-3


@pytest.mark.parametrize("box", [None, 10.0])
def test_direct_forces_kernel_unsoftened(dev, box):
    """K14 without softening (the kernel's clamped path: r^2 at least
    1e-18) against its plain version, coincident particles included
    (their pair adds nothing)."""
    from orbitanalysis_tpu_torch.ops import nbody as tn

    rng = np.random.default_rng(9)
    pos = rng.uniform(0, 10.0, (3000, 3)).astype(np.float32)
    pos[1:40:2] = pos[0:40:2]                      # 20 coincident pairs
    p = torch.from_numpy(pos)
    m = torch.from_numpy(rng.uniform(0.5, 2.0, 3000).astype(np.float32))
    got = tn.direct_forces_blocked(p.to(dev), m.to(dev), softening=0.0,
                                   box_size=box)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel(got, tn.direct_forces_blocked_torch(
        p.to(dev), m.to(dev), 0.0, 1.0, box)) < 1e-3
    assert _rel(got, tn.direct_forces_blocked_torch(p, m, 0.0, 1.0,
                                                    box)) < 1e-3


def test_direct_forces_kernel_refuses_bad_inputs_and_counts(dev):
    from orbitanalysis_tpu_torch.models import nbody as tnb
    from orbitanalysis_tpu_torch.ops import nbody as tn

    _cuda.reset_launch_counts()
    pos = torch.randn(300, 3, device=dev)
    mass = torch.ones(300, device=dev)
    tn.direct_forces_blocked(pos, mass)
    tnb.make_direct_force_fn(use_pallas=True)(pos, mass, box_size=5.0)
    tn.direct_forces_blocked_torch(pos, mass)         # the twin: not counted
    assert _cuda.launch_counts()["direct_forces"] == 2
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.direct_forces(pos.cpu(), mass.cpu(), 0.1, 1.0, None)
    with pytest.raises(ValueError, match="float32"):
        _cuda.direct_forces(pos.double(), mass, 0.1, 1.0, None)
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.direct_forces(torch.randn(3, 300, device=dev).T, mass, 0.1,
                            1.0, None)
    with pytest.raises(ValueError, match="mass"):
        _cuda.direct_forces(pos, mass[:10], 0.1, 1.0, None)


def test_gram_forces_refuse_tf32(dev):
    from orbitanalysis_tpu_torch.models import nbody as tnb

    pos = torch.randn(64, 3, device=dev)
    assert not torch.backends.cuda.matmul.allow_tf32
    tnb.direct_forces(pos, torch.ones(64, device=dev))
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            tnb.direct_forces(pos, torch.ones(64, device=dev))
    finally:
        torch.set_float32_matmul_precision(old)


def _stream(rng, n, grid, box, clustered=False):
    from orbitanalysis_tpu_torch.ops import deposit as td

    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    if clustered and n:
        pos[: n // 3] = rng.uniform(0.2 * box, 0.3 * box, (n // 3, 3))
    pos[:2] = np.array([[0.0, 0.0, 0.0], [box, box, box]])[:n]
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return td.sorted_stream(torch.from_numpy(pos), torch.from_numpy(mass),
                            grid, box), pos, mass


@pytest.mark.parametrize("n", [0, 1, 1000, 50000])
@pytest.mark.parametrize("grid", [8, 16, 33])
@pytest.mark.parametrize("clustered", [False, True])
def test_deposit_kernel_matches_twin(dev, n, grid, clustered):
    """K13 equals its plain version bit for bit, on the card and on the
    CPU (the same adds in the same order), runs of equal keys included."""
    from orbitanalysis_tpu_torch.ops import deposit as td

    rng = np.random.default_rng(n + grid)
    (keys, fracs), _, _ = _stream(rng, n, grid, 10.0, clustered)
    got = td.deposit_stream(keys.to(dev), fracs.to(dev), grid)
    want_dev = td.deposit_stream_torch(keys.to(dev), fracs.to(dev), grid)
    want_cpu = td.deposit_stream_torch(keys, fracs, grid)
    torch.cuda.synchronize()
    assert got.shape == ((grid + 1) ** 3,)
    assert torch.equal(got, want_dev)
    assert torch.equal(got.cpu(), want_cpu)


def _edge_stream(rng, grid, case):
    """A sorted stream ``(keys [N] int32, fracs [4, N] f32)`` on the
    virtual ``(grid+1)^3`` grid that K13's row design must get right:

    - ``one_cell``: 5,000 entries in one cell, in a uniform stream, so a
      run crosses many 256-entry tiles;
    - ``chunk_edges``: clustered runs in the rows of cells around each
      16-row block edge, and keys on the last cell of those rows (the
      cell a row's key range shares with the next row);
    - ``empty_rows``: entries in a few x-planes only, most rows empty;
    - ``faces``: keys in the bx = 0, by = 0 and == G faces (raw keys,
      the kernel's contract; the base cells of real particles stop at
      G - 1), with keys below 0 and past the grid, which deposit
      nothing."""
    g1 = grid + 1
    sx, sy = g1 * g1, g1
    v = g1 ** 3
    if case == "one_cell":
        keys = rng.integers(0, v, 3000)
        hot = (grid // 2) * (sx + sy + 1)
        keys = np.concatenate([keys, np.full(5000, hot)])
    elif case == "chunk_edges":
        rows = [r for e in range(16, g1 * g1, 16) for r in (e - 1, e)]
        rows = np.array(rows[:40])
        keys = np.concatenate([
            np.repeat(rows * sy + rng.integers(0, grid, rows.size), 40),
            rows * sy + grid, rows * sy - 1, rng.integers(0, v, 2000)])
    elif case == "empty_rows":
        bx = rng.choice([0, grid // 2, grid - 1], 4000)
        keys = (bx * sx + rng.integers(0, grid, 4000) * sy
                + rng.integers(0, grid, 4000))
    else:
        ax = rng.integers(0, g1, (3, 3000))
        ax[0, :1000] = 0
        ax[1, 1000:2000] = 0
        ax[:, 2000:2500] = grid
        keys = np.concatenate([ax[0] * sx + ax[1] * sy + ax[2],
                               [-3, -1, v, v + 5]])
    keys = np.sort(keys).astype(np.int32)
    fracs = rng.uniform(0, 1, (4, keys.size)).astype(np.float32)
    fracs[3] = rng.uniform(0.5, 2.0, keys.size)
    return torch.from_numpy(keys), torch.from_numpy(fracs)


@pytest.mark.parametrize("case", ["one_cell", "chunk_edges", "empty_rows",
                                  "faces"])
@pytest.mark.parametrize("grid", [8, 33, 129])
def test_deposit_kernel_edge_streams(dev, grid, case):
    """K13 bit for bit against its plain version, on the card and on the
    CPU, on the streams of :func:`_edge_stream`; two calls give equal
    bits."""
    from orbitanalysis_tpu_torch.ops import deposit as td

    keys, fracs = _edge_stream(np.random.default_rng(grid), grid, case)
    got = td.deposit_stream(keys.to(dev), fracs.to(dev), grid)
    again = td.deposit_stream(keys.to(dev), fracs.to(dev), grid)
    want_dev = td.deposit_stream_torch(keys.to(dev), fracs.to(dev), grid)
    want_cpu = td.deposit_stream_torch(keys, fracs, grid)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, want_dev)
    assert torch.equal(got.cpu(), want_cpu)


def test_sorted_deposit_cuda_equals_cpu(dev):
    """The whole sorted deposit (stream, kernel, fold) and its slab form
    on the card equal the CPU's bit for bit (IEEE cell index), and mass
    is conserved."""
    from orbitanalysis_tpu_torch.ops import deposit as td

    rng = np.random.default_rng(5)
    n, grid, box = 200000, 32, 10.0
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    h = box / grid
    pos[:4] = [[h, h, h], [h / 2, 2 * h, 3 * h], [box - h / 2, 0, 0],
               [box, box, box]]
    p = torch.from_numpy(pos)
    got = td.cic_deposit_sorted(p.to(dev), 1.25, grid, box)
    assert torch.equal(got.cpu(), td.cic_deposit_sorted(p, 1.25, grid, box))
    assert float(got.double().sum()) == pytest.approx(1.25 * n, rel=1e-6)
    for ns in (2, 4, None):
        s = td.cic_deposit_sorted_slabs(p.to(dev), 1.25, grid, box,
                                        n_slabs=ns)
        assert torch.equal(s.cpu(), td.cic_deposit_sorted_slabs(
            p, 1.25, grid, box, n_slabs=ns))
        torch.testing.assert_close(s, got, rtol=2e-5, atol=2e-5)


def test_slab_deposit_cuda_equals_cpu_and_forces_repeat(dev, monkeypatch):
    """The distributed PM's slab deposit (K13 on the slab block, in one
    and in three x-segments) equals the CPU's bit for bit, and the
    slab-resident and psum forces of a world of one and P3M give the
    same bits twice."""
    from orbitanalysis_tpu_torch.models import pm_sharded as ps
    from orbitanalysis_tpu_torch.models.p3m import make_p3m_force_fn
    from orbitanalysis_tpu_torch.ops import deposit as td
    from orbitanalysis_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(6)
    n, grid, box = 100000, 32, 10.0
    pos = torch.from_numpy(rng.uniform(0, box, (n, 3)).astype(np.float32))
    mass = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32))
    # a world of one's routed lanes: the particles, then zero padding
    lanes = torch.cat([torch.cat([pos, mass[:, None]], dim=1),
                       torch.zeros(3 * n, 4)])

    def block(d):
        lane = lanes.to(d)
        i0, f = td.cic_base(lane[:, :3], grid, box)
        return ps._slab_deposit(i0[:, 0], i0, f, lane[:, 3], grid, grid)

    one = block(dev)
    assert torch.equal(one.cpu(), block("cpu"))
    sx, sy = td.strides(grid)
    monkeypatch.setattr(td, "_SEGMENT_CELLS", 11 * sx + sx + 2 * sy)
    assert td.x_segments(grid, grid) == (11, 3)
    seg = block(dev)
    assert torch.equal(seg.cpu(), block("cpu"))
    torch.testing.assert_close(seg, one, rtol=2e-5, atol=2e-5)
    monkeypatch.undo()
    mesh = make_mesh({"x": 1}, device="cuda")
    p, m = pos.to(dev), mass.to(dev)
    for f in (ps.make_slab_resident_pm_force_fn(mesh, grid),
              ps.make_sharded_pm_force_fn(mesh, grid),
              make_p3m_force_fn(grid)):
        a, b = (f(p, m, box_size=box, softening=0.05) for _ in range(2))
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_deposit_kernel_refuses_bad_inputs_and_counts(dev):
    from orbitanalysis_tpu_torch.models import pm as tpm

    _cuda.reset_launch_counts()
    keys = torch.zeros(10, dtype=torch.int32, device=dev)
    fracs = torch.zeros(4, 10, device=dev)
    _cuda.deposit_sorted(keys, fracs, 729, 81, 9)
    pos = torch.rand(500, 3, device=dev) * 4.0
    tpm.make_pm_force_fn(8)(pos, torch.ones(500, device=dev), box_size=4.0)
    tpm.make_pm_force_fn(8, deposit="scatter")(
        pos, torch.ones(500, device=dev), box_size=4.0)
    counts = _cuda.launch_counts()
    assert counts.pop("deposit_sorted") == 2
    assert set(counts.values()) == {0}
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.deposit_sorted(keys.cpu(), fracs.cpu(), 729, 81, 9)
    with pytest.raises(ValueError, match="int32"):
        _cuda.deposit_sorted(keys.long(), fracs, 729, 81, 9)
    with pytest.raises(ValueError, match="float32"):
        _cuda.deposit_sorted(keys, fracs.double(), 729, 81, 9)
    with pytest.raises(ValueError, match="contiguous"):
        _cuda.deposit_sorted(keys, torch.zeros(10, 4, device=dev).T, 729,
                             81, 9)
    with pytest.raises(ValueError, match="fracs"):
        _cuda.deposit_sorted(keys, fracs[:, :5].contiguous(), 729, 81, 9)


def test_integrator_on_cuda_matches_cpu(dev):
    """PM-driven tracking on the card against the CPU: one force
    evaluation agrees to 1e-4 of its scale (cuFFT against pocketfft, K13
    against index_add_), and the detector gives the same flags and
    counts on identical states."""
    from orbitanalysis_tpu_torch.models import nbody as tnb
    from orbitanalysis_tpu_torch.models import pm as tpm

    rng = np.random.default_rng(4)
    n, grid, box = 4096, 32, 50.0
    pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    vel = rng.normal(scale=0.2, size=(n, 3)).astype(np.float32)
    mass = np.full(n, 1.0 / n, np.float32)
    force = tpm.make_pm_force_fn(grid)
    st = {d: tnb.nbody_state_from_numpy(pos, vel, mass, device=d)
          for d in (dev, "cpu")}
    acc = {d: force(s.pos, s.mass, box_size=box) for d, s in st.items()}
    scale = float(acc["cpu"].abs().max())
    assert float((acc[dev].cpu() - acc["cpu"]).abs().max()) < 1e-4 * scale
    members = np.arange(n, dtype=np.int32).reshape(4, n // 4)
    s1 = tnb.kdk_step(st[dev], acc[dev], 0.5, force, box_size=box)[0]
    later = tnb.NBodyState(*(t.cpu() for t in s1))
    for ident in (True, False):
        out = {}
        for d, s0, s in ((dev, st[dev], s1), ("cpu", st["cpu"], later)):
            tr = tnb.init_track_state(4, n // 4, device=d)
            tr, _ = tnb.detect_apsides_static(tr, s0, members, box_size=box,
                                              identity=ident)
            out[d] = tnb.detect_apsides_static(tr, s, members, box_size=box,
                                               identity=ident)
        (tg, (ag, *_)), (tc, (ac, *_)) = out[dev], out["cpu"]
        assert torch.equal(ag.cpu(), ac) and int(ac.sum()) > 0
        assert torch.equal(tg.counts.cpu(), tc.counts)
        assert torch.equal(tg.rhat.cpu(), tc.rhat)
        torch.testing.assert_close(tg.angles.cpu(), tc.angles, rtol=0,
                                   atol=1e-5)


#: Edges of the probe kernels' grids, resolved on the card by
#: :func:`_edge_shape`: ``few`` fewer vectors than the grid has threads
#: (P1) or fewer stages than blocks, the last one short (P2, P3);
#: ``past`` one vector past a multiple of the grid's share (P1: a vector
#: a thread; P2, P3: a stage a block); ``one`` one unit of a block (P1)
#: or one whole stage (P2, P3); ``view`` a plane that is a row-offset
#: view of a larger one, as ``pallas5``'s are.
PROBE_EDGES = ("few", "past", "one", "view")
#: Particles of one block of P4 (``csrc/probe.cu`` kDetectThreads x
#: kDetectVecs float4s).
P4_TILE = 4096


def _edge_shape(dev, fn, edge):
    """``(rows, row length)`` of edge ``edge`` of the grid of ``fn``'s
    kernel on ``dev`` (``view``: of the view; rows of one vector for
    the others)."""
    if edge == "view":
        return (37, 65536)
    if fn.kernel == "stream_add_rows":
        grid, threads, _ = _cuda.rows_launch(1 << 40, dev)
        unit = threads
    else:
        stage = fn.params["chunk_rows"] * tdm.STAGE_ROW_BYTES
        n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = (_cuda.split_plan if fn.kernel == "stream_add_split"
                else _cuda.ring_plan)
        grid = plan(1 << 40, stage, fn.params["n_buf"], n_sm)[0]
        unit = stage // 16
    share = grid * unit
    return ({"few": share // 2 + 3, "past": 3 * share + 1,
             "one": unit}[edge], 4)


@pytest.mark.parametrize("shape", [
    # rows off the 8- and 32-row tiles and the 4096-particle tile, stages
    # cut short (4,000 bytes a row of 1000), more stages than blocks,
    # one vector, five planes of no rows, the bench row; the grids' edges
    (13, 1000), (37, 65536), (300, 4096), (1, 4), (3, 4100), (8, 32768),
    *PROBE_EDGES])
@pytest.mark.parametrize("name", [*(n for n in tdm.VARIANTS
                                    if not n.startswith("xla")), "stream"])
def test_probe_kernels_match_plain(dev, name, shape):
    """P1-P4 bit for bit against their plain versions on the card: every
    ``dma_probe`` variant (P1, P2, P3) writes ``x + 1`` on every row, one
    launch a plane, and P4 (``stream``) gives the copy kernel's five
    outputs; at the grids' edges (:data:`PROBE_EDGES`) too, P4's at its
    own tile (fewer particles than a block, one vector past a multiple
    of the tile, one tile, its 2-D planes row-offset views)."""
    edge = shape if isinstance(shape, str) else None
    fn = None if name == "stream" else tdm.VARIANTS[name]()
    if edge and fn:
        shape = _edge_shape(dev, fn, edge)
    elif edge:
        shape = {"few": (1, 4), "past": (3, 3 * P4_TILE + 4),
                 "one": (1, P4_TILE), "view": (13, 1000)}[edge]
    skip = 1 if edge == "view" else 0
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    _cuda.reset_launch_counts()
    if name == "stream":
        r, w = shape
        f = lambda *s: torch.from_numpy(  # noqa: E731
            rng.normal(scale=50.0, size=s).astype(np.float32)).to(dev)
        def i(lo, labels=False):
            t = torch.from_numpy(rng.integers(
                lo, 2**31, (r + skip, w), dtype=np.int64).astype(np.int32))
            return (t % 64 - 1 if labels else t).to(dev)[skip:]

        planes = (f(6, r, w), i(-1, labels=True), f(3, r, w), f(3, r, w),
                  i(-2**31), f(3, r, w), i(-2**31))
        got = tdp.detect_stream(*planes)
        want = tdp.detect_stream_torch(*planes)
        torch.cuda.synchronize()
        for g, v in zip(got, want):
            assert g.shape == v.shape
            assert torch.equal(g.view(torch.int32), v.view(torch.int32))
        assert _cuda.launch_counts()["detect_stream_rows"] == 1
        return
    x = torch.from_numpy(rng.normal(size=(shape[0] + skip, shape[1])).astype(
        np.float32)).to(dev)[skip:]
    xin = tdm.variant_input(fn, x)
    got = fn(xin)
    torch.cuda.synchronize()
    planes = zip(xin, got) if fn.n_planes else [(xin, got)]
    n = 0
    for p, g in planes:
        n += p.numel() > 0
        assert torch.equal(g.view(torch.int32),
                           tdm.stream_add_torch(p).view(torch.int32))
    assert _cuda.launch_counts()[fn.kernel] == n


def test_ring_back_to_back_calls_and_plan(dev):
    """P2's claim counter is zeroed on the stream before each launch: two
    calls queued back to back on one stream with different inputs (and a
    third on a plane of another size) each give their own ``x + 1``; its
    blocks an SM are the occupancy calculator's at every ``man*``
    variant, and the block clocks of a call bracket its work."""
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
          for s in ((512, 4096), (512, 4096), (3, 4100))]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in (n for n in tdm.VARIANTS if n.startswith("man")):
        q = tdm.VARIANTS[name]().params
        stage = q["chunk_rows"] * tdm.STAGE_ROW_BYTES
        _cuda.reset_launch_counts()
        ys = [_cuda.stream_add_ring(x, stage, q["n_buf"]) for x in xs]
        torch.cuda.synchronize()
        for x, y in zip(xs, ys):
            assert torch.equal(y.view(torch.int32),
                               tdm.stream_add_torch(x).view(torch.int32))
        assert _cuda.launch_counts()["stream_add_ring"] == 3
        threads, per_sm = _cuda.ring_geometry(stage, q["n_buf"], dev)
        assert threads == _cuda.RING_THREADS
        assert per_sm == _cuda.ring_plan(1 << 40, stage, q["n_buf"],
                                         n_sm)[1], name
        y, clock = _cuda.stream_add_ring_on(xs[0], stage, q["n_buf"],
                                            clock=True)
        assert torch.equal(y, ys[0])
        grid = _cuda.ring_plan(xs[0].numel() * 4, stage, q["n_buf"],
                               n_sm)[0]
        assert clock.shape == (grid, 2)
        assert bool((clock[:, 1] > clock[:, 0]).all())
        # any grid is correct: one block, and more blocks than stages
        for g in (1, 4 * grid):
            y, _ = _cuda.stream_add_ring_on(xs[2], stage, q["n_buf"], g)
            assert torch.equal(y.view(torch.int32),
                               tdm.stream_add_torch(xs[2]).view(torch.int32))
