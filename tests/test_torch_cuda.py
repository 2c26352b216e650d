"""The port's hand-written CUDA kernels on the card, against their
plain-torch twins, and the port's main path on CUDA against the same
path on the CPU.

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


@pytest.mark.parametrize("h,p,k", [(64, 32768, 2048), (3, 256, 256),
                                   (5, 131072 - 128, 4096), (2, 4096, 128)])
@pytest.mark.parametrize("density", [0.0, 0.017, 0.07, 0.5, 1.0])
def test_angle_kernel_matches_twin(dev, h, p, k, density):
    rng = np.random.default_rng(int(density * 100) + p)
    aw = _angle_words(rng, h, p, density)
    aw[0, 1000 % p:1000 % p + 100] |= np.uint32(1 << 31)  # clustered block
    aw[-1, -1] = np.float32(65520.0).view(np.uint32) | np.uint32(1 << 31)
    x = _i32(aw)
    got = tc.compact_angle_blocked(x.to(dev), k)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), tc.compact_angle_blocked_torch(x, k))


@pytest.mark.parametrize("p,k", [(1 << 17, 128), (1 << 18, 16384)])
def test_pair_kernel_matches_twin(dev, p, k):
    rng = np.random.default_rng(p)
    sel = rng.random((4, p)) < 0.03
    sel[:, p - 1] = True
    posw = np.where(sel, np.arange(p, dtype=np.uint32) + 1, np.uint32(0))
    angw = np.where(sel, rng.integers(0, 0x7BFF, (4, p)).astype(np.uint32),
                    np.uint32(0))
    got = tc.compact_payload_pair(_i32(posw).to(dev), _i32(angw).to(dev), k)
    want = tc.compact_payload_pair_torch(_i32(posw), _i32(angw), k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_launch_counts_and_input_checks(dev):
    _cuda.reset_launch_counts()
    x = torch.zeros((2, 256), dtype=torch.int32, device=dev)
    tc.compact_angle_blocked(x, 128)
    tc.compact_payload_pair(x, x, 128)
    tc.compact_angle_blocked_torch(x, 128)  # the twin is not counted
    assert _cuda.launch_counts() == {"compact_angle_rows": 1,
                                     "compact_pair_rows": 1}
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
