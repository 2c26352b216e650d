"""The PM force's CIC interpolation (``models/pm.py`` ``cic_interpolate``):
the hand-written kernel ``cic_interpolate`` (``csrc/interp.cu``) on CUDA
tensors, its plain version ``cic_interpolate_torch`` on CPU tensors; and
its stream form (``cic_interpolate_stream``: the deposit's cell-sorted
stream, rows written at ``order``), which ``pm_forces`` runs wherever it
deposits through the sorted stream, with the plain version
``cic_interpolate_stream_torch``.

On the CPU: the routing (CPU tensors take the plain chain and launch
nothing, the policy still names ``cic_interpolate``, ``pm_forces`` takes
the stream form exactly with the sorted deposit and the scalar
interpolation), the wrappers' refusal of CPU tensors, the plain version
bit-equal to a NumPy model of the kernel's arithmetic, step by step as
``csrc/interp.cu`` takes it, and the stream form's plain version
bit-equal to the positions form's.  On the card (tests marked ``cuda``,
skipped without one): the kernel bit-equal to the plain version on the
same CUDA tensors and on the CPU, at ragged N, grids 16, 64, 128 and 256
(one, two and twelve x-slabs on the H100) and positions on cell
boundaries, at 0, at the box edge, outside the box and negative; the
stream kernel bit-equal to both plain versions and the positions kernel
at 32^3 and config 4's 12.6M / 256^3, on runs of equal keys and an
empty stream; through ``pm_forces`` (profiled: the kernel the benchmark
reads), P3M and the sharded PM's ``local`` in a world of one; and the
wrappers' checks.  The file imports nothing of JAX, so run its card
tests on the card without the repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_interp.py
"""

import numpy as np
import pytest
import torch

from orbitanalysis_tpu_torch.models import pm as tpm
from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.ops import deposit as tdep

BOX = 10.0


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda")


def _positions(n, grid, seed):
    """Uniform positions in the box, the first rows on the cases the
    base cell turns on: cell centres and boundaries, 0 and the box edge,
    the wrap seam, just outside ``[0, box)`` and negative."""
    rng = np.random.default_rng(seed)
    h = BOX / grid
    pos = rng.uniform(0, BOX, size=(n, 3)).astype(np.float32)
    pins = np.array([
        [0.0, 0.0, 0.0],
        [BOX, BOX, BOX],
        [h / 2, h / 2, h / 2],
        [h, 2 * h, 3 * h],
        [BOX - h / 2, 5.0, 5.0],
        [5.0, BOX - h / 2, 5.0],
        [5.0, 5.0, BOX - h / 2],
        [BOX - 1e-6, 1e-6, BOX / 2],
        [BOX + 1e-4, -1e-4, BOX + h],
        [-h / 2, -BOX / 3, -2.5 * BOX],
        [1.5 * BOX, 3 * BOX + h, -h],
        [np.nextafter(np.float32(h / 2), np.float32(0)), h / 2,
         np.nextafter(np.float32(h / 2), np.float32(1))],
    ], np.float32)
    k = min(n, len(pins))
    pos[:k] = pins[:k]
    return pos


def _clustered(n, grid, seed):
    """``n`` positions in a few cells, on their faces and inside: long
    runs of equal stream keys."""
    rng = np.random.default_rng(seed)
    h = BOX / grid
    cell = rng.integers(0, grid, size=(3, 3)).astype(np.float32) * h
    frac = rng.choice(np.array([0.0, 0.25, 0.5, 0.5, 0.75], np.float32),
                      size=(n, 3))
    return (cell[rng.integers(0, 3, n)] + frac * h).astype(np.float32)


def _field(grid, seed):
    rng = np.random.default_rng(seed + 100)
    return rng.normal(size=(3, grid, grid, grid)).astype(np.float32)


def _model(field, pos, grid, box):
    """The kernel's arithmetic in NumPy float32, step by step: the
    float64 quotient rounded to float32, minus 0.5; the floor wrapped
    into ``[0, grid)`` and its +1 neighbour; corner weights ``(wx * wy)
    * wz`` in corner order (dz fastest); each component added left to
    right."""
    f32 = np.float32
    h = f32(float(box) / grid)
    x = (pos.astype(np.float64) / np.float64(h)).astype(f32) - f32(0.5)
    fl = np.floor(x)
    f = x - fl
    base = np.mod(fl.astype(np.int64), grid)
    up = (base + 1) % grid
    planes = field.reshape(3, -1)
    vals, ws = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                ix = up[:, 0] if dx else base[:, 0]
                iy = up[:, 1] if dy else base[:, 1]
                iz = up[:, 2] if dz else base[:, 2]
                wx = f[:, 0] if dx else f32(1) - f[:, 0]
                wy = f[:, 1] if dy else f32(1) - f[:, 1]
                wz = f[:, 2] if dz else f32(1) - f[:, 2]
                vals.append(planes[:, (ix * grid + iy) * grid + iz])
                ws.append((wx * wy) * wz)
    out = np.empty((pos.shape[0], 3), f32)
    for c in range(3):
        a = vals[0][c] * ws[0]
        for q in range(1, 8):
            a = a + vals[q][c] * ws[q]
        out[:, c] = a
    return out


def _bits(a):
    return a.contiguous().view(torch.int32)


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("grid,n", [(16, 1), (16, 4099), (64, 20001)])
def test_plain_version_is_the_kernels_arithmetic(grid, n):
    """The plain chain equals, bit for bit, the NumPy model of what the
    kernel computes: the kernel's specification is the plain version."""
    pos, field = _positions(n, grid, 3), _field(grid, 3)
    got = tpm.cic_interpolate(torch.from_numpy(field), torch.from_numpy(pos),
                              grid, BOX)
    want = _model(field, pos, grid, BOX)
    assert got.dtype == torch.float32 and got.shape == (n, 3)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_cpu_tensors_take_the_plain_chain_and_launch_nothing():
    grid = 16
    pos = torch.from_numpy(_positions(3000, grid, 5))
    field = torch.from_numpy(_field(grid, 5))
    _cuda.reset_launch_counts()
    got = tpm.cic_interpolate(field, pos, grid, BOX)
    acc = tpm.make_pm_force_fn(grid)(pos, torch.ones(3000), box_size=BOX)
    assert torch.equal(_bits(got),
                       _bits(tpm.cic_interpolate_torch(field, pos, grid,
                                                       BOX)))
    assert acc.shape == (3000, 3) and bool(torch.isfinite(acc).all())
    assert set(_cuda.launch_counts().values()) == {0}


def test_sharded_local_on_cpu_takes_the_plain_chain():
    """The sharded PM's ``local`` in a CPU world of one: the
    single-device PM's forces, no kernel launched."""
    from orbitanalysis_tpu_torch.models import pm_sharded as ps
    from orbitanalysis_tpu_torch.parallel import make_mesh

    grid = 16
    pos = torch.from_numpy(_positions(2048, grid, 6))
    mass = torch.ones(2048)
    _cuda.reset_launch_counts()
    force = ps.make_sharded_pm_force_fn(make_mesh({"x": 1}, device="cpu"),
                                        grid)
    got = force.local(pos, mass, box_size=BOX)
    want = tpm.make_pm_force_fn(grid)(pos, mass, box_size=BOX)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert set(_cuda.launch_counts().values()) == {0}


@pytest.mark.parametrize("assignment", ["auto", "scalar"])
def test_policy_still_names_cic_interpolate(assignment):
    assert tpm.select_interpolator(assignment, 256) is tpm.cic_interpolate


def test_wrapper_refuses_cpu_tensors():
    field = torch.zeros(3, 8, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.cic_interpolate(field, torch.zeros(10, 3), 8, BOX)
    skeys, fracs, order = tdep._sorted_stream(torch.zeros(10, 3), 1.0, 8,
                                              BOX)
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.cic_interpolate_stream(field, skeys, fracs, order, 8)


def _stream_and_positions(n, grid, seed, clustered=False):
    pos = (_clustered if clustered else _positions)(n, grid, seed)
    return torch.from_numpy(pos), torch.from_numpy(_field(grid, seed))


@pytest.mark.parametrize("grid", [8, 32, 33, 64])
@pytest.mark.parametrize("n,clustered", [(0, False), (1, False),
                                         (4099, False), (4099, True),
                                         (20001, False)])
def test_stream_twin_equals_positions_twin(grid, n, clustered):
    """The stream form's plain version on the stream the PM force builds
    (``_sorted_stream``) equals the positions form's bit for bit, rows in
    particle order: uniform positions with the pinned faces, 0, the box
    edge and the outside, or a few cells' long runs of equal keys."""
    pos, field = _stream_and_positions(n, grid, grid + n, clustered)
    skeys, fracs, order = tdep._sorted_stream(pos, 1.0, grid, BOX)
    if clustered:
        assert torch.unique(skeys).numel() <= 24
    got = tpm.cic_interpolate_stream(field, skeys, fracs, order, grid)
    want = tpm.cic_interpolate_torch(field, pos, grid, BOX)
    assert got.shape == (n, 3) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("grid", [8, 33, 64, 1289])
def test_stream_keys_decode_to_the_wrapped_base_cells(grid):
    """``stream_base`` of the stream's keys gives ``cic_base``'s wrapped
    base cells, in stream order, at the grids' edges and up to the
    largest grid whose virtual keys fit int32."""
    pos = torch.from_numpy(_positions(3000, grid, grid))
    skeys, _, order = tdep._sorted_stream(pos, 1.0, grid, BOX)
    i0, _ = tdep.cic_base(pos, grid, BOX)
    got = tdep.stream_base(skeys, grid)
    assert torch.equal(got, i0[order])
    assert int(got.min()) >= 0 and int(got.max()) < grid
    assert torch.equal(tdep.sorted_stream(pos, 1.0, grid, BOX)[0], skeys)


def _positions_form(pos, mass, grid, deposit):
    rho = tpm.select_depositor(deposit, grid)(pos, mass, grid, BOX)
    return tpm.cic_interpolate_torch(tpm.pm_forces_grid(rho, grid, BOX),
                                     pos, grid, BOX)


def test_pm_forces_sorted_on_cpu_interpolates_the_stream():
    """``deposit='sorted'`` on CPU tensors: the stream form, the positions
    form's bits, every particle counted in ``interp_stream``, no launch."""
    grid, n = 32, 5000
    pos = torch.from_numpy(_positions(n, grid, 21))
    mass = torch.from_numpy(np.random.default_rng(21).uniform(
        0.5, 2.0, n).astype(np.float32))
    metrics = {}
    _cuda.reset_launch_counts()
    got = tpm.pm_forces(pos, mass, grid, BOX, deposit="sorted",
                        metrics=metrics)
    assert torch.equal(_bits(got),
                       _bits(_positions_form(pos, mass, grid, "sorted")))
    assert metrics["interp_stream"] == metrics["deposited"] == n
    assert set(_cuda.launch_counts().values()) == {0}


@pytest.mark.parametrize("deposit,assignment", [
    ("scatter", "auto"), ("sorted", "rows"), ("sorted", "cells"),
    ("auto", "scalar")])
def test_pm_forces_takes_the_positions_form_elsewhere(deposit, assignment,
                                                      monkeypatch):
    """The scatter deposit, the tables, and ``'auto'`` on CPU tensors
    (the scatter deposit): the positions form, ``interp_stream`` 0."""
    grid, n = 16, 3000
    pos = torch.from_numpy(_positions(n, grid, 22))
    mass = torch.ones(n)

    def refuse(*a, **k):
        raise AssertionError("the stream form ran")

    monkeypatch.setattr(tpm, "cic_interpolate_stream", refuse)
    metrics = {}
    got = tpm.pm_forces(pos, mass, grid, BOX, deposit=deposit,
                        assignment=assignment, metrics=metrics)
    assert metrics["interp_stream"] == 0 and metrics["deposited"] == n
    if assignment in ("auto", "scalar"):
        assert torch.equal(_bits(got),
                           _bits(_positions_form(pos, mass, grid, deposit)))


# ------------------------------------------------------------ on the card

@pytest.mark.cuda
@pytest.mark.parametrize("grid", [16, 64, 128, 256])
@pytest.mark.parametrize("n", [1, 257, 1025, 100003])
def test_kernel_equals_plain_version(dev, grid, n):
    pos, field = _positions(n, grid, grid + n), _field(grid, grid)
    p, f = torch.from_numpy(pos), torch.from_numpy(field)
    pc, fc = p.to(dev), f.to(dev)
    _cuda.reset_launch_counts()
    got = tpm.cic_interpolate(fc, pc, grid, BOX)
    again = tpm.cic_interpolate(fc, pc, grid, BOX)
    assert _cuda.launch_counts()["cic_interpolate"] == 2
    plain = tpm.cic_interpolate_torch(fc, pc, grid, BOX)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(plain))
    assert torch.equal(_bits(got), _bits(again))
    assert torch.equal(_bits(got.cpu()),
                       _bits(tpm.cic_interpolate_torch(f, p, grid, BOX)))
    if n == 100003:
        assert np.array_equal(got.cpu().numpy().view(np.int32),
                              _model(field, pos, grid, BOX).view(np.int32))


@pytest.mark.cuda
def test_kernel_on_empty_and_float64_positions(dev):
    grid = 16
    f = torch.from_numpy(_field(grid, 1)).to(dev)
    assert tpm.cic_interpolate(f, torch.zeros(0, 3, device=dev), grid,
                               BOX).shape == (0, 3)
    p = torch.from_numpy(_positions(999, grid, 1)).to(dev)
    assert torch.equal(
        _bits(tpm.cic_interpolate(f, p.double(), grid, BOX)),
        _bits(tpm.cic_interpolate_torch(f, p.double(), grid, BOX)))


def _plain_interp(monkeypatch):
    """Both forms of the interpolation to their plain versions."""
    monkeypatch.setattr(tpm, "cic_interpolate", tpm.cic_interpolate_torch)
    monkeypatch.setattr(tpm, "cic_interpolate_stream",
                        tpm.cic_interpolate_stream_torch)


@pytest.mark.cuda
def test_force_paths_equal_with_the_plain_interpolation(dev, monkeypatch):
    """``pm_forces`` (the stream form), P3M and the sharded PM's
    ``local`` (world of one; the positions form): the same bits with the
    kernels as with the plain chains, and the kernel launched once a
    force evaluation."""
    from orbitanalysis_tpu_torch.models import pm_sharded as ps
    from orbitanalysis_tpu_torch.models.p3m import make_p3m_force_fn
    from orbitanalysis_tpu_torch.parallel import make_mesh

    grid, n = 32, 50000
    pos = torch.from_numpy(_positions(n, grid, 9)).to(dev)
    mass = torch.from_numpy(np.random.default_rng(9).uniform(
        0.5, 2.0, n).astype(np.float32)).to(dev)
    mesh = make_mesh({"x": 1}, device="cuda")

    def forces():
        fns = (tpm.make_pm_force_fn(grid), make_p3m_force_fn(grid),
               ps.make_sharded_pm_force_fn(mesh, grid).local)
        return [f(pos, mass, box_size=BOX, softening=0.05) for f in fns]

    _cuda.reset_launch_counts()
    got = forces()
    assert _cuda.launch_counts()["cic_interpolate"] == 3
    acc = tpm.pm_forces(pos, mass, grid, BOX)
    assert _cuda.launch_counts()["cic_interpolate"] == 4
    _plain_interp(monkeypatch)
    want = forces()
    assert _cuda.launch_counts()["cic_interpolate"] == 4
    assert torch.equal(_bits(acc), _bits(got[0]))
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("grid,n,clustered", [
    (32, 0, False), (32, 1, False), (32, 100003, False), (32, 100003, True),
    (256, 12582912, False), (256, 1 << 20, True)])
def test_stream_kernel_equals_its_twin_and_the_positions_kernel(
        dev, grid, n, clustered):
    """The stream kernel on the stream of ``_sorted_stream``: bit-equal to
    its plain version on the same CUDA tensors and on the CPU, to the
    positions kernel and to ``cic_interpolate_torch``, twice the same
    bits, one ``cic_interpolate`` launch counted a call; config 4's
    12.6M particles on 256^3 and runs of equal keys among the cases."""
    p, f = _stream_and_positions(n, grid, grid + n, clustered)
    pc, fc = p.to(dev), f.to(dev)
    stream = tdep._sorted_stream(pc, 1.0, grid, BOX)
    _cuda.reset_launch_counts()
    got = tpm.cic_interpolate_stream(fc, *stream, grid)
    again = tpm.cic_interpolate_stream(fc, *stream, grid)
    assert _cuda.launch_counts()["cic_interpolate"] == 2
    twin = tpm.cic_interpolate_stream_torch(fc, *stream, grid)
    positions = tpm.cic_interpolate(fc, pc, grid, BOX)
    plain = tpm.cic_interpolate_torch(fc, pc, grid, BOX)
    torch.cuda.synchronize()
    assert got.shape == (n, 3)
    for other in (again, twin, positions, plain):
        assert torch.equal(_bits(got), _bits(other))
    if n <= 100003:
        cpu = tdep._sorted_stream(p, 1.0, grid, BOX)
        assert torch.equal(_bits(got.cpu()), _bits(
            tpm.cic_interpolate_stream_torch(f, *cpu, grid)))


def _interp_kernels():
    """The benchmark's words for the interpolation kernel in a trace
    (``portbench/metrics/interp_roofline.integrate.py``)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "portbench", "metrics", "interp_roofline.integrate.py")
    spec = importlib.util.spec_from_file_location("interp_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.INTERP_KERNELS


@pytest.mark.cuda
def test_profiled_pm_forces_runs_the_stream_kernel(dev):
    """A profiled ``pm_forces`` call on CUDA tensors: one
    ``cic_interpolate`` launch, a device kernel that the benchmark's
    ``INTERP_KERNELS`` names (the stream form's), every particle counted
    in ``interp_stream``, and the bits of the positions kernel and of
    ``cic_interpolate_torch`` on the sorted deposit's field."""
    from torch.profiler import ProfilerActivity, profile

    grid, n = 32, 50000
    pos = torch.from_numpy(_positions(n, grid, 23)).to(dev)
    mass = torch.from_numpy(np.random.default_rng(23).uniform(
        0.5, 2.0, n).astype(np.float32)).to(dev)
    tpm.pm_forces(pos, mass, grid, BOX)
    torch.cuda.synchronize()
    metrics = {}
    _cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = tpm.pm_forces(pos, mass, grid, BOX, metrics=metrics)
        torch.cuda.synchronize()
    assert _cuda.launch_counts()["cic_interpolate"] == 1
    assert metrics["interp_stream"] == metrics["deposited"] == n
    names = {e.key for e in prof.key_averages()}
    found = [k for k in names for words in _interp_kernels()
             if all(w in k for w in words)]
    assert found and all("cic_interpolate_kernel_stream" in k
                         for k in found), sorted(names)
    field = tpm.pm_forces_grid(tdep.cic_deposit_sorted(pos, mass, grid, BOX),
                               grid, BOX)
    assert torch.equal(_bits(got),
                       _bits(tpm.cic_interpolate(field, pos, grid, BOX)))
    assert torch.equal(_bits(got), _bits(tpm.cic_interpolate_torch(
        field, pos, grid, BOX)))


@pytest.mark.cuda
def test_stream_wrapper_refuses_bad_inputs(dev):
    grid, n = 8, 10
    field = torch.zeros(3, grid, grid, grid, device=dev)
    skeys, fracs, order = tdep._sorted_stream(
        torch.zeros(n, 3, device=dev), 1.0, grid, BOX)
    _cuda.reset_launch_counts()
    bad = {
        "float32": [(field.double(), skeys, fracs, order),
                    (field, skeys, fracs.double(), order)],
        "int32": [(field, skeys.long(), fracs, order)],
        "int64": [(field, skeys, fracs, order.int())],
        r"\[3, 8, 8, 8\]": [(torch.zeros(3, grid, grid, grid + 1,
                                         device=dev), skeys, fracs, order)],
        r"fracs \[4, 10\]": [(field, skeys, fracs[:3].contiguous(), order),
                              (field, skeys, fracs, order[:9])],
        "CUDA": [(field.cpu(), skeys, fracs, order),
                 (field, skeys, fracs, order.cpu())],
        "contiguous": [(field, skeys, fracs.T.contiguous().T, order)],
    }
    for match, cases in bad.items():
        for args in cases:
            with pytest.raises(ValueError, match=match):
                _cuda.cic_interpolate_stream(*args, grid)
    assert _cuda.launch_counts()["cic_interpolate"] == 0


@pytest.mark.cuda
def test_wrapper_refuses_bad_inputs(dev):
    grid = 8
    field = torch.zeros(3, grid, grid, grid, device=dev)
    pos = torch.zeros(10, 3, device=dev)
    _cuda.reset_launch_counts()
    bad = {
        "float32": [(field.double(), pos), (field, pos.double()),
                    (field.half(), pos)],
        "4-D": [(field.reshape(3, -1), pos)],
        "2-D": [(field, pos.reshape(-1))],
        r"\[3, 8, 8, 8\]": [(torch.zeros(3, grid, grid, grid + 1,
                                         device=dev), pos),
                            (torch.zeros(4, grid, grid, grid,
                                         device=dev), pos)],
        r"\[N, 3\]": [(field, torch.zeros(10, 4, device=dev))],
        "CUDA": [(field.cpu(), pos), (field, pos.cpu())],
        "contiguous": [(field.transpose(1, 3), pos),
                       (field, torch.zeros(3, 10, device=dev).T)],
    }
    for match, cases in bad.items():
        for f, p in cases:
            with pytest.raises(ValueError, match=match):
                _cuda.cic_interpolate(f, p, grid, BOX)
    assert _cuda.launch_counts()["cic_interpolate"] == 0


@pytest.mark.parametrize("grid,slabs", [(8, 1), (64, 1), (128, 2),
                                        (256, 12), (512, 16), (1024, 16)])
def test_slab_count_fits_a_third_of_the_l2(grid, slabs):
    """The kernel's x-slabs on the H100's 50 MB L2: the fewest whose
    three float32 planes take at most a third of it, at most 16."""
    l2 = 50 * 2 ** 20
    got = _cuda.interp_slabs(grid, l2)
    assert got == slabs
    assert got == _cuda.INTERP_MAX_SLABS or 36 * grid ** 3 <= got * l2


@pytest.mark.cuda
def test_integrator_same_bits_with_the_plain_interpolation(dev, monkeypatch):
    """A tracked PM run on the card (8 steps, detection every 2): the
    same states, counts, angles and events with the kernel (its stream
    form) as with the plain chain, and the kernel launched once a force
    evaluation."""
    from orbitanalysis_tpu_torch.models import nbody as tnb

    grid, rows, width = 32, 4, 4096
    n = rows * width
    rng = np.random.default_rng(12)
    pos = rng.uniform(0, BOX, (n, 3)).astype(np.float32)
    vel = rng.normal(scale=0.05, size=(n, 3)).astype(np.float32)
    mass = np.full(n, 1.0, np.float32)
    members = np.arange(n, dtype=np.int32).reshape(rows, width)
    cfg = tnb.OrbitNBodyConfig(dt=1e-3, n_steps=8, detect_every=2,
                               mode="pericentric", box_size=BOX,
                               softening=0.0)

    def run():
        st = tnb.nbody_state_from_numpy(pos, vel, mass, device=dev)
        st, tr, ev = tnb.simulate_with_tracking(
            st, members, cfg, tpm.make_pm_force_fn(grid))
        return st.pos, st.vel, tr.counts, tr.angles, tr.rhat, ev

    _cuda.reset_launch_counts()
    got = run()
    assert _cuda.launch_counts()["cic_interpolate"] == 9
    _plain_interp(monkeypatch)
    want = run()
    assert int(got[-1].sum()) > 0
    for a, b in zip(got, want):
        assert torch.equal(a, b)
