"""The port's stream probes (orbitanalysis_tpu_torch.probes) on the CPU:
every ``dma_probe.VARIANTS`` entry against the JAX package's
``benchmarks/dma_probe.py`` function in TPU interpret mode, P4's plain
version against a NumPy restatement of the JAX ``copy_kernel``, the
entry points at small sizes, and the kernel wrappers' checks.

The JAX half skips where jax is missing (the machine with the card runs
the repo's tests without jax); the CUDA kernels are held against their
plain versions on the card by tests/test_torch_cuda.py.  Every output is
exact: ``x + 1``, copies, integer sums, and float32 sums in one order.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.probes import detect_probe as tdp
from orbitanalysis_tpu_torch.probes import dma_probe as tdm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_dma():
    """The JAX probe script, imported from its file, and the interpret
    mode its Pallas kernels run in here."""
    pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu

    spec = importlib.util.spec_from_file_location(
        "jax_dma_probe", os.path.join(REPO, "benchmarks", "dma_probe.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, pltpu.force_tpu_interpret_mode


def _defined_rows(fn, rows):
    """The rows of each input plane the JAX kernel writes: whole row
    blocks (``auto``) or whole chunks (``manual``, ``split``)."""
    step = fn.params.get("block_rows") or fn.params.get("chunk_rows") or 1
    return rows // step * step


def test_variants_keep_the_jax_names():
    with open(os.path.join(REPO, "benchmarks", "dma_probe.py")) as f:
        src = f.read()
    start = src.index("VARIANTS = {")
    names = [line.split('"')[1] for line in
             src[start:src.index("}", start)].splitlines()[1:]]
    assert list(tdm.VARIANTS) == names


@pytest.mark.parametrize("rows", [128, 256])
@pytest.mark.parametrize("name", list(tdm.VARIANTS))
def test_dma_variant_matches_jax(jax_dma, name, rows):
    """Each variant on the CPU gives the JAX function's output on every
    row JAX defines (``pallas5`` leaves row 24 of each 25-row plane at
    128 rows undefined), and writes every row."""
    import jax.numpy as jnp

    jmod, interpret = jax_dma
    x = np.random.default_rng(rows).normal(size=(rows, tdm.LANES)).astype(
        np.float32)
    fn = tdm.VARIANTS[name]()
    jfn = jmod.VARIANTS[name]()
    assert fn.n_planes == getattr(jfn, "n_planes", 0)
    xt = torch.from_numpy(x)
    xin = tdm.variant_input(fn, xt)
    got = fn(xin)
    jin = (tuple(jnp.asarray(p.numpy()) for p in xin)
           if fn.n_planes else jnp.asarray(x))
    with interpret():
        want = jfn(jin)
    planes = (xin, got, want) if fn.n_planes else ((xin,), (got,), (want,))
    for p, g, w in zip(*planes):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape == tuple(p.shape)
        d = _defined_rows(fn, p.shape[0])
        assert d > 0
        assert np.array_equal(g[:d].view(np.int32), w[:d].view(np.int32))
        # every row, those JAX leaves undefined too
        assert np.array_equal(g.view(np.int32),
                              (p.numpy() + np.float32(1)).view(np.int32))


def test_pallas5_leaves_rows_undefined_that_the_port_writes():
    """At 2048 rows the five planes hold 409 rows; JAX's grid of
    409 // 8 blocks writes 408 of them, and the port counts and writes
    all 409."""
    fn = tdm.VARIANTS["pallas5"]()
    x = torch.zeros((2048, 8))
    planes = tdm.variant_input(fn, x)
    assert [p.shape[0] for p in planes] == [409] * 5
    assert _defined_rows(fn, 409) == 408
    assert tdm.moved_bytes(planes) == 2 * 5 * 409 * 8 * 4


def _copy_kernel_numpy(rows, lab, pos, vel, sv, rh, pk):
    """``detect_probe.py:118-128`` restated in NumPy (uint32 planes as
    their int32 bits)."""
    s = (rows[0] + pos[0] + pos[1] + pos[2] + vel[0] + vel[1] + vel[2]
         + rows[3])
    return (sv + lab, rh.copy(), pk.copy(), s.view(np.int32),
            lab.sum(axis=1, keepdims=True, dtype=np.int32))


def _stream_planes(rng, r, w):
    f = lambda *s: rng.normal(scale=50.0, size=s).astype(np.float32)  # noqa
    return (f(6, r, w), rng.integers(-1, 64, (r, w), dtype=np.int32),
            f(3, r, w), f(3, r, w),
            rng.integers(-2**31, 2**31, (r, w), dtype=np.int64).astype(
                np.int32),
            f(3, r, w),
            rng.integers(-2**31, 2**31, (r, w), dtype=np.int64).astype(
                np.int32))


def test_detect_stream_plain_matches_copy_kernel():
    """P4's plain version bit for bit against the JAX copy kernel's body
    on seeded [8, 32768] planes (sv and pk over the whole int32 range, so
    sv + lab wraps)."""
    planes = _stream_planes(np.random.default_rng(17), 8, 32768)
    with np.errstate(over="ignore"):
        want = _copy_kernel_numpy(*planes)
    got = tdp.detect_stream(*(torch.from_numpy(p) for p in planes))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.int32), w.view(np.int32))


def test_dma_main_on_cpu():
    """The entry point runs every variant and counts the bytes moved."""
    res = tdm.main(rows=40, device="cpu")
    assert list(res) == list(tdm.VARIANTS)
    for name, r in res.items():
        five = tdm.VARIANTS[name]().n_planes
        rows = 40 // five * five if five else 40
        assert r["bytes"] == 2 * rows * tdm.LANES * 4
        assert r["ms"] > 0 and r["gbps"] > 0


def test_detect_main_on_cpu():
    res = tdp.main(halos=1, cap=32768, snaps=2, device="cpu")
    assert list(res) == ["full", "stream"]
    assert all(r["bytes"] == 96 * 32768 + 4 for r in res.values())


def test_detect_probe_inputs_follow_the_jax_probe():
    """The frame-row stand-in is snapshot 0's positions and zeros, the
    carry untracked with f32 r-hat."""
    rows, lab, pos, vel, carry = tdp.probe_inputs(2, 16384, 3, "cpu")
    assert rows.shape == (6, 1, 32768) and lab.shape == (3, 1, 32768)
    assert pos.shape == vel.shape == (3, 3, 1, 32768)
    assert torch.equal(rows[:3], pos[0]) and not rows[3:].any()
    assert carry.rhat.shape == (3, 1, 32768) and not carry.lab_sv.any()
    with pytest.raises(ValueError, match="not rows of"):
        tdp.probe_inputs(2, 1000, 1, "cpu")


def test_entry_points_need_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdm.main(rows=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdp.main(halos=1, cap=32768, snaps=1)


@pytest.mark.parametrize("call,match", [
    (lambda x: _cuda.stream_add_rows(x, 0), "block_rows"),
    (lambda x: _cuda.stream_add_rows(x[0], 8), r"x \[R, L\]"),
    (lambda x: _cuda.stream_add_ring(x, 512, 3), "n_buf in"),
    (lambda x: _cuda.stream_add_ring(x, 520, 4), "multiple of 16"),
    (lambda x: _cuda.stream_add_ring(x, 64 * 1024, 4), "within"),
    (lambda x: _cuda.stream_add_split(x, 16 * 512, 4, 3), "16 \\* n_dma"),
    (lambda x: _cuda.stream_add_split(x, 32 * 1024, 4, 1), "within"),
    (lambda x: _cuda.stream_add_split(x, 4096, 4, 0), "n_dma"),
    # valid parameters: the tensor is not on the card
    (lambda x: _cuda.stream_add_rows(x, 8), "CUDA tensors"),
    (lambda x: _cuda.stream_add_ring(x, 8192, 4), "CUDA tensors"),
    (lambda x: _cuda.stream_add_split(x, 16384, 4, 2), "CUDA tensors"),
])
def test_stream_wrappers_check_their_arguments(call, match):
    with pytest.raises(ValueError, match=match):
        call(torch.zeros((16, 64)))


def test_detect_stream_wrapper_checks_shapes_and_device():
    planes = [torch.from_numpy(p) for p in
              _stream_planes(np.random.default_rng(0), 2, 64)]
    bad = list(planes)
    bad[2] = planes[2][:2]  # pos [2, R, W]
    with pytest.raises(ValueError, match=r"want shape \(3, 2, 64\)"):
        _cuda.detect_stream_rows(*bad)
    with pytest.raises(ValueError, match=r"want lab \[R, W\]"):
        _cuda.detect_stream_rows(planes[0], planes[2], *planes[2:])
    with pytest.raises(ValueError, match="CUDA tensors"):
        _cuda.detect_stream_rows(*planes)


@pytest.mark.parametrize("call", [
    lambda x: tdm.stream_add_rows(x, 8),
    lambda x: tdm.stream_add_ring(x, 16, 4),
    lambda x: tdm.stream_add_split(x, 32, 4, 2),
])
def test_stream_entry_points_route_by_device(call):
    """CPU tensors take the plain version; a device with no kernel
    raises and nothing falls back."""
    x = torch.arange(64 * 8, dtype=torch.float32).reshape(8, 64)
    assert torch.equal(call(x), x + 1)
    with pytest.raises(ValueError, match="no stream kernel"):
        call(x.to("meta"))


def test_probe_kernels_are_registered_with_their_sites():
    want = {"stream_add_rows": "benchmarks/dma_probe.py:68",
            "stream_add_ring": "benchmarks/dma_probe.py:144",
            "stream_add_split": "benchmarks/dma_probe.py:244",
            "detect_stream_rows": "benchmarks/detect_probe.py:138"}
    for name, site in want.items():
        k = _cuda.KERNELS[name]
        assert (k.replaces, k.source, k.route) == (
            site, "orbitanalysis_tpu_torch/csrc/probe.cu", "cuda")
        path, line = site.split(":")
        with open(os.path.join(REPO, path)) as f:
            text = f.read().splitlines()
        assert "pl.pallas_call(" in text[int(line) - 1]
