"""The port's stream probes (orbitanalysis_tpu_torch.probes) on the CPU:
every ``dma_probe.VARIANTS`` entry against the JAX package's
``benchmarks/dma_probe.py`` function in TPU interpret mode, P4's plain
version against a NumPy restatement of the JAX ``copy_kernel``, the
entry points at small sizes, the kernel wrappers' checks, and P1's,
P2's and P3's launch plans (``ops/_cuda.py`` ``rows_plan``,
``rows_share``, ``ring_plan``, ``split_plan``) with the kernels' index
arithmetic and P2's stage claims restated.

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
from hypothesis import assume, given, settings
from hypothesis import strategies as st

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


# --- the host-side plans of P1 and P3 (ops/_cuda.py) ----------------------

#: The H100's SMs, and the bytes of loads an SM needs in flight to cover
#: ~1 us of memory latency at 3.35 TB/s (Little's law).
H100_SMS = 132
LATENCY_BYTES = 25 * 1024


def _check_rows_shares(n_vecs, n_sm, per_sm, threads):
    """P1's plan deals every vector to exactly one block, uses at most the
    card's resident blocks and one block a unit, and keeps every block's
    share within one vector a thread of every other's."""
    grid, units = _cuda.rows_plan(n_vecs, n_sm, per_sm, threads)
    assert units * threads >= n_vecs > (units - 1) * threads
    assert 1 <= grid <= min(n_sm * per_sm, units)
    ranges = sorted(r for b in range(grid)
                    for r in _cuda.rows_share(b, grid, units, threads, n_vecs))
    assert ranges[0][0] == 0 and ranges[-1][1] == n_vecs
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [sum(hi - lo for lo, hi in _cuda.rows_share(
        b, grid, units, threads, n_vecs)) for b in range(grid)]
    assert max(sizes) - min(sizes) <= threads
    return grid


@pytest.mark.parametrize("n_vecs,n_sm,per_sm,threads", [
    # the probe's plane and a pallas5 plane on the H100's 1024-thread
    # blocks; fewer vectors than the grid has threads; one vector past a
    # multiple of the grid's share; one vector; a short last unit
    (2048 * 65536 // 4, H100_SMS, 1, 1024),
    (409 * 65536 // 4, H100_SMS, 1, 1024),
    (H100_SMS * 1024 // 2 + 3, H100_SMS, 1, 1024),
    (3 * H100_SMS * 1024 + 1, H100_SMS, 1, 1024),
    (1, H100_SMS, 1, 1024),
    (5 * 256 + 7, 2, 4, 256),
])
def test_rows_plan_deals_every_vector_once(n_vecs, n_sm, per_sm, threads):
    grid = _check_rows_shares(n_vecs, n_sm, per_sm, threads)
    if n_vecs >= n_sm * per_sm * threads:
        assert grid == n_sm * per_sm  # every SM full


@settings(max_examples=60, deadline=None, database=None)
@given(n_vecs=st.integers(1, 1 << 18), n_sm=st.integers(1, 160),
       per_sm=st.integers(1, 16),
       threads=st.sampled_from([32, 128, 256, 512, 1024]))
def test_rows_plan_any_size(n_vecs, n_sm, per_sm, threads):
    _check_rows_shares(n_vecs, n_sm, per_sm, threads)


def _rows_kernel_walk(n_vecs, grid, threads, unroll=4):
    """The vectors ``csrc/probe.cu`` stream_add_rows_kernel loads and
    stores, by block: thread ``t`` of block ``b`` starts at ``b *
    threads + t``, steps ``grid * threads`` and takes ``count`` vectors,
    ``unroll`` at a time, the next ones loaded before the current ones
    are stored."""
    out = []
    stride = grid * threads
    for b in range(grid):
        mine = []
        for t in range(threads):
            first = b * threads + t
            if first >= n_vecs:
                continue
            count = (n_vecs - 1 - first) // stride + 1
            loaded = [first + u * stride for u in range(min(unroll, count))]
            stored = []
            for k in range(0, count, unroll):
                nxt = [first + (k + unroll + u) * stride for u in range(unroll)
                       if u < count - k - unroll]
                stored += [first + (k + u) * stride for u in range(unroll)
                           if u < count - k]
                loaded += nxt
            assert loaded == stored  # each vector loaded once, then stored
            mine += stored
        out.append(sorted(mine))
    return out


@pytest.mark.parametrize("n_vecs,n_sm,per_sm,threads", [
    (1, 3, 1, 8), (7, 3, 1, 8), (24, 3, 1, 8), (25, 3, 1, 8),
    (3 * 3 * 8 * 4 + 1, 3, 1, 8), (1000, 5, 2, 16), (4096, 4, 1, 32)])
def test_rows_kernel_walk_is_the_plan(n_vecs, n_sm, per_sm, threads):
    """The kernel's index arithmetic, restated, visits exactly the
    vectors :func:`_cuda.rows_share` gives each block."""
    grid, units = _cuda.rows_plan(n_vecs, n_sm, per_sm, threads)
    walk = _rows_kernel_walk(n_vecs, grid, threads)
    for b in range(grid):
        want = [v for lo, hi in _cuda.rows_share(b, grid, units, threads,
                                                 n_vecs)
                for v in range(lo, hi)]
        assert walk[b] == want


def _split_copies(n_bytes, stage, n_dma, grid):
    """The ``(offset, bytes)`` bulk copies of ``csrc/probe.cu``
    stream_add_split_kernel (each the same way in and out): stage ``g``
    of the flat tensor goes to block ``g % grid``, ``n_dma`` copies of
    ``stage // n_dma`` bytes a stage, the last stage and copy cut
    short."""
    sub = stage // n_dma
    copies = []
    n_stages = -(-n_bytes // stage)
    for b in range(grid):
        for g in range(b, n_stages, grid):
            size = min(stage, n_bytes - g * stage)
            copies += [(g * stage + off, min(sub, size - off))
                       for off in range(0, size, sub)]
    return copies


def _check_split_plan(n_bytes, stage, n_buf, n_dma, n_sm):
    grid, per_sm = _cuda.split_plan(n_bytes, stage, n_buf, n_sm)
    block = (2 * n_buf * stage + n_buf * _cuda.SPLIT_BARRIER_BYTES
             + _cuda.BLOCK_RESERVED_SMEM)
    assert per_sm in (1, 2)
    assert 2 * n_buf * stage + n_buf * _cuda.SPLIT_BARRIER_BYTES <= 227 * 1024
    assert per_sm * block <= _cuda.SM_SMEM
    assert 1 <= grid <= min(per_sm * n_sm, -(-n_bytes // stage))
    copies = sorted(_split_copies(n_bytes, stage, n_dma, grid))
    assert all(size > 0 and size % 16 == 0 and off % 16 == 0
               for off, size in copies)
    assert copies[0][0] == 0
    assert all(a[0] + a[1] == b[0] for a, b in zip(copies, copies[1:]))
    assert copies[-1][0] + copies[-1][1] == n_bytes
    return grid, per_sm


@pytest.mark.parametrize("name", ["split32x4", "dual32x4", "quad64x2"])
@pytest.mark.parametrize("n_bytes", [
    # the probe's plane; fewer stages than blocks; one vector past a
    # multiple of stage x grid; one vector
    2048 * 65536 * 4, 4096 * 7, 3 * H100_SMS * 32 * 512 + 16, 16])
def test_split_plan_fits_and_covers(name, n_bytes):
    """P3's rings fit 227 KB a block and 228 KB an SM at every JAX
    variant, hold enough loads in flight an SM to cover the latency, and
    its bulk copies cover every byte once."""
    p = tdm.VARIANTS[name]().params
    stage = p["chunk_rows"] * tdm.STAGE_ROW_BYTES
    grid, per_sm = _check_split_plan(n_bytes, stage, p["n_buf"], p["n_dma"],
                                      H100_SMS)
    assert per_sm * p["n_buf"] * stage >= LATENCY_BYTES
    if n_bytes >= per_sm * H100_SMS * stage:
        assert grid == per_sm * H100_SMS


@settings(max_examples=60, deadline=None, database=None)
@given(vecs=st.integers(1, 1 << 16), rows=st.sampled_from([1, 8, 16, 32, 64]),
       row_bytes=st.sampled_from([64, 256, 512, 768]),
       n_buf=st.sampled_from(_cuda.RING_DEPTHS),
       n_dma=st.sampled_from([1, 2, 4]), n_sm=st.integers(1, 160))
def test_split_plan_any_size(vecs, rows, row_bytes, n_buf, n_dma, n_sm):
    stage = rows * row_bytes
    # the stages the wrapper takes
    assume(stage % (16 * n_dma) == 0 and 2 * n_buf * stage <= _cuda.RING_SMEM)
    _check_split_plan(16 * vecs, stage, n_buf, n_dma, n_sm)


# --- P2's plan and stage claims (ops/_cuda.py ring_plan, csrc/probe.cu) ---

#: The blocks an H100 SM holds of each ring size (bytes), as the CUDA
#: occupancy calculator gives them for 192-thread blocks.
RING_BLOCKS = {32 * 1024: 6, 64 * 1024: 3, 128 * 1024: 1}


def _ring_claims(n_bytes, stage, n_buf, grid, claim, turns):
    """``csrc/probe.cu`` stream_add_ring_kernel's claims, restated: each
    block's producer takes ``claim`` stages a claim (``atomicAdd(
    next_stage, claim)``), one stage a turn, its j-th stage from the
    claim made at j - j % claim, in the order ``turns`` gives (a block
    index a turn, drawn round-robin once it runs out; a finished block's
    turn passes); each stops at its first stage past the last, which
    tags its slot -1.  Returns the counter's last value and, by block,
    the ``(slot, offset, bytes)`` of each stage it loaded and stored."""
    n_stages = -(-n_bytes // stage)
    counter, claims, live = 0, [[] for _ in range(grid)], set(range(grid))
    first = [0] * grid
    turns = iter(list(turns) + [b for _ in range(n_stages + 1)
                                for b in range(grid)])
    while live:
        b = next(turns) % grid
        if b not in live:
            continue
        j = len(claims[b])
        if j % claim == 0:
            first[b], counter = counter, counter + claim
        g = first[b] + j % claim
        if g >= n_stages:
            live.discard(b)
            continue
        claims[b].append((j % n_buf, g * stage,
                          min(stage, n_bytes - g * stage)))
    return counter, claims


def _check_ring_claims(n_bytes, stage, n_buf, n_sm, turns=()):
    grid, per_sm = _cuda.ring_plan(n_bytes, stage, n_buf, n_sm)
    claim = _cuda.ring_claim(stage)
    assert claim * stage >= _cuda.RING_CLAIM_BYTES or claim == 1
    n_stages = -(-n_bytes // stage)
    assert 1 <= grid <= min(per_sm * n_sm, n_stages)
    counter, claims = _ring_claims(n_bytes, stage, n_buf, grid, claim, turns)
    # the claims tile [0, counter); the bound ring_plan checks holds
    assert counter % claim == 0 and n_stages <= counter
    assert counter < n_stages + (grid + 1) * claim
    copies = sorted((off, size) for c in claims for _, off, size in c)
    assert len(copies) == n_stages  # every stage claimed once
    assert copies[0][0] == 0
    assert all(a[0] + a[1] == b[0] for a, b in zip(copies, copies[1:]))
    assert copies[-1][0] + copies[-1][1] == n_bytes
    assert all(size > 0 and size % 16 == 0 and off % 16 == 0
               for off, size in copies)
    # a block's k-th stage sits in slot k % n_buf
    assert all(slot == k % n_buf for c in claims
               for k, (slot, _, _) in enumerate(c))
    return grid, per_sm, claims


@pytest.mark.parametrize("name", [n for n in tdm.VARIANTS
                                  if n.startswith("man")])
def test_ring_plan_fits_every_manual_variant(name):
    """P2's rings fit 227 KB a block, and as many blocks an SM as the
    228 KB of an SM holds (the occupancy calculator's count, checked on
    the card by tests/test_torch_cuda.py), enough loads in flight an SM
    to cover the latency; at least one block a stage and at most the
    stages, on the probe's plane and on fewer stages than blocks."""
    p = tdm.VARIANTS[name]().params
    stage = p["chunk_rows"] * tdm.STAGE_ROW_BYTES
    ring = p["n_buf"] * stage
    grid, per_sm = _cuda.ring_plan(2048 * 65536 * 4, stage, p["n_buf"],
                                   H100_SMS)
    assert per_sm == RING_BLOCKS[ring]
    assert ring + p["n_buf"] * _cuda.RING_SLOT_BYTES <= 227 * 1024
    assert per_sm * (ring + p["n_buf"] * _cuda.RING_SLOT_BYTES
                     + _cuda.BLOCK_RESERVED_SMEM) <= _cuda.SM_SMEM
    assert per_sm * _cuda.RING_THREADS <= _cuda.SM_THREADS
    assert per_sm * ring >= 64 * 1024 or per_sm == 1
    assert per_sm * ring >= LATENCY_BYTES
    assert grid == per_sm * H100_SMS
    for n_bytes in (16, stage, 5 * stage + 16, per_sm * H100_SMS * stage
                    - stage + 48):
        g, _ = _cuda.ring_plan(n_bytes, stage, p["n_buf"], H100_SMS)
        assert g == min(-(-n_bytes // stage), per_sm * H100_SMS) >= 1


@pytest.mark.parametrize("n_bytes,stage,n_buf,n_sm", [
    # the probe's plane at man16x4; one stage; one vector; fewer stages
    # than blocks, the last one short; one vector past a multiple of
    # stage x grid; a 128 KiB ring on a few SMs
    (2048 * 65536 * 4, 8192, 4, H100_SMS), (8192, 8192, 4, H100_SMS),
    (16, 8192, 4, H100_SMS), (37 * 8192 + 4000 - 4000 % 16, 8192, 4, 13),
    (3 * 6 * 4 * 4096 + 16, 4096, 8, 4), (40 * 65536 + 16, 65536, 2, 3)])
def test_ring_claims_cover_every_stage_once(n_bytes, stage, n_buf, n_sm):
    """Claimed round-robin, each stage goes to one claim and every byte
    to one bulk copy each way."""
    _check_ring_claims(n_bytes, stage, n_buf, n_sm)


@settings(max_examples=60, deadline=None, database=None)
@given(vecs=st.integers(1, 1 << 14), rows=st.sampled_from([1, 8, 16, 64]),
       row_bytes=st.sampled_from([16, 64, 512]),
       n_buf=st.sampled_from(_cuda.RING_DEPTHS), n_sm=st.integers(1, 40),
       turns=st.lists(st.integers(0, 1 << 10), max_size=400))
def test_ring_claims_any_size_any_order(vecs, rows, row_bytes, n_buf, n_sm,
                                        turns):
    """Whatever order the blocks claim in (a fast block taking many
    stages in a row, a slow one none), every stage is claimed once, every
    byte is copied once, and every block ends on its one claim past the
    last stage."""
    stage = rows * row_bytes
    assume(n_buf * stage <= _cuda.RING_SMEM)
    _check_ring_claims(16 * vecs, stage, n_buf, n_sm, turns)


def test_ring_plan_bounds_the_claim_counter():
    """Stages and blocks that pass the kernel's int32 claim counter are
    refused before the card is asked."""
    # stages of 16 B go 512 to a claim
    n = 2**31 - 1321 * 512 - 1
    assert _cuda.ring_plan(16 * n, 16, 2, H100_SMS)[0] == 1320
    with pytest.raises(ValueError, match="int32 claim counter"):
        _cuda.ring_plan(16 * (n + 1), 16, 2, H100_SMS)
