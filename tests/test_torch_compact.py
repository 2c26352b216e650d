"""The port's event compaction (orbitanalysis_tpu_torch.ops.compact) and
the bit-exact helpers of the aligned step, against the JAX package.

The plain-torch twins run here on the CPU; the JAX kernels run in
interpret mode, as tests/test_pallas_compact.py runs them.  Inputs come
from seeded NumPy and reach both packages as the same bits.  The CUDA
kernels are compared with these twins on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbitanalysis_tpu.ops import pallas_compact as jc
from orbitanalysis_tpu.ops.pallas_label import f16_bits_rne as jax_f16
from orbitanalysis_tpu.ops.pallas_step import _acos_f32 as jax_acos
from orbitanalysis_tpu.ops.sorted_step import _vr_bits as jax_vr_bits
from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.ops import compact as tc
from orbitanalysis_tpu_torch.ops.sorted_step import _acos_f32, _vr_bits

torch.set_num_threads(1)

SHAPES = [(3, 256, 128), (4, 1024, 128), (2, 4096, 512)]
DENSITIES = [0.0, 0.017, 0.07, 0.5, 1.0]
#: Rows that are not a multiple of the angle kernel's tile of 4096 words
#: (``csrc/compact.cu`` kTileWords): one tile and a part, two and a part.
ANGLE_EDGE_SHAPES = [(2, 4096 + 128, 256), (2, 2 * 4096 + 640, 512)]


def _i32(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


def _angle_words(rng, h, p, density):
    ang = rng.uniform(0.0, 7.0, (h, p)).astype(np.float32)
    sel = rng.random((h, p)) < density
    return ang.view(np.uint32) | (sel.astype(np.uint32) << np.uint32(31)), sel


def _assert_front_packed(got, want, counts):
    """Entries below each row's count equal; the twin zero-fills the
    rest (the JAX kernels leave it unspecified)."""
    assert got.shape == want.shape
    for r, n in enumerate(np.minimum(counts, got.shape[1])):
        np.testing.assert_array_equal(got[r, :n], want[r, :n], err_msg=r)
        assert (got[r, n:] == 0).all(), r


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("h,p,k", SHAPES + ANGLE_EDGE_SHAPES)
def test_angle_twin_matches_jax(h, p, k, density):
    rng = np.random.default_rng(int(density * 1000) + p)
    aw, sel = _angle_words(rng, h, p, density)
    want = np.asarray(jc.compact_angle_blocked(jnp.asarray(aw), k))
    got = _u32(tc.compact_angle_blocked(_i32(aw), k))
    _assert_front_packed(got, want, sel.sum(axis=1))


@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("h,p,k", SHAPES)
def test_pair_twin_matches_jax(h, p, k, density):
    rng = np.random.default_rng(int(density * 1000) + p + 1)
    sel = rng.random((h, p)) < density
    pos = np.broadcast_to(np.arange(p, dtype=np.uint32), (h, p))
    posw = np.where(sel, pos + 1, np.uint32(0))
    angw = np.where(sel, rng.integers(0, 0x7BFF, (h, p)).astype(np.uint32),
                    np.uint32(0))
    want_p, want_a = jc.compact_payload_pair(
        jnp.asarray(posw), jnp.asarray(angw), k)
    got_p, got_a = tc.compact_payload_pair(_i32(posw), _i32(angw), k)
    _assert_front_packed(_u32(got_p), np.asarray(want_p), sel.sum(axis=1))
    _assert_front_packed(_u32(got_a), np.asarray(want_a), sel.sum(axis=1))


#: Rows of one halo past PAYLOAD_MAX_ROW, as the aligned step sends them
#: to the pair compaction (K3): one tile of lanes past it, and 1 << 18.
WIDE_PAIR_ROWS = [131200, 1 << 18]


@pytest.mark.parametrize("density", [0.0, 0.03, 0.5])
@pytest.mark.parametrize("p", WIDE_PAIR_ROWS)
def test_pair_twin_wide_rows_match_jax(p, density):
    """K3's plain version against JAX at H = 1 on wide rows: bursts of
    events across 4096-word boundaries (the first, the third and the
    middle of the row), an event at the last position, and at densities
    0.03 and 0.5 more events than the capacity keeps."""
    rng = np.random.default_rng(p + int(density * 100))
    sel = rng.random((1, p)) < density
    for edge in (4096, 3 * 4096, p // 2 // 4096 * 4096):
        sel[0, edge - 150:edge + 100] = True
    sel[0, p - 1] = True
    posw = np.where(sel, np.arange(p, dtype=np.uint32) + 1, np.uint32(0))
    angw = np.where(sel, rng.integers(0, 0x7BFF, (1, p)).astype(np.uint32),
                    np.uint32(0))
    want_p, want_a = jc.compact_payload_pair(
        jnp.asarray(posw), jnp.asarray(angw), 4096)
    got_p, got_a = tc.compact_payload_pair(_i32(posw), _i32(angw), 4096)
    counts = sel.sum(axis=1)
    assert (counts > 4096) == (density > 0)
    _assert_front_packed(_u32(got_p), np.asarray(want_p), counts)
    _assert_front_packed(_u32(got_a), np.asarray(want_a), counts)


def test_angle_twin_clustered_block_matches_jax():
    """More than BLOCK_CAP (16) events in one 128-entry block: the JAX
    entry reroutes to its exact single-stage kernel (K2) here; the twin
    (like the CUDA kernel) has no occupancy limit."""
    p = 2048
    ang = np.linspace(0.0, 3.0, 2 * p, dtype=np.float32).reshape(2, p)
    sel = np.zeros((2, p), bool)
    sel[0, 300:340] = True      # 40 events in one block
    sel[1, ::512] = True
    sel[1, 1920:1984] = True    # a second clustered block
    aw = ang.view(np.uint32) | (sel.astype(np.uint32) << np.uint32(31))
    assert jc.BLOCK_CAP < 40
    want = np.asarray(jc.compact_angle_blocked(jnp.asarray(aw), 256))
    got = _u32(tc.compact_angle_blocked(_i32(aw), 256))
    _assert_front_packed(got, want, sel.sum(axis=1))


def test_pair_twin_last_position_131072():
    """An event at position 131071 of a 131072-wide row (pos + 1 = 2**17,
    beyond the single-word payload) survives the pair compaction."""
    p = 1 << 17
    posw = np.zeros((1, p), np.uint32)
    angw = np.zeros((1, p), np.uint32)
    posw[0, [7, p - 1]] = [8, p]
    angw[0, [7, p - 1]] = [3, 0x7ABC]
    want_p, want_a = jc.compact_payload_pair(
        jnp.asarray(posw), jnp.asarray(angw), 128)
    got_p, got_a = tc.compact_payload_pair(_i32(posw), _i32(angw), 128)
    _assert_front_packed(_u32(got_p), np.asarray(want_p), [2])
    _assert_front_packed(_u32(got_a), np.asarray(want_a), [2])
    np.testing.assert_array_equal(_u32(got_p)[0, :2], [8, p])


def test_single_word_rejects_overwide_rows():
    assert tc.PAYLOAD_MAX_ROW == jc.PAYLOAD_MAX_ROW == (1 << 17) - 1
    with pytest.raises(ValueError, match="compact_payload_pair"):
        tc.compact_angle_blocked(torch.zeros((1, 1 << 17), dtype=torch.int32),
                                 128)
    with pytest.raises(ValueError, match="multiple of 128"):
        tc.compact_payload_pair(torch.zeros((1, 200), dtype=torch.int32),
                                torch.zeros((1, 200), dtype=torch.int32), 128)


def test_wrapper_takes_twin_only_for_cpu_tensors():
    """No device other than CPU (twin) and CUDA (kernel) is served."""
    aw = torch.zeros((1, 256), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no compaction kernel"):
        tc.compact_angle_blocked(aw, 128)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails makes the build raise with its exit code;
    nothing falls back, and no library is left behind."""
    import shutil

    monkeypatch.setattr(_cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_cuda, "_nvcc", lambda: shutil.which("false"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _cuda.build()
    assert not any(f.endswith(".so") for f in map(str, tmp_path.iterdir()))


_F16_CASES = np.array(
    [
        0.0, 2.0**-25, 2.0**-24, 3 * 2.0**-25, 1e-6, 5.9e-5, 6.0e-5,
        np.nextafter(np.float32(2.0**-14), np.float32(0)), 2.0**-14,
        np.nextafter(np.float32(2.0**-14), np.float32(1)),
        0.1, 1.0, 1.0009765625, 1.00048828125, np.pi, 1000.5,
        65504.0, 65519.0, 65520.0, 1e30,
    ],
    dtype=np.float32,
)


def test_f16_bits_rne_matches_jax():
    got = tc.f16_bits_rne(torch.from_numpy(_F16_CASES)).numpy()
    want = np.asarray(jax_f16(jnp.asarray(_F16_CASES))).astype(np.int64)
    np.testing.assert_array_equal(got, want)
    # below the clamp both agree with IEEE float16 rounding
    below = _F16_CASES < 65520
    np.testing.assert_array_equal(
        got[below],
        _F16_CASES[below].astype(np.float16).view(np.uint16).astype(np.int64),
    )


def test_f16_clamp_where_numpy_rounds_to_inf():
    """At 65520 the JAX kernel encode clamps to 0x7BFF while the JAX
    tracker's overflow recovery (numpy astype) gives inf: the JAX
    package disagrees with itself there.  The port clamps everywhere."""
    x = np.float32(65520.0)
    assert int(np.asarray(jax_f16(jnp.asarray([x])))[0]) == 0x7BFF
    with np.errstate(over="ignore"):
        assert np.array([x]).astype(np.float16).view(np.uint16)[0] == 0x7C00
    assert int(tc.f16_bits_rne(torch.tensor([65520.0, np.inf]))[0]) == 0x7BFF
    assert int(tc.f16_bits_rne(torch.tensor([np.inf]))[0]) == 0x7BFF


def test_f16_bits_rne_nan_lanes_defined():
    nans = np.array([np.nan, -np.nan], np.float32)
    nans[1] = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
    a = tc.f16_bits_rne(torch.from_numpy(nans)).numpy()
    b = tc.f16_bits_rne(torch.from_numpy(nans)).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, [0x7BFF, 0])


def test_acos_f32_within_two_ulp_of_jax():
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.uniform(-1, 1, 20000), [-1.0, -0.5, 0.0, 0.5, 1.0],
        np.nextafter(np.float32(0.5), np.float32([0, 1])),
    ]).astype(np.float32)
    got = _acos_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_acos(jnp.asarray(x)))
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= 2 * ulp)


def test_vr_bits_exact():
    v = np.array([-2.0, -0.0, 0.0, 1e-30, -1e-30, 3.0, np.inf, -np.inf],
                 np.float32)
    got = _vr_bits(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_vr_bits(jnp.asarray(v))))
