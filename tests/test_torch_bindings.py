"""The ctypes bindings of the port's CUDA library (``ops/_cuda.py``)
against the C entry points of ``csrc/*.cu``, read from the sources: no
compiler is needed, so this runs on any machine.  A binding whose
argument list drifts from its entry point passes the wrong values to a
kernel, which only the card would show."""

import ctypes
import glob
import os
import re
import types

import pytest

from orbitanalysis_tpu_torch.ops import _cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: The ctypes type ``bind`` must give each C parameter type.
C_TYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "const void* const*": ctypes.POINTER(ctypes.c_void_p),
    "void* const*": ctypes.POINTER(ctypes.c_void_p),
    "int": ctypes.c_int,
    "int*": ctypes.POINTER(ctypes.c_int),
    "long long": ctypes.c_longlong,
    "float": ctypes.c_float,
}


def _entry_points():
    """``{name: (source, result type, [parameter types])}`` of every
    ``extern "C"`` function of ``csrc/*.cu``."""
    out = {}
    for path in sorted(glob.glob(os.path.join(_cuda.CSRC, "*.cu"))):
        with open(path) as f:
            src = f.read()
        for m in re.finditer(r'extern "C" (int|long long) (\w+)\(([^)]*)\)',
                             src):
            params = [re.sub(r"\s*\w+$", "", " ".join(p.split()))
                      for p in m.group(3).split(",")]
            out[m.group(2)] = (os.path.basename(path), m.group(1), params)
    return out


class _FakeLib:
    """Takes ``bind``'s argtypes and restype for any name."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


ENTRY_POINTS = _entry_points()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_binding_matches_entry_point(name):
    _, result, params = ENTRY_POINTS[name]
    fn = getattr(_cuda.bind(_FakeLib()), name)
    assert fn.argtypes == [C_TYPES[p] for p in params]
    assert fn.restype == (ctypes.c_longlong if result == "long long"
                          else ctypes.c_int)


def test_every_kernel_is_an_entry_point_of_its_source():
    for name, k in _cuda.KERNELS.items():
        assert ENTRY_POINTS[name][0] == os.path.basename(k.source)
        assert os.path.exists(os.path.join(REPO, k.source))


def test_fused_chain_kernels_name_the_jax_chain():
    """The aligned step's fused kernels replace no Pallas kernel: their
    record names the two JAX functions XLA fuses on the TPU."""
    for name in ("aligned_moments", "aligned_frame_detect"):
        k = _cuda.KERNELS[name]
        assert k.source == "orbitanalysis_tpu_torch/csrc/static.cu"
        sites = re.findall(r"(orbitanalysis_tpu/ops/\w+\.py):(\d+) (\w+)",
                           k.replaces)
        assert [s[2] for s in sites] == ["region_frame",
                                         "aligned_detect_math"]
        for path, line, fn in sites:
            with open(os.path.join(REPO, path)) as f:
                assert f"def {fn}(" in f.read().splitlines()[int(line) - 1]


def test_interpolation_kernel_names_the_jax_function():
    """The PM force's interpolation kernel replaces no Pallas kernel: its
    record names the JAX function whose gathers XLA fuses on the TPU."""
    k = _cuda.KERNELS["cic_interpolate"]
    assert k.source == "orbitanalysis_tpu_torch/csrc/interp.cu"
    (path, line, fn), = re.findall(
        r"(orbitanalysis_tpu/models/\w+\.py):(\d+) (\w+)", k.replaces)
    assert fn == "cic_interpolate"
    with open(os.path.join(REPO, path)) as f:
        assert f"def {fn}(" in f.read().splitlines()[int(line) - 1]
