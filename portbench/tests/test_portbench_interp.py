"""The reader of ``interp_roofline.integrate``: declared for the
integrate cell alone, the interpolation kernel's bytes over its device
time by hand, and nothing to read where the kernel did not launch (a
program without it, or a run on the CPU)."""

from __future__ import annotations

import pytest

from conftest import bench
from portbench import harness

NAME = "interp_roofline.integrate"
INFO = {"particles": 1000, "grid": 8, "steps_per_call": 32}


def _trace(launches, ops):
    traced = [{"work": 1, "launches": launches}]
    plain = [{"work": 1, "metrics": {}}]
    return harness.Trace(traced, plain, 2.0, 2.0, 0.5, ops, INFO)


def test_declared_for_the_integrate_cell():
    m = {m["name"]: m for m in bench()["per_layer"]}[NAME]
    assert m["workloads"] == ["integrate.config4"]
    assert m["moves"] == "scan_updates_per_s" and m["layer"] == "kernels"
    assert NAME in {x["name"] for x in harness.find_cell(
        bench(), "integrate.config4").per_layer}
    for cell in ("track.config2", "scan.config2"):
        assert NAME not in {x["name"] for x in harness.find_cell(
            bench(), cell).per_layer}


def test_bytes_over_kernel_time_by_hand():
    """33 launches of 24 B a particle and 12 B a cell over the kernel's
    device seconds; other kernels' time is not the kernel's."""
    ops = {"void (anonymous namespace)::cic_interpolate_kernel(float "
           "const*, float const*, float*, long long, int, float)": 0.066,
           "void (anonymous namespace)::deposit_rows_kernel(int)": 0.009,
           "void at::native::index_elementwise_kernel": 0.5}
    got = harness.metric_reader(NAME).read(
        _trace({"cic_interpolate": 33, "deposit_sorted": 33}, ops))
    assert got == pytest.approx(
        100 * 33 * (24 * 1000 + 12 * 512) / 3.35e12 / 0.066)


@pytest.mark.parametrize("launches,ops", [
    ({"deposit_sorted": 33},
     {"void at::native::index_elementwise_kernel": 0.5}),
    ({}, {}),
])
def test_nothing_to_read_without_the_kernel(launches, ops):
    assert harness.metric_reader(NAME).read(_trace(launches, ops)) is None
