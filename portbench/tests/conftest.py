"""Fixtures of the benchmark's own tests: the cells at tiny sizes on the
CPU, and the card for the tests marked ``cuda``.

    python -m pytest portbench/tests -q -p no:cacheprovider

Tests marked ``cuda`` (the control on the card) skip without one; on the
card's machine they run with the same command.
"""

from __future__ import annotations

import importlib.util
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

#: Tiny sizes of each configuration and traffic mix, for the CPU.
TINY_CONFIG = {
    "config2": dict(halos=6, pool=500, snapshots=6),
}
TINY_TRAFFIC = {
    # the tracker's 'auto' picks the aligned engine on the card only
    "track": dict(join_impl="aligned"),
    "scan": dict(capacity=512, event_capacity=128),
}
CELLS = ("track.config2", "scan.config2")


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def tiny_spec(cell: str) -> harness.CellSpec:
    spec = harness.find_cell(bench(), cell)
    w = {x["name"]: x for x in bench()["workloads"]}[cell]
    config = dict(spec.config, **TINY_CONFIG.get(w["config"], {}))
    traffic = dict(spec.traffic, **TINY_TRAFFIC.get(w["traffic"], {}))
    return spec._replace(config=config, traffic=traffic)


def run_module():
    spec = importlib.util.spec_from_file_location(
        "portbench_run", os.path.join(ROOT, "portbench", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def card():
    """The card, decided when the test runs (never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return "cuda"
