"""The plain references agree with the port at tiny sizes on the CPU;
the control (the reference in bfloat16 put in the program's place)
comes out not correct; and a run with the timed path broken underneath
comes out not correct, once for each fault a cell can have: a step that
returns its state unchanged, half of the batch left out, and an answer
altered where it is produced.  (No cell spans chips, so none can leave
out an exchange between them.)  The control at each cell's own size runs
on the card (``test_control_fails_at_full_size``)."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import CELLS, run_module, tiny_spec
from portbench import harness

RUN = run_module()


def run_cpu(cell, seed=2 ** 31 + 99, seconds=0.3):
    code, result = RUN.execute(tiny_spec(cell), seed, seconds, 0,
                               device="cpu", t_start=time.perf_counter())
    assert code == 0
    return result


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 99, 12345])
def test_port_agrees_with_reference(cell, seed):
    result = run_cpu(cell, seed)
    assert result["correct"], result["limits"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "limits"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    spec = tiny_spec(cell)
    mod = harness.entry_module(spec.traffic)
    c = mod.Cell(spec.config, spec.traffic, 2 ** 31 + 7, "cpu")
    c.setup()
    correct, limits = harness.judge(c.control(), spec.traffic["limits"])
    assert not correct, limits


# ---------------------------------------------------------------- faults

def _aligned_wrapper(fault):
    """A factory wrapping the port's aligned step with ``fault``."""
    from orbitanalysis_tpu_torch.ops import sorted_step

    real = sorted_step.make_aligned_native_step

    def make(*a, **k):
        step = real(*a, **k)

        def broken(carry, snap):
            return fault(step, carry, snap)

        return broken

    return make


def _unchanged(step, carry, snap):
    _, events = step(carry, snap)
    return carry, events


def _half_batch(step, carry, snap):
    h = snap.ids.shape[0]
    ids = snap.ids.clone()
    ids[h // 2:] = torch.iinfo(ids.dtype).max
    return step(carry, snap._replace(ids=ids))


def _altered(step, carry, snap):
    carry, events = step(carry, snap)
    angles = events.angles.clone()
    angles[0, 0] = angles[0, 0] + 0.5
    return carry, events._replace(angles=angles)


ALIGNED_FAULTS = {"unchanged": _unchanged, "half": _half_batch,
                  "altered": _altered}


@pytest.mark.parametrize("fault", sorted(ALIGNED_FAULTS))
@pytest.mark.parametrize("cell", ["track.config2", "scan.config2"])
def test_aligned_fault_is_not_correct(cell, fault, monkeypatch):
    from orbitanalysis_tpu_torch.engine import tracker
    from orbitanalysis_tpu_torch.ops import sorted_step

    make = _aligned_wrapper(ALIGNED_FAULTS[fault])
    monkeypatch.setattr(tracker, "make_aligned_native_step", make)
    monkeypatch.setattr(sorted_step, "make_aligned_native_step", make)
    assert not run_cpu(cell)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_full_size(cell, card):
    """The control at the cell's own size on the card (three seeds)."""
    from conftest import bench

    spec = harness.find_cell(bench(), cell)
    mod = harness.entry_module(spec.traffic)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        c = mod.Cell(spec.config, spec.traffic, seed, card)
        c.setup()
        correct, limits = harness.judge(c.control(), spec.traffic["limits"])
        assert not correct, limits
        del c
        torch.cuda.empty_cache()
