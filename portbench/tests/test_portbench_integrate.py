"""Config 4's cell, ``integrate.config4``, at a tiny size on the CPU: the
harness finds it and its readers by name, its work and byte counts match
hand counts, the port agrees with the plain float64 reference
(``portbench/reference/nbody.py``), the bfloat16 control and planted
faults come out not correct, and no run loads JAX.  The control at the
cell's own size runs on the card (``test_control_fails_at_full_size``).
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, bench, run_module
from portbench import harness, layers_nbody

CELL = "integrate.config4"
#: The per-layer metrics of the cell.
READERS = ("issue_ms.integrate", "force_device_ms.integrate",
           "detect_device_ms.integrate", "deposit_roofline.integrate",
           "idle_share.integrate")
#: Config 4 at a tiny size: 8 rows of 2,048 on 32^3 (box, time step,
#: steps and cadence as configured).
TINY_CONFIG = dict(particles=8 * 2048, rows=8, row=2048, grid=32)
TINY_TRAFFIC = dict(states=2, check_calls=2, trace_calls=1)

RUN = run_module()


def tiny_spec() -> harness.CellSpec:
    spec = harness.find_cell(bench(), CELL)
    return spec._replace(config=dict(spec.config, **TINY_CONFIG),
                         traffic=dict(spec.traffic, **TINY_TRAFFIC))


def run_cpu(seed=2 ** 31 + 99, seconds=0.3):
    code, result = RUN.execute(tiny_spec(), seed, seconds, 0, device="cpu",
                               t_start=time.perf_counter())
    assert code == 0
    return result


def test_cell_and_readers_found_by_name():
    spec = harness.find_cell(bench(), CELL)
    assert spec.chips == 1
    assert spec.config["name"] == "config4" and spec.config["reduced"] == []
    assert spec.config["rows"] * spec.config["row"] == \
        spec.config["particles"]
    assert hasattr(harness.entry_module(spec.traffic), "Cell")
    assert {m["name"] for m in spec.end_to_end} == {"scan_updates_per_s",
                                                    "setup_s"}
    assert spec.traffic["report"] == {"scan_updates_per_s": "rate"}
    assert {m["name"] for m in spec.per_layer} == set(READERS)
    for m in spec.per_layer:
        assert m["workloads"] == [CELL]
        assert m["moves"] == "scan_updates_per_s"
        assert callable(harness.metric_reader(m["name"]).read)
    assert set(spec.traffic["limits"]) == {"pos_gap", "vel_gap",
                                           "count_mismatch", "event_gap"}
    # config 2's cells report none of config 4's readers
    for cell in ("track.config2", "scan.config2"):
        names = {m["name"] for m in harness.find_cell(bench(), cell)
                 .per_layer}
        assert not names & set(READERS)


def test_work_and_bytes_match_hand_counts():
    spec = tiny_spec()
    mod = harness.entry_module(spec.traffic)
    cell = mod.Cell(spec.config, spec.traffic, 7, "cpu")
    cell.setup()
    assert cell.call(0)["work"] == 8 * 2048 * 32
    assert cell.layer_info() == {"particles": 8 * 2048, "grid": 32,
                                 "steps_per_call": 32}
    # K13: 20 B an entry, 4 B a virtual cell of (grid + 1)^3
    assert layers_nbody.k13_bytes(100, 8) == 2000 + 4 * 729
    assert layers_nbody.k13_bytes(12582912, 256) == \
        20 * 12582912 + 4 * 257 ** 3


def test_readers_read_the_entry_calls():
    """The host readers read the traced entry's own calls; the device
    readers find nothing to read on the CPU, and nothing on calls
    without the program's metrics (a program without them)."""
    spec = tiny_spec()
    mod = harness.entry_module(spec.traffic)
    cell = mod.Cell(spec.config, spec.traffic, 9, "cpu")
    cell.setup()
    cell.traced = True
    calls = [cell.call(i) for i in range(2)]
    for c in calls:
        assert c["metrics"]["force_evals"] == 33
        assert c["metrics"]["detections"] == 5
    trace = harness.Trace(calls, calls, 1.0, 1.0, 0.0, {},
                          cell.layer_info())
    want = 1e3 * sum(c["metrics"]["step_s"] for c in calls) / (2 * 32)
    got = harness.metric_reader("issue_ms.integrate").read(trace)
    assert got == pytest.approx(want) and got > 0
    for name in ("force_device_ms.integrate", "detect_device_ms.integrate",
                 "deposit_roofline.integrate", "idle_share.integrate"):
        assert harness.metric_reader(name).read(trace) is None, name
    bare = [{"work": 1, "latency_s": 1.0, "host_s": 0.5}]
    trace = harness.Trace(bare, bare, 1.0, 1.0, 0.0, {}, cell.layer_info())
    for name in READERS:
        assert harness.metric_reader(name).read(trace) is None, name


def test_device_readers_by_hand():
    """Each device reader on hand-made calls: the stretches over their
    counts, K13's bytes over its kernels' seconds."""
    m = [{"force_device_s": 0.33, "force_evals": 33,
          "detect_device_s": 0.05, "detections": 5, "step_s": 0.64},
         {"force_device_s": 0.30, "force_evals": 33,
          "detect_device_s": 0.04, "detections": 5, "step_s": 0.32}]
    plain = [{"work": 1, "metrics": x} for x in m]
    traced = [{"work": 1, "launches": {"deposit_sorted": 33}}]
    ops = {"void (anonymous namespace)::row_bounds_kernel(int)": 0.001,
           "void (anonymous namespace)::deposit_rows_kernel(int)": 0.009,
           "void at::native::elementwise_kernel": 0.5}
    info = {"particles": 1000, "grid": 8, "steps_per_call": 32}
    trace = harness.Trace(traced, plain, 2.0, 2.0, 0.5, ops, info)

    def read(name):
        return harness.metric_reader(name).read(trace)

    assert read("force_device_ms.integrate") == pytest.approx(
        1e3 * 0.63 / 66)
    assert read("detect_device_ms.integrate") == pytest.approx(
        1e3 * 0.09 / 10)
    assert read("issue_ms.integrate") == pytest.approx(1e3 * 0.96 / 64)
    assert read("deposit_roofline.integrate") == pytest.approx(
        100 * 33 * (20 * 1000 + 4 * 729) / 3.35e12 / 0.010)
    assert read("idle_share.integrate") == pytest.approx(75.0)


@pytest.mark.parametrize("seed", [2 ** 31 + 99, 12345])
def test_port_agrees_with_reference(seed):
    result = run_cpu(seed)
    assert result["correct"], result["limits"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "limits"


def test_control_fails():
    spec = tiny_spec()
    mod = harness.entry_module(spec.traffic)
    c = mod.Cell(spec.config, spec.traffic, 2 ** 31 + 7, "cpu")
    c.setup()
    correct, limits = harness.judge(c.control(), spec.traffic["limits"])
    assert not correct, limits


# ---------------------------------------------------------------- faults

def _acos_turn(a, b):
    """The parent's turn: float32 ``acos`` of the dot product."""
    cos = (a * b).sum(-1)
    return torch.acos(torch.clamp(cos, -1.0, 1.0))


def _dropped_detection(monkeypatch):
    """Every call's second detection after the seed leaves the track as
    it was and reports no event."""
    from orbitanalysis_tpu_torch.models import nbody

    real = nbody._apsis_update
    seen = {"n": 0}

    def update(track, rhat, vrad, valid, mode, angle_cut):
        seen["n"] += 1
        new, apsis = real(track, rhat, vrad, valid, mode, angle_cut)
        if seen["n"] % 5 == 3:
            return track, torch.zeros_like(apsis)
        return new, apsis

    monkeypatch.setattr(nbody, "_apsis_update", update)


def _unchanged_state(monkeypatch):
    from orbitanalysis_tpu_torch.models import nbody

    real = nbody.kdk_step

    def step(state, acc, *a, **k):
        _, acc_new = real(state, acc, *a, **k)
        return state, acc_new

    monkeypatch.setattr(nbody, "kdk_step", step)


def _half_forces(monkeypatch):
    from orbitanalysis_tpu_torch.models import pm

    real = pm.pm_forces

    def forces(pos, *a, **k):
        acc = real(pos, *a, **k).clone()
        acc[pos.shape[0] // 2:] = 0
        return acc

    monkeypatch.setattr(pm, "pm_forces", forces)


def _acos(monkeypatch):
    from orbitanalysis_tpu_torch.models import nbody

    monkeypatch.setattr(nbody, "turn_angle", _acos_turn)


FAULTS = {"acos": _acos, "dropped_detection": _dropped_detection,
          "unchanged_state": _unchanged_state, "half_forces": _half_forces}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = run_cpu()
    assert not result["correct"], result["limits"]
    if fault == "acos":
        # the parent's turn loses about half the counts of the events
        assert result["limits"]["count_mismatch"]["value"] > \
            result["limits"]["count_mismatch"]["limit"]


def test_gaps_by_hand():
    """``compare_nbody.call_numbers`` on a hand-made call: a position
    across the box's seam is 0.5 away, not 99.5; an event on a step
    without a detection makes ``event_gap`` infinite."""
    from portbench import compare_nbody
    from portbench.reference.nbody import Result

    ref = Result(pos=torch.tensor([[0.25, 50.0, 50.0]], dtype=torch.float64),
                 vel=torch.zeros(1, 3, dtype=torch.float64),
                 counts=torch.tensor([1]), events=[4, 2])
    ev = torch.tensor([0, 3, 0, 2])
    got = compare_nbody.call_numbers(
        torch.tensor([[99.75, 50.0, 50.0]]), torch.full((1, 3), 0.125),
        torch.tensor([[2]]), ev, ref, 100.0, 2)
    assert got == {"pos_gap": 0.5, "vel_gap": 0.125, "count_mismatch": 1.0,
                   "event_gap": 0.25}
    got = compare_nbody.call_numbers(
        torch.tensor([[0.25, 50.0, 50.0]]), torch.zeros(1, 3),
        torch.tensor([[1]]), torch.tensor([1, 4, 0, 2]), ref, 100.0, 2)
    assert math.isinf(got["event_gap"]) and got["pos_gap"] == 0.0


def test_nothing_the_cell_runs_loads_jax():
    code = f"""
import sys, time
sys.path[:0] = [{os.path.join(ROOT, 'portbench', 'tests')!r}, {ROOT!r}]
from test_portbench_integrate import tiny_spec, RUN
code, result = RUN.execute(tiny_spec(), 5, 0.2, 0, device="cpu",
                           t_start=time.perf_counter())
assert code == 0 and result["correct"], result
print(' '.join(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(out.stdout.split())
    assert "orbitanalysis_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.cuda
def test_control_fails_at_full_size(card):
    """The control at the cell's own size on the card (three seeds)."""
    spec = harness.find_cell(bench(), CELL)
    mod = harness.entry_module(spec.traffic)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        c = mod.Cell(spec.config, dict(spec.traffic, states=1), seed, card)
        c.setup()
        correct, limits = harness.judge(c.control(), spec.traffic["limits"])
        assert not correct, limits
        del c
        torch.cuda.empty_cache()
