"""The bench64 cells, ``scan.bench64`` and ``label.bench64``, at a tiny
size on the CPU: the harness finds both cells, their files and their
readers by name (the scan cell reads the scan readers; the label cell
reads its own four, which apply to it alone and read hand-made calls),
the byte counts match hand counts, both cells come out correct against
their plain references, the controls and a planted fault do not, and no
run loads JAX.  The controls at the cells' own size run on the card
(``test_controls_fail_at_full_size``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, bench, run_module
from portbench import harness, layers, layers_label

CELLS = ("scan.bench64", "label.bench64")
#: The per-layer metrics of the label cell.
READERS = ("issue_ms.label", "step_device_ms.label", "label_roofline.label",
           "idle_share.label")
#: The scan readers, which read the scan entry of either configuration.
SCAN_READERS = ("issue_ms.scan", "step_roofline.scan",
                "compact_roofline.scan", "idle_share.scan")
#: bench64 at a tiny size: 4 halos of 512 over 8 snapshots, rows of one
#: halo, K 128.
TINY_CONFIG = dict(halos=4, pool=512, snapshots=8)
TINY_TRAFFIC = {"scan64": dict(capacity=512, event_capacity=128,
                               check_calls=2),
                "label": dict(row_width=512, event_capacity=128,
                              check_calls=2)}

RUN = run_module()


def tiny_spec(cell) -> harness.CellSpec:
    spec = harness.find_cell(bench(), cell)
    w = {x["name"]: x for x in bench()["workloads"]}[cell]
    return spec._replace(config=dict(spec.config, **TINY_CONFIG),
                         traffic=dict(spec.traffic,
                                      **TINY_TRAFFIC[w["traffic"]]))


def tiny_cell(cell, seed=7):
    spec = tiny_spec(cell)
    c = harness.entry_module(spec.traffic).Cell(spec.config, spec.traffic,
                                                seed, "cpu")
    c.setup()
    return spec, c


def run_cpu(cell, seed=2 ** 31 + 99, seconds=0.3):
    code, result = RUN.execute(tiny_spec(cell), seed, seconds, 0,
                               device="cpu", t_start=time.perf_counter())
    assert code == 0
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_cells_and_files_found_by_name(cell):
    spec = harness.find_cell(bench(), cell)
    assert spec.chips == 1
    assert spec.config["name"] == "bench64" and spec.config["reduced"] == []
    assert (spec.config["halos"], spec.config["pool"],
            spec.config["snapshots"]) == (64, 32768, 48)
    assert hasattr(harness.entry_module(spec.traffic), "Cell")
    assert {m["name"] for m in spec.end_to_end} == {"scan_updates_per_s",
                                                    "setup_s"}
    assert spec.traffic["report"] == {"scan_updates_per_s": "rate"}
    assert spec.traffic["event_capacity"] == 2048
    assert set(spec.traffic["limits"]) == {"event_mismatch",
                                           "angle_mismatch", "layout_faults"}
    assert spec.traffic["limits"]["layout_faults"] == 0
    names = {m["name"] for m in spec.per_layer}
    assert names == (set(READERS) if cell == "label.bench64"
                     else set(SCAN_READERS))


def test_readers_apply_to_the_label_cell_alone():
    metrics = {m["name"]: m for m in bench()["per_layer"]}
    for name in READERS:
        m = metrics[name]
        assert m["workloads"] == ["label.bench64"]
        assert m["moves"] == "scan_updates_per_s"
        assert callable(harness.metric_reader(name).read)
    for w in bench()["workloads"]:
        if w["name"] != "label.bench64":
            spec = harness.find_cell(bench(), w["name"])
            assert not {m["name"] for m in spec.per_layer} & set(READERS)


def test_work_and_layer_info_match_hand_counts():
    for cell in CELLS:
        _, c = tiny_cell(cell)
        want = sum(int(s.counts.sum()) for s in c.seq.snaps[1:])
        assert c.call(0)["work"] == want
    _, c = tiny_cell("label.bench64")
    assert c.layer_info() == {"steps_per_call": 8, "halos": 4,
                              "particles": 2048, "rows": 4,
                              "row_width": 512, "event_capacity": 128}
    # the label form: position h * 512 + c holds halo h's slot c
    s = c.seq.snaps[2]
    at = (s.ids // 10 ** 6) * 512 + s.ids % 10 ** 6
    assert int((c.label[2] >= 0).sum()) == len(s.ids)
    assert torch.equal(c.label[2][torch.as_tensor(at)].long(),
                       torch.as_tensor(s.ids // 10 ** 6))
    assert torch.equal(c.mass[2][torch.as_tensor(at)],
                       torch.as_tensor(s.mass))
    assert torch.equal(c.ids[torch.as_tensor(at)], torch.as_tensor(s.ids))


def test_byte_counts_match_hand_counts():
    # K7: label 4, velocity 12, mass 4 a particle, [H, 4] f32 out
    assert layers_label.k7_bytes(2097152, 64) == 20 * 2097152 + 64 * 16
    # K6: label 4 in, rows 24 out a particle, the [H, 6] table in
    assert layers_label.k6_bytes(2097152, 64) == 28 * 2097152 + 64 * 24
    # K8 at f32 r-hat: 92 B a particle, 2048 event words and a count a row
    assert layers_label.detect_bytes() == 92
    assert layers_label.detect_bytes(rhat_packed=True) == 76
    assert layers_label.k8_bytes(2097152, 64, 2048) == \
        92 * 2097152 + 64 * 2048 * 4 + 64 * 4
    assert layers_label.k9_bytes(100, 2) == 96 * 100 + 8
    assert layers_label.k10_bytes(100, 2, 3) == 72 * 100 + 8 + 72
    assert layers_label.k4_bytes(2, 256, 128) == 2 * 256 * 4 + 2 * 128 * 4
    info = dict(particles=2097152, halos=64, rows=64, row_width=32768,
                event_capacity=2048)
    step = sum(layers_label.launch_bytes(k, info) for k in
               ("segment_moments", "frame_rows",
                "detect_label_compact_rows"))
    assert step == 140 * 2097152 + 64 * 16 + 64 * 24 + 64 * 2048 * 4 + \
        64 * 4


def _call(step_s, steps, device_s=None, launches=None):
    m = {"step_s": step_s, "label_steps": steps, "label_updates": 10,
         "label_events": 3}
    if device_s is not None:
        m["label_device_s"] = device_s
    return {"work": 1, "latency_s": 1.0, "host_s": step_s, "metrics": m,
            "launches": launches or {}}


def test_readers_by_hand():
    info = dict(particles=2097152, halos=64, rows=64, row_width=32768,
                event_capacity=2048, steps_per_call=48)
    launches = {"segment_moments": 48, "frame_rows": 48,
                "detect_label_compact_rows": 48}
    calls = [_call(0.024, 48, 0.0072, launches),
             _call(0.030, 48, 0.0060, launches)]
    ops = {"void (anonymous namespace)::segment_moments_partial_kernel(int)":
           0.001, "void (anonymous namespace)::segment_moments_final_kernel"
           "(double)": 0.0002, "(anonymous namespace)::frame_rows_kernel":
           0.0024, "void (anonymous namespace)::detect_label_compact_kernel"
           "<false>(DetectArgs)": 0.0074, "aten::copy_ elementwise": 0.5,
           "void compact_tiles_kernel<AngleWords>": 0.25}
    trace = harness.Trace(calls, calls, 1.0, 1.0, 0.4, ops, info)
    read = {n: harness.metric_reader(n).read(trace) for n in READERS}
    assert read["issue_ms.label"] == pytest.approx(1e3 * 0.054 / 96)
    assert read["step_device_ms.label"] == pytest.approx(1e3 * 0.0132 / 96)
    n_bytes = 96 * sum(layers_label.launch_bytes(k, info) for k in launches)
    assert read["label_roofline.label"] == pytest.approx(
        100.0 * n_bytes / layers.PEAK_BYTES / 0.011)
    assert read["idle_share.label"] == pytest.approx(60.0)


def test_readers_without_the_programs_numbers_give_none():
    """Calls without the program's metrics or launches (a program that
    does not write them, or the CPU) give no value."""
    _, c = tiny_cell("label.bench64")
    c.traced = True
    calls = [c.call(i) for i in range(2)]
    for m in (x["metrics"] for x in calls):
        assert m["label_steps"] == 8 and "label_device_s" not in m
    trace = harness.Trace(calls, calls, 1.0, 1.0, 0.0, {}, c.layer_info())
    got = harness.metric_reader("issue_ms.label").read(trace)
    assert got == pytest.approx(
        1e3 * sum(x["metrics"]["step_s"] for x in calls) / 16) and got > 0
    for name in READERS[1:]:
        assert harness.metric_reader(name).read(trace) is None, name
    bare = [{"work": 1, "latency_s": 1.0, "host_s": 0.5}]
    trace = harness.Trace(bare, bare, 1.0, 1.0, 0.0, {}, c.layer_info())
    for name in READERS:
        assert harness.metric_reader(name).read(trace) is None, name


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2 ** 31 + 99, 12345])
def test_cell_is_correct_at_tiny_size(cell, seed):
    result = run_cpu(cell, seed)
    assert result["correct"], result["limits"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "limits"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    spec, c = tiny_cell(cell, 2 ** 31 + 7)
    correct, limits = harness.judge(c.control(), spec.traffic["limits"])
    assert not correct, limits


def test_label_fault_is_not_correct(monkeypatch):
    """The label step returning its carry unchanged."""
    from orbitanalysis_tpu_torch.ops import label_step

    real = label_step.make_label_orbit_step

    def make(*a, **k):
        step = real(*a, **k)
        return lambda carry, inputs: (carry, step(carry, inputs)[1])

    monkeypatch.setattr(label_step, "make_label_orbit_step", make)
    assert not run_cpu("label.bench64")["correct"]


def test_nothing_the_bench64_cells_run_loads_jax():
    code = f"""
import sys, time
sys.path[:0] = [{os.path.join(ROOT, 'portbench', 'tests')!r}, {ROOT!r}]
import test_portbench_label as t
for cell in t.CELLS:
    code, result = t.RUN.execute(t.tiny_spec(cell), 5, 0.2, 0, device="cpu",
                                 t_start=time.perf_counter())
    assert code == 0 and result["correct"], (cell, result)
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(' '.join(tops))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600,
                         cwd=os.path.join(ROOT, "portbench", "tests"))
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(out.stdout.split())
    assert "orbitanalysis_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_at_full_size(cell, card):
    """The control at the cell's own size on the card (three seeds)."""
    spec = harness.find_cell(bench(), cell)
    mod = harness.entry_module(spec.traffic)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        c = mod.Cell(spec.config, spec.traffic, seed, card)
        c.setup()
        correct, limits = harness.judge(c.control(), spec.traffic["limits"])
        assert not correct, limits
        del c
        torch.cuda.empty_cache()
