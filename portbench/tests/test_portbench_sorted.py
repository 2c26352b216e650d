"""The sorted merge-join cell, ``sorted.bench64``, at a tiny size on the
CPU: the harness finds the cell, its configuration, its traffic and its
four readers by name (they apply to it alone and read hand-made calls),
K16's byte count matches a hand count of ``csrc/merge.cu``'s loads and
stores, the cell comes out correct against its plain reference, and the
control and planted faults do not.  The control at the cell's own size
runs on the card (``test_control_fails_at_full_size``).
"""

from __future__ import annotations

import time

import pytest
import torch

from conftest import bench, run_module
from portbench import harness, layers, layers_sorted

CELL = "sorted.bench64"
#: The per-layer metrics of the sorted cell.
READERS = ("issue_ms.sorted", "step_device_ms.sorted",
           "join_roofline.sorted", "idle_share.sorted")
#: bench64 at a tiny size: 4 halos of 512 over 8 snapshots, K 128.
TINY_CONFIG = dict(halos=4, pool=512, snapshots=8)
TINY_TRAFFIC = dict(capacity=512, event_capacity=128, check_calls=2)

RUN = run_module()


def tiny_spec() -> harness.CellSpec:
    spec = harness.find_cell(bench(), CELL)
    return spec._replace(config=dict(spec.config, **TINY_CONFIG),
                         traffic=dict(spec.traffic, **TINY_TRAFFIC))


def tiny_cell(seed=7):
    spec = tiny_spec()
    c = harness.entry_module(spec.traffic).Cell(spec.config, spec.traffic,
                                                seed, "cpu")
    c.setup()
    return spec, c


def run_cpu(seed=2 ** 31 + 99, seconds=0.3):
    code, result = RUN.execute(tiny_spec(), seed, seconds, 0, device="cpu",
                               t_start=time.perf_counter())
    assert code == 0
    return result


def test_cell_and_files_found_by_name():
    spec = harness.find_cell(bench(), CELL)
    assert spec.chips == 1
    assert spec.config["name"] == "bench64_sorted"
    assert spec.config["reduced"] == []
    assert (spec.config["halos"], spec.config["pool"],
            spec.config["snapshots"]) == (64, 32768, 48)
    assert hasattr(harness.entry_module(spec.traffic), "Cell")
    assert spec.traffic["entry"] == "sorted"
    assert {m["name"] for m in spec.end_to_end} == {"scan_updates_per_s",
                                                    "setup_s"}
    assert spec.traffic["report"] == {"scan_updates_per_s": "rate"}
    assert (spec.traffic["capacity"], spec.traffic["event_capacity"]) == (
        32768, 2048)
    assert (spec.traffic["trace_calls"], spec.traffic["check_calls"]) == (
        20, 4)
    assert set(spec.traffic["limits"]) == {"event_mismatch",
                                           "angle_mismatch", "layout_faults"}
    assert spec.traffic["limits"]["layout_faults"] == 0
    assert {m["name"] for m in spec.per_layer} == set(READERS)


def test_configuration_is_bench64_with_all_snapshots():
    """The same sizes and law as bench64, one assumption more."""
    b = bench()
    configs = {c["name"]: c for c in b["configs"]}
    mine = harness.load_json(configs["bench64_sorted"]["file"].replace(
        "portbench/", harness.HERE + "/", 1))
    base = harness.load_json(configs["bench64"]["file"].replace(
        "portbench/", harness.HERE + "/", 1))
    for k in ("halos", "pool", "snapshots", "box_size", "churn",
              "region_radius", "cosmology", "precision"):
        assert mine[k] == base[k], k
    extra = set(mine["assumed"]) - set(base["assumed"])
    assert extra == {"snapshots"}
    assert all(mine["assumed"][k] == v for k, v in base["assumed"].items())


def test_readers_apply_to_the_sorted_cell_alone():
    metrics = {m["name"]: m for m in bench()["per_layer"]}
    for name in READERS:
        m = metrics[name]
        assert m["workloads"] == [CELL]
        assert m["moves"] == "scan_updates_per_s"
        assert callable(harness.metric_reader(name).read)
    for w in bench()["workloads"]:
        if w["name"] != CELL:
            spec = harness.find_cell(bench(), w["name"])
            assert not {m["name"] for m in spec.per_layer} & set(READERS)
    e2e = {m["name"]: m for m in bench()["end_to_end"]}
    assert CELL in e2e["scan_updates_per_s"]["workloads"]


def test_k16_bytes_match_a_hand_count():
    """``join_detect_kernel`` (``csrc/merge.cu``): the prev key, sv, rx,
    ry, rz and angle planes and the cur key, sv, rx, ry, rz planes read
    (11 words a slot), ``packed`` written (1 word a slot), ``ev_key``,
    ``ev_sv`` and ``ev_ang`` written (3 words a lane of ``[H, k128]``)
    and ``count`` (1 word a row)."""
    h, p, k = 64, 32768, 2048
    reads = 11 * 4 * h * p
    writes = 4 * h * p + 3 * 4 * h * k + 4 * h
    assert layers_sorted.k16_bytes(h, p, k) == reads + writes
    # the bench shape's 92 MB in and 10 MB out (merge.cu's own reckoning)
    assert round(reads / 1e6) == 92 and round(writes / 1e6) == 10
    # the event lists: K rounded up to 128 lanes, at most the row
    assert layers_sorted.k128(2000, 32768) == 2048
    assert layers_sorted.k128(2048, 512) == 512
    assert layers_sorted.k16_bytes(2, 256, 2048) == \
        48 * 2 * 256 + 12 * 2 * 256 + 8
    info = dict(halos=h, capacity=p, event_capacity=k)
    assert layers_sorted.launch_bytes("fused_join_detect", info) == \
        reads + writes


def test_work_and_layer_info_match_hand_counts():
    _, c = tiny_cell()
    want = sum(int(s.counts.sum()) for s in c.seq.snaps[1:])
    assert c.call(0)["work"] == want
    assert c.layer_info() == {"steps_per_call": 8, "halos": 4,
                              "capacity": 512, "event_capacity": 128}
    # the staging: each row's members sorted by ID, padding last
    s = c.seq.snaps[3]
    for h in range(4):
        n = int(s.counts[h])
        row = c.stack.ids[3, h]
        assert torch.equal(row[:n].long(), torch.sort(torch.as_tensor(
            s.ids[s.ids // 10 ** 6 == h])).values)
        assert bool((row[n:] == torch.iinfo(torch.int32).max).all())


def _call(step_s, steps, device_s=None, launches=None):
    m = {"step_s": step_s, "sorted_steps": steps, "sorted_updates": 10,
         "sorted_events": 3, "sorted_static_steps": 0}
    if device_s is not None:
        m["sorted_device_s"] = device_s
    return {"work": 1, "latency_s": 1.0, "host_s": step_s, "metrics": m,
            "launches": launches or {}}


def test_readers_by_hand():
    info = dict(halos=64, capacity=32768, event_capacity=2048,
                steps_per_call=48)
    launches = {"fused_join_detect": 48}
    calls = [_call(0.024, 48, 0.0072, launches),
             _call(0.030, 48, 0.0060, launches)]
    ops = {"void (anonymous namespace)::join_detect_kernel((anonymous "
           "namespace)::JoinArgs)": 0.0066,
           "void (anonymous namespace)::merge_rows_kernel(MergeArgs)": 0.5,
           "aten::copy_ elementwise": 0.25}
    trace = harness.Trace(calls, calls, 1.0, 1.0, 0.4, ops, info)
    read = {n: harness.metric_reader(n).read(trace) for n in READERS}
    assert read["issue_ms.sorted"] == pytest.approx(1e3 * 0.054 / 96)
    assert read["step_device_ms.sorted"] == pytest.approx(1e3 * 0.0132 / 96)
    n_bytes = 96 * layers_sorted.k16_bytes(64, 32768, 2048)
    assert read["join_roofline.sorted"] == pytest.approx(
        100.0 * n_bytes / layers.PEAK_BYTES / 0.0066)
    assert read["idle_share.sorted"] == pytest.approx(60.0)


def test_readers_without_the_programs_numbers_give_none():
    """Calls without the program's metrics or launches (a program that
    does not write them, or the CPU) give no value."""
    _, c = tiny_cell()
    c.traced = True
    calls = [c.call(i) for i in range(2)]
    for m in (x["metrics"] for x in calls):
        assert m["sorted_steps"] == 8 and "sorted_device_s" not in m
    trace = harness.Trace(calls, calls, 1.0, 1.0, 0.0, {}, c.layer_info())
    got = harness.metric_reader("issue_ms.sorted").read(trace)
    assert got == pytest.approx(
        1e3 * sum(x["metrics"]["step_s"] for x in calls) / 16) and got > 0
    for name in READERS[1:]:
        assert harness.metric_reader(name).read(trace) is None, name
    bare = [{"work": 1, "latency_s": 1.0, "host_s": 0.5}]
    trace = harness.Trace(bare, bare, 1.0, 1.0, 0.0, {}, c.layer_info())
    for name in READERS:
        assert harness.metric_reader(name).read(trace) is None, name


@pytest.mark.parametrize("seed", [2 ** 31 + 99, 12345])
def test_cell_is_correct_at_tiny_size(seed):
    result = run_cpu(seed)
    assert result["correct"], result["limits"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "limits"


def test_control_fails():
    spec, c = tiny_cell(2 ** 31 + 7)
    correct, limits = harness.judge(c.control(), spec.traffic["limits"])
    assert not correct, limits


@pytest.mark.parametrize("fault", ["unchanged", "reordered"])
def test_sorted_fault_is_not_correct(monkeypatch, fault):
    """The step returning its carry unchanged, or each row's events
    reversed: the same event set, out of the previous snapshot's load
    order."""
    from orbitanalysis_tpu_torch.ops import sorted_step

    real = sorted_step.make_sorted_orbit_step

    def make(*a, **k):
        step = real(*a, **k)

        def broken(carry, snap, static=None):
            new, ev = step(carry, snap, static=static)
            if fault == "unchanged":
                return carry, ev
            k = torch.arange(ev.ids.shape[1])[None, :]
            n = ev.count.long()[:, None]
            back = torch.where(k < n, n - 1 - k, k)
            return new, ev._replace(ids=torch.gather(ev.ids, 1, back),
                                    angles=torch.gather(ev.angles, 1, back))
        return broken

    monkeypatch.setattr(sorted_step, "make_sorted_orbit_step", make)
    assert not run_cpu()["correct"]


@pytest.mark.cuda
def test_control_fails_at_full_size(card):
    """The control at the cell's own size on the card (three seeds)."""
    spec = harness.find_cell(bench(), CELL)
    mod = harness.entry_module(spec.traffic)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        c = mod.Cell(spec.config, spec.traffic, seed, card)
        c.setup()
        correct, limits = harness.judge(c.control(), spec.traffic["limits"])
        assert not correct, limits
        del c
        torch.cuda.empty_cache()
