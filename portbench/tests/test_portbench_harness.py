"""The harness finds every cell, configuration and metric by name, its
counts match hand counts, and nothing it runs loads JAX or the JAX
package."""

from __future__ import annotations

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from conftest import CELLS, ROOT, bench, tiny_spec
from portbench import generate, harness, layers

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    metrics = b["end_to_end"] + b["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
        assert c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] in (1, 4)
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_found_by_name(cell):
    spec = harness.find_cell(bench(), cell)
    assert spec.chips == 1
    mod = harness.entry_module(spec.traffic)
    assert hasattr(mod, "Cell")
    names = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert spec.per_layer, f"{cell} reports no per-layer metric"
    for m in spec.per_layer:
        # every per-layer metric's cell reports the metric it moves
        assert m["moves"] in names
    for name in spec.traffic["report"]:
        assert name in names
    assert set(spec.traffic["limits"]) and all(
        isinstance(v, (int, float)) for v in spec.traffic["limits"].values())


def test_every_config_and_metric_found_by_name():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for m in b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)


def test_unknown_cell_is_refused():
    with pytest.raises(harness.BenchError):
        harness.find_cell(bench(), "no.such_cell")


def test_churn_counts_match_hand_counts():
    seq = generate.churn_sequence(3, 200, 4, 25.0, 0.07, 11, "cpu")
    for s in seq.snaps:
        assert len(s.ids) == int(s.counts.sum())
        rows = s.ids // generate.ID_STRIDE
        assert np.array_equal(np.bincount(rows, minlength=3), s.counts)
        assert s.pos.shape == (len(s.ids), 3) and s.pos.dtype == np.float32
        assert (s.pos >= 0).all() and (s.pos <= 25.0).all()
    again = generate.churn_sequence(3, 200, 4, 25.0, 0.07, 11, "cpu")
    assert all(np.array_equal(a.pos, b.pos)
               for a, b in zip(seq.snaps, again.snaps))


def test_large_and_negative_seeds():
    for seed in (2 ** 31 + 5, 2 ** 40, -3):
        generate.generator(seed, "cpu")
    a = generate.churn_sequence(2, 50, 2, 25.0, 0.07, 2 ** 33, "cpu")
    assert a.snaps[0].pos.shape[1] == 3


def test_work_counts_match_hand_counts():
    spec = tiny_spec("track.config2")
    mod = harness.entry_module(spec.traffic)
    cell = mod.Cell(spec.config, spec.traffic, 7, "cpu")
    cell.setup()
    want = sum(int(s.counts.sum()) for s in cell.seq.snaps)
    assert cell.call(0)["work"] == want
    spec = tiny_spec("scan.config2")
    mod = harness.entry_module(spec.traffic)
    cell = mod.Cell(spec.config, spec.traffic, 7, "cpu")
    cell.setup()
    want = sum(int(s.counts.sum()) for s in cell.seq.snaps[1:])
    assert cell.call(0)["work"] == want
    assert cell.layer_info()["steps_per_call"] == spec.config[
        "snapshots"] - 1


def test_byte_counts_match_hand_counts():
    # K1 at [100, 16384], K = 1024: the plane once, 100 rows of 1024 out
    assert layers.k1_bytes(100, 16384, 1024) == 100 * 16384 * 4 + \
        100 * 1024 * 4
    assert layers.k1_bytes(2, 256, 1) == 2 * 256 * 4 + 2 * 128 * 4
    # the aligned step: 84 B a slot, 6 B an event
    assert layers.aligned_step_bytes(100, 16384, 10) == \
        100 * 16384 * 84 + 60
    assert layers.roofline(3.35e12, 1.0) == pytest.approx(100.0)
    assert layers.roofline(1.0, 0.0) is None


def test_percentile_and_idle_share():
    assert harness.percentile(list(range(101)), 95) == pytest.approx(95)
    assert harness.percentile([1.0, 3.0], 50) == pytest.approx(2.0)
    t = harness.Trace([], [], 2.0, 1.5, 0.5, {}, {})
    assert layers.idle_share(t) == pytest.approx(75.0)


def test_busy_union_and_gaps(tmp_path):
    events = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": harness.WINDOW_SPAN,
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 20},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 70, "dur": 10},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 40,
         "dur": 25}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(events))
    window, dev, host = harness.read_chrome_trace(str(path))
    assert window == (0.0, 100.0) and len(dev) == 3 and len(host) == 1
    merged = harness._merge([(ts, ts + d) for _, ts, d in dev])
    assert merged == [[10.0, 40.0], [70.0, 80.0]]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = [os.path.join(ROOT, "portbench", "reference", f)
             for f in os.listdir(os.path.join(ROOT, "portbench",
                                              "reference"))
             if f.endswith(".py")]
    files += [os.path.join(ROOT, "portbench", f)
              for f in ("compare.py", "generate.py", "layers.py")]
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"orbitanalysis_tpu_torch", "orbitanalysis_tpu",
                           "jax", "jaxlib", "flax"}, path


def test_nothing_the_benchmark_runs_loads_jax():
    """A tiny run of every cell in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or orbitanalysis_tpu (compared
    whole) is loaded."""
    code = f"""
import sys, time
sys.path[:0] = [{os.path.join(ROOT, 'portbench', 'tests')!r}, {ROOT!r}]
from conftest import tiny_spec, run_module, CELLS
run = run_module()
for cell in CELLS:
    code, result = run.execute(tiny_spec(cell), 5, 0.2, 0, device="cpu",
                               t_start=time.perf_counter())
    assert code == 0 and result["correct"], (cell, result)
tops = sorted({{m.split('.')[0] for m in sys.modules}})
print(' '.join(tops))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(out.stdout.split())
    assert "orbitanalysis_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)
