"""The benchmark's machinery, the same for every cell: finding a cell's
files by name, the device checks, the measured window, the profiler's
reading, the per-layer readers and the result line.

A cell is an entry (``portbench/entries/<entry>.py``, named by the
traffic file) driven by two data files: its configuration
(``BENCHMARK.json`` ``configs[].file``) and its traffic mix
(``portbench/traffic/<traffic>.json``).  An entry module defines
``Cell(config, traffic, seed, device)`` with:

- ``setup()``: make the inputs from the seed and warm up every shape
  the window uses (counted in ``setup_s``);
- ``call(i) -> dict``: one whole call of the program, finished on the
  device before it returns; the dict has ``work`` (the units the cell's
  rate counts) and may have ``host_s`` (the benchmark's own span of the
  call before its synchronisation);
- ``traced``: set True by the harness before a traced window, so the
  call's dict also holds what the per-layer readers read;
- ``release()``: drop the program's state once the window has closed;
- ``check() -> dict``: the numbers compared with the plain reference,
  each held to ``traffic["limits"][name]``;
- ``failed`` (after ``check``): the checked answers that broke a limit;
- ``layer_info() -> dict``: what the per-layer readers need besides the
  trace (counters, spans, byte counts).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Modules the process may not hold once the window has closed: JAX and
#: the JAX package this port was made from (top-level names, compared
#: whole: the port's own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "orbitanalysis_tpu")


class BenchError(Exception):
    """A run that cannot produce a result (exit code 2)."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class CellSpec(NamedTuple):
    name: str
    chips: int
    config: dict         # the configuration file's contents
    traffic: dict        # the traffic file's contents
    end_to_end: list     # BENCHMARK.json end_to_end entries of this cell
    per_layer: list      # BENCHMARK.json per_layer entries of this cell


def _applies(metric, cell, e2e_names):
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def find_cell(bench: dict, name: str, root: str = ROOT) -> CellSpec:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration and
    traffic files and the metrics it reports."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise BenchError(f"{name}: no configuration {w['config']!r}")
    config = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic_path = os.path.join(root, "portbench", "traffic",
                                w["traffic"] + ".json")
    if not os.path.exists(traffic_path):
        raise BenchError(f"{name}: no traffic file {traffic_path}")
    traffic = load_json(traffic_path)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return CellSpec(name, int(w["chips"]), config, traffic, e2e, layer)


def entry_module(traffic: dict, root: str = ROOT):
    entry = traffic["entry"]
    path = os.path.join(root, "portbench", "entries", entry + ".py")
    if not os.path.exists(path):
        raise BenchError(f"no entry {path}")
    return importlib.import_module("portbench.entries." + entry)


def metric_reader(name: str, root: str = ROOT):
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    if not os.path.exists(path):
        raise BenchError(f"no reader {path} for the per-layer metric {name}")
    return load_module(path, "portbench_metric_" + name.replace(".", "_"))


def require_device(chips: int):
    """The card the cell asks for, or a BenchError: never the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is false: no card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"{torch.cuda.device_count()} card(s), the cell "
                         f"asks for {chips}")


def card_power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them (a
    card may be set below its 700 W)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def sync(device):
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run_window(cell, seconds: float, device) -> tuple:
    """Whole calls back to back until ``seconds`` have passed: ``(calls,
    window_s)``, the window running from the first call's start to the
    last call's end."""
    calls = []
    sync(device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    while True:
        c0 = time.perf_counter()
        out = dict(cell.call(i))
        out["latency_s"] = time.perf_counter() - c0
        calls.append(out)
        i += 1
        if time.perf_counter() >= deadline:
            break
    return calls, time.perf_counter() - t0


def run_calls(cell, n: int, device, first: int = 0) -> tuple:
    """``n`` whole calls back to back, numbered from ``first``: ``(calls,
    window_s)``."""
    calls = []
    sync(device)
    t0 = time.perf_counter()
    for i in range(first, first + n):
        c0 = time.perf_counter()
        out = dict(cell.call(i))
        out["latency_s"] = time.perf_counter() - c0
        calls.append(out)
    return calls, time.perf_counter() - t0


def percentile(values, q):
    """The ``q``-th percentile (0-100) by linear interpolation."""
    v = sorted(values)
    if not v:
        return float("nan")
    x = (len(v) - 1) * q / 100.0
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


def end_to_end(spec: CellSpec, calls, window_s, setup_s) -> dict:
    """The cell's end-to-end metrics.  The traffic file's ``report``
    names each metric's statistic: ``rate`` (work of every whole call
    over all the window's time) or ``p95_ms`` (95th percentile of every
    call's time)."""
    stats = {
        "rate": sum(c["work"] for c in calls) / window_s,
        "p95_ms": percentile([c["latency_s"] for c in calls], 95) * 1e3,
    }
    out = {}
    for m in spec.end_to_end:
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = stats[spec.traffic["report"][m["name"]]]
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


class Trace(NamedTuple):
    """What a traced window gives the per-layer readers: the same calls
    run twice, without the profiler (``plain_calls``, whose host spans
    the readers take) and under it (``calls``, the device's times)."""

    calls: list          # the traced calls' dicts
    plain_calls: list    # the same calls without the profiler
    plain_window_s: float  # their window, host clock
    window_s: float      # the traced window, the profiler's clock
    busy_s: float        # seconds with a device operation running
    device_ops: dict     # device operation name -> seconds
    info: dict           # the entry's layer_info()


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "portbench.window"


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_chrome_trace(path):
    """``(window (t0, t1) us, device ops [(name, ts, dur)], host ops
    [(name, ts, dur)])`` of a profiler's Chrome trace."""
    events = load_json(path)["traceEvents"]
    window, dev, host = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((e.get("name", "?"), ts, dur))
        elif e.get("name") == WINDOW_SPAN and cat == "user_annotation":
            window = (ts, ts + dur)
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                     "cuda_driver"):
            host.append((e.get("name", "?"), ts, dur))
    return window, dev, host


def trace_window(cell, n_calls, device, tmpdir) -> tuple:
    """``n_calls`` whole calls without the profiler, then ``n_calls``
    more under ``torch.profiler``; the trace is written under
    ``tmpdir``, read and deleted.  Returns ``(plain calls, plain
    window_s, calls, window_s, busy_s, device_ops, breakdown)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(tmpdir, exist_ok=True)
    path = os.path.join(tmpdir, "portbench-trace.json")
    cell.traced = True
    plain, plain_s = run_calls(cell, n_calls, device)
    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW_SPAN):
            calls, _ = run_calls(cell, n_calls, device, first=n_calls)
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        window, dev, host = read_chrome_trace(path)
    finally:
        os.remove(path)
    if window is None or not dev:
        raise BenchError("the profiler's trace holds no window or no "
                         "device operation")
    t0, t1 = window
    busy = _merge([(max(ts, t0), min(ts + d, t1)) for _, ts, d in dev
                   if ts + d > t0 and ts < t1])
    busy_s = sum(e - s for s, e in busy) * 1e-6
    ops = {}
    for name, _, d in dev:
        ops[name] = ops.get(name, 0.0) + d * 1e-6
    # idle gaps, named by the innermost host operation running at the
    # gap's start ("host Python" where none is)
    gaps, edge = {}, t0
    host.sort(key=lambda x: x[1])
    nxt, active = 0, []
    for s, e in busy + [[t1, t1]]:
        if s > edge:
            while nxt < len(host) and host[nxt][1] <= edge:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[1] + h[2] >= edge]
            label = min(active, key=lambda h: h[2])[0] if active else \
                "host Python"
            gaps[label] = gaps.get(label, 0.0) + (s - edge) * 1e-6
        edge = max(edge, e)
    top = sorted(ops.items(), key=lambda x: -x[1])[:10]
    breakdown = {
        "device_ops": [[n, v] for n, v in top],
        "idle_gaps": [[n, v] for n, v in
                      sorted(gaps.items(), key=lambda x: -x[1])[:10]],
    }
    return plain, plain_s, calls, (t1 - t0) * 1e-6, busy_s, ops, breakdown


def per_layer(spec: CellSpec, trace: Trace, root: str = ROOT) -> dict:
    """Each per-layer metric the cell reports, from its reader; a reader
    that finds nothing to read returns None and the metric is left
    out."""
    out = {}
    for m in spec.per_layer:
        value = metric_reader(m["name"], root).read(trace)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> tuple:
    """``(correct, limits line)``: every number at or under its limit
    (NaN fails), and each number beside its limit."""
    line = {}
    ok = True
    for name, value in numbers.items():
        if name not in limits:
            raise BenchError(f"no limit for the number {name!r}")
        limit = float(limits[name])
        good = value <= limit
        ok &= bool(good)
        line[name] = {"value": float(value), "limit": limit}
    return ok, line
