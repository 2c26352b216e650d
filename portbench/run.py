#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``orbitanalysis_tpu_torch``):
one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout.  ``--trace 0`` measures the cell's
end-to-end metrics over a window of ``--seconds``; ``--trace 1`` runs
the traffic file's ``trace_calls`` calls under ``torch.profiler`` and
reports its per-layer metrics.  Either way the window's outputs are then
compared with the plain reference, and the last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (``breakdown`` with ``--trace 1``) and, last, ``limits``:
each number compared beside its limit, which also end standard error.

Exits with 2 and prints no result without the card(s) the cell asks
for, and with 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT]

from portbench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def execute(spec, seed, seconds, trace, device="cuda", t_start=None):
    """One run of the cell ``spec``: ``(exit code, result dict or None)``.
    ``device`` is the card, or the CPU in the benchmark's own tests."""
    import torch

    on_card = str(device).startswith("cuda")
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    power = harness.card_power_limit() if on_card else ""
    if on_card:
        log(f"card: {kind}, {torch.cuda.device_count()} visible, "
            f"nvidia-smi: {power}")
    mod = harness.entry_module(spec.traffic)
    cell = mod.Cell(spec.config, spec.traffic, seed, device)
    cell.setup()
    harness.sync(device)
    setup_s = time.perf_counter() - (T_START if t_start is None else t_start)

    out = {}
    if trace:
        tmp = os.path.join(os.environ.get("TMPDIR")
                           or os.path.join(HERE, "_cache"), "portbench")
        plain, plain_s, calls, window_s, busy_s, ops, breakdown = \
            harness.trace_window(cell, int(spec.traffic["trace_calls"]),
                                 device, tmp)
        traced = harness.Trace(calls, plain, plain_s, window_s, busy_s, ops,
                               cell.layer_info())
        calls = plain + calls
        metrics = harness.per_layer(spec, traced)
    else:
        calls, window_s = harness.run_window(cell, seconds, device)
        metrics = harness.end_to_end(spec, calls, window_s, setup_s)
    harness.sync(device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    device_line = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": spec.chips, "memory_peak_bytes": int(peak),
                   "power_limit": power}
    if trace:
        device_line.update(busy_s=busy_s, window_s=window_s)
        out["breakdown"] = breakdown
    log(f"window: {len(calls)} calls in {window_s:.3f} s; set-up "
        f"{setup_s:.3f} s; peak {peak} B")

    cell.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = cell.check()
    log(f"reference comparison: {time.perf_counter() - t0:.3f} s")
    correct, limits = harness.judge(numbers, spec.traffic["limits"])

    found = harness.forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}: the benchmark "
            "runs the port alone")
        return 3, None
    result = {"correct": correct, "attempted": len(calls),
              "failed": int(cell.failed), "metrics": metrics,
              "device": device_line}
    result.update(out)
    result["limits"] = limits
    return 0, result


def main(argv=None) -> int:
    args = parse(argv)
    # build and kernel caches at fixed paths inside the checkout; the
    # port's own kernel library builds under orbitanalysis_tpu_torch/_build/
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(HERE, "_cache", sub)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    spec = harness.find_cell(bench, args.workload)
    harness.require_device(spec.chips)
    code, result = execute(spec, args.seed, args.seconds, args.trace)
    if result is None:
        return code
    for name, v in result["limits"].items():
        log(f"{name}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except harness.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        sys.exit(2)
