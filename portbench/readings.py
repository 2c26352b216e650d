#!/usr/bin/env python3
"""Readings that set a cell's limits: the numbers the program's runs give
over many seeds, and those of the control (the plain reference in the
nearest precision below the configuration's, put in the program's
place), in one process on the card.  The benchmark's own runs never run
it.

    python3 portbench/readings.py --workload <cell> --seeds 2147483701 12 \
        --seconds 4 --control 3

runs ``12`` seeds from the first, each a short window at the cell's own
size followed by the comparison, and the control on the first ``3``;
one JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE)]

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs=2, required=True,
                   metavar=("FIRST", "COUNT"))
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--control", type=int, default=3)
    args = p.parse_args(argv)
    bench = harness.load_json(os.path.join(os.path.dirname(HERE),
                                           "BENCHMARK.json"))
    spec = harness.find_cell(bench, args.workload)
    harness.require_device(spec.chips)
    import torch

    mod = harness.entry_module(spec.traffic)
    first, count = args.seeds
    for k in range(count):
        seed = first + k
        cell = mod.Cell(spec.config, spec.traffic, seed, "cuda")
        cell.setup()
        calls, window_s = harness.run_window(cell, args.seconds, "cuda")
        cell.release()
        t0 = time.perf_counter()
        numbers = cell.check()
        line = {"kind": "program", "seed": seed, "calls": len(calls),
                "check_s": time.perf_counter() - t0, "numbers": numbers}
        print(json.dumps(line), flush=True)
        if k < args.control:
            numbers = cell.control()
            print(json.dumps({"kind": "control", "seed": seed,
                              "numbers": numbers}), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except harness.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr, flush=True)
        sys.exit(2)
