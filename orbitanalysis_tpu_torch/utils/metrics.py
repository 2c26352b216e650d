"""Observability: structured step metrics, phase timers, profiler scope
(twin of ``orbitanalysis_tpu/utils/metrics.py``).

- :class:`Metrics` — append-only structured records (JSON-lines file
  and/or in-memory), one per snapshot;
- :func:`phase_timer` — scoped wall-clock timing of named phases
  (load / pack / step / fetch / save);
- :func:`trace` — a ``torch.profiler`` scope that writes a Chrome
  trace of the CPU and CUDA activity into a directory.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Metrics:
    """Structured per-step metric records.

    ``jsonl_path``: optional file to append one JSON object per record.
    Records are always kept in ``.records`` for programmatic access.
    """

    jsonl_path: Optional[str] = None
    records: List[Dict[str, Any]] = field(default_factory=list)

    def log(self, **fields):
        rec = {"t": time.time(), **fields}
        self.records.append(rec)
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def summary(self) -> Dict[str, Any]:
        """Aggregate timings by phase across records."""
        agg: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for r in self.records:
            for k, v in r.items():
                if k.endswith("_s") and isinstance(v, (int, float)):
                    agg[k] = agg.get(k, 0.0) + v
                    counts[k] = counts.get(k, 0) + 1
        return {
            k: {"total_s": v, "mean_s": v / counts[k], "n": counts[k]}
            for k, v in agg.items()
        }


@contextlib.contextmanager
def phase_timer(out: Dict[str, float], name: str):
    """``with phase_timer(d, 'step'): ...`` accumulates ``d['step_s']``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        out[name + "_s"] = out.get(name + "_s", 0.0) + (
            time.perf_counter() - t0
        )


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """``torch.profiler`` scope over CPU and (when present) CUDA
    activity; writes ``<logdir>/trace.json`` (Chrome/Perfetto format).
    No-op when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
