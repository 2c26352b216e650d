"""Observability: structured step metrics, phase spans, profiler scope
(twin of ``orbitanalysis_tpu/utils/metrics.py``).

- :class:`Metrics` — append-only structured records (JSON-lines file
  and/or in-memory), one per saved snapshot;
- :func:`phase_timer` — the one span primitive: host seconds of a named
  phase into a record dict and, while a ``torch.profiler`` records, a
  ``record_function`` range ``oa.<name>`` on the profiler's clock;
- :func:`trace` — a ``torch.profiler`` scope that writes a Chrome
  trace of the CPU and CUDA activity into a directory.

Ranges the port opens (each only while a profiler records):

- ``oa.track.lead``, ``oa.track.snapshot``, ``oa.track.flush`` and, in
  them, ``oa.track.load``, ``oa.track.pack`` (``oa.track.pack.align``),
  ``oa.track.step`` (``oa.track.stage``, ``oa.track.issue``),
  ``oa.track.fetch``, ``oa.track.decode``, ``oa.track.save``:
  ``engine/tracker.track_orbits``;
- ``oa.scan.step``: each step of ``engine/scan``'s per-step drivers
  but the sorted scan;
- ``oa.sorted.step`` (a step's enqueue, or one around a replay of the
  scan's CUDA graph): each step of ``engine/scan.scan_events_sorted``;
  in it, or in any call of a ``make_sorted_orbit_step`` step,
  ``oa.sorted.frame`` and, on the fused path, ``oa.sorted.join`` and
  ``oa.sorted.finish``;
- ``oa.step.frame``, ``oa.step.detect``, ``oa.step.compact``,
  ``oa.step.finish``: the aligned step (``ops/sorted_step.
  make_aligned_native_step``), under ``oa.track.issue`` or
  ``oa.scan.step``;
- ``oa.sim.step`` (a step's enqueue: the KDK step and its detection)
  and, in it or before the loop, ``oa.sim.force`` and ``oa.sim.detect``:
  ``models/nbody.simulate_with_tracking``;
- ``oa.pm.deposit``, ``oa.pm.solve``, ``oa.pm.interp``: the PM force
  (``models/pm.pm_forces``), under ``oa.sim.force``;
- ``oa.label.step`` (a step's enqueue, or one around a replay of the
  scan's CUDA graph): each step of
  ``ops/label_step.scan_label_events``; in it, or in any call of a
  ``make_label_orbit_step`` step, ``oa.label.moments``,
  ``oa.label.frames``, ``oa.label.detect`` and ``oa.label.finish``.

Keys of ``scan_label_events(metrics=...)`` (into the dict it is
handed): ``step_s`` (``label.step``), the counters ``label_steps``,
``label_updates`` (members of every step after the call's first) and
``label_events``, summed on the device and read once a call, and on
CUDA tensors ``label_device_s``, the steps' stretches of the device
stream between CUDA timing events (where the call replays the scan's
CUDA graph, the replay's stretch, and ``step_s`` the replay's whole
enqueue, with the graph's capture where the call made it),
``label_graph_captures``, the calls that captured the scan's
graph, and ``label_graph_replays``, the calls that replayed a graph an
earlier call captured (over the calls: the graph's hit rate).

Keys of ``scan_events_sorted(metrics=...)``: ``step_s``
(``sorted.step``), the counters ``sorted_steps``, ``sorted_updates``
(the staged members of every step after the call's first),
``sorted_events`` and ``sorted_static_steps`` (the steps that took the
static branch), summed on the device and read once a call, on CUDA
tensors ``sorted_device_s`` (each step's stretch of the device stream
between CUDA timing events, or the replay's), and
``sorted_graph_captures`` and ``sorted_graph_replays``, as the label
scan's (both scans replay through ``utils/graphs``).

Counters of the PM force (``models/pm.pm_forces``, into the ``metrics``
dict it is handed): ``deposited``, the particles deposited, and
``interp_stream``, those interpolated from the deposit's cell-sorted
stream (all of them where it deposits through the sorted stream with
the scalar interpolation, as on CUDA tensors by default; else 0).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


@dataclass
class Metrics:
    """Structured per-step metric records.

    ``jsonl_path``: optional file to append one JSON object per record.
    Records are always kept in ``.records`` for programmatic access.

    ``track_orbits(metrics=...)`` logs one record per saved snapshot
    (the seed snapshot is in the first record's ``lead_s``): ``t``,
    ``snapshot``, ``n_halos_active``, ``n_particles``, ``n_events``
    (``n_events_<tag>`` for ``mode='both'``), ``join``, ``capacity``,
    ``event_capacity`` and the host seconds of its phases:

    - ``load_s``: the wait on the prefetch thread for the callbacks;
    - ``pack_s``: host staging into the padded layout, of which
      ``align_s`` is the stable-layout alignment (aligned engine);
    - ``step_s``: ``stage_s`` (the staging copies and their
      host-to-device enqueue) plus ``issue_s`` (the step's enqueue);
    - ``fetch_s``: the wait for the step's small outputs on the host;
    - ``decode_s``: the host ordering and ID mapping of the events;
    - ``save_s``: the writer's append;

    and, on the single-device engines only (general, sorted, aligned):

    - ``lead_s`` (first record of a call): from the call's entry to the
      first saved snapshot's iteration (checks, engine and writer
      set-up, the seed snapshot);
    - ``snapshot_s``: the snapshot's loop iteration, less the previous
      snapshot's flush nested in it, plus its own deferred flush; its
      self time, ``snapshot_s`` less ``load_s + pack_s + step_s +
      fetch_s + decode_s + save_s``, is the tracker's own Python;
    - ``h2d_bytes``: the bytes staged to the device;
    - ``step_device_s`` (CUDA): the step's stretch of the device stream,
      between CUDA timing events after the staging copies and after the
      step's last launch.
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


#: ``torch.autograd.profiler.record_function`` opens a range only while
#: a profiler records on this thread; entering one costs ~15 us even
#: then, this flag ~0.2 us (thread-local, as the profiler's state).
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Span:
    """One open :func:`phase_timer`: host seconds into ``out[key]``, and
    the profiler range ``name`` around them (either may be None)."""

    __slots__ = ("_out", "_key", "_name", "_range", "_t0")

    def __init__(self, out, key, name):
        self._out, self._key, self._name = out, key, name
        self._range = None

    def __enter__(self):
        if self._name is not None:
            self._range = torch.autograd.profiler.record_function(self._name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._out is not None:
            self._out[self._key] = self._out.get(self._key, 0.0) + (
                time.perf_counter() - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def phase_timer(out: Optional[Dict[str, float]], name: str):
    """``with phase_timer(d, 'track.step'): ...`` adds the block's host
    seconds into ``d['step_s']`` (the key is the name's last dotted part
    and ``_s``) and, while a ``torch.profiler`` records, opens the range
    ``oa.track.step``.  ``out=None``: the range alone.  With neither a
    dict nor a profiler it does nothing."""
    profiling = _profiling()
    if out is None and not profiling:
        return _OFF
    return _Span(out, name.rpartition(".")[2] + "_s",
                 "oa." + name if profiling else None)


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """``torch.profiler`` scope over CPU and (when present) CUDA
    activity; writes ``<logdir>/trace.json`` (Chrome/Perfetto format).
    No-op when ``logdir`` is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
