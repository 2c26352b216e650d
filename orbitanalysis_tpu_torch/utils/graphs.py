"""A whole scan captured once as a CUDA graph and replayed, for the
port's scans whose steps read nothing back to the host:
``ops/label_step.scan_label_events`` and ``engine/scan.
scan_events_sorted``.  This module has no JAX twin: the JAX package
compiles a scan's ``lax.scan`` once, and a replayed graph is the port's
way to issue a whole scan without the host's Python a step.

A scan calls :func:`scan` with its key (:func:`graph_key`: what a
capture bakes in) and its loop ``run(carry, metrics, stamps) -> (carry,
outputs)``.  On CUDA tensors a key's first call runs the loop; its
second captures the loop on a side stream into a private memory pool
(:class:`ScanGraph`) and replays it; later calls replay.  A replay reads
whatever the baked-in tensors hold then, copies the caller's carry into
the graph's carry planes and returns clones of the graph's outputs, so
one call's outputs outlive the next.  :data:`GRAPHS` holds two keys,
graphs or keys seen once, the least recently used dropped first.  CPU
tensors always run the loop.

The carry and the outputs are NamedTuples (or plain tuples) of tensors;
each comes back as the type it was.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.utils.metrics import phase_timer


def stamp():
    """A pair of CUDA timing events, the first recorded now."""
    pair = (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))
    pair[0].record()
    return pair


def graph_key(build, carry, seqs, *baked) -> tuple:
    """What a capture of a scan bakes in: the step builder ``build``, each
    sequence tensor's address, shape, strides and dtype (``seqs``, None
    where absent), the carry's shapes and dtypes, and the scan's
    arguments ``baked`` (hashable: capacity, mode, box, routes, the drag
    of each step, and whatever else the loop reads as Python values)."""
    def meta(t):
        return None if t is None else (t.data_ptr(), tuple(t.shape),
                                       t.stride(), t.dtype)
    return (build, tuple(map(meta, seqs)),
            tuple((tuple(t.shape), t.dtype) for t in carry), *baked)


def _like(proto, tensors):
    """``tensors`` as ``proto``'s tuple type."""
    tensors = tuple(tensors)
    return type(proto)(*tensors) if hasattr(proto, "_fields") else tensors


class ScanGraph:
    """One scan captured as a CUDA graph: the carry planes it reads, the
    carry and outputs it leaves in its private memory pool, and the
    kernel launches of one replay.  ``run(carry)`` is the scan's loop;
    the capture launches nothing, so the launch counts it made are taken
    back, whether it succeeds or not, and each replay adds them."""

    def __init__(self, run, carry):
        self.device = carry[0].device
        self.carry_in = _like(carry, (
            torch.empty(t.shape, dtype=t.dtype, device=self.device)
            for t in carry))
        self.graph = torch.cuda.CUDAGraph()
        before = _cuda.launch_counts()
        try:
            # a bare capture: torch.cuda.graph's context would also wait
            # for the device and empty the allocator's cache (0.2-0.27 s
            # a capture at the bench shape on an H100), which the graph's
            # pool does not need
            with torch.cuda.device(self.device), torch.cuda.stream(
                    torch.cuda.Stream()):
                self.graph.capture_begin(capture_error_mode="thread_local")
                try:
                    self.carry_out, self.outputs = run(self.carry_in)
                finally:
                    self.graph.capture_end()
        finally:
            after = _cuda.launch_counts()
            for n in after:
                _cuda.KERNELS[n].launches = before[n]
        self.launches = {n: after[n] - before[n] for n in after
                         if after[n] != before[n]}

    def replay(self, carry, stamps=None):
        """The scan from ``carry`` on the current stream: ``(carry,
        outputs)``, clones of the graph's; given ``stamps``, a pair of
        CUDA timing events around the replay is appended."""
        with torch.cuda.device(self.device):
            for mine, theirs in zip(self.carry_in, carry):
                mine.copy_(theirs)
            if stamps is not None:
                stamps.append(stamp())
            self.graph.replay()
            if stamps is not None:
                stamps[-1][1].record()
            for n, c in self.launches.items():
                _cuda.KERNELS[n].launches += c
            return (_like(self.carry_out, (t.clone() for t in self.carry_out)),
                    _like(self.outputs, (t.clone() for t in self.outputs)))


#: The process's CUDA scans by :func:`graph_key`: None for a key seen
#: once, its :class:`ScanGraph` once captured.
GRAPHS: OrderedDict = OrderedDict()
GRAPHS_KEPT = 2


def first_sighting(key) -> bool:
    """Whether ``key`` is new to :data:`GRAPHS`.  Either way it becomes
    the most recently used of the keys held, at most ``GRAPHS_KEPT``:
    the least recently used is dropped (a dropped graph frees its
    pool)."""
    new = key not in GRAPHS
    GRAPHS[key] = GRAPHS.pop(key, None)
    while len(GRAPHS) > GRAPHS_KEPT:
        GRAPHS.popitem(last=False)
    return new


def scan(key, run, carry, name: str, metrics=None, stamps=None):
    """``run(carry, metrics, stamps)``, or on CUDA tensors its graph's
    replay (module docstring): ``(carry, outputs)``.  A replay, with its
    copies and any capture before it, is one span ``<name>.step`` into
    ``metrics``, which also counts ``<name>_graph_captures`` (the call
    captured the graph) or ``<name>_graph_replays`` (it replayed a graph
    an earlier call captured); given ``stamps``, the replay's pair of
    CUDA timing events is appended to it."""
    if carry[0].device.type != "cuda" or first_sighting(key):
        return run(carry, metrics, stamps)
    with phase_timer(metrics, name + ".step"):
        graph = GRAPHS[key]
        counter = name + "_graph_replays"
        if graph is None:
            graph = GRAPHS[key] = ScanGraph(run, carry)
            counter = name + "_graph_captures"
        out = graph.replay(carry, stamps)
    if metrics is not None:
        metrics[counter] = metrics.get(counter, 0) + 1
    return out
