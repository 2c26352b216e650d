"""The comparisons that decide ``correct`` in config 4's cell: one
``simulate_with_tracking`` call of the program, as the timed window
produced it, against the plain reference's replay of the same call
(``portbench/reference/nbody.py``).  Each function returns plain
numbers; the limits live in ``traffic/integrate.json`` and are set in
``PERF.md`` from measured readings.

- ``pos_gap``: the largest minimum-image gap of a final position
  coordinate (box units); ``vel_gap``: of a final velocity component;
- ``count_mismatch``: the share of particles whose apsis count of the
  call differs from the reference's (a turn lost to rounding, or a
  radial velocity within rounding of zero at a detection);
- ``event_gap``: at each detection, the program's events less the
  reference's, in size, over the reference's, the largest of the
  call's detections (the program reports a detection's events as a
  total, so this is the least share of events in one set only; the
  sets of particles are held by ``count_mismatch``).  Events on a step
  without a detection, or a detection missing, make it infinite.
"""

from __future__ import annotations

import math

import torch


def call_numbers(pos, vel, counts, events, ref, box: float,
                 detect_every: int) -> dict:
    """The program's final ``pos``, ``vel`` (``[N, 3]``), ``counts``
    (``[rows, P]``) and per-step ``events`` (``[n_steps]``) against a
    reference ``Result``."""
    dev = ref.pos.device
    pos = pos.to(dev, torch.float64)
    d = pos - ref.pos.double()
    d = d - box * torch.round(d / box)
    vel_gap = (vel.to(dev, torch.float64) - ref.vel.double()).abs().max()
    counts = counts.to(dev).reshape(-1).long()
    mismatch = (counts != ref.counts.to(dev)).double().mean()
    ev = events.cpu().long().tolist()
    at = ev[detect_every - 1::detect_every]
    rest = [e for k, e in enumerate(ev) if (k + 1) % detect_every]
    if any(rest) or len(at) != len(ref.events):
        event_gap = math.inf
    else:
        event_gap = max((abs(a - b) / max(b, 1)
                         for a, b in zip(at, ref.events)), default=0.0)
    return dict(pos_gap=float(d.abs().max()), vel_gap=float(vel_gap),
                count_mismatch=float(mismatch), event_gap=float(event_gap))
