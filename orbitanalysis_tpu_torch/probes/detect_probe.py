"""The label detect kernel against a copy kernel with its streams (twin
of the JAX package's ``benchmarks/detect_probe.py``, its ``full`` and
``stream`` variants).

On the benchmark's churn workload in the label-native form
(:func:`~orbitanalysis_tpu_torch.models.synthetic.label_churn_workload`:
``halos`` x ``cap`` slots, ``snaps`` snapshots) in rows of
:data:`ROW_WIDTH`, with the JAX probe's stand-in for the frame rows
(snapshot 0's positions and three planes of zeros: the same stream
volume), a scan over the snapshots with the carry threaded through:

- ``full``: the port's K9 (``ops.label.detect_label``, the ``'split'``
  route's detect kernel, f32 r-hat, pericentric, box 100, no Hubble
  term);
- ``stream``: P4 (:func:`detect_stream`), a copy kernel with K9's
  streams: 72 B a particle in (all six frame-row planes) and 24 B out,
  the floor for this I/O shape.

Each prints ``name ms/snap GB/s``, the bytes those of one call (each
input read once, each output written once), the time a snapshot the
median of :data:`~orbitanalysis_tpu_torch.probes.dma_probe.RUNS`
timings of one scan (:func:`~orbitanalysis_tpu_torch.probes.dma_probe.
timed_ms`).  JAX's ``noacos`` and ``nof16`` patch K9's arccos and f16
encoder at trace time; they are K9 variants, not kernels of their own,
and are not here.

Usage: python -m orbitanalysis_tpu_torch.probes.detect_probe
       [--halos 64] [--cap 32768] [--snaps 12] [--variants full,stream]
       [--cpu]
"""

from __future__ import annotations

import argparse

import torch

from orbitanalysis_tpu_torch.models.synthetic import label_churn_workload
from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.ops.label import detect_label
from orbitanalysis_tpu_torch.ops.label_step import init_label_carry
from orbitanalysis_tpu_torch.probes.dma_probe import device_label, timed_ms
from orbitanalysis_tpu_torch.utils.device import resolve_device

BOX = 100.0
ROW_WIDTH = 1 << 15
#: Bytes a particle of one call of either variant: rows 24, lab 4, pos
#: 12, vel 12, sv 4, rh 12, pk 4 in; sv 4, rh 12, pk 4, payload 4 out
#: (and 4 bytes a row of counts).
PARTICLE_BYTES = 96


def detect_stream_torch(rows, lab, pos, vel, sv, rh, pk):
    """The plain version of P4 (the JAX ``copy_kernel``): ``(sv + lab,
    rh, pk, payload, count [R, 1])``, the payload the int32 bits of the
    f32 sum ``rows[0] + pos[0] + pos[1] + pos[2] + vel[0] + vel[1] +
    vel[2] + rows[3]`` in that order and the count each row's int32 sum
    of ``lab``."""
    s = (rows[0] + pos[0] + pos[1] + pos[2] + vel[0] + vel[1] + vel[2]
         + rows[3])
    return (sv + lab, rh.clone(), pk.clone(), s.view(torch.int32),
            lab.sum(dim=1, keepdim=True, dtype=torch.int32))


def detect_stream(rows, lab, pos, vel, sv, rh, pk):
    """P4: the kernel ``detect_stream_rows`` on CUDA tensors,
    :func:`detect_stream_torch` on CPU tensors."""
    if _cuda.on_cpu(lab, "detect stream"):
        return detect_stream_torch(rows, lab, pos, vel, sv, rh, pk)
    return _cuda.detect_stream_rows(rows, lab, pos, vel, sv, rh, pk)


def probe_inputs(halos: int, cap: int, snaps: int, device):
    """``(rows [6, R, W], lab [S, R, W], pos [S, 3, R, W], vel, carry)``
    on ``device``: the churn workload (seed 0, 7 % churn, as the JAX
    probe draws it), the frame-row stand-in and an untracked carry with
    f32 r-hat."""
    n = halos * cap
    if n % ROW_WIDTH:
        raise ValueError(f"{halos} x {cap} slots are not rows of "
                         f"{ROW_WIDTH}")
    r = n // ROW_WIDTH
    lab, pos, vel, _, _ = label_churn_workload(halos, cap, snaps)

    def dev(a, *shape):
        return torch.from_numpy(a.reshape(snaps, *shape, r, ROW_WIDTH)).to(
            device)

    lab, pos, vel = dev(lab), dev(pos, 3), dev(vel, 3)
    rows = torch.cat([pos[0], torch.zeros_like(pos[0])], dim=0)
    carry = init_label_carry(n, row_width=ROW_WIDTH, device=device)
    return rows, lab, pos, vel, carry


def _scan(step, rows, lab, pos, vel, carry):
    def run():
        c = (carry.lab_sv, carry.rhat, carry.packed)
        for s in range(lab.shape[0]):
            c = step(rows, lab[s], pos[s], vel[s], *c)[:3]
        return c
    return run


VARIANTS = {
    "full": lambda *a: detect_label(*a, 0.0, pericentric=True,
                                    box_size=BOX),
    "stream": detect_stream,
}


def main(halos: int = 64, cap: int = 32768, snaps: int = 12,
         variants=("full", "stream"), device="cuda") -> dict:
    """Times each of ``variants`` over the workload's snapshots and
    prints ``name ms/snap GB/s``; returns ``{name: {"ms", "bytes",
    "gbps"}}`` (``ms`` a snapshot, ``bytes`` a call)."""
    dev = resolve_device(device, "detect_probe.main")
    rows, lab, pos, vel, carry = probe_inputs(halos, cap, snaps, dev)
    r, w = lab.shape[1:]
    nbytes = PARTICLE_BYTES * r * w + 4 * r
    print(f"data ready: N={r * w} S={snaps} on {device_label(dev)}",
          flush=True)
    results = {}
    for name in variants:
        ms = timed_ms(_scan(VARIANTS[name], rows, lab, pos, vel, carry),
                      dev, reps=1) / snaps
        results[name] = dict(ms=ms, bytes=nbytes, gbps=nbytes / ms / 1e6)
        print(f"{name:10s} {ms:9.4f} ms/snap  {nbytes / ms / 1e6:8.1f} GB/s "
              f"({nbytes} B a call)", flush=True)
    return results


def _cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--halos", type=int, default=64)
    ap.add_argument("--cap", type=int, default=32768)
    ap.add_argument("--snaps", type=int, default=12)
    ap.add_argument("--variants", type=str, default="full,stream")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    main(args.halos, args.cap, args.snaps, names,
         "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    _cli()
