"""Stream-rate probe: ``x + 1`` over a ``[rows, 65536]`` f32 plane (twin
of the JAX package's ``benchmarks/dma_probe.py``).

Each variant keeps its JAX name and parameters:

  xla, xla5    torch's ``x + 1`` (the JAX ``jit(x + 1)``, "the speed of
               light"): the library line, no kernel of the port
  auto*        P1, ``stream_add_rows``: the JAX grid of row blocks
               becomes a grid of the card (the blocks every SM holds
               at once, each a balanced share of the flat tensor);
               ``block_rows`` is checked and sets nothing
  man*         P2, ``stream_add_ring``: an ``n_buf``-slot
               shared-memory ring a block filled and drained by TMA bulk
               copies, a slot refilled only after its store has read it
               out (the JAX rotating VMEM buffer); warp-specialised, as
               many blocks an SM as their rings fit, each taking its
               stages from a shared counter
  split32x4,   P3, ``stream_add_split``: separate in and out rings,
  dual*, quad* ``n_dma`` bulk copies a stage each way, a
               warp-specialised pipeline (a producer warp, compute
               warps, a store thread on mbarriers)
  pallas5,     five planes of ``rows // 5`` rows, one call each
  xla5

A JAX chunk of ``chunk_rows`` rows of 256 KiB does not fit a block's
227 KiB of shared memory: a ring stage here is ``chunk_rows *
STAGE_ROW_BYTES`` = ``chunk_rows`` x 512 bytes (1/512 of the JAX chunk),
so the variants' rings are 32 to 128 KiB a block (two rings for the
split variants) and ``n_buf`` and ``n_dma`` are the JAX ones.  Unlike
the TPU kernels, which leave the rows past the last whole block or chunk
undefined (``pallas5``'s 409-row planes at 2048 rows), every variant
writes every row, and the rates are computed from the bytes actually
moved: each input element read once and each output element written
once.

Times are device milliseconds between CUDA events, the median of
:data:`RUNS` timings of :data:`REPS` back-to-back calls with the card
held busy while the host queues them; on the CPU (``device='cpu'``, the
plain versions) they are the host's clock.

Usage: python -m orbitanalysis_tpu_torch.probes.dma_probe [rows]
       [variant ...] [--cpu]
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from orbitanalysis_tpu_torch.ops import _cuda
from orbitanalysis_tpu_torch.utils.device import resolve_device

LANES = 65536  # one full f32 plane row: 256 KiB
#: Bytes of a ring stage for each row of a JAX chunk.
STAGE_ROW_BYTES = 512
RUNS, REPS, WARMUP = 5, 10, 3
#: Cycles of the sleep kernel that holds the card busy while the host
#: queues the timed calls (~50 ms at the H100's clock).
SLEEP_CYCLES = 100_000_000


def timed_ms(fn, device, runs=RUNS, reps=REPS, warmup=WARMUP) -> float:
    """Median milliseconds of one ``fn()`` over ``runs`` timings of
    ``reps`` back-to-back calls, after ``warmup`` calls: device time
    between CUDA events on a CUDA ``device`` (a sleep kernel first holds
    the card busy, so the events bracket the card's work and not the
    host's queuing), the host's clock on the CPU."""
    device = torch.device(device)
    for _ in range(warmup):
        fn()
    samples = []
    for _ in range(runs):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            samples.append(a.elapsed_time(b) / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            samples.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(samples)


def stream_add_torch(x: torch.Tensor) -> torch.Tensor:
    """The plain version of P1-P3: ``x + 1``."""
    return x + 1.0


def stream_add_rows(x: torch.Tensor, block_rows: int) -> torch.Tensor:
    """P1: ``x + 1`` over ``x [R, L]`` on a grid of the card on CUDA
    tensors (every row written; ``block_rows`` checked),
    :func:`stream_add_torch` on CPU tensors."""
    if _cuda.on_cpu(x, "stream"):
        return stream_add_torch(x)
    return _cuda.stream_add_rows(x, block_rows)


def stream_add_ring(x: torch.Tensor, chunk_rows: int,
                    n_buf: int) -> torch.Tensor:
    """P2: ``x + 1`` through an ``n_buf``-slot TMA ring of ``chunk_rows
    * STAGE_ROW_BYTES`` bytes a slot on CUDA tensors,
    :func:`stream_add_torch` on CPU tensors."""
    if _cuda.on_cpu(x, "stream"):
        return stream_add_torch(x)
    return _cuda.stream_add_ring(x, chunk_rows * STAGE_ROW_BYTES, n_buf)


def stream_add_split(x: torch.Tensor, chunk_rows: int, n_buf: int,
                     n_dma: int) -> torch.Tensor:
    """P3: ``x + 1`` through separate in and out TMA rings of ``n_buf``
    slots of ``chunk_rows * STAGE_ROW_BYTES`` bytes, ``n_dma`` copies a
    stage each way, on CUDA tensors; :func:`stream_add_torch` on CPU
    tensors."""
    if _cuda.on_cpu(x, "stream"):
        return stream_add_torch(x)
    return _cuda.stream_add_split(x, chunk_rows * STAGE_ROW_BYTES, n_buf,
                                  n_dma)


def _variant(fn, kernel, **params):
    """``fn`` with the name of the kernel it launches (None for torch's
    own ``x + 1``), its JAX parameters and its plane count (0: one
    plane, not a tuple)."""
    fn.kernel, fn.params, fn.n_planes = kernel, params, 0
    return fn


def xla_variant():
    return _variant(lambda x: stream_add_torch(x), None)


def auto_variant(block_rows=8):
    return _variant(lambda x: stream_add_rows(x, block_rows),
                    "stream_add_rows", block_rows=block_rows)


def manual_variant(chunk_rows=16, n_buf=4):
    return _variant(lambda x: stream_add_ring(x, chunk_rows, n_buf),
                    "stream_add_ring", chunk_rows=chunk_rows, n_buf=n_buf)


def split_variant(chunk_rows=32, n_buf=4, n_dma=1):
    return _variant(lambda x: stream_add_split(x, chunk_rows, n_buf, n_dma),
                    "stream_add_split", chunk_rows=chunk_rows, n_buf=n_buf,
                    n_dma=n_dma)


def multi_variant(inner, n_planes=5):
    """``n_planes`` independent planes through ``inner``, one call each
    (input planes of ``rows // n_planes`` rows, as the JAX probe cuts
    them)."""

    def fn(xs):
        return tuple(inner(x) for x in xs)

    fn.kernel, fn.params, fn.n_planes = inner.kernel, inner.params, n_planes
    return fn


VARIANTS = {
    "xla": xla_variant,
    "xla5": lambda: multi_variant(xla_variant()),
    "pallas5": lambda: multi_variant(auto_variant(8)),
    "man128x2": lambda: manual_variant(128, 2),
    "split32x4": lambda: split_variant(32, 4, 1),
    "dual32x4": lambda: split_variant(32, 4, 2),
    "quad64x2": lambda: split_variant(64, 2, 4),
    "auto8": lambda: auto_variant(8),
    "auto32": lambda: auto_variant(32),
    "man16x4": lambda: manual_variant(16, 4),
    "man32x4": lambda: manual_variant(32, 4),
    "man64x2": lambda: manual_variant(64, 2),
    "man64x4": lambda: manual_variant(64, 4),
    "man32x8": lambda: manual_variant(32, 8),
    "man8x8": lambda: manual_variant(8, 8),
}


def probe_input(rows: int, device) -> torch.Tensor:
    """The probe's ``[rows, LANES]`` f32 plane (the JAX script's draw:
    ``default_rng(0).normal``) on ``device``."""
    x = np.random.default_rng(0).normal(size=(rows, LANES)).astype(
        np.float32)
    return torch.from_numpy(x).to(device)


def variant_input(fn, x: torch.Tensor):
    """``x`` itself, or for a multi-plane variant the tuple of its planes
    of ``rows // n_planes`` rows (the rows past them left out, as JAX
    leaves them)."""
    n = fn.n_planes
    if not n:
        return x
    rows = x.shape[0] // n
    return tuple(x[i * rows:(i + 1) * rows] for i in range(n))


def moved_bytes(xin) -> int:
    """Bytes a call moves: each input element read once and each output
    element written once."""
    planes = xin if isinstance(xin, tuple) else (xin,)
    return sum(2 * p.numel() * p.element_size() for p in planes)


def device_label(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "the CPU (host clock, plain versions)"


def main(rows: int = 2048, variants=None, device="cuda") -> dict:
    """Runs each name of ``variants`` (all of :data:`VARIANTS` by
    default) on a ``[rows, LANES]`` plane and prints ``name ms GB/s``;
    returns ``{name: {"ms", "bytes", "gbps"}}``."""
    dev = resolve_device(device, "dma_probe.main")
    names = list(variants or VARIANTS)
    x = probe_input(rows, dev)
    print(f"plane [{rows}, {LANES}] f32, {rows * LANES * 4 / 2**20:.0f} MiB, "
          f"on {device_label(dev)}", flush=True)
    results = {}
    for name in names:
        fn = VARIANTS[name]()
        xin = variant_input(fn, x)
        nbytes = moved_bytes(xin)
        ms = timed_ms(lambda: fn(xin), dev)
        results[name] = dict(ms=ms, bytes=nbytes, gbps=nbytes / ms / 1e6)
        print(f"{name:10s} {ms:9.4f} ms  {nbytes / ms / 1e6:8.1f} GB/s "
              f"({nbytes} B)", flush=True)
    return results


def _cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="?", type=int, default=2048)
    ap.add_argument("variants", nargs="*", help=", ".join(VARIANTS))
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain versions on the CPU")
    args = ap.parse_args(argv)
    unknown = set(args.variants) - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    main(args.rows, args.variants or None, "cpu" if args.cpu else "cuda")


if __name__ == "__main__":
    _cli()
