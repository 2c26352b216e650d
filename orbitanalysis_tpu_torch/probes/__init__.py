"""The stream probes of the port (twins of the JAX package's
``benchmarks/dma_probe.py`` and ``benchmarks/detect_probe.py``): what
the card streams for a plain ``x + 1`` (P1-P3) and for the label detect
kernels' I/O (P4), the floors the port's byte-bound kernels are read
against.  Each runs as ``python -m orbitanalysis_tpu_torch.probes.<name>``
on the card, or with ``--cpu`` through the plain versions:

- :mod:`~orbitanalysis_tpu_torch.probes.dma_probe`: ``x + 1`` over a
  ``[rows, 65536]`` f32 plane through torch, a row-tile kernel (P1) and
  TMA rings (P2, P3);
- :mod:`~orbitanalysis_tpu_torch.probes.detect_probe`: the label detect
  kernel K9 against a copy kernel with its streams (P4), on the
  benchmark's churn workload.
"""
