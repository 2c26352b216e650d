"""Multi-process glue (twin of ``orbitanalysis_tpu/parallel/multihost.py``).

The JAX package drives every device of a mesh from one process and
keeps this module for its multi-host mode, one process a host.  The
port is that mode with one process a device: one rank of a
``torch.distributed`` world a GPU (or, on the CPU, a process), and

- ``initialize`` once per process (from the launcher's environment, as
  ``torchrun`` sets it, or from explicit arguments);
- the collectives of the engines run on the groups of a mesh's axes
  (:mod:`~orbitanalysis_tpu_torch.parallel.collectives`);
- the host work is replicated: every rank loads and packs the same
  snapshot, takes part in every gather of device results, and rank 0
  alone writes the savefile (:func:`is_primary`).

Without a process group every function here is the identity, so the
engines do not depend on the number of processes.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from orbitanalysis_tpu_torch.parallel.collectives import (
    group_rank,
    group_size,
    process_allgather,
)


def local_rank() -> int:
    """The rank's index on its host: ``LOCAL_RANK`` from the launcher,
    else the global rank (one host)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return group_rank()


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None):
    """Start this process's ``torch.distributed`` world (a no-op when it
    is running already, or with no arguments outside a launcher).

    ``coordinator_address``: an ``init_method`` URL (``'tcp://host:port'``,
    ``'file:///path'``, ``'env://'``) or a bare ``'host:port'`` (JAX's
    form, taken as TCP).  Without it and ``num_processes``, a launcher's
    environment (``WORLD_SIZE`` and ``RANK``, as ``torchrun`` sets them)
    starts the world through ``env://``.  ``backend``: ``'nccl'`` where
    CUDA is available and ``'gloo'`` elsewhere unless named; an NCCL
    rank first selects its GPU, its local rank modulo the device count.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None and num_processes is None:
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            return  # one process: nothing to start
        coordinator_address = "env://"
    if coordinator_address is None:
        raise ValueError("num_processes needs coordinator_address")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = (process_id if process_id is not None
                     else os.environ.get("RANK", 0))
        torch.cuda.set_device(int(local) % torch.cuda.device_count())
    kw = {}
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(backend, init_method=init_method, **kw)


def shutdown():
    """End this process's world (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """Processes in the world (1 without a group)."""
    return group_size()


def is_primary() -> bool:
    """True on the process that performs the host-side writes."""
    return group_rank() == 0


def allgather_host(x) -> np.ndarray:
    """Gather a per-process host array of the same shape on every
    process to every process, stacked in rank order (the identity on
    one process)."""
    if group_size() == 1:
        return np.asarray(x)
    return process_allgather(np.asarray(x))


def broadcast_from_primary(x):
    """Process 0's value of ``x`` (any picklable host value) on every
    process (the identity on one process)."""
    if group_size() == 1:
        return x
    box = [x]
    dist.broadcast_object_list(box, src=0)
    return box[0]
