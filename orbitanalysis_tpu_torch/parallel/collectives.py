"""The collectives of the distributed engines, named after the ``lax``
operations of the JAX package they replace.

JAX runs its collectives inside ``shard_map`` over the devices of one
mesh; here each device is one process of a ``torch.distributed`` world
and the collectives run between the kernels, on the group of one mesh
axis:

- :func:`psum` — ``lax.psum`` (``parallel/hash_sharded.py:276-277``,
  ``parallel/label_sharded.py:126``): ``all_reduce(SUM)``;
- :func:`all_gather` — ``lax.all_gather`` (``parallel/nbody_sharded.py:
  92-93``): ``all_gather_into_tensor``;
- :func:`all_to_all` — ``lax.all_to_all`` (``parallel/hash_sharded.py:
  547-550``, ``models/pm_sharded.py:68-70``): ``all_to_all_single``;
- :func:`ppermute` — ``lax.ppermute`` (``models/pm_sharded.py:269-272``):
  one ``all_to_all_single`` with uneven splits, this rank's block going
  only to its destination;
- :func:`process_allgather` — ``multihost_utils.process_allgather``
  (``engine/tracker.py:90-106``): an all-gather whose result comes back
  to the host as a NumPy array on every rank.

Without a process group every collective is the identity, as the JAX
multi-host helpers are on one host; on a group of one rank the backend
still runs it (its result is the identity).  Complex tensors cross as
their ``torch.view_as_real`` views (two float32 words an element), so a
backend sees real tensors only and their bytes count as complex64's.

Each collective adds the bytes this rank hands to it to
:func:`sent_bytes` (a plain count a name, as the kernels count their
launches), so a run can state its collective volume a step.

Transport.  Every tensor goes to its group's backend as it is.  An
NCCL group moves CUDA tensors device to device and never stages through
the host; a gloo group moves CUDA tensors through host buffers inside
its backend.  A collective that its backend refuses (an NCCL group given
CPU tensors, say) raises, and never falls back to another transport or
to a loop of point-to-point copies.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist


_SENT = {"psum": 0, "all_gather": 0, "all_to_all": 0, "ppermute": 0}


def sent_bytes() -> dict:
    """Bytes this rank has handed to each collective since the last
    :func:`reset_sent_bytes`."""
    return dict(_SENT)


def reset_sent_bytes():
    for k in _SENT:
        _SENT[k] = 0


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def group_size(group=None) -> int:
    """Ranks in ``group`` (the world when None); 1 without a process
    group."""
    if not _active():
        return 1
    return dist.get_world_size(group)


def group_rank(group=None) -> int:
    """This rank's index in ``group``; 0 without a process group."""
    if not _active():
        return 0
    return dist.get_rank(group)


def backend_of(group=None) -> str:
    """The backend name of ``group`` (``'nccl'``, ``'gloo'``, ...)."""
    return str(dist.get_backend(group)).lower()


def backend_device(group=None) -> torch.device:
    """The device a host value takes to cross ``group``: the current
    CUDA device for NCCL, the CPU for every other backend."""
    if backend_of(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (a new tensor on
    ``x``'s device; ``x`` itself is not changed)."""
    if not _active():
        return x
    _SENT["psum"] += x.numel() * x.element_size()
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def all_gather(x: torch.Tensor, group=None, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in rank order: concatenated along ``axis``
    (``tiled=True``) or stacked on a new ``axis``."""
    if not _active():
        return x if tiled else x.unsqueeze(axis)
    n = group_size(group)
    _SENT["all_gather"] += x.numel() * x.element_size()
    src = x.contiguous()
    out = src.new_empty((n * src.numel(),))
    with warnings.catch_warnings():
        # renamed in newer torch releases; the old name is the one every
        # release this port runs on has
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, src.reshape(-1), group=group)
    out = out.view((n,) + tuple(src.shape))
    if not tiled:
        return out.movedim(0, axis)
    return torch.cat(out.unbind(0), dim=axis)


def all_to_all(x: torch.Tensor, group=None, split_axis: int = 0,
               concat_axis: int = 0) -> torch.Tensor:
    """The tiled all-to-all: ``x`` is cut into ``n`` equal blocks along
    ``split_axis``, block ``d`` goes to rank ``d``, and the blocks each
    rank receives are concatenated along ``concat_axis`` in source-rank
    order."""
    if not _active():
        return x
    n = group_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(
            f"all_to_all: axis {split_axis} of length {x.shape[split_axis]} "
            f"does not split over {n} ranks")
    _SENT["all_to_all"] += x.numel() * x.element_size()
    src = _real(x.movedim(split_axis, 0).contiguous())
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    out = _complex(out, x)
    blocks = out.movedim(0, split_axis).chunk(n, dim=split_axis)
    return torch.cat(blocks, dim=concat_axis)


def ppermute(x: torch.Tensor, group=None, perm=()) -> torch.Tensor:
    """``lax.ppermute``: ``perm`` is a list of ``(src, dst)`` pairs of
    group ranks; this rank's ``x`` goes to its destination and the result
    is the ``x`` of its source (zeros where no pair names this rank as a
    destination, as in JAX).  One ``all_to_all_single`` whose splits are
    ``x``'s size toward the destination and 0 elsewhere; without a
    process group the identity (on one device every permutation is a
    self-send)."""
    if not _active():
        return x
    n = group_size(group)
    me = group_rank(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute: {perm} is not a permutation")
    src_t = _real(x.contiguous())
    rows = src_t.shape[0] if src_t.dim() else 1
    send = [0] * n
    recv = [0] * n
    if dst:
        send[dst[0]] = rows
        _SENT["ppermute"] += x.numel() * x.element_size()
    if src:
        recv[src[0]] = rows
    out = torch.zeros_like(src_t)
    flat_in = src_t.reshape(rows, -1)
    flat_out = out.reshape(rows, -1)
    if not src:
        # nothing arrives: the buffer the backend fills is empty
        flat_out = flat_out[:0]
    dist.all_to_all_single(flat_out, flat_in if dst else flat_in[:0],
                           output_split_sizes=recv, input_split_sizes=send,
                           group=group)
    return _complex(out, x)


def _real(x: torch.Tensor) -> torch.Tensor:
    """A complex tensor's ``view_as_real`` (the backends move real
    words); any other tensor as it is."""
    return torch.view_as_real(x) if x.is_complex() else x


def _complex(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`_real` for a result shaped as ``like``."""
    return torch.view_as_complex(y) if like.is_complex() else y


def process_allgather(x, group=None, tiled: bool = False) -> np.ndarray:
    """Every rank's ``x`` (a tensor, or a host array of the same shape
    on every rank), gathered to the host of every rank as NumPy:
    stacked on a new leading axis, or concatenated on axis 0 with
    ``tiled=True``.  A host array crosses on the group's device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
        if _active():
            x = x.to(backend_device(group))
    return all_gather(x, group, axis=0, tiled=tiled).cpu().numpy()
