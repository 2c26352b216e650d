"""Progenitor linking: ``main_branches`` without a merger tree (twin of
``orbitanalysis_tpu/progenitors.py``).

- :func:`get_central_particle_ids`: the n innermost particles of each
  halo, one segmented sort on the host; :func:`get_central_particle_ids_
  device` pads the regions and takes a top-k on the device.
- :func:`find_main_progenitors`: each descendant's tracked central
  particles vote for the halo of the earlier catalog that holds most of
  them (one sort, a run-length count and a segmented argmax on the
  host); :func:`find_main_progenitors_device` runs the catalog-sized
  work on the device.  Ties go to the smaller halo number, the
  reference's first argmax.
"""

from __future__ import annotations

import numpy as np
import torch

from orbitanalysis_tpu_torch.utils.device import resolve_device
from orbitanalysis_tpu_torch.utils.numerics import periodic_displacement
from orbitanalysis_tpu_torch.utils.padding import round_up


def _minimum_image_f32(rel, box_size):
    """The JAX package's host minimum image, which runs its jnp
    ``periodic_displacement`` on float64 NumPy without x64: the
    displacement and the box become float32 and so does the result."""
    rel = np.asarray(rel, dtype=np.float32)
    box = np.asarray(box_size, dtype=np.float32)
    return rel - box * np.round(rel / box)


def get_central_particle_ids(snapshot, halo_positions, n=100):
    """IDs of the ``n`` particles closest to each halo centre.

    ``snapshot`` follows the loader contract (``ids``, ``coordinates``,
    ``region_offsets``, optional ``box_size``).  Returns ``(central_ids,
    offsets)``, each halo's block ordered by increasing radius (ties by
    load order).  With a box, radii are float32, as in the JAX package.
    """
    ids = np.asarray(snapshot["ids"])
    coords = np.asarray(snapshot["coordinates"], dtype=np.float64)
    offsets = np.asarray(snapshot["region_offsets"], dtype=np.int64)
    n_halos = len(offsets)
    lengths = np.diff(np.concatenate((offsets, [len(ids)])))

    halo_positions = np.atleast_2d(np.asarray(halo_positions,
                                              dtype=np.float64))
    seg = np.repeat(np.arange(n_halos), lengths)
    rel = coords - halo_positions[seg]
    if "box_size" in snapshot:
        rel = _minimum_image_f32(rel, snapshot["box_size"])
    rads = np.sqrt((rel * rel).sum(-1))

    # one global lexsort (segment-major, radius-minor), then the first n
    # of each segment
    order = np.lexsort((rads, seg))
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    rank = np.arange(len(ids)) - starts[seg]
    central_ids = ids[order][rank < n]
    out_lens = np.minimum(lengths, n)
    out_offsets = np.concatenate(([0], np.cumsum(out_lens)))[:-1]
    return central_ids, out_offsets


def get_central_particle_ids_device(snapshot, halo_positions, n=100,
                                    device="cuda"):
    """Device form of :func:`get_central_particle_ids` for large
    catalogs: the regions padded to ``[n_halos, capacity]`` rows and the
    ``n`` smallest float32 squared radii of each taken by a top-k on
    ``device`` (default ``'cuda'``; RuntimeError without CUDA).

    The top-k runs on int64 keys, the radius's float32 bits above the
    slot, so equal radii go in slot order, as ``lax.top_k`` puts them.
    The rows hold load indices rather than the IDs, so IDs of any width
    come back as they went in.  Returns the same ``(central_ids,
    offsets)``.
    """
    device = resolve_device(device, "get_central_particle_ids_device")
    ids = np.asarray(snapshot["ids"])
    coords = np.asarray(snapshot["coordinates"], dtype=np.float32)
    offsets = np.asarray(snapshot["region_offsets"], dtype=np.int64)
    n_halos = len(offsets)
    lengths = np.diff(np.concatenate((offsets, [len(ids)])))
    capacity = round_up(int(lengths.max(initial=1)))
    k = min(n, capacity)

    seg = np.repeat(np.arange(n_halos), lengths)
    col = np.arange(len(ids)) - offsets[seg]
    flat = torch.from_numpy(seg * capacity + col).to(device)
    index = torch.full((n_halos * capacity,), -1, dtype=torch.int64,
                       device=device)
    index[flat] = torch.arange(len(ids), device=device)
    pos = torch.zeros((n_halos * capacity, 3), dtype=torch.float32,
                      device=device)
    pos[flat] = torch.from_numpy(coords).to(device)
    centers = torch.from_numpy(np.atleast_2d(np.asarray(
        halo_positions, dtype=np.float32))).to(device)

    rel = pos.view(n_halos, capacity, 3) - centers[:, None, :]
    if "box_size" in snapshot:
        rel = periodic_displacement(rel, snapshot["box_size"])
    r2 = (rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
          + rel[..., 2] * rel[..., 2])
    index = index.view(n_halos, capacity)
    r2 = torch.where(index >= 0, r2, torch.full_like(r2, float("inf")))
    # r2 >= 0, so its bits order as the value; the slot breaks ties
    slot = torch.arange(capacity, device=device)
    key = (r2.view(torch.int32).to(torch.int64) << 32) | slot
    _, sel = torch.topk(key, k, dim=-1, largest=False, sorted=True)
    taken = torch.gather(index, 1, sel).cpu().numpy()

    counts = np.minimum(lengths, n)
    keep = np.arange(k)[None, :] < counts[:, None]
    out_offsets = np.concatenate(([0], np.cumsum(counts)))[:-1]
    return ids[taken[keep]], out_offsets


def _vote_inputs(halo_pids, halo_offsets, tracked_pids, tracked_offsets):
    halo_pids = np.asarray(halo_pids)
    tracked_pids = np.asarray(tracked_pids)
    halo_offsets = np.asarray(halo_offsets, dtype=np.int64)
    tracked_offsets = np.asarray(tracked_offsets, dtype=np.int64)
    halo_lens = np.diff(np.concatenate((halo_offsets, [len(halo_pids)])))
    tracked_lens = np.diff(
        np.concatenate((tracked_offsets, [len(tracked_pids)])))
    # duplicate tracked IDs vote once: keep first occurrences
    _, unique_inds = np.unique(tracked_pids, return_index=True)
    vote_ok = np.zeros(len(tracked_pids), dtype=bool)
    vote_ok[unique_inds] = True
    return halo_pids, tracked_pids, halo_lens, tracked_lens, vote_ok


def find_main_progenitors_device(halo_pids, halo_offsets, tracked_pids,
                                 tracked_offsets, device="cuda"):
    """Device form of :func:`find_main_progenitors` on ``device``
    (default ``'cuda'``; RuntimeError without CUDA).

    The catalog is sorted once (stably, as the host form sorts it) and
    the tracked IDs found by ``searchsorted``; each vote is a
    (descendant, halo) pair packed into an int64 key, sorted, counted by
    runs, and the winner of each descendant taken by a segment max of
    ``count << halo_bits | ~halo`` (ties to the smaller halo).  IDs stay
    64-bit on the device.  Where the packed vote cannot fit (count bits
    plus halo bits above 63) the host form runs instead; the results
    equal :func:`find_main_progenitors` in every case.
    """
    device = resolve_device(device, "find_main_progenitors_device")
    n_desc = len(tracked_offsets)
    if len(halo_pids) == 0 or len(tracked_pids) == 0:
        return [-1] * n_desc
    halo_pids, tracked_pids, halo_lens, tracked_lens, vote_ok = (
        _vote_inputs(halo_pids, halo_offsets, tracked_pids,
                     tracked_offsets))
    n_halos = len(halo_lens)
    bits_c = int(tracked_lens.max(initial=1)).bit_length()
    bits_h = max(int(n_halos - 1).bit_length(), 1)
    if bits_c + bits_h > 63:
        return find_main_progenitors(halo_pids, halo_offsets, tracked_pids,
                                     tracked_offsets)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    h_pids = dev(halo_pids.astype(np.int64))
    t_pids = dev(tracked_pids.astype(np.int64))
    h_num = torch.repeat_interleave(
        torch.arange(n_halos, device=device), dev(halo_lens))
    d_num = torch.repeat_interleave(
        torch.arange(n_desc, device=device), dev(tracked_lens))

    s_pids, order = torch.sort(h_pids, stable=True)
    s_num = h_num[order]
    pos = torch.searchsorted(s_pids, t_pids).clamp_(max=len(s_pids) - 1)
    found = (s_pids[pos] == t_pids) & dev(vote_ok)
    # votes -> per-(descendant, halo) runs of one sorted int64 key
    pair = torch.where(found, (d_num << bits_h) | s_num[pos],
                       torch.full_like(d_num, n_desc << bits_h))
    pair, _ = torch.sort(pair)
    new_run = torch.ones_like(pair, dtype=torch.bool)
    new_run[1:] = pair[1:] != pair[:-1]
    run_id = torch.cumsum(new_run, 0) - 1
    run_len = torch.bincount(run_id)[run_id]
    ds, vs = pair >> bits_h, pair & ((1 << bits_h) - 1)
    halo_mask = (1 << bits_h) - 1
    vote = (run_len << bits_h) | (halo_mask - vs)
    first = new_run & (ds < n_desc)
    best = torch.zeros(n_desc + 1, dtype=torch.int64, device=device)
    best.scatter_reduce_(0, torch.where(first, ds, n_desc),
                         torch.where(first, vote, 0), reduce="amax")
    best = best[:n_desc]
    out = torch.where(best > 0, halo_mask - (best & halo_mask), -1)
    return [int(x) for x in out.cpu().numpy()]


def find_main_progenitors(halo_pids, halo_offsets, tracked_pids,
                          tracked_offsets):
    """Majority-vote main progenitors.

    For each descendant's block of tracked central particles, the halo
    of the earlier catalog holding most of them.  Returns one halo
    number a descendant, -1 where no tracked particle is in any halo.
    """
    n_desc = len(tracked_offsets)
    if len(halo_pids) == 0 or len(tracked_pids) == 0:
        return [-1] * n_desc
    halo_pids, tracked_pids, halo_lens, tracked_lens, vote_ok = (
        _vote_inputs(halo_pids, halo_offsets, tracked_pids,
                     tracked_offsets))
    halo_number = np.repeat(np.arange(len(halo_lens)), halo_lens)
    desc_number = np.repeat(np.arange(n_desc), tracked_lens)

    # membership and lookup by one sort of the catalog
    order = np.argsort(halo_pids, kind="stable")
    sorted_pids = halo_pids[order]
    pos_c = np.minimum(np.searchsorted(sorted_pids, tracked_pids),
                       len(sorted_pids) - 1)
    found = (sorted_pids[pos_c] == tracked_pids) & vote_ok
    d = desc_number[found]
    v = halo_number[order[pos_c]][found]
    if len(d) == 0:
        return [-1] * n_desc

    # votes per (descendant, halo) pair: sort the pairs, count the runs
    pair_order = np.lexsort((v, d))
    ds, vs = d[pair_order], v[pair_order]
    new_pair = np.concatenate(
        ([True], (ds[1:] != ds[:-1]) | (vs[1:] != vs[:-1])))
    pair_start = np.where(new_pair)[0]
    pair_counts = np.diff(np.concatenate((pair_start, [len(ds)])))
    pair_desc = ds[pair_start]
    pair_halo = vs[pair_start]

    # segmented argmax over descendants; ties to the smaller halo
    best_order = np.lexsort((pair_halo, -pair_counts, pair_desc))
    bd = pair_desc[best_order]
    first = np.concatenate(([True], bd[1:] != bd[:-1]))
    out = -np.ones(n_desc, dtype=np.int64)
    out[bd[first]] = pair_halo[best_order][first]
    return list(out)
