"""On-the-fly orbit tracking: one snapshot pair a call (twin of
``orbitanalysis_tpu/engine/onthefly.py``).

Stateless across calls, so a running simulation can call it: it takes
exactly the pair ``(snapshot_number, snapshot_number - 1)`` and writes
one file a snapshot in the reference's on-the-fly schema: apsis,
entered and departed ID sets with per-halo offsets over the *full* halo
list (-1 progenitor links give empty blocks), the angle change of every
matched pair, and the region metadata of both snapshots.

No Hubble-flow term is added to velocities here, as in the reference's
on-the-fly driver: its caller passes physical velocities.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from orbitanalysis_tpu_torch.engine import io_hdf5
from orbitanalysis_tpu_torch.engine.io_hdf5 import (
    apsis_tag,
    normalize_mode_savefiles,
)
from orbitanalysis_tpu_torch.engine.packing import (
    pack_snapshot,
    required_capacity,
)
from orbitanalysis_tpu_torch.engine.tracker import _stage
from orbitanalysis_tpu_torch.ops.apsis import init_carry, make_orbit_step
from orbitanalysis_tpu_torch.utils.device import resolve_device
from orbitanalysis_tpu_torch.utils.padding import unpack_mask


def track_orbits(
    snapshot_number,
    progenitor_links,
    regions,
    load_snapshot_data,
    savefile,
    mode: str = "pericentric",
    verbose: bool = True,
    capacity: Optional[int] = None,
    headroom: float = 1.1,
    id_dtype=np.int32,
    device="cuda",
    writer=None,
):
    """Detect apsides between snapshots ``snapshot_number`` and
    ``snapshot_number - 1``.

    ``progenitor_links`` is ``[2, n_halos]``: row 0 the halo IDs at
    ``snapshot_number``, row 1 their progenitors at the previous
    snapshot, -1 where a halo has none.  ``savefile`` is a path template
    formatted with the zero-padded snapshot number, or for
    ``mode='both'`` a ``(pericentric, apocentric)`` pair of templates:
    both snapshots are then loaded and packed once and only the
    detection runs per mode.  ``device`` is the torch device of the
    step (default ``'cuda'``, RuntimeError without CUDA: pass
    ``device='cpu'``); ``writer`` is the file writer (default
    :class:`~orbitanalysis_tpu_torch.engine.io_hdf5.H5Writer`,
    :class:`~orbitanalysis_tpu_torch.engine.io_hdf5.MemoryWriter` keeps
    the files in memory).
    """
    device = resolve_device(device, "track_orbits_onthefly")
    writer = io_hdf5.H5Writer() if writer is None else writer
    modes, savefiles = normalize_mode_savefiles(mode, savefile)
    progenitor_links = np.asarray(progenitor_links)
    n_halos = progenitor_links.shape[1]

    meta = []  # (region_positions_full, region_radii_full)
    raw = []
    box_size = None
    lengths_all = []
    for s, halo_ids in zip([snapshot_number, snapshot_number - 1],
                           progenitor_links):
        rows = np.argwhere(halo_ids != -1).flatten()
        out = regions(s, halo_ids[rows])
        region_pos = np.atleast_2d(np.asarray(out[0]))
        region_rad = np.atleast_1d(np.asarray(out[1]))

        snapshot = load_snapshot_data(s, region_pos, region_rad)
        if "box_size" in snapshot:
            box_size = snapshot["box_size"]
        offsets = np.asarray(snapshot["region_offsets"], dtype=np.int64)
        lengths = np.diff(np.concatenate((offsets, [len(snapshot["ids"])])))
        lengths_all.append(int(lengths.max(initial=0)))
        raw.append((snapshot, rows, region_pos))

        pos_full = -np.ones((n_halos, 3), dtype=np.float64)
        pos_full[rows] = region_pos
        rad_full = -np.ones(n_halos, dtype=np.float64)
        rad_full[rows] = region_rad
        meta.append((pos_full, rad_full))

    cap = capacity or required_capacity(lengths_all, headroom)
    cur, prev = (pack_snapshot(snapshot, rows, n_halos, cap, region_pos,
                               id_dtype=id_dtype)
                 for snapshot, rows, region_pos in raw)
    cur_batch, prev_batch = _stage(cur, 0.0, device), _stage(prev, 0.0,
                                                             device)

    apsis_by_mode = {}
    shared = None  # the channels no mode changes, fetched once
    for mname in modes:
        step = make_orbit_step(mode=mname, box_size=box_size,
                               id_dtype=id_dtype, with_dtheta=True)
        t0 = time.time()
        carry, seed_events = step(
            init_carry(n_halos, cap, id_dtype=id_dtype, device=device),
            prev_batch)
        _, events = step(carry, cur_batch)
        apsis_by_mode[mname] = events.apsis.cpu().numpy()
        if verbose:
            print("Identified {}s in {} s\n".format(
                apsis_tag(mname), time.time() - t0))
        if shared is None:
            _, angle_changes = unpack_mask(events.matched_prev.cpu().numpy(),
                                           events.dtheta.cpu().numpy())
            departed = unpack_mask(events.departed.cpu().numpy(), prev.ids)
            entered = unpack_mask(events.entered.cpu().numpy(), cur.ids)
            bulk = np.stack([events.bulk_vel.cpu().numpy(),
                             seed_events.bulk_vel.cpu().numpy()])
            # halos with no region get NaN bulk velocities (the
            # reference's mean over an empty slice)
            for k, (_pos_full, rad_full) in enumerate(meta):
                bulk[k][rad_full < 0] = np.nan
            shared = (angle_changes, entered, departed, bulk)

    angle_changes, entered, departed, bulk = shared
    for mname, fname in zip(modes, savefiles):
        tag = apsis_tag(mname)
        apsis_offsets, apsis_ids = unpack_mask(apsis_by_mode[mname],
                                               prev.ids)
        datasets = {
            tag + "_offsets": apsis_offsets,
            tag + "_IDs": apsis_ids,
            "angles": angle_changes,
            "entered_offsets": entered[0],
            "entered_IDs": entered[1],
            "departed_offsets": departed[0],
            "departed_IDs": departed[1],
            "progenitor_links": progenitor_links,
            "region_radii": np.stack([m[1] for m in meta]),
            "region_positions": np.stack([m[0] for m in meta]),
            "bulk_velocities": bulk,
        }
        if verbose:
            print("Saving to file...")
            t0 = time.time()
        writer.write_flat(
            fname.format("%0.3d" % snapshot_number), datasets,
            {} if box_size is None else {"box_size": box_size})
        if verbose:
            print("Saved to file in {} s\n".format(time.time() - t0))
