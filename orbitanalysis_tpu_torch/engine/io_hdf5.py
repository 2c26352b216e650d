"""Savefile persistence in the reference's exact schema (twin of
``orbitanalysis_tpu/engine/io_hdf5.py``).

Layout, dataset for dataset:

- root attrs: ``mode``, ``box_size`` (when periodic)
- one group ``snapshot_%03d`` per processed snapshot (after the first),
  holding ``region_offsets`` (cumulative apsis counts per halo),
  ``{peri|apo}center_IDs``, ``angles`` (float16), ``halo_IDs``,
  ``final_descendant_IDs`` (absent on the final snapshot),
  ``region_radii``, ``region_positions``, ``bulk_velocities``
- an optional ``<savefile>.checkpoint`` sidecar with the per-particle
  cumulative ``angles`` of the last written snapshot and, for the
  aligned engine, each particle's stable ``layout_positions``; resume
  reads it (files the JAX package checkpointed included).

Every read and write goes through one writer object.  :class:`H5Writer`
writes the HDF5 files and imports ``h5py`` only when it touches a file,
so the package imports without h5py; :class:`MemoryWriter` has the
same methods and keeps the datasets in memory, for machines without
h5py.
"""

from __future__ import annotations

import os
import time

import numpy as np


def apsis_tag(mode: str) -> str:
    """'pericentric' -> 'pericenter', 'apocentric' -> 'apocenter'."""
    return mode[:-3] + "er"


def normalize_mode_savefiles(mode, savefile):
    """Validate ``(mode, savefile)`` and return ``(modes, savefiles)``
    lists: ``mode='both'`` takes a pair of distinct paths (pericentric
    first), a single mode takes one path."""
    if mode == "both":
        if isinstance(savefile, (str, bytes, os.PathLike)):
            raise ValueError(
                "mode='both' writes two reference-schema savefiles; "
                "pass savefile=(pericentric_path, apocentric_path)"
            )
        savefiles = [os.fspath(p) for p in savefile]
        if len(savefiles) != 2 or savefiles[0] == savefiles[1]:
            raise ValueError(
                "mode='both' needs two distinct savefile paths, "
                f"got {savefiles!r}"
            )
        return ["pericentric", "apocentric"], savefiles
    if mode in ("pericentric", "apocentric"):
        return [mode], [os.fspath(savefile)]
    raise ValueError(
        "Orbit detection mode not recognized. Please specify either "
        "'pericentric' or 'apocentric'."
    )


def snapshot_datasets(mode, apsis_ids, apsis_offsets, apsis_angles,
                      halo_ids, final_descendant_ids, region_radii,
                      region_positions, bulk_velocities):
    """The datasets of one ``snapshot_%03d`` group, in schema order and
    storage dtypes (angles as float16)."""
    ds = {
        "region_offsets": np.asarray(apsis_offsets),
        apsis_tag(mode) + "_IDs": np.asarray(apsis_ids),
        "angles": np.asarray(apsis_angles, dtype=np.float16),
        "halo_IDs": np.asarray(halo_ids),
    }
    if final_descendant_ids is not None:
        ds["final_descendant_IDs"] = np.asarray(final_descendant_ids)
    ds["region_radii"] = np.asarray(region_radii)
    ds["region_positions"] = np.asarray(region_positions)
    ds["bulk_velocities"] = np.asarray(bulk_velocities)
    return ds


def _snapshot_numbers(names, savefile) -> int:
    nums = sorted(int(k.split("_")[1]) for k in names
                  if k.startswith("snapshot_"))
    if not nums:
        raise ValueError(f"no snapshot groups in {savefile}; cannot resume")
    return nums[-1]


class H5Writer:
    """Reference-schema HDF5 files on disk (``h5py``)."""

    def initialize(self, savefile, mode, box_size, verbose=True):
        import h5py

        os.makedirs(os.path.dirname(os.path.abspath(savefile)),
                    exist_ok=True)
        with h5py.File(savefile, "w") as hf:
            hf.attrs["mode"] = mode
            if box_size is not None:
                hf.attrs["box_size"] = box_size
        if verbose:
            print("Savefile initialized\n")

    def append_snapshot(self, savefile, snapshot_number, datasets,
                        verbose=True):
        import h5py

        if verbose:
            print("Saving to file...")
            t0 = time.time()
        with h5py.File(savefile, "r+") as hf:
            g = hf.create_group("snapshot_%03d" % snapshot_number)
            for name, data in datasets.items():
                g.create_dataset(name, data=data)
        if verbose:
            print("Saved to file ({} s)\n".format(time.time() - t0))

    def write_checkpoint(self, savefile, angles, snapshot_number,
                         layout_positions=None):
        """Angle sidecar, angles stored in their own dtype (the carry's
        angle dtype), plus the aligned engine's stable positions."""
        import h5py

        with h5py.File(savefile + ".checkpoint", "w") as hf:
            hf.create_dataset("angles", data=np.asarray(angles))
            if layout_positions is not None:
                hf.create_dataset(
                    "layout_positions",
                    data=np.asarray(layout_positions, dtype=np.int32),
                )
            hf.attrs["snapshot_number"] = int(snapshot_number)

    def read_checkpoint(self, savefile, with_layout=False):
        """``(angles, snapshot_number[, layout_positions or None])``;
        raises OSError when there is no sidecar."""
        import h5py

        with h5py.File(savefile + ".checkpoint", "r") as hf:
            angles = hf["angles"][:]
            snap = int(hf.attrs.get("snapshot_number", -1))
            if not with_layout:
                return angles, snap
            layout = (hf["layout_positions"][:]
                      if "layout_positions" in hf else None)
            return angles, snap, layout

    def last_snapshot_number(self, savefile) -> int:
        """Resume anchor: number of the last written snapshot group."""
        import h5py

        with h5py.File(savefile, "r") as hf:
            return _snapshot_numbers(list(hf.keys()), savefile)


class MemoryWriter:
    """The :class:`H5Writer` interface over in-memory dictionaries.

    ``files[savefile]`` maps ``'attrs'`` to the root attributes and
    each ``snapshot_%03d`` group name to its ``{dataset: array}`` dict;
    ``checkpoints[savefile]`` holds the sidecar's arrays.
    """

    def __init__(self):
        self.files = {}
        self.checkpoints = {}

    def initialize(self, savefile, mode, box_size, verbose=True):
        attrs = {"mode": mode}
        if box_size is not None:
            attrs["box_size"] = box_size
        self.files[savefile] = {"attrs": attrs}

    def append_snapshot(self, savefile, snapshot_number, datasets,
                        verbose=True):
        f = self.files[savefile]
        name = "snapshot_%03d" % snapshot_number
        if name in f:
            raise ValueError(f"group {name} already exists in {savefile}")
        f[name] = {k: np.array(v) for k, v in datasets.items()}

    def write_checkpoint(self, savefile, angles, snapshot_number,
                         layout_positions=None):
        self.checkpoints[savefile] = dict(
            angles=np.array(angles),
            snapshot_number=int(snapshot_number),
            layout_positions=(
                None if layout_positions is None
                else np.asarray(layout_positions, dtype=np.int32)
            ),
        )

    def read_checkpoint(self, savefile, with_layout=False):
        ck = self.checkpoints.get(savefile)
        if ck is None:
            raise OSError(f"no checkpoint for {savefile}")
        if not with_layout:
            return ck["angles"], ck["snapshot_number"]
        return ck["angles"], ck["snapshot_number"], ck["layout_positions"]

    def last_snapshot_number(self, savefile) -> int:
        return _snapshot_numbers(list(self.files[savefile]), savefile)
