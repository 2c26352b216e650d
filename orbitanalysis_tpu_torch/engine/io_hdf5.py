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
h5py.  Besides the tracking savefile's own methods, both read files
back (``list_groups``, ``read_group``, ``read_attrs``) and write the
other schemas: a flat file of root datasets (``write_flat``, the
on-the-fly catalog), a group added to a file that may not exist yet
(``add_group``, the collated catalog) and a dataset added to an existing
group (``add_dataset``, the final counts).  The module functions
:func:`initialize_savefile`, :func:`append_snapshot`,
:func:`write_checkpoint`, :func:`read_checkpoint` and
:func:`last_snapshot_number` are the JAX package's, over
:class:`H5Writer`.
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

    def list_groups(self, savefile) -> list:
        """Names of the file's root groups."""
        import h5py

        with h5py.File(savefile, "r") as hf:
            return [k for k in hf.keys() if isinstance(hf[k], h5py.Group)]

    def read_group(self, savefile, group=None) -> dict:
        """``{name: array}`` of a group's datasets (the root's when
        ``group`` is None)."""
        import h5py

        with h5py.File(savefile, "r") as hf:
            g = hf if group is None else hf[group]
            return {k: v[()] for k, v in g.items()
                    if isinstance(v, h5py.Dataset)}

    def read_attrs(self, savefile) -> dict:
        """The root attributes, bytes decoded to str."""
        import h5py

        with h5py.File(savefile, "r") as hf:
            return {k: v.decode() if isinstance(v, bytes) else v
                    for k, v in hf.attrs.items()}

    def write_flat(self, savefile, datasets, attrs=None):
        """A new file (replacing any) of root datasets and attributes."""
        import h5py

        with h5py.File(savefile, "w") as hf:
            for name, data in datasets.items():
                hf.create_dataset(name, data=data)
            for name, value in (attrs or {}).items():
                hf.attrs[name] = value

    def add_group(self, savefile, group, datasets):
        """A new group in ``savefile``, creating the file if absent;
        raises ValueError when the group exists."""
        import h5py

        with h5py.File(savefile, "a") as hf:
            g = hf.create_group(group)
            for name, data in datasets.items():
                g.create_dataset(name, data=data)

    def add_dataset(self, savefile, group, name, data):
        """A new dataset in an existing group; raises ValueError when it
        exists."""
        import h5py

        with h5py.File(savefile, "r+") as hf:
            hf[group].create_dataset(name, data=data)


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
        if savefile not in self.files:
            raise KeyError(f"{savefile} was not initialized")
        self.add_group(savefile, "snapshot_%03d" % snapshot_number, datasets)

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
        return _snapshot_numbers(self.list_groups(savefile), savefile)

    def list_groups(self, savefile) -> list:
        return [k for k, v in self.files[savefile].items()
                if k != "attrs" and isinstance(v, dict)]

    def read_group(self, savefile, group=None) -> dict:
        f = self.files[savefile]
        if group is not None:
            return dict(f[group])
        return {k: v for k, v in f.items()
                if k != "attrs" and not isinstance(v, dict)}

    def read_attrs(self, savefile) -> dict:
        return dict(self.files[savefile]["attrs"])

    def write_flat(self, savefile, datasets, attrs=None):
        f = {"attrs": dict(attrs or {})}
        f.update((k, np.array(v)) for k, v in datasets.items())
        self.files[savefile] = f

    def add_group(self, savefile, group, datasets):
        f = self.files.setdefault(savefile, {"attrs": {}})
        if group in f:
            raise ValueError(f"group {group} already exists in {savefile}")
        f[group] = {k: np.array(v) for k, v in datasets.items()}

    def add_dataset(self, savefile, group, name, data):
        g = self.files[savefile][group]
        if name in g:
            raise ValueError(f"dataset {group}/{name} already exists in "
                             f"{savefile}")
        g[name] = np.array(data)


def initialize_savefile(savefile, mode, box_size, verbose=True):
    """A new tracking savefile with its root attributes."""
    H5Writer().initialize(savefile, mode, box_size, verbose)


def append_snapshot(savefile, snapshot_number, mode, apsis_ids,
                    apsis_offsets, apsis_angles, halo_ids,
                    final_descendant_ids, region_radii, region_positions,
                    bulk_velocities, verbose=True,
                    angle_store_dtype=np.float16):
    """One ``snapshot_%03d`` group of the tracking savefile."""
    ds = snapshot_datasets(mode, apsis_ids, apsis_offsets, apsis_angles,
                           halo_ids, final_descendant_ids, region_radii,
                           region_positions, bulk_velocities)
    ds["angles"] = np.asarray(apsis_angles, dtype=angle_store_dtype)
    H5Writer().append_snapshot(savefile, snapshot_number, ds, verbose)


def write_checkpoint(savefile, angles, snapshot_number,
                     angle_store_dtype=np.float16, layout_positions=None):
    """The angle sidecar, angles stored as ``angle_store_dtype``, with
    the aligned engine's stable positions when given."""
    H5Writer().write_checkpoint(
        savefile, np.asarray(angles, dtype=angle_store_dtype),
        snapshot_number, layout_positions=layout_positions)


def read_checkpoint(savefile, with_layout=False):
    """``(angles, snapshot_number[, layout_positions or None])``."""
    return H5Writer().read_checkpoint(savefile, with_layout=with_layout)


def last_snapshot_number(savefile) -> int:
    """Resume anchor: number of the last written snapshot group."""
    return H5Writer().last_snapshot_number(savefile)
