"""Gadget-style HDF5 snapshot and catalog adapters (twin of
``orbitanalysis_tpu/engine/gadget.py``).

File-backed implementations of the two-callback data contract that the
reference's example only sketches: a halo catalog gives the region
centres and radii, a snapshot file the particles, and
:class:`~orbitanalysis_tpu_torch.engine.regions.RegionExtractor` selects
the regions.

Dataset names follow the example's flat layout by default
(``Coordinates``/``Velocities``/``ParticleIDs``/``Masses`` and a
``BoxSize`` file attribute); ``group`` reads the ``PartType1``-style
nesting of real Gadget outputs, and every dataset name can be changed.
Cosmology attributes (``Redshift``, ``HubbleParam`` or ``H0``,
``Omega0``/``OmegaLambda``) reach the loader dict when all are present,
which turns on the offline engine's Hubble-flow term.  ``h5py`` is
imported when the callbacks are built.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from orbitanalysis_tpu_torch.engine.regions import RegionExtractor


def make_gadget_callbacks(
    snapshot_path: str,
    catalog_path: str,
    *,
    group: Optional[str] = None,
    coordinates="Coordinates",
    velocities="Velocities",
    particle_ids="ParticleIDs",
    masses="Masses",
    box_size_attr="BoxSize",
    center_dataset="position_of_minimum_potential",
    radius_dataset="R_200crit",
    radius_factor: float = 4.0,
    cosmology_attrs: bool = True,
    cell_size: Optional[float] = None,
):
    """Build ``(regions, load_snapshot_data)`` over Gadget-style files.

    ``snapshot_path`` / ``catalog_path`` are format strings taking the
    snapshot number (e.g. ``'/data/snapshot_{:03d}.hdf5'``).  The
    ``regions`` callback returns the catalog's halo centers and
    ``radius_factor`` times its radius dataset (the example uses
    ``4 * R_200crit``); the loader extracts exactly the requested
    regions via a uniform-grid index built once per snapshot.
    """
    import h5py

    state = {"snap": None, "extractor": None, "meta": None}

    def _root(hf):
        return hf[group] if group else hf

    def regions(snapshot_number, halo_ids):
        with h5py.File(catalog_path.format(int(snapshot_number)), "r") as hf:
            idx = np.asarray(halo_ids)
            return (
                hf[center_dataset][:][idx],
                radius_factor * hf[radius_dataset][:][idx],
            )

    def _load_extractor(s):
        with h5py.File(snapshot_path.format(s), "r") as hf:
            g = _root(hf)
            box = hf.attrs.get(box_size_attr)
            if box is None:
                box = g.attrs.get(box_size_attr)
            mass = g[masses][:] if masses in g else 1.0
            extractor = RegionExtractor(
                g[particle_ids][:],
                g[coordinates][:],
                g[velocities][:],
                masses=mass,
                box_size=None if box is None else float(np.asarray(box)),
                cell_size=cell_size,
            )
            meta = {}
            if cosmology_attrs:
                attrs = dict(hf.attrs)
                attrs.update(dict(g.attrs))
                h0 = attrs.get("H0", attrs.get("HubbleParam"))
                # forward cosmology only as a complete set: a loader dict
                # with 'redshift' makes the engine apply the Hubble-flow
                # term, which needs H0 and the density parameters too
                if ("Redshift" in attrs and h0 is not None
                        and "Omega0" in attrs):
                    meta["redshift"] = float(attrs["Redshift"])
                    meta["H0"] = float(h0)
                    meta["Omega_m"] = float(attrs["Omega0"])
                    meta["Omega_L"] = float(
                        attrs.get("OmegaLambda", 1 - attrs["Omega0"])
                    )
        return extractor, meta

    def load_snapshot_data(snapshot_number, region_positions, region_radii):
        s = int(snapshot_number)
        if state["snap"] != s:
            state["extractor"], state["meta"] = _load_extractor(s)
            state["snap"] = s
        out = state["extractor"].extract(region_positions, region_radii)
        out.update(state["meta"])
        return out

    return regions, load_snapshot_data
