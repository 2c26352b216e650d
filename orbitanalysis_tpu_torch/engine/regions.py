"""Region extraction: the loader contract built from full snapshots
(twin of ``orbitanalysis_tpu/engine/regions.py``).

The reference leaves region selection to user code, and its example
recentres *all* N particles on *each* halo and masks by radius, O(N *
n_halos).  Here a uniform grid bins the snapshot once (O(N), by the
native counting sort past 2**18 particles) and each region gathers from
its overlapping cells only.

Output follows the ``load_snapshot_data`` contract: block-concatenated
per-region arrays and ``region_offsets``.  A particle inside several
regions appears in each, as in the brute-force example.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class RegionExtractor:
    """Uniform-grid index over one snapshot for repeated region queries.

    Build once per snapshot (O(N)), then :meth:`extract` any set of
    (center, radius) regions.  ``box_size=None`` disables periodic
    wrapping.
    """

    def __init__(
        self,
        ids: np.ndarray,
        coordinates: np.ndarray,
        velocities: np.ndarray,
        masses=None,
        box_size: Optional[float] = None,
        cell_size: Optional[float] = None,
    ):
        self.ids = np.asarray(ids)
        self.pos = np.asarray(coordinates)
        self.vel = np.asarray(velocities)
        self.masses = masses
        self.box = None if box_size is None else float(box_size)

        lo = self.pos.min(axis=0) if self.box is None else np.zeros(3)
        hi = self.pos.max(axis=0) if self.box is None else np.full(
            3, self.box
        )
        span = np.maximum(hi - lo, 1e-9)
        if cell_size is None:
            # aim for O(100) particles per cell
            n_cells = max(int((len(self.ids) / 100.0) ** (1.0 / 3.0)), 1)
            cell_size = float(span.max() / max(n_cells, 1))
        self.lo = lo
        self.dims = np.maximum(
            np.ceil(span / float(cell_size)).astype(np.int64), 1
        )
        # exact per-dimension cell sizes: dims * cell == span, so that in
        # periodic mode index-wrapping (mod dims) is identical to
        # position-wrapping (mod box) — a user cell_size that does not
        # divide the box would otherwise drop boundary particles
        self.cell = span / self.dims

        cell_idx = self._cell_of(self.pos)
        flat = (
            cell_idx[:, 0] * self.dims[1] + cell_idx[:, 1]
        ) * self.dims[2] + cell_idx[:, 2]
        n_flat = int(np.prod(self.dims))
        native_sorted = None
        if len(flat) >= 1 << 18:  # native pays off past ~256k particles
            from orbitanalysis_tpu_torch import native

            if native.ensure() is not None:
                native_sorted = native.grid_count_sort_native(flat, n_flat)
        if native_sorted is not None:
            self.cell_starts, self.order = native_sorted
        else:
            self.order = np.argsort(flat, kind="stable")
            self.cell_starts = np.searchsorted(
                flat[self.order], np.arange(n_flat + 1)
            )

    def _cell_of(self, pos):
        c = np.floor((pos - self.lo) / self.cell).astype(np.int64)
        if self.box is not None:
            c = np.mod(c, self.dims)
        return np.clip(c, 0, self.dims - 1)

    def _candidate_indices(self, center, radius):
        """Particle indices in the grid cells overlapping the sphere."""
        r = radius + 1e-9
        lo_c = np.floor((center - r - self.lo) / self.cell).astype(np.int64)
        hi_c = np.floor((center + r - self.lo) / self.cell).astype(np.int64)
        rng = [np.arange(lo_c[d], hi_c[d] + 1) for d in range(3)]
        if self.box is not None:
            rng = [np.unique(np.mod(a, self.dims[d]))
                   for d, a in enumerate(rng)]
        else:
            rng = [a[(a >= 0) & (a < self.dims[d])]
                   for d, a in enumerate(rng)]
        cx, cy, cz = np.meshgrid(*rng, indexing="ij")
        flat = ((cx * self.dims[1] + cy) * self.dims[2] + cz).ravel()
        chunks = [
            self.order[self.cell_starts[f]:self.cell_starts[f + 1]]
            for f in flat
        ]
        if not chunks:
            return np.empty(0, np.int64)
        return np.concatenate(chunks)

    def extract(self, centers, radii):
        """Loader-contract dict for the given regions.

        Returns a dict with ``ids``, ``coordinates``, ``velocities``,
        ``region_offsets`` (+ ``masses`` when given, ``box_size`` when
        periodic), blocks in region order.
        """
        centers = np.atleast_2d(np.asarray(centers, dtype=np.float64))
        radii = np.atleast_1d(np.asarray(radii, dtype=np.float64))
        sel_blocks = []
        for c, r in zip(centers, radii):
            cand = self._candidate_indices(c, r)
            if len(cand) == 0:
                sel_blocks.append(cand)
                continue
            d = self.pos[cand] - c
            if self.box is not None:
                d -= self.box * np.round(d / self.box)
            inside = (d * d).sum(axis=1) < r * r
            sel_blocks.append(cand[inside])
        lens = [len(b) for b in sel_blocks]
        sel = (
            np.concatenate(sel_blocks) if sel_blocks
            else np.empty(0, np.int64)
        )
        out = dict(
            ids=self.ids[sel],
            coordinates=self.pos[sel],
            velocities=self.vel[sel],
            region_offsets=np.concatenate(([0], np.cumsum(lens)))[:-1],
        )
        if self.masses is not None:
            out["masses"] = (
                self.masses
                if np.isscalar(self.masses) or np.ndim(self.masses) == 0
                else np.asarray(self.masses)[sel]
            )
        if self.box is not None:
            out["box_size"] = self.box
        return out


def make_region_callbacks(
    snapshots: dict,
    catalog,
    box_size: Optional[float] = None,
    **extractor_kwargs,
):
    """Build the reference's two-callback contract from in-memory data.

    ``snapshots``: mapping snapshot_number -> dict with ids/coordinates/
    velocities (+ optional masses and cosmology keys).  ``catalog``:
    mapping snapshot_number -> (halo_ids_array, centers [n,3], radii [n])
    — a minimal stand-in for a halo-catalog reader.

    Returns ``(regions, load_snapshot_data)`` ready for
    :func:`orbitanalysis_tpu_torch.track_orbits`.
    """
    extractors = {}  # small LRU: snapshots are visited ~once each

    def regions(snapshot_number, halo_ids):
        hids, centers, radii = catalog[int(snapshot_number)]
        hids = np.asarray(hids)
        # explicit id -> row lookup: halo catalogs need not be sorted,
        # and a missing id must fail loudly, not index garbage
        order = np.argsort(hids, kind="stable")
        pos = np.searchsorted(hids[order], halo_ids)
        pos = np.clip(pos, 0, len(hids) - 1)
        idx = order[pos]
        if not np.array_equal(hids[idx], np.asarray(halo_ids)):
            missing = np.setdiff1d(halo_ids, hids)
            raise KeyError(
                f"halo ids {missing} not in the snapshot-"
                f"{int(snapshot_number)} catalog"
            )
        return centers[idx], radii[idx]

    def load_snapshot_data(snapshot_number, region_positions, region_radii):
        s = int(snapshot_number)
        if s not in extractors:
            snap = snapshots[s]
            extractors[s] = RegionExtractor(
                snap["ids"], snap["coordinates"], snap["velocities"],
                masses=snap.get("masses"), box_size=box_size,
                **extractor_kwargs,
            )
            # keep at most two indices alive (the on-the-fly engine
            # queries a snapshot pair); a per-run cache would retain
            # O(N) index arrays for every snapshot ever touched
            while len(extractors) > 2:
                extractors.pop(next(iter(extractors)))
        out = extractors[s].extract(region_positions, region_radii)
        snap = snapshots[s]
        for k in ("redshift", "H0", "Omega_m", "Omega_L", "Omega_k"):
            if k in snap:
                out[k] = snap[k]
        return out

    return regions, load_snapshot_data
