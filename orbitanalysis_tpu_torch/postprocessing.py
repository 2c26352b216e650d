"""Postprocessing: apsis collation, orbit decomposition, plotting (twin
of ``orbitanalysis_tpu/postprocessing.py``).

- :class:`Apsides` collates a tracking savefile into per-snapshot
  orbit-count catalogs, on the host or with the accumulation on a torch
  device, and attaches each particle's final count to earlier
  snapshots.
- :class:`OrbitDecomposition` gives one halo's per-particle orbit counts
  at one snapshot, matched onto that snapshot's particles, with
  position-space and phase-space scatter plots (``matplotlib``, imported
  when a plot is drawn).

Both read either HDF5 files (:class:`~orbitanalysis_tpu_torch.engine.
io_hdf5.H5Writer`, the default) or the files of a
:class:`~orbitanalysis_tpu_torch.engine.io_hdf5.MemoryWriter`, and write
the collated catalog through the same writer.  As in the JAX package,
the collation visits the requested halos in their given order and
writes blocks only for halos present at each snapshot, and the final
counts are integers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from orbitanalysis_tpu_torch.engine import io_hdf5
from orbitanalysis_tpu_torch.engine.io_hdf5 import apsis_tag
from orbitanalysis_tpu_torch.utils.device import resolve_device


def _match_order(a, b):
    """Indices into ``a`` of the values of ``b`` (all present), in
    ``b``'s order: one sort and a binary search."""
    order = np.argsort(a, kind="stable")
    pos = np.searchsorted(a, b, sorter=order)
    return order[pos]


def _snapshot_groups(writer, filename):
    """The file's snapshot numbers, sorted numerically (``%03d`` names
    widen at snapshot 1000)."""
    return np.sort(np.array([int(k.split("_")[1])
                             for k in writer.list_groups(filename)
                             if k.startswith("snapshot_")]))


def _collation_device(device):
    """The torch device of ``collate_apsides(device=...)``, or None for
    the host path: False is the host, True the default ``'cuda'``."""
    if device is False or device is None:
        return None
    return resolve_device("cuda" if device is True else device,
                          "collate_apsides")


class Apsides:
    """Index and collate a tracking savefile; ``writer`` reads it
    (default :class:`~orbitanalysis_tpu_torch.engine.io_hdf5.H5Writer`)
    and writes the collated catalog."""

    def __init__(self, filename, writer=None):
        self.filename = filename
        self.writer = io_hdf5.H5Writer() if writer is None else writer
        self.snapshot_numbers = _snapshot_groups(self.writer, filename)
        final = self.writer.read_group(
            filename, "snapshot_%03d" % self.snapshot_numbers[-1])
        self.final_halo_ids = final["halo_IDs"]
        attrs = self.writer.read_attrs(filename)
        self.mode = attrs["mode"]
        if isinstance(self.mode, bytes):
            self.mode = self.mode.decode()
        if "box_size" in attrs:
            self.box_size = attrs["box_size"]

    @property
    def _tag(self):
        return apsis_tag(self.mode)

    def _group(self, s):
        """One snapshot group's datasets, with ``final_descendant_IDs``
        filled in on the final snapshot (its own halo IDs)."""
        g = self.writer.read_group(self.filename, "snapshot_%03d" % s)
        if s == self.snapshot_numbers[-1]:
            g["final_descendant_IDs"] = g["halo_IDs"]
        return g

    def _write_collated(self, savefile, s, ids_unique, counts, halo_offsets,
                        g, file_inds):
        ds = {
            "particle_IDs": ids_unique,
            self._tag + "_counts": counts,
            "halo_offsets": halo_offsets,
        }
        if s != self.snapshot_numbers[-1]:
            ds["final_descendant_IDs"] = g["final_descendant_IDs"][file_inds]
        ds["halo_IDs"] = g["halo_IDs"][file_inds]
        ds["halo_positions"] = g["region_positions"][file_inds]
        ds["halo_velocities"] = g["bulk_velocities"][file_inds]
        ds["region_radii"] = g["region_radii"][file_inds]
        self.writer.add_group(savefile, "snapshot_%03d" % s, ds)

    def collate_apsides(
        self,
        halo_ids=None,
        snapshot_number=None,
        angle_cut=np.pi / 4,
        save_final_counts=False,
        data_type=None,
        savefile=None,
        verbose=True,
        device=False,
    ):
        """Accumulate each halo's apsis IDs across snapshots (events at
        angles above ``angle_cut`` only, which rejects subhalo passages)
        and write per-snapshot unique-ID and orbit-count catalogs to
        ``savefile``.

        ``device=False`` runs on the host (a unique per halo a
        snapshot); ``True`` (``'cuda'``) or a torch device accumulates
        on that device: one (halo, ID) sort of every kept event, then a
        per-snapshot segment sum keeps the cumulative counts resident.
        Both write the same catalog.
        """
        t_start = time.time()
        if halo_ids is None:
            halo_ids = self.final_halo_ids
        else:
            halo_ids = np.asarray(halo_ids)
            missing = np.setdiff1d(halo_ids, self.final_halo_ids)
            if len(missing):
                self.missing_halo_ids = missing
                raise ValueError(
                    "The input halo ID list contains IDs of halos (at z=0) "
                    "that have not been processed."
                )
        if snapshot_number is None:
            sind = len(self.snapshot_numbers) - 1
        else:
            sind = int(np.argwhere(
                self.snapshot_numbers == snapshot_number).flatten()[0])

        dev = _collation_device(device)
        if dev is not None:
            self._collate_apsides_device(halo_ids, sind, angle_cut,
                                         data_type, savefile, verbose, dev)
        else:
            self._collate_apsides_host(halo_ids, sind, angle_cut,
                                       data_type, savefile, verbose)
        if save_final_counts:
            self.save_final_apsis_counts(savefile, verbose=verbose)
        if verbose:
            print("{}s collated in {} s".format(
                self._tag, round(time.time() - t_start, 3)))

    def _collate_apsides_host(self, halo_ids, sind, angle_cut, data_type,
                              savefile, verbose):
        n_req = len(halo_ids)
        accumulated = [None] * n_req  # per-halo ID accumulators
        for s in self.snapshot_numbers[: sind + 1]:
            g = self._group(s)
            apsis_ids = g[self._tag + "_IDs"]
            if len(apsis_ids) == 0:
                continue
            angles, offsets = g["angles"], g["region_offsets"]
            orbtype = apsis_ids.dtype if data_type is None else data_type
            for k in range(n_req):
                if accumulated[k] is None:
                    accumulated[k] = np.array([], dtype=orbtype)

            # requested halos present at this snapshot, in requested order
            halo_ids_final = g["final_descendant_IDs"]
            req_inds = np.where(np.isin(halo_ids, halo_ids_final))[0]
            file_inds = _match_order(halo_ids_final, halo_ids[req_inds])
            for k, fi in zip(req_inds, file_inds):
                sl = slice(offsets[fi], offsets[fi + 1])
                accumulated[k] = np.append(
                    accumulated[k], apsis_ids[sl][angles[sl] > angle_cut])

            ids_unique, counts, lens = [], [], []
            for k in req_inds:
                u, c = np.unique(accumulated[k], return_counts=True)
                ids_unique.append(u)
                counts.append(c)
                lens.append(len(u))
            ids_unique = (np.concatenate(ids_unique) if ids_unique
                          else np.array([], dtype=orbtype))
            counts = (np.concatenate(counts) if counts
                      else np.array([], dtype=np.int64))
            halo_offsets = np.cumsum([0] + lens)[:-1]
            self._write_collated(savefile, s, ids_unique, counts,
                                 halo_offsets, g, file_inds)
            if verbose:
                print("Snapshot {} collated".format("%03d" % s))

    def _collate_apsides_device(self, halo_ids, sind, angle_cut, data_type,
                                savefile, verbose, device="cuda"):
        """Device core of :meth:`collate_apsides`.

        The host stages every kept event as flat ``(halo index, particle
        ID, snapshot index)`` arrays; the device sorts them by ``(halo,
        ID)`` once (stable argsorts, minor key first) and a segment sum
        a snapshot over the unique pairs keeps the cumulative counts,
        fetched once a snapshot.  The host trims and writes each
        snapshot's catalog.
        """
        device = resolve_device(device, "collate_apsides")
        n_req = len(halo_ids)
        snaps = self.snapshot_numbers[: sind + 1]
        metas, ev_id, ev_k, ev_s = [], [], [], []
        orbtype = None
        for si, s in enumerate(snaps):
            g = self._group(s)
            apsis_ids = g[self._tag + "_IDs"]
            if len(apsis_ids) and orbtype is None:
                orbtype = (apsis_ids.dtype if data_type is None
                           else np.dtype(data_type))
            halo_ids_final = g["final_descendant_IDs"]
            req_inds = np.where(np.isin(halo_ids, halo_ids_final))[0]
            file_inds = _match_order(halo_ids_final, halo_ids[req_inds])
            metas.append((s, si, g, req_inds, file_inds,
                          len(apsis_ids) > 0))
            if len(apsis_ids) == 0:
                continue
            # each event's file halo from the offsets, mapped to its
            # requested index by an inverse table, then the angle cut
            lengths = np.diff(g["region_offsets"])
            ev_file_ind = np.repeat(np.arange(len(lengths)), lengths)
            inv = np.full(len(lengths), -1, np.int32)
            inv[file_inds] = req_inds.astype(np.int32)
            ev_req = inv[ev_file_ind]
            keep = (ev_req >= 0) & (g["angles"] > angle_cut)
            if keep.any():
                ev_id.append(apsis_ids[keep].astype(np.int64))
                ev_k.append(ev_req[keep])
                ev_s.append(np.full(int(keep.sum()), si, np.int32))

        counts_dev = None
        if ev_id:
            def dev(parts):
                return torch.from_numpy(np.concatenate(parts)).to(device)

            k_d, id_d, s_d = dev(ev_k), dev(ev_id), dev(ev_s)
            order = torch.argsort(id_d, stable=True)
            order = order[torch.argsort(k_d[order], stable=True)]
            k_d, id_d, s_d = k_d[order], id_d[order], s_d[order]
            first = torch.ones_like(k_d, dtype=torch.bool)
            first[1:] = (k_d[1:] != k_d[:-1]) | (id_d[1:] != id_d[:-1])
            uidx = torch.cumsum(first, 0) - 1
            k_u = k_d[first].cpu().numpy()
            id_u = id_d[first].cpu().numpy()
            counts_dev = torch.zeros(len(k_u), dtype=torch.int32,
                                     device=device)
        else:
            k_u = np.zeros(0, np.int32)
            id_u = np.zeros(0, np.int64)
        if orbtype is None:
            orbtype = id_u.dtype

        for s, si, g, req_inds, file_inds, has_events in metas:
            if not has_events:
                continue
            if counts_dev is not None:
                counts_dev.index_add_(0, uidx, (s_d == si).to(torch.int32))
                counts_h = counts_dev.cpu().numpy()
            else:
                counts_h = np.zeros(0, np.int32)
            in_req = (counts_h > 0) & np.isin(k_u, req_inds)
            lens = np.bincount(k_u[in_req], minlength=n_req)[req_inds]
            self._write_collated(
                savefile, s, id_u[in_req].astype(orbtype),
                counts_h[in_req].astype(np.int64),
                np.cumsum([0] + list(lens))[:-1], g, file_inds)
            if verbose:
                print("Snapshot {} collated".format("%03d" % s))

    def save_final_apsis_counts(self, collated_file, snapshot_numbers=None,
                                verbose=True):
        """Attach each particle's *final* orbit count to every earlier
        snapshot's catalog (``{tag}_counts_final``)."""
        w = self.writer
        nums_all = np.sort(np.array(
            [int(k.split("_")[-1]) for k in w.list_groups(collated_file)]))
        skeys = np.array(["snapshot_%03d" % n for n in nums_all])
        gfin = w.read_group(collated_file, skeys[-1])
        ids_final = gfin["particle_IDs"]
        counts_final = gfin[self._tag + "_counts"]
        # match in z=0 descendant space: a collation stopped mid-sequence
        # has snapshot-local halo_IDs in its last group, but its
        # final_descendant_IDs (absent only on the true final snapshot)
        # are in the space of the earlier groups'
        halo_ids = gfin.get("final_descendant_IDs", gfin["halo_IDs"])
        offsets_final = np.concatenate((gfin["halo_offsets"],
                                        [len(ids_final)]))
        if snapshot_numbers is None:
            skeys_ = skeys[:-1]
        else:
            nums = np.array([int(k.split("_")[-1]) for k in skeys])
            skeys_ = skeys[np.isin(nums, snapshot_numbers)]

        for skey in skeys_:
            g = w.read_group(collated_file, skey)
            ids = g["particle_IDs"]
            offsets = np.concatenate((g["halo_offsets"], [len(ids)]))
            hinds = _match_order(halo_ids, g["final_descendant_IDs"])
            counts_retro = np.zeros(len(ids), dtype=counts_final.dtype)
            for h2, h1 in enumerate(hinds):
                fsl = slice(offsets_final[h1], offsets_final[h1 + 1])
                sl = slice(offsets[h2], offsets[h2 + 1])
                fidx = _match_order(ids_final[fsl], ids[sl])
                counts_retro[sl] = counts_final[fsl][fidx]
            w.add_dataset(collated_file, skey, self._tag + "_counts_final",
                          counts_retro)
            if verbose:
                print("Final counts saved for {} {}".format(
                    *skey.split("_")))


class OrbitDecomposition:
    """One halo's orbit decomposition, with plots: its apsis events
    collated up to a snapshot, orbit counts attached to that snapshot's
    particles, drawn in position and phase space.  ``writer`` reads the
    tracking savefile (default H5Writer)."""

    def __init__(self, filename, writer=None):
        self.filename = filename
        self.apsides = Apsides(filename, writer=writer)
        self.writer = self.apsides.writer
        self.mode = self.apsides.mode
        # set by get_halo_decomposition_at_snapshot:
        self.particle_ids = None
        self.counts = None
        self.coordinates = None
        self.velocities = None
        self.radii = None
        self.radial_velocities = None
        self.region_radius = None
        self.halo_position = None
        self.halo_velocity = None

    @property
    def _tag(self):
        return apsis_tag(self.mode)

    def get_halo_decomposition_at_snapshot(
        self,
        halo_id,
        snapshot_number=None,
        snapshot_data=None,
        angle_cut=np.pi / 4,
    ):
        """Collate apsis counts for ``halo_id`` at ``snapshot_number``.

        With ``snapshot_data`` (the loader dict of this halo's region)
        the counts are matched onto its particles (0 where a particle
        has no recorded apsis) and region-frame radii and radial
        velocities are computed for the phase-space plot.
        """
        snaps = self.apsides.snapshot_numbers
        if snapshot_number is None:
            snapshot_number = snaps[-1]
        sind = int(np.argwhere(snaps == snapshot_number).flatten()[0])

        acc = []
        for s in snaps[: sind + 1]:
            g = self.apsides._group(s)
            loc = np.argwhere(g["final_descendant_IDs"] == halo_id).flatten()
            if len(loc) == 0:
                continue
            fi = int(loc[0])
            sl = slice(g["region_offsets"][fi], g["region_offsets"][fi + 1])
            acc.append(g[self._tag + "_IDs"][sl][g["angles"][sl] > angle_cut])
        g = self.apsides._group(snapshot_number)
        fi = int(np.argwhere(
            g["final_descendant_IDs"] == halo_id).flatten()[0])
        self.halo_position = g["region_positions"][fi]
        self.halo_velocity = g["bulk_velocities"][fi]
        self.region_radius = g["region_radii"][fi]
        box_size = self.writer.read_attrs(self.filename).get("box_size")

        acc = np.concatenate(acc) if acc else np.array([], dtype=np.int64)
        ids_u, counts = np.unique(acc, return_counts=True)
        self.particle_ids = ids_u
        self.counts = counts

        if snapshot_data is not None:
            ids = np.asarray(snapshot_data["ids"])
            counts_all = np.zeros(len(ids), dtype=np.int64)
            present = np.isin(ids, ids_u)
            counts_all[present] = counts[_match_order(ids_u, ids[present])]
            self.particle_ids = ids
            self.counts = counts_all

            pos = np.asarray(snapshot_data["coordinates"], dtype=np.float64)
            vel = np.asarray(snapshot_data["velocities"], dtype=np.float64)
            rel = pos - self.halo_position
            if box_size is not None:
                # float64 minimum image, the precision cast to above
                rel = rel - box_size * np.round(rel / box_size)
            vrel = vel - self.halo_velocity
            r = np.sqrt((rel**2).sum(-1))
            with np.errstate(invalid="ignore"):
                rhat = np.where(r[:, None] > 0,
                                rel / np.maximum(r, 1e-300)[:, None], 0.0)
            self.coordinates = rel
            self.velocities = vrel
            self.radii = r
            self.radial_velocities = (vrel * rhat).sum(-1)
        return self

    def _select_counts(self, counts_to_plot):
        if counts_to_plot == "all":
            return np.unique(self.counts)
        return np.atleast_1d(np.asarray(counts_to_plot))

    @staticmethod
    def _pyplot(display):
        import matplotlib

        if not display:
            matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        return plt

    @staticmethod
    def _finish(plt, fig, display, savefile):
        if savefile:
            fig.savefig(savefile, dpi=150, bbox_inches="tight")
        if display:
            plt.show()
        else:
            plt.close(fig)
        return fig

    def plot_position_space(
        self,
        projection="xy",
        colormap="rainbow_r",
        counts_to_plot="all",
        xlabel=None,
        ylabel=None,
        display=False,
        savefile=None,
        point_size=1.0,
    ):
        """The halo's particles in a 2D projection, coloured by orbit
        count."""
        plt = self._pyplot(display)
        if self.coordinates is None:
            raise RuntimeError("call get_halo_decomposition_at_snapshot(..., "
                               "snapshot_data=...) first")
        axes = {"x": 0, "y": 1, "z": 2}
        ax0, ax1 = axes[projection[0]], axes[projection[1]]
        scale = self.region_radius
        cvals = self._select_counts(counts_to_plot)
        fig, ax = plt.subplots(figsize=(6, 6))
        cmap = plt.get_cmap(colormap)
        for k, c in enumerate(cvals):
            sel = self.counts == c
            ax.scatter(self.coordinates[sel, ax0] / scale,
                       self.coordinates[sel, ax1] / scale, s=point_size,
                       color=cmap(k / max(len(cvals) - 1, 1)),
                       label=f"n={c}")
        ax.set_xlabel(xlabel or f"${projection[0]}/R$")
        ax.set_ylabel(ylabel or f"${projection[1]}/R$")
        ax.set_aspect("equal")
        ax.legend(markerscale=8, fontsize=8, loc="upper right")
        return self._finish(plt, fig, display, savefile)

    def plot_phase_space(
        self,
        colormap="rainbow_r",
        counts_to_plot="all",
        radius_label=None,
        radial_velocity_label=None,
        logr=False,
        display=False,
        savefile=None,
        point_size=1.0,
    ):
        """r - v_r phase-space scatter coloured by orbit count."""
        plt = self._pyplot(display)
        if self.radii is None:
            raise RuntimeError("call get_halo_decomposition_at_snapshot(..., "
                               "snapshot_data=...) first")
        cvals = self._select_counts(counts_to_plot)
        fig, ax = plt.subplots(figsize=(7, 5))
        cmap = plt.get_cmap(colormap)
        r = self.radii / self.region_radius
        for k, c in enumerate(cvals):
            sel = self.counts == c
            ax.scatter(r[sel], self.radial_velocities[sel], s=point_size,
                       color=cmap(k / max(len(cvals) - 1, 1)),
                       label=f"n={c}")
        if logr:
            ax.set_xscale("log")
        ax.set_xlabel(radius_label or "$r/R$")
        ax.set_ylabel(radial_velocity_label or "$v_r$")
        ax.legend(markerscale=8, fontsize=8, loc="upper right")
        return self._finish(plt, fig, display, savefile)
