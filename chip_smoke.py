#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orbitanalysis_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or /usr/local/cuda) and the
repository checkout; it imports nothing of JAX.  Phases:

1. environment: versions, and the card's name and power limit;
2. build: nvcc compiles every csrc/*.cu for sm_90a, one process per
   source, and links one library (and g++ the native host packer); the
   JAX package's benchmark workloads (64 halos x 32768 slots x 48
   snapshots from one orbit pool: the label-native churn sequence, the
   same churn in the ID form, and the fixed-membership sequence) are
   generated on the host, the ID forms staged ID-sorted and, one
   ``pack_snapshot_aligned`` a snapshot, in the stable layout;
3. each CUDA kernel against its plain-torch version on the same CUDA
   tensors, at the shapes its main path gives it (the sorted engine's
   kernels and the aligned detect kernel on the inputs of real steps,
   the fused label detect kernel on the label path's, the sorted
   deposit on the streams of the first force evaluations of phase 12's
   two runs, 12.6M / 257^3 and 33.5M / 513^3, the blocked direct forces
   at N = 16,384 and 131,072, free and periodic), with timings,
   the card's bound for the same work and, where one PyTorch call
   computes the same function, that call's time;
4. aligned step parity: 8 churning snapshots at [64, 32768], the
   aligned step on CUDA against the same step on the CPU: counts,
   positions, carry keys and r-hat planes equal, and no event angle
   more than one f16 ulp apart;
5. the aligned main path end to end at config-2 scale (100 halos, ~1e6
   tracked particles, periodic box, Hubble term):
   ``track_orbits(device='cuda')`` under ``join_impl='auto'`` must pick
   the aligned engine, match the general engine run on the card and the
   NumPy oracle, and launch the compaction kernel once per aligned step;
   a wide-row run (one halo past 131071 members) drives the pair kernel
   the same way;
6. label step parity: 8 snapshots of [8, 32768] rows, the label step on
   CUDA against the CPU, through the detect-and-compact kernel and
   through the detect kernel plus the payload compaction;
7. the label-native main path at full width: ``scan_label_events`` over
   the whole workload (``frames='auto'``, K = 2048, octahedral r-hat,
   bulk moments on the card) must find the JAX benchmark's 1,741,643
   events, launching the frame-row, moments and detect-and-compact
   kernels once per snapshot; with its bulk velocities fed back, the
   K = 8192 route (detect kernel + payload compaction) and the
   ``'twolevel'`` route (plain chain + payload compaction) must give the
   same events, and so must the ``'fused'`` route (moments, fused detect
   kernel, payload compaction) and the ``'pallas'`` route (moments, frame
   rows, plain chain, payload compaction) estimating the bulk velocities
   themselves, each kernel once a snapshot; then the step's device time,
   host queue time and update rate for ``'auto'`` and ``'fused'``;
8. the sorted engine at full width, the JAX benchmark's merge-join and
   static cells: ``scan_events_sorted(fused=True, cur_presorted=True,
   soa_batch=True)`` over the 48-snapshot churn sequence must find
   exactly the 1,741,643 events, launching the join-and-detect kernel
   once a step; on its first 12 snapshots the events equal the general
   engine's on the card (given the sorted run's bulk velocities) and the
   unfused route's (merge kernel + two-group compaction); the static
   sequence launches the join-and-detect kernel on its first step and
   the event compaction on every later one, and the legacy aligned step
   (the aligned detect kernel once a step) finds the same events; then
   step timings;
9. ``track_orbits(join_impl='sorted')`` at config-2 scale: catalogs
   equal the general engine's run on the card and the oracle, and every
   step launches the join-and-detect kernel or the event compaction;
10. the aligned engine on the benchmark's churn sequence in the stable
   layout (SoA planes): ``make_aligned_native_step`` with
   ``detect_impl='xla'`` (the compaction kernel once a step) and
   ``'pallas'`` (the aligned detect kernel once a step) and the legacy
   ``make_aligned_orbit_step`` (the same kernel) must give the same
   events, exactly the 1,741,643, and the two native steps the same
   carry bits; then step timings;
11. config 4's oracle (benchmarks/config4_onthefly_e2e.py): a 16,384
   particle Kepler ensemble under point-mass forces, detection every 8
   and every 32 steps: at 4x the snapshot cadence at least 99 % of the
   particles within +-1 of the closed-form pericentre count, the
   snapshot rate missing more; the same runs on the CPU, counts within
   one on at most 0.1 % of the particles;
12. config 4 at scale with PM forces (``make_pm_force_fn``, the sorted
   deposit kernel once a force evaluation): 12,582,912 particles on
   256^3 for 32 steps, integrator only and tracked, a profiler window
   over 8 tracked steps, and one detection on the identity and the
   gather paths; then 33,554,432 particles on 512^3
   for 16 steps in 4-step chunks (s/step, peak memory); then at 1M on
   128^3 the sorted deposit bit-equal CUDA vs CPU, one PM force
   evaluation within 1e-4, and the detector's flags, counts and r-hat
   bit-equal on identical states;
13. direct summation through the blocked force kernel at N = 131,072
   (16 steps, detection every 4), against the same run with the plain
   blocked version on the card; one P3M force evaluation at 262,144
   particles on 64^3 (finite, net force near zero).

Any failed check exits non-zero without printing the result lines.  The
last three lines are the card's name and power limit, the kernels' JSON
record and the device JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

DEVICE = "cuda"
#: phase 3: (rows, row length, event capacity) of each kernel's check,
#: the aligned step's bench shape and a wide-row shape
ANGLE_ROWS = (64, 32768, 2048)
PAIR_ROWS = (4, 1 << 18, 16384)
#: phase 4: (halos, capacity, particle pool per halo, snapshots)
PARITY = (64, 32768, 40000, 8)
#: phase 5: config 2 (BASELINE.md): (halos, particle pool per halo,
#: snapshots, box); ~80% of a pool is in its region at snapshot 0,
#: so ~1e6 particles are tracked.  WIDE_POOL puts one halo past
#: PAYLOAD_MAX_ROW members.  ORACLE_HALOS are checked against the oracle.
E2E = (100, 12500, 20, 25.0)
WIDE_POOL = 175000
ORACLE_HALOS = 8
#: phases 6-7: the JAX benchmark's label-native workload (bench.py
#: device_label_updates_per_s): halos, slots per halo, snapshots; its
#: row width, event capacity and box; the event total it found; the
#: rows and snapshots of the CUDA-vs-CPU parity phase
LABEL = (64, 32768, 48)
LABEL_ROW, LABEL_K, LABEL_BOX = 32768, 2048, 100.0
LABEL_EVENTS = 1741643
LABEL_PARITY = (8, 8)
#: timed scans of phase 7 (after one warm-up scan)
LABEL_SCANS = 5
#: phase 8: snapshots of the sorted engine's cross-checks and of the
#: static cell (the JAX benchmark's secondary slice, bench.py:1103), and
#: the events the static cell holds
SORTED_CHECK = 12
STATIC_EVENTS = 473138

#: The card's published peaks (H100 SXM, NVIDIA's data sheet) that
#: ``bound_ms`` divides by: HBM bytes per second, and float32 (or
#: 32-bit integer) operations per second outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12


#: Event angles from two arccos routines (torch's ``acos`` in the general
#: engine and the unfused sorted route, the Cephes polynomial in the
#: kernels and the aligned and fused sorted steps) agree to one f16 ulp,
#: or to ANGLE_ATOL rad where one f16 ulp is finer than f32 arccos
#: resolves: the two differ by about 2 f32 ulps, and near cos = 1 the
#: arccos of cosines d apart differs by up to sqrt(2 d) (1e-3 rad for 8
#: ulps of 2**-24).  The same step on CUDA and on the CPU computes every
#: division and root as the IEEE float32 one, so phase 4 asks for one
#: f16 ulp on every event.
ANGLE_ATOL = 2e-3


def f16_ulps(a, b):
    """(f16 ulps apart, absolute difference) of two f32 angle arrays."""
    ia = a.astype(np.float16).view(np.int16).astype(np.int32)
    ib = b.astype(np.float16).view(np.int16).astype(np.int32)
    return np.abs(ia - ib), np.abs(a.astype(np.float64) - b)


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``n_bytes`` (each input read once, each output written
    once) and does ``n_ops`` operations."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gathered_bytes(sel, length, n_chan):
    """Bytes that ``n_chan`` planes of 32-bit words, read by an ordered
    compaction only at the selected lanes, must move: ``sel`` is the
    ``[H, N]`` bool selection, a lane past a row's first ``length``
    selected ones need not be read, and each 32-byte sector (8 lanes)
    that holds a lane to read counts once."""
    import torch

    take = sel & (sel.to(torch.int32).cumsum(dim=1) <= length)
    flat = take.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros(-flat.numel() % 8)])
    return n_chan * 32 * int(flat.view(-1, 8).any(dim=1).sum())


def launch_diff(after, before=None):
    """Kernel launches between two readings of the counts (since the
    reset when ``before`` is None), the kernels that launched."""
    before = before or {}
    return {n: c - before.get(n, 0) for n, c in after.items()
            if c != before.get(n, 0)}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


#: Cycles of the sleep kernel that holds the card busy while the host
#: queues the work to be timed (~50 ms at the H100's ~1.98 GHz clock).
SLEEP_CYCLES = 100_000_000


def device_ms(fn, reps=1):
    """Device milliseconds of ``reps`` back-to-back ``fn()`` calls: a
    sleep kernel first holds the card busy while the host queues them,
    so the CUDA events bracket the device's own execution, not the
    host's queuing (a call that synchronizes the host inside, as a
    boolean-mask index does, still counts its host time)."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def cuda_ms(fn, runs=5, reps=10, warmup=3):
    """Median device milliseconds of one ``fn()`` over ``runs`` timings
    of ``reps`` back-to-back calls (:func:`device_ms`), after ``warmup``
    calls."""
    for _ in range(warmup):
        fn()
    return statistics.median(device_ms(fn, reps) / reps for _ in range(runs))


# ---------------------------------------------------------------- phase 3

def kernel_checks(dev):
    """Each kernel against its twin on the same CUDA tensors."""
    import torch

    from orbitanalysis_tpu_torch.ops import compact

    rng = np.random.default_rng(1)
    h, p, k = ANGLE_ROWS
    results = {}
    worst = 0
    for density in (0.0, 0.017, 0.07, 0.5, 1.0, "clustered"):
        ang = rng.uniform(0, 7, (h, p)).astype(np.float32)
        if density == "clustered":
            sel = rng.random((h, p)) < 0.01
            sel[1, p // 8:p // 8 + 700] = True   # far past a block's 16
            sel[2, p - 200:] = True
        else:
            sel = rng.random((h, p)) < density
        ang[0, :4] = [65504.0, 65519.0, 65520.0, 1e30]  # clamp lanes
        sel[0, :4] = True
        aw = ang.view(np.uint32) | (sel.astype(np.uint32) << np.uint32(31))
        x = torch.from_numpy(aw.view(np.int32)).to(dev)
        got = compact.compact_angle_blocked(x, k)
        want = compact.compact_angle_blocked_torch(x, k)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        log(f"  compact_angle_rows [{h}, {p}] K={k} density={density}: "
            f"events {int(sel.sum())}, max |kernel - twin| = {err}")
        check(torch.equal(got, want),
              f"compact_angle_rows differs from its twin at {density}")
        if density == 0.017:
            # a few integer operations an entry; bytes bound it
            b_ms, b_by = bound(x.numel() * 4 + h * compact._k128(k, p) * 4,
                               4 * x.numel())
            results["compact_angle_rows"] = dict(
                ms=cuda_ms(lambda: compact.compact_angle_blocked(x, k)),
                plain_ms=cuda_ms(
                    lambda: compact.compact_angle_blocked_torch(x, k)),
                bound_ms=b_ms, bound_by=b_by,
                # no single PyTorch call compacts rows in order
                library_ms=None,
            )
    results["compact_angle_rows"]["max_abs_err"] = worst

    h, p, k = PAIR_ROWS
    sel = rng.random((h, p)) < 0.03
    sel[:, p - 1] = True
    posw = np.where(sel, np.arange(p, dtype=np.uint32) + 1, np.uint32(0))
    angw = np.where(sel, rng.integers(0, 0x7BFF, (h, p)).astype(np.uint32),
                    np.uint32(0))
    pw = torch.from_numpy(posw.view(np.int32)).to(dev)
    aw2 = torch.from_numpy(angw.view(np.int32)).to(dev)
    got = compact.compact_payload_pair(pw, aw2, k)
    want = compact.compact_payload_pair_torch(pw, aw2, k)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(got, want))
    log(f"  compact_pair_rows [{h}, {p}] K={k}: events {int(sel.sum())}, "
        f"max |kernel - twin| = {err}")
    check(all(torch.equal(g, w) for g, w in zip(got, want)),
          "compact_pair_rows differs from its twin")
    check(int(got[0][0, int(sel[0].sum()) - 1]) == p,
          f"the event at position {p - 1} was lost")
    # posw read whole, angw only at the events
    k128 = compact._k128(k, p)
    b_ms, b_by = bound(pw.numel() * 4 + gathered_bytes(pw != 0, k128, 1)
                       + 2 * h * k128 * 4, 4 * pw.numel())
    results["compact_pair_rows"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: compact.compact_payload_pair(pw, aw2, k)),
        plain_ms=cuda_ms(
            lambda: compact.compact_payload_pair_torch(pw, aw2, k)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )
    return results


def log_timings(results):
    for name, r in results.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain torch "
            f"{r['plain_ms']:.4f} ms, library {lib}, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) (device time a "
            "call: medians of 5 timings of 10 back-to-back calls, CUDA "
            "events, the card held busy while the host queues them)")


# ---------------------------------------------------------------- phase 4

def _churn_loader(snaps, n_halos, box, cosmology=None):
    """Callbacks over churn_snapshots output: every halo is requested at
    every snapshot, so the loader returns all blocks in halo order."""
    centers = np.stack([snaps[0][h]["center"] for h in range(n_halos)])
    radii = np.full(n_halos, 50.0)

    def regions(snapshot_number, halo_ids):
        return centers[halo_ids], radii[halo_ids]

    def load(snapshot_number, positions, rr):
        s = snaps[snapshot_number]
        lens = [len(s[h]["ids"]) for h in range(n_halos)]
        out = dict(
            ids=np.concatenate([s[h]["ids"] for h in range(n_halos)]),
            coordinates=np.concatenate([s[h]["pos"] for h in range(n_halos)]),
            velocities=np.concatenate([s[h]["vel"] for h in range(n_halos)]),
            masses=np.concatenate([s[h]["mass"] for h in range(n_halos)]),
            region_offsets=np.concatenate(([0], np.cumsum(lens)[:-1])),
            box_size=box,
        )
        out.update(cosmology or {})
        return out

    return regions, load


def _as_f32(snaps):
    """Store positions, velocities, masses and centres as float32, so
    the device and the float64 oracle see the same input values."""
    for s in snaps:
        for d in s.values():
            for key in ("pos", "vel", "mass", "center"):
                d[key] = d[key].astype(np.float32)
    return snaps


def step_parity(dev):
    import torch

    from orbitanalysis_tpu_torch.engine.packing import (
        StableLayout,
        pack_snapshot_aligned,
    )
    from orbitanalysis_tpu_torch.engine.tracker import _stage
    from orbitanalysis_tpu_torch.models.synthetic import churn_snapshots
    from orbitanalysis_tpu_torch.ops.sorted_step import (
        init_aligned_carry,
        make_aligned_native_step,
    )

    h, p, pool, n_snap = PARITY
    box = 100.0
    snaps, _ = churn_snapshots(h, pool, n_snap, box_size=box, churn=0.07,
                               seed=5)
    regions, load = _churn_loader(_as_f32(snaps), h, box)
    rows = np.arange(h)
    lay = StableLayout(h, p)
    step = make_aligned_native_step(p // 16, box_size=box)
    c_gpu = init_aligned_carry(h, p, device=dev)
    c_cpu = init_aligned_carry(h, p, device="cpu")
    total = beyond = 0
    worst = 0.0
    rhat_equal = True
    for s in range(n_snap):
        rp, rr = regions(s, rows)
        pk = pack_snapshot_aligned(load(s, rp, rr), rows, h, lay, rp)
        c_gpu, e_gpu = step(c_gpu, _stage(pk, 0.0, dev))
        c_cpu, e_cpu = step(c_cpu, _stage(pk, 0.0, "cpu"))
        count = e_cpu.count.numpy()
        check(np.array_equal(e_gpu.count.cpu().numpy(), count),
              f"step {s}: event counts differ between CUDA and CPU")
        ids_g, ids_c = e_gpu.ids.cpu().numpy(), e_cpu.ids.numpy()
        ang_g, ang_c = e_gpu.angles.cpu().numpy(), e_cpu.angles.numpy()
        for r in range(h):
            n = min(int(count[r]), ids_c.shape[1])
            check(np.array_equal(ids_g[r, :n], ids_c[r, :n]),
                  f"step {s} row {r}: event positions differ")
        sel = np.arange(ids_c.shape[1])[None, :] < count[:, None]
        ulps, diff = f16_ulps(ang_g[sel], ang_c[sel])
        worst = max(worst, float(diff.max(initial=0)))
        beyond += int((ulps > 1).sum())
        same = torch.equal(c_gpu.rhat.cpu().view(torch.int32),
                           c_cpu.rhat.view(torch.int32))
        rhat_equal &= same
        total += int(count.sum())
        log(f"  snapshot {s}: {int(count.sum())} events, counts/positions "
            f"equal, {int((ulps > 1).sum())} angles beyond one f16 ulp "
            f"(max |diff| {diff.max(initial=0):.3g} rad), carry r-hat "
            f"{'bit-equal' if same else 'DIFFERS'}")
    check(total > 0, "step parity produced no events")
    log(f"  {total} events: {beyond} angles beyond one f16 ulp (max |diff| "
        f"{worst:.3g} rad); carry r-hat planes bit-equal at every step: "
        f"{rhat_equal}")
    check(beyond == 0, f"{beyond} event angles differ by more than one f16 "
          "ulp between CUDA and CPU")
    check(rhat_equal, "carry r-hat planes differ between CUDA and CPU")
    check(torch.equal(c_gpu.key.cpu(), c_cpu.key),
          "carry keys differ between CUDA and CPU")


# ---------------------------------------------------------------- phase 5

def catalogs_equal(a, b):
    """tests/test_engine.py::_assert_files_equal on in-memory catalogs:
    angles to one f16 ulp (atol 4e-3), bulk velocities to about one f32
    ulp, everything else exact."""
    check(sorted(a) == sorted(b), "catalog groups differ")
    for g in a:
        if g == "attrs":
            check(a[g] == b[g], "root attributes differ")
            continue
        check(sorted(a[g]) == sorted(b[g]), f"{g}: datasets differ")
        for ds in a[g]:
            x, y = a[g][ds], b[g][ds]
            if ds == "angles":
                ok = x.shape == y.shape and np.allclose(
                    x.astype(np.float32), y.astype(np.float32), rtol=0,
                    atol=4e-3)
            elif ds == "bulk_velocities":
                ok = np.allclose(x, y, rtol=2e-6, atol=1e-6)
            else:
                ok = x.shape == y.shape and np.array_equal(x, y)
            check(ok, f"{g}/{ds} differs between the engines")


def oracle_check(snaps, cat, hubble_drag, box, n_check):
    """Event ID sets of the first ``n_check`` halos against the NumPy
    oracle (tests/oracle.py) in float64.  A particle whose float64 radial
    velocity lies within 1e-5 of zero at either snapshot has a sign that
    float32 cannot settle; such particles are left out on both sides and
    counted."""
    from oracle import OracleTracker

    oracle = OracleTracker(mode="pericentric", box_size=box)
    ambiguous = compared = 0
    for s, snap in enumerate(snaps):
        halos = {h: dict(snap[h], hubble_drag=hubble_drag)
                 for h in range(n_check)}
        prev = oracle.state
        ev = oracle.step(halos)
        if s == 0:
            continue
        g = cat["snapshot_%03d" % s]
        offs = g["region_offsets"]
        for h in range(n_check):
            want = set(ev[h][0].tolist())
            got = set(g["pericenter_IDs"][offs[h]:offs[h + 1]].tolist())
            for pid in want ^ got:
                vr0 = prev[h][pid][0] if pid in prev.get(h, {}) else 1.0
                vr1 = oracle.state[h][pid][0]
                check(min(abs(vr0), abs(vr1)) < 1e-5,
                      f"snapshot {s} halo {h}: particle {pid} disagrees "
                      f"with the oracle (v_r {vr0:.3g} -> {vr1:.3g})")
                ambiguous += 1
            compared += len(want)
    return compared, ambiguous


def end_to_end(dev):
    import torch

    from orbitanalysis_tpu_torch import track_orbits
    from orbitanalysis_tpu_torch.engine.io_hdf5 import MemoryWriter
    from orbitanalysis_tpu_torch.engine.packing import (
        StableLayout,
        pack_snapshot_aligned,
    )
    from orbitanalysis_tpu_torch.engine.tracker import _stage
    from orbitanalysis_tpu_torch.models.synthetic import churn_snapshots
    from orbitanalysis_tpu_torch.ops import _cuda, sorted_step
    from orbitanalysis_tpu_torch.ops.sorted_step import (
        init_aligned_carry,
        make_aligned_native_step,
    )
    from orbitanalysis_tpu_torch.utils.metrics import Metrics
    from orbitanalysis_tpu_torch.utils.numerics import hubble_parameter

    n_halos, pool, n_snap, box = E2E
    cosmo = dict(redshift=0.5, H0=0.1, Omega_m=0.3, Omega_L=0.7)
    hubble_drag = float(hubble_parameter(0.5, 0.1, 0.3, 0.7) / 1.5)
    t0 = time.perf_counter()
    snaps, _ = churn_snapshots(n_halos, pool, n_snap, box_size=box,
                               churn=0.07, seed=2)
    regions, load = _churn_loader(_as_f32(snaps), n_halos, box, cosmo)
    members = sum(len(d["ids"]) for s in snaps for d in s.values())
    log(f"  data: {n_halos} halos x {n_snap} snapshots, "
        f"{len(snaps[0][0]['ids'])} members in halo 0 at snapshot 0, "
        f"{members} particle-snapshots ({time.perf_counter() - t0:.1f} s "
        "to generate)")
    snap_nums = np.arange(n_snap)
    branches = np.tile(np.arange(n_halos), (n_snap, 1))

    # wide rows: one halo past PAYLOAD_MAX_ROW members -> pair kernel
    wide_snaps, _ = churn_snapshots(1, WIDE_POOL, 3, box_size=box,
                                    churn=0.07, seed=3)
    w_regions, w_load = _churn_loader(_as_f32(wide_snaps), 1, box)

    # ---- the main path, counted
    _cuda.reset_launch_counts()
    m_auto, m_wide = Metrics(), Metrics()
    w_auto = MemoryWriter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    track_orbits(snap_nums, branches, regions, load, "auto.h5",
                 verbose=False, metrics=m_auto, writer=w_auto, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts_auto = _cuda.launch_counts()
    track_orbits(np.arange(3), np.zeros((3, 1), np.int64), w_regions,
                 w_load, "wide.h5", verbose=False, join_impl="aligned",
                 metrics=m_wide, writer=MemoryWriter(), device=dev)
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    # ---- end of the counted main path

    joins = {r["join"] for r in m_auto.records}
    check(joins == {"aligned"}, f"join_impl='auto' ran {joins} on CUDA")
    steps = len(m_auto.records) + 1  # the first snapshot seeds the carry
    log(f"  auto: engine {sorted(joins)}, capacity "
        f"{m_auto.records[0]['capacity']}, {steps} aligned steps, "
        f"compact_angle_rows launches {counts_auto['compact_angle_rows']}")
    check(counts_auto["compact_angle_rows"] == steps,
          "compaction kernel launches != aligned steps")
    check(counts_auto["compact_pair_rows"] == 0,
          "pair kernel launched on rows that fit one word")
    wide_steps = len(m_wide.records) + 1
    check(m_wide.records[0]["capacity"] > sorted_step.PAYLOAD_MAX_ROW,
          "the wide-row run did not get rows past PAYLOAD_MAX_ROW")
    check(launches["compact_pair_rows"] == wide_steps,
          "pair kernel launches != wide-row aligned steps")
    log(f"  wide rows: capacity {m_wide.records[0]['capacity']}, "
        f"{wide_steps} aligned steps, compact_pair_rows launches "
        f"{launches['compact_pair_rows']}")
    n_events = sum(r["n_events"] for r in m_auto.records)
    check(n_events > 0, "no events in the end-to-end run")

    w_gen = MemoryWriter()
    m_gen = Metrics()
    t1 = time.perf_counter()
    track_orbits(snap_nums, branches, regions, load, "general.h5",
                 verbose=False, join_impl="general", metrics=m_gen,
                 writer=w_gen, device=dev)
    torch.cuda.synchronize()
    wall_gen = time.perf_counter() - t1
    catalogs_equal(w_auto.files["auto.h5"], w_gen.files["general.h5"])
    log("  aligned and general catalogs equal (angles within 4e-3, bulk "
        "velocities rtol 2e-6)")
    compared, ambiguous = oracle_check(snaps, w_auto.files["auto.h5"],
                                       hubble_drag, box, ORACLE_HALOS)
    log(f"  oracle: first {ORACLE_HALOS} halos, {compared} events compared, "
        f"{ambiguous} sign-ambiguous particles left out")

    # device time of one aligned step at this shape, on staged batches
    cap = m_auto.records[0]["capacity"]
    lay = StableLayout(n_halos, cap)
    rows = np.arange(n_halos)
    batches = []
    for s in range(n_snap):
        rp, rr = regions(s, rows)
        pk = pack_snapshot_aligned(load(s, rp, rr), rows, n_halos, lay, rp)
        batches.append(_stage(pk, hubble_drag, dev))
    step = make_aligned_native_step(
        m_auto.records[0]["event_capacity"], box_size=box)
    carry = init_aligned_carry(n_halos, cap, device=dev)
    carry, _ = step(carry, batches[0])
    times, queue = [], []
    for b in batches[1:]:
        a, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        t1 = time.perf_counter()
        carry, _ = step(carry, b)
        queue.append((time.perf_counter() - t1) * 1e3)
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    step_ms = statistics.median(times)
    rate = members / wall
    log(f"  end to end (aligned, incl. host pipeline): wall {wall:.3f} s, "
        f"{rate:.4g} particle-snapshot updates/s, {n_events} events")
    log(f"  general engine on the card: wall {wall_gen:.3f} s, "
        f"{members / wall_gen:.4g} updates/s")
    log(f"  aligned step on device: {step_ms:.4f} ms/step (median of "
        f"{len(times)}, CUDA events, [{n_halos}, {cap}]); the host takes "
        f"{statistics.median(queue):.4f} ms to queue one step")
    return launches, dict(
        snaps=snaps, regions=regions, load=load, snap_nums=snap_nums,
        branches=branches, general=w_gen.files["general.h5"],
        members=members, hubble_drag=hubble_drag, box=box,
        wall_aligned=wall, wall_general=wall_gen)


# ---------------------------------------------------- label-native phases

def stage_aligned(dev, form, n_snap):
    """The first ``n_snap`` snapshots of an ID-form sequence ``(ids, pos,
    vel, centers, _)`` staged in the stable layout, one
    ``pack_snapshot_aligned`` a snapshot (each row's members in load
    order are the loader's region blocks), with SoA position and
    velocity planes: a SnapshotBatch of ``[S, ...]`` tensors on the
    card."""
    import torch

    from orbitanalysis_tpu_torch.engine.packing import (
        StableLayout,
        pack_snapshot_aligned,
    )
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch

    ids, pos, vel, cen, _ = form
    h, c = ids.shape[1:]
    rows = np.arange(h)
    lay = StableLayout(h, c)

    def plane(*shape, dtype=torch.float32):
        return torch.empty((n_snap, *shape), dtype=dtype, device=dev)

    out = SnapshotBatch(
        ids=plane(h, c, dtype=torch.int32), pos=plane(3, h, c),
        vel=plane(3, h, c),
        center=torch.from_numpy(np.ascontiguousarray(cen[:n_snap])).to(dev),
        slot=plane(h, c, dtype=torch.int32))
    for s in range(n_snap):
        valid = ids[s] != np.iinfo(np.int32).max
        n_valid = valid.sum(axis=1)
        pk = pack_snapshot_aligned(dict(
            ids=ids[s][valid], coordinates=pos[s][valid],
            velocities=vel[s][valid],
            region_offsets=np.concatenate(([0], np.cumsum(n_valid)[:-1]))),
            rows, h, lay, cen[s])
        out.ids[s].copy_(torch.from_numpy(pk.ids))
        out.pos[s].copy_(torch.from_numpy(pk.pos).permute(2, 0, 1))
        out.vel[s].copy_(torch.from_numpy(pk.vel).permute(2, 0, 1))
        out.slot[s].copy_(torch.from_numpy(pk.slot))
    return out


def bench_workloads(dev):
    """The JAX benchmark's workloads from one orbit pool, made on the host
    from its seed: the label-native churn sequence (moved to the card),
    the same churn in the ID form (load order on the host for the
    general engine's check, staged ID-sorted with SoA planes on the card,
    and staged in the stable layout) and the first SORTED_CHECK snapshots
    of the fixed-membership sequence (staged both ways)."""
    import torch

    from orbitanalysis_tpu_torch.models.synthetic import bench_workloads
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu_torch.ops.sorted_step import presort_snapshot

    t0 = time.perf_counter()
    w = bench_workloads(*LABEL, seed=0, churn=0.07)
    t_gen = time.perf_counter() - t0
    lab, pos, vel, cen, n_valid = w["label"]
    work = dict(label=torch.from_numpy(lab).to(dev),
                pos=torch.from_numpy(pos).to(dev),
                vel=torch.from_numpy(vel).to(dev),
                centers=torch.from_numpy(cen).to(dev), n_valid=n_valid)
    del lab, pos, vel
    t1 = time.perf_counter()
    staged = {}
    for form, n_snap in (("churn", LABEL[2]), ("static", SORTED_CHECK)):
        ids, pos, vel, cen, nv = w[form]
        b = presort_snapshot(SnapshotBatch(
            ids=ids[:n_snap], pos=pos[:n_snap], vel=vel[:n_snap],
            center=cen[:n_snap]), soa=True)
        staged[form] = (SnapshotBatch(
            ids=torch.from_numpy(b.ids).to(dev),
            pos=torch.from_numpy(b.pos).to(dev),
            vel=torch.from_numpy(b.vel).to(dev),
            center=torch.from_numpy(b.center).to(dev),
            slot=torch.from_numpy(b.slot).to(dev)), nv)
    ids, pos, vel, cen, _ = w["churn"]
    load_order = tuple(
        torch.from_numpy(np.ascontiguousarray(x[:SORTED_CHECK])).to(dev)
        for x in (ids, pos, vel, cen))
    del ids, pos, vel
    t_sorted = time.perf_counter() - t1
    t1 = time.perf_counter()
    aligned = stage_aligned(dev, w["churn"], LABEL[2])
    aligned_static = stage_aligned(dev, w["static"], SORTED_CHECK)
    del w
    torch.cuda.synchronize()
    t_aligned = time.perf_counter() - t1
    log(f"  bench workloads {LABEL[0]} halos x {LABEL[1]} slots x "
        f"{LABEL[2]} snapshots: label N = {work['label'].shape[1]}, "
        f"{n_valid} tracked at snapshot 0; churn ID form "
        f"{staged['churn'][1]} members a row; {t_gen:.1f} s to generate "
        f"on the host, {t_sorted:.1f} s to stage ID-sorted and move to the "
        f"card, {t_aligned:.1f} s to stage {LABEL[2]} + {SORTED_CHECK} "
        "snapshots in the stable layout (pack_snapshot_aligned) and move "
        "them to the card")
    return work, dict(churn=staged["churn"][0], n_valid=staged["churn"][1],
                      static=staged["static"][0],
                      n_static=staged["static"][1], load_order=load_order,
                      aligned=aligned, aligned_static=aligned_static)


def _detect_inputs(dev, work, packed):
    """Inputs of the detect pass of snapshot 3 on the carry the CUDA label
    step leaves after snapshots 0-2 (so matched lanes exist): the frame
    rows, labels, positions, velocities and carry planes, and the frame
    table the rows were gathered from."""
    import torch

    from orbitanalysis_tpu_torch.ops import frames
    from orbitanalysis_tpu_torch.ops import label_step as ls

    n = work["label"].shape[1]
    r, w = n // LABEL_ROW, LABEL_ROW
    step = ls.make_label_orbit_step(LABEL_K, box_size=LABEL_BOX,
                                    row_width=w, rhat_packed=packed)
    carry = ls.init_label_carry(n, packed, w, device=dev)
    for s in range(3):
        carry, _ = step(carry, (work["pos"][s], work["vel"][s],
                                work["label"][s], work["centers"][s], None,
                                None, 0.0))
    lab = work["label"][3]
    mom = frames.segment_moments(lab, work["vel"][3], None,
                                 n_halos=LABEL[0])
    bulk = mom[:, :3] / torch.clamp(mom[:, 3:4], min=1e-30)
    table = torch.cat([work["centers"][3], bulk], dim=1)
    rows = frames.frame_rows(table, lab).reshape(6, r, w)
    return [rows, lab.reshape(r, w), work["pos"][3].reshape(3, r, w),
            work["vel"][3].reshape(3, r, w), *carry], table


def label_kernel_checks(dev, work):
    """K4/K5, K6, K7, K8, K9 and K10 against their plain versions on the
    same CUDA tensors, at the label path's full-width shapes."""
    import torch
    import torch.nn.functional as F

    from orbitanalysis_tpu_torch.ops import compact, frames, label

    results = {}
    rng = np.random.default_rng(4)
    n = work["label"].shape[1]
    r, w, k = n // LABEL_ROW, LABEL_ROW, LABEL_K
    k128 = compact._k128(k, w)

    # K4/K5: payload words at [64, 32768]
    worst = 0
    for density in (0.0, 0.017, 0.07, 0.5, 1.0, "clustered"):
        if density == "clustered":
            sel = rng.random((r, w)) < 0.01
            sel[1, w // 8:w // 8 + 700] = True
            sel[2, w - 200:] = True
        else:
            sel = rng.random((r, w)) < density
        ang = rng.integers(0, 0x7BFF, (r, w)).astype(np.uint32)
        pos1 = np.arange(1, w + 1, dtype=np.uint32)
        pay = np.where(sel, (pos1 << np.uint32(15)) | ang, np.uint32(0))
        x = torch.from_numpy(pay.view(np.int32)).to(dev)
        got = compact.compact_payload(x, k)
        got_b = compact.compact_payload_blocked(x, k)
        want = compact.compact_payload_torch(x, k)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        log(f"  compact_payload_rows [{r}, {w}] K={k} density={density}: "
            f"events {int(sel.sum())}, max |kernel - plain| = {err}")
        check(torch.equal(got, want) and torch.equal(got_b, want),
              f"compact_payload_rows differs from its plain version at "
              f"{density}")
        if density == 0.017:
            b_ms, b_by = bound(x.numel() * 4 + r * k128 * 4, 4 * x.numel())
            results["compact_payload_rows"] = dict(
                ms=cuda_ms(lambda: compact.compact_payload(x, k)),
                plain_ms=cuda_ms(lambda: compact.compact_payload_torch(x, k)),
                library_ms=None, bound_ms=b_ms, bound_by=b_by)
    results["compact_payload_rows"]["max_abs_err"] = worst

    # K6: frame rows of snapshot 0 (10 % of the pool untracked: -1)
    lab = work["label"][0]
    table = torch.from_numpy(rng.normal(
        size=(LABEL[0], 6)).astype(np.float32)).to(dev)
    got = frames.frame_rows(table, lab)
    want = frames.frame_rows_torch(table, lab)
    torch.cuda.synchronize()
    n_neg = int((lab < 0).sum())
    check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
          "frame_rows differs from its plain version")
    log(f"  frame_rows [{LABEL[0]}, 6] x {n} labels ({n_neg} of them -1): "
        "bit-exact")
    lab1 = lab + 1
    padded = torch.cat([torch.zeros_like(table[:1]), table])
    b_ms, b_by = bound(n * 4 + table.numel() * 4 + 6 * n * 4, 0)
    results["frame_rows"] = dict(
        max_abs_err=float((got - want).abs().max()),
        ms=cuda_ms(lambda: frames.frame_rows(table, lab)),
        plain_ms=cuda_ms(lambda: frames.frame_rows_torch(table, lab)),
        library_ms=cuda_ms(lambda: F.embedding(lab1, padded)),
        bound_ms=b_ms, bound_by=b_by)

    # K7: moments of snapshot 0, without masses (the main path) and with
    vel = work["vel"][0]
    mass = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)
                            ).to(dev)
    worst = 0.0
    for m in (None, mass):
        got = frames.segment_moments(lab, vel, m, n_halos=LABEL[0])
        again = frames.segment_moments(lab, vel, m, n_halos=LABEL[0])
        want = frames.segment_moments_torch(lab, vel, m, n_halos=LABEL[0])
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"  segment_moments {'with' if m is not None else 'without'} "
            f"masses: max |kernel - plain| = {err:.3g} (|sum| up to "
            f"{float(want.abs().max()):.6g}); rerun bit-identical: "
            f"{torch.equal(got, again)}")
        check(torch.equal(got, again), "segment_moments is not repeatable")
        check(torch.allclose(got, want, rtol=2e-6, atol=2e-6),
              "segment_moments differs from its plain version")
    ok = (lab >= 0).to(torch.float32)
    idx = torch.clamp(lab, min=0)
    vals = torch.cat([vel.T * ok[:, None], ok[:, None]], dim=1).contiguous()
    acc = torch.zeros((LABEL[0], 4), device=dev)
    b_ms, b_by = bound(n * 16 + LABEL[0] * 16, 7 * n)
    results["segment_moments"] = dict(
        max_abs_err=worst,
        ms=cuda_ms(lambda: frames.segment_moments(lab, vel, None,
                                                  n_halos=LABEL[0])),
        plain_ms=cuda_ms(lambda: frames.segment_moments_torch(
            lab, vel, None, n_halos=LABEL[0])),
        library_ms=cuda_ms(lambda: acc.index_add_(0, idx, vals)),
        bound_ms=b_ms, bound_by=b_by)

    # K8 / K9 on snapshot 3 of the carry after three real steps
    kw = dict(pericentric=True, box_size=LABEL_BOX)
    worst = {"detect_label_compact_rows": 0.0, "detect_label_rows": 0.0,
             "fused_label_rows": 0}
    for packed in (False, True):
        args, table = _detect_inputs(dev, work, packed)
        k9 = label.detect_label(*args, 0.0, rhat_packed=packed, **kw)
        k8 = label.detect_label_compact(*args, 0.0, event_capacity=k,
                                        rhat_packed=packed, **kw)
        plain = label.detect_label_torch(*args, 0.0, rhat_packed=packed,
                                         **kw)
        plain_ev = compact.compact_payload_torch(plain[3], k)
        torch.cuda.synchronize()
        matched = int((args[6] < 0).sum())
        for name, got, want in (
                ("detect_label_rows", k9, plain),
                ("detect_label_compact_rows", k8,
                 (*plain[:3], plain_ev, plain[4]))):
            diff = {f: int((g.view(torch.int32) != v.view(torch.int32)).sum())
                    for f, g, v in zip(("lab_sv", "rhat", "packed",
                                        "events", "count"), got, want)}
            check(torch.equal(got[4], want[4]), f"{name}: counts differ")
            check(torch.equal(got[0], want[0]), f"{name}: lab_sv differs")
            check(torch.equal(got[2] < 0, want[2] < 0),
                  f"{name}: matched bits differ")
            check(torch.equal((got[3] >> 15) & 0x1FFFF,
                              (want[3] >> 15) & 0x1FFFF),
                  f"{name}: event positions differ")
            d16 = int(((got[3] & 0x7FFF) - (want[3] & 0x7FFF)).abs().max())
            dang = float(((got[2] & 0x7FFFFFFF).view(torch.float32)
                          - (want[2] & 0x7FFFFFFF).view(torch.float32)
                          ).abs().max())
            check(d16 <= 1 or dang <= ANGLE_ATOL,
                  f"{name}: angles differ by {d16} f16 ulps, {dang:.3g} rad")
            worst[name] = max(worst[name], dang)
            log(f"  {name} [{r}, {w}] rhat {'packed' if packed else 'f32'}: "
                f"{int(want[4].sum())} events, {matched} matched lanes in; "
                f"counts, lab_sv, matched bits and positions equal; lanes "
                f"that differ at all: {diff}; max f16 ulps {d16}, max "
                f"|angle diff| {dang:.3g} rad")
        if packed:
            # bytes a particle: rows 24, label 4, pos 12, vel 12, sv 4,
            # rhat 4, packed 4 in; sv, rhat, packed out (+ payload 4 for
            # K9, the [R, k128] events for K8); ~120 float operations
            b8 = bound(n * 76 + r * k128 * 4 + r * 4, 120 * n)
            b9 = bound(n * 80 + r * 4, 120 * n)
            results["detect_label_compact_rows"] = dict(
                ms=cuda_ms(lambda: label.detect_label_compact(
                    *args, 0.0, event_capacity=k, rhat_packed=True, **kw)),
                plain_ms=cuda_ms(lambda: label.detect_label_compact_torch(
                    *args, 0.0, event_capacity=k, rhat_packed=True, **kw)),
                library_ms=None, bound_ms=b8[0], bound_by=b8[1])
            results["detect_label_rows"] = dict(
                ms=cuda_ms(lambda: label.detect_label(
                    *args, 0.0, rhat_packed=True, **kw)),
                plain_ms=cuda_ms(lambda: label.detect_label_torch(
                    *args, 0.0, rhat_packed=True, **kw)),
                library_ms=None, bound_ms=b9[0], bound_by=b9[1])

        # K10 on the same inputs, the rows plane replaced by the table it
        # was gathered from: every output bit for bit
        got = label.fused_label_detect(table, *args[1:], 0.0,
                                       rhat_packed=packed, **kw)
        want = label.fused_label_detect_torch(table, *args[1:], 0.0,
                                              rhat_packed=packed, **kw)
        ne, diff = _bitwise(got, want)
        worst["fused_label_rows"] = max(worst["fused_label_rows"], diff)
        log(f"  fused_label_rows [{r}, {w}] rhat "
            f"{'packed' if packed else 'f32'}: {int(want[4].sum())} events; "
            f"lanes that differ from the plain version (carry planes, "
            f"payload, counts) {ne}")
        check(ne == 0, "fused_label_rows differs from its plain version")
        if packed:
            # bytes a particle: label 4, pos 12, vel 12, sv 4, rhat 4,
            # packed 4 in; sv, rhat, packed, payload 4 each out; the
            # table once
            b10 = bound(n * 56 + r * 4 + table.numel() * 4, 120 * n)
            results["fused_label_rows"] = dict(
                ms=cuda_ms(lambda: label.fused_label_detect(
                    table, *args[1:], 0.0, rhat_packed=True, **kw)),
                plain_ms=cuda_ms(lambda: label.fused_label_detect_torch(
                    table, *args[1:], 0.0, rhat_packed=True, **kw)),
                library_ms=None, bound_ms=b10[0], bound_by=b10[1])
    for name, err in worst.items():
        results[name]["max_abs_err"] = err
    return results


def _compare_events(a, b, what):
    """Counts and positions exact, angles within one f16 ulp or
    ANGLE_ATOL; returns (events, angles beyond one ulp, max diff)."""
    ca, cb = a.count.cpu().numpy(), b.count.cpu().numpy()
    check(np.array_equal(ca, cb), f"{what}: event counts differ")
    ia, ib = a.index.cpu().numpy(), b.index.cpu().numpy()
    check(np.array_equal(ia, ib), f"{what}: event positions differ")
    sel = ia >= 0
    ulps, diff = f16_ulps(a.angle.cpu().numpy()[sel],
                          b.angle.cpu().numpy()[sel])
    check(np.all((ulps <= 1) | (diff <= ANGLE_ATOL)),
          f"{what}: event angles differ by {diff.max(initial=0):.3g} rad")
    return int(ca.sum()), int((ulps > 1).sum()), float(diff.max(initial=0))


def label_parity(dev, work):
    """The label step on CUDA against the CPU on the first rows of the
    pool, with the bulk velocities given (both sides the same frames),
    through K8 (K = 2048) and through K9 + the payload compaction
    (K = 8192 exceeds the 256 x 16 block fronts of a 32768 row)."""
    import torch

    from orbitanalysis_tpu_torch.ops import frames
    from orbitanalysis_tpu_torch.ops import label_step as ls

    rows, n_snap = LABEL_PARITY
    n = rows * LABEL_ROW
    h = rows  # the first rows hold halos 0 .. rows - 1
    host = {key: work[key][:n_snap].cpu() for key in ("label", "pos", "vel")}
    host = dict(label=host["label"][:, :n], pos=host["pos"][:, :, :n],
                vel=host["vel"][:, :, :n],
                centers=work["centers"][:n_snap, :h].cpu())
    bulk = torch.stack([
        (lambda m: m[:, :3] / torch.clamp(m[:, 3:4], min=1e-30))(
            frames.segment_moments_torch(host["label"][s], host["vel"][s],
                                         n_halos=h))
        for s in range(n_snap)])
    for k in (LABEL_K, 8192):
        out = []
        for d in (dev, "cpu"):
            carry = ls.init_label_carry(n, True, LABEL_ROW, device=d)
            _, ev = ls.scan_label_events(
                carry, host["pos"], host["vel"], host["label"],
                host["centers"], event_capacity=k, box_size=LABEL_BOX,
                bulk_vel_seq=bulk, row_width=LABEL_ROW, rhat_packed=True)
            out.append(ev)
        events, beyond, worst = _compare_events(*out, f"label parity K={k}")
        check(events > 0, "label parity produced no events")
        log(f"  K={k}: {events} events over {n_snap} snapshots of "
            f"[{rows}, {LABEL_ROW}], counts and positions equal CUDA vs "
            f"CPU; {beyond} angles beyond one f16 ulp (max |diff| "
            f"{worst:.3g} rad)")


def profile_scan(run_scan, s_n, wall_ms):
    """torch.profiler over one scan: device time by kernel, the launches
    a step issues, and the device's idle share of the steady-state wall
    time.  Reports and returns the device busy ms a step (None when the
    profiler saw no device time); checks nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_scan()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if e.device_type == torch.autograd.DeviceType.CUDA and t > 0:
            rows.append((t, e.count, e.key))
    total = sum(t for t, _, _ in rows) / 1e3
    if not rows:
        log("  profiler: no device time recorded")
        return None
    launches = sum(c for _, c, _ in rows)
    log(f"  profiler, one scan: device busy {total:.3f} ms "
        f"({total / s_n:.4f} ms/step), {launches / s_n:.1f} device "
        f"kernels a step; idle share of the steady-state wall "
        f"{max(0.0, 1 - total / wall_ms):.3f}; by kernel (ms/step, share):")
    for t, c, key in sorted(rows, reverse=True)[:12]:
        log(f"    {t / 1e3 / s_n:.4f} ms/step {t / 1e3 / total:6.1%} "
            f"x{c / s_n:.0f}/step  {key[:90]}")
    return total / s_n


def label_full_width(dev, work):
    """The label-native main path at full width (counted), then its
    timing.  Returns the kernel launches of the counted runs."""
    import torch

    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.ops import label_step as ls

    n = work["label"].shape[1]
    s_n = work["label"].shape[0]
    seq = (work["pos"], work["vel"], work["label"], work["centers"])
    kw = dict(box_size=LABEL_BOX, row_width=LABEL_ROW, rhat_packed=True)

    def scan(k, frames="auto", bulk=None):
        carry = ls.init_label_carry(n, True, LABEL_ROW, device=dev)
        return ls.scan_label_events(carry, *seq, event_capacity=k,
                                    frames=frames, bulk_vel_seq=bulk, **kw)

    # ---- the main path, counted
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, ev = scan(LABEL_K)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts_auto = _cuda.launch_counts()
    _, ev9 = scan(8192, bulk=ev.bulk_vel)
    _, ev2 = scan(LABEL_K, frames="twolevel", bulk=ev.bulk_vel)
    torch.cuda.synchronize()
    c_fed = _cuda.launch_counts()
    _, evf = scan(LABEL_K, frames="fused")
    torch.cuda.synchronize()
    c_fused = _cuda.launch_counts()
    _, evp = scan(LABEL_K, frames="pallas")
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    # ---- end of the counted main path

    total = int(ev.count.sum())
    per_kernel = {name: counts_auto[name] for name in (
        "frame_rows", "segment_moments", "detect_label_compact_rows")}
    log(f"  frames='auto' at [{n // LABEL_ROW}, {LABEL_ROW}] x {s_n} "
        f"snapshots, K={LABEL_K}: {total} events (the JAX benchmark's "
        f"total: {LABEL_EVENTS}); launches {per_kernel}; first scan "
        f"{first_s:.3f} s incl. warm-up")
    check(total == LABEL_EVENTS,
          f"label path found {total} events, not {LABEL_EVENTS}")
    check(all(c == s_n for c in per_kernel.values()),
          f"frame_rows / segment_moments / detect_label_compact_rows "
          f"launches {per_kernel}, not {s_n} each")
    check(int(ev.count.max()) <= LABEL_K, "a row overflowed K = 2048")
    for other, what in ((ev9, "K=8192 (detect kernel + payload "
                               "compaction)"),
                        (ev2, "'twolevel' (plain chain + payload "
                              "compaction)")):
        k_other = other.index.shape[-1]
        check(torch.equal(other.count, ev.count),
              f"{what}: event counts differ from frames='auto'")
        check(torch.equal(other.index[..., :LABEL_K] if k_other > LABEL_K
                          else other.index, ev.index),
              f"{what}: event positions differ from frames='auto'")
        log(f"  {what}: the same {int(other.count.sum())} events and "
            "positions")
    check(launch_diff(c_fed, counts_auto) == {
        "frame_rows": s_n, "detect_label_rows": s_n,
        "compact_payload_rows": 2 * s_n},
          f"the runs with the bulk velocities fed back launched "
          f"{launch_diff(c_fed, counts_auto)}, not K6 and K9 once and the "
          "payload compaction twice a snapshot")
    for other, before, after, kernels, what in (
            (evf, c_fed, c_fused, ("segment_moments", "fused_label_rows",
                                   "compact_payload_rows"), "'fused'"),
            (evp, c_fused, launches, ("segment_moments", "frame_rows",
                                      "compact_payload_rows"), "'pallas'")):
        got = launch_diff(after, before)
        n_ev = int(other.count.sum())
        log(f"  frames={what}, K={LABEL_K}, bulk velocities estimated on "
            f"the card: {n_ev} events; launches {got}")
        check(n_ev == LABEL_EVENTS,
              f"frames={what} found {n_ev} events, not {LABEL_EVENTS}")
        check(got == {k: s_n for k in kernels},
              f"frames={what} launched {got}, not {kernels} once a snapshot")
        check(torch.equal(other.count, ev.count)
              and torch.equal(other.index, ev.index),
              f"frames={what}: events differ from frames='auto'")

    # ---- timing: wall and device ms per step over whole scans, the
    # host's time to queue a step, and where the device time goes
    for frames, what in (("auto", "'split': K7 -> K6 -> K8"),
                         ("fused", "K7 -> K10 -> K5")):
        step = ls.make_label_orbit_step(LABEL_K, frames=frames, **kw)

        def run_scan(queue=None):
            carry = ls.init_label_carry(n, True, LABEL_ROW, device=dev)
            for s in range(s_n):
                t1 = time.perf_counter()
                carry, _ = step(carry, (work["pos"][s], work["vel"][s],
                                        work["label"][s],
                                        work["centers"][s], None, None,
                                        0.0))
                if queue is not None:
                    queue.append((time.perf_counter() - t1) * 1e3)

        run_scan()  # warm-up
        walls, busy, queue = [], [], []
        for _ in range(LABEL_SCANS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            run_scan(queue)
            b.record()
            b.synchronize()
            walls.append(a.elapsed_time(b))
            busy.append(device_ms(run_scan))
        wall_ms, dev_ms = statistics.median(walls), statistics.median(busy)
        host_ms = statistics.median(queue)
        updates = s_n * work["n_valid"]
        log(f"  label step, frames='{frames}' ({what}), medians of "
            f"{LABEL_SCANS} scans of {s_n} steps (CUDA events): wall "
            f"{wall_ms / s_n:.4f} ms/step (scans {min(walls):.3f}-"
            f"{max(walls):.3f} ms), device {dev_ms / s_n:.4f} ms/step (the "
            f"card held busy while the host queues the scan; scans "
            f"{min(busy):.3f}-{max(busy):.3f} ms); the host takes "
            f"{host_ms:.4f} ms to queue a step; "
            f"{updates / (wall_ms * 1e-3):.4g} particle-snapshot updates/s "
            f"at the wall, {updates / (dev_ms * 1e-3):.4g} at the device "
            f"time ({s_n} x {work['n_valid']} updates a scan)")
        profile_scan(run_scan, s_n, wall_ms)
    return launches


# ---------------------------------------------------- sorted-engine phases

def _batch(stack, s):
    """Snapshot ``s`` of a staged stack as one step's batch."""
    return stack._replace(**{
        k: getattr(stack, k)[s]
        for k in ("ids", "pos", "vel", "center", "slot")})


def recorded_call(module, entry, run):
    """The last call's arguments to ``module.entry`` while ``run()``
    runs, where ``module`` is the module a step looks the entry point up
    in when it is made: the entry point is wrapped by a recorder for the
    run (every call goes through), so a kernel is checked on the inputs
    of a real step.  Returns ``(args, kwargs)``."""
    real = getattr(module, entry)
    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    setattr(module, entry, record)
    try:
        run()
    finally:
        setattr(module, entry, real)
    return calls[-1]


def run_steps(dev, stack, make_step, init_carry, n):
    """The first ``n`` steps of ``make_step()`` over ``stack``."""
    step = make_step()
    carry = init_carry(dev)
    for s in range(n):
        carry, _ = step(carry, _batch(stack, s))


def staged_call(dev, stack, module, entry, at=2, **kw):
    """The arguments the sorted step (``kw`` its options) passes to
    ``module.entry`` at step ``at`` of ``stack`` (:func:`recorded_call`)."""
    from orbitanalysis_tpu_torch.ops import sorted_step as tss

    args, _ = recorded_call(module, entry, lambda: run_steps(
        dev, stack, lambda: tss.make_sorted_orbit_step(
            LABEL_K, box_size=LABEL_BOX, cur_presorted=True, soa_batch=True,
            **kw),
        lambda d: tss.init_sorted_carry(LABEL[0], LABEL[1], device=d),
        at + 1))
    return args


def _bitwise(got, want):
    """(lanes that differ, max |difference| of the int32 bits) over
    tensors of 32-bit words."""
    import torch

    diff = ne = 0
    for g, w in zip(got, want):
        g, w = g.view(torch.int32), w.view(torch.int32)
        ne += int((g != w).sum())
        diff = max(diff, int((g.long() - w.long()).abs().max()))
    return ne, diff


def sorted_kernel_checks(dev, seq):
    """K15, K16, K18, K19 and K17 against their plain versions on the
    inputs of real steps at the bench shape [64, 32768], K = 2048: K16 on
    sorted churn step 2, K18 on static step 2, K15 and K19 on churn step 2
    of the unfused routes (K19 with a 6-channel group a, merge by sort,
    and a 1-channel one, merge by K15), K17 on aligned churn step 2
    (native) and aligned static step 2 (legacy)."""
    import torch

    from orbitanalysis_tpu_torch.ops import compact, merge
    from orbitanalysis_tpu_torch.ops import sorted_step as tss
    from orbitanalysis_tpu_torch.ops import step as tstep

    h, p, k = LABEL[0], LABEL[1], LABEL_K
    k128 = compact._k128(k, p)
    hp = h * p
    results = {}

    def record(name, got, want, fn, plain, n_bytes, n_ops, lib=None,
               what=""):
        torch.cuda.synchronize()
        ne, diff = _bitwise(got, want)
        log(f"  {name} [{h}, {p}] {what}: lanes that differ {ne}, max "
            f"|kernel - plain| {diff} (int32 bits)")
        check(ne == 0, f"{name} differs from its plain version {what}")
        b_ms, b_by = bound(n_bytes, n_ops)
        r = results.setdefault(name, dict(max_abs_err=0))
        r["max_abs_err"] = max(r["max_abs_err"], diff)
        if fn is not None:
            r.update(ms=cuda_ms(fn), plain_ms=cuda_ms(plain), bound_ms=b_ms,
                     bound_by=b_by,
                     library_ms=None if lib is None else cuda_ms(lib))

    # K16 on a churn step
    a = staged_call(dev, seq["churn"], tstep, "fused_join_detect",
                    fused=True)
    got = tstep.fused_join_detect(*a)
    want = tstep.fused_join_detect_torch(*a)
    log(f"  fused_join_detect: {int(want[4].sum())} events, max "
        f"{int(want[4].max())} a row, "
        f"{int((want[0] < 0).sum())} matched cur lanes")
    # 11 planes in; packed, three event planes and the counts out; ~80
    # operations a lane (two 15-step searches, the detect chain)
    record("fused_join_detect", got, want, lambda: tstep.fused_join_detect(*a),
           lambda: tstep.fused_join_detect_torch(*a),
           12 * hp * 4 + 3 * h * k128 * 4 + h * 4, 80 * 2 * hp,
           what="(churn step 2)")

    # K18 on a static step
    a = staged_call(dev, seq["static"], tss, "compact_events", fused=True)
    got = compact.compact_events(*a)
    want = compact.compact_events_torch(*a)
    log(f"  compact_events_rows: {int((a[0] < 0).sum())} events in")
    # packed read whole, key and sv only at the events
    record("compact_events_rows", got, want,
           lambda: compact.compact_events(*a),
           lambda: compact.compact_events_torch(*a),
           hp * 4 + gathered_bytes(a[0] < 0, k128, 2) + 3 * h * k128 * 4,
           4 * hp, what="(static step 2)")

    # K15 on the unfused route
    a = staged_call(dev, seq["churn"], tss, "merge_rows",
                    merge_impl="pallas", compact_impl="pallas")
    got = merge.merge_rows(*a)
    want = merge.merge_rows_torch(*a)
    keys = merge.u32_order(torch.cat([a[0][0], a[1][0]], dim=1))
    # six channels a side in, six [H, 2P] channels out; two or three
    # 15-step searches a lane
    record("merge_rows", got, want, lambda: merge.merge_rows(*a),
           lambda: merge.merge_rows_torch(*a), 24 * hp * 4, 3 * 15 * 2 * hp,
           lib=lambda: torch.sort(keys, dim=1), what="(churn step 2)")

    # K19 with the unfused routes' channel counts
    for merge_impl, n_a in (("lax_sort", 6), ("pallas", 1)):
        a = staged_call(dev, seq["churn"], tss, "compact_rows",
                        merge_impl=merge_impl, compact_impl="pallas")
        check(len(a[1]) == n_a, f"compact_rows got {len(a[1])} channels")
        got = compact.compact_rows(*a)
        want = compact.compact_rows_torch(*a)
        n = a[0].shape[1]
        timed = n_a == 6
        # both masks read whole, each group's channels only at its
        # selected lanes; every output lane written
        record("compact_rows_groups", [*got[0], *got[1]],
               [*want[0], *want[1]],
               (lambda: compact.compact_rows(*a)) if timed else None,
               (lambda: compact.compact_rows_torch(*a)) if timed else None,
               2 * h * n * 4 + gathered_bytes(a[0] != 0, a[2], n_a)
               + gathered_bytes(a[3] != 0, a[5], len(a[4]))
               + (n_a * a[2] + len(a[4]) * a[5]) * h * 4, 4 * 2 * h * n,
               what=f"(group a {n_a} channels over 2P = {n}, merge by "
               f"{merge_impl}; {int(a[3].sum())} events)")
    log("  merge_rows library yardstick: torch.sort of the concatenated "
        f"[{h}, {2 * p}] uint32 keys as int64, which moves no payload")

    # K17 on step 2 of the aligned churn sequence (native, detect_impl=
    # 'pallas') and of the aligned static sequence (the legacy step)
    for what, stack, make, init in (
            ("native, aligned churn step 2", seq["aligned"],
             lambda: tss.make_aligned_native_step(
                 LABEL_K, box_size=LABEL_BOX, soa_batch=True,
                 detect_impl="pallas"),
             lambda d: tss.init_aligned_carry(h, p, device=d)),
            ("legacy, aligned static step 2", seq["aligned_static"],
             lambda: tss.make_aligned_orbit_step(
                 LABEL_K, box_size=LABEL_BOX, soa_batch=True),
             lambda d: tss.init_sorted_carry(h, p, device=d))):
        a, kw = recorded_call(tstep, "fused_static_detect", lambda: run_steps(
            dev, stack, make, init, 3))
        got = tstep.fused_static_detect(*a, **kw)
        want = tstep.fused_static_detect_torch(*a, **kw)
        log(f"  static_detect_rows ({what}): {int(want[4].sum())} events, "
            f"max {int(want[4].max())} a row, "
            f"{int((want[0] < 0).sum())} matched lanes")
        native = kw.get("native", False)
        # 10 planes in; packed, three event planes and the counts out;
        # ~40 operations a lane (the Cephes arccos, the flip, the words)
        record("static_detect_rows", got, want,
               (lambda: tstep.fused_static_detect(*a, **kw)) if native
               else None,
               (lambda: tstep.fused_static_detect_torch(*a, **kw)) if native
               else None,
               11 * hp * 4 + 3 * h * k128 * 4 + h * 4, 40 * hp,
               what=f"({what})")
    return results


def time_scan(dev, stack, s_n, n_valid, what, step, init_carry):
    """Wall ms a step (CUDA events over whole scans of ``step`` from
    ``init_carry(dev)``), the device span a step with the card held busy
    while the host queues (a step that reads a flag on the host, as the
    sorted step does, syncs, so its span includes the host's time after
    each read), device busy ms a step (the profiler's sum of kernel
    times), the host's ms to issue a step, and updates/s; medians of
    LABEL_SCANS scans after one warm-up."""
    import torch

    h = LABEL[0]

    def run_scan(queue=None):
        carry = init_carry(dev)
        for s in range(s_n):
            t1 = time.perf_counter()
            carry, _ = step(carry, _batch(stack, s))
            if queue is not None:
                queue.append((time.perf_counter() - t1) * 1e3)

    run_scan()
    walls, spans, queue = [], [], []
    for _ in range(LABEL_SCANS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        run_scan(queue)
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b))
        spans.append(device_ms(run_scan))
    wall_ms, span_ms = statistics.median(walls), statistics.median(spans)
    host_ms = statistics.median(queue)
    updates = s_n * h * n_valid
    log(f"  {what}, medians of {LABEL_SCANS} scans of {s_n} "
        f"steps: wall {wall_ms / s_n:.4f} ms/step (scans "
        f"{min(walls):.3f}-{max(walls):.3f} ms), device span "
        f"{span_ms / s_n:.4f} ms/step (card held busy at the start), the "
        f"host takes {host_ms:.4f} ms to issue a step; "
        f"{updates / (wall_ms * 1e-3):.4g} particle-snapshot updates/s at "
        f"the wall ({s_n} x {h} x {n_valid} updates a scan)")
    busy = profile_scan(run_scan, s_n, wall_ms)
    if busy is not None:
        log(f"  {what}: {updates / (busy * s_n * 1e-3):.4g} updates/s at "
            "the device busy time")


def sorted_full_width(dev, seq):
    """Phase 8: the sorted engine on the JAX benchmark's cells (counted),
    its cross-checks, then its timings.  Returns the kernel launches of
    the counted runs."""
    import torch

    from orbitanalysis_tpu_torch.engine.scan import scan_events_sorted
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.ops import apsis as tapsis
    from orbitanalysis_tpu_torch.ops import sorted_step as tss

    h, p = LABEL[0], LABEL[1]
    churn, static = seq["churn"], seq["static"]
    s_n, n_chk = churn.ids.shape[0], SORTED_CHECK
    kw = dict(box_size=LABEL_BOX, cur_presorted=True, soa_batch=True)

    def scan(stack, **opts):
        return scan_events_sorted(
            tss.init_sorted_carry(h, p, device=dev), stack, LABEL_K,
            **kw, **opts)

    def head(stack):
        return stack._replace(**{k: getattr(stack, k)[:n_chk] for k in (
            "ids", "pos", "vel", "center", "slot")})

    # ---- the main path, counted
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, (cnt, ids, ang) = scan(churn, fused=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    c_churn = _cuda.launch_counts()
    _, (cnt_u, ids_u, ang_u) = scan(head(churn), merge_impl="pallas",
                                    compact_impl="pallas")
    torch.cuda.synchronize()
    c_unf = _cuda.launch_counts()
    _, (cnt_s, ids_s, _) = scan(static, fused=True)
    torch.cuda.synchronize()
    c_static = _cuda.launch_counts()
    legacy = tss.make_aligned_orbit_step(LABEL_K, box_size=LABEL_BOX,
                                         soa_batch=True)
    carry = tss.init_sorted_carry(h, p, device=dev)
    leg = []
    for s in range(n_chk):
        carry, ev = legacy(carry, _batch(seq["aligned_static"], s))
        leg.append(ev)
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    # ---- end of the counted main path

    diff = launch_diff
    total = int(cnt.sum())
    log(f"  churn, fused, [{h}, {p}] x {s_n} snapshots, K={LABEL_K}: "
        f"{total} events (the JAX benchmark's total: {LABEL_EVENTS}), max "
        f"{int(cnt.max())} a row; launches {diff(c_churn)}; first scan "
        f"{first_s:.3f} s incl. warm-up")
    check(total == LABEL_EVENTS,
          f"sorted engine found {total} events, not {LABEL_EVENTS}")
    check(int(cnt.max()) <= LABEL_K, "a row overflowed K = 2048")
    check(diff(c_churn) == {"fused_join_detect": s_n},
        "the churn scan did not launch K16 once a step (and nothing else)")
    check(diff(c_unf, c_churn) == {"merge_rows": n_chk,
                                   "compact_rows_groups": n_chk},
          "the unfused route did not launch K15 and K19 once a step")
    check(diff(c_static, c_unf) == {"fused_join_detect": 1,
                                    "compact_events_rows": n_chk - 1},
          f"the static scan launched {diff(c_static, c_unf)}, not K16 once "
          f"and K18 {n_chk - 1} times")
    log(f"  static, fused, {n_chk} snapshots: {int(cnt_s.sum())} events; "
        f"launches {diff(c_static, c_unf)}")
    check(int(cnt_s.sum()) == STATIC_EVENTS,
          f"the static scan found {int(cnt_s.sum())} events, not "
          f"{STATIC_EVENTS}")
    # the legacy aligned step: the same event ID sets a row
    cnt_l = torch.stack([e.count for e in leg])
    check(diff(launches, c_static) == {"static_detect_rows": n_chk},
          f"the legacy aligned step launched {diff(launches, c_static)}, "
          f"not K17 {n_chk} times")
    check(torch.equal(cnt_l, cnt_s), "legacy aligned step: counts differ "
          "from the sorted engine's")
    big = torch.iinfo(torch.int32).max
    for s, e in enumerate(leg):
        ok = torch.arange(LABEL_K, device=dev)[None, :] < e.count[:, None]
        a = torch.sort(torch.where(ok, e.ids, big), dim=1).values
        b = torch.sort(torch.where(ok, ids_s[s], big), dim=1).values
        check(torch.equal(a, b), f"legacy aligned step, static snapshot "
              f"{s}: event IDs differ from the sorted engine's")
    log(f"  static, legacy aligned step (K17, native=False), {n_chk} "
        f"snapshots: the same {int(cnt_l.sum())} events and ID sets a row; "
        f"launches {diff(launches, c_static)}")

    # the unfused route: the same events on the first snapshots
    check(torch.equal(cnt_u, cnt[:n_chk]), "unfused route: counts differ")
    sel = (torch.arange(LABEL_K, device=dev)[None, None, :]
           < cnt_u[..., None])
    check(torch.equal(ids_u[sel], ids[:n_chk][sel]),
          "unfused route: event IDs differ")
    ulps, dif = f16_ulps(ang_u[sel].cpu().numpy(),
                         ang[:n_chk][sel].cpu().numpy())
    check(np.all((ulps <= 1) | (dif <= ANGLE_ATOL)),
          f"unfused route: angles differ by {dif.max(initial=0):.3g} rad")
    log(f"  unfused route (K15 + K19), {n_chk} snapshots: the same "
        f"{int(cnt_u.sum())} events; {int((ulps > 1).sum())} angles beyond "
        f"one f16 ulp (torch acos vs Cephes; max |diff| "
        f"{dif.max(initial=0):.3g} rad)")

    # the general engine on the card, given the sorted run's bulk
    # velocities, on the load-order snapshots
    step = tss.make_sorted_orbit_step(LABEL_K, fused=True, **kw)
    gstep = tapsis.make_orbit_step(box_size=LABEL_BOX, event_capacity=LABEL_K)
    carry = tss.init_sorted_carry(h, p, device=dev)
    gcarry = tapsis.init_carry(h, p, device=dev)
    l_ids, l_pos, l_vel, l_cen = seq["load_order"]
    beyond = compared = 0
    worst = 0.0
    for s in range(n_chk):
        carry, ev = step(carry, _batch(churn, s))
        check(torch.equal(ev.count, cnt[s]) and torch.equal(ev.ids, ids[s]),
              f"snapshot {s}: the sorted step differs from the scan")
        gcarry, gev = gstep(gcarry, tapsis.SnapshotBatch(
            ids=l_ids[s], pos=l_pos[s], vel=l_vel[s], center=l_cen[s],
            bulk_vel=ev.bulk_vel))
        check(torch.equal(gev.ev_count, ev.count),
              f"snapshot {s}: counts differ from the general engine")
        ok = (torch.arange(LABEL_K, device=dev)[None, :]
              < ev.count[:, None])
        check(torch.equal(gev.ev_ids[ok], ev.ids[ok]),
              f"snapshot {s}: event IDs differ from the general engine")
        ulps, dif = f16_ulps(gev.ev_angles[ok].cpu().numpy(),
                             ev.angles[ok].cpu().numpy())
        check(np.all((ulps <= 1) | (dif <= ANGLE_ATOL)),
              f"snapshot {s}: angles differ from the general engine by "
              f"{dif.max(initial=0):.3g} rad")
        beyond += int((ulps > 1).sum())
        compared += int(ok.sum())
        worst = max(worst, float(dif.max(initial=0)))
    log(f"  general engine on the card, {n_chk} snapshots with the sorted "
        f"run's bulk velocities: counts and event IDs (in reference order) "
        f"equal, {compared} events; {beyond} angles beyond one f16 ulp "
        f"(max |diff| {worst:.3g} rad)")

    step = tss.make_sorted_orbit_step(
        LABEL_K, box_size=LABEL_BOX, fused=True, cur_presorted=True,
        soa_batch=True)

    def init(d):
        return tss.init_sorted_carry(h, p, device=d)

    time_scan(dev, churn, s_n, seq["n_valid"], "sorted step, churn (K16)",
              step, init)
    time_scan(dev, static, n_chk, seq["n_static"],
              "sorted step, static (K18 after the first step)", step, init)
    return launches


def sorted_end_to_end(dev, ctx):
    """Phase 9: track_orbits(join_impl='sorted') on config 2 (counted)
    against phase 5's general-engine catalogs and the oracle.  Returns
    the kernel launches."""
    import torch

    from orbitanalysis_tpu_torch import track_orbits
    from orbitanalysis_tpu_torch.engine.io_hdf5 import MemoryWriter
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.utils.metrics import Metrics

    m, w = Metrics(), MemoryWriter()
    # ---- the main path, counted
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    track_orbits(ctx["snap_nums"], ctx["branches"], ctx["regions"],
                 ctx["load"], "sorted.h5", verbose=False, join_impl="sorted",
                 metrics=m, writer=w, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    # ---- end of the counted main path
    joins = {r["join"] for r in m.records}
    steps = len(m.records) + 1
    k16, k18 = launches["fused_join_detect"], launches["compact_events_rows"]
    log(f"  engine {sorted(joins)}, capacity {m.records[0]['capacity']}, "
        f"{steps} steps: fused_join_detect {k16}, compact_events_rows {k18}")
    check(joins == {"sorted"}, f"join_impl='sorted' ran {joins}")
    check(k16 + k18 == steps and k16 >= 1,
          "K16 + K18 launches != sorted steps")
    catalogs_equal(w.files["sorted.h5"], ctx["general"])
    log("  sorted and general catalogs equal (angles within 4e-3, bulk "
        "velocities rtol 2e-6)")
    compared, ambiguous = oracle_check(ctx["snaps"], w.files["sorted.h5"],
                                       ctx["hubble_drag"], ctx["box"],
                                       ORACLE_HALOS)
    log(f"  oracle: first {ORACLE_HALOS} halos, {compared} events compared, "
        f"{ambiguous} sign-ambiguous particles left out")
    n_events = sum(r["n_events"] for r in m.records)
    log(f"  end to end (sorted, incl. host pipeline): wall {wall:.3f} s, "
        f"{ctx['members'] / wall:.4g} particle-snapshot updates/s, "
        f"{n_events} events (phase 5 in this call: aligned "
        f"{ctx['wall_aligned']:.3f} s, general {ctx['wall_general']:.3f} s)")
    return launches


def aligned_full_width(dev, seq):
    """Phase 10: the aligned engine over the benchmark's churn sequence in
    the stable layout (counted): the default step, detect_impl='pallas'
    and the legacy step must give the same events, the JAX benchmark's
    total, and the two native steps the same carries; then timings.
    Returns the kernel launches of the counted runs."""
    import torch

    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.ops import sorted_step as tss

    h, p = LABEL[0], LABEL[1]
    stack = seq["aligned"]
    s_n = stack.ids.shape[0]
    kw = dict(box_size=LABEL_BOX, soa_batch=True)
    steps = dict(
        xla=(tss.make_aligned_native_step(LABEL_K, **kw),
             lambda d: tss.init_aligned_carry(h, p, device=d)),
        pallas=(tss.make_aligned_native_step(LABEL_K, detect_impl="pallas",
                                             **kw),
                lambda d: tss.init_aligned_carry(h, p, device=d)),
        legacy=(tss.make_aligned_orbit_step(LABEL_K, **kw),
                lambda d: tss.init_sorted_carry(h, p, device=d)))

    # ---- the main path, counted
    _cuda.reset_launch_counts()
    events, carries, counts = {}, {}, {}
    for name, (step, init) in steps.items():
        before = _cuda.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, evs = init(dev), []
        for s in range(s_n):
            carry, ev = step(carry, _batch(stack, s))
            evs.append(ev)
        torch.cuda.synchronize()
        events[name], carries[name] = evs, carry
        counts[name] = launch_diff(_cuda.launch_counts(), before)
        log(f"  {name}: {sum(int(e.count.sum()) for e in evs)} events over "
            f"{s_n} snapshots of [{h}, {p}]; launches {counts[name]}; scan "
            f"{time.perf_counter() - t0:.3f} s incl. warm-up")
    launches = _cuda.launch_counts()
    # ---- end of the counted main path

    check(counts["xla"] == {"compact_angle_rows": s_n},
          "the default step did not launch the compaction once a step")
    for name in ("pallas", "legacy"):
        check(counts[name] == {"static_detect_rows": s_n},
              f"{name}: K17 did not launch once a step (and nothing else)")
    total = sum(int(e.count.sum()) for e in events["xla"])
    check(total == LABEL_EVENTS,
          f"the aligned engine found {total} events, not {LABEL_EVENTS}")
    beyond, worst, exact = 0, 0.0, True
    kio = torch.arange(LABEL_K, device=dev)[None, :]
    for s in range(s_n):
        x = events["xla"][s]
        ok = kio < x.count[:, None]
        pos_ids = torch.gather(stack.ids[s], 1,
                               torch.where(ok, x.ids, 0).long())
        for name in ("pallas", "legacy"):
            e = events[name][s]
            check(torch.equal(e.count, x.count),
                  f"{name}, snapshot {s}: counts differ from 'xla'")
            want = pos_ids if name == "legacy" else x.ids
            check(torch.equal(e.ids[ok], want[ok]),
                  f"{name}, snapshot {s}: event "
                  f"{'IDs' if name == 'legacy' else 'positions'} differ")
            ulps, dif = f16_ulps(e.angles[ok].cpu().numpy(),
                                 x.angles[ok].cpu().numpy())
            check(np.all(ulps <= 1), f"{name}, snapshot {s}: angles differ "
                  f"by {int(ulps.max(initial=0))} f16 ulps")
            beyond += int((ulps > 0).sum())
            worst = max(worst, float(dif.max(initial=0)))
        p_ev, l_ev = events["pallas"][s], events["legacy"][s]
        exact &= bool(torch.equal(p_ev.angles[ok], l_ev.angles[ok])
                      and torch.equal(p_ev.slots[ok], l_ev.slots[ok]))
    check(exact, "'pallas' and legacy events differ in f32 angles or slots")
    for a, b in zip(carries["xla"], carries["pallas"]):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32)),
              "the 'xla' and 'pallas' carries differ")
    log(f"  the three steps give the same {total} events (the JAX "
        f"benchmark's total: {LABEL_EVENTS}); 'pallas' and legacy f32 "
        f"angles and prev slots bit-equal; {beyond} f32 angles not on the "
        f"'xla' step's f16 value (max |diff| {worst:.3g} rad, within one "
        "f16 ulp); final 'xla' and 'pallas' carries bit-equal")

    for name, what in (("xla", "aligned step, 'xla' (torch chain + K1)"),
                       ("pallas", "aligned step, 'pallas' (K17)"),
                       ("legacy", "legacy aligned step (K17)")):
        time_scan(dev, stack, s_n, seq["n_valid"], what, *steps[name])
    return launches


# ------------------------------------------- native integrator phases

#: Config 4 (BASELINE.md:17, benchmarks/config4_onthefly_e2e.py): the
#: oracle ensemble and its snapshot and detection cadences; halo rows of
#: the PM runs; box and time step; the 12.6M run (rows, grid, steps,
#: detect_every); the never-run 33.5M anchor (rows, grid, steps, chunk);
#: the CUDA-vs-CPU parity size (rows, grid)
C4_ORACLE = 16384
C4_SNAPSHOT_EVERY, C4_DETECT_EVERY = 32, 8
C4_ROW = 65536
C4_BOX, C4_DT = 100.0, 1e-3
C4_SCALE = (192, 256, 32, 8)
C4_ANCHOR = (512, 512, 16, 4)
C4_PARITY = (16, 128)
#: direct summation through K14: rows x row width (all tracked), steps,
#: detect_every, softening, time step; K14's check size (the JAX
#: benchmark's, benchmarks/run_all.py:79); the P3M check (particles, grid)
DIRECT = (32, 4096, 16, 4, 0.05, 0.01)
K14_N = 16384
P3M_CHECK = (1 << 18, 64)
#: float32 instructions a pair of K14 at a softening of 1e-9 or more, an
#: FMA counted once (csrc/nbody.cu: free space, periodic), issued at 128
#: lanes a clock per SM, and its one reciprocal root on the
#: special-function unit at 16 a clock per SM
K14_INSTR = {False: 12, True: 21}
FP32_LANES, SFU_LANES = 128, 16


def sm_clock_hz():
    """The card's maximum SM clock, in Hz (``nvidia-smi
    --query-gpu=clocks.max.sm``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout
    return float(out.split()[0]) * 1e6


def k14_bound(n, periodic, dev):
    """K14's ``(bound_ms, bound_by, which binds)`` for ``n`` particles: the
    larger of the float32 pipe's time (K14_INSTR a pair at FP32_LANES a
    clock per SM), the SFU's (one rsqrtf a pair at SFU_LANES) and the
    bytes' (16 read and 12 written a particle)."""
    import torch

    rate = torch.cuda.get_device_properties(dev).multi_processor_count \
        * sm_clock_hz()
    pairs = float(n) * n
    t = {"float32 pipe": K14_INSTR[periodic] * pairs / (FP32_LANES * rate),
         "SFU rsqrt": pairs / (SFU_LANES * rate),
         "bytes": 28.0 * n / PEAK_BYTES}
    what = max(t, key=t.get)
    return (t[what] * 1e3, "bytes" if what == "bytes" else "operations",
            f"the {what} binds; "
            + ", ".join(f"{k} {v * 1e3:.4f} ms" for k, v in t.items()))


def c4_state(n, dev, seed=3):
    """Config 4's scale state (benchmarks/config4_onthefly_e2e.py:200):
    uniform positions in the box, velocities 0.02 N(0, 1), unit masses;
    drawn with NumPy from ``seed``."""
    from orbitanalysis_tpu_torch.models.nbody import nbody_state_from_numpy

    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, C4_BOX, size=(n, 3)).astype(np.float32)
    vel = (0.02 * rng.normal(size=(n, 3))).astype(np.float32)
    return nbody_state_from_numpy(pos, vel, np.ones(n, np.float32),
                                  device=dev)


def force_rel(a1, a2):
    """The JAX test's force measure, max |a1 - a2| / (|a2| + 1e-3)."""
    a1, a2 = a1.double(), a2.double()
    return float(((a1 - a2).abs()
                  / (a2.norm(dim=1, keepdim=True) + 1e-3)).max())


def _k13_check(dev, n, grid, results):
    """K13 on the sorted stream of the first force evaluation of config
    4's ``n``-particle run on ``grid``^3: bit-equal to its plain version,
    mass kept, ``index_add_`` close; returns the timings."""
    import torch

    from orbitanalysis_tpu_torch.ops import deposit as td

    st = c4_state(n, dev)
    keys, fracs = td.sorted_stream(st.pos, st.mass, grid, C4_BOX)
    del st
    v = (grid + 1) ** 3
    got = td.deposit_stream(keys, fracs, grid)
    again = td.deposit_stream(keys, fracs, grid)
    want = td.deposit_stream_torch(keys, fracs, grid)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    total = float(td.fold_virtual(got, grid).double().sum())
    check(torch.equal(got, want), f"deposit_sorted differs from its twin "
          f"at {n} / {grid + 1}^3")
    check(torch.equal(got, again), "deposit_sorted is not deterministic")
    check(abs(total - n) <= 1e-6 * n,
          f"deposit_sorted: mass {total} of {n}")
    del want, again
    offs = torch.tensor(td._offsets(grid), device=dev)
    idx8 = (keys.long()[None, :] + offs[:, None]).reshape(-1)
    w8 = td._corner_weights8(fracs).reshape(-1)

    def library():
        return torch.zeros(v, device=dev).index_add_(0, idx8, w8)

    lib_err = float((library() - got).abs().max())
    check(lib_err <= 2e-5 * float(got.abs().max()),
          f"deposit_sorted: index_add_ differs by {lib_err}")
    # the function reads keys (4 B) and fracs (16 B) an entry and writes
    # the virtual grid once
    b_ms, b_by = bound(20 * n + 4 * v, 0)
    big = n > C4_SCALE[0] * C4_ROW
    r = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: td.deposit_stream(keys, fracs, grid)),
        plain_ms=cuda_ms(lambda: td.deposit_stream_torch(keys, fracs, grid),
                         runs=3 if big else 5, reps=2 if big else 10,
                         warmup=1 if big else 3),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(library))
    log(f"  deposit_sorted {n} entries onto {grid + 1}^3: bit-equal to its "
        f"twin, twice the same bits; mass {total:.1f} of {n}; index_add_ "
        f"within {lib_err:.3g}; kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f}, index_add_ {r['library_ms']:.4f}, bound "
        f"{b_ms:.4f} ({b_by})")
    results[n, grid] = r
    return r


def _k14_check(dev, n, box, results):
    """K14 at ``n`` particles (free, or periodic in ``box``) against its
    plain version and, where its pair matrix fits, the Gram or dense
    ``direct_forces``; returns the timings."""
    import torch

    from orbitanalysis_tpu_torch.models import nbody as tnb
    from orbitanalysis_tpu_torch.ops import nbody as tn

    rng = np.random.default_rng(0)
    if box is None:
        pos = rng.normal(size=(n, 3)).astype(np.float32)
    else:
        pos = rng.uniform(0, box, (n, 3)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    p = torch.from_numpy(pos).to(dev)
    m = torch.from_numpy(mass).to(dev)
    got = tn.direct_forces_blocked(p, m, softening=0.1, box_size=box)
    again = tn.direct_forces_blocked(p, m, softening=0.1, box_size=box)
    twin = tn.direct_forces_blocked_torch(p, m, 0.1, 1.0, box)
    torch.cuda.synchronize()
    r_twin = force_rel(got, twin)
    what = "free" if box is None else f"periodic box {box}"
    check(torch.equal(got, again), f"direct_forces ({what}) is not "
          "deterministic")
    check(r_twin < 1e-3, f"direct_forces ({what}) disagrees with its twin")
    line = f"  direct_forces N={n} {what}: against its twin {r_twin:.3g}"
    if n <= K14_N:
        r_dense = force_rel(got, tnb.direct_forces(p, m, softening=0.1,
                                                   box_size=box))
        check(r_dense < 1e-3, f"direct_forces ({what}) disagrees with the "
              "dense form")
        line += (f", against the {'Gram' if box is None else 'dense'} "
                 f"direct_forces {r_dense:.3g}")
    big = n > K14_N
    b_ms, b_by, parts = k14_bound(n, box is not None, dev)
    r = dict(
        max_abs_err=float((got - twin).abs().max()),
        ms=cuda_ms(lambda: tn.direct_forces_blocked(p, m, 0.1, box_size=box),
                   runs=3 if big else 5, reps=2 if big else 10),
        plain_ms=cuda_ms(
            lambda: tn.direct_forces_blocked_torch(p, m, 0.1, 1.0, box),
            runs=3 if big else 5, reps=1 if big else 10,
            warmup=1 if big else 3),
        bound_ms=b_ms, bound_by=b_by,
        # no single PyTorch call sums softened pair forces
        library_ms=None)
    log(f"{line} (max |a1-a2|/(|a2|+1e-3) < 1e-3); twice the same bits; "
        f"kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, bound "
        f"{b_ms:.4f} ms ({parts}); {n * n / r['ms'] * 1e3:.4g} pairs/s")
    results[n, box] = r
    return r


def force_kernel_checks(dev):
    """Phase 3 for K13 (the sorted streams of the first force evaluations
    of the 12.6M / 256^3 and 33.5M / 512^3 runs) and K14 (N = 16384 and
    131072, free and periodic).  Returns the timings at the kernels' main
    shapes (12.6M / 257^3; N = 16384 free) and logs every shape's."""
    import torch

    k13, k14 = {}, {}
    results = {"deposit_sorted": _k13_check(
        dev, C4_SCALE[0] * C4_ROW, C4_SCALE[1], k13)}
    _k13_check(dev, C4_ANCHOR[0] * C4_ROW, C4_ANCHOR[1], k13)
    torch.cuda.empty_cache()
    log(f"  matmul: allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
        f"float32 precision '{torch.get_float32_matmul_precision()}' (the "
        "Gram form needs full float32; cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} is not used)")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "float32 matmuls are not full float32")
    results["direct_forces"] = _k14_check(dev, K14_N, None, k14)
    for n, box in ((K14_N, 10.0), (8 * K14_N, None), (8 * K14_N, 10.0)):
        _k14_check(dev, n, box, k14)
    for (n, grid), r in k13.items():
        log(f"  K13 at {n} / {grid + 1}^3: {json.dumps(r)}")
    for (n, box), r in k14.items():
        log(f"  K14 at N={n} {'free' if box is None else 'periodic'}: "
            f"{json.dumps(r)}")
    return results


def mean_anomaly_from_state(pos, vel, GM=1.0):
    """Each particle's mean anomaly from (pos, vel) about a point mass at
    the origin (benchmarks/config4_onthefly_e2e.py:54)."""
    r = np.linalg.norm(pos, axis=-1)
    v2 = np.sum(vel * vel, axis=-1)
    a = -GM / (2.0 * (0.5 * v2 - GM / r))
    h = np.linalg.norm(np.cross(pos, vel), axis=-1)
    e = np.sqrt(np.clip(1.0 - h * h / (GM * a), 0.0, None))
    cos_e = np.clip((1.0 - r / a) / np.maximum(e, 1e-12), -1.0, 1.0)
    ecc = np.arccos(cos_e)
    ecc = np.where(np.sum(pos * vel, axis=-1) >= 0, ecc, 2 * np.pi - ecc)
    return np.mod(ecc - e * np.sin(ecc), 2 * np.pi)


def c4_oracle(dev):
    """Phase 11: the config-4 oracle (config4_onthefly_e2e.py:80-182) on
    the card and on the CPU.  Returns the (zero) kernel launches."""
    import torch

    from orbitanalysis_tpu_torch.models import nbody as tnb
    from orbitanalysis_tpu_torch.models.synthetic import kepler_ensemble
    from orbitanalysis_tpu_torch.ops import _cuda

    n = C4_ORACLE
    ens = kepler_ensemble(n, 2, a_range=(0.5, 2.0), e_range=(0.05, 0.6),
                          seed=7)
    t_min, t_max = float(ens.period.min()), float(ens.period.max())
    dt = t_min / (1.3 * C4_SNAPSHOT_EVERY)
    n_steps = int(np.ceil(3.0 * t_max / dt))
    t_total = n_steps * dt
    pos = ens.positions[0].astype(np.float32)
    vel = ens.velocities[0].astype(np.float32)
    m0 = mean_anomaly_from_state(ens.positions[0], ens.velocities[0])
    expected = (np.floor((m0 + 2 * np.pi / ens.period * t_total)
                         / (2 * np.pi)).astype(np.int64)
                - np.floor(m0 / (2 * np.pi)).astype(np.int64))
    members = np.arange(n, dtype=np.int32).reshape(1, n)
    log(f"  Kepler ensemble: {n} particles, periods {t_min:.2f}-"
        f"{t_max:.2f}, {n_steps} KDK steps over {t_total:.1f} time units")
    res = {}
    launches = {}
    for d in (dev, "cpu"):
        zero = torch.zeros((1, 3), device=d)
        st = tnb.nbody_state_from_numpy(pos, vel, np.full(n, 1e-12,
                                                          np.float32),
                                        device=d)
        for every in (C4_DETECT_EVERY, C4_SNAPSHOT_EVERY):
            cfg = tnb.OrbitNBodyConfig(
                dt=dt, n_steps=n_steps, detect_every=every,
                mode="pericentric", softening=0.0, centers=zero,
                bulk_vels=zero)
            # ---- the main path, counted (point-mass forces: no kernel)
            if d == dev:
                _cuda.reset_launch_counts()
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, tr, ev = tnb.simulate_with_tracking(
                st, members, cfg, tnb.point_mass_forces(GM=1.0))
            counts = tr.counts[0].cpu().numpy().astype(np.int64)
            wall = time.perf_counter() - t0
            if d == dev:
                for k, c in _cuda.launch_counts().items():
                    launches[k] = launches.get(k, 0) + c
            # ---- end of the counted main path
            err = counts - expected
            within1 = float(np.mean(np.abs(err) <= 1))
            missed = float(np.mean(np.maximum(expected - counts, 0))
                           / max(np.mean(expected), 1e-9))
            res[str(d), every] = (counts, within1, missed)
            log(f"  {d}, detect_every={every}: {int(ev.sum())} passages, "
                f"exact {float(np.mean(err == 0)):.4f}, within +-1 "
                f"{within1:.4f}, missed {missed:.3%}; {wall:.2f} s wall "
                f"({n_steps / wall:.1f} steps/s)")
    g = str(dev)
    check(res[g, C4_DETECT_EVERY][1] >= 0.99,
          f"4x cadence: only {res[g, C4_DETECT_EVERY][1]:.4f} within +-1")
    check(res[g, C4_SNAPSHOT_EVERY][2] > res[g, C4_DETECT_EVERY][2],
          "snapshot-rate detection does not miss more than 4x cadence")
    for every in (C4_DETECT_EVERY, C4_SNAPSHOT_EVERY):
        diff = res[g, every][0] - res["cpu", every][0]
        n_diff = int((diff != 0).sum())
        log(f"  CUDA vs CPU, detect_every={every}: {n_diff} of {n} "
            f"particles' counts differ (max |diff| "
            f"{int(np.abs(diff).max())}; torch.rsqrt on the card is not "
            "the CPU's, so trajectories drift apart over "
            f"{n_steps} steps)")
        check(np.abs(diff).max() <= 1 and n_diff <= n // 1000,
              f"CUDA and CPU counts differ on {n_diff} particles")
    return launches


def _timed_run(dev, st, members, cfg, force, chunk=None):
    """``simulate_with_tracking`` (in ``chunk``-step pieces through
    ``track``/``step_offset`` when given), synchronized; returns
    ``(state, track, events, wall s)``."""
    import torch

    from orbitanalysis_tpu_torch.models.nbody import simulate_with_tracking

    chunk = chunk or cfg.n_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr = None
    evs = []
    for c in range(cfg.n_steps // chunk):
        st, tr, ev = simulate_with_tracking(
            st, members, cfg._replace(n_steps=chunk), force, track=tr,
            step_offset=c * chunk)
        evs.append(ev)
    torch.cuda.synchronize()
    return st, tr, torch.cat(evs), time.perf_counter() - t0


def c4_scale(dev):
    """Phase 12: config-4 scale with PM forces and K13 (12.6M / 256^3,
    then the 33.5M / 512^3 anchor in chunks), and CUDA-vs-CPU parity at
    1M / 128^3.  Returns the kernel launches of the counted runs."""
    import torch

    from orbitanalysis_tpu_torch.models import nbody as tnb
    from orbitanalysis_tpu_torch.models.pm import make_pm_force_fn
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.ops import deposit as td

    rows, grid, steps, every = C4_SCALE
    n = rows * C4_ROW
    st = c4_state(n, dev)
    members = np.arange(n, dtype=np.int32).reshape(rows, C4_ROW)
    force = make_pm_force_fn(grid)
    base = dict(dt=C4_DT, mode="pericentric", box_size=C4_BOX,
                softening=0.0, G=1.0)
    # warm-up: cuFFT plans and the allocator, one step
    _timed_run(dev, st, members, tnb.OrbitNBodyConfig(
        n_steps=1, detect_every=2, **base), force)
    totals = {}
    for label, det in (("integrator only", steps + 1), (
            f"tracked, detect_every={every}", every)):
        cfg = tnb.OrbitNBodyConfig(n_steps=steps, detect_every=det, **base)
        # ---- the main path, counted
        _cuda.reset_launch_counts()
        _, tr, ev, wall = _timed_run(dev, st, members, cfg, force)
        counts = _cuda.launch_counts()
        # ---- end of the counted main path
        for k, c in counts.items():
            totals[k] = totals.get(k, 0) + c
        k13 = counts["deposit_sorted"]
        log(f"  {n} particles, {grid}^3, {steps} steps, {label}: "
            f"{wall:.3f} s, {steps / wall:.3f} steps/s, "
            f"{n * steps / wall:.4g} particle-steps/s; {int(ev.sum())} "
            f"events; deposit_sorted {k13} launches")
        check(k13 == steps + 1, f"K13 launched {k13} times, not {steps + 1}")
        check(bool(torch.isfinite(tr.angles).all()), "non-finite angles")
        check(set(launch_diff(counts)) == {"deposit_sorted"},
              f"unexpected kernels {launch_diff(counts)}")
    # where a tracked PM step's device time goes (8 steps, 9 force
    # evaluations with the opening one)
    cfg = tnb.OrbitNBodyConfig(n_steps=8, detect_every=every, **base)
    wall = _timed_run(dev, st, members, cfg, force)[3]
    profile_scan(lambda: _timed_run(dev, st, members, cfg, force), 8,
                 wall * 1e3)
    tr0 = tnb.init_track_state(rows, C4_ROW, device=dev)
    members_dev = torch.from_numpy(members).to(dev)
    for ident, label in ((True, "identity"), (False, "gather")):
        ms = device_ms(lambda i=ident: tnb.detect_apsides_static(
            tr0, st, members_dev, box_size=C4_BOX, identity=i), reps=4) / 4
        log(f"  one detection, {label} path: {ms:.3f} ms ({n / ms / 1e6:.4g}"
            "e9 detection updates/s)")
    del st, tr0, members, members_dev, tr, ev
    torch.cuda.empty_cache()

    # the anchor the TPU never ran: 33.5M particles on 512^3, in chunks
    rows, grid, steps, chunk = C4_ANCHOR
    n = rows * C4_ROW
    st = c4_state(n, dev)
    members = np.arange(n, dtype=np.int32).reshape(rows, C4_ROW)
    force = make_pm_force_fn(grid)
    force(st.pos, st.mass, box_size=C4_BOX)          # warm-up: cuFFT plans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = tnb.OrbitNBodyConfig(n_steps=steps, detect_every=C4_DETECT_EVERY,
                               **base)
    # ---- the main path, counted
    _cuda.reset_launch_counts()
    _, tr, ev, wall = _timed_run(dev, st, members, cfg, force, chunk=chunk)
    counts = _cuda.launch_counts()
    # ---- end of the counted main path
    for k, c in counts.items():
        totals[k] = totals.get(k, 0) + c
    peak = torch.cuda.max_memory_allocated()
    k13 = counts["deposit_sorted"]
    log(f"  {n} particles, {grid}^3, {steps} steps in {chunk}-step chunks, "
        f"detect_every={C4_DETECT_EVERY}: {wall:.3f} s, {wall / steps:.4f} "
        f"s/step, {n * steps / wall:.4g} particle-steps/s, {int(ev.sum())} "
        f"events; peak memory {peak / 2**30:.2f} GiB; deposit_sorted {k13} "
        "launches")
    check(k13 == (steps // chunk) * (chunk + 1),
          f"K13 launched {k13} times at 512^3")
    check(bool(torch.isfinite(tr.angles).all()), "non-finite angles at 512^3")
    del st, tr, ev, members
    torch.cuda.empty_cache()

    # CUDA vs CPU at 1M / 128^3: one PM force evaluation, the deposit,
    # and the detector on identical states
    rows, grid = C4_PARITY
    n = rows * C4_ROW
    st = {d: c4_state(n, d, seed=11) for d in (dev, "cpu")}
    force = make_pm_force_fn(grid)
    rho = {d: td.cic_deposit_sorted(s.pos, s.mass, grid, C4_BOX)
           for d, s in st.items()}
    check(torch.equal(rho[dev].cpu(), rho["cpu"]),
          "the sorted deposit differs between CUDA and CPU")
    acc = {d: force(s.pos, s.mass, box_size=C4_BOX) for d, s in st.items()}
    scale = float(acc["cpu"].abs().max())
    err = float((acc[dev].cpu() - acc["cpu"]).abs().max())
    log(f"  {n} particles, {grid}^3, CUDA vs CPU: sorted deposit "
        f"bit-equal; PM force max |diff| {err:.3g} = {err / scale:.3g} of "
        "the largest (cuFFT against pocketfft, K13 against index_add_; "
        "limit 1e-4)")
    check(err <= 1e-4 * scale, "PM forces differ between CUDA and CPU")
    later = tnb.kdk_step(st[dev], acc[dev], 0.5, force, box_size=C4_BOX)[0]
    later = {dev: later, "cpu": tnb.NBodyState(*(t.cpu() for t in later))}
    members = np.arange(n, dtype=np.int32).reshape(rows, C4_ROW)
    for ident in (True, False):
        out = {}
        for d in (dev, "cpu"):
            tr = tnb.init_track_state(rows, C4_ROW, device=d)
            tr, _ = tnb.detect_apsides_static(tr, st[d], members,
                                              box_size=C4_BOX, identity=ident)
            out[d] = tnb.detect_apsides_static(tr, later[d], members,
                                               box_size=C4_BOX,
                                               identity=ident)
        (tg, (ag, *_)), (tc, (ac, *_)) = out[dev], out["cpu"]
        dang = float((tg.angles.cpu() - tc.angles).abs().max())
        log(f"  detector on identical states ({'identity' if ident else 'gather'}"
            f"): {int(ac.sum())} apsides, flags, counts and r-hat "
            f"{'bit-equal' if torch.equal(tg.rhat.cpu(), tc.rhat) else 'DIFFER'}"
            f"; angles within {dang:.3g} rad (torch.acos; limit 1e-5)")
        check(torch.equal(ag.cpu(), ac) and torch.equal(tg.counts.cpu(),
                                                        tc.counts),
              "the detector differs between CUDA and CPU")
        check(torch.equal(tg.rhat.cpu(), tc.rhat) and dang <= 1e-5,
              "detector r-hat or angles differ between CUDA and CPU")
    return totals


def direct_phase(dev):
    """Phase 13: direct summation with K14 at N = 131072 (the Gram form
    would need a 68.7 GB pair matrix), against the same run with the
    plain blocked version on the card; then one P3M force evaluation.
    Returns the kernel launches of the counted run."""
    import torch

    from orbitanalysis_tpu_torch.models import nbody as tnb
    from orbitanalysis_tpu_torch.models.p3m import make_p3m_force_fn
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.ops import nbody as tn

    rows, width, steps, every, soft, dt = DIRECT
    n = rows * width
    rng = np.random.default_rng(21)
    st = tnb.nbody_state_from_numpy(
        rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(scale=0.3, size=(n, 3)).astype(np.float32),
        np.full(n, 1.0 / n, np.float32), device=dev)
    members = np.arange(n, dtype=np.int32).reshape(rows, width)
    cfg = tnb.OrbitNBodyConfig(dt=dt, n_steps=steps, detect_every=every,
                               softening=soft)
    kernel = tnb.make_direct_force_fn(use_pallas=True)

    def twin(pos, mass, softening=0.05, G=1.0, box_size=None, **_):
        return tn.direct_forces_blocked_torch(pos, mass, softening, G,
                                              box_size)

    kernel(st.pos, st.mass, softening=soft)            # warm-up
    # ---- the main path, counted
    _cuda.reset_launch_counts()
    _, tr_k, ev_k, wall = _timed_run(dev, st, members, cfg, kernel)
    launches = _cuda.launch_counts()
    # ---- end of the counted main path
    k14 = launches["direct_forces"]
    pairs = (steps + 1) * n * n
    one = device_ms(lambda: kernel(st.pos, st.mass, softening=soft), 3) / 3
    log(f"  {n} particles ({rows} x {width}, identity), {steps} steps, "
        f"detect_every={every}: {wall:.3f} s, {pairs / wall:.4g} pairs/s "
        f"over the run; one force evaluation {one:.3f} ms = "
        f"{n * n / one * 1e3:.4g} pairs/s; direct_forces {k14} launches")
    check(k14 == steps + 1, f"K14 launched {k14} times, not {steps + 1}")
    _, tr_t, ev_t, wall_t = _timed_run(dev, st, members, cfg, twin)
    diff = (tr_k.counts - tr_t.counts).abs()
    n_diff = int((diff != 0).sum())
    det = ev_k[every - 1::every].tolist()
    log(f"  the plain blocked version on the card: {wall_t:.3f} s; events "
        f"a detection {det} against {ev_t[every - 1::every].tolist()}; "
        f"{n_diff} particles' counts differ (limit {n // 10000}: sums in "
        "other orders move knife-edge sign flips)")
    check(int(diff.max()) <= 1 and n_diff <= n // 10000,
          f"K14 and its twin disagree on {n_diff} particles' counts")
    check(sum(det) > 0, "no apsides in the direct-summation run")
    del st, tr_k, tr_t
    torch.cuda.empty_cache()

    n, grid = P3M_CHECK
    rng = np.random.default_rng(31)
    pos = torch.from_numpy(rng.uniform(0, C4_BOX, (n, 3)).astype(
        np.float32)).to(dev)
    mass = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(
        np.float32)).to(dev)
    p3m = make_p3m_force_fn(grid)
    p3m(pos, mass, box_size=C4_BOX, softening=0.05)     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = p3m(pos, mass, box_size=C4_BOX, softening=0.05)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ma = mass[:, None].double() * acc.double()
    net = ma.sum(0).abs()
    scale = ma.abs().sum(0)
    log(f"  P3M, {n} particles on {grid}^3: {wall:.3f} s; finite "
        f"{bool(torch.isfinite(acc).all())}; net force / sum |m a| = "
        f"{(net / scale).max().item():.3g} (limit 1e-3)")
    check(bool(torch.isfinite(acc).all()), "P3M forces not finite")
    check(bool((net < 1e-3 * scale).all()), "P3M net force not near zero")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from orbitanalysis_tpu_torch import native
    from orbitanalysis_tpu_torch.ops import _cuda

    dev = torch.device(DEVICE)
    log("== phase 1: environment")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, numpy {np.__version__}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"  {smi}")
    log("== phase 2: build")
    t0 = time.perf_counter()
    nvcc_s = _cuda.build()
    log(f"  nvcc {', '.join(os.path.basename(f) for f in _cuda.sources())} "
        f"-> {os.path.basename(_cuda.library_path())}: {nvcc_s:.2f} s "
        f"({time.perf_counter() - t0:.2f} s with the check)")
    for src, out in sorted(_cuda.build_log.items()):
        for line in out.splitlines():
            if "Function properties" in line or "Used" in line or (
                    "spill" in line and " 0 bytes spill" not in line):
                log(f"  ptxas {src}: {line.strip()}")
    t0 = time.perf_counter()
    tier = native.tier()
    log(f"  host packing tier: {tier} ({time.perf_counter() - t0:.2f} s)")
    work, seq = bench_workloads(dev)
    log("== phase 3: kernels against their plain-torch versions")
    timings = kernel_checks(dev)
    timings.update(label_kernel_checks(dev, work))
    timings.update(sorted_kernel_checks(dev, seq))
    timings.update(force_kernel_checks(dev))
    log_timings(timings)
    log(f"== phase 4: aligned step parity, CUDA vs CPU, {PARITY[:2]}")
    step_parity(dev)
    log("== phase 5: the aligned main path end to end at config-2 scale")
    launches, ctx = end_to_end(dev)
    log(f"== phase 6: label step parity, CUDA vs CPU, "
        f"[{LABEL_PARITY[0]}, {LABEL_ROW}] x {LABEL_PARITY[1]} snapshots")
    label_parity(dev, work)
    log("== phase 7: the label-native main path at full width")
    label_launches = label_full_width(dev, work)
    del work
    log("== phase 8: the sorted engine at full width (the benchmark's "
        "merge-join and static cells)")
    sorted_launches = sorted_full_width(dev, seq)
    log("== phase 9: track_orbits(join_impl='sorted') at config-2 scale")
    e2e_sorted = sorted_end_to_end(dev, ctx)
    log("== phase 10: the aligned engine on the benchmark's churn sequence "
        "(default step, detect_impl='pallas', legacy step)")
    aligned_launches = aligned_full_width(dev, seq)
    # the earlier phases' workloads go before the 33.5M run
    del seq, ctx
    torch.cuda.empty_cache()
    log("== phase 11: config-4 oracle, Kepler ensemble under point-mass "
        "forces, on the card and on the CPU")
    oracle_launches = c4_oracle(dev)
    log("== phase 12: config-4 scale, PM forces through K13 (12.6M / 256^3, "
        "33.5M / 512^3, CUDA-vs-CPU parity at 1M / 128^3)")
    scale_launches = c4_scale(dev)
    log("== phase 13: direct summation through K14 at N = 131072, and P3M")
    direct_launches = direct_phase(dev)
    kernels = []
    for name, k in _cuda.KERNELS.items():
        n = (launches[name] + label_launches[name] + sorted_launches[name]
             + e2e_sorted[name] + aligned_launches[name]
             + oracle_launches[name] + scale_launches[name]
             + direct_launches[name])
        r = timings[name]
        kernels.append(dict(
            name=name, route=k.route, source=k.source, replaces=k.replaces,
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
        check(n > 0, f"{name} was not launched by a main path")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
