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
   generated on the host, the ID forms staged ID-sorted and, by
   ``stage_batch_aligned(soa=True)`` as the benchmark stages them, the
   static form and phase 3's churn snapshots in the stable layout;
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
   host queue time and update rate for ``'auto'``, ``'fused'`` and
   ``'pallas'``;
8. the sorted engine at full width, the JAX benchmark's merge-join and
   static cells: ``scan_events_sorted(fused=True, cur_presorted=True,
   soa_batch=True)`` over the 48-snapshot churn sequence must find
   exactly the 1,741,643 events, launching the join-and-detect kernel
   once a step; on its first 12 snapshots the events equal the general
   engine's on the card (given the sorted run's bulk velocities) and the
   unfused route's (merge kernel + two-group compaction); the static
   sequence launches the join-and-detect kernel on its first step and
   the event compaction on every later one, and the legacy aligned step
   (the aligned detect kernel once a step) finds the same events;
   ``scan_counts(angle_cut=0)`` over the load-order churn sequence (the
   general step) counts every one of the sorted engine's events; then
   step timings;
9. ``track_orbits(join_impl='sorted')`` at config-2 scale: catalogs
   equal the general engine's run on the card and the oracle, and every
   step launches the join-and-detect kernel or the event compaction;
9b. the rest of the reference workflow on phase 5's data:
   ``track_orbits(mode='both')`` under ``join_impl='auto'`` (the
   pericentric catalog equal to phase 5's, the angle compaction twice a
   snapshot); ``Apsides`` on both catalogs, the collation on the host
   and on the card bit-equal, with the final counts, the first halos'
   counts against the oracle; one halo's ``OrbitDecomposition`` equal to
   its collated counts (no plot: the CPU tests draw them); the central
   particles and the progenitor vote on the last snapshot pair, card
   equal to host and every halo its own progenitor; the on-the-fly
   driver on that pair with one halo unlinked, card against CPU; and
   ``RegionExtractor`` through the native grid index against a
   brute-force radius cut;
10. the aligned engine on the benchmark's churn sequence, staged whole
   in the stable layout (SoA planes) by ``stage_batch_aligned(soa=True)``
   as the benchmark stages it (the host's seconds logged; its first
   snapshots equal the tracker's ``pack_snapshot_aligned``): the drivers
   ``scan_events_aligned`` per step (the default step,
   ``detect_impl='xla'``: the angle compaction once a step) and
   ``batched=True`` (the payload compaction once, over all 3072 rows),
   ``make_aligned_native_step(detect_impl='pallas')`` and the legacy
   ``make_aligned_orbit_step`` (the aligned detect kernel once a step)
   must give the same events, exactly the 1,741,643, the batched
   driver's angles bit-equal to the per-step driver's, and the two
   native steps the same carry bits; the payload compaction against its
   plain version on the batched driver's own [3072, 32768] plane; then
   step and driver timings;
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
   particles on 64^3 (finite, net force near zero, and two calls the
   same bits: its deposit is K13);
14. the distributed engines (``parallel/``, ``track_orbits(mesh=)``):
   (a) an NCCL world of one rank in this process: config 2 through a
   ``{'halos': 1}`` mesh under ``join_impl='auto'`` (the aligned engine,
   the angle compaction once a step) and a ``{'shards': 1}`` mesh, both
   catalogs equal to phase 5's general engine's, and the four
   collectives once each on CUDA tensors through NCCL; (b) a gloo world
   of two spawned ranks sharing the card (NCCL refuses two ranks on one
   GPU), reading the workloads phase 2 wrote: which collectives gloo
   takes natively on CUDA tensors; the halo-sharded sorted step (the
   join-and-detect kernel once a step a rank) and aligned step (the
   angle compaction once a step a rank), the hash-sharded scan with its
   all-to-all router (nothing dropped) and the particle-sharded label
   step (moments, frame rows and detect-and-compact once a snapshot a
   rank) on the benchmark's 48 churn snapshots, each finding exactly
   the 1,741,643 events of phases 7 and 8, equal as sets; config 2
   through ``track_orbits(mesh=)`` on ``{'halos': 2}`` (auto: aligned,
   and sorted) and ``{'shards': 2}`` with ``mode='both'``, rank 0
   writing, catalogs equal to phase 5's; each rank's wall and
   collective bytes a step (two ranks on one card over the host: not a
   multi-GPU node's speed).  The ranks' launches join the counts;
15. the distributed PM (``models/pm_sharded.py``): (a) an NCCL world of
   one at 12,582,912 particles on 256^3 (phase 12's state): the grid
   solve against ``pm_forces_grid`` on the same deposit (1e-4 of max
   |ref|), the psum path (1e-4) and the slab-resident rows and scalar
   paths (2e-4) against ``make_pm_force_fn(256)``, each called twice
   with the same bits (every deposit is K13, in a fixed order); the slab
   block's K13 time against its bound; 8 steps of the integrator with
   the slab-resident force against the single-device force (K13 once a
   force evaluation and segment; at most 1e-5 of the particles' counts
   differ), run twice with equal counts; distributed P3M at phase 13's
   size against ``make_p3m_force_fn`` (1e-4, no NaN, twice the same
   bits), each force's ms, peak memory and collective bytes; at
   1,048,576 on 128^3 the slab deposit of the same routed lanes on the
   card and the CPU bit-equal; (b) a gloo world of two
   ranks sharing the card: the slab-resident PM at 1,048,576 on 128^3 and
   P3M equal to the world of one's within those tolerances, the sharded
   direct integrator (16,384 particles, 8 steps) with the counts of
   ``direct_forces``, the distributed example at its own size with its
   world-of-one counts, and ``graft_entry.dryrun_multichip(2)``;
16. the stream probes (``orbitanalysis_tpu_torch/probes``) at the JAX
   scripts' defaults: ``dma_probe.main(rows=2048)`` (every variant: torch's
   ``x + 1`` and P1-P3 on a [2048, 65536] f32 plane) and
   ``detect_probe.main()`` (K9 and P4 over 12 snapshots of the churn
   workload at [64, 32768]), counted, with P1's, P2's and P3's grids (P2's
   blocks an SM by ``ring_plan``, checked against the occupancy
   calculator, and its loads in flight an SM), each P1-P3 variant's ms
   over torch's on the same planes (``xla``, ``xla5`` for ``pallas5``) and
   the spread of P2's block end times (``man16x4``, the card's clock);
   each probe kernel bit-equal to its
   plain version at those shapes and timed beside phase 3's kernels; then
   each byte-bound kernel's stream floor: its bound's bytes at P4's rate
   (K6-K10) or at the best rate of P1-P3 (the others).

Any failed check exits non-zero without printing the result lines.  The
last three lines are the card's name and power limit, the kernels' JSON
record and the device JSON line.
"""

from __future__ import annotations

import itertools
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
#: K3 on one halo at the aligned engine's widest row
#: (MAX_ALIGNED_CAPACITY), checked and timed on a log line
PAIR_WIDE = (1, 1 << 19, 16384)
#: phase 4: (halos, capacity, particle pool per halo, snapshots)
PARITY = (64, 32768, 40000, 8)
#: phase 5: config 2 (BASELINE.md): (halos, particle pool per halo,
#: snapshots, box); ~80% of a pool is in its region at snapshot 0,
#: so ~1e6 particles are tracked.  WIDE_POOL puts one halo past
#: PAYLOAD_MAX_ROW members.  ORACLE_HALOS are checked against the oracle.
E2E = (100, 12500, 20, 25.0)
E2E_COSMO = dict(redshift=0.5, H0=0.1, Omega_m=0.3, Omega_L=0.7)
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
#: timed scans of phase 7 (after one warm-up scan), and its timed routes
LABEL_SCANS = 5
LABEL_TIMED = (("auto", "'split': K7 -> K6 -> K8"),
               ("fused", "K7 -> K10 -> K5"),
               ("pallas", "K12 -> K11 -> plain chain -> K5"))
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


def row_event_keys(count, ids, row0=0):
    """The events of ``[S, H]`` counts and ``[S, H, K]`` event IDs (each
    row's first ``count`` entries) as one sorted host array of
    ``(snapshot << 40) | ((row0 + row) << 32) | id`` keys: a set to hold
    engines against each other."""
    import torch

    s, h, k = ids.shape
    dev = ids.device
    ok = torch.arange(k, device=dev)[None, None, :] < count[..., None]
    snap = torch.arange(s, device=dev, dtype=torch.int64)[:, None, None]
    row = torch.arange(row0, row0 + h, device=dev,
                       dtype=torch.int64)[None, :, None]
    keys = (snap << 40) | (row << 32) | ids.long()
    return np.sort(keys.expand(s, h, k)[ok].cpu().numpy())


def label_event_keys(count, index):
    """The label path's events (``[S, R]`` counts, ``[S, R, K]`` global
    pool indices, -1 past each count) as sorted ``(snapshot << 32) |
    index`` keys."""
    import torch

    s = index.shape[0]
    snap = torch.arange(s, device=index.device,
                        dtype=torch.int64)[:, None, None]
    keys = (snap << 32) | index.long()
    return np.sort(keys.expand_as(index)[index >= 0].cpu().numpy())


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

    results["compact_pair_rows"] = _pair_check(dev, rng, *PAIR_ROWS)
    wide = _pair_check(dev, rng, *PAIR_WIDE)
    results["compact_pair_rows"]["max_abs_err"] = max(
        results["compact_pair_rows"]["max_abs_err"], wide["max_abs_err"])
    h, p, k = PAIR_WIDE
    log(f"  compact_pair_rows [{h}, {p}] K={k}: kernel {wide['ms']:.4f} ms, "
        f"plain torch {wide['plain_ms']:.4f} ms, bound "
        f"{wide['bound_ms']:.4f} ms ({wide['bound_by']}) (timed as below)")
    return results


#: Config 2's aligned rows: halos, slots a row, snapshots staged.
ALIGNED_CHAIN = (100, 16384, 3)


def aligned_chain_checks(dev):
    """The aligned step's fused frame-and-detect kernels at config 2's
    shape ([100, 16384] SoA rows with masses, box 25, the Hubble term):
    the pass fed the plain chain's bulk velocities against the plain
    chain on the same CUDA tensors, bit for bit; the moments kernel's
    bulk velocities against the plain chain's; their times, and the
    plain chain's (both halves together)."""
    import torch

    from orbitanalysis_tpu_torch.engine.packing import (
        StableLayout,
        align_packed,
    )
    from orbitanalysis_tpu_torch.models.synthetic import churn_workload
    from orbitanalysis_tpu_torch.ops import _cuda, sorted_step
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu_torch.utils.numerics import hubble_parameter

    h, p, n_snap = ALIGNED_CHAIN
    ids, pos, vel, cen, _ = churn_workload(h, p, n_snap, seed=4)
    rng = np.random.default_rng(4)
    lay = StableLayout(h, p)
    drag = float(hubble_parameter(0.5, 0.1, 0.3, 0.7) / 1.5)
    step = sorted_step.make_aligned_native_step(1024, box_size=25.0,
                                                soa_batch=True)
    carry = sorted_step.init_aligned_carry(h, p, device=dev)
    for s in range(n_snap):
        a = align_packed(lay, ids[s], pos[s], vel[s],
                         rng.uniform(0.5, 2.0, (h, p)).astype(np.float32),
                         soa=True)
        snap = SnapshotBatch(
            *(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in (a[0], a[1], a[2], cen[s], a[3])),
            hubble_drag=drag, slot=torch.from_numpy(a[4]).to(dev))
        if s < n_snap - 1:
            carry, _ = step(carry, snap)
    args = (25.0, True, np.iinfo(np.int32).max)
    plain = sorted_step.aligned_chain_torch(carry, snap, *args, soa=True)
    fed = snap._replace(bulk_vel=plain[6].contiguous())
    got = sorted_step.aligned_chain(carry, fed, *args, soa=True)
    est = sorted_step.aligned_chain(carry, snap, *args, soa=True)
    torch.cuda.synchronize()
    same = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got[:6], plain[:6]))
    gap = float((est[6] - plain[6]).abs().max())
    log(f"  aligned_frame_detect [{h}, {p}]: {int(plain[5].sum())} events, "
        f"fed the plain bulk velocities the plain chain's bits: {same}; "
        f"aligned_moments' bulk velocities within {gap:.3e} of torch's")
    check(same, "aligned_frame_detect differs from the plain chain")
    check(gap <= 1e-6, "aligned_moments' bulk velocities stray")
    inv = np.iinfo(np.int32).max
    partial = _cuda.aligned_moments(snap.ids, snap.vel, snap.mass, inv, True)
    box = (25.0, 25.0, 25.0)
    prev = (carry.sv, carry.rhat, carry.packed)
    n = h * p
    plain_ms = cuda_ms(lambda: sorted_step.aligned_chain_torch(
        carry, snap, *args, soa=True))

    def moments(c):
        ids, vel, mass = (t.clone() for t in (snap.ids, snap.vel, snap.mass))
        return lambda: _cuda.aligned_moments(ids, vel, mass, inv, True)

    def fused(c):
        ids, slot, pos, vel, center = (t.clone() for t in (
            snap.ids, snap.slot, snap.pos, snap.vel, snap.center))
        old = tuple(t.clone() for t in prev)
        return lambda: _cuda.aligned_frame_detect(
            ids, slot, pos, vel, center, partial, drag, box, old, True, inv,
            -1, True, False, False)

    # moments: ID, velocity, mass read; the pass: ID, slot, position,
    # velocity, the carry's sv, r-hat and packed word read, key, sv,
    # r-hat, packed and the angle word written
    out = {}
    for name, n_bytes, make in (("aligned_moments", n * 20, moments),
                                ("aligned_frame_detect", n * 80, fused)):
        b_ms, b_by = bound(n_bytes, 0)
        cold, warm = cold_ms(make, n_bytes), cuda_ms(make(0))
        log(f"  {name}: {cold:.4f} ms with its inputs out of L2, "
            f"{warm:.4f} ms on one set of inputs back to back (as warm as "
            f"{n_bytes / 1e6:.1f} MB a call leaves the card's L2)")
        out[name] = dict(max_abs_err=0 if same else 1, ms=cold,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None)
    return out


def cold_ms(make, n_bytes):
    """:func:`cuda_ms` of a call with its inputs out of L2: ``make(c)``
    returns the call on the c-th copy of its inputs, and the calls visit
    enough copies in turn that the ``n_bytes`` each moves, times the
    other copies, exceed the card's L2 twice over."""
    import torch

    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    calls = [make(c) for c in range(2 + 2 * l2 // n_bytes)]
    turn = itertools.cycle(calls)
    return cuda_ms(lambda: next(turn)())


def _pair_check(dev, rng, h, p, k):
    """K3 against its twin on ``[h, p]`` rows with 3 % events and the
    last position an event; its times and bound."""
    import torch

    from orbitanalysis_tpu_torch.ops import compact

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
          f"compact_pair_rows differs from its twin at [{h}, {p}]")
    check(int(got[0][0, int(sel[0].sum()) - 1]) == p,
          f"the event at position {p - 1} was lost")
    # posw read whole, angw only at the events
    k128 = compact._k128(k, p)
    b_ms, b_by = bound(pw.numel() * 4 + gathered_bytes(pw != 0, k128, 1)
                       + 2 * h * k128 * 4, 4 * pw.numel())
    return dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: compact.compact_payload_pair(pw, aw2, k)),
        plain_ms=cuda_ms(
            lambda: compact.compact_payload_pair_torch(pw, aw2, k)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
    )


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
    cosmo = E2E_COSMO
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
        aligned=w_auto.files["auto.h5"],
        members=members, hubble_drag=hubble_drag, box=box,
        wall_aligned=wall, wall_general=wall_gen)


# ---------------------------------------------------- label-native phases

def stage_aligned(dev, form, n_snap):
    """The first ``n_snap`` snapshots of an ID-form sequence ``(ids, pos,
    vel, centers, _)`` (each row's members in load order, then padding)
    staged in the stable layout as the JAX benchmark stages them
    (``bench.py``: ``stage_batch_aligned(soa=True)``, one allocation for
    the sequence, the native sequence pass where it built), then moved
    to the card: a SnapshotBatch of ``[S, ...]`` tensors with SoA
    position and velocity planes.  Logs the host's staging seconds."""
    import torch

    from orbitanalysis_tpu_torch import native
    from orbitanalysis_tpu_torch.engine.packing import stage_batch_aligned
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch

    ids, pos, vel, cen, _ = form
    h, c = ids.shape[1:]
    t0 = time.perf_counter()
    staged = stage_batch_aligned(SnapshotBatch(
        ids=ids[:n_snap], pos=pos[:n_snap], vel=vel[:n_snap],
        center=cen[:n_snap]), soa=True)
    t_stage = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = SnapshotBatch(**{f: torch.from_numpy(np.ascontiguousarray(
        getattr(staged, f))).to(dev) for f in (
            "ids", "pos", "vel", "center", "slot")})
    torch.cuda.synchronize()
    log(f"  stage_batch_aligned(soa=True), {n_snap} snapshots of [{h}, {c}]: "
        f"{t_stage:.3f} s on the host ({native.tier()} tier, "
        f"{t_stage / n_snap * 1e3:.1f} ms a snapshot), "
        f"{time.perf_counter() - t0:.3f} s to move to the card")
    return out


def bench_workloads(dev, rank_dir):
    """The JAX benchmark's workloads from one orbit pool, made on the host
    from its seed: the label-native churn sequence (moved to the card),
    the same churn in the ID form (load order on the host for the
    general engine's check, staged ID-sorted with SoA planes on the card,
    and staged in the stable layout) and the first SORTED_CHECK snapshots
    of the fixed-membership sequence (staged both ways).  The label form
    and the ID form in load order are also written to ``rank_dir`` for
    phase 14's ranks, which read their blocks and generate nothing."""
    import torch

    from orbitanalysis_tpu_torch.models.synthetic import bench_workloads
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu_torch.ops.sorted_step import presort_snapshot

    t0 = time.perf_counter()
    w = bench_workloads(*LABEL, seed=0, churn=0.07)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    for form in ("label", "churn"):
        for name, a in zip(("", "_pos", "_vel", "_centers"), w[form][:4]):
            np.save(os.path.join(rank_dir, f"{form}{name}.npy"), a)
    log(f"  the label form and the ID form written for phase 14's ranks: "
        f"{time.perf_counter() - t0:.1f} s")
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
    t_sorted = time.perf_counter() - t1
    log(f"  bench workloads {LABEL[0]} halos x {LABEL[1]} slots x "
        f"{LABEL[2]} snapshots: label N = {work['label'].shape[1]}, "
        f"{n_valid} tracked at snapshot 0; churn ID form "
        f"{staged['churn'][1]} members a row; {t_gen:.1f} s to generate "
        f"on the host, {t_sorted:.1f} s to stage ID-sorted and move to the "
        "card; in the stable layout, phase 3's three churn snapshots and "
        f"the {SORTED_CHECK} static ones (phase 10 stages the churn "
        "sequence whole):")
    aligned_head = stage_aligned(dev, w["churn"], 3)
    aligned_static = stage_aligned(dev, w["static"], SORTED_CHECK)
    churn_host = w["churn"]
    del w
    return work, dict(churn=staged["churn"][0], n_valid=staged["churn"][1],
                      static=staged["static"][0],
                      n_static=staged["static"][1], load_order=load_order,
                      churn_host=churn_host, aligned_head=aligned_head,
                      aligned_static=aligned_static)


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
            check(name != "detect_label_compact_rows"
                  or not any(diff.values()),
                  f"{name}: lanes differ from the plain version: {diff}")
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

    keys = label_event_keys(ev.count, ev.index)

    # ---- timing: wall and device ms per step over whole scans, the
    # host's time to queue a step, and where the device time goes
    for frames, what in LABEL_TIMED:
        time_label_step(dev, work, frames, what)
    return launches, keys


def time_label_step(dev, work, frames, what):
    """Wall and device ms a step of the label step on ``frames`` over
    whole scans of ``work`` (medians of LABEL_SCANS scans after a warm-up
    one), the host's time to queue a step, and where the device time goes
    (:func:`profile_scan`); prints them and checks nothing."""
    import torch

    from orbitanalysis_tpu_torch.ops import label_step as ls

    n = work["label"].shape[1]
    s_n = work["label"].shape[0]
    step = ls.make_label_orbit_step(LABEL_K, frames=frames,
                                    box_size=LABEL_BOX, row_width=LABEL_ROW,
                                    rhat_packed=True)

    def run_scan(queue=None):
        carry = ls.init_label_carry(n, True, LABEL_ROW, device=dev)
        for s in range(s_n):
            t1 = time.perf_counter()
            carry, _ = step(carry, (work["pos"][s], work["vel"][s],
                                    work["label"][s], work["centers"][s],
                                    None, None, 0.0))
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
    # operations a lane (the merge's comparisons, the detect chain)
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
    # six channels a side in, six [H, 2P] channels out; a merge step and
    # a share of one 11-step search in shared memory, ~8 operations a
    # merged position
    record("merge_rows", got, want, lambda: merge.merge_rows(*a),
           lambda: merge.merge_rows_torch(*a), 24 * hp * 4, 8 * 2 * hp,
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
            ("native, aligned churn step 2", seq["aligned_head"],
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

    from orbitanalysis_tpu_torch.engine.scan import (
        CountingCarry,
        scan_counts,
        scan_events_sorted,
    )
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
    c_legacy = _cuda.launch_counts()
    # the general step's count accumulator over the load-order churn
    # sequence (host arrays, moved to the card once by the driver)
    ids_h, pos_h, vel_h, cen_h, _ = seq["churn_host"]
    t0 = time.perf_counter()
    ccarry, per_step = scan_counts(
        CountingCarry(track=tapsis.init_carry(h, p, device=dev),
                      counts=torch.zeros((h, p), dtype=torch.int32,
                                         device=dev)),
        tapsis.SnapshotBatch(ids=ids_h, pos=pos_h, vel=vel_h, center=cen_h),
        box_size=LABEL_BOX, angle_cut=0.0)
    torch.cuda.synchronize()
    counts_s = time.perf_counter() - t0
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
    check(diff(c_legacy, c_static) == {"static_detect_rows": n_chk},
          f"the legacy aligned step launched {diff(c_legacy, c_static)}, "
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
        f"launches {diff(c_legacy, c_static)}")
    # the count accumulator: every apsis of the general step counted once
    counted = int(per_step.sum())
    log(f"  scan_counts(angle_cut=0), general step over the {s_n} load-order "
        f"churn snapshots: {counted} apsides counted (per step "
        f"{int(per_step.min())}-{int(per_step.max())}), the most a particle "
        f"holds {int(ccarry.counts.max())}; launches "
        f"{diff(launches, c_legacy)}; {counts_s:.3f} s incl. warm-up")
    check(per_step.shape == (s_n,) and counted == total,
          f"scan_counts counted {counted} apsides, the sorted engine "
          f"{total}")
    check(diff(launches, c_legacy) == {},
          "the general step launched a kernel")

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
    return launches, row_event_keys(cnt, ids)


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


# -------------------------------------------------------------- phase 9b

#: phase 9b: the angle cut of the collation, the halos whose collated
#: counts are held against the oracle, the central particles a halo of
#: the progenitor vote, the halo without a progenitor in the on-the-fly
#: pair, and the radius of the region queries
COLLATE_CUT = 0.1
COLLATE_HALOS = 4
CENTRAL_N = 100
NO_PROGENITOR = 7
REGION_RADIUS = 3.0


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _exact(a, b, what):
    """Two in-memory files equal dataset for dataset, dtypes included."""
    check(sorted(a) == sorted(b), f"{what}: groups differ")
    for g in a:
        if g == "attrs":
            check(a[g] == b[g], f"{what}: root attributes differ")
            continue
        check(sorted(a[g]) == sorted(b[g]), f"{what}/{g}: datasets differ")
        for ds in a[g]:
            x, y = a[g][ds], b[g][ds]
            check(x.dtype == y.dtype and x.shape == y.shape
                  and np.array_equal(x, y), f"{what}/{g}/{ds} differs")


def collated_oracle_check(snaps, final, hubble_drag, box, n_check, cut):
    """The collated final counts of the first ``n_check`` halos against
    the NumPy oracle's events with the angle cut applied to their f16
    storage.  A particle whose float64 radial velocity lies within 1e-5
    of zero at some snapshot, or with an event angle within 1e-3 rad of
    the cut, is left out (float32 cannot settle it) and counted."""
    from collections import Counter

    from oracle import OracleTracker

    oracle = OracleTracker(mode="pericentric", box_size=box)
    want = [Counter() for _ in range(n_check)]
    unsure = [set() for _ in range(n_check)]
    for s, snap in enumerate(snaps):
        ev = oracle.step({h: dict(snap[h], hubble_drag=hubble_drag)
                          for h in range(n_check)})
        for h in range(n_check):
            unsure[h].update(pid for pid, st in oracle.state[h].items()
                             if abs(st[0]) < 1e-5)
            if s == 0:
                continue
            ids, ang, _ = ev[h]
            unsure[h].update(ids[np.abs(ang - cut) < 1e-3].tolist())
            want[h].update(ids[ang.astype(np.float16)
                               > np.float16(cut)].tolist())
    offs = np.concatenate((final["halo_offsets"],
                           [len(final["particle_IDs"])]))
    compared = left_out = 0
    for h in range(n_check):
        sl = slice(offs[h], offs[h + 1])
        got = dict(zip(final["particle_IDs"][sl].tolist(),
                       final["pericenter_counts"][sl].tolist()))
        for pid in set(got) | set(want[h]):
            if pid in unsure[h]:
                left_out += 1
                continue
            check(got.get(pid, 0) == want[h].get(pid, 0),
                  f"halo {h}: particle {pid} collated {got.get(pid, 0)} "
                  f"times, the oracle {want[h].get(pid, 0)}")
            compared += 1
    return compared, left_out


def _subset_callbacks(snaps, n_halos, box):
    """Callbacks that honour the request (the on-the-fly driver asks for
    the halos that have a progenitor only): ``regions`` records the
    requested halos, the loader returns exactly their blocks."""
    centers = np.stack([snaps[0][h]["center"] for h in range(n_halos)])
    asked = {}

    def regions(snapshot_number, halo_ids):
        asked[snapshot_number] = np.asarray(halo_ids)
        return centers[halo_ids], np.full(len(halo_ids), 50.0)

    def load(snapshot_number, positions, rr):
        s, rows = snaps[snapshot_number], asked[snapshot_number]
        return dict(
            ids=np.concatenate([s[h]["ids"] for h in rows]),
            coordinates=np.concatenate([s[h]["pos"] for h in rows]),
            velocities=np.concatenate([s[h]["vel"] for h in rows]),
            masses=np.concatenate([s[h]["mass"] for h in rows]),
            region_offsets=np.concatenate(
                ([0], np.cumsum([len(s[h]["ids"]) for h in rows])[:-1])),
            box_size=box)

    return regions, load


def postprocess_phase(dev, ctx):
    """Phase 9b: the rest of the reference workflow at config-2 scale on
    phase 5's data: ``track_orbits(mode='both')`` (counted), both
    catalogs collated on the host and on the card, the final counts, one
    halo's decomposition, the progenitor tools on the last snapshot
    pair, the on-the-fly driver on the card against the CPU, and region
    queries through the native grid index.  Returns the kernel
    launches."""
    import importlib.util

    import torch

    from orbitanalysis_tpu_torch import (
        Apsides,
        OrbitDecomposition,
        find_main_progenitors,
        get_central_particle_ids,
        get_central_particle_ids_device,
        native,
        track_orbits,
        track_orbits_onthefly,
    )
    from orbitanalysis_tpu_torch.engine import RegionExtractor
    from orbitanalysis_tpu_torch.engine.io_hdf5 import MemoryWriter
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.progenitors import (
        find_main_progenitors_device,
    )
    from orbitanalysis_tpu_torch.utils.metrics import Metrics

    t_phase = time.perf_counter()
    snaps, regions, load = ctx["snaps"], ctx["regions"], ctx["load"]
    n_snap, box = len(ctx["snap_nums"]), ctx["box"]
    n_halos = ctx["branches"].shape[1]
    files = ("peri.h5", "apo.h5")
    w, m = MemoryWriter(), Metrics()
    # ---- the main path, counted
    _cuda.reset_launch_counts()
    _sync(dev)
    t0 = time.perf_counter()
    track_orbits(ctx["snap_nums"], ctx["branches"], regions, load, files,
                 mode="both", verbose=False, metrics=m, writer=w,
                 device=dev)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _cuda.launch_counts()
    # ---- end of the counted main path
    joins = {r["join"] for r in m.records}
    k1 = launches["compact_angle_rows"]
    log(f"  track_orbits(mode='both'): engine {sorted(joins)}, wall "
        f"{wall:.3f} s, compact_angle_rows launches {k1} ({n_snap} "
        "snapshots x 2 modes)")
    check(joins == {"aligned"}, f"join_impl='auto' ran {joins} on CUDA")
    check(k1 == 2 * n_snap, "compaction launches != 2 modes x snapshots")
    _exact(w.files["peri.h5"], ctx["aligned"], "pericentric catalog of "
           "mode='both' against phase 5's")
    log("  the pericentric catalog equals phase 5's aligned catalog")

    # ---- collation, host against the card
    walls = {}
    for f in files:
        ap = Apsides(f, writer=w)
        for where, device in (("host", False), ("card", dev)):
            _sync(dev)
            t0 = time.perf_counter()
            ap.collate_apsides(savefile=f"{f}.{where}", angle_cut=COLLATE_CUT,
                               save_final_counts=True, verbose=False,
                               device=device)
            _sync(dev)
            walls[f, where] = time.perf_counter() - t0
        _exact(w.files[f"{f}.host"], w.files[f"{f}.card"],
               f"collated {f}, host against the card")
        groups = w.list_groups(f"{f}.host")
        fin = w.read_group(f"{f}.host", groups[-1])
        check(len(groups) == n_snap - 1 and all(
            ap._tag + "_counts_final" in w.files[f"{f}.host"][g]
            for g in groups[:-1]), f"{f}: final counts missing")
        log(f"  collated {f}: host {walls[f, 'host']:.3f} s, card "
            f"{walls[f, 'card']:.3f} s (both with the final counts), "
            f"catalogs equal bit for bit; {len(fin['particle_IDs'])} "
            f"particles with counts at snapshot {groups[-1][-3:]}, "
            f"{int(fin[ap._tag + '_counts'].sum())} passages past the "
            f"cut {COLLATE_CUT}")
    final = w.read_group("peri.h5.host", "snapshot_%03d" % (n_snap - 1))
    t0 = time.perf_counter()
    compared, left_out = collated_oracle_check(
        snaps, final, ctx["hubble_drag"], box, COLLATE_HALOS, COLLATE_CUT)
    log(f"  oracle: final counts of the first {COLLATE_HALOS} halos, "
        f"{compared} particles equal, {left_out} left out (sign or cut "
        f"unsettled in float32; {time.perf_counter() - t0:.1f} s)")
    check(compared > 0, "no collated counts compared with the oracle")

    # ---- one halo's decomposition
    last = snaps[n_snap - 1][0]
    od = OrbitDecomposition("peri.h5", writer=w)
    od.get_halo_decomposition_at_snapshot(
        0, snapshot_data=dict(ids=last["ids"], coordinates=last["pos"],
                              velocities=last["vel"]),
        angle_cut=COLLATE_CUT)
    sl = slice(final["halo_offsets"][0], final["halo_offsets"][1])
    coll = dict(zip(final["particle_IDs"][sl].tolist(),
                    final["pericenter_counts"][sl].tolist()))
    check(len(od.counts) == len(last["ids"]) and np.all(
        np.isfinite(od.radii)) and all(
        c == coll.get(pid, 0)
        for pid, c in zip(od.particle_ids.tolist(), od.counts.tolist())),
        "halo 0's decomposition disagrees with its collated counts")
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    log(f"  decomposition of halo 0 at snapshot {n_snap - 1}: "
        f"{len(od.counts)} particles, {int((od.counts > 0).sum())} with "
        "passages, equal to the collated counts; no plot drawn here "
        f"(matplotlib {'present' if have_mpl else 'absent'} on this "
        "machine; the CPU tests draw both plots)")

    # ---- progenitors on the last snapshot pair
    rows = np.arange(n_halos)
    s1, s0 = n_snap - 1, n_snap - 2
    centers = regions(s1, rows)[0]
    snap1, snap0 = load(s1, *regions(s1, rows)), load(s0, *regions(s0, rows))
    t0 = time.perf_counter()
    host = get_central_particle_ids(snap1, centers, n=CENTRAL_N)
    t_host = time.perf_counter() - t0
    get_central_particle_ids_device(snap1, centers, n=CENTRAL_N, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    card = get_central_particle_ids_device(snap1, centers, n=CENTRAL_N,
                                           device=dev)
    t_card = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for a, b in zip(host, card)),
          "central particle IDs differ between the host and the card")
    vote_args = (snap0["ids"], snap0["region_offsets"]) + host
    t0 = time.perf_counter()
    links_host = find_main_progenitors(*vote_args)
    v_host = time.perf_counter() - t0
    find_main_progenitors_device(*vote_args, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    links_card = find_main_progenitors_device(*vote_args, device=dev)
    v_card = time.perf_counter() - t0
    check(list(links_host) == links_card == list(range(n_halos)),
          "progenitor links differ from the host form or from arange")
    log(f"  progenitors ({s0}, {s1}): central IDs ({CENTRAL_N} a halo) "
        f"host {t_host * 1e3:.1f} ms, card {t_card * 1e3:.1f} ms, equal; "
        f"vote host {v_host * 1e3:.1f} ms, card {v_card * 1e3:.1f} ms, "
        f"links equal and each halo its own progenitor")

    # ---- the on-the-fly pair, card against CPU
    links = np.stack([rows, rows])
    links[1, NO_PROGENITOR] = -1
    out = {}
    for where, device in (("card", dev), ("cpu", "cpu")):
        wo = MemoryWriter()
        reg, ld = _subset_callbacks(snaps, n_halos, box)
        _sync(dev)
        t0 = time.perf_counter()
        track_orbits_onthefly(s1, links, reg, ld, ("otfp_{}", "otfa_{}"),
                              mode="both", verbose=False, device=device,
                              writer=wo)
        _sync(dev)
        walls[where] = time.perf_counter() - t0
        out[where] = wo
    n_apsis = 0
    for name in ("otfp_%03d" % s1, "otfa_%03d" % s1):
        a = out["card"].read_group(name)
        b = out["cpu"].read_group(name)
        check(sorted(a) == sorted(b), f"{name}: datasets differ")
        for k in a:
            if k == "angles":
                ok = a[k].shape == b[k].shape and np.allclose(
                    a[k], b[k], rtol=0, atol=1e-4)
            elif k == "bulk_velocities":
                ok = np.array_equal(np.isnan(a[k]), np.isnan(b[k])) and (
                    np.allclose(a[k], b[k], rtol=2e-6, atol=1e-6,
                                equal_nan=True))
            else:
                ok = a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            check(ok, f"{name}/{k} differs between the card and the CPU")
        tag = "pericenter" if name.startswith("otfp") else "apocenter"
        offs = a[tag + "_offsets"]
        check(offs[NO_PROGENITOR + 1] == offs[NO_PROGENITOR] and np.isnan(
            a["bulk_velocities"][1, NO_PROGENITOR]).all(),
            f"{name}: the halo without a progenitor has events or a bulk "
            "velocity")
        n_apsis += len(a[tag + "_IDs"])
    log(f"  on-the-fly pair ({s0}, {s1}), mode='both', halo "
        f"{NO_PROGENITOR} without a progenitor: card {walls['card']:.3f} s, "
        f"CPU {walls['cpu']:.3f} s; {n_apsis} apsides, "
        f"{len(a['entered_IDs'])} entered, {len(a['departed_IDs'])} "
        "departed: ID sets equal, angle changes within 1e-4 rad, bulk "
        "velocities within rtol 2e-6, NaN rows alike")

    # ---- region queries through the native grid index
    check(native.available(), "the native host library is not available")
    s = snaps[s1]
    ids = np.concatenate([s[h]["ids"] for h in rows])
    pos = np.concatenate([s[h]["pos"] for h in rows])
    vel = np.concatenate([s[h]["vel"] for h in rows])
    t0 = time.perf_counter()
    ex = RegionExtractor(ids, pos, vel, box_size=box)
    t_index = time.perf_counter() - t0
    radii = np.full(n_halos, REGION_RADIUS)
    t0 = time.perf_counter()
    got = ex.extract(centers, radii)
    t_extract = time.perf_counter() - t0
    offs = np.concatenate((got["region_offsets"], [len(got["ids"])]))
    for h, (c, r) in enumerate(zip(centers.astype(np.float64), radii)):
        d = pos - c
        d -= box * np.round(d / box)
        want = np.sort(ids[(d * d).sum(1) < r * r])
        check(np.array_equal(np.sort(got["ids"][offs[h]:offs[h + 1]]), want),
              f"region of halo {h} differs from the brute-force cut")
    tier = "native" if len(ids) >= 1 << 18 else "NumPy"
    log(f"  RegionExtractor over snapshot {s1} ({len(ids)} particles, "
        f"{tier} index, grid {ex.dims.tolist()}): index {t_index:.3f} s, "
        f"{n_halos} regions of radius {REGION_RADIUS} in {t_extract:.3f} s, "
        f"{len(got['ids'])} members, equal to the brute-force cut")
    log(f"  phase 9b: {time.perf_counter() - t_phase:.1f} s")
    return launches


def aligned_full_width(dev, seq):
    """Phase 10: the aligned engine over the benchmark's churn sequence in
    the stable layout, staged whole as the JAX benchmark stages it
    (``stage_batch_aligned(soa=True)``, checked against the tracker's
    ``pack_snapshot_aligned`` on its first snapshots), then (counted) the
    drivers ``scan_events_aligned`` per step (the default step,
    ``detect_impl='xla'``) and batched, and the steps
    detect_impl='pallas' and legacy: the same events, the JAX
    benchmark's total, and the native steps the same carries; then K5 at
    the batched driver's shape, and timings.  Returns the kernel
    launches of the counted runs and K5's largest difference from its
    plain version there."""
    import torch

    from orbitanalysis_tpu_torch.engine.scan import scan_events_aligned
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.ops import sorted_step as tss

    h, p = LABEL[0], LABEL[1]
    form = seq.pop("churn_host")
    stack = stage_aligned(dev, form, LABEL[2])
    staging_matches_tracker(dev, form, stack, 3)
    del form
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
    events, carries, counts, slots = {}, {}, {}, {}
    for name, batched in (("xla", False), ("batched", True)):
        before = _cuda.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        carries[name], events[name] = scan_events_aligned(
            tss.init_aligned_carry(h, p, device=dev), stack, LABEL_K,
            batched=batched, **kw)
        torch.cuda.synchronize()
        counts[name] = launch_diff(_cuda.launch_counts(), before)
        log(f"  scan_events_aligned(batched={batched}): "
            f"{int(events[name][0].sum())} events over {s_n} snapshots of "
            f"[{h}, {p}]; launches {counts[name]}; "
            f"{time.perf_counter() - t0:.3f} s incl. warm-up, peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated")
    for name in ("pallas", "legacy"):
        step, init = steps[name]
        before = _cuda.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, evs = init(dev), []
        for s in range(s_n):
            carry, ev = step(carry, _batch(stack, s))
            evs.append(ev)
        torch.cuda.synchronize()
        carries[name] = carry
        events[name] = tuple(torch.stack(x) for x in zip(
            *((e.count, e.ids, e.angles) for e in evs)))
        slots[name] = torch.stack([e.slots for e in evs])
        counts[name] = launch_diff(_cuda.launch_counts(), before)
        log(f"  {name} step: {int(events[name][0].sum())} events; "
            f"launches {counts[name]}; scan "
            f"{time.perf_counter() - t0:.3f} s incl. warm-up")
    launches = _cuda.launch_counts()
    # ---- end of the counted main path

    # the staged stack carries no catalog bulk velocities: the moments
    # pass runs beside the fused frame-and-detect pass and K1
    per_step = {k: s_n for k in ("aligned_moments", "aligned_frame_detect",
                                 "compact_angle_rows")}
    check(counts["xla"] == per_step,
          f"scan_events_aligned launched {counts['xla']}, not the moments, "
          "the fused pass and K1 once a step")
    check(counts["batched"] == {"compact_payload_rows": 1},
          f"scan_events_aligned(batched=True) launched {counts['batched']}, "
          "not K5 once")
    for name in ("pallas", "legacy"):
        check(counts[name] == {"static_detect_rows": s_n},
              f"{name}: K17 did not launch once a step (and nothing else)")
    x_cnt, x_ids, x_ang = events["xla"]
    total = int(x_cnt.sum())
    check(total == LABEL_EVENTS,
          f"the aligned engine found {total} events, not {LABEL_EVENTS}")
    ok = torch.arange(LABEL_K, device=dev) < x_cnt[..., None]
    pos_ids = torch.gather(stack.ids, 2, torch.where(ok, x_ids, 0).long())
    beyond, worst = {}, 0.0
    for name in ("batched", "pallas", "legacy"):
        cnt, ids, ang = events[name]
        check(torch.equal(cnt, x_cnt),
              f"{name}: counts differ from the per-step driver's")
        want = pos_ids if name == "legacy" else x_ids
        check(torch.equal(ids[ok], want[ok]),
              f"{name}: event {'IDs' if name == 'legacy' else 'positions'} "
              "differ from the per-step driver's")
        ulps, dif = f16_ulps(ang[ok].cpu().numpy(), x_ang[ok].cpu().numpy())
        # the batched driver quantizes as the step does: bit-equal
        limit = 0 if name == "batched" else 1
        check(np.all(ulps <= limit), f"{name}: angles differ by "
              f"{int(ulps.max(initial=0))} f16 ulps (limit {limit})")
        beyond[name] = int((ulps > 0).sum())
        worst = max(worst, float(dif.max(initial=0)))
    p_ang, l_ang = events["pallas"][2], events["legacy"][2]
    check(torch.equal(p_ang[ok], l_ang[ok])
          and torch.equal(slots["pallas"][ok], slots["legacy"][ok]),
          "'pallas' and legacy events differ in f32 angles or slots")
    x_carry = carries["xla"]
    for name, fields in (("pallas", ("key", "sv", "rhat", "packed")),
                         ("batched", ("key", "sv"))):
        for f in fields:
            check(torch.equal(getattr(carries[name], f).view(torch.int32),
                              getattr(x_carry, f).view(torch.int32)),
                  f"{name}: final carry {f} differs from the per-step "
                  "driver's")
    check(torch.equal(carries["batched"].packed < 0, x_carry.packed < 0),
          "batched: final match bits differ from the per-step driver's")
    log(f"  the drivers and steps give the same {total} events (the JAX "
        f"benchmark's total: {LABEL_EVENTS}); the batched driver's "
        f"angles bit-equal to the per-step driver's, its carry keys, slots "
        f"and match bits equal; 'pallas' and legacy f32 angles and prev "
        f"slots bit-equal, "
        f"{beyond['pallas']} of them not on the per-step driver's f16 value "
        f"(max |diff| {worst:.3g} rad, within one f16 ulp); final 'xla' "
        "and 'pallas' carries bit-equal")
    del events, carries, slots, pos_ids, ok

    k5_err = batched_payload_check(dev, stack, kw)
    for name, what in (("xla", "aligned step, 'xla' (fused pass + K1)"),
                       ("pallas", "aligned step, 'pallas' (K17)"),
                       ("legacy", "legacy aligned step (K17)")):
        time_scan(dev, stack, s_n, seq["n_valid"], what, *steps[name])
    walls = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        scan_events_aligned(tss.init_aligned_carry(h, p, device=dev), stack,
                            LABEL_K, batched=True, **kw)
        b.record()
        b.synchronize()
        walls.append(a.elapsed_time(b))
    log(f"  scan_events_aligned(batched=True): wall "
        f"{statistics.median(walls):.3f} ms a scan of {s_n} snapshots "
        f"(median of 3, {min(walls):.3f}-{max(walls):.3f}; CUDA events)")
    return launches, k5_err


def batched_payload_check(dev, stack, kw):
    """K5 at the batched driver's shape: the driver's own payload plane,
    ``[S*H, P]`` (3072 rows of 32768), through the kernel and through its
    plain version on the same CUDA tensor, bit for bit (every row's
    zero tail included); logs its times and bound.  Returns the largest
    difference."""
    import torch

    from orbitanalysis_tpu_torch.engine.scan import _aligned_batch_words
    from orbitanalysis_tpu_torch.ops import compact
    from orbitanalysis_tpu_torch.ops import sorted_step as tss

    s_n, h, p = stack.ids.shape
    _, count, words = _aligned_batch_words(
        tss.init_aligned_carry(h, p, device=dev), stack, **kw)
    rows, k = s_n * h, LABEL_K
    k128 = compact._k128(k, p)
    got = compact.compact_payload_blocked(words, k)
    want = compact.compact_payload_torch(words, k)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    check(torch.equal(got, want),
          f"compact_payload_rows differs from its plain version on the "
          f"batched driver's [{rows}, {p}] payload plane (max |diff| {err})")
    tail = torch.arange(k128, device=dev) >= count.reshape(rows, 1)
    check(not bool(got[tail].any()),
          "compact_payload_rows left a non-zero word past a row's count")
    b_ms, b_by = bound(words.numel() * 4 + rows * k128 * 4, 4 * words.numel())
    ms = cuda_ms(lambda: compact.compact_payload_blocked(words, k))
    plain_ms = cuda_ms(lambda: compact.compact_payload_torch(words, k),
                       runs=3, reps=2, warmup=1)
    log(f"  compact_payload_rows [{rows}, {p}] K={k} (the batched driver's "
        f"payload plane, {int(count.sum())} events): max |kernel - plain| "
        f"= {err}, zero past every count; kernel {ms:.4f} ms, plain torch "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) (kernel timed as "
        "in phase 3; plain: medians of 3 timings of 2 calls)")
    return err


def staging_matches_tracker(dev, form, stack, n_snap):
    """The first ``n_snap`` snapshots of ``stack`` (staged by
    ``stage_batch_aligned``) equal the tracker's staging of the same
    loader blocks, one ``pack_snapshot_aligned`` a snapshot, bit for
    bit."""
    import torch

    from orbitanalysis_tpu_torch.engine.packing import (
        StableLayout,
        pack_snapshot_aligned,
    )

    ids, pos, vel, cen, _ = form
    h, c = ids.shape[1:]
    rows, lay = np.arange(h), StableLayout(h, c)
    for s in range(n_snap):
        valid = ids[s] != np.iinfo(np.int32).max
        n_valid = valid.sum(axis=1)
        pk = pack_snapshot_aligned(dict(
            ids=ids[s][valid], coordinates=pos[s][valid],
            velocities=vel[s][valid],
            region_offsets=np.concatenate(([0], np.cumsum(n_valid)[:-1]))),
            rows, h, lay, cen[s])
        for got, want in ((stack.ids[s], pk.ids), (stack.slot[s], pk.slot),
                          (stack.pos[s], np.moveaxis(pk.pos, -1, 0)),
                          (stack.vel[s], np.moveaxis(pk.vel, -1, 0))):
            check(torch.equal(got.cpu(), torch.from_numpy(
                np.ascontiguousarray(want))),
                  f"stage_batch_aligned differs from pack_snapshot_aligned "
                  f"at snapshot {s}")
    log(f"  the staged stack equals pack_snapshot_aligned's (the tracker's "
        f"staging) on snapshots 0-{n_snap - 1}, bit for bit")


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
    first = p3m(pos, mass, box_size=C4_BOX, softening=0.05)     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = p3m(pos, mass, box_size=C4_BOX, softening=0.05)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ma = mass[:, None].double() * acc.double()
    net = ma.sum(0).abs()
    scale = ma.abs().sum(0)
    same = _same_bits(acc, first)
    log(f"  P3M, {n} particles on {grid}^3: {wall:.3f} s; finite "
        f"{bool(torch.isfinite(acc).all())}; net force / sum |m a| = "
        f"{(net / scale).max().item():.3g} (limit 1e-3); two calls "
        f"{'the same bits' if same else 'DIFFER'} (its deposit is K13)")
    check(bool(torch.isfinite(acc).all()), "P3M forces not finite")
    check(bool((net < 1e-3 * scale).all()), "P3M net force not near zero")
    check(same, "P3M gave other bits on a second call")
    return launches


# ------------------------------------------------------------- phase 14

#: phase 14(b): ranks of the gloo world that share the card, and the
#: seconds the phase waits for them before it fails
RANKS = 2
RANK_TIMEOUT = 480
#: the collectives of ``parallel/collectives.py`` by the torch.distributed
#: call each makes (process_allgather is an all_gather on the host's
#: side), probed on gloo with CUDA tensors
GLOO_PROBES = ("all_reduce", "all_gather_into_tensor", "all_to_all_single",
               "broadcast")
#: phase 14's config-2 tracker runs: (name, mesh axes, track_orbits kw)
MESH_RUNS = (("halos_auto", {"halos": RANKS}, {}),
             ("halos_sorted", {"halos": RANKS}, dict(join_impl="sorted")),
             ("shards_both", {"shards": RANKS}, dict(mode="both")))


def _save_config2(ctx, path):
    """Phase 5's config-2 snapshots in one ``.npz`` for the ranks."""
    arrays = {}
    for s, snap in enumerate(ctx["snaps"]):
        for h, d in snap.items():
            for k in ("ids", "pos", "vel", "mass", "center"):
                arrays[f"{k}_{s}_{h}"] = d[k]
    np.savez(path, n_snaps=len(ctx["snaps"]), n_halos=len(ctx["snaps"][0]),
             **arrays)


def _load_config2(path):
    with np.load(path) as z:
        n_s, n_h = int(z["n_snaps"]), int(z["n_halos"])
        return [{h: {k: z[f"{k}_{s}_{h}"] for k in (
            "ids", "pos", "vel", "mass", "center")} for h in range(n_h)}
            for s in range(n_s)]


def _tracker_runs(dev, snaps, runs):
    """Config 2 through ``track_orbits(mesh=...)`` for each of ``runs``,
    every catalog into a MemoryWriter: per run (catalog files, steps,
    wall ms a step, the collectives' bytes a step)."""
    import torch

    from orbitanalysis_tpu_torch import track_orbits
    from orbitanalysis_tpu_torch.engine.io_hdf5 import MemoryWriter
    from orbitanalysis_tpu_torch.parallel import make_mesh
    from orbitanalysis_tpu_torch.parallel.collectives import (
        reset_sent_bytes,
        sent_bytes,
    )
    from orbitanalysis_tpu_torch.utils.metrics import Metrics

    n_halos, _, n_snap, box = E2E
    regions, load = _churn_loader(snaps, n_halos, box, E2E_COSMO)
    out = {}
    for name, axes, kw in runs:
        mesh = make_mesh(axes, device=dev)
        w, m = MemoryWriter(), Metrics()
        save = ((f"{name}_peri.h5", f"{name}_apo.h5")
                if kw.get("mode") == "both" else f"{name}.h5")
        reset_sent_bytes()
        _sync(dev)
        t0 = time.perf_counter()
        track_orbits(np.arange(n_snap), np.tile(np.arange(n_halos),
                                                (n_snap, 1)),
                     regions, load, save, verbose=False, writer=w,
                     metrics=m, device=dev, mesh=mesh, **kw)
        _sync(dev)
        steps = len(m.records) + 1
        out[name] = dict(
            files=w.files, steps=steps, joins=sorted(
                {r["join"] for r in m.records}),
            ms=(time.perf_counter() - t0) * 1e3 / steps,
            bytes=sum(sent_bytes().values()) / steps,
            capacity=m.records[0]["capacity"])
    return out


def phase14_rank(rank, world, store, work, device="cuda"):
    """One rank of phase 14(b) (spawned by :func:`sharded_phase`): a gloo
    world of ``world`` ranks sharing the card.  Probes which collectives
    gloo takes natively on CUDA tensors, then drives the sharded steps on
    the benchmark's workloads (read from ``work``, this rank's block) and
    the config-2 tracker runs; writes its results, launches and log to
    ``work/rank<rank>.pkl``.  Any failure ends the process non-zero."""
    import pickle

    import torch
    import torch.distributed as dist

    from orbitanalysis_tpu_torch.parallel import multihost

    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    multihost.initialize(f"file://{store}", world, rank, backend="gloo")
    try:
        out = _rank_work(rank, world, work, dist, dev)
    finally:
        multihost.shutdown()
    with open(os.path.join(work, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _rank_work(rank, world, work, dist, dev):
    import torch

    from orbitanalysis_tpu_torch.engine.packing import stage_batch_aligned
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch
    from orbitanalysis_tpu_torch.ops.label_step import init_label_carry
    from orbitanalysis_tpu_torch.ops.sorted_step import (
        init_aligned_carry,
        init_sorted_carry,
        presort_snapshot,
    )
    from orbitanalysis_tpu_torch.parallel import (
        make_mesh,
        make_sharded_aligned_step,
        make_sharded_sorted_step,
    )
    from orbitanalysis_tpu_torch.parallel import hash_sharded as hs
    from orbitanalysis_tpu_torch.parallel.collectives import (
        reset_sent_bytes,
        sent_bytes,
    )
    from orbitanalysis_tpu_torch.parallel.label_sharded import (
        make_sharded_label_step,
        shard_label_tree,
    )

    out = dict(rank=rank, walls={}, bytes={}, steps={}, keys={})

    # ---- what gloo takes on CUDA tensors (the port hands them to it as
    # they are)
    x = torch.ones(4 * world, device=dev)
    calls = dict(
        all_reduce=lambda: dist.all_reduce(x.clone()),
        all_gather_into_tensor=lambda: dist.all_gather_into_tensor(
            torch.empty(4 * world * world, device=dev), x),
        all_to_all_single=lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        broadcast=lambda: dist.broadcast(x.clone(), 0))
    out["probe"] = {}
    for name in GLOO_PROBES:
        try:
            calls[name]()
            _sync(dev)
            out["probe"][name] = "accepted"
        except (RuntimeError, ValueError) as exc:
            out["probe"][name] = ("refused: "
                                  + str(exc).strip().splitlines()[0][:100])
        dist.barrier()

    def load(name):
        return np.load(os.path.join(work, f"{name}.npy"), mmap_mode="r")

    h, p, s_n = LABEL
    hl = h // world
    rows = slice(rank * hl, (rank + 1) * hl)
    ids, pos, vel, cen = (load(f"churn{n}") for n in (
        "", "_pos", "_vel", "_centers"))
    block = SnapshotBatch(
        ids=np.ascontiguousarray(ids[:, rows]),
        pos=np.ascontiguousarray(pos[:, rows]),
        vel=np.ascontiguousarray(vel[:, rows]),
        center=np.ascontiguousarray(cen[:, rows]))
    hmesh = make_mesh({"halos": world}, device=dev)

    def to_dev(b):
        return SnapshotBatch(**{f: torch.from_numpy(np.ascontiguousarray(
            getattr(b, f))).to(dev) for f in (
                "ids", "pos", "vel", "center", "slot")})

    def timed_scan(name, step, carry, staged, ev_ids):
        """The counted, timed scan of one sharded step over the staged
        sequence; returns the event keys, after one warm-up step."""
        step(carry, _batch(staged, 0))
        keys = []
        c0 = _cuda.launch_counts()
        reset_sent_bytes()
        _sync(dev)
        t0 = time.perf_counter()
        for s in range(s_n):
            carry, ev = step(carry, _batch(staged, s))
            keys.append((ev.count, ev_ids(ev, s)))
        _sync(dev)
        out["walls"][name] = (time.perf_counter() - t0) * 1e3 / s_n
        out["bytes"][name] = sum(sent_bytes().values()) / s_n
        out["steps"][name] = launch_diff(_cuda.launch_counts(), c0)
        cnt = torch.stack([k[0] for k in keys])
        out["keys"][name] = row_event_keys(
            cnt, torch.stack([k[1] for k in keys]), row0=rank * hl)

    # ---- the counted main path: the four sharded steps, then config 2
    _cuda.reset_launch_counts()
    staged = to_dev(presort_snapshot(block, soa=True))
    step = make_sharded_sorted_step(
        hmesh, LABEL_K, box_size=LABEL_BOX, fused=True, cur_presorted=True,
        soa_batch=True)
    timed_scan("sorted", step, init_sorted_carry(hl, p, device=dev), staged,
               lambda ev, s: ev.ids)
    del staged
    staged = to_dev(stage_batch_aligned(block, soa=True))
    step = make_sharded_aligned_step(hmesh, LABEL_K, box_size=LABEL_BOX,
                                     soa_batch=True)
    # positional events: the IDs from the current snapshot's staged table
    timed_scan("aligned", step, init_aligned_carry(hl, p, device=dev),
               staged, lambda ev, s: torch.gather(
                   staged.ids[s], 1, ev.ids.clamp(0, p - 1).long()))
    del staged, block

    # the hash scan: each snapshot's load-order records, cut by position
    # (every rank cuts the same records; each keeps its chunk)
    invalid = np.iinfo(np.int32).max
    n_max = max(int((ids[s] != invalid).sum()) for s in range(s_n))
    L = -(-n_max // world)
    cap = -(-int(L * 1.05) // 128) * 128
    chunks = []
    for s in range(s_n):
        v = ids[s] != invalid
        fr = hs.flat_to_position_shards(dict(
            halo=np.broadcast_to(np.arange(h, dtype=np.int32)[:, None],
                                 v.shape)[v],
            ids=ids[s][v], pos=pos[s][v], vel=vel[s][v]), world, pad_to=L)
        chunks.append([None if x is None else x[rank:rank + 1].copy()
                       for x in fr])
    flat_seq = hs.FlatRecords(*(
        None if parts[0] is None else torch.from_numpy(
            np.stack(parts)).to(dev)
        for parts in zip(*chunks)))
    del chunks
    smesh = make_mesh({"shards": world}, device=dev)
    scan = hs.make_hash_scan(smesh, h, cap, cap, box_size=LABEL_BOX)
    carry = hs.init_hash_carry(1, cap, h, device=dev)
    centers = torch.from_numpy(np.array(cen)).to(dev)
    c0 = _cuda.launch_counts()
    reset_sent_bytes()
    _sync(dev)
    t0 = time.perf_counter()
    carry, evs, dropped = scan(carry, flat_seq, centers)
    _sync(dev)
    out["walls"]["hash"] = (time.perf_counter() - t0) * 1e3 / s_n
    out["bytes"]["hash"] = sum(sent_bytes().values()) / s_n
    out["steps"]["hash"] = launch_diff(_cuda.launch_counts(), c0)
    out["hash_dropped"] = int(dropped.sum())
    out["hash_shape"] = dict(L=L, cap=cap, block=hs.default_block(
        L, world, cap), words=hs.router_words(False))
    k = evs.ids.shape[-1]
    ok = torch.arange(k, device=dev)[None, None, :] < evs.count[..., None]
    snap = torch.arange(s_n, device=dev, dtype=torch.int64)[:, None, None]
    keys = (snap << 40) | (evs.halo.long() << 32) | evs.ids.long()
    out["keys"]["hash"] = np.sort(keys.expand_as(evs.ids)[ok].cpu().numpy())
    del flat_seq, evs, carry, keys, ok

    # the label pool: this rank's block of each snapshot's pool
    lab = load("label")
    n = lab.shape[1]
    lo, hi = rank * n // world, (rank + 1) * n // world
    lab_d = torch.from_numpy(np.ascontiguousarray(lab[:, lo:hi])).to(dev)
    lpos = torch.from_numpy(np.ascontiguousarray(
        load("label_pos")[:, :, lo:hi])).to(dev)
    lvel = torch.from_numpy(np.ascontiguousarray(
        load("label_vel")[:, :, lo:hi])).to(dev)
    lcen = torch.from_numpy(np.array(load("label_centers"))).to(dev)
    pmesh = make_mesh({"particles": world}, device=dev)
    lstep, _ = make_sharded_label_step(pmesh, LABEL_K, h, box_size=LABEL_BOX,
                                       row_width=LABEL_ROW)
    carry = shard_label_tree(pmesh, init_label_carry(
        n, row_width=LABEL_ROW, device="cpu"))
    c0 = _cuda.launch_counts()
    reset_sent_bytes()
    _sync(dev)
    t0 = time.perf_counter()
    counts, index = [], []
    for s in range(s_n):
        carry, ev = lstep(carry, (lpos[s], lvel[s], lab_d[s], lcen[s], None,
                                  0.0))
        counts.append(ev.count)
        index.append(ev.index)
    _sync(dev)
    out["walls"]["label"] = (time.perf_counter() - t0) * 1e3 / s_n
    out["bytes"]["label"] = sum(sent_bytes().values()) / s_n
    out["steps"]["label"] = launch_diff(_cuda.launch_counts(), c0)
    out["keys"]["label"] = label_event_keys(torch.stack(counts),
                                            torch.stack(index))
    del lab_d, lpos, lvel, carry, index
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # config 2 through track_orbits(mesh=...)
    c0 = _cuda.launch_counts()
    runs = _tracker_runs(dev, _load_config2(os.path.join(work,
                                                         "config2.npz")),
                         MESH_RUNS)
    out["tracker_launches"] = launch_diff(_cuda.launch_counts(), c0)
    out["launches"] = _cuda.launch_counts()
    # ---- end of the counted main path
    for name, r in runs.items():
        out["walls"][name] = r["ms"]
        out["bytes"][name] = r["bytes"]
        out["steps"][name] = dict(steps=r["steps"], joins=r["joins"],
                                  capacity=r["capacity"])
    if rank == 0:
        out["catalogs"] = {name: r["files"] for name, r in runs.items()}
    return out


def world_of_one(dev, ctx, work):
    """Phase 14(a): an NCCL world of one rank in this process, config 2
    through the halo-sharded (aligned) and hash-sharded engines, and the
    four collectives once each on CUDA tensors.  Returns the counted
    launches."""
    import torch
    import torch.distributed as dist

    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.parallel import make_mesh, multihost
    from orbitanalysis_tpu_torch.parallel import collectives as col

    multihost.initialize(f"file://{os.path.join(work, 'nccl_store')}", 1, 0,
                         backend="nccl")
    try:
        check(col.backend_of() == "nccl", "the world of one is not NCCL")
        # ---- the main path, counted
        _cuda.reset_launch_counts()
        runs = _tracker_runs(dev, ctx["snaps"], (
            ("halos_auto", {"halos": 1}, {}),
            ("shards", {"shards": 1}, {})))
        launches = _cuda.launch_counts()
        # ---- end of the counted main path
        mesh = make_mesh({"halos": 1}, device=dev)
        g = mesh.group("halos")
        x = torch.arange(8, dtype=torch.float32, device=dev).reshape(2, 4)
        col.reset_sent_bytes()
        got = (col.psum(x, g), col.all_gather(x, g, axis=1),
               col.all_to_all(x, g), col.process_allgather(x, g),
               col.ppermute(x, g, [(0, 0)]))
        _sync(dev)
        check(all(torch.equal(torch.as_tensor(y).to(dev).reshape(2, 4), x)
                  for y in got), "a collective of the world of one is not "
              "the identity")
        check(col.sent_bytes() == {"psum": 32, "all_gather": 64,
                                   "all_to_all": 32, "ppermute": 32},
              f"collective bytes {col.sent_bytes()}")
    finally:
        multihost.shutdown()
    check(not dist.is_initialized(), "the NCCL world did not end")
    halos, shards = runs["halos_auto"], runs["shards"]
    check(halos["joins"] == ["aligned"],
          f"join_impl='auto' on a 'halos' mesh ran {halos['joins']}")
    check(launches["compact_angle_rows"] == halos["steps"],
          f"K1 launched {launches['compact_angle_rows']} times, not once "
          f"in each of {halos['steps']} steps")
    check(shards["joins"] == ["hash"], f"the shards run ran {shards['joins']}")
    for name, r in runs.items():
        catalogs_equal(ctx["general"], r["files"][f"{name}.h5"])
    log(f"  {{'halos': 1}} (aligned, K1 {halos['steps']} times) and "
        f"{{'shards': 1}} over NCCL at config 2: catalogs equal phase 5's "
        "general engine's; psum, all_gather, all_to_all, "
        "process_allgather and a ppermute self-send through NCCL on CUDA "
        "tensors, the identity")
    log(f"  walls: halos {halos['ms']:.2f} ms a step, shards "
        f"{shards['ms']:.2f} ms a step; collective bytes a step: halos "
        f"{halos['bytes']:.0f}, shards {shards['bytes']:.0f}")
    return launches


def sharded_phase(dev, ctx, work, keys, smi):
    """Phase 14: the distributed engines on the card.  (a) an NCCL world
    of one in this process; (b) a gloo world of RANKS spawned ranks
    sharing the card (NCCL refuses two ranks on one GPU): the sharded
    sorted, aligned, hash and label steps at full width on the JAX
    benchmark's workloads, each finding exactly its 1,741,643 events as
    phases 7 and 8 found them, and config 2 through track_orbits(mesh=)
    with catalogs equal to phase 5's.  Returns the launches of both."""
    import multiprocessing
    import pickle

    import torch

    t_phase = time.perf_counter()
    launches = world_of_one(dev, ctx, work)
    _save_config2(ctx, os.path.join(work, "config2.npz"))
    torch.cuda.empty_cache()
    ctx_mp = multiprocessing.get_context("spawn")
    store = os.path.join(work, "gloo_store")
    procs = [ctx_mp.Process(target=phase14_rank,
                            args=(r, RANKS, store, work))
             for r in range(RANKS)]
    t0 = time.perf_counter()
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(timeout=max(1.0, RANK_TIMEOUT
                                - (time.perf_counter() - t0)))
    finally:
        hung = [pr for pr in procs if pr.is_alive()]
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    check(not hung, f"{len(hung)} rank(s) still running after "
          f"{RANK_TIMEOUT} s")
    for r, pr in enumerate(procs):
        check(pr.exitcode == 0, f"rank {r} failed (exit {pr.exitcode})")
    outs = []
    for r in range(RANKS):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))  # written by this run's ranks
    log(f"  gloo world of {RANKS} ranks on one card: "
        f"{time.perf_counter() - t0:.1f} s from spawn to exit")
    log(f"  gloo on CUDA tensors: {outs[0]['probe']} (the port hands CUDA "
        "tensors to a gloo group as they are)")

    s_n = LABEL[2]
    for name, want, what in (("sorted", keys["sorted"], "phase 8"),
                             ("aligned", keys["sorted"], "phase 8"),
                             ("hash", keys["sorted"], "phase 8"),
                             ("label", keys["label"], "phase 7")):
        got = np.sort(np.concatenate([o["keys"][name] for o in outs]))
        check(len(got) == LABEL_EVENTS,
              f"sharded {name}: {len(got)} events, not {LABEL_EVENTS}")
        check(np.array_equal(got, want),
              f"sharded {name}: the events differ from {what}'s as a set")
        log(f"  sharded {name}: {len(got)} events, the set {what} found; "
            f"launches a rank "
            f"{[o['steps'][name] for o in outs]}")
    for o in outs:
        st = o["steps"]
        check(st["sorted"] == {"fused_join_detect": s_n},
              f"rank {o['rank']}: sharded sorted launched {st['sorted']}")
        # no catalog bulk velocities: moments, fused pass and K1 a step
        check(st["aligned"] == {k: s_n for k in (
            "aligned_moments", "aligned_frame_detect",
            "compact_angle_rows")},
              f"rank {o['rank']}: sharded aligned launched {st['aligned']}")
        check(st["label"] == {"segment_moments": s_n, "frame_rows": s_n,
                              "detect_label_compact_rows": s_n},
              f"rank {o['rank']}: sharded label launched {st['label']}")
        check(o["hash_dropped"] == 0,
              f"rank {o['rank']}: the router dropped {o['hash_dropped']}")
    general = ctx["general"]
    cats = outs[0]["catalogs"]
    for name in ("halos_auto", "halos_sorted"):
        catalogs_equal(general, cats[name][f"{name}.h5"])
    catalogs_equal(general, cats["shards_both"]["shards_both_peri.h5"])
    apo = cats["shards_both"]["shards_both_apo.h5"]
    check(sorted(apo) == sorted(general) and sum(
        len(g.get("apocenter_IDs", ())) for k, g in apo.items()
        if k != "attrs") > 0, "the apocentric catalog is empty")
    for o in outs:
        st = o["steps"]
        check(st["halos_auto"]["joins"] == ["aligned"]
              and st["halos_sorted"]["joins"] == ["sorted"]
              and st["shards_both"]["joins"] == ["hash"],
              f"rank {o['rank']}: the mesh runs took "
              f"{[st[n]['joins'] for n, _, _ in MESH_RUNS]}")
    log("  track_orbits(mesh=) at config 2, rank 0 writing: {'halos': 2} "
        "(auto: aligned), {'halos': 2} sorted, {'shards': 2} mode='both': "
        "catalogs equal phase 5's general engine's")

    hs_shape = outs[0]["hash_shape"]
    log(f"  {smi}: walls and collective bytes a step, a rank (two ranks "
        "share this one card and exchange through the host over gloo: "
        "not the speed of a multi-GPU node)")
    for name in ("sorted", "aligned", "hash", "label", "halos_auto",
                 "halos_sorted", "shards_both"):
        log(f"    {name}: " + "; ".join(
            f"rank {o['rank']} {o['walls'][name]:.3f} ms, "
            f"{o['bytes'][name]:.0f} B" for o in outs))
    log(f"    reckoned from the shapes: label psum [{LABEL[0]}, 4] f32 = "
        f"{LABEL[0] * 16} B; router {RANKS} x block {hs_shape['block']} x "
        f"{hs_shape['words']} words x 4 B = "
        f"{RANKS * hs_shape['block'] * hs_shape['words'] * 4} B "
        f"(L = {hs_shape['L']}, cap = {hs_shape['cap']}) plus the hash "
        f"psum [{LABEL[0]}, 4] f32; halo-sharded steps none; the tracker's "
        "event gathers count-bounded")
    log(f"  launches: world of one {launch_diff(launches)}; a rank "
        f"{[launch_diff(o['launches']) for o in outs]}")
    for o in outs:
        for name, n in o["launches"].items():
            launches[name] += n
    log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------- phase 15

#: phase 15 (models/pm_sharded.py): the world of one's integrator steps
#: and detection cadence at config 4's 12.6M / 256^3 (C4_SCALE); the gloo
#: world's slab-resident PM (particles, grid); the sharded direct
#: integrator (particles, steps); the distributed example's steps
PM15_STEPS, PM15_EVERY = 8, 2
PM15_GLOO_PM = (1 << 20, 128)
PM15_DIRECT = (16384, 8)
PM15_EXAMPLE_STEPS = 60
#: tolerances as a share of max |ref|: the grid solve, the psum path and
#: P3M; the slab-resident paths; and the share of particles whose counts
#: may differ from the single-device force's over PM15_STEPS steps
PM15_TOL, PM15_SLAB_TOL, PM15_COUNT_SHARE = 1e-4, 2e-4, 1e-5
#: the collectives one distributed force evaluation hands bytes to
PM15_COLLECTIVES = ("all_to_all", "ppermute", "all_gather", "psum")


def _uniform_cloud(n, dev, seed):
    """``n`` positions uniform in config 4's box and masses in [0.5, 2),
    drawn with NumPy from ``seed`` (phase 13's P3M draw for seed 31)."""
    import torch

    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.uniform(0, C4_BOX, (n, 3)).astype(
        np.float32)).to(dev)
    mass = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(
        np.float32)).to(dev)
    return pos, mass


def _direct_state(dev):
    """The sharded direct integrator's state: phase 13's draw (seed 21)
    at PM15_DIRECT's size."""
    from orbitanalysis_tpu_torch.models.nbody import nbody_state_from_numpy

    n = PM15_DIRECT[0]
    rng = np.random.default_rng(21)
    return nbody_state_from_numpy(
        rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(scale=0.3, size=(n, 3)).astype(np.float32),
        np.full(n, 1.0 / n, np.float32), device=dev)


def _direct_run(dev, force):
    """PM15_DIRECT's steps of the direct integrator: the counts."""
    from orbitanalysis_tpu_torch.models.nbody import (
        OrbitNBodyConfig,
        simulate_with_tracking,
    )

    n, steps = PM15_DIRECT
    _, _, _, every, soft, dt = DIRECT
    _, tr, _ = simulate_with_tracking(
        _direct_state(dev), np.arange(n, dtype=np.int32).reshape(1, n),
        OrbitNBodyConfig(dt=dt, n_steps=steps, detect_every=every,
                         softening=soft), force)
    return tr.counts.cpu().numpy()


def _force_call(dev, f, *args, **kw):
    """One force evaluation after a warm-up: ``(acc, ms on the host
    clock to the synchronize, peak bytes allocated, collective bytes)``."""
    import torch

    from orbitanalysis_tpu_torch.parallel.collectives import (
        reset_sent_bytes,
        sent_bytes,
    )

    f(*args, **kw)
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_sent_bytes()
    t0 = time.perf_counter()
    acc = f(*args, **kw)
    _sync(dev)
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    return acc, ms, peak, {k: sent_bytes()[k] for k in PM15_COLLECTIVES}


def _same_bits(a, b):
    """Two float32 results equal bit for bit, NaN lanes included."""
    import torch

    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _max_err(got, want):
    """``(max |got - want|, max |want|)`` in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max()), float(want.abs().max())


def pm15_world_of_one(dev, work):
    """Phase 15(a): an NCCL world of one in this process (gloo on the
    CPU).  At 12.6M / 256^3: the grid solve against ``pm_forces_grid`` on
    the same fixed-order deposit (``cic_deposit_auto``), the psum path
    and the slab-resident rows and scalar paths against
    ``make_pm_force_fn``, each twice with the same bits, and the slab
    block's K13 timed; then the main path (counted, K13 once a force
    evaluation): PM15_STEPS steps of the integrator
    with the slab-resident force, whose counts are held against the
    single-device force's, and the same steps again with the same
    counts.  Distributed P3M at phase 13's size against
    ``make_p3m_force_fn``, twice with the same bits.  Then the
    references of the gloo world: the slab-resident PM at PM15_GLOO_PM
    (and its slab deposit, card against CPU), P3M, the direct integrator
    through ``direct_forces`` and the distributed example.  Returns
    ``(launches, references)``."""
    import torch
    import torch.distributed as dist

    from orbitanalysis_tpu_torch.examples import distributed_simulation
    from orbitanalysis_tpu_torch.models import nbody as tnb
    from orbitanalysis_tpu_torch.models import pm_sharded as ps
    from orbitanalysis_tpu_torch.models.p3m import make_p3m_force_fn
    from orbitanalysis_tpu_torch.models.pm import (
        cic_deposit_auto,
        make_pm_force_fn,
        pm_forces_grid,
    )
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.ops import deposit as td
    from orbitanalysis_tpu_torch.parallel import make_mesh, multihost

    cuda = torch.device(dev).type == "cuda"
    multihost.initialize(f"file://{os.path.join(work, 'pm15_store')}", 1, 0,
                         backend="nccl" if cuda else "gloo")
    ref = {}
    try:
        mesh = make_mesh({"x": 1}, device=dev)
        rows, grid, _, _ = C4_SCALE
        n = rows * C4_ROW
        st = c4_state(n, dev)
        # the fixed-order deposit (K13 on the card): the same grid, and so
        # the same error, on every run
        rho = cic_deposit_auto(st.pos, st.mass, grid, C4_BOX)
        solve = ps.make_sharded_pm_grid_solver(mesh, grid)
        err, top = _max_err(solve(rho, C4_BOX),
                            pm_forces_grid(rho, grid, C4_BOX))
        log(f"  grid solve, {grid}^3, against pm_forces_grid on the same "
            f"deposit: max error {err:.3e} = {err / top:.3e} of max |ref| "
            f"(limit {PM15_TOL})")
        check(err <= PM15_TOL * top, "the sharded grid solve disagrees")
        del rho
        want = make_pm_force_fn(grid)(st.pos, st.mass, box_size=C4_BOX)
        _, ms1, peak1, _ = _force_call(dev, make_pm_force_fn(grid), st.pos,
                                       st.mass, box_size=C4_BOX)
        log(f"  {n} particles on {grid}^3, one force evaluation: "
            f"single-device make_pm_force_fn {ms1:.1f} ms, peak "
            f"{peak1 / 1e9:.2f} GB")
        for name, f, tol in (
                ("psum path", ps.make_sharded_pm_force_fn(mesh, grid),
                 PM15_TOL),
                ("slab-resident rows", ps.make_slab_resident_pm_force_fn(
                    mesh, grid, assignment="rows"), PM15_SLAB_TOL),
                ("slab-resident scalar", ps.make_slab_resident_pm_force_fn(
                    mesh, grid, assignment="scalar"), PM15_SLAB_TOL)):
            acc, ms, peak, sent = _force_call(dev, f, st.pos, st.mass,
                                              box_size=C4_BOX)
            err, top = _max_err(acc, want)
            same = _same_bits(acc, f(st.pos, st.mass, box_size=C4_BOX))
            log(f"  {name}: {ms:.1f} ms, peak {peak / 1e9:.2f} GB, bytes a "
                f"call {sent}; max error {err / top:.3e} of max |ref| "
                f"(limit {tol}); a second call "
                f"{'the same bits' if same else 'DIFFERS'}")
            check(err <= tol * top, f"the {name} disagrees with "
                  "make_pm_force_fn")
            check(same, f"the {name} gave other bits on a second call")
            del acc
        del want

        # the slab block's deposit alone: the sorted stream of the
        # routed lanes (a world of one: the particles, then the bucket
        # padding) and K13 on it, against the bytes it must move
        slab = ps.make_slab_resident_pm_force_fn(mesh, grid)
        lanes = ps._route(st.pos, st.mass, grid, C4_BOX, slab.slab, 1,
                          ps._bucket_cap(4.0, n, 1), mesh.group("x"))[0]
        i0, fr = td.cic_base(lanes[:, :3], grid, C4_BOX)
        skeys, fracs, planes, n_seg = ps._slab_stream(
            i0[:, 0], i0, fr, lanes[:, 3], grid, slab.slab)
        sx, sy = td.strides(grid)
        v = planes * sx + sx + sy + 1
        if cuda and n_seg == 1:
            k_ms = cuda_ms(lambda: td.deposit_stream(skeys, fracs, grid, v))
            d_ms = cuda_ms(lambda: ps._slab_deposit(
                i0[:, 0], i0, fr, lanes[:, 3], grid, slab.slab))
            live = int((lanes[:, 3] != 0).sum())
            b_ms, b_by = bound(20 * live + 4 * v, 0)
            log(f"  the slab block's K13: {skeys.shape[0]} routed lanes "
                f"({live} live) onto {v} cells ({slab.slab + 1} planes of "
                f"{grid + 1}^2 and the reach), {n_seg} segment: kernel "
                f"{k_ms:.4f} ms, bound {b_ms:.4f} ({b_by}); the whole slab "
                f"deposit (keys, stable sort, K13, fold) {d_ms:.4f} ms")
        del lanes, i0, fr, skeys, fracs

        # ---- the main path, counted
        members = np.arange(n, dtype=np.int32).reshape(rows, C4_ROW)
        cfg = tnb.OrbitNBodyConfig(dt=C4_DT, n_steps=PM15_STEPS,
                                   detect_every=PM15_EVERY,
                                   mode="pericentric", box_size=C4_BOX,
                                   softening=0.0)
        _cuda.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        _, tr, ev = tnb.simulate_with_tracking(st, members, cfg, slab)
        _sync(dev)
        wall = time.perf_counter() - t0
        launches = _cuda.launch_counts()
        # ---- end of the counted main path
        k13 = launches["deposit_sorted"]
        log(f"  launches of the main path: {launch_diff(launches)} (K13 "
            f"once a force evaluation and segment: {PM15_STEPS + 1} "
            f"evaluations x {n_seg} segment(s))")
        if cuda:
            check(k13 == (PM15_STEPS + 1) * n_seg,
                  f"K13 launched {k13} times on the slab-resident path")
        # the same steps again: the same counts, bit for bit
        _, tr2, ev2 = tnb.simulate_with_tracking(st, members, cfg, slab)
        t0 = time.perf_counter()
        _, tr1, ev1 = tnb.simulate_with_tracking(st, members, cfg,
                                                 make_pm_force_fn(grid))
        _sync(dev)
        wall1 = time.perf_counter() - t0
        n_diff = int((tr.counts != tr1.counts).sum())
        n_diff2 = int((tr2.counts != tr1.counts).sum())
        repeat = torch.equal(tr.counts, tr2.counts) and torch.equal(ev, ev2)
        log(f"  {PM15_STEPS} steps (detect_every={PM15_EVERY}) with the "
            f"slab-resident force: {wall:.2f} s; the single-device force "
            f"{wall1:.2f} s; events {ev.tolist()} against {ev1.tolist()}; "
            f"{n_diff} particles' counts differ (limit "
            f"{PM15_COUNT_SHARE} of {n}); the run repeated: {n_diff2}, "
            f"counts and events {'equal' if repeat else 'DIFFER'}")
        check(int(ev.sum()) > 0, "no apsides in the slab-resident run")
        check(n_diff <= PM15_COUNT_SHARE * n,
              f"{n_diff} particles' counts differ")
        check(repeat and n_diff2 == n_diff,
              "the slab-resident run gave other counts when repeated")
        del st, tr, tr1, tr2, slab
        if cuda:
            torch.cuda.empty_cache()

        n3, g3 = P3M_CHECK
        pos, mass = _uniform_cloud(n3, dev, 31)
        want = make_p3m_force_fn(g3, sigma_cells=1.5)(
            pos, mass, box_size=C4_BOX, softening=0.05)
        p3m = ps.make_slab_resident_pm_force_fn(
            mesh, g3, deconvolve=True, p3m_sigma_cells=1.5)
        acc, ms, peak, sent = _force_call(
            dev, p3m, pos, mass, box_size=C4_BOX, softening=0.05)
        err, top = _max_err(acc, want)
        nan = int(torch.isnan(acc).sum())
        same = _same_bits(acc, p3m(pos, mass, box_size=C4_BOX,
                                   softening=0.05))
        log(f"  distributed P3M, {n3} on {g3}^3: {ms:.1f} ms, peak "
            f"{peak / 1e9:.2f} GB, bytes a call {sent}; max error "
            f"{err / top:.3e} of max |ref| (limit {PM15_TOL}), NaN {nan}; "
            f"a second call {'the same bits' if same else 'DIFFERS'}")
        check(nan == 0 and err <= PM15_TOL * top,
              "distributed P3M disagrees with make_p3m_force_fn")
        check(same, "distributed P3M gave other bits on a second call")
        ref["p3m"] = acc

        n2, g2 = PM15_GLOO_PM
        pos, mass = _uniform_cloud(n2, dev, 41)
        ref["slab"], ms, _, sent = _force_call(
            dev, ps.make_slab_resident_pm_force_fn(mesh, g2), pos, mass,
            box_size=C4_BOX)
        log(f"  slab-resident PM, {n2} on {g2}^3 (the gloo world's size): "
            f"{ms:.1f} ms, bytes a call {sent}")
        # the slab deposit of the same routed lanes on the card and on the
        # CPU (K13 against its plain version, IEEE cell indices)
        lanes = ps._route(pos, mass, g2, C4_BOX, g2, 1,
                          ps._bucket_cap(4.0, n2, 1), mesh.group("x"))[0]
        dep = {}
        for d in (dev, "cpu"):
            lane = lanes.to(d)
            i0, fr = td.cic_base(lane[:, :3], g2, C4_BOX)
            dep[d] = ps._slab_deposit(i0[:, 0], i0, fr, lane[:, 3], g2,
                                      g2).cpu()
        same = torch.equal(dep[dev], dep["cpu"])
        log(f"  the slab deposit of {lanes.shape[0]} routed lanes on "
            f"{g2 + 1} x {g2}^2, card against CPU: "
            f"{'bit-equal' if same else 'DIFFER'}; mass "
            f"{float(dep['cpu'].double().sum()):.1f} of "
            f"{float(mass.double().sum()):.1f}")
        check(same, "the slab deposit differs between CUDA and CPU")
        del lanes, dep
        ref["direct"] = _direct_run(dev, tnb.make_direct_force_fn())
        ref["example"] = distributed_simulation.simulate(
            torch.device(dev).type, PM15_EXAMPLE_STEPS)["counts"]
    finally:
        multihost.shutdown()
    check(not dist.is_initialized(), "the world of one did not end")
    return launches, ref


def pm15_rank(rank, world, store, work, device="cuda"):
    """One rank of phase 15(b) (spawned by :func:`pm_sharded_phase`): a
    gloo world of ``world`` ranks sharing the card.  Writes its results,
    launches and bytes to ``work/pm15_rank<rank>.pkl``."""
    import pickle

    import torch

    from orbitanalysis_tpu_torch import graft_entry
    from orbitanalysis_tpu_torch.examples import distributed_simulation
    from orbitanalysis_tpu_torch.models import pm_sharded as ps
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.parallel import (
        make_mesh,
        make_sharded_direct_force_fn,
        multihost,
    )

    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    multihost.initialize(f"file://{store}", world, rank, backend="gloo")
    out = dict(rank=rank, ms={}, bytes={})
    try:
        mesh = make_mesh({"x": world}, device=dev.type)
        n2, g2 = PM15_GLOO_PM
        pos, mass = _uniform_cloud(n2, dev, 41)
        acc, out["ms"]["slab"], _, out["bytes"]["slab"] = _force_call(
            dev, ps.make_slab_resident_pm_force_fn(mesh, g2), pos, mass,
            box_size=C4_BOX)
        out["slab"] = acc.cpu()
        n3, g3 = P3M_CHECK
        pos, mass = _uniform_cloud(n3, dev, 31)
        acc, out["ms"]["p3m"], _, out["bytes"]["p3m"] = _force_call(
            dev, ps.make_slab_resident_pm_force_fn(
                mesh, g3, deconvolve=True, p3m_sigma_cells=1.5),
            pos, mass, box_size=C4_BOX, softening=0.05)
        out["p3m"] = acc.cpu()
        del pos, mass, acc
        out["direct"] = _direct_run(dev, make_sharded_direct_force_fn(
            make_mesh({"particles": world}, device=dev.type)))
        ex = distributed_simulation.simulate(dev.type, PM15_EXAMPLE_STEPS)
        out["example"], out["example_finite"] = ex["counts"], ex["finite"]
        graft_entry.dryrun_multichip(world, device=dev.type)
        out["launches"] = _cuda.launch_counts()
    finally:
        multihost.shutdown()
    with open(os.path.join(work, f"pm15_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def pm_sharded_phase(dev, work, smi):
    """Phase 15: the distributed PM on the card.  (a) an NCCL world of
    one in this process (:func:`pm15_world_of_one`); (b) a gloo world of
    RANKS spawned ranks sharing the card: the slab-resident PM and P3M
    equal to the world of one's, the sharded direct integrator's counts
    equal to ``direct_forces``'s, the distributed example's counts equal
    to its world-of-one run, and the dry run.  Returns the launches of
    both."""
    import multiprocessing
    import pickle

    import torch

    t_phase = time.perf_counter()
    launches, ref = pm15_world_of_one(dev, work)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    ctx_mp = multiprocessing.get_context("spawn")
    store = os.path.join(work, "pm15_gloo_store")
    procs = [ctx_mp.Process(target=pm15_rank,
                            args=(r, RANKS, store, work,
                                  torch.device(dev).type))
             for r in range(RANKS)]
    t0 = time.perf_counter()
    for pr in procs:
        pr.start()
    try:
        for pr in procs:
            pr.join(timeout=max(1.0, RANK_TIMEOUT
                                - (time.perf_counter() - t0)))
    finally:
        hung = [pr for pr in procs if pr.is_alive()]
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join()
    check(not hung, f"{len(hung)} rank(s) still running after "
          f"{RANK_TIMEOUT} s")
    for r, pr in enumerate(procs):
        check(pr.exitcode == 0, f"rank {r} failed (exit {pr.exitcode})")
    outs = []
    for r in range(RANKS):
        with open(os.path.join(work, f"pm15_rank{r}.pkl"), "rb") as f:
            outs.append(pickle.load(f))  # written by this run's ranks
    log(f"  gloo world of {RANKS} ranks on one card: "
        f"{time.perf_counter() - t0:.1f} s from spawn to exit")
    for key, what, tol in (("slab", f"slab-resident PM {PM15_GLOO_PM}",
                            PM15_SLAB_TOL),
                           ("p3m", f"distributed P3M {P3M_CHECK}",
                            PM15_TOL)):
        want = ref[key].cpu()
        for o in outs:
            err, top = _max_err(o[key], want)
            nan = int(torch.isnan(o[key]).sum())
            log(f"    rank {o['rank']} {what}: max error {err / top:.3e} of "
                f"the world of one's max |ref| (limit {tol}), NaN {nan}; "
                f"{o['ms'][key]:.1f} ms, bytes a call {o['bytes'][key]}")
            check(nan == 0 and err <= tol * top,
                  f"rank {o['rank']}: {what} differs from the world of one")
    n_d = PM15_DIRECT[0]
    for o in outs:
        diff = int((o["direct"] != ref["direct"]).sum())
        log(f"    rank {o['rank']}: the sharded direct integrator, {n_d} "
            f"particles, {PM15_DIRECT[1]} steps: {int(o['direct'].sum())} "
            f"apsides, {diff} particles' counts differ from direct_forces'")
        check(diff == 0 and int(o["direct"].sum()) > 0,
              f"rank {o['rank']}: the sharded direct counts differ")
        diff = int((o["example"] != ref["example"]).sum())
        log(f"    rank {o['rank']}: the distributed example "
            f"({PM15_EXAMPLE_STEPS} steps): {int(o['example'].sum())} "
            f"passages, positions finite {bool(o['example_finite'])}, "
            f"{diff} particles' counts differ from its world-of-one run")
        check(bool(o["example_finite"]) and diff == 0,
              f"rank {o['rank']}: the distributed example differs")
    log(f"  {smi}: bytes a rank a force evaluation by collective are on "
        "the lines above (two ranks on one card over the host: not the "
        "speed of a multi-GPU node); graft_entry.dryrun_multichip(2) "
        "completed on both ranks")
    log(f"  launches: world of one {launch_diff(launches)}; a rank (the dry "
        f"run's steps) {[launch_diff(o['launches']) for o in outs]}")
    for o in outs:
        for name, k in o["launches"].items():
            launches[name] += k
    log(f"  phase 15: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------- phase 16

#: phase 16: the probes at the JAX scripts' defaults (dma_probe.py's plane
#: rows; detect_probe.py's halos, slots and snapshots)
PROBE_ROWS = 2048
PROBE_DETECT = (64, 32768, 12)
#: the ``dma_probe`` variant whose times stand in a P kernel's line: the
#: JAX function's default parameters (auto_variant(8), manual_variant(16,
#: 4), split_variant(32, 4, 1))
PROBE_DEFAULTS = {"stream_add_rows": "auto8", "stream_add_ring": "man16x4",
                  "stream_add_split": "split32x4"}
#: kernels with K9's streams or the label path's, whose stream floor is
#: P4's rate (the others' is the best rate of P1-P3)
DETECT_STREAMS = ("frame_rows", "segment_moments",
                  "detect_label_compact_rows", "detect_label_rows",
                  "fused_label_rows", "detect_stream_rows")


def probe_phase(dev, timings):
    """Phase 16: the probes' entry points at the JAX defaults (counted:
    P1-P3 through every ``dma_probe`` variant, P4 through
    ``detect_probe``'s ``stream`` scan); then each probe kernel bit-equal
    to its plain version on seeded planes of those shapes, timed into
    ``timings``; then every byte-bound kernel's stream floor, its bound's
    bytes at the measured rate.  Returns the launches and the floors
    (ms, None for a kernel bound by operations)."""
    import torch

    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.probes import detect_probe, dma_probe

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    _cuda.reset_launch_counts()
    dma = dma_probe.main(rows=PROBE_ROWS)
    det = detect_probe.main(*PROBE_DETECT)
    torch.cuda.synchronize()
    launches = _cuda.launch_counts()
    log(f"  launches: {launch_diff(launches)}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for what, rows in (("the plane", PROBE_ROWS),
                       ("a pallas5 plane", PROBE_ROWS // 5)):
        n_vecs = rows * dma_probe.LANES // 4
        grid, threads, per_sm = _cuda.rows_launch(n_vecs, dev)
        log(f"  stream_add_rows on {what} ({n_vecs} vectors): {grid} blocks "
            f"of {threads} threads ({per_sm} an SM x {n_sm} SMs)")
    for name in ("split32x4", "dual32x4", "quad64x2"):
        p = dma_probe.VARIANTS[name]().params
        stage = p["chunk_rows"] * dma_probe.STAGE_ROW_BYTES
        grid, per_sm = _cuda.split_plan(PROBE_ROWS * dma_probe.LANES * 4,
                                        stage, p["n_buf"], n_sm)
        log(f"  stream_add_split {name}: {grid} blocks ({per_sm} an SM), "
            f"rings 2 x {p['n_buf']} x {stage} B")
    n_bytes = PROBE_ROWS * dma_probe.LANES * 4
    for name in (n for n in dma_probe.VARIANTS if n.startswith("man")):
        p = dma_probe.VARIANTS[name]().params
        stage = p["chunk_rows"] * dma_probe.STAGE_ROW_BYTES
        grid, per_sm = _cuda.ring_plan(n_bytes, stage, p["n_buf"], n_sm)
        threads, calc = _cuda.ring_geometry(stage, p["n_buf"], dev)
        log(f"  stream_add_ring {name}: {grid} blocks of {threads} threads "
            f"({per_sm} an SM; the occupancy calculator {calc}), rings "
            f"{p['n_buf']} x {stage} B, {per_sm * p['n_buf'] * stage} B of "
            "loads in flight an SM at most")
        check(calc == per_sm, f"stream_add_ring {name}: ring_plan gives "
              f"{per_sm} blocks an SM, the calculator {calc}")
    for name, r in dma.items():
        fn = dma_probe.VARIANTS[name]()
        if fn.kernel in ("stream_add_rows", "stream_add_ring",
                         "stream_add_split"):
            ref = "xla5" if fn.n_planes else "xla"
            log(f"  {name} ({fn.kernel}): {r['ms']:.4f} ms over torch's "
                f"{ref} on the same planes {dma[ref]['ms']:.4f} ms = "
                f"{r['ms'] / dma[ref]['ms']:.3f} x")

    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn((PROBE_ROWS, dma_probe.LANES), generator=gen,
                    device=dev)
    worst = dict.fromkeys(PROBE_DEFAULTS, 0.0)
    for name in dma_probe.VARIANTS:
        fn = dma_probe.VARIANTS[name]()
        kernel = fn.kernel
        if kernel is None:
            continue
        xin = dma_probe.variant_input(fn, x)
        got = fn(xin)
        pairs = list(zip(xin, got)) if fn.n_planes else [(xin, got)]
        for p, g in pairs:
            want = dma_probe.stream_add_torch(p)
            torch.cuda.synchronize()
            worst[kernel] = max(worst[kernel], float((g - want).abs().max()))
            check(torch.equal(g.view(torch.int32), want.view(torch.int32)),
                  f"{name} ({kernel}) differs from x + 1")
        log(f"  {name} ({kernel}) on {len(pairs)} plane(s) of "
            f"{tuple(pairs[0][0].shape)}: bit-equal to x + 1 on every row")
    # how P2's blocks end: each block's start and end on the card's clock
    p = dma_probe.VARIANTS[PROBE_DEFAULTS["stream_add_ring"]]().params
    for _ in range(2):
        _, clock = _cuda.stream_add_ring_on(
            x, p["chunk_rows"] * dma_probe.STAGE_ROW_BYTES, p["n_buf"],
            clock=True)
        c = (clock - clock[:, 0].min()).double().cpu() / 1e3
        end = c[:, 1]
        log(f"  stream_add_ring man16x4 block clocks: {len(c)} blocks, span "
            f"{float(end.max()):.2f} us, starts within "
            f"{float(c[:, 0].max()):.2f} us, ends "
            f"{float(end.min()):.2f}-{float(end.max()):.2f} us (spread "
            f"{float(end.max() - end.min()):.2f} us, median "
            f"{float(end.median()):.2f} us)")
    results = {}
    for kernel, name in PROBE_DEFAULTS.items():
        fn = dma_probe.VARIANTS[name]()
        b_ms, b_by = bound(dma_probe.moved_bytes(x), x.numel())
        results[kernel] = dict(
            max_abs_err=worst[kernel], ms=cuda_ms(lambda: fn(x)),
            plain_ms=cuda_ms(lambda: dma_probe.stream_add_torch(x)),
            library_ms=cuda_ms(lambda: torch.add(x, 1.0)),
            bound_ms=b_ms, bound_by=b_by)
    del x

    # P4 on planes of detect_probe's shapes: sv and pk over the whole
    # int32 range (sv + lab wraps), labels -1 to 63
    h, cap, _ = PROBE_DETECT
    w = detect_probe.ROW_WIDTH
    r = h * cap // w

    def normal(*shape):
        return 50.0 * torch.randn(shape, generator=gen, device=dev)

    def words(lo, hi):
        return torch.randint(lo, hi, (r, w), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    planes = (normal(6, r, w), words(-1, 64), normal(3, r, w),
              normal(3, r, w), words(-2**31, 2**31), normal(3, r, w),
              words(-2**31, 2**31))
    got = detect_probe.detect_stream(*planes)
    want = detect_probe.detect_stream_torch(*planes)
    torch.cuda.synchronize()
    ne = sum(int((g.view(torch.int32) != v.view(torch.int32)).sum())
             for g, v in zip(got, want))
    log(f"  detect_stream_rows [{r}, {w}]: lanes that differ from the plain "
        f"version (sv', r-hat, packed, payload, counts) {ne}")
    check(ne == 0 and all(g.shape == v.shape for g, v in zip(got, want)),
          "detect_stream_rows differs from its plain version")
    n = r * w
    b_ms, b_by = bound(detect_probe.PARTICLE_BYTES * n + 4 * r, 9 * n)
    results["detect_stream_rows"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(lambda: detect_probe.detect_stream(*planes)),
        plain_ms=cuda_ms(lambda: detect_probe.detect_stream_torch(*planes)),
        library_ms=None, bound_ms=b_ms, bound_by=b_by)
    del planes, got, want
    log_timings(results)
    timings.update(results)

    lib = max(v["gbps"] for k, v in dma.items() if k.startswith("xla"))
    best_name, best = max(((k, v["gbps"]) for k, v in dma.items()
                           if not k.startswith("xla")), key=lambda t: t[1])
    p4 = det["stream"]["gbps"]
    log(f"  measured rates: P1-P3 best {best:.1f} GB/s ({best_name}), "
        f"torch x + 1 {lib:.1f} GB/s, P4 {p4:.1f} GB/s, K9 on the same "
        f"streams {det['full']['gbps']:.1f} GB/s ({det['full']['ms']:.4f} "
        f"ms a snapshot); data sheet {PEAK_BYTES / 1e9:.1f} GB/s")
    floors = {}
    for name, t in timings.items():
        if t["bound_by"] != "bytes":
            floors[name] = None
            log(f"  stream floor {name}: bound by operations, none")
            continue
        nbytes = t["bound_ms"] * 1e-3 * PEAK_BYTES
        rate = p4 if name in DETECT_STREAMS else best
        floors[name] = floor = nbytes / rate / 1e6
        log(f"  stream floor {name}: {nbytes:.0f} B at {rate:.1f} GB/s = "
            f"{floor:.4f} ms (bound {t['bound_ms']:.4f} ms); kernel "
            f"{t['ms']:.4f} ms = {t['ms'] / floor:.3f} x the floor")
    log(f"  phase 16: {time.perf_counter() - t_phase:.1f} s")
    return launches, floors


def log_excess(kernels, floors):
    """Each kernel's launches in this run x its time above its stream
    floor (above its bound where it has none), largest first, beside the
    same product against the bound."""
    rows = []
    for k in kernels:
        floor = floors[k["name"]]
        ref = k["bound_ms"] if floor is None else floor
        rows.append((k["launches"] * (k["ms"] - ref), ref, k))
    log("  launches x (ms - stream floor), the whole run's launches, "
        "largest first (operations-bound kernels against their bound):")
    for excess, ref, k in sorted(rows, key=lambda t: -t[0]):
        log(f"    {k['name']}: {k['launches']} x ({k['ms']:.4f} - "
            f"{ref:.4f}) = {excess:.3f} ms; against the bound "
            f"{k['launches'] * (k['ms'] - k['bound_ms']):.3f} ms")


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
    import shutil
    import tempfile

    rank_dir = tempfile.mkdtemp(prefix="orbit_smoke_ranks_")
    try:
        return _phases(dev, rank_dir, smi)
    finally:
        shutil.rmtree(rank_dir, ignore_errors=True)


def _phases(dev, rank_dir, smi):
    import torch

    from orbitanalysis_tpu_torch.ops import _cuda

    work, seq = bench_workloads(dev, rank_dir)
    log("== phase 3: kernels against their plain-torch versions")
    timings = kernel_checks(dev)
    timings.update(label_kernel_checks(dev, work))
    timings.update(sorted_kernel_checks(dev, seq))
    timings.update(force_kernel_checks(dev))
    timings.update(aligned_chain_checks(dev))
    log_timings(timings)
    log(f"== phase 4: aligned step parity, CUDA vs CPU, {PARITY[:2]}")
    step_parity(dev)
    log("== phase 5: the aligned main path end to end at config-2 scale")
    launches, ctx = end_to_end(dev)
    log(f"== phase 6: label step parity, CUDA vs CPU, "
        f"[{LABEL_PARITY[0]}, {LABEL_ROW}] x {LABEL_PARITY[1]} snapshots")
    label_parity(dev, work)
    log("== phase 7: the label-native main path at full width")
    label_launches, label_keys = label_full_width(dev, work)
    del work
    log("== phase 8: the sorted engine at full width (the benchmark's "
        "merge-join and static cells)")
    sorted_launches, sorted_keys = sorted_full_width(dev, seq)
    log("== phase 9: track_orbits(join_impl='sorted') at config-2 scale")
    e2e_sorted = sorted_end_to_end(dev, ctx)
    log("== phase 9b: the rest of the reference workflow at config-2 scale "
        "(mode='both', Apsides, OrbitDecomposition, progenitors, "
        "on-the-fly pair, RegionExtractor)")
    post_launches = postprocess_phase(dev, ctx)
    log("== phase 10: the aligned engine on the benchmark's churn sequence "
        "(scan_events_aligned per step and batched, detect_impl='pallas', "
        "legacy step)")
    aligned_launches, k5_err = aligned_full_width(dev, seq)
    timings["compact_payload_rows"]["max_abs_err"] = max(
        timings["compact_payload_rows"]["max_abs_err"], k5_err)
    # the earlier phases' workloads go before the 33.5M run (phase 14
    # reads phase 5's host snapshots and catalogs)
    del seq
    torch.cuda.empty_cache()
    log("== phase 11: config-4 oracle, Kepler ensemble under point-mass "
        "forces, on the card and on the CPU")
    oracle_launches = c4_oracle(dev)
    log("== phase 12: config-4 scale, PM forces through K13 (12.6M / 256^3, "
        "33.5M / 512^3, CUDA-vs-CPU parity at 1M / 128^3)")
    scale_launches = c4_scale(dev)
    log("== phase 13: direct summation through K14 at N = 131072, and P3M")
    direct_launches = direct_phase(dev)
    log("== phase 14: the distributed engines on the card: an NCCL world of "
        f"one, then a gloo world of {RANKS} ranks sharing it")
    sharded_launches = sharded_phase(
        dev, ctx, rank_dir, dict(label=label_keys, sorted=sorted_keys), smi)
    log("== phase 15: the distributed PM (models/pm_sharded.py): an NCCL "
        f"world of one at 12.6M / 256^3, then a gloo world of {RANKS} ranks")
    pm_launches = pm_sharded_phase(dev, rank_dir, smi)
    log("== phase 16: the stream probes (P1-P4) at the JAX scripts' "
        "defaults, and the stream floor of every byte-bound kernel")
    probe_launches, floors = probe_phase(dev, timings)
    kernels = []
    for name, k in _cuda.KERNELS.items():
        n = (launches[name] + label_launches[name] + sorted_launches[name]
             + e2e_sorted[name] + post_launches[name]
             + aligned_launches[name]
             + oracle_launches[name] + scale_launches[name]
             + direct_launches[name] + sharded_launches[name]
             + pm_launches[name] + probe_launches[name])
        r = timings[name]
        kernels.append(dict(
            name=name, route=k.route, source=k.source, replaces=k.replaces,
            launches=n, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
        ))
        check(n > 0, f"{name} was not launched by a main path")
    log_excess(kernels, floors)
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
