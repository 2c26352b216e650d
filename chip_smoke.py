#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (orbitanalysis_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or /usr/local/cuda) and the
repository checkout; it imports nothing of JAX.  Phases:

1. environment: versions, and the card's name and power limit;
2. build: nvcc compiles csrc/compact.cu for sm_90a (and g++ the native
   host packer);
3. each CUDA kernel against its plain-torch twin on the card, at the
   shapes the main path gives it (exact match), with timings;
4. step parity: 8 churning snapshots at [64, 32768], the aligned step on
   CUDA against the same step on the CPU;
5. end to end at config-2 scale (100 halos, ~1e6 tracked particles,
   periodic box, Hubble term): ``track_orbits(device='cuda')`` under
   ``join_impl='auto'`` must pick the aligned engine, match the general
   engine run on the card and the NumPy oracle, and launch the
   compaction kernel once per aligned step; a wide-row run (one halo
   past 131071 members) drives the pair kernel the same way.

Any failed check exits non-zero without printing the result lines.  The
last two lines are the kernels' JSON record and the device JSON line.
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


#: Event angles of the CUDA and the CPU step agree to one f16 ulp, or to
#: ANGLE_ATOL rad where one f16 ulp is finer than f32 arccos resolves:
#: torch's CUDA sqrt differs from the CPU's in the last bit now and then,
#: so cos(dtheta) can differ by a few f32 ulps, and near cos = 1 the
#: arccos of cosines d apart differs by up to sqrt(2 d) (1e-3 rad for
#: 8 ulps of 2**-24).
ANGLE_ATOL = 2e-3


def f16_ulps(a, b):
    """(f16 ulps apart, absolute difference) of two f32 angle arrays."""
    ia = a.astype(np.float16).view(np.int16).astype(np.int32)
    ib = b.astype(np.float16).view(np.int16).astype(np.int32)
    return np.abs(ia - ib), np.abs(a.astype(np.float64) - b)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, runs=25, warmup=3):
    """Median device milliseconds of ``fn()`` over ``runs`` launches
    (CUDA events around each call, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
            results["compact_angle_rows"] = dict(
                ms=cuda_ms(lambda: compact.compact_angle_blocked(x, k)),
                plain_ms=cuda_ms(
                    lambda: compact.compact_angle_blocked_torch(x, k)),
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
    results["compact_pair_rows"] = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: compact.compact_payload_pair(pw, aw2, k)),
        plain_ms=cuda_ms(
            lambda: compact.compact_payload_pair_torch(pw, aw2, k)),
    )
    for name, r in results.items():
        log(f"  {name}: kernel {r['ms']:.4f} ms, plain torch "
            f"{r['plain_ms']:.4f} ms (median of 25, CUDA events)")
    return results


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
        check(np.all((ulps <= 1) | (diff <= ANGLE_ATOL)),
              f"step {s}: event angles differ by {diff.max(initial=0):.3g} rad")
        total += int(count.sum())
        log(f"  snapshot {s}: {int(count.sum())} events, counts/positions "
            f"equal, {int((ulps > 1).sum())} angles beyond one f16 ulp "
            f"(max |diff| {diff.max(initial=0):.3g} rad)")
    check(total > 0, "step parity produced no events")
    log(f"  {total} events: {beyond} angles beyond one f16 ulp, all within "
        f"{ANGLE_ATOL} rad (max {worst:.3g})")
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
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)},"
        f" count {torch.cuda.device_count()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("== phase 2: build")
    t0 = time.perf_counter()
    nvcc_s = _cuda.build()
    log(f"  nvcc compact.cu -> {os.path.basename(_cuda.library_path())}: "
        f"{nvcc_s:.2f} s ({time.perf_counter() - t0:.2f} s with the check)")
    t0 = time.perf_counter()
    tier = native.tier()
    log(f"  host packing tier: {tier} ({time.perf_counter() - t0:.2f} s)")
    log("== phase 3: kernels against their plain-torch twins")
    timings = kernel_checks(dev)
    log(f"== phase 4: aligned step parity, CUDA vs CPU, {PARITY[:2]}")
    step_parity(dev)
    log("== phase 5: end to end at config-2 scale")
    launches = end_to_end(dev)
    kernels = []
    for name, k in _cuda.KERNELS.items():
        kernels.append(dict(
            name=name, route=k.route, source=k.source, replaces=k.replaces,
            launches=launches[name], max_abs_err=timings[name]["max_abs_err"],
            ms=timings[name]["ms"], plain_ms=timings[name]["plain_ms"],
        ))
        check(launches[name] > 0, f"{name} was not launched by the main path")
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
