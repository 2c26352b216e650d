"""Device time of K1/K2 (the angle-word compaction), K4/K5 (the payload
compaction), K8 (the label detect with its compaction), K10 (the fused
label detect), K13 (the sorted CIC deposit), K14 (the blocked direct
forces), K15 (the merge of presorted rows), K16 (the fused join-detect)
and K17 (the aligned static detect) of one checkout, measured by that
checkout's own ``chip_smoke.py`` checks.

K1 runs on phase 3's angle-word plane (``[64, 32768]``, 1.7 % events,
K = 2048, the same draws, the f16 clamp lanes in row 0); K15 on phase
3's input, the six-channel merge of sorted churn step 2 of the unfused
route (the bench's first three snapshots at [64, 32768]).
K4 runs on phase 3's payload plane (``[64, 32768]``, 1.7 % events,
K = 2048, the same draws) and on the payload plane the label step's
detect pass writes for snapshot 3 of the bench's label sequence; K8 and
K10 on phase 3's inputs (that snapshot, the label route's 64 halos on
rows of 32768, packed r-hat), K10 also with its labels spread over 512
halos, the most the JAX one-hot budget lets that row width have (the
table repeated, so every output keeps its bits); K13 on the sorted
streams of the first force evaluations of config 4's two runs (12.6M
particles on 256^3, 33.5M on 512^3; ``chip_smoke._k13_check``); K14 at
N = 16384 and 131072, free and periodic (``chip_smoke._k14_check``);
K16 and K17 on phase 3's inputs (the bench's first three snapshots at
[64, 32768], K = 2048, recorded at step 2: K16 of the sorted churn step,
K17 of the aligned churn step, native, and of the legacy aligned static
step).  K19 (not in the default set) runs on phase 3's inputs, sorted
churn step 2 of the unfused routes: group a of six channels (merge by
sort) and of one (merge by K15).  K18 (not in the default set either)
runs on phase 3's input, the event compaction's arguments at step 2 of
the bench's static sequence staged ID-sorted.  K1, K4, K8, K15, K16, K17,
K18 and K19 are checked bit for bit against their plain versions and
against a second call, and their device time is split by CUDA kernel
(torch.profiler).
``STEPS`` (not in the default set) runs phases 8 and 10's step timings
on the bench's churn sequence through the checkout's own
``chip_smoke.time_scan``, which prints them: wall, device span and busy
ms a step, the host's ms to issue one, kernels a step, idle share; the
unfused sorted route (K15 + K19) on phase 8's first 12 snapshots and
the sorted step on the 12 static snapshots (K16, then K18) too.
``P1``, ``P2`` and ``P3`` (not in the default set) time every
``dma_probe`` variant of the stream probe P1 (``auto8``, ``auto32``,
``pallas5``), P2 (the seven ``man*``) or P3 (``split32x4``,
``dual32x4``, ``quad64x2``) and torch's ``x + 1`` on
the same planes (``xla``, and ``xla5`` for ``pallas5``'s five) on one
seeded ``[2048, 65536]`` f32 plane, each variant checked bit for bit
against ``x + 1``, through the checkout's own ``probes/dma_probe.py``.
``LABEL_STEPS`` (not in the default set either) runs phase 7's label
step timings (``'split'``, ``'fused'``, ``'pallas'``) on the bench's
label sequence through the checkout's own
``chip_smoke.time_label_step``, which prints them.
``COMPACT`` (not in the default set) times K3 at ``[4, 262144]`` and
``[1, 1 << 19]`` (``K3_wide``) and K18 with every lane an event
(``K18_full``) on seeded synthetic words (:func:`compact_times`).
Each is checked against its plain version as ``chip_smoke.py`` checks it.
Prints one JSON line of milliseconds, with a digest of K14's forces at
N = 16384 so that two builds can be compared bit for bit.  Two checkouts
are compared on one card by running it in each, in the order A, B, B, A:

    python3 kernel_ab.py PATH_TO_CHECKOUT_A old [K1,K4,K8,K10,...]
    python3 kernel_ab.py . new [K1,K4,K8,K10,...]

The third argument picks the kernels (K1, K4, K8, K10, K13, K14, K15,
K16 and K17 by default).  The checkout's ``chip_smoke.py`` must have
``_k13_check``, ``_k14_check`` and ``time_label_step``.  It needs a
CUDA card and builds the checkout's kernels at first use.
"""
import hashlib
import json
import os
import sys


def label_work(cs, dev, n_snap=4):
    """The first ``n_snap`` snapshots of the bench's label sequence on the
    card (the generator makes them as it makes the first of 48)."""
    import torch

    from orbitanalysis_tpu_torch.models.synthetic import label_churn_workload

    h, p, s_n = cs.LABEL
    lab, pos, vel, cen, n_valid = label_churn_workload(h, p, s_n, seed=0,
                                                       churn=0.07)
    return dict(label=torch.from_numpy(lab[:n_snap]).to(dev),
                pos=torch.from_numpy(pos[:n_snap]).to(dev),
                vel=torch.from_numpy(vel[:n_snap]).to(dev),
                centers=torch.from_numpy(cen[:n_snap]).to(dev),
                n_valid=n_valid)


def k10_times(cs, dev, label_args):
    """K10's milliseconds at 64 halos (phase 3's inputs) and with the
    labels spread over 512 halos, each bit-equal to the plain version
    and with the same events."""
    import torch

    from orbitanalysis_tpu_torch.ops import label

    args, table = label_args
    kw = dict(pericentric=True, box_size=cs.LABEL_BOX, rhat_packed=True)
    lab, sv = args[1], args[4]
    h0 = table.shape[0]
    cs.check(int(lab.max()) < h0, "labels past the table")
    spread = torch.arange(lab.numel(), device=dev).reshape(lab.shape)
    prev = (sv & 0x0FFFFFFF) - 1
    out, counts = {}, None
    for h in (h0, 512):
        # label l becomes l * f + (position mod f), in the carry's lab_sv
        # too, so the same lanes match and every frame keeps its bits
        f = h // h0
        tab = table.repeat_interleave(f, dim=0)
        lab_h = torch.where(lab >= 0, lab * f + spread % f, lab).int()
        sv_h = torch.where(prev >= 0, (prev * f + spread % f + 1)
                           | (sv & ~0x0FFFFFFF), sv).int()
        run_args = [lab_h, *args[2:4], sv_h, *args[5:]]
        got = label.fused_label_detect(tab, *run_args, 0.0, **kw)
        want = label.fused_label_detect_torch(tab, *run_args, 0.0, **kw)
        ne, _ = cs._bitwise(got, want)
        cs.check(ne == 0, f"fused_label_rows at {h} halos differs from "
                 "its plain version")
        counts = want[4] if counts is None else counts
        cs.check(torch.equal(want[4], counts) and int(counts.sum()) > 0,
                 f"{h} halos change the events")
        out[f"K10_H{h}"] = cs.cuda_ms(
            lambda: label.fused_label_detect(tab, *run_args, 0.0, **kw))
    return out


def kernel_split(fn, reps=20):
    """Device ms a call of ``fn`` spends in each CUDA kernel (and
    memset) it launches, by torch.profiler over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            out[e.key[:60]] = t / 1e3 / reps
    return out


def checked_times(cs, tag, fn, plain):
    """``fn``'s milliseconds, after checking it bit for bit against its
    plain version and against a second call, with the split of its
    device time by CUDA kernel."""
    got, want = fn(), plain()
    ne, _ = cs._bitwise(got, want)
    cs.check(ne == 0, f"{tag} differs from its plain version")
    ne, _ = cs._bitwise(fn(), got)
    cs.check(ne == 0, f"{tag} gives other bits on a second call")
    return {tag: cs.cuda_ms(fn), f"{tag}_split": kernel_split(fn)}


def k1_plane(cs, dev):
    """Phase 3's timed K1 input: the angle words ``chip_smoke.py`` draws
    for its density 0.017 (after those of density 0), and K."""
    import numpy as np
    import torch

    h, p, k = cs.ANGLE_ROWS
    rng = np.random.default_rng(1)
    for density in (0.0, 0.017):
        ang = rng.uniform(0, 7, (h, p)).astype(np.float32)
        sel = rng.random((h, p)) < density
    ang[0, :4] = [65504.0, 65519.0, 65520.0, 1e30]  # clamp lanes
    sel[0, :4] = True
    aw = ang.view(np.uint32) | (sel.astype(np.uint32) << np.uint32(31))
    return torch.from_numpy(aw.view(np.int32)).to(dev), k


def k1_times(cs, dev):
    """K1 on phase 3's angle words, bit for bit."""
    from orbitanalysis_tpu_torch.ops import compact

    x, k = k1_plane(cs, dev)
    out = checked_times(cs, "K1", lambda: (compact.compact_angle_blocked(x, k),),
                        lambda: (compact.compact_angle_blocked_torch(x, k),))
    out["K1_events"] = int((x < 0).sum())
    return out


def k4_times(cs, dev, label_args):
    """K4 on phase 3's payload plane (the draws ``chip_smoke.py`` makes
    for its densities 0 and 0.017, the second timed) and on the payload
    plane of the detect pass of snapshot 3 (K9's output on phase 3's K8
    inputs)."""
    import numpy as np
    import torch

    from orbitanalysis_tpu_torch.ops import compact, label

    r, w, k = cs.LABEL[0], cs.LABEL_ROW, cs.LABEL_K
    rng = np.random.default_rng(4)
    pos1 = np.arange(1, w + 1, dtype=np.uint32)
    for density in (0.0, 0.017):
        sel = rng.random((r, w)) < density
        ang = rng.integers(0, 0x7BFF, (r, w)).astype(np.uint32)
    pay = np.where(sel, (pos1 << np.uint32(15)) | ang, np.uint32(0))
    planes = {"K4": torch.from_numpy(pay.view(np.int32)).to(dev)}
    args, _ = label_args
    planes["K4_label"] = label.detect_label(
        *args, 0.0, pericentric=True, box_size=cs.LABEL_BOX,
        rhat_packed=True)[3]
    out = {}
    for tag, x in planes.items():
        out.update(checked_times(
            cs, tag, lambda x=x: (compact.compact_payload(x, k),),
            lambda x=x: (compact.compact_payload_torch(x, k),)))
        out[f"{tag}_events"] = int(((x >> 15) != 0).sum())
    return out


def k8_times(cs, dev, label_args):
    """K8 on phase 3's inputs, every output bit for bit."""
    from orbitanalysis_tpu_torch.ops import label

    args, _ = label_args
    kw = dict(event_capacity=cs.LABEL_K, pericentric=True,
              box_size=cs.LABEL_BOX, rhat_packed=True)
    out = checked_times(
        cs, "K8", lambda: label.detect_label_compact(*args, 0.0, **kw),
        lambda: label.detect_label_compact_torch(*args, 0.0, **kw))
    out["K8_events"] = int(
        label.detect_label_compact_torch(*args, 0.0, **kw)[4].sum())
    return out


def label_step_times(cs, dev):
    """Phase 7's label step timings on the bench's label sequence (48
    snapshots of [64, 32768]): ``'split'`` (K7, K6, K8), ``'fused'``
    (K7, K10, K5) and ``'pallas'`` (K12, K11, the plain chain, K5)."""
    work = label_work(cs, dev, cs.LABEL[2])
    for frames, what in (("auto", "'split': K7 -> K6 -> K8"),
                         ("fused", "K7 -> K10 -> K5"),
                         ("pallas", "K12 -> K11 -> plain chain -> K5")):
        cs.time_label_step(dev, work, frames, what)


def sorted_stack(dev, churn):
    """A churn workload staged ID-sorted on the card, as phase 8 stages
    it."""
    import torch

    from orbitanalysis_tpu_torch.ops import sorted_step as tss
    from orbitanalysis_tpu_torch.ops.apsis import SnapshotBatch

    ids, pos, vel, cen, _ = churn
    b = tss.presort_snapshot(SnapshotBatch(ids=ids, pos=pos, vel=vel,
                                           center=cen), soa=True)
    return SnapshotBatch(**{f: torch.from_numpy(getattr(b, f)).to(dev)
                            for f in ("ids", "pos", "vel", "center",
                                      "slot")})


def churn_head(cs, dev):
    """The bench's first three churn snapshots, staged ID-sorted on the
    card (the generator makes them as it makes the first three of 48)."""
    from orbitanalysis_tpu_torch.models.synthetic import churn_workload

    h, p = cs.LABEL[:2]
    return sorted_stack(dev, churn_workload(h, p, 3, seed=0, churn=0.07))


def k15_args(cs, dev):
    """Phase 3's K15 input: the merge's arguments at sorted churn step 2
    of the unfused route (``merge_impl='pallas'``)."""
    from orbitanalysis_tpu_torch.ops import sorted_step as tss

    return cs.staged_call(dev, churn_head(cs, dev), tss, "merge_rows",
                          merge_impl="pallas", compact_impl="pallas")


def k19_args(cs, dev):
    """Phase 3's K19 inputs: the compaction's arguments at sorted churn
    step 2 of the unfused routes, by tag: ``K19`` with group a's six
    channels (merge by sort, the timed one) and ``K19_1ch`` with one
    (merge by K15, the route ``STEPS`` times)."""
    from orbitanalysis_tpu_torch.ops import sorted_step as tss

    stack = churn_head(cs, dev)
    return {tag: cs.staged_call(dev, stack, tss, "compact_rows",
                                merge_impl=merge_impl, compact_impl="pallas")
            for tag, merge_impl in (("K19", "lax_sort"),
                                    ("K19_1ch", "pallas"))}


def k19_times(cs, dev):
    """K19 on phase 3's inputs, every channel of both groups bit for
    bit."""
    from orbitanalysis_tpu_torch.ops import compact

    out = {}
    for tag, a in k19_args(cs, dev).items():
        out.update(checked_times(
            cs, tag, lambda a=a: sum(compact.compact_rows(*a), ()),
            lambda a=a: sum(compact.compact_rows_torch(*a), ())))
    return out


def k18_args(cs, dev):
    """Phase 3's K18 input: the event compaction's arguments at step 2 of
    the bench's static sequence (its first three snapshots, which the
    generator makes as it makes the first three of 12), staged
    ID-sorted."""
    from orbitanalysis_tpu_torch.models.synthetic import static_workload
    from orbitanalysis_tpu_torch.ops import sorted_step as tss

    h, p = cs.LABEL[:2]
    stack = sorted_stack(dev, static_workload(h, p, 3, seed=0))
    return cs.staged_call(dev, stack, tss, "compact_events", fused=True)


def k18_times(cs, dev):
    """K18 on phase 3's input, its three outputs bit for bit."""
    from orbitanalysis_tpu_torch.ops import compact

    a = k18_args(cs, dev)
    out = checked_times(cs, "K18", lambda: compact.compact_events(*a),
                        lambda: compact.compact_events_torch(*a))
    out["K18_events"] = int((a[0] < 0).sum())
    return out


#: K3's second shape: one halo at MAX_ALIGNED_CAPACITY, K = 16384.
WIDE_PAIR = (1, 1 << 19, 16384)


def compact_times(cs, dev):
    """``COMPACT``: K3 at ``chip_smoke.PAIR_ROWS`` (``[4, 262144]``) and
    on one halo of ``1 << 19`` (``K3_wide``), 3 % events each, and K18
    on ``[64, 32768]`` with every lane an event (``K18_full``: each
    row's k128 outputs full), each bit for bit against its plain
    version.  K3's words are the first draws of ``default_rng(1)``,
    ``K18_full``'s follow a K1 plane's draws from ``default_rng(2)``."""
    import numpy as np
    import torch

    from orbitanalysis_tpu_torch.ops import compact

    def words(x):
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)

    out = {}
    for tag, (h, p, k), seed in (("K3", cs.PAIR_ROWS, 1),
                                 ("K3_wide", WIDE_PAIR, 3)):
        rng = np.random.default_rng(seed)
        sel = rng.random((h, p)) < 0.03
        pw = words(np.where(sel, np.arange(p, dtype=np.uint32) + 1,
                            np.uint32(0)))
        aw = words(np.where(sel, rng.integers(0, 0x7BFF, (h, p)).astype(
            np.uint32), np.uint32(0)))
        out.update(checked_times(
            cs, tag, lambda pw=pw, aw=aw, k=k: compact.compact_payload_pair(
                pw, aw, k),
            lambda pw=pw, aw=aw, k=k: compact.compact_payload_pair_torch(
                pw, aw, k)))
    h, p, k = cs.ANGLE_ROWS
    rng = np.random.default_rng(2)
    rng.uniform(0, 7, (h, p)), rng.random((h, p))  # the K1 plane's draws
    key, sv = (words(rng.integers(0, 1 << 32, (h, p), dtype=np.uint64)
                     .astype(np.uint32)) for _ in range(2))
    full = words(rng.integers(0, 1 << 31, (h, p)).astype(np.uint32)
                 | np.uint32(1 << 31))
    out.update(checked_times(
        cs, "K18_full", lambda: compact.compact_events(full, key, sv, k),
        lambda: compact.compact_events_torch(full, key, sv, k)))
    return out


def k15_times(cs, dev):
    """K15 on phase 3's input, every channel bit for bit."""
    from orbitanalysis_tpu_torch.ops import merge

    a = k15_args(cs, dev)
    return checked_times(cs, "K15", lambda: merge.merge_rows(*a),
                         lambda: merge.merge_rows_torch(*a))


def detect_inputs(cs, dev):
    """Phase 3's K16 and K17 inputs: the arguments the steps pass at
    step 2 of the bench's sequences (their first three snapshots, which
    the generator makes as it makes the first three of 48)."""
    from orbitanalysis_tpu_torch.models.synthetic import (
        churn_workload,
        static_workload,
    )
    from orbitanalysis_tpu_torch.ops import sorted_step as tss
    from orbitanalysis_tpu_torch.ops import step as tstep

    h, p = cs.LABEL[:2]
    churn = churn_workload(h, p, 3, seed=0, churn=0.07)
    static = static_workload(h, p, 3, seed=0)
    stack = sorted_stack(dev, churn)
    k16 = cs.staged_call(dev, stack, tstep, "fused_join_detect", fused=True)
    k17 = []
    for form, make, init in (
            (churn, lambda: tss.make_aligned_native_step(
                cs.LABEL_K, box_size=cs.LABEL_BOX, soa_batch=True,
                detect_impl="pallas"),
             lambda d: tss.init_aligned_carry(h, p, device=d)),
            (static, lambda: tss.make_aligned_orbit_step(
                cs.LABEL_K, box_size=cs.LABEL_BOX, soa_batch=True),
             lambda d: tss.init_sorted_carry(h, p, device=d))):
        aligned = cs.stage_aligned(dev, form, 3)
        k17.append(cs.recorded_call(tstep, "fused_static_detect",
                                    lambda: cs.run_steps(dev, aligned, make,
                                                         init, 3)))
    return k16, k17


def detect_times(cs, dev, which):
    """K16's and K17's milliseconds on phase 3's inputs, each bit-equal
    to its plain version, with the split by CUDA kernel."""
    from orbitanalysis_tpu_torch.ops import step as tstep

    k16, k17 = detect_inputs(cs, dev)
    runs = []
    if "K16" in which:
        runs.append(("K16", lambda: tstep.fused_join_detect(*k16),
                     lambda: tstep.fused_join_detect_torch(*k16)))
    if "K17" in which:
        for tag, (a, kw) in zip(("K17_native", "K17_legacy"), k17):
            runs.append((tag,
                         lambda a=a, kw=kw: tstep.fused_static_detect(*a,
                                                                      **kw),
                         lambda a=a, kw=kw: tstep.fused_static_detect_torch(
                             *a, **kw)))
    out = {}
    for tag, fn, plain in runs:
        out.update(checked_times(cs, tag, fn, plain))
        out[f"{tag}_events"] = int(plain()[4].sum())
    return out


def step_times(cs, dev):
    """Phases 8 and 10's step timings on the bench's churn sequence (48
    snapshots of [64, 32768]), through the checkout's own
    ``chip_smoke.time_scan``, which prints them: the fused sorted step
    (K16), the unfused sorted route (K15 + K19) on phase 8's first
    ``SORTED_CHECK`` snapshots, the fused sorted step on the static
    sequence's ``SORTED_CHECK`` snapshots (K16, then K18), and the
    aligned ``'xla'``, ``'pallas'`` (K17) and legacy (K17) steps."""
    from orbitanalysis_tpu_torch.models.synthetic import (
        churn_workload,
        static_workload,
    )
    from orbitanalysis_tpu_torch.ops import sorted_step as tss

    h, p, s_n = cs.LABEL
    churn = churn_workload(h, p, s_n, seed=0, churn=0.07)
    n_valid = churn[4]
    stack = sorted_stack(dev, churn)
    init = lambda d: tss.init_sorted_carry(h, p, device=d)  # noqa: E731
    kw = dict(box_size=cs.LABEL_BOX, cur_presorted=True, soa_batch=True)
    cs.time_scan(dev, stack, s_n, n_valid, "sorted step, churn (K16)",
                 tss.make_sorted_orbit_step(cs.LABEL_K, fused=True, **kw),
                 init)
    n_chk = cs.SORTED_CHECK
    head = stack._replace(**{f: getattr(stack, f)[:n_chk] for f in (
        "ids", "pos", "vel", "center", "slot")})
    cs.time_scan(dev, head, n_chk, n_valid,
                 "sorted step, unfused (K15 + K19)",
                 tss.make_sorted_orbit_step(cs.LABEL_K, merge_impl="pallas",
                                            compact_impl="pallas", **kw),
                 init)
    del stack, head
    static = static_workload(h, p, n_chk, seed=0)
    stack = sorted_stack(dev, static)
    cs.time_scan(dev, stack, n_chk, static[4],
                 "sorted step, static (K18 after the first step)",
                 tss.make_sorted_orbit_step(cs.LABEL_K, fused=True, **kw),
                 init)
    del stack, static
    aligned = cs.stage_aligned(dev, churn, s_n)
    kw = dict(box_size=cs.LABEL_BOX, soa_batch=True)
    for what, step, init in (
            ("aligned step, 'xla' (torch chain + K1)",
             tss.make_aligned_native_step(cs.LABEL_K, **kw),
             lambda d: tss.init_aligned_carry(h, p, device=d)),
            ("aligned step, 'pallas' (K17)",
             tss.make_aligned_native_step(cs.LABEL_K, detect_impl="pallas",
                                          **kw),
             lambda d: tss.init_aligned_carry(h, p, device=d)),
            ("legacy aligned step (K17)",
             tss.make_aligned_orbit_step(cs.LABEL_K, **kw),
             lambda d: tss.init_sorted_carry(h, p, device=d))):
        cs.time_scan(dev, aligned, s_n, n_valid, what, step, init)


#: The stream probes' ``dma_probe`` variants, by kernel.
PROBE_VARIANTS = {"P1": ("auto8", "auto32", "pallas5"),
                  "P2": ("man16x4", "man8x8", "man32x4", "man64x2",
                         "man128x2", "man64x4", "man32x8"),
                  "P3": ("split32x4", "dual32x4", "quad64x2")}


def probe_times(cs, dev, which):
    """Milliseconds of each P1, P2 or P3 variant of ``which`` and of
    torch's ``x + 1`` on the same planes (``xla``; ``xla5`` where a variant
    takes five planes), on one seeded ``[2048, 65536]`` f32 plane, each
    variant bit-equal to ``x + 1`` on every plane."""
    import torch

    from orbitanalysis_tpu_torch.probes import dma_probe

    gen = torch.Generator(device=dev).manual_seed(16)
    x = torch.randn((2048, dma_probe.LANES), generator=gen, device=dev)
    names = {n: f"{k}_{n}" for k in ("P1", "P2", "P3") if k in which
             for n in PROBE_VARIANTS[k]}
    out = {}
    for name in ["xla", "xla5", *names]:
        fn = dma_probe.VARIANTS[name]()
        xin = dma_probe.variant_input(fn, x)
        planes = xin if fn.n_planes else (xin,)
        got = fn(xin)
        got = got if fn.n_planes else (got,)
        ne, _ = cs._bitwise(got, tuple(p + 1.0 for p in planes))
        cs.check(ne == 0, f"{name} differs from x + 1")
        out[names.get(name, name)] = cs.cuda_ms(lambda: fn(xin))
        del got
    return out


def main(root, tag, which="K1,K4,K8,K10,K13,K14,K15,K16,K17"):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.ops import nbody as tn

    if not _cuda.__file__.startswith(root):
        raise SystemExit(f"imported {_cuda.__file__}, not from {root}")
    which = which.split(",")
    dev = torch.device("cuda")
    out = {"tag": tag, "build_s": _cuda.build()}
    if "K1" in which:
        out.update(k1_times(cs, dev))
    if "K15" in which:
        out.update(k15_times(cs, dev))
    if "K18" in which:
        out.update(k18_times(cs, dev))
    if "K19" in which:
        out.update(k19_times(cs, dev))
    if "COMPACT" in which:
        out.update(compact_times(cs, dev))
    if {"K4", "K8", "K10"} & set(which):
        label_args = cs._detect_inputs(dev, label_work(cs, dev), True)
        for name, fn in (("K4", k4_times), ("K8", k8_times),
                         ("K10", k10_times)):
            if name in which:
                out.update(fn(cs, dev, label_args))
        del label_args
    if "K13" in which:
        for rows, grid in ((cs.C4_SCALE[0], cs.C4_SCALE[1]),
                           (cs.C4_ANCHOR[0], cs.C4_ANCHOR[1])):
            n = rows * cs.C4_ROW
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out[f"K13_{n}_{grid + 1}"] = cs._k13_check(dev, n, grid, {})
            out[f"K13_{n}_{grid + 1}_peak_GiB"] = (
                torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.empty_cache()
    if "K14" in which:
        for n in (cs.K14_N, 8 * cs.K14_N):
            for box in (None, 10.0):
                key = f"K14_N{n}_{'free' if box is None else 'periodic'}"
                out[key] = cs._k14_check(dev, n, box, {})
        rng = np.random.default_rng(0)
        p = torch.from_numpy(
            rng.normal(size=(cs.K14_N, 3)).astype(np.float32)).to(dev)
        m = torch.from_numpy(
            rng.uniform(0.5, 2.0, cs.K14_N).astype(np.float32)).to(dev)
        acc = tn.direct_forces_blocked(p, m, 0.1).cpu().numpy()
        out[f"K14_N{cs.K14_N}_free_sha256"] = hashlib.sha256(
            acc.tobytes()).hexdigest()
    if "K16" in which or "K17" in which:
        out.update(detect_times(cs, dev, which))
    if {"P1", "P2", "P3"} & set(which):
        out.update(probe_times(cs, dev, which))
    if "STEPS" in which:
        step_times(cs, dev)
    if "LABEL_STEPS" in which:
        label_step_times(cs, dev)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4):
        raise SystemExit("usage: python3 kernel_ab.py CHECKOUT TAG "
                         "[K1,K4,K8,K10,K13,K14,K15,K16,K17,K18,K19,COMPACT,"
                         "P1,P2,P3,STEPS,LABEL_STEPS]")
    main(*sys.argv[1:])
