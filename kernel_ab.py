"""Device time of K10 (the fused label detect), K13 (the sorted CIC
deposit) and K14 (the blocked direct forces) of one checkout, measured
by that checkout's own ``chip_smoke.py`` checks.

K10 runs on phase 3's inputs (the label route's 64 halos on rows of
32768) and on the same particles with their labels spread over 512
halos, the most the JAX one-hot budget lets that row width have (the
table repeated, so every output keeps its bits); K13 on the sorted
streams of the first force evaluations of config 4's two runs (12.6M
particles on 256^3, 33.5M on 512^3; ``chip_smoke._k13_check``); K14 at
N = 16384 and 131072, free and periodic (``chip_smoke._k14_check``).
Each is checked against its plain version as ``chip_smoke.py`` checks it.
Prints one JSON line of milliseconds, with a digest of K14's forces at
N = 16384 so that two builds can be compared bit for bit.  Two checkouts
are compared on one card by running it in each, in the order A, B, B, A:

    python3 kernel_ab.py PATH_TO_CHECKOUT_A old [K10,K13,K14]
    python3 kernel_ab.py . new [K10,K13,K14]

The third argument picks the kernels (all three by default).  A
checkout whose ``chip_smoke.py`` predates ``_k13_check``/``_k14_check``
gets the same checks and timings from this script's own
:func:`k13_fallback` and :func:`k14_fallback`.  It needs a CUDA card and
builds the checkout's kernels at first use.
"""
import hashlib
import json
import os
import sys


def k10_times(cs, dev):
    """K10's milliseconds at 64 halos (phase 3's inputs) and with the
    labels spread over 512 halos, each bit-equal to the plain version
    and with the same events."""
    import torch

    from orbitanalysis_tpu_torch.models.synthetic import label_churn_workload
    from orbitanalysis_tpu_torch.ops import label

    lab, pos, vel, cen, _ = label_churn_workload(*cs.LABEL, seed=0,
                                                 churn=0.07)
    work = dict(label=torch.from_numpy(lab[:4]).to(dev),
                pos=torch.from_numpy(pos[:4]).to(dev),
                vel=torch.from_numpy(vel[:4]).to(dev),
                centers=torch.from_numpy(cen[:4]).to(dev))
    del lab, pos, vel
    args, table = cs._detect_inputs(dev, work, True)
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


def k13_fallback(cs, dev, n, grid):
    """``_k13_check``'s bit-equality check and kernel time, for a
    checkout that predates it."""
    import torch

    from orbitanalysis_tpu_torch.ops import deposit as td

    st = cs.c4_state(n, dev)
    keys, fracs = td.sorted_stream(st.pos, st.mass, grid, cs.C4_BOX)
    del st
    cs.check(torch.equal(td.deposit_stream(keys, fracs, grid),
                         td.deposit_stream_torch(keys, fracs, grid)),
             f"K13 differs from its plain version at {n}")
    return {"ms": cs.cuda_ms(lambda: td.deposit_stream(keys, fracs, grid))}


def k14_fallback(cs, dev, n, box):
    """``_k14_check``'s inputs, plain-version check and kernel time, for
    a checkout that predates it."""
    import numpy as np
    import torch

    from orbitanalysis_tpu_torch.ops import nbody as tn

    rng = np.random.default_rng(0)
    pos = (rng.normal(size=(n, 3)) if box is None
           else rng.uniform(0, box, (n, 3))).astype(np.float32)
    p = torch.from_numpy(pos).to(dev)
    m = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32)).to(dev)
    if n == cs.K14_N:
        rel = cs.force_rel(tn.direct_forces_blocked(p, m, 0.1, box_size=box),
                           tn.direct_forces_blocked_torch(p, m, 0.1, 1.0, box))
        cs.check(rel < 1e-3, f"K14 differs from its plain version: {rel}")
    big = n > cs.K14_N
    return {"ms": cs.cuda_ms(
        lambda: tn.direct_forces_blocked(p, m, 0.1, box_size=box),
        runs=3 if big else 5, reps=2 if big else 10)}


def main(root, tag, which="K10,K13,K14"):
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
    if "K10" in which:
        out.update(k10_times(cs, dev))
    if "K13" in which:
        for rows, grid in ((cs.C4_SCALE[0], cs.C4_SCALE[1]),
                           (cs.C4_ANCHOR[0], cs.C4_ANCHOR[1])):
            n = rows * cs.C4_ROW
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out[f"K13_{n}_{grid + 1}"] = (
                cs._k13_check(dev, n, grid, {}) if hasattr(cs, "_k13_check")
                else k13_fallback(cs, dev, n, grid))
            out[f"K13_{n}_{grid + 1}_peak_GiB"] = (
                torch.cuda.max_memory_allocated() / 2**30)
            torch.cuda.empty_cache()
    if "K14" in which:
        for n in (cs.K14_N, 8 * cs.K14_N):
            for box in (None, 10.0):
                key = f"K14_N{n}_{'free' if box is None else 'periodic'}"
                out[key] = (
                    cs._k14_check(dev, n, box, {})
                    if hasattr(cs, "_k14_check")
                    else k14_fallback(cs, dev, n, box))
        rng = np.random.default_rng(0)
        p = torch.from_numpy(
            rng.normal(size=(cs.K14_N, 3)).astype(np.float32)).to(dev)
        m = torch.from_numpy(
            rng.uniform(0.5, 2.0, cs.K14_N).astype(np.float32)).to(dev)
        acc = tn.direct_forces_blocked(p, m, 0.1).cpu().numpy()
        out[f"K14_N{cs.K14_N}_free_sha256"] = hashlib.sha256(
            acc.tobytes()).hexdigest()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    if len(sys.argv) not in (3, 4):
        raise SystemExit("usage: python3 kernel_ab.py CHECKOUT TAG "
                         "[K10,K13,K14]")
    main(*sys.argv[1:])
