"""Device time of the ordered-compaction kernels of one checkout.

Times K1 (``compact_angle_blocked``), K3 (``compact_payload_pair``), K4
(``compact_payload``), K18 (``compact_events``) and K19
(``compact_rows``) on seeded synthetic inputs at ``chip_smoke.py``'s
shapes, K18 once more with every lane an event (``K18_full``: every
row's k128 outputs full), and K3 once more on one halo at the aligned
engine's widest row (``K3_wide``, ``[1, 1 << 19]``), after checking each
against its plain version, and prints one JSON line of milliseconds.
Two checkouts
are compared on one card by running it in each, in the order A, B, B, A:

    python3 compaction_ab.py PATH_TO_CHECKOUT_A old
    python3 compaction_ab.py . new

It needs a CUDA card and builds the checkout's kernels at first use.
"""
import json
import os
import sys


#: K3's second shape: one halo at MAX_ALIGNED_CAPACITY, K = 16384.
WIDE_PAIR = (1, 1 << 19, 16384)


def main(root, tag):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from orbitanalysis_tpu_torch.ops import compact

    if not compact.__file__.startswith(root):
        raise SystemExit(f"imported {compact.__file__}, not from {root}")
    rng = np.random.default_rng(1)

    def dev(x):
        return torch.from_numpy(
            np.ascontiguousarray(x).view(np.int32)).to("cuda")

    def words(shape):
        return dev(rng.integers(0, 1 << 32, shape, dtype=np.uint64)
                   .astype(np.uint32))

    def same(got, want):
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise SystemExit("a kernel differs from its plain version")

    out = {"tag": tag}
    # K3 at [4, 262144], 3 % events
    h, p, k = cs.PAIR_ROWS
    sel = rng.random((h, p)) < 0.03
    pw = dev(np.where(sel, np.arange(p, dtype=np.uint32) + 1, np.uint32(0)))
    aw = dev(np.where(sel, rng.integers(0, 0x7BFF, (h, p)).astype(np.uint32),
                      np.uint32(0)))
    same(compact.compact_payload_pair(pw, aw, k),
         compact.compact_payload_pair_torch(pw, aw, k))
    out["K3"] = cs.cuda_ms(lambda: compact.compact_payload_pair(pw, aw, k))
    # K4 at [64, 32768], 1.7 % events
    h, p, k = cs.ANGLE_ROWS
    sel = rng.random((h, p)) < 0.017
    x = dev(np.where(
        sel, (np.arange(1, p + 1, dtype=np.uint32) << np.uint32(15))
        | rng.integers(0, 0x7BFF, (h, p)).astype(np.uint32), np.uint32(0)))
    same([compact.compact_payload(x, k)], [compact.compact_payload_torch(x, k)])
    out["K4"] = cs.cuda_ms(lambda: compact.compact_payload(x, k))
    # K18 at [64, 32768], 2 % events
    sel = rng.random((h, p)) < 0.02
    packed = dev(rng.integers(0, 1 << 31, (h, p)).astype(np.uint32)
                 | (sel.astype(np.uint32) << np.uint32(31)))
    key, sv = words((h, p)), words((h, p))
    same(compact.compact_events(packed, key, sv, k),
         compact.compact_events_torch(packed, key, sv, k))
    out["K18"] = cs.cuda_ms(lambda: compact.compact_events(packed, key, sv, k))
    # K19 over 2P: group a six channels, 45 % selected, len P; group b
    # three channels, 1 %, len K
    n = 2 * p
    sa = dev((rng.random((h, n)) < 0.45).astype(np.int32))
    sb = dev((rng.random((h, n)) < 0.01).astype(np.int32))
    ca = tuple(words((h, n)) for _ in range(6))
    cb = tuple(words((h, n)) for _ in range(3))
    got = compact.compact_rows(sa, ca, p, sb, cb, k)
    want = compact.compact_rows_torch(sa, ca, p, sb, cb, k)
    same([*got[0], *got[1]], [*want[0], *want[1]])
    out["K19"] = cs.cuda_ms(lambda: compact.compact_rows(sa, ca, p, sb, cb, k))
    # K3 at [1, 1 << 19], 3 % events
    h, p, k = WIDE_PAIR
    sel = rng.random((h, p)) < 0.03
    pw = dev(np.where(sel, np.arange(p, dtype=np.uint32) + 1, np.uint32(0)))
    aw = dev(np.where(sel, rng.integers(0, 0x7BFF, (h, p)).astype(np.uint32),
                      np.uint32(0)))
    same(compact.compact_payload_pair(pw, aw, k),
         compact.compact_payload_pair_torch(pw, aw, k))
    out["K3_wide"] = cs.cuda_ms(
        lambda: compact.compact_payload_pair(pw, aw, k))
    # drawn last, from their own generator, so the inputs above stay
    # those of the earlier versions of this script
    rng = np.random.default_rng(2)
    h, p, k = cs.ANGLE_ROWS
    # K1 at [64, 32768], 1.7 % events, the f16 clamp lanes in row 0
    ang = rng.uniform(0, 7, (h, p)).astype(np.float32)
    sel = rng.random((h, p)) < 0.017
    ang[0, :4] = [65504.0, 65519.0, 65520.0, 1e30]
    sel[0, :4] = True
    x = dev(ang.view(np.uint32) | (sel.astype(np.uint32) << np.uint32(31)))
    same([compact.compact_angle_blocked(x, k)],
         [compact.compact_angle_blocked_torch(x, k)])
    out["K1"] = cs.cuda_ms(lambda: compact.compact_angle_blocked(x, k))
    # K18 with every lane an event: each row's k128 outputs full
    key, sv = words((h, p)), words((h, p))
    full = dev(rng.integers(0, 1 << 31, (h, p)).astype(np.uint32)
               | np.uint32(1 << 31))
    same(compact.compact_events(full, key, sv, k),
         compact.compact_events_torch(full, key, sv, k))
    out["K18_full"] = cs.cuda_ms(
        lambda: compact.compact_events(full, key, sv, k))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:3])
