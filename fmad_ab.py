"""Device time of the blocked direct-force kernel (K14) built with and
without FMA contraction.

The kernel library builds with ``--fmad=false`` (``ops/_cuda.py``
``NVCC_FLAGS``), so each multiply and add of K14's pair loop issues on
its own.  This script builds the library with the flags as they are
(``false``) or with ``--fmad=true`` in their place (``true``; the
library's name hashes its flags, so the two builds live side by side
under ``_build/``), checks K14 against its plain version, times it at
N = 16384 and 131072, free and periodic, and prints one JSON line of
milliseconds.  Compare the two on one card in turns:

    for f in false true true false; do python3 fmad_ab.py $f; done

It needs a CUDA card and nvcc.
"""
import json
import os
import sys


def main(fmad):
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from orbitanalysis_tpu_torch.ops import _cuda
    from orbitanalysis_tpu_torch.ops import nbody as tn

    if fmad == "true":
        _cuda.NVCC_FLAGS = [("--fmad=true" if f == "--fmad=false" else f)
                            for f in _cuda.NVCC_FLAGS]
    elif fmad != "false":
        raise SystemExit("usage: python3 fmad_ab.py false|true")
    build_s = _cuda.build()
    rng = np.random.default_rng(0)
    out = {"fmad": fmad, "build_s": round(build_s, 2)}
    for n in (cs.K14_N, 8 * cs.K14_N):
        for box in (None, 10.0):
            pos = (rng.normal(size=(n, 3)) if box is None
                   else rng.uniform(0, box, (n, 3))).astype(np.float32)
            p = torch.from_numpy(pos).to("cuda")
            m = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(
                np.float32)).to("cuda")
            got = tn.direct_forces_blocked(p, m, 0.1, box_size=box)
            rel = cs.force_rel(got, tn.direct_forces_blocked_torch(
                p, m, 0.1, 1.0, box))
            if not rel < 1e-3:
                raise SystemExit(f"K14 differs from its plain version: {rel}")
            key = f"N{n}_{'free' if box is None else 'periodic'}"
            out[key] = cs.cuda_ms(
                lambda: tn.direct_forces_blocked(p, m, 0.1, box_size=box),
                runs=5, reps=3 if n > cs.K14_N else 10)
            out[key + "_rel"] = rel
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "")
