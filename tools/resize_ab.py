#!/usr/bin/env python3
"""Holds the port's resize (``kvq_tpu_torch/data/resize.py``) against
``cv2.resize`` at random sizes where a side grows, and times its host paths
for two or more checkouts of the repo, in turns.

    python3 tools/resize_ab.py [--root OLD --root NEW] [--sizes 60] \
        [--reps 3] [--out resize_ab.json]

The check (the first root, default this checkout): ``--sizes`` random
(H, W) -> (oh, ow) pairs, both sides growing, on seeded frames: uint8
through INTER_LINEAR, float32 with fractional values through INTER_LINEAR
(cv2 calls Intel IPP for it when ``cv2.ipp.useIPP()``) and uint8 through
INTER_AREA with one side shrinking; prints the pixels that differ.

The timing: each root in a process of its own, the roots in the order given
and then reversed (A B B A), each path the best of ``--reps`` on one thread
of this host: uint8 bilinear 32 frames 240x426 -> 520x520 (SimpleVQA's
view of a 240p source), uint8 mixed area 32 frames 90x400 -> 224x224, and
the mosaic's float32 upsample of 32 frames 240x426 -> 288x511 (KSVQE's
fallback).  Host times, not device times.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, sys.argv[1])
from kvq_tpu_torch.data.resize import resize
reps = int(sys.argv[2])
rng = np.random.default_rng(0)
low = rng.integers(0, 256, (32, 240, 426, 3), dtype=np.uint8)
wide = rng.integers(0, 256, (32, 90, 400, 3), dtype=np.uint8)
paths = {"uint8 linear 240x426 -> 520x520": lambda: resize(low, 520, 520,
                                                             "linear"),
         "uint8 area 90x400 -> 224x224": lambda: resize(wide, 224, 224),
         "float32 linear 240x426 -> 288x511": lambda: resize(
             low.astype(np.float32), 288, 511, "linear")}
ms = {}
for name, fn in paths.items():
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    ms[name] = best * 1e3
print("RESULT " + json.dumps(ms))
"""


def check(root: str, n: int) -> dict:
    """Pixels that differ from cv2 at ``n`` random growing sizes."""
    import cv2
    import numpy as np

    sys.path.insert(0, root)
    from kvq_tpu_torch.data.resize import resize

    rng = np.random.default_rng(7)
    out = {"sizes": n, "cv2": cv2.__version__, "ipp": cv2.ipp.useIPP(),
           "uint8 linear": 0, "float32 linear": 0, "uint8 mixed area": 0,
           "float32 max_abs": 0.0}
    for _ in range(n):
        h, w = (int(x) for x in rng.integers(2, 300, 2))
        oh, ow = (int(x * rng.uniform(1, 6)) + 1 for x in (h, w))
        u8 = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
        f32 = u8.astype(np.float32) + rng.random(u8.shape, np.float32)
        for key, v, interp, size in (
                ("uint8 linear", u8, "linear", (oh, ow)),
                ("float32 linear", f32, "linear", (oh, ow)),
                ("uint8 mixed area", u8, "area", (oh, max(1, w // 2)))):
            flag = cv2.INTER_LINEAR if interp == "linear" else cv2.INTER_AREA
            want = cv2.resize(v[0], size[::-1], interpolation=flag)
            got = resize(v, *size, interp)[0]
            out[key] += int((got != want).sum())
            if v.dtype == np.float32:
                out["float32 max_abs"] = max(out["float32 max_abs"], float(
                    np.abs(got - want).max()))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", action="append", default=None)
    p.add_argument("--sizes", type=int, default=60)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", default="resize_ab.json")
    args = p.parse_args(argv)
    roots = [os.path.abspath(r) for r in (args.root or [os.curdir])]
    result = {"check": check(roots[0], args.sizes), "runs": []}
    print(f"{roots[0]} against cv2: {json.dumps(result['check'])}",
          flush=True)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for root in roots + roots[::-1]:
        out = subprocess.run([sys.executable, "-c", CHILD, root,
                              str(args.reps)], capture_output=True,
                             text=True, env=env, check=True).stdout
        ms = json.loads(out.split("RESULT ", 1)[1])
        result["runs"].append({"root": root, "ms": ms})
        print(f"{root}: {json.dumps({k: round(v, 2) for k, v in ms.items()})}"
              f" (best of {args.reps}, one thread)", flush=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
