#!/usr/bin/env python3
"""Times chip_smoke.py's KSVQE eval main path (8 scored batches of the
shipped shapes through ``Evaluator.inference_test``, twice, after a
warm-up; its checks included) for two or more checkouts of the repo on one
NVIDIA GPU, in turns, so that a difference between two versions can be
told from the host's spread.

    python3 tools/eval_ab.py --root OLD --root NEW [--pairs 5] \
        [--out eval_ab.json]

Each run is a process of its own that imports the root's chip_smoke.py and
package (its kernels build into its own ``ops/_build`` on the first run);
the roots run in the order given, then reversed, ``--pairs`` times (A B B
A ...).  Prints each run's two videos/s and the profiled forward's host
dispatch and device busy, then per root the median, the quartiles and the
range of all its videos/s, and writes every number to ``--out``.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke as C
from kvq_tpu_torch.ops import build
build.build_all()
r = C.main_path(C.card_line())
p = r["profile"]
print("RESULT " + json.dumps({
    "videos_per_s": [r["videos_per_s"], r["videos_per_s_again"]],
    "dispatch_ms": p.get("dispatch_ms"), "device_ms": p.get("device_ms")}))
"""


def run(root: str) -> dict:
    res = subprocess.run([sys.executable, "-c", CHILD, os.path.abspath(root)],
                         capture_output=True, text=True, timeout=900)
    lines = [l for l in res.stdout.splitlines() if l.startswith("RESULT ")]
    if res.returncode != 0 or not lines:
        sys.exit(f"{root}: exit {res.returncode}\n{res.stdout[-3000:]}"
                 f"\n{res.stderr[-3000:]}")
    return json.loads(lines[-1][len("RESULT "):])


def quartiles(xs: list[float]) -> tuple[float, float, float]:
    xs = sorted(xs)

    def at(q):
        i = q * (len(xs) - 1)
        lo = int(i)
        return xs[lo] + (xs[min(lo + 1, len(xs) - 1)] - xs[lo]) * (i - lo)

    return at(0.25), at(0.5), at(0.75)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", action="append", required=True)
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/eval_ab.json")
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    runs = {root: [] for root in args.root}
    for i in range(args.pairs):
        for root in (args.root if i % 2 == 0 else args.root[::-1]):
            r = run(root)
            runs[root].append(r)
            print(f"{root} run {len(runs[root])}: videos/s "
                  f"{r['videos_per_s']}, dispatch {r['dispatch_ms']} ms, "
                  f"device busy {r['device_ms']} ms; {card}", flush=True)
    summary = {}
    for root, rs in runs.items():
        v = [x for r in rs for x in r["videos_per_s"]]
        q1, med, q3 = quartiles(v)
        summary[root] = {"median": med, "q1": q1, "q3": q3,
                         "min": min(v), "max": max(v)}
        print(f"{root}: KSVQE eval videos/s median {med}, quartiles {q1} "
              f"- {q3}, range {min(v)} - {max(v)} over {len(v)} readings; "
              f"{card}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs, "summary": summary}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
