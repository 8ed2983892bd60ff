"""Readings that the limits of ``correct`` are set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        [--control-seeds 4,5,6] [--seconds 3] [--out file.jsonl]

For each seed of ``--seeds`` one run of the program as the benchmark runs
it (a short window, then the check; with ``--fault`` a fault of
``harness/faults.py`` planted in it), and for each of ``--control-seeds``
the control: the reference computed with float8 e4m3 products put in the
program's place at the cell's own sizes and judged as the program is.
One JSON line a reading: ``{"who": "program"|"control", "seed", "checks"}``.
The limits go into the configuration's ``limits`` between the program's
largest reading and the control's smallest (PERF.md gives both).
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None,
                    help="plant a fault of harness/faults.py in the program")
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import core, entries, faults, inputs, spec

    cell = spec.cell_spec(args.workload)
    dev = torch.device("cuda")
    lines = []

    def emit(row):
        print(json.dumps(row), flush=True)
        lines.append(row)

    for seed in _seeds(args.seeds):
        t = time.perf_counter()
        with (faults.FAULTS[args.fault]() if args.fault
              else contextlib.nullcontext()):
            out = core.run_cell(args.workload, seed, args.seconds, False,
                                "cuda", cell)
        emit({"who": args.fault or "program", "seed": seed,
              "correct": out["correct"],
              "checks": out["readings"],
              "metrics": {k: v["value"] for k, v in out["metrics"].items()},
              "seconds": time.perf_counter() - t})
    for seed in _seeds(args.control_seeds):
        t = time.perf_counter()
        ctx = core.Ctx(cell["cell"], cell["config"], cell["mix"], seed, dev)
        entry = entries.ENTRIES[ctx.mix["entry"]]
        state = {"pool": inputs.make_pool(ctx.mix, seed, dev)}
        checks, bad = entry.judge(ctx, state, control=True)
        emit({"who": "control", "seed": seed, "bad": bad, "checks": checks,
              "seconds": time.perf_counter() - t})
        del state
    if args.out:
        with open(args.out, "a") as f:
            for row in lines:
                f.write(json.dumps({"workload": args.workload, **row}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
