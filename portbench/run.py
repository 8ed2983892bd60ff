"""The benchmark of kvq_tpu_torch on one NVIDIA H100: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything the cell needs is found by name from ``BENCHMARK.json``: the
configuration file, ``portbench/traffic/<traffic>.json`` (the mix, and the
entry its window drives) and, with ``--trace 1``, each per-layer metric's
reader ``portbench/metrics/<metric>.py``.  The last line of standard output
is the result's JSON object; the numbers compared for ``correct`` are its
last key and the last lines of standard error.  Without a CUDA card (or
with fewer than the cell asks for) it prints no result and exits 2; if
JAX, flax or the JAX package got loaded, it exits 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, REPO)
os.environ.setdefault("USE_FLAX", "0")
os.environ["TRITON_CACHE_DIR"] = os.path.join(REPO, ".portbench_cache",
                                              "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
    REPO, ".portbench_cache", "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import core, spec

    cell = spec.cell_spec(args.workload)
    chips = int(cell["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = core.run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), "cuda", cell, T_START)
    found = core.forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    out.pop("readings")
    print(f"pace (hand-offs in each 5 s of the window): "
          f"{out.pop('pace')}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
