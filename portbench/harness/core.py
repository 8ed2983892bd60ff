"""One run of one cell: set-up, the measured window, the readings, the
check of what the window produced, and the result line.

``run_cell`` is what ``portbench/run.py`` calls; the tests call it on the
CPU at tiny sizes, with ``spec`` overridden.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from . import spec as specs
from .entries import ENTRIES
from .trace import Tracer, reduce

# top-level modules the process that prints the result may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "kvq_tpu")


@dataclasses.dataclass
class Ctx:
    cell: dict
    config: dict
    mix: dict
    seed: int
    device: torch.device


@dataclasses.dataclass
class Reading:
    """What a metric's reader reads (``metrics/<name>.py: read(r)``): the
    window's counts and times, the set-up's seconds, and with ``--trace
    1`` the reduced trace."""

    ctx: Ctx
    window: dict
    setup_s: float
    trace: dict | None
    peak_bytes: int


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spec: dict | None = None,
             t_start: float | None = None) -> dict:
    """One run; returns the result line's object (``correct`` from the
    limits of the configuration's ``limits`` for the mix's entry)."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or specs.cell_spec(cell)
    dev = torch.device(device)
    ctx = Ctx(spec["cell"], spec["config"], spec["mix"], int(seed), dev)
    entry = ENTRIES[ctx.mix["entry"]]
    cuda = dev.type == "cuda"
    state = entry.setup(ctx)
    opened = []

    def begin() -> float:
        """Drains the card and opens the window: the set-up ends here."""
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
        opened.append(time.perf_counter())
        return opened[0]
    tracer = Tracer() if trace else None
    window = entry.window(ctx, state, seconds, tracer, begin)
    setup_s = opened[0] - t_start
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        card = torch.cuda.get_device_name(dev)
    else:
        peak, card = 0, "cpu"
    tr = reduce(tracer) if tracer is not None and tracer.prof else None
    entry.release(state)
    r = Reading(ctx, window, setup_s, tr, peak)
    metrics = {}
    for m in spec["per_layer" if trace else "end_to_end"]:
        value = specs.metric_reader(m["name"], spec["root"])(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    readings, bad = entry.judge(ctx, state)
    limits = ctx.config["limits"][ctx.mix["entry"]]
    for k, v in readings.items():
        if k not in limits:
            print(f"reading {k} = {v!r} (not compared)", file=sys.stderr)
    compared = {k: {"value": readings[k], "limit": v}
                for k, v in limits.items()}
    correct = bad == 0 and all(c["value"] <= c["limit"]
                               for c in compared.values())
    failed = window["attempted"] - window["done"] + bad
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": card,
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": window["attempted"],
           "failed": failed, "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = compared
    out["readings"] = readings
    out["pace"] = window["pace"]
    return out
