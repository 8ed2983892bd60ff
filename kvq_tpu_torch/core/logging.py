"""Structured metric logging and profiling hooks (counterpart of
kvq_tpu/core/logging.py):

  - :class:`MetricLogger`: a JSONL stream of records (step, seconds since
    the logger was made, values) in ``{workdir}/{name}_metrics.jsonl``,
    each also printed without its time; in a data-parallel run rank 0
    alone writes and prints;
  - :func:`profile_trace`: ``torch.profiler`` around a block, exported as
    a Chrome trace;
  - :func:`count_params` and :func:`flops_estimate`
    (``torch.utils.flop_counter``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Mapping

import torch
import torch.distributed as dist


class MetricLogger:
    def __init__(self, workdir: str | None = None, name: str = "train"):
        self.path = (os.path.join(workdir, f"{name}_metrics.jsonl")
                     if workdir else None)
        self.main = not dist.is_initialized() or dist.get_rank() == 0
        self._t0 = time.time()

    def log(self, step: int, values: Mapping[str, Any],
            prefix: str = "") -> dict:
        """Write and print one record; returns it."""
        rec = {"step": int(step), "time_s": round(time.time() - self._t0, 3)}
        for k, v in values.items():
            try:
                rec[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                rec[f"{prefix}{k}"] = str(v)
        if not self.main:
            return rec
        if self.path:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        print({k: v for k, v in rec.items() if k != "time_s"}, flush=True)
        return rec


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """Profile the block's host and CUDA activity into
    ``{logdir}/trace.json`` (Chrome's trace format) when ``logdir`` is
    set; nothing otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def count_params(module: torch.nn.Module) -> int:
    """Total number of parameter elements, frozen ones included."""
    return sum(p.numel() for p in module.parameters())


def flops_estimate(fn, *args) -> float | None:
    """Floating-point operations of one call of ``fn(*args)`` counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (products, convolutions
    and attention, 2 per multiply-add), or None when it counts none."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    flops = counter.get_total_flops()
    return float(flops) if flops else None
