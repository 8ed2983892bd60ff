"""The device trace of a steady part of the window (``--trace 1``).

:class:`Tracer` runs ``torch.profiler`` (CPU and CUDA activities) from a
point inside the window to a later one, with the card drained at both
ends, so that the trace holds exactly the kernels launched between them.
:func:`reduce` turns it into what the per-layer readers need: every
kernel's name, family and interval; the busy time (the union of the
intervals of the kernels and copies); the kernels launched; the idle gaps,
each named by the innermost host operation that was running when it
opened; and the top device operations.

``family`` is chip_smoke.py's ``_family`` (kernel name -> the port's
kernel families and the libraries'), copied here so that later changes to
that script do not move the benchmark.
"""

from __future__ import annotations

import time

def family(name: str) -> str:
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if "flash_attention_kernel" in name:
        return ("kvq_window_attention" if "true" in low
                else "kvq_nobias_attention")
    if "attention_bwd_kernel" in name:
        return "kvq_attention_bwd"
    if "kvq" in name and "gemm_kernel" in name:
        return "kvq_gemm"
    if "kvq" in name and "layernorm" in name:
        return "kvq_layernorm"
    if "kvq" in name:
        return "kvq_train_other"
    if "conv" in low or "cudnn" in low or "implicit" in low:
        return "conv (cuDNN)"
    if ("gemm" in low or "cutlass" in low or "sm90" in low
            or "nvjet" in low):
        return "matmul (cuBLAS)"
    return "other"


class Tracer:
    """``start()`` and ``stop()`` from inside the window; ``units`` counts
    the units (videos, steps) handed out while it ran, ``begin`` and
    ``end`` bound what it cost the window (starting the profiler can take
    seconds)."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.units = 0
        self.counters0 = self.counters1 = None

    def start(self, counters):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.begin = time.perf_counter()
        torch.cuda.synchronize()
        self.counters0 = counters()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, counters):
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        self.counters1 = counters()
        self.end = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.t1 is None

    def counts(self) -> dict:
        return {k: self.counters1[k] - self.counters0[k]
                for k in self.counters0}


def reduce(tracer: Tracer) -> dict:
    from torch.autograd import DeviceType

    kernels, host = [], []
    for e in tracer.prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            # a record_function range drawn on the device's timeline is
            # no operation of the device
            if not getattr(e, "is_user_annotation", False):
                kernels.append((start, end, e.name))
        elif e.device_type == DeviceType.CPU:
            host.append((start, end, e.name))
    kernels.sort()
    busy_us, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e, _ in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
                gaps.append((s - cur_e, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_family: dict[str, float] = {}
    by_name: dict[str, float] = {}
    for s, e, n in kernels:
        f = family(n)
        by_family[f] = by_family.get(f, 0.0) + (e - s) / 1e6
        key = f"{f}: {n[:96]}"
        by_name[key] = by_name.get(key, 0.0) + (e - s) / 1e6
    gaps.sort(reverse=True)
    named_gaps = []
    for length, at in gaps[:10]:
        inner = min((h for h in host if h[0] <= at <= h[1]),
                    key=lambda h: h[1] - h[0], default=None)
        named_gaps.append([inner[2][:96] if inner else "no host op",
                           length / 1e6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": tracer.t1 - tracer.t0,
        "busy_s": busy_us / 1e6,
        "kernels": sum(1 for *_, n in kernels
                       if not n.startswith(("Memcpy", "Memset"))),
        "families_s": by_family,
        "device_ops": [[k, v] for k, v in top],
        "idle_gaps": named_gaps,
        "units": tracer.units,
        "span_s": tracer.end - tracer.begin,
        "counts": tracer.counts(),
    }
