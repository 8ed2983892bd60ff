"""The readers of the program's spans (``metrics/*_ms_per_*``) on tiny
CPU runs recorded with ``kvq_tpu_torch.core.tracing.recording()``, and
their silence where the program records nothing or has no recorder."""

import sys
import types

import pytest

from kvq_tpu_torch.core import tracing
from portbench.harness import core
from portbench.harness import spec as specs

from .tiny import tiny_spec

READERS = {
    "ksvqe-score": {
        "dispatch_ms_per_video.score": ("kvq.eval.forward",),
        "feed_wait_ms_per_video.score": ("kvq.eval.feed",),
        "readback_ms_per_video.score": ("kvq.eval.readback",)},
    "ksvqe-train": {
        "forward_ms_per_step.train": ("kvq.train.cast", "kvq.train.forward"),
        "backward_ms_per_step.train": ("kvq.train.backward",),
        "optimizer_ms_per_step.train": ("kvq.train.optimizer",
                                        "kvq.train.ema"),
        "feed_wait_ms_per_step.train": ("kvq.train.feed",)},
}


def _reading(s):
    return types.SimpleNamespace(ctx=types.SimpleNamespace(mix=s["mix"]))


@pytest.mark.parametrize("cell", sorted(READERS))
def test_span_readers_on_a_tiny_run(cell):
    s = tiny_spec(cell)
    bench = {m["name"]: m for m in specs.load_benchmark()["per_layer"]}
    tracing.reset()
    try:
        with tracing.recording():
            out = core.run_cell(cell, 5, 1.0, False, "cpu", s)
        assert out["correct"]
        summ = tracing.summary()
        unit = ("kvq.eval.forward" if cell == "ksvqe-score"
                else "kvq.train.forward")
        units = summ[unit]["dispatch"]["count"]
        per = s["mix"]["batch_size"] if cell == "ksvqe-score" else 1
        for name, spans in READERS[cell].items():
            assert bench[name]["workloads"] == [cell]
            assert bench[name]["source"] == "program_span"
            want = sum(summ[n]["dispatch"]["total_ms"]
                       for n in spans) / (units * per)
            got = specs.metric_reader(name)(_reading(s))
            assert got == pytest.approx(want) and got > 0, name
    finally:
        tracing.reset()


@pytest.mark.parametrize("name", sorted(n for r in READERS.values()
                                        for n in r))
def test_span_readers_silent_without_spans(name, monkeypatch):
    read = specs.metric_reader(name)
    s = tiny_spec("ksvqe-score")
    tracing.reset()
    assert read(_reading(s)) is None
    # a program without the recorder (the parent of the change that adds it)
    monkeypatch.setitem(sys.modules, "kvq_tpu_torch.core.tracing", None)
    assert read(_reading(s)) is None
