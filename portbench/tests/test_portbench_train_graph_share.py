"""The reader of ``graph_replay_share.train`` (the share of train steps
whose KSVQE backbone replayed its CUDA graphs) on synthetic span summaries
and a tiny CPU run, and its silence where the program has no recorder or no
graphed train step."""

import sys
import types

import pytest

from kvq_tpu_torch.core import tracing
from portbench.harness import core
from portbench.harness import spec as specs

from .tiny import tiny_spec


def _reading(s):
    return types.SimpleNamespace(ctx=types.SimpleNamespace(mix=s["mix"]))


GRAPH_SHARE = "graph_replay_share.train"


def _counts(**by_name):
    return {name.replace("_", "."): {"dispatch": {"count": n,
                                                  "total_ms": 1.0,
                                                  "self_ms": 1.0}}
            for name, n in by_name.items()}


@pytest.mark.parametrize("summ,want", [
    (_counts(kvq_train_forward=16, kvq_train_replay=16), 100.0),
    (_counts(kvq_train_forward=16, kvq_train_replay=12), 75.0),
    (_counts(kvq_train_forward=16), 0.0),
    (_counts(kvq_train_replay=3), None),
    (_counts(kvq_eval_forward=8, kvq_graph_replay=8), None),
    ({}, None),
])
def test_graph_replay_share_train_reads_span_counts(summ, want,
                                                    monkeypatch):
    """The dispatch thread's ``kvq.train.replay`` spans over its
    ``kvq.train.forward`` spans, on a synthetic summary; nothing without a
    train forward span (an eval run's graph spans are not read)."""
    bench = {m["name"]: m for m in specs.load_benchmark()["per_layer"]}
    assert bench[GRAPH_SHARE]["workloads"] == ["ksvqe-train"]
    assert bench[GRAPH_SHARE]["source"] == "program_span"
    assert bench[GRAPH_SHARE]["layer"] == "dispatch"
    assert bench[GRAPH_SHARE]["moves"] == "train_steps_per_s"
    monkeypatch.setattr(tracing, "summary", lambda since=0: summ)
    got = specs.metric_reader(GRAPH_SHARE)(_reading(tiny_spec("ksvqe-train")))
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("missing", ["kvq_tpu_torch.core.tracing",
                                     "kvq_tpu_torch.nn.train_graphs"])
def test_graph_replay_share_train_silent_without_the_program_parts(
        missing, monkeypatch):
    """A program without the recorder or without graphed train steps (the
    parent of the change that adds them) reads nothing."""
    monkeypatch.setattr(tracing, "summary", lambda since=0: _counts(
        kvq_train_forward=16, kvq_train_replay=16))
    monkeypatch.setitem(sys.modules, missing, None)
    read = specs.metric_reader(GRAPH_SHARE)
    assert read(_reading(tiny_spec("ksvqe-train"))) is None


def test_graph_replay_share_train_reads_zero_on_the_cpu():
    """On the CPU every train step is eager: a tiny recorded train run
    reads 0 %, not nothing."""
    s = tiny_spec("ksvqe-train")
    tracing.reset()
    try:
        with tracing.recording():
            out = core.run_cell("ksvqe-train", 5, 1.0, False, "cpu", s)
        assert out["correct"]
        assert specs.metric_reader(GRAPH_SHARE)(_reading(s)) == 0.0
    finally:
        tracing.reset()
