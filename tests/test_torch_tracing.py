"""The span recorder (``kvq_tpu_torch/core/tracing.py``) on the CPU: what
it records and when, the spans of the Evaluator's and the Trainer's loops
unit by unit, the kernel wrappers' spans nested in them, and exact self
times."""

import gc
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kvq_tpu_torch.core import tracing
from kvq_tpu_torch.data.fragments import s2d_pack
from kvq_tpu_torch.data.pipeline import prepared_in_background
from kvq_tpu_torch.train.evaluator import Evaluator
from kvq_tpu_torch.train.trainer import Trainer

from test_torch_modules import _batch, tiny_config


@pytest.fixture(autouse=True)
def clean():
    """No spans before, none after, and no automatic collection in
    between: a test that wants ``kvq.gc`` calls ``gc.collect()``."""
    enabled = gc.isenabled()
    gc.disable()
    tracing.reset()
    yield
    tracing.reset()
    if enabled:
        gc.enable()


def _by(name):
    return [s for s in tracing.spans() if s["name"] == name]


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: opened.append(name))

    @tracing.span("kvq.t.decorated")
    def f(x):
        return x + 1

    with tracing.span("kvq.t.with", 3):
        assert f(1) == 2
    with tracing.span("kvq.t.attrs", batch=1):
        pass
    tracing.begin_unit(0)
    list(prepared_in_background(lambda x: x, range(3)))
    gc.collect()
    assert tracing.spans() == [] and opened == []
    # the same shared object for every span of a name
    assert tracing.span("kvq.t.with", 1) is tracing.span("kvq.t.with", 2)


def test_recording_and_profiler_record_and_show_ranges():
    @tracing.span("kvq.t.decorated")
    def f():
        with tracing.span("kvq.t.inner"):
            pass

    with tracing.recording():
        f()
    assert [s["name"] for s in tracing.spans()] == ["kvq.t.inner",
                                                     "kvq.t.decorated"]
    tracing.reset()
    # under a profiler on this thread, no recording(): ranges in the trace;
    # the worker's prep follows the state seen at the unit boundary
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.begin_unit(5)
        got = list(prepared_in_background(lambda x: x * 2, range(3),
                                          first_unit=5))
        f()
    tracing.begin_unit(None)  # the profiler is off again
    assert got == [0, 2, 4]
    names = {e.name for e in prof.events()}
    assert {"kvq.t.decorated", "kvq.t.inner",
            "kvq.pipeline.prep_wait"} <= names
    prep = _by("kvq.pipeline.prep")
    assert sorted(s["unit"] for s in prep) == [5, 6, 7]
    assert {s["role"] for s in prep} == {"worker"}
    assert {s["role"] for s in _by("kvq.pipeline.prep_wait")} == {"dispatch"}
    n = len(tracing.spans())
    f()
    list(prepared_in_background(lambda x: x, range(2)))
    assert len(tracing.spans()) == n  # nothing once the profiler stopped


def test_span_the_profiler_stopped_inside_is_dropped():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    tracing.begin_unit(0)
    with tracing.span("kvq.t.kept"):
        pass
    with tracing.span("kvq.t.straddles"):
        prof.stop()
    with tracing.span("kvq.t.after"):
        pass
    assert [s["name"] for s in tracing.spans()] == ["kvq.t.kept"]


def test_self_times_exact(monkeypatch):
    clock = iter([0, 10, 30, 40, 45, 50, 70, 100])
    monkeypatch.setattr(tracing, "_now", lambda: next(clock) * 10 ** 6)
    with tracing.recording():
        with tracing.span("kvq.t.outer", 7):
            with tracing.span("kvq.t.a"):
                pass
            with tracing.span("kvq.t.b"):
                with tracing.span("kvq.t.c"):
                    pass
    s = tracing.summary()
    got = {n: (r["dispatch"]["total_ms"], r["dispatch"]["self_ms"])
           for n, r in s.items()}
    assert got == {"kvq.t.outer": (100.0, 50.0), "kvq.t.a": (20.0, 20.0),
                   "kvq.t.b": (30.0, 25.0), "kvq.t.c": (5.0, 5.0)}
    assert {sp["unit"] for sp in tracing.spans()} == {7}
    ids = {sp["name"]: sp["id"] for sp in tracing.spans()}
    parent = {sp["name"]: sp["parent"] for sp in tracing.spans()}
    assert parent == {"kvq.t.outer": None, "kvq.t.a": ids["kvq.t.outer"],
                      "kvq.t.b": ids["kvq.t.outer"],
                      "kvq.t.c": ids["kvq.t.b"]}


def test_spans_of_other_threads_and_gc():
    with tracing.recording():
        t = threading.Thread(target=lambda: tracing.span("kvq.t.w").__enter__()
                             .__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        gc.collect()
    assert _by("kvq.t.w")[0]["role"] == "worker"
    collected = _by("kvq.gc")
    assert collected and collected[-1]["attrs"] == {"generation": 2}


def _ancestors(span, ids):
    out = []
    while span["parent"] is not None and span["parent"] in ids:
        span = ids[span["parent"]]
        out.append(span["name"])
    return out


def _per_unit(name, units, role="dispatch"):
    got = [s for s in _by(name) if s["unit"] in units]
    assert sorted(s["unit"] for s in got) == sorted(units), name
    assert {s["role"] for s in got} == {role}, name


def test_evaluator_spans_each_unit():
    ev = Evaluator(tiny_config(use_pallas=True), device="cpu")
    batches = [_batch(B=1, seed=i) for i in range(3)]
    with tracing.recording():
        scores = list(ev.scored_batches(batches))
    assert len(scores) == 3
    units = [0, 1, 2]
    for name in ("kvq.eval.feed", "kvq.eval.forward", "kvq.eval.readback",
                 "kvq.pipeline.prep_wait"):
        _per_unit(name, units)
    _per_unit("kvq.pipeline.prep", units, "worker")
    ids = {s["id"]: s for s in tracing.spans()}
    kernels = _by("kvq.k1") + _by("kvq.k2")
    assert _by("kvq.k1") and _by("kvq.k2")
    for k in kernels:
        assert "kvq.eval.forward" in _ancestors(k, ids)
        fwd = ids[k["parent"]]
        assert k["unit"] == fwd["unit"]
    for w in _by("kvq.pipeline.prep_wait"):
        assert _ancestors(w, ids) == ["kvq.eval.feed"]


def _train_batch(seed):
    b = _batch(B=4, T=8, seed=seed)
    b["fragment"] = np.stack([s2d_pack(f) for f in b["fragment"]])
    return b


def test_trainer_spans_each_step():
    cfg = dict(tiny_config(use_pallas=True, s2d_input=True),
               warmup_epochs=1, num_epochs=4)
    tr = Trainer(cfg, device="cpu", seed=0, steps_per_epoch=2)
    tr.train_step(_train_batch(5))  # step 0 outside the recording
    with tracing.recording():
        tr.train_epoch([_train_batch(0), _train_batch(1)])
        gc.collect()
    units = [1, 2]
    for name in ("kvq.train.feed", "kvq.train.cast", "kvq.train.forward",
                 "kvq.train.backward", "kvq.train.optimizer",
                 "kvq.train.ema", "kvq.pipeline.prep_wait"):
        _per_unit(name, units)
    _per_unit("kvq.pipeline.prep", units, "worker")
    assert not _by("kvq.train.allreduce")  # one process
    ids = {s["id"]: s for s in tracing.spans()}
    fwd = _by("kvq.k4.fwd") + _by("kvq.k5.fwd")
    bwd = _by("kvq.k4.bwd") + _by("kvq.k5.bwd")
    assert fwd and bwd
    for k in fwd:
        assert "kvq.train.forward" in _ancestors(k, ids)
    for k in bwd:  # the CPU's backward runs on the calling thread
        assert "kvq.train.backward" in _ancestors(k, ids)
    assert {k["unit"] for k in fwd + bwd} == set(units)
    assert _by("kvq.gc")


def test_write_and_summary_since(tmp_path):
    with tracing.recording():
        with tracing.span("kvq.t.before"):
            pass
        since = tracing.mark()
        with tracing.span("kvq.t.after", batch=3):
            pass
    n = tracing.write(str(tmp_path / "s.jsonl"), since)
    lines = [json.loads(x) for x in open(tmp_path / "s.jsonl")]
    assert n == 1 and [x["name"] for x in lines] == ["kvq.t.after"]
    assert set(lines[0]) == {"name", "role", "thread", "unit", "start_ns",
                             "end_ns", "id", "parent", "attrs"}
    assert lines[0]["attrs"] == {"batch": 3}
    assert list(tracing.summary(since)) == ["kvq.t.after"]
    assert "kvq.t.after" in tracing.format_summary(tracing.summary())


def test_recorded_to_writes_spans(tmp_path, capsys):
    with tracing.recorded_to(str(tmp_path / "d")):
        with tracing.span("kvq.t.x"):
            torch.zeros(1)
    assert [json.loads(x)["name"]
            for x in open(tmp_path / "d" / "spans.jsonl")] == ["kvq.t.x"]
    assert "kvq.t.x" in json.load(open(tmp_path / "d" /
                                       "spans_summary.json"))
    assert "kvq.t.x" in capsys.readouterr().out
    with tracing.recorded_to(None):
        with tracing.span("kvq.t.y"):
            pass
    assert not _by("kvq.t.y")
