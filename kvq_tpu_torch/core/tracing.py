"""Spans of the program's phases on the host clock.

``span(name, unit=None, **attrs)`` marks a phase, as a context manager
(``with span("kvq.eval.forward", i):``) or as a decorator
(``@span("kvq.k1")``).  A recorded span keeps its name, its thread and that
thread's role (``dispatch``, ``worker`` or ``autograd``), its start and end
(``time.perf_counter_ns``), the enclosing span on the same thread and its
unit: the Evaluator's batch index or the Trainer's step, given where a
phase begins, else the enclosing span's, else the unit the dispatch thread
began last (:func:`begin_unit`).

Spans are recorded only while a ``torch.profiler`` runs on the dispatch
thread, or inside :func:`recording`.  Under a profiler each span also opens
a ``record_function`` range of its name, so the device trace shows what
the host was doing on the profiler's own clock.  Other threads do not see
the dispatch thread's profiler (the autograd engine's threads inherit it):
they follow the state the dispatch thread saw at its last unit boundary.
A span during which the profiler stopped is dropped: its time holds the
profiler's teardown.  With recording off, a span checks a flag, asks
whether this thread profiles and hands out a shared object that does
nothing: no ``record_function`` and no record are made.

:func:`summary` gives each name's count, total and self time (the total
less what its child spans on the same thread cover) by thread role;
:func:`write` dumps the spans as JSON lines; :func:`reset` clears them.
A ``gc.callbacks`` hook records each collection as ``kvq.gc`` with its
generation.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd.profiler import record_function

_profiling = torch.autograd._profiler_enabled
_now = time.perf_counter_ns
_get_ident = threading.get_ident

_depth = 0          # open recording() blocks
_follow = False     # the dispatch thread's profiler at its last unit boundary
_on = False         # _depth > 0 or _follow: what a span checks first
_dispatch = threading.main_thread().ident
_unit = None        # the unit the dispatch thread began last
_lock = threading.Lock()
_spans: list[dict] = []
_ids = itertools.count(1)
_local = threading.local()
_gc_open = None
_nulls: dict = {}


def span(name: str, unit=None, **attrs):
    """The phase ``name``: a context manager for one ``with``, or a
    decorator, whose spans take the enclosing span's unit.  Recording off
    and no ``attrs``, it is one shared object that does nothing."""
    if _on or _profiling() or attrs:
        return _Span(name, unit, attrs)
    null = _nulls.get(name)
    if null is None:
        null = _nulls[name] = _Null(name)
    return null


class _Null:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _Span(self.name, None, {})(fn)


class _Span:
    __slots__ = ("name", "unit", "attrs", "_open")

    def __init__(self, name, unit, attrs):
        self.name, self.unit, self.attrs = name, unit, attrs
        self._open = None

    def __enter__(self):
        if _on or _profiling():
            self._open = _begin(self.name, self.unit, self.attrs)
        return self

    def __exit__(self, *exc):
        if self._open is not None:
            _end(self._open)
            self._open = None
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            if not (_on or _profiling()):
                return fn(*args, **kwargs)
            rec = _begin(name, None, attrs)
            try:
                return fn(*args, **kwargs)
            finally:
                if rec is not None:
                    _end(rec)
        return traced


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _begin(name, unit, attrs):
    prof = _profiling()
    if not (prof or _depth) and _get_ident() == _dispatch:
        return None  # the profiler stopped since the last unit boundary
    st = _stack()
    parent = st[-1] if st else None
    if unit is None:
        unit = parent["unit"] if parent is not None else _unit
    rec = {"name": name, "id": next(_ids),
           "parent": parent["id"] if parent is not None else None,
           "unit": unit, "attrs": attrs, "prof": prof, "range": None}
    if prof:
        rec["range"] = record_function(name).__enter__()
    st.append(rec)
    rec["start"] = _now()
    return rec


def _role(ident: int) -> str:
    if ident == _dispatch:
        return "dispatch"
    return "autograd" if torch._C._current_graph_task_id() != -1 else "worker"


def _end(rec) -> None:
    end = _now()
    rng = rec.pop("range")
    if rng is not None:
        rng.__exit__(None, None, None)
    st = _stack()
    for i in range(len(st) - 1, -1, -1):  # the last but for a finalizer's
        if st[i] is rec:
            del st[i]
            break
    if rec.pop("prof") and not (_depth or _profiling()):
        return  # the profiler stopped inside the span
    ident = _get_ident()
    rec.update(end=end, thread=ident, role=_role(ident))
    _spans.append(rec)


def begin_unit(unit) -> None:
    """Called by the dispatch thread where a unit (a batch, a step) begins:
    names the unit and this thread, and refreshes the state that other
    threads follow."""
    global _unit, _dispatch, _follow, _on
    _unit = unit
    _dispatch = _get_ident()
    _follow = _profiling()
    _on = _follow or _depth > 0


@contextlib.contextmanager
def recording():
    """Record spans inside the block, profiler or not."""
    global _depth, _on
    with _lock:
        _depth += 1
        _on = True
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            _on = _follow or _depth > 0


def mark() -> int:
    """An id below every span that begins after this call."""
    return next(_ids)


def spans(since: int = 0) -> list[dict]:
    """The recorded spans (ids from ``since``) in the order they ended."""
    return [s for s in list(_spans) if s["id"] >= since]


def reset() -> None:
    _spans.clear()


def summary(since: int = 0) -> dict:
    """``{name: {role: {"count", "total_ms", "self_ms"}}}`` over the
    recorded spans (ids from ``since``)."""
    got = spans(since)
    covered: dict[int, int] = {}
    for s in got:
        if s["parent"] is not None:
            covered[s["parent"]] = (covered.get(s["parent"], 0)
                                    + s["end"] - s["start"])
    ns: dict = {}
    for s in got:
        d = ns.setdefault(s["name"], {}).setdefault(s["role"], [0, 0, 0])
        length = s["end"] - s["start"]
        d[0] += 1
        d[1] += length
        d[2] += length - covered.get(s["id"], 0)
    return {name: {role: {"count": c, "total_ms": t / 1e6, "self_ms": m / 1e6}
                   for role, (c, t, m) in roles.items()}
            for name, roles in ns.items()}


def format_summary(summ: dict) -> str:
    lines = [f"{'span':<24} {'role':<9} {'count':>7} {'total ms':>12} "
             f"{'self ms':>12}"]
    for name in sorted(summ):
        for role, d in sorted(summ[name].items()):
            lines.append(f"{name:<24} {role:<9} {d['count']:>7} "
                         f"{d['total_ms']:>12.3f} {d['self_ms']:>12.3f}")
    return "\n".join(lines)


def write(path: str, since: int = 0) -> int:
    """The spans as JSON lines (``name``, ``role``, ``thread``, ``unit``,
    ``start_ns``, ``end_ns``, ``id``, ``parent``, ``attrs``); returns how
    many."""
    got = spans(since)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for s in got:
            f.write(json.dumps({
                "name": s["name"], "role": s["role"], "thread": s["thread"],
                "unit": s["unit"], "start_ns": s["start"],
                "end_ns": s["end"], "id": s["id"], "parent": s["parent"],
                "attrs": s["attrs"]}, default=str) + "\n")
    return len(got)


def export(directory: str, since: int = 0, rank: int = 0,
           world: int = 1) -> str:
    """``spans.jsonl`` (``spans.rank<r>.jsonl`` in a group of more than one
    rank) and its summary (``spans_summary.json``, likewise) in
    ``directory``; returns the spans' path."""
    tag = f".rank{rank}" if world > 1 else ""
    path = os.path.join(directory, f"spans{tag}.jsonl")
    write(path, since)
    with open(os.path.join(directory, f"spans_summary{tag}.json"), "w") as f:
        json.dump(summary(since), f, indent=1, sort_keys=True)
    return path


@contextlib.contextmanager
def recorded_to(directory: str | None):
    """Record inside the block and :func:`export` what began in it to
    ``directory`` at its end (this rank's files in a process group), and
    print the summary (rank 0); nothing when ``directory`` is empty."""
    if not directory:
        yield
        return
    import torch.distributed as dist

    since = mark()
    try:
        with recording():
            yield
    finally:
        multi = dist.is_available() and dist.is_initialized()
        rank = dist.get_rank() if multi else 0
        path = export(directory, since, rank,
                      dist.get_world_size() if multi else 1)
        if rank == 0:
            print(f"spans: {path}\n{format_summary(summary(since))}",
                  flush=True)


def _collection(phase: str, info: dict) -> None:
    global _gc_open
    if phase == "start":
        if _on or _profiling():
            _gc_open = _begin("kvq.gc", None,
                              {"generation": info.get("generation")})
    elif _gc_open is not None:
        rec, _gc_open = _gc_open, None
        _end(rec)


gc.callbacks.append(_collection)
