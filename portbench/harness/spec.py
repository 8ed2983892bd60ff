"""Finds each piece of a cell by the names in ``BENCHMARK.json``: the
configuration file it names, the traffic mix ``traffic/<name>.json`` and,
for each per-layer metric, its reader ``metrics/<name>.py``."""

from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(HERE)


def load_benchmark(root: str = REPO) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, root: str = REPO) -> dict:
    """The workload ``name`` with its configuration, mix and metrics."""
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = work[name]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return {
        "cell": cell,
        "config": _load_json(os.path.join(root, cfg["file"])),
        "mix": _load_json(os.path.join(root, "portbench", "traffic",
                                       cell["traffic"] + ".json")),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if applies(m, name)],
        "root": root,
    }


def metric_reader(name: str, root: str = REPO):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
