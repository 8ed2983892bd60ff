"""A later change adds a cell, a mix, a configuration and a per-layer
metric with new files and new BENCHMARK.json entries only: here in a
copy, with a tiny cell that runs on the CPU."""

import json
import os
import shutil

from portbench.harness import core
from portbench.harness import spec as specs
from portbench.tests.tiny import tiny_spec

READER = '''"""Scored videos a second of the traced window, a new reader."""


def read(r):
    return r.trace["units"] / r.trace["window_s"]
'''


def test_new_cell_from_new_files_only(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(specs.REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(specs.REPO, "portbench"),
                    os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    tiny = tiny_spec("swin-train")
    cfg = dict(tiny["config"], name="tiny-swin")
    with open(os.path.join(root, "portbench", "configs", "tiny-swin.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "portbench", "traffic", "tiny-clips.json"),
              "w") as f:
        json.dump(tiny["mix"], f)
    with open(os.path.join(root, "portbench", "metrics",
                           "steps_traced.train.py"), "w") as f:
        f.write(READER)
    bench = specs.load_benchmark(root)
    bench["configs"].append({
        "name": "tiny-swin", "source": "https://arxiv.org/abs/2207.02595",
        "file": "portbench/configs/tiny-swin.json", "reduced": [],
        "why": "a test cell"})
    bench["workloads"].append({
        "name": "tiny-swin-train", "config": "tiny-swin",
        "traffic": "tiny-clips", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_steps_per_s":
            m["workloads"].append("tiny-swin-train")
    bench["per_layer"].append({
        "name": "steps_traced.train", "unit": "steps/s", "better": "higher",
        "source": "device_trace", "layer": "trainer",
        "moves": "train_steps_per_s", "workloads": ["tiny-swin-train"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    s = specs.cell_spec("tiny-swin-train", root)
    assert s["config"]["name"] == "tiny-swin"
    assert [m["name"] for m in s["per_layer"]] == ["steps_traced.train"]
    read = specs.metric_reader("steps_traced.train", root)
    assert read(type("R", (), {"trace": {"units": 6, "window_s": 2.0}})) == 3
    out = core.run_cell("tiny-swin-train", 9, 1.0, False, "cpu", s)
    assert out["correct"] and set(out["metrics"]) == {"train_steps_per_s",
                                                      "setup_s"}
