"""BENCHMARK.json against the contract's form, and every piece of every
cell found by name."""

import json
import os
import re

import pytest

from portbench.harness import spec as specs

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
BENCH = specs.load_benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == TOP
    raw = open(os.path.join(specs.REPO, "BENCHMARK.json"), "rb").read()
    assert len(raw) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w)
                                               for w in BENCH["command"])


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k)
                                              for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        cells.append((w["config"], w["traffic"]))
    assert len(set(cells)) == len(cells)
    metrics = []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        metrics.append(m["name"])
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_pieces_found_by_name(cell):
    s = specs.cell_spec(cell)
    assert s["config"]["name"] == s["cell"]["config"]
    assert s["mix"]["entry"] in ("score", "train")
    assert s["config"]["limits"][s["mix"]["entry"]]
    reported = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert s["per_layer"]
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(specs.metric_reader(m["name"]))
    for m in s["per_layer"]:
        assert m["moves"] in reported


def test_config_files_are_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.load(open(os.path.join(specs.REPO, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
