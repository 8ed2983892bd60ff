"""On the card: one short run of each cell through ``portbench/run.py``
prints a correct result line (``pytest -m cuda portbench/tests``)."""

import json
import os
import subprocess
import sys

import pytest

from portbench.harness import spec as specs

CELLS = [w["name"] for w in specs.load_benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, os.path.join(specs.HERE, "run.py"), "--workload",
         cell, "--seed", "2147483747", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=specs.REPO, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]


def test_no_card_no_result():
    """Without a card (this host) the run prints no result and fails."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(specs.HERE, "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=specs.REPO, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
