"""At a tiny size on the CPU, in float32: each entry's run through the
program's plain versions agrees with the reference (a frozen copy of the
plain path), so the check reads rounding alone; in bfloat16 it reads
more, and the float8 control more again."""

import pytest
import torch

from portbench.harness import core, entries, inputs
from portbench.tests.tiny import tiny_spec

CELLS = ["ksvqe-score", "ksvqe-train", "swin-train", "swin-train-fast"]
# float32 against float32: rounding of another order of operations
F32 = {"feature_gap": 1e-5, "head_gap": 1e-5, "readback_errors": 0,
       "repeat_gap": 0.0, "score_gap": 1e-5, "cls_attn_gap": 1e-5,
       "pick_errors": 0, "loss_gap": 1e-5,
       "loss1_gap": 1e-5, "grad_gap": 1e-4, "grad_gap_median": 1e-5,
       "change_gap": 5e-3, "change_gap_median": 1e-4}


def _run(cell, dtype, seed=7):
    torch.manual_seed(0)
    return core.run_cell(cell, seed, 1.0, False, "cpu",
                         tiny_spec(cell, dtype))


@pytest.mark.parametrize("cell", CELLS)
def test_float32_program_matches_reference(cell):
    out = _run(cell, "float32")
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, value in out["readings"].items():
        assert value <= F32[name], (name, value)
    assert out["correct"]


@pytest.mark.parametrize("cell", ["ksvqe-score", "swin-train",
                                  "swin-train-fast"])
def test_control_reads_above_bfloat16_program(cell):
    """The control (float8 products) reads higher than the bfloat16
    program on the features, the measure that separates them at full size
    (PERF.md)."""
    prog = _run(cell, "bfloat16", seed=5)["checks"]
    s = tiny_spec(cell, "bfloat16")
    ctx = core.Ctx(s["cell"], s["config"], s["mix"], 5, torch.device("cpu"))
    state = {"pool": inputs.make_pool(ctx.mix, 5, ctx.device)}
    ctrl, bad = entries.ENTRIES[ctx.mix["entry"]].judge(ctx, state,
                                                        control=True)
    assert bad == 0
    assert ctrl["feature_gap"] > 3 * prog["feature_gap"]["value"]
