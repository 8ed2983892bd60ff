"""A run with the timed path broken underneath comes out not correct:
the harness runs as it does on the card (all but its look for one), on
the CPU at a tiny size, with the configurations' own limits, once for
each fault a cell can have (``harness/faults.py``; one card: no exchange
between chips)."""

import pytest

from portbench.harness import core, faults
from portbench.tests.tiny import tiny_spec

TRAIN = ["ksvqe-train", "swin-train", "swin-train-fast"]


def _run(cell):
    return core.run_cell(cell, 3, 1.0, False, "cpu", tiny_spec(cell))


@pytest.mark.parametrize("cell", ["ksvqe-score"] + TRAIN)
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["ksvqe-score"] + TRAIN)
def test_answer_altered_where_produced(cell):
    with faults.answer_altered():
        out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["feature_gap"]["value"] > out["checks"][
        "feature_gap"]["limit"]


@pytest.mark.parametrize("cell", TRAIN)
def test_state_left_unchanged(cell):
    with faults.state_unchanged():
        out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["change_gap_median"]["value"] >= 0.99


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out(cell):
    with faults.half_batch():
        out = _run(cell)
    assert not out["correct"]


@pytest.mark.parametrize("fault, check", [("scores_shifted",
                                           "readback_errors"),
                                          ("score_altered", "head_gap")])
def test_score_fault_after_the_backbone(fault, check):
    """A score read back in another batch's place, or altered where the
    head produces it: the features hold, the scores do not."""
    with faults.FAULTS[fault]():
        out = _run("ksvqe-score")
    assert not out["correct"]
    c = out["checks"][check]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("fault, check", [("one_learning_rate",
                                           "change_gap_median"),
                                          ("rank_dropped", "loss_gap")])
def test_optimizer_and_loss_as_the_configuration_states(fault, check):
    """On the cell whose schedule states fast-b.yml's backbone learning
    rate multiplier (0.1) and rank loss weight (0.3): the backbone trained
    at the head's learning rate moves ~10x as far as the reference's; the
    rank loss left out changes every step's loss."""
    with faults.FAULTS[fault]():
        out = _run("swin-train-fast")
    assert not out["correct"]
    c = out["checks"][check]
    assert c["value"] > c["limit"]
