"""The ledger of the port's kernel launches (kvq_tpu_torch/ops/launches.py):
which wrappers count, in which order, and the counters' round trip."""

import pytest

from kvq_tpu_torch.ops import launches
from kvq_tpu_torch.ops import train_attention as TA
from kvq_tpu_torch.ops import window_attention as WA
from portbench.harness import entries


def test_each_wrapper_is_registered_once_in_order():
    """The nine wrappers, each under its own name and once (a second
    registration is refused), in the order of ``NAMES``; the counters the
    benchmark reads (``portbench/harness/entries.py``) name the seven they
    share in the same order."""
    assert launches.wrappers() == (
        WA.fused_swin_block, WA.flash_attention_nobias_cl,
        WA.flash_window_attention_packed, WA.flash_window_attention,
        WA.flash_attention_nobias, TA.train_swin_block,
        TA.train_swin_block_bwd, TA.window_attention_train,
        TA.window_attention_train_bwd)
    assert [f.__name__ for f in launches.wrappers()] == list(launches.NAMES)
    assert len(set(launches.wrappers())) == 9
    with pytest.raises(ValueError):
        launches.counted(WA.fused_swin_block)
    saved = launches.snapshot()
    try:
        launches.restore(range(100, 109))  # a distinct count a wrapper
        read = list(entries._kernel_counters().values())
    finally:
        launches.restore(saved)
    assert len(read) == 7 and read == sorted(set(read))


def test_snapshot_restore_and_add_round_trip():
    """What ``snapshot`` reads ``restore`` puts back; ``add`` adds in the
    order of ``NAMES``, and ``diff`` takes it back out."""
    saved = launches.snapshot()
    try:
        launches.restore([3, 1, 4, 1, 5, 9, 2, 6, 5])
        before = launches.snapshot()
        assert before == [3, 1, 4, 1, 5, 9, 2, 6, 5]
        assert WA.flash_window_attention_packed.launches == 4
        launches.add([0, 0, 0, 0, 0, 10, 10, 2, 2])
        assert TA.train_swin_block.launches == 19
        assert launches.diff(before, launches.snapshot()) == [
            0, 0, 0, 0, 0, 10, 10, 2, 2]
    finally:
        launches.restore(saved)
    assert launches.snapshot() == saved
