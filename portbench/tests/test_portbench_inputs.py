"""The generators are deterministic in the seed, and the work counts
match hand counts at tiny shapes."""

import numpy as np
import pytest
import torch

from portbench.harness import inputs, work
from portbench.reference.network import Network
from portbench.tests.tiny import tiny_spec

SEEDS = [0, 2 ** 31 + 11]


@pytest.mark.parametrize("cell", ["ksvqe-score", "ksvqe-train",
                                  "swin-train"])
def test_pool_deterministic_in_seed(cell):
    mix = tiny_spec(cell)["mix"]
    a, b = (inputs.make_pool(mix, SEEDS[1], "cpu") for _ in range(2))
    c = inputs.make_pool(mix, SEEDS[0], "cpu")
    assert len(a) == mix["pool"]
    for x, y, z in zip(a, b, c):
        for field in mix["fields"]:
            assert x[field].shape[0] == mix["batch_size"]
            np.testing.assert_array_equal(x[field], y[field])
        assert not np.array_equal(x[next(iter(mix["fields"]))],
                                  z[next(iter(mix["fields"]))])


@pytest.mark.parametrize("cell", ["ksvqe-score", "swin-train"])
def test_weights_deterministic_in_seed(cell):
    block = tiny_spec(cell)["config"]["model"]
    with torch.device("meta"):
        net = Network(block)
    shapes = inputs.state_shapes(net)
    a, b = (inputs.make_state_dict(shapes, block, SEEDS[1], "cpu")
            for _ in range(2))
    c = inputs.make_state_dict(shapes, block, SEEDS[0], "cpu")
    assert set(a) == set(shapes)
    for k in a:
        assert torch.equal(a[k], b[k])
    w = [k for k in a if k.endswith("qkv.weight")][0]
    assert not torch.equal(a[w], c[w])


def test_bound_is_the_larger_of_bytes_and_operations():
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12) == pytest.approx(1.0)
    assert work.bound_s(3.35e9, 989e12) == pytest.approx(1.0)


def test_swin_block_cost_by_hand():
    # one sample, volume (2, 7, 7) = one window of N = 98 tokens, C = 8,
    # 2 heads of 4, with the fragment plane
    f, fb, b, bb = work.swin_block_cost(1, (2, 7, 7), (2, 7, 7), 8, 2, True)
    N, C = 98, 8
    assert f == 2 * N * 12 * C * C + 4 * 2 * N * N * 4
    assert fb == 2 * N * C * 2 + 12 * C * C * 2 + 2 * 2 * N * N * 4 + 2 * 4
    assert b == 3 * f
    assert bb == (3 * N * C * 2 + 12 * C * C * 6 + 4 * 2 * N * N * 4
                  + 2 * 4)


def test_window_attention_cost_by_hand():
    # two samples, volume (4, 7, 14): 2 windows each, N = 196; 3 heads of 8
    f, fb, b, bb = work.window_attention_cost(2, (4, 7, 14), (4, 7, 7), 3,
                                              8, False)
    BW, N = 4, 196
    assert f == 4 * BW * 3 * N * N * 8
    assert fb == 4 * BW * 3 * N * 8 * 2 + 3 * N * N * 4 + BW * 3 * N * 4
    assert b == 2.5 * f
    assert bb == 8 * BW * 3 * N * 8 * 2 + 2 * 3 * N * N * 4 + BW * 3 * N * 4


def test_model_flops_of_a_head_by_hand():
    # the swin_tiny_grpb network at one 4x32x32 clip: every product is
    # counted; its head alone (768 -> 64 -> 1 over 2x1x1 tokens) by hand
    s = tiny_spec("swin-train")
    mix = {**s["mix"], "batch_size": 1}
    total = work.model_flops(s["config"], mix, train=False)
    stages = work.swin_stages(s["config"], mix)
    assert stages[0]["dims"] == (2, 8, 8)
    embed = 2 * (2 * 8 * 8) * (2 * 4 * 4 * 3) * 96
    head = 2 * 2 * (768 * 16 + 16 * 1)
    assert total > embed + head
    with torch.device("meta"):
        net = Network(s["config"]["model"]).eval()
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        net.swin_tiny_grpb_head(torch.zeros(1, 2, 1, 1, 768, device="meta"))
    assert fc.get_total_flops() == head
    assert work.model_flops(s["config"], mix, train=True) > 2 * total
