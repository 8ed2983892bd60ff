"""FAST-VQA-B as ``options/fast/fast-b.yml`` trains it, the benchmark's
configuration ``portbench/configs/fastvqa-b.json`` under its mix
``portbench/traffic/fastvqa-train-b16-pool4.json``: its published widths
and route at the mix's shapes, the cell's check at a tiny size on the CPU
(sound, and with the optimizer or the loss not as the configuration
states), and the Trainer's ``kvq.train.loss`` span.

On the card (this file imports no JAX), one Trainer step at the mix's
full size, B=16 and technical (32, 224, 224, 3):

    python -m pytest --noconftest -m cuda -s tests/test_torch_fastvqa_b.py
"""

import contextlib
import copy
import json
import os

import numpy as np
import pytest
import torch

from kvq_tpu_torch.core import tracing
from kvq_tpu_torch.nn.reference_routing import takes_fused_block
from kvq_tpu_torch.nn.swin import get_window_size
from kvq_tpu_torch.ops import train_attention as TA
from kvq_tpu_torch.ops.window_attention import WindowGeometry
from kvq_tpu_torch.train.trainer import Trainer
from portbench.harness import core, faults, work
from portbench.harness import spec as specs
from portbench.reference.network import Network

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path):
    with open(os.path.join(REPO, path)) as f:
        return json.load(f)


CONFIG = _load("portbench/configs/fastvqa-b.json")
MIX = _load("portbench/traffic/fastvqa-train-b16-pool4.json")

# the CPU's cut: the configuration's model in float32 at its widths, its
# schedule, reference_rows and limits, on a batch of 6 rows (blocks of 4
# and 2 in the reference's step) of (4, 32, 32, 3) clips
TINY_ROWS, TINY_CLIP = 6, [4, 32, 32, 3]


def tiny_spec() -> dict:
    cfg = copy.deepcopy(CONFIG)
    cfg["model"]["compute_dtype"] = "float32"
    cfg["steps_per_epoch"] = 1
    mix = copy.deepcopy(MIX)
    mix["batch_size"] = TINY_ROWS
    mix["fields"]["technical"]["shape"] = TINY_CLIP
    return {"cell": {"name": "fastvqa-train", "config": cfg["name"],
                     "traffic": "tiny-clips", "chips": 1},
            "config": cfg, "mix": mix, "end_to_end": [], "per_layer": [],
            "root": REPO}


def test_published_widths_and_route():
    """28,127,901 parameters; stage volumes (16,56,56) to (16,7,7), none
    padded, windows (8,7,7), fragment biases on stages 0-2; both blocks
    of each of stages 0-2 take the fused train block (K4) and stage 3's
    take the window attention (K5), by the reference's gate."""
    assert CONFIG["reduced"] == []
    with torch.device("meta"):
        net = Network(CONFIG["model"])
    assert sum(p.numel() for p in net.parameters()) == 28_127_901
    stages = work.swin_stages(CONFIG, MIX)
    assert [s["dims"] for s in stages] == [(16, 56, 56), (16, 28, 28),
                                           (16, 14, 14), (16, 7, 7)]
    assert [s["padded"] for s in stages] == [s["dims"] for s in stages]
    assert [s["window"] for s in stages] == [(8, 7, 7)] * 4
    assert [s["frag"] for s in stages] == [True, True, True, False]
    assert [(s["C"], s["heads"], s["depth"]) for s in stages] == [
        (96, 3, 2), (192, 6, 2), (384, 12, 6), (768, 24, 2)]
    assert {s["batch"] for s in stages} == {MIX["batch_size"]}
    route = []
    for s in stages:
        for j in range(s["depth"]):
            shift = (4, 3, 3) if j % 2 else (0, 0, 0)
            window, shift = get_window_size(s["dims"], (8, 7, 7), shift)
            geo = WindowGeometry(
                batch=s["batch"], dims=s["dims"], window=window, shift=shift,
                fragments=(1, 7, 7), num_heads=s["heads"],
                head_dim=s["C"] // s["heads"], use_frag=s["frag"])
            route.append(takes_fused_block(geo, s["C"], 4 * s["C"], True))
    assert route == [True] * 10 + [False] * 2


def _run(fault=None):
    with faults.FAULTS[fault]() if fault else contextlib.nullcontext():
        return core.run_cell("fastvqa-train", 3, 0.5, False, "cpu",
                             tiny_spec())


def test_tiny_cell_is_correct():
    """The configuration's own schedule (two AdamW groups, the rank loss),
    reference rows and limits: the program's first three steps agree with
    the reference's, computed in row blocks."""
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"feature_gap", "loss_gap",
                                  "change_gap_median"}


@pytest.mark.parametrize("fault, check", [("one_learning_rate",
                                           "change_gap_median"),
                                          ("rank_dropped", "loss_gap")])
def test_tiny_cell_faults(fault, check):
    """The backbone at the head's learning rate, or the rank loss left
    out: not correct, by the check that each moves."""
    out = _run(fault)
    assert not out["correct"]
    c = out["checks"][check]
    assert c["value"] > c["limit"]


def _batches(n, seed):
    rng = np.random.default_rng(seed)
    return [{"technical": rng.normal(size=(TINY_ROWS, *TINY_CLIP)).astype(
                np.float32),
             "label": rng.normal(size=(TINY_ROWS,)).astype(np.float32)}
            for _ in range(n)]


def test_loss_span_each_step():
    """``kvq.train.loss`` is recorded once a step, inside that step's
    ``kvq.train.forward``, on the dispatch thread; the cell's reader
    ``loss_ms_per_step.fastvqa`` gives its total over the forward spans'
    count, and nothing where no span was recorded."""
    cfg = tiny_spec()["config"]
    tr = Trainer({"name": cfg["name"], "model": cfg["model"],
                  **cfg["schedule"]}, device="cpu", seed=0)
    read = specs.metric_reader("loss_ms_per_step.fastvqa")
    tracing.reset()
    try:
        assert read(None) is None
        with tracing.recording():
            tr.train_epoch(_batches(2, 0))
        got = tracing.spans()
        summ = tracing.summary()
        assert read(None) == pytest.approx(
            summ["kvq.train.loss"]["dispatch"]["total_ms"] / 2)
    finally:
        tracing.reset()
    ids = {x["id"]: x for x in got}
    loss = [x for x in got if x["name"] == "kvq.train.loss"]
    assert sorted(x["unit"] for x in loss) == [0, 1]
    for x in loss:
        parent = ids[x["parent"]]
        assert parent["name"] == "kvq.train.forward"
        assert parent["unit"] == x["unit"]
        assert x["role"] == "dispatch"


@pytest.mark.cuda
def test_full_size_step_on_the_card():
    """One Trainer step at the mix's full size (B=16, 32 frames of 224²,
    bf16, no remat) after a warm-up step: every Swin block on the port's
    kernels (K4 10 a step forward and backward, K5 2), a finite loss, and
    the step's peak memory, printed, under 70 GB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 and K5 have no CPU mode")
    dev = torch.device("cuda")
    cfg = {"name": CONFIG["name"], "model": CONFIG["model"],
           **CONFIG["schedule"]}
    tr = Trainer(cfg, device=dev, seed=7,
                 steps_per_epoch=CONFIG["steps_per_epoch"])
    gen = torch.Generator(device=dev).manual_seed(7)
    batch = {"technical": torch.randn(
        (MIX["batch_size"], *MIX["fields"]["technical"]["shape"]),
        generator=gen, device=dev).cpu().numpy(),
        "label": torch.randn((MIX["batch_size"],), generator=gen,
                             device=dev).cpu().numpy()}
    tr.train_step(batch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = (TA.train_swin_block, TA.train_swin_block_bwd,
               TA.window_attention_train, TA.window_attention_train_bwd)
    before = [k.launches for k in kernels]
    loss = tr.train_step(batch)["total_loss"]
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    counts = [k.launches - b for k, b in zip(kernels, before)]
    print(f"fastvqa-b step on {torch.cuda.get_device_name(dev)}: loss "
          f"{loss!r}, peak {peak} B, K4 fwd/bwd, K5 fwd/bwd {counts}")
    assert counts == [10, 10, 2, 2]
    assert np.isfinite(loss)
    assert peak < 70e9
