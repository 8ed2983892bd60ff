"""Tiny cells for the CPU tests: the benchmark's entries, reference and
checks at widths a test run can hold (the kernels' wrappers run their
plain versions on CPU tensors)."""

from __future__ import annotations

import copy
import json
import os

from portbench.harness import spec as specs

TINY_KSVQE = {
    "num_samples": 1, "sample_type": "topkpertubation", "tuning_stage": 1,
    "a1": 1.0, "a2": 2.0, "anchor_size": 8, "region_k": 9, "embed_dim": 16,
    "depths": [1, 1], "num_heads": [2, 2], "CLIP_location": 1,
    "window_size": [2, 7, 7], "checkpoint": False,
    "contrique_layers": [1, 1, 1, 1], "clip_layers": 2, "clip_width": 64,
    "clip_heads": 4, "use_pallas": True, "s2d_input": True,
}

KSVQE_FIELDS = {
    "fragment": {"shape": [4, 10, 10, 96], "law": "normal"},
    "resize_video": {"shape": [8, 32, 32, 3], "law": "normal"},
    "label": {"shape": [], "law": "normal"},
    "dis_label": {"shape": [], "law": "randint", "high": 4},
}


# a Swin-T-3D key's train cell: the generic path a later configuration of
# FAST-VQA's family takes (no QRS), with its schedule and limits here
SWIN = {"name": "tiny-swin", "schedule": None, "steps_per_epoch": 1,
        "limits": {"train": {"feature_gap": 0.04,
                             "change_gap_median": 0.05}}}
# the same path under fast-b.yml's own optimizer and loss (FAST-VQA's
# training: a tenth of the head's learning rate on the backbone, 0.3 x the
# rank loss), its reference step in blocks of two rows
SWIN_FAST = {"name": "tiny-swin-fast", "steps_per_epoch": 1,
             "reference_rows": 2,
             "schedule": {"num_epochs": 30, "l_num_epochs": 0,
                          "warmup_epochs": 2.5, "ema": True,
                          "ema_decay": 0.999, "batch_size": 4,
                          "rank_loss_weight": 0.3,
                          "optimizer": {"lr": 1e-3, "backbone_lr_mult": 0.1,
                                        "wd": 0.05}},
             "limits": {"train": {"feature_gap": 0.04, "loss_gap": 0.03,
                                  "change_gap_median": 0.05}}}
SWIN_CONFIGS = {"tiny-swin": SWIN, "tiny-swin-fast": SWIN_FAST}
SWIN_MIX = {"entry": "train", "batch_size": 4, "pool": 4,
            "fields": {"technical": {"shape": [4, 32, 32, 3],
                                     "law": "normal"},
                       "label": {"shape": [], "law": "normal"}}}


def _config(name: str, dtype: str) -> dict:
    """The configuration ``name`` (its schedule and limits) with a tiny
    model in ``dtype``."""
    if name == "ksvqe":
        cfg = load_json("portbench/configs/ksvqe.json")
        cfg["model"] = {"type": "KSVQE", "compute_dtype": dtype, "args": {
            "KSVQE": {"backbone": dict(TINY_KSVQE),
                      "head": {"hidden_channels": 16}}}}
    else:
        cfg = copy.deepcopy(SWIN_CONFIGS[name])
        cfg["schedule"] = cfg["schedule"] or load_json(
            "portbench/configs/ksvqe.json")["schedule"]
        cfg["model"] = {"type": "swin_tiny_grpb", "compute_dtype": dtype,
                        "args": {"swin_tiny_grpb": {
                            "backbone": {"checkpoint": True,
                                         "use_pallas": True},
                            "head": {"hidden_channels": 16}}}}
    cfg["steps_per_epoch"] = 1
    return cfg


# (configuration, traffic mix) of each cell the tests run: the benchmark's
# cells, and tiny Swin-T-3D train cells of their own
CELLS = {"ksvqe-score": ("ksvqe", "val-b1-pool8"),
         "ksvqe-train": ("ksvqe", "ksvqe-train-b4-pool4"),
         "swin-train": ("tiny-swin", None),
         "swin-train-fast": ("tiny-swin-fast", None)}


def tiny_spec(cell: str, dtype: str = "float32") -> dict:
    """The spec of ``cell`` at a tiny size, from its files by name."""
    config, traffic = CELLS[cell]
    cfg = _config(config, dtype)
    if config == "ksvqe":
        mix = load_json(f"portbench/traffic/{traffic}.json")
        mix.update(pool=3 if mix["entry"] == "score" else 4,
                   fields=copy.deepcopy(KSVQE_FIELDS))
    else:
        mix, traffic = copy.deepcopy(SWIN_MIX), "tiny-clips"
    bench = specs.load_benchmark()
    e2e = ["videos_per_s", "video_p95_ms"] if mix["entry"] == "score" else [
        "train_steps_per_s"]
    return {"cell": {"name": cell, "config": config, "traffic": traffic,
                     "chips": 1},
            "config": cfg, "mix": mix,
            "end_to_end": [m for m in bench["end_to_end"]
                           if m["name"] in e2e + ["setup_s"]],
            "per_layer": [], "root": specs.REPO}


def load_json(path: str) -> dict:
    with open(os.path.join(specs.REPO, path)) as f:
        return json.load(f)
