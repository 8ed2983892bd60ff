"""Config helpers (copy of kvq_tpu/core/config.py's plain-dict layer).

Same YAML schema as the reference configs.  ``yaml`` is imported inside
:func:`load_config` only, so nothing on the evaluator's path needs PyYAML.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

_TOP_LEVEL_DEFAULTS: dict[str, Any] = {
    "name": "experiment",
    "num_epochs": 1,
    "l_num_epochs": 0,
    "warmup_epochs": 0.0,
    "ema": True,
    "ema_decay": 0.999,
    "save_model": True,
    "batch_size": 4,
    "num_workers": 6,
    "split_seed": 42,
    "ddp": False,
    "seed": 42,
    "load_path": None,
    "test_load_path": None,
    "rank_loss_weight": 0.0,
    "contra_loss_weight": 0.3,
    "compute_dtype": "bfloat16",
    "param_dtype": "float32",
}


def load_config(path: str) -> dict[str, Any]:
    """Load a YAML config file, reference-schema compatible."""
    import yaml

    with open(path, "r") as f:
        cfg = yaml.safe_load(f)
    return normalize_config(cfg)


def normalize_config(cfg: Mapping[str, Any]) -> dict[str, Any]:
    """Fill defaults and validate the minimal structure."""
    out = copy.deepcopy(dict(cfg))
    for k, v in _TOP_LEVEL_DEFAULTS.items():
        out.setdefault(k, v)
    if "model" in out:
        model = out["model"]
        if "type" not in model or "args" not in model:
            raise ValueError("config['model'] must have 'type' and 'args' keys")
    if "optimizer" in out:
        opt = out["optimizer"]
        opt.setdefault("lr", 3e-5)
        opt.setdefault("backbone_lr_mult", 1.0)
        opt.setdefault("wd", 0.05)
    return out


def model_keys(cfg: Mapping[str, Any]) -> list[str]:
    """The registry keys composing the model (reference models/model.py:28)."""
    return list(cfg["model"]["args"].keys())


def key_list(cfg: Mapping[str, Any]) -> list[str]:
    """Data-dict keys the evaluator reshapes (reference trainer.py:56)."""
    return str(cfg["model"]["type"]).split(",")
