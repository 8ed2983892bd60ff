"""Optimizer, learning-rate schedule, frozen parameters and EMA (counterpart
of kvq_tpu/train/optim.py):

  - AdamW with b1 0.9, b2 0.999, eps 1e-8 and decoupled weight decay on
    every trainable parameter: ``torch.optim.AdamW`` computes optax.adamw's
    update (reference trainer.py:97-102);
  - linear warmup then cosine, the exact lambda of trainer.py:104-113,
    evaluated at the number of updates already made (0 for the first, as
    optax counts);
  - ``backbone_lr_mult`` scales the update of parameters under a
    ``*_backbone`` module (a parameter group; default 1);
  - frozen parameters (CLIP except its adapters, CONTRIQUE) get
    ``requires_grad=False`` and stay out of the optimizer, so autograd never
    computes their gradients (CLIP_backbone.py:141-154,
    KSVQE_model.py:1085-1086);
  - EMA over all parameters, e = decay * e + (1 - decay) * p
    (trainer.py:166-172);
  - ``optimizer_from_config``, ``step_settings`` and ``step_generator``:
    what a train step reads from the config and how it seeds its draws,
    shared by the Trainer and the sharded step (parallel/fsdp.py), as
    kvq_tpu/train/trainer.py reads them for both.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# (frozen substring, exempt substrings): the JAX package's
# KSVQE_FROZEN_PATTERNS, on the port's dotted parameter names
KSVQE_FROZEN_PATTERNS: tuple[tuple[str, tuple[str, ...]], ...] = (
    ("CLIP_tool", ("adapter",)),
    ("distortion_tool", ()),
)


def schedule_factor(step, warmup_iters: int, max_iters: int) -> float:
    """The warmup + cosine multiplier of the base learning rate at update
    ``step`` (0 for the first update)."""
    step = float(step)
    if warmup_iters > 0 and step <= warmup_iters:
        return step / max(warmup_iters, 1)
    return 0.5 * (1 + math.cos(math.pi * (step - warmup_iters)
                               / max(max_iters, 1)))


def warmup_cosine_schedule(base_lr: float, warmup_iters: int,
                           max_iters: int):
    """step -> learning rate (the JAX package's schedule function)."""
    return lambda step: base_lr * schedule_factor(step, warmup_iters,
                                                  max_iters)


def is_frozen(name: str, frozen_patterns) -> bool:
    return any(f in name and not any(e in name for e in exempt)
               for f, exempt in frozen_patterns)


def freeze(model: torch.nn.Module, frozen_patterns) -> None:
    """requires_grad=False on every parameter a pattern freezes."""
    for name, p in model.named_parameters():
        if is_frozen(name, frozen_patterns):
            p.requires_grad_(False)


def build_optimizer(named_params, lr: float, weight_decay: float,
                    warmup_iters: int, max_iters: int,
                    backbone_lr_mult: float = 1.0):
    """(AdamW over the trainable parameters of ``named_params``, ``(name,
    parameter)`` pairs, its LambdaLR schedule).  Step the schedule once
    after each optimizer step."""
    groups = {False: [], True: []}
    for name, p in named_params:
        if p.requires_grad:
            groups["_backbone" in name and backbone_lr_mult != 1.0].append(p)
    param_groups = [{"params": groups[False], "lr": lr}]
    if groups[True]:
        param_groups.append({"params": groups[True],
                             "lr": lr * backbone_lr_mult})
    opt = torch.optim.AdamW(param_groups, lr=lr, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=weight_decay)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule_factor(step, warmup_iters, max_iters))
    return opt, sched


def optimizer_from_config(named_params, config: dict,
                          steps_per_epoch: int):
    """``build_optimizer`` from a normalised config: ``optimizer``'s lr
    (3e-5), wd (0.05) and backbone_lr_mult (1), warmup over
    ``warmup_epochs`` and the cosine over ``num_epochs + l_num_epochs``
    epochs of ``steps_per_epoch`` updates."""
    opt = config.get("optimizer") or {}
    epochs = float(config.get("num_epochs", 1)) + float(
        config.get("l_num_epochs", 0))
    return build_optimizer(
        named_params,
        lr=float(opt.get("lr", 3e-5)),
        weight_decay=float(opt.get("wd", 0.05)),
        warmup_iters=int(float(config.get("warmup_epochs", 0))
                         * steps_per_epoch),
        max_iters=int(epochs * steps_per_epoch),
        backbone_lr_mult=float(opt.get("backbone_lr_mult", 1.0)))


class StepSettings(NamedTuple):
    contra_w: float         # contra_loss_weight
    rank_w: float           # rank_loss_weight
    use_ema: bool           # ema
    ema_decay: float
    backbone_lr_mult: float


def step_settings(config: dict) -> StepSettings:
    """The loss weights, EMA and backbone multiplier of a normalised
    config, with the Trainer's defaults."""
    opt = config.get("optimizer") or {}
    return StepSettings(
        contra_w=float(config.get("contra_loss_weight", 0.3)),
        rank_w=float(config.get("rank_loss_weight", 0.0)),
        use_ema=bool(config.get("ema", True)),
        ema_decay=float(config.get("ema_decay", 0.999)),
        backbone_lr_mult=float(opt.get("backbone_lr_mult", 1.0)))


def step_generator(device, seed: int, rank: int = 0) -> torch.Generator:
    """Rank ``rank``'s generator of the train forward's draws (QRS,
    DropPath, dropout): seeded ``seed + 1 + rank * 2**32``, so rank 0
    draws as the one-process trainer."""
    return torch.Generator(device=device).manual_seed(
        seed + 1 + rank * 2 ** 32)


@torch.no_grad()
def ema_update(ema: list[torch.Tensor], params: list[torch.Tensor],
               decay: float = 0.999) -> None:
    """In place: e = e * decay + p * (1 - decay), for every pair."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, params, alpha=1.0 - decay)
