"""The reference network, its losses and its train step, in float32.

``Network(model_block)`` holds a ``<key>_backbone`` and a ``<key>_head``
for the one model key of the block (``KSVQE`` or a Swin-T-3D key), under
the names of the reference checkpoints, which the program uses too.
``TrainStep`` is the reference's step: the forward (its draws from a
generator seeded as the program seeds its own: ``seed + 1``), 0.3 x
KSVQE's contrastive loss plus the PLCC loss, the backward, AdamW (b1 0.9,
b2 0.999, eps 1e-8, decoupled weight decay) under the linear warmup and
cosine schedule, and the EMA.  KSVQE's CLIP (but for its adapters) and
CONTRIQUE are frozen and get no gradient.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .ksvqe import KSVQE, ksvqe_config
from .layers import VQAHead
from .swin import PRESETS, SwinConfig, SwinTransformer3D

FROZEN = (("CLIP_tool", ("adapter",)), ("distortion_tool", ()))


def model_key(block: dict) -> str:
    (key,) = block["args"].keys()
    return key


class Network(nn.Module):
    def __init__(self, block: dict):
        super().__init__()
        self.key = model_key(block)
        hypers = block["args"][self.key] or {}
        bb = hypers.get("backbone") or {}
        if self.key == "KSVQE":
            backbone = KSVQE(ksvqe_config(bb))
        elif self.key in PRESETS:
            kw = dict(PRESETS[self.key])
            if "window_size" in bb:
                kw["window_size"] = tuple(bb["window_size"])
            backbone = SwinTransformer3D(SwinConfig(**kw))
        else:
            raise NotImplementedError(f"no reference for {self.key!r}")
        head = hypers.get("head") or {}
        setattr(self, f"{self.key}_backbone", backbone)
        setattr(self, f"{self.key}_head", VQAHead(
            backbone.num_features, int(head.get("hidden_channels", 64))))

    @property
    def backbone(self):
        return getattr(self, f"{self.key}_backbone")

    @property
    def head(self):
        return getattr(self, f"{self.key}_head")

    def features(self, batch, gen=None):
        """-> (the backbone's features, KSVQE's contrastive loss or None)."""
        feat = self.backbone(batch, gen)
        return feat if self.key == "KSVQE" else (feat, None)

    def forward(self, batch, gen=None):
        """-> (scores (B, 1), KSVQE's contrastive loss or None)."""
        feat, dis = self.features(batch, gen)
        return self.head(feat, gen), dis


def is_frozen(key: str, name: str) -> bool:
    return key == "KSVQE" and any(
        f in name and not any(e in name for e in exempt)
        for f, exempt in FROZEN)


def _std(x):
    return (x - x.mean()).square().mean().sqrt()


def plcc_loss(y_pred, y):
    y_pred = (y_pred - y_pred.mean()) / (_std(y_pred) + 1e-8)
    y = (y - y.mean()) / (_std(y) + 1e-8)
    loss0 = ((y_pred - y) ** 2).mean() / 4
    rho = (y_pred * y).mean()
    loss1 = ((rho * y_pred - y) ** 2).mean() / 4
    return (loss0 + loss1) / 2


def schedule_factor(step: int, warmup: int, total: int) -> float:
    if warmup > 0 and step <= warmup:
        return step / max(warmup, 1)
    return 0.5 * (1 + math.cos(math.pi * (step - warmup) / max(total, 1)))


class TrainStep:
    """The reference's train state on ``model`` (float32 parameters)."""

    def __init__(self, model: Network, schedule: dict, seed: int, device):
        self.model = model.train()
        self.params = [p for n, p in model.named_parameters()
                       if not is_frozen(model.key, n)]
        for n, p in model.named_parameters():
            p.requires_grad_(not is_frozen(model.key, n))
        opt = schedule["optimizer"]
        spe = int(schedule["steps_per_epoch"])
        self.warmup = int(float(schedule["warmup_epochs"]) * spe)
        self.total = int(float(schedule["num_epochs"]) * spe)
        self.lr = float(opt["lr"])
        self.opt = torch.optim.AdamW(
            self.params, lr=self.lr * schedule_factor(0, self.warmup,
                                                      self.total),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=float(opt["wd"]),
            foreach=False)
        self.decay = float(schedule["ema_decay"])
        self.contra_w = 0.3
        self.ema = [p.detach().clone() for p in model.parameters()]
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.steps = 0

    def step(self, batch: dict) -> tuple[float, list]:
        """One step; returns (loss, the gradients as AdamW gets them) and
        keeps the backbone's features in ``features``."""
        feat, dis = self.model.features(batch, self.gen)
        self.features = feat.detach()
        scores = self.model.head(feat, self.gen)
        y = batch["label"].reshape(-1, 1).float()
        loss = plcc_loss(scores.float(), y)
        if dis is not None:
            loss = loss + self.contra_w * dis
        self.opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [None if p.grad is None else p.grad.detach().clone()
                 for p in self.params]
        self.opt.step()
        self.steps += 1
        for g in self.opt.param_groups:
            g["lr"] = self.lr * schedule_factor(self.steps, self.warmup,
                                                self.total)
        with torch.no_grad():
            for e, p in zip(self.ema, self.model.parameters()):
                e.mul_(self.decay).add_(p, alpha=1.0 - self.decay)
        return float(loss.detach()), grads
