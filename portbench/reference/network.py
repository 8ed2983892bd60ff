"""The reference network, its losses and its train step, in float32.

``Network(model_block)`` holds a ``<key>_backbone`` and a ``<key>_head``
for the one model key of the block (``KSVQE`` or a Swin-T-3D key), under
the names of the reference checkpoints, which the program uses too.
``TrainStep`` is the reference's step: the forward (its draws from a
generator seeded as the program seeds its own: ``seed + 1``), the loss
(the PLCC loss, plus ``contra_loss_weight`` x KSVQE's contrastive loss and
``rank_loss_weight`` x the rank loss), the backward, AdamW (b1 0.9, b2
0.999, eps 1e-8, decoupled weight decay; the ``*_backbone`` parameters in
a group of their own at ``lr x backbone_lr_mult`` where that is not 1)
under the linear warmup and cosine schedule, and the EMA, each as the
schedule it is given states it.  KSVQE's CLIP (but for its adapters) and
CONTRIQUE are frozen and get no gradient.  With ``rows`` a batch of more
rows is computed in blocks of that many, so that its activations fit
(``TrainStep.step``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .ksvqe import KSVQE, ksvqe_config
from .layers import DrawTape, VQAHead
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


def rank_loss(y_pred, y):
    """FAST-VQA's pairwise rank loss: relu((p - p^T) sign(y^T - y)),
    summed, over n(n - 1) and over 1 + its largest entry."""
    y_pred, y = y_pred.reshape(-1, 1), y.reshape(-1, 1)
    ranking = torch.relu((y_pred - y_pred.T) * torch.sign(y.T - y))
    n = y_pred.shape[0]
    return ranking.sum() / n / (n - 1) / (1 + ranking.max())


def schedule_factor(step: int, warmup: int, total: int) -> float:
    if warmup > 0 and step <= warmup:
        return step / max(warmup, 1)
    return 0.5 * (1 + math.cos(math.pi * (step - warmup) / max(total, 1)))


class TrainStep:
    """The reference's train state on ``model`` (float32 parameters).

    ``schedule`` is the configuration's ``schedule`` with its
    ``steps_per_epoch``: ``optimizer`` (``lr``, ``wd``, and
    ``backbone_lr_mult``, 1 by default), ``warmup_epochs``,
    ``num_epochs``, ``ema_decay``, ``contra_loss_weight`` (0.3 by
    default) and ``rank_loss_weight`` (0 by default).  ``rows``: compute a
    batch of more rows in blocks of that many (``step``); a model whose
    rows are coupled in training (KSVQE's QRS picks and contrastive loss,
    a BatchNorm on the batch's statistics) cannot be and raises."""

    def __init__(self, model: Network, schedule: dict, seed: int, device,
                 rows: int | None = None):
        self.model = model.train()
        if rows is not None:
            if model.key == "KSVQE":
                raise ValueError("KSVQE's QRS picks and contrastive loss "
                                 "couple a batch's rows: no row blocks")
            if any(isinstance(m, nn.modules.batchnorm._BatchNorm)
                   and m.training for m in model.modules()):
                raise ValueError("a BatchNorm in train mode couples a "
                                 "batch's rows: no row blocks")
        self.rows = rows
        named = [(n, p) for n, p in model.named_parameters()
                 if not is_frozen(model.key, n)]
        self.params = [p for _, p in named]
        for n, p in model.named_parameters():
            p.requires_grad_(not is_frozen(model.key, n))
        opt = schedule["optimizer"]
        spe = int(schedule["steps_per_epoch"])
        self.warmup = int(float(schedule["warmup_epochs"]) * spe)
        self.total = int(float(schedule["num_epochs"]) * spe)
        lr = float(opt["lr"])
        # the program's rule (train/optim.py:build_optimizer): the
        # ``*_backbone`` parameters in a group of their own where the
        # multiplier is not 1
        mult = float(opt.get("backbone_lr_mult", 1.0))
        parts = {False: [], True: []}
        for n, p in named:
            parts["_backbone" in n and mult != 1.0].append(p)
        self.base_lr = [lr] + ([lr * mult] if parts[True] else [])
        factor = schedule_factor(0, self.warmup, self.total)
        self.opt = torch.optim.AdamW(
            [{"params": ps, "lr": base * factor}
             for ps, base in zip((parts[False], parts[True]), self.base_lr)],
            betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(opt["wd"]), foreach=False)
        self.decay = float(schedule["ema_decay"])
        self.contra_w = float(schedule.get("contra_loss_weight", 0.3))
        self.rank_w = float(schedule.get("rank_loss_weight", 0.0))
        self.ema = [p.detach().clone() for p in model.parameters()]
        self.gen = torch.Generator(device=device).manual_seed(seed + 1)
        self.steps = 0

    def loss(self, scores, y, dis):
        loss = plcc_loss(scores.float(), y)
        if dis is not None:
            loss = loss + self.contra_w * dis
        if self.rank_w:
            loss = loss + self.rank_w * rank_loss(scores.float(), y)
        return loss

    def step(self, batch: dict) -> tuple[float, list]:
        """One step; returns (loss, the gradients as AdamW gets them) and
        keeps the backbone's features in ``features``."""
        y = batch["label"].reshape(-1, 1).float()
        if self.rows is not None and self.rows < y.shape[0]:
            loss = self._in_blocks(batch, y)
        else:
            feat, dis = self.model.features(batch, self.gen)
            self.features = feat.detach()
            scores = self.model.head(feat, self.gen)
            loss = self.loss(scores, y, dis)
            self.opt.zero_grad(set_to_none=True)
            loss.backward()
        grads = [None if p.grad is None else p.grad.detach().clone()
                 for p in self.params]
        self.opt.step()
        self.steps += 1
        factor = schedule_factor(self.steps, self.warmup, self.total)
        for g, base in zip(self.opt.param_groups, self.base_lr):
            g["lr"] = base * factor
        with torch.no_grad():
            for e, p in zip(self.ema, self.model.parameters()):
                e.mul_(self.decay).add_(p, alpha=1.0 - self.decay)
        return float(loss.detach()), grads

    def _in_blocks(self, batch: dict, y) -> torch.Tensor:
        """The step's loss and gradients with the activations of
        ``rows`` rows alive at a time: the whole batch's forward without
        autograd, its draws taped (the generator ends as after a whole
        step), gives the features, the scores and the loss, and dL/dscores
        from the loss on the scores alone; then each block's forward with
        autograd, its draws replayed from the tape, and its backward from
        its rows of dL/dscores, the gradients adding up.  Each row's score
        depends on its own row only (no BatchNorm, no coupled draws), so
        this is the whole step's gradient in another order of sums."""
        n = y.shape[0]
        tape = DrawTape(self.gen, n)
        with torch.no_grad():
            feat, _ = self.model.features(batch, tape)
            self.features = feat
            scores = self.model.head(feat, tape)
        scores.requires_grad_(True)
        loss = self.loss(scores, y, None)
        (d_scores,) = torch.autograd.grad(loss, scores)
        self.opt.zero_grad(set_to_none=True)
        for start in range(0, n, self.rows):
            stop = min(start + self.rows, n)
            part = {k: v[start:stop] for k, v in batch.items()}
            got, _ = self.model(part, tape.replay(start, stop))
            got.backward(d_scores[start:stop])
            if not tape.replayed_all():
                raise ValueError("a block's forward draws less than the "
                                 "whole batch's did")
        return loss
