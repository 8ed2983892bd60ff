"""The train half of the JAX ``Trainer`` (kvq_tpu/train/trainer.py:115-463),
on one device.

``Trainer(config, device="cuda", seed=0)`` builds the network with float32
master parameters (:func:`~kvq_tpu_torch.models.vqa_network.build_train_model`),
freezes CLIP (except its adapters) and CONTRIQUE of KSVQE, and sets up
AdamW with the warmup + cosine schedule and the EMA.  It trains the KSVQE
model key only and raises ``NotImplementedError`` for any other.
``train_step(batch)``
runs one step: the forward in the compute dtype with the train routing
(K4 and K5 on the Swin blocks, the plain CDM), ``total_loss``, the
backward, the AdamW and schedule steps, the EMA update and ``step + 1``;
it returns the loss terms as floats, the only point where the host waits
for the card.  ``train_epoch(batches)`` overlaps the next batch's pre-cast
(worker thread) and host-to-device copy (side stream) with the current
step and reads the losses once, after the last step.

All randomness comes from one ``torch.Generator`` per trainer (seeded with
``seed + 1``; the weights use ``seed``): the QRS noise, the DropPath masks
and the head's dropout, drawn in that order on every route, so one seed
gives the kernel path and the plain path the same draws.  ``save`` /
``load`` keep the full state (core/checkpoint.py), generator included.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch.func import functional_call

from ..core.checkpoint import load_checkpoint, save_checkpoint
from ..core.config import model_keys, normalize_config
from ..core.device import resolve_device
from ..data.pipeline import (
    prefetch_to_device,
    prepared_in_background,
    train_host_tensors,
    view_dtype,
)
from ..models.vqa_network import (
    build_train_model,
    compute_dtype,
    compute_tensors,
)
from .losses import total_loss
from .optim import KSVQE_FROZEN_PATTERNS, build_optimizer, ema_update, freeze

PIPELINE_DEPTH = 2  # train batches prepared and copied ahead of the step


class Trainer:
    def __init__(self, config: dict, device="cuda", seed: int = 0,
                 steps_per_epoch: int = 1):
        self.config = normalize_config(config)
        cfg = self.config
        for key in model_keys(cfg):
            # the step unpacks KSVQE's (scores, distortion logits) and its
            # batch needs KSVQE's views; other keys would fail at the step
            if key != "KSVQE":
                raise NotImplementedError(
                    f"Trainer trains the KSVQE model key only, not {key!r}")
        self.device = resolve_device(device)
        self.model = build_train_model(cfg, self.device, seed)
        freeze(self.model, KSVQE_FROZEN_PATTERNS)
        self.dtype = compute_dtype(cfg)
        self.cast = view_dtype(cfg)
        opt = cfg.get("optimizer") or {}
        epochs = float(cfg.get("num_epochs", 1)) + float(
            cfg.get("l_num_epochs", 0))
        self.optimizer, self.schedule = build_optimizer(
            self.model,
            lr=float(opt.get("lr", 3e-5)),
            weight_decay=float(opt.get("wd", 0.05)),
            warmup_iters=int(float(cfg.get("warmup_epochs", 0))
                             * steps_per_epoch),
            max_iters=int(epochs * steps_per_epoch),
            backbone_lr_mult=float(opt.get("backbone_lr_mult", 1.0)),
        )
        self.contra_w = float(cfg.get("contra_loss_weight", 0.3))
        self.rank_w = float(cfg.get("rank_loss_weight", 0.0))
        self.use_ema = bool(cfg.get("ema", True))
        self.ema_decay = float(cfg.get("ema_decay", 0.999))
        self.params = list(self.model.parameters())
        self.ema = ([p.detach().clone() for p in self.params]
                    if self.use_ema else [])
        self.step = 0
        self.best = (-1.0, -1.0, -1.0, 1999.0)
        self.best_ema = (-1.0, -1.0, -1.0, 1999.0)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 1)
        self._frozen = None

    # ------------------------------------------------------------------ steps
    def _compute_tensors(self) -> dict:
        """The forward's parameters and buffers in the compute dtype.  The
        frozen ones never change, so their casts are made once."""
        if self._frozen is None:
            trainable = {n for n, p in self.model.named_parameters()
                         if p.requires_grad}
            self._frozen = {n: t for n, t in
                            compute_tensors(self.model, self.dtype).items()
                            if n not in trainable}
        return {**self._frozen, **compute_tensors(self.model, self.dtype,
                                                  trainable_only=True)}

    def _step(self, dev: dict) -> dict:
        """One train step on a device-resident batch; returns the loss
        terms as 0-d tensors (nothing is read back)."""
        self.model.train()
        out = functional_call(self.model, self._compute_tensors(), (dev,),
                              {"gen": self.gen})
        scores, dis = out
        loss, aux = total_loss(scores, dev["label"], dis, self.contra_w,
                               self.rank_w)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.schedule.step()
        if self.use_ema:
            ema_update(self.ema, self.params, self.ema_decay)
        self.step += 1
        return {k: v.detach() for k, v in aux.items()}

    def _prepare(self, batch: dict):
        return None, train_host_tensors(batch, self.cast,
                                        pin=self.device.type == "cuda")

    def train_step(self, batch: dict) -> dict[str, float]:
        """One step on a host batch (the Loader's collated numpy format)."""
        _, host = self._prepare(batch)
        dev = {k: v.to(self.device, non_blocking=True)
               for k, v in host.items()}
        return {k: float(v) for k, v in self._step(dev).items()}

    def train_epoch(self, batches: Iterable[dict]) -> dict[str, float]:
        """Steps over ``batches``; returns the last step's loss terms."""
        last: dict = {}
        for _, dev in prefetch_to_device(
            prepared_in_background(self._prepare, batches, PIPELINE_DEPTH),
            self.device, PIPELINE_DEPTH,
        ):
            last = self._step(dev)
        return {k: float(v) for k, v in last.items()}

    # -------------------------------------------------------------- state
    def save(self, path: str) -> None:
        """Full train state: parameters, optimizer and schedule, EMA, step,
        best metrics and the generator."""
        save_checkpoint(path, {
            "params": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "schedule": self.schedule.state_dict(),
            "ema": self.ema,
            "step": self.step,
            "best": list(self.best),
            "best_ema": list(self.best_ema),
            "generator": self.gen.get_state(),
        })

    def load(self, path: str) -> None:
        state = load_checkpoint(path)
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.schedule.load_state_dict(state["schedule"])
        with torch.no_grad():
            for e, s in zip(self.ema, state["ema"]):
                e.copy_(s)
        self.step = int(state["step"])
        self.best = tuple(state["best"])
        self.best_ema = tuple(state["best_ema"])
        self.gen.set_state(state["generator"])
        self._frozen = None
