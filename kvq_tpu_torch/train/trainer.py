"""The Trainer (counterpart of kvq_tpu/train/trainer.py:115-670), on one
device or data-parallel over ``torch.distributed``.

``Trainer(config, device="cuda", seed=0)`` builds the network of any
ported model key with float32 master parameters
(:func:`~kvq_tpu_torch.models.vqa_network.build_train_model`), merges the
weights of ``load_path`` when the config names one (the reference's
``load_state_dict(strict=False)``, core/checkpoint.py), freezes CLIP
(except its adapters) and CONTRIQUE when the model is KSVQE, and sets up
AdamW with the warmup + cosine schedule and the EMA.  ``train_step(batch)``
runs one step: the forward in the compute dtype with the train routing (K4
on pad-free Swin blocks, K5 around the plain LayerNorm/MLP on padded ones,
the plain CDM), ``total_loss`` (KSVQE adds its contrastive distortion
loss), the backward, the AdamW and schedule steps, the EMA update and
``step + 1``; it returns the loss terms as floats, the only point where
the host waits for the card.  ``train_epoch(batches)`` overlaps the next
batch's pre-cast (worker thread) and host-to-device copy (side stream)
with the current step and reads the losses once, after the last step.

``evaluate(batches, use_ema)`` scores the raw or the EMA weights through
the :class:`~kvq_tpu_torch.train.evaluator.Evaluator`; ``train_eval``
trains an epoch, evaluates both and keeps the best metrics and weights as
the reference does (best-(SRCC+PLCC) files ``{name}_head_{test_set}_{n|s}
_finetuned.pth`` under ``workdir``).

All randomness comes from one ``torch.Generator`` per trainer (seeded with
``seed + 1``; the weights use ``seed``): the QRS draw, the DropPath masks
and the head's dropout, drawn in that order on every route, with or
without remat, so one seed gives the kernel path and the plain path the
same draws.  ``save`` / ``load`` keep the full state (core/checkpoint.py),
generator included; ``load`` also resumes the JAX trainer's
``_last_state.msgpack``.  ``train_eval`` logs each epoch's loss terms and
best metrics through ``core/logging.py:MetricLogger``: printed, and
written to ``{name}_metrics.jsonl`` under ``log_dir`` when one is given.

Data-parallel (kvq_tpu/parallel/steps.py:79-118 ``make_ddp_train_step``):
when a process group is up and the config says ``ddp``, each rank trains
on its own batch (at least 2 samples: the correlation losses are
degenerate on one) and the step is the JAX DDP step's: the trainable
BatchNorms' statistics are synced across the ranks, rank 0's state is
broadcast once, the gradients and the loss terms are averaged between
``backward`` and the AdamW step (``parallel/steps.py``), ``evaluate``
gathers every rank's rows, and rank 0 alone writes files.  Rank r's
generator is seeded with ``seed + 1 + r * 2**32``: rank 0's is the
one-process trainer's, and the others draw other noise, as JAX's
``fold_in(rng, axis_index)`` does.  A group of more than one rank without
``ddp`` raises: the ranks would train apart.
"""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from ..core.checkpoint import (
    is_msgpack,
    load_checkpoint,
    load_weights,
    merge_jax_weights,
    save_checkpoint,
)
from ..core.config import model_keys, normalize_config
from ..core.device import resolve_device
from ..core.from_jax import adamw_state_from_jax, map_jax_tree
from ..core.logging import MetricLogger
from ..core.metrics import VQAMetrics
from ..data.pipeline import (
    prefetch_to_device,
    prepared_in_background,
    train_fields,
    train_host_tensors,
    view_dtype,
)
from ..models.vqa_network import (
    VQANetwork,
    build_train_model,
    cast_model,
    compute_dtype,
    compute_tensors,
    f32_names,
)
from ..nn.resnet import sync_batchnorm
from ..parallel.mesh import rank, world
from ..parallel.steps import broadcast_state, reduce_aux, reduce_gradients
from .evaluator import Evaluator
from .losses import total_loss
from .optim import (
    KSVQE_FROZEN_PATTERNS,
    ema_update,
    freeze,
    optimizer_from_config,
    step_generator,
    step_settings,
)

PIPELINE_DEPTH = 2  # train batches prepared and copied ahead of the step


class Trainer:
    def __init__(self, config: dict, device="cuda", seed: int = 0,
                 steps_per_epoch: int = 1, workdir: str = "./work",
                 test_set: str = "val", log_dir: str | None = None):
        self.config = normalize_config(config)
        cfg = self.config
        self.workdir = workdir
        self.test_set = test_set
        keys = model_keys(cfg)
        # only KSVQE returns (scores, contrastive loss) and has frozen tools
        self.is_ksvqe = "KSVQE" in keys
        self.fields = train_fields(keys)
        self.device = resolve_device(device)
        self.rank, self.world = rank(), world()
        self.ddp = dist.is_initialized() and bool(cfg.get("ddp"))
        if self.world > 1 and not self.ddp:
            raise ValueError(
                f"{self.world} ranks and no `ddp: true` in the config: the "
                f"ranks would train unsynchronised replicas")
        self.model = build_train_model(cfg, self.device, seed)
        if cfg.get("load_path"):
            load_weights(self.model, cfg["load_path"])
        if self.is_ksvqe:
            freeze(self.model, KSVQE_FROZEN_PATTERNS)
        self.dtype = compute_dtype(cfg)
        self.cast = view_dtype(cfg)
        self.optimizer, self.schedule = optimizer_from_config(
            self.model.named_parameters(), cfg, steps_per_epoch)
        self.settings = step_settings(cfg)
        self.use_ema = self.settings.use_ema
        self.params = list(self.model.parameters())
        self.ema = ([p.detach().clone() for p in self.params]
                    if self.use_ema else [])
        self.step = 0
        self.best = (-1.0, -1.0, -1.0, 1999.0)
        self.best_ema = (-1.0, -1.0, -1.0, 1999.0)
        self.last_losses: dict[str, float] = {}  # of train_eval's epoch
        self.gen = step_generator(self.device, seed, self.rank)
        self._frozen = None
        self._evaluator = None
        self.logger = MetricLogger(log_dir, str(cfg.get("name", "train")))
        if self.ddp:
            sync_batchnorm(self.model)
            broadcast_state(self.model, self.ema)

    # ------------------------------------------------------------------ steps
    def _compute_tensors(self) -> dict:
        """The forward's parameters and buffers in the compute dtype.  The
        frozen ones never change, so their casts are made once; the float32
        buffers (BatchNorm's running statistics) are the module's own, so
        a train-mode forward updates them in place, once a step."""
        if self._frozen is None:
            self._keep = f32_names(self.model)
            trainable = {n for n, p in self.model.named_parameters()
                         if p.requires_grad}
            self._frozen = {n: t for n, t in compute_tensors(
                self.model, self.dtype, keep=self._keep).items()
                if n not in trainable}
        return {**self._frozen, **compute_tensors(
            self.model, self.dtype, trainable_only=True, keep=self._keep)}

    def _step(self, dev: dict) -> dict:
        """One train step on a device-resident batch; returns the loss
        terms as 0-d tensors (nothing is read back)."""
        if self.ddp and dev["label"].shape[0] < 2:
            raise ValueError(
                f"a data-parallel step needs at least 2 samples a rank, got "
                f"{dev['label'].shape[0]}: the correlation losses are "
                f"degenerate on one")
        self.model.train()
        out = functional_call(self.model, self._compute_tensors(), (dev,),
                              {"gen": self.gen})
        scores, dis = out if self.is_ksvqe else (out, None)
        loss, aux = total_loss(scores, dev["label"], dis,
                               self.settings.contra_w, self.settings.rank_w)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.ddp:
            reduce_gradients(self.params)
            aux = reduce_aux(aux)
        self.optimizer.step()
        self.schedule.step()
        if self.use_ema:
            ema_update(self.ema, self.params, self.settings.ema_decay)
        self.step += 1
        return {k: v.detach() for k, v in aux.items()}

    def _prepare(self, batch: dict):
        return None, train_host_tensors(batch, self.fields, self.cast,
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

    # ------------------------------------------------------------ evaluation
    def weights(self, use_ema: bool = False) -> dict:
        """The model's ``state_dict`` (f32 masters and buffers), with the
        EMA parameters in place of the raw ones when ``use_ema``."""
        sd = self.model.state_dict()
        if use_ema and self.use_ema:
            names = [n for n, _ in self.model.named_parameters()]
            sd.update(zip(names, self.ema))
        return sd

    def evaluate(self, batches: Iterable[dict],
                 use_ema: bool = False) -> VQAMetrics:
        """Score ``batches`` (the Loader's eval format) with the raw or the
        EMA weights, cast to the compute dtype, through the Evaluator."""
        if self._evaluator is None:
            with torch.device(self.device):
                net = VQANetwork(self.config)
            self._evaluator = Evaluator(
                self.config, model=cast_model(net, self.dtype).eval(),
                device=self.device)
        self._evaluator.model.load_state_dict(self.weights(use_ema))
        return self._evaluator.evaluate(batches)

    def train_eval(self, train_batches: Iterable[dict],
                   val_batches) -> tuple[tuple, tuple]:
        """One epoch over ``train_batches`` (its last step's loss terms kept
        in ``last_losses``), then ``val_batches`` (iterable twice: it is
        scored with the raw and, with the EMA on, the EMA weights); returns
        ``(best, best_ema)``.  The JAX trainer's
        ``train_eval_all_epoches``."""
        self.last_losses = self.train_epoch(train_batches)
        self.logger.log(self.step, self.last_losses, prefix="train/")
        self.best = self._eval_and_maybe_save(False, self.best, "n",
                                              val_batches)
        if self.use_ema:
            self.best_ema = self._eval_and_maybe_save(True, self.best_ema,
                                                      "s", val_batches)
        self.logger.log(self.step, dict(zip(
            ("best_srcc", "best_plcc", "best_krcc", "best_rmse"), self.best)),
            prefix="val_n/")
        return self.best, self.best_ema

    def _eval_and_maybe_save(self, use_ema: bool, best: tuple, suffix: str,
                             val_batches) -> tuple:
        """The reference's rule: write the weights when SRCC + PLCC beats
        the best so far (and ``save_model``), with the best so far as its
        validation results; each metric's best is its max (RMSE: min).
        Every rank gets the same metrics; rank 0 writes."""
        m = self.evaluate(val_batches, use_ema=use_ema)
        best_s, best_p, best_k, best_r = best
        if m.srcc + m.plcc > best_s + best_p and self.config.get(
                "save_model", True) and self.rank == 0:
            name = f"{self.config['name']}_head_{self.test_set}"
            save_checkpoint(
                os.path.join(self.workdir, f"{name}_{suffix}_finetuned.pth"),
                {"params": self.weights(use_ema),
                 "validation_results": list(best)})
        return (max(best_s, m.srcc), max(best_p, m.plcc),
                max(best_k, m.krcc), min(best_r, m.rmse))

    # -------------------------------------------------------------- state
    def save(self, path: str) -> None:
        """Full train state: parameters, optimizer and schedule, EMA, step,
        best metrics and the generator.  Data-parallel, every rank calls it
        (it gathers each rank's generator) and rank 0 writes."""
        gens = None
        if self.ddp:
            gens = [None] * self.world
            dist.all_gather_object(gens, self.gen.get_state())
        if self.rank != 0:
            return
        save_checkpoint(path, {
            "params": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "schedule": self.schedule.state_dict(),
            "ema": self.ema,
            "step": self.step,
            "best": list(self.best),
            "best_ema": list(self.best_ema),
            "generator": self.gen.get_state(),
            **({"rank_generators": gens} if gens else {}),
        })

    def load(self, path: str) -> None:
        """Resume a full state: the port's own file (:meth:`save`), or the
        JAX trainer's ``_last_state.msgpack`` (:meth:`load_jax_state`)."""
        state = load_checkpoint(path)
        if is_msgpack(path):
            self.load_jax_state(state, path)
            return
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.schedule.load_state_dict(state["schedule"])
        with torch.no_grad():
            for e, s in zip(self.ema, state["ema"]):
                e.copy_(s)
        self.step = int(state["step"])
        self.best = tuple(state["best"])
        self.best_ema = tuple(state["best_ema"])
        gens = state.get("rank_generators") or []
        if len(gens) == self.world:
            self.gen.set_state(gens[self.rank])
        elif self.rank == 0:  # another world's file: the others keep theirs
            self.gen.set_state(state["generator"])
        self._frozen = None

    def load_jax_state(self, state: dict, path: str = "<state>") -> None:
        """Resume the JAX trainer's full state (its ``save_full_state``,
        kvq_tpu/train/trainer.py:279-332): ``params`` and ``batch_stats``
        merged as it merges them, ``ema_params`` into the EMA, the AdamW
        moments into each trainable parameter's ``exp_avg`` /
        ``exp_avg_sq``, the optax count as each parameter's ``step`` and
        the schedule's, then ``step``, ``best`` and ``best_ema``.  An
        ``opt_state`` that does not match this trainer's optimizer (its
        frozen mask, ``backbone_lr_mult`` and parameters) raises
        ``ValueError`` before anything is loaded.  JAX's RNG state has no
        counterpart here: the generator keeps its seed."""
        moments = None
        if "opt_state" in state:
            try:
                moments = self._adamw_state(state["opt_state"])
            except ValueError as e:
                raise ValueError(
                    f"checkpoint opt_state at {path!r} does not match the "
                    f"optimizer of this config: {e}") from e
        report = merge_jax_weights(self.model, state["params"],
                                   state.get("batch_stats"))
        print("loaded", path, {k: len(v) for k, v in report.items()})
        if moments is not None:
            count, opt_state = moments
            self.optimizer.load_state_dict(opt_state)
            sched = self.schedule
            lrs = [base * fn(count)
                   for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
            sched.load_state_dict({**sched.state_dict(), "last_epoch": count,
                                   "_last_lr": lrs})
            for group, lr in zip(self.optimizer.param_groups, lrs):
                group["lr"] = lr
        if self.use_ema and state.get("ema_params"):
            ema, _ = map_jax_tree(state["ema_params"])
            names = [n for n, _ in self.model.named_parameters()]
            with torch.no_grad():
                for e, n in zip(self.ema, names):
                    if n in ema:
                        e.copy_(ema[n])
        self.step = int(np.asarray(state.get("step", 0)))
        for key in ("best", "best_ema"):
            if key in state:
                setattr(self, key,
                        tuple(float(x) for x in np.asarray(state[key])))
        self._frozen = None

    def _adamw_state(self, opt_state: dict) -> tuple[int, dict]:
        """(optax count, an ``optimizer.state_dict()`` holding the JAX
        moments) for this trainer's AdamW."""
        count, mu, nu = adamw_state_from_jax(
            opt_state, frozen=self.is_ksvqe,
            scaled=self.settings.backbone_lr_mult != 1)
        name_of = {id(p): n for n, p in self.model.named_parameters()}
        order = [p for g in self.optimizer.param_groups for p in g["params"]]
        want = {name_of[id(p)] for p in order}
        if set(mu) != want:
            raise ValueError(
                f"moments for {len(mu)} parameters, {len(want)} trainable; "
                f"not trained here: {sorted(set(mu) - want)[:3]}, without "
                f"moments: {sorted(want - set(mu))[:3]}")
        sd = self.optimizer.state_dict()
        sd["state"] = {}
        for i, p in enumerate(order):
            n = name_of[id(p)]
            if mu[n].shape != p.shape:
                raise ValueError(f"moment of {n}: shape {tuple(mu[n].shape)}"
                                 f", parameter {tuple(p.shape)}")
            sd["state"][i] = {"step": torch.tensor(float(count)),
                              "exp_avg": mu[n], "exp_avg_sq": nu[n]}
        return count, sd
