"""The (data, fsdp) flavour of the train step and its eval (counterpart of
kvq_tpu/parallel/steps.py:121-229, ``make_sharded_train_step``,
``_match_opt_state_shardings`` and ``make_eval_step`` under a mesh).

JAX jits the one-process step and lays its arrays out on the mesh: the
batch split over ("data", "fsdp") jointly, each parameter with its AdamW
moments and its EMA split over "fsdp" by ``param_spec``'s size rule (frozen
parameters too), batch statistics and the step replicated.  The loss is
computed *globally*: the PLCC over every row's score, KSVQE's supervised
contrastive loss over every row's distortion tokens, SimpleVQA's
train-mode BatchNorm statistics over the whole batch.  Its gradient is the
one-process gradient on the whole batch.

Here each rank is one process and the step is written on
``torch.distributed`` collectives, ZeRO-style:

  1. the trainable f32 masters' shards are gathered over the rank's fsdp
     group into whole tensors (flat buckets, one ``all_gather`` each), and
     cast into the compute copies (the frozen parameters were gathered and
     cast once, at construction);
  2. forward and backward on this rank's rows, with the scores gathered
     over every rank before ``total_loss``, KSVQE's distortion tokens
     gathered before its contrastive loss (``KSVQE.contrastive_group``),
     and SimpleVQA's BatchNorm statistics averaged over every rank
     (``sync_batchnorm``); each gather's backward keeps this rank's slice
     (``steps.gather_batch``), so every rank computes the same global loss
     and the ranks' gradients sum to its gradient;
  3. the gradients are summed over every rank (``steps.sum_flat``) and a
     sharded parameter keeps its slice: the reduce-scatter over fsdp after
     the sum over data, written as one all-reduce over all ranks and a
     slice, because gloo, the backend of several ranks on one card, has
     no reduce-scatter for CUDA tensors;
  4. AdamW, the schedule and the EMA run on the shards.

Rank ``r``'s generator is seeded with ``seed + 1 + r * 2**32`` (the DDP
route's rule, ``train.optim.step_generator``): the QRS, DropPath and
dropout draws of each row come from its rank's generator, where JAX draws
the whole batch from one key, so the random parts agree with JAX only
when they are off.

No Trainer or CLI option takes this flavour, as none does in kvq_tpu
(kvq_tpu/train/trainer.py:128-134 and 431-450 use the DDP step only).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch
import torch.distributed as dist
from torch.func import functional_call

from ..core.config import model_keys, normalize_config
from ..models.vqa_network import (
    VQANetwork,
    cast_model,
    compute_dtype,
    f32_names,
    tensor_compute_dtype,
)
from ..nn.resnet import sync_batchnorm
from ..train.evaluator import Evaluator
from ..train.losses import total_loss
from ..train.optim import (
    KSVQE_FROZEN_PATTERNS,
    ema_update,
    freeze,
    optimizer_from_config,
    step_generator,
    step_settings,
)
from .mesh import Mesh
from .sharding import MIN_SIZE, param_shardings
from .steps import (
    BUCKET_BYTES,
    _buckets,
    broadcast_state,
    gather_batch,
    gather_rows,
    sum_flat,
)


@dataclasses.dataclass
class ShardedState:
    """This rank's part of the train state: for each parameter (the
    module's order) its name, the port axis that fsdp splits (None:
    replicated), its whole shape, and the f32 master (its shard, or the
    whole tensor), whether it trains; the EMA beside the masters, the
    AdamW optimizer and schedule over the trainable masters (their moments
    shaped like the masters), the step and this rank's generator.  Batch
    statistics stay in the module's buffers, replicated."""

    names: list
    axes: list
    shapes: list
    params: list
    trainable: list
    ema: list
    optimizer: torch.optim.Optimizer
    schedule: object
    gen: torch.Generator
    mesh: Mesh
    step: int = 0

    def gather(self, tensors, which=None) -> list:
        """The whole tensors of ``tensors`` (shards or whole, one a
        parameter of ``which``, default all), gathered over the fsdp
        group."""
        idx = range(len(self.names)) if which is None else which
        return gather_shards(list(tensors), [self.axes[i] for i in idx],
                             self.mesh)

    def whole(self, use_ema: bool = False) -> dict:
        """Parameter name -> its whole f32 tensor (raw or EMA)."""
        src = self.ema if use_ema else self.params
        return dict(zip(self.names, self.gather(t.detach() for t in src)))

    def moments(self) -> dict:
        """Trainable name -> (exp_avg, exp_avg_sq), whole; none before the
        first step."""
        idx = [i for i, t in enumerate(self.trainable) if t]
        st = [self.optimizer.state.get(self.params[i], {}) for i in idx]
        if not all("exp_avg" in s for s in st):
            return {}
        m = self.gather((s["exp_avg"] for s in st), idx)
        v = self.gather((s["exp_avg_sq"] for s in st), idx)
        return {self.names[i]: (a, b) for i, a, b in zip(idx, m, v)}

    def state_bytes(self) -> dict:
        """This rank's bytes of f32 masters, AdamW moments and EMA: of the
        parameters fsdp splits (``sharded``), of all (``total``), and what
        a replicated state holds of each (``*_replicated``: the DDP
        route's)."""
        out = dict.fromkeys(("sharded", "total", "sharded_replicated",
                             "total_replicated"), 0)
        per = 4 * (1 + bool(self.ema))
        for p, shape, axis, tr in zip(self.params, self.shapes, self.axes,
                                      self.trainable):
            mine, whole = (p.numel() * (per + 8 * tr),
                           shape.numel() * (per + 8 * tr))
            out["total"] += mine
            out["total_replicated"] += whole
            if axis is not None:
                out["sharded"] += mine
                out["sharded_replicated"] += whole
        return out


@torch.no_grad()
def gather_shards(shards: list, axes: list, mesh: Mesh,
                  bucket_bytes: int = BUCKET_BYTES) -> list:
    """The whole tensor of each shard (cut on ``axes``; None: already
    whole), gathered over this rank's fsdp group: the shards of a bucket go
    out flat in one ``all_gather``, and each whole tensor is the
    concatenation of every rank's shard on its axis, in fsdp order."""
    out = list(shards)
    cut = [i for i, a in enumerate(axes) if a is not None]
    n = mesh.shape["fsdp"]
    group = mesh.groups["fsdp"]
    for bucket in _buckets([shards[i] for i in cut], bucket_bytes):
        ids, cut = cut[:len(bucket)], cut[len(bucket):]
        flat = torch.cat([t.reshape(-1) for t in bucket])
        parts = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(parts, flat, group=group)
        sizes = [t.numel() for t in bucket]
        pieces = [p.split(sizes) for p in parts]
        for j, i in enumerate(ids):
            out[i] = torch.cat([pieces[r][j].view(shards[i].shape)
                                for r in range(n)], dim=axes[i])
    return out


def _shard(t: torch.Tensor, axis, mesh: Mesh) -> torch.Tensor:
    if axis is not None:
        t = t.chunk(mesh.shape["fsdp"], axis)[mesh.index["fsdp"]]
    return t.detach().clone(memory_format=torch.contiguous_format)


def make_sharded_train_step(model: VQANetwork, config: dict, mesh: Mesh,
                            steps_per_epoch: int = 1, seed: int = 0,
                            min_size: int = MIN_SIZE,
                            dtype: torch.dtype | None = None):
    """``(step_fn, state)``: ``step_fn(state, batch)`` runs one step on
    this rank's rows ``batch`` (a dict of device tensors, the Trainer's
    train fields; rank ``r`` holds rows ``r*b`` to ``(r+1)*b`` of the
    global batch) and returns the loss terms as 0-d tensors, the same on
    every rank; the masters keep this step's reduced gradient shards in
    ``.grad`` until the next.  ``model``: the float32 network of
    ``build_train_model(config, device, seed)`` (or with weights loaded
    into it); rank 0's parameters and buffers are broadcast first, then
    each rank keeps its shards, and the module's own parameter storage is
    released.  KSVQE's tools are frozen here, as the Trainer freezes them.
    ``min_size``: ``param_spec``'s, JAX's ``param_shardings`` argument.
    The optimizer and schedule follow the config as the Trainer's do.
    ``dtype``: the forward's dtype, the config's ``compute_dtype`` when
    None (a float64 model with ``torch.float64`` checks in double
    precision)."""
    cfg = normalize_config(config)
    is_ksvqe = "KSVQE" in model_keys(cfg)
    dev = next(model.parameters()).device
    if is_ksvqe:
        freeze(model, KSVQE_FROZEN_PATTERNS)
        model.KSVQE_backbone.contrastive_group = dist.group.WORLD
    sync_batchnorm(model, group=dist.group.WORLD)
    settings = step_settings(cfg)
    broadcast_state(model)

    names, params = zip(*model.named_parameters())
    spec = param_shardings(model, mesh.shape["fsdp"], min_size)
    axes = [spec[n] for n in names]
    trainable = [p.requires_grad for p in params]
    masters = [torch.nn.Parameter(_shard(p, a, mesh), requires_grad=t)
               for p, a, t in zip(params, axes, trainable)]
    optimizer, schedule = optimizer_from_config(zip(names, masters), cfg,
                                                steps_per_epoch)
    state = ShardedState(
        names=list(names), axes=axes, shapes=[p.shape for p in params],
        params=masters, trainable=trainable,
        ema=([m.detach().clone() for m in masters] if settings.use_ema
             else []),
        optimizer=optimizer, schedule=schedule,
        gen=step_generator(dev, seed, dist.get_rank()), mesh=mesh)

    dtype = dtype or compute_dtype(cfg)
    keep = f32_names(model)
    buffers = {n: b.to(tensor_compute_dtype(n, b, dtype, keep))
               for n, b in model.named_buffers()}
    for p in params:  # the masters and the compute copies hold the values
        p.data = torch.empty(0, dtype=p.dtype, device=dev)
    frozen_idx = [i for i, t in enumerate(trainable) if not t]
    frozen = dict(zip((names[i] for i in frozen_idx),
                      state.gather((masters[i].detach() for i in frozen_idx),
                                   frozen_idx)))
    frozen = {n: t.to(tensor_compute_dtype(n, t, dtype, keep))
              for n, t in frozen.items()}
    train_idx = [i for i, t in enumerate(trainable) if t]
    fsdp, f = mesh.shape["fsdp"], mesh.index["fsdp"]

    def step_fn(state: ShardedState, batch: dict) -> dict:
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        whole = state.gather((state.params[i].detach() for i in train_idx),
                             train_idx)
        for t in whole:
            t.requires_grad_(True)
        tensors = {**buffers, **frozen, **{
            names[i]: t.to(tensor_compute_dtype(names[i], t, dtype, keep))
            for i, t in zip(train_idx, whole)}}
        out = functional_call(model, tensors, (batch,), {"gen": state.gen})
        scores, dis = out if is_ksvqe else (out, None)
        scores = [gather_batch(s.float()) for s in scores]
        loss, aux = total_loss(scores, gather_batch(batch["label"]), dis,
                               settings.contra_w, settings.rank_w)
        loss.backward()
        grads = sum_flat([t.grad if t.grad is not None else
                          torch.zeros_like(t) for t in whole])
        for i, g in zip(train_idx, grads):
            a = state.axes[i]
            state.params[i].grad = (g if a is None else
                                    g.chunk(fsdp, a)[f].contiguous())
        state.optimizer.step()
        state.schedule.step()
        if state.ema:
            ema_update(state.ema, [p.detach() for p in state.params],
                       settings.ema_decay)
        state.step += 1
        return {k: v.detach() for k, v in aux.items()}

    return step_fn, state


def make_sharded_eval_step(model: VQANetwork, config: dict):
    """``eval_fn(state, batches, use_ema=False)``: the (data, fsdp) eval
    (kvq_tpu/parallel/steps.py:198-229): the whole weights gathered from
    the shards (raw or EMA), with ``model``'s buffers, into one eval
    network in the compute dtype; each rank scores its own rows (its Loader
    shard: batches stamped with ``sample_index``) and every rank's rows are
    gathered by dataset index (``steps.gather_rows``).  Returns ``(index,
    scores, labels)``, the same on every rank."""
    cfg = normalize_config(config)
    dev = next(model.buffers()).device
    with torch.device(dev):
        net = cast_model(VQANetwork(cfg), compute_dtype(cfg)).eval()
    evaluator = Evaluator(cfg, model=net, device=dev)

    def eval_fn(state: ShardedState, batches: Iterable[dict],
                use_ema: bool = False):
        evaluator.model.load_state_dict(
            {**state.whole(use_ema), **dict(model.named_buffers())})
        return gather_rows(*evaluator._columns(batches, "label"))

    return eval_fn
