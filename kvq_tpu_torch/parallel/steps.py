"""The collectives of the data-parallel step and the gathered eval
(counterpart of kvq_tpu/parallel/steps.py:79-118 ``make_ddp_train_step``
and the tagged eval of :198-229).

JAX's DDP step is one ``shard_map``: each shard's loss and gradients, then
``pmean`` of the gradients, of the loss terms and (inside the forward) of
the BatchNorm statistics.  Here each process computes its shard's loss
and gradients with autograd, and these functions make it the same step:

  - :func:`broadcast_state`: rank 0's parameters, buffers and EMA, once
    (JAX replicates one state; torch's DDP broadcasts at construction);
  - :func:`all_reduce_mean`: the differentiable ``pmean`` that the synced
    BatchNorm runs in its forward; its backward is the ``pmean`` of the
    cotangents, JAX's transpose of ``pmean`` under ``shard_map``;
  - :func:`reduce_gradients`: the ``pmean`` of the gradients over flat
    float32 buckets, after ``backward``;
  - :func:`reduce_aux`: the ``pmean`` of the loss terms, one collective;
  - :func:`gather_rows`: every rank's eval rows, deduped by dataset index
    (kvq_tpu/train/trainer.py:571-601).

The (data, fsdp) flavour (``parallel/fsdp.py``) computes one global loss
on every rank, and uses two more:

  - :func:`gather_batch`: every rank's rows of a tensor, in rank order,
    differentiable; its backward keeps this rank's slice of the cotangent,
    so that the ranks' parameter gradients *sum* to the gradient of the
    global loss (a backward that summed the cotangents over the ranks
    would count the loss ``world`` times);
  - :func:`sum_flat`: the sum over the ranks of a list of tensors, a flat
    bucket (of at least float32) at a time.

A mean is a SUM all-reduce divided by the world size, as ``pmean`` is
``psum`` over the axis size (gloo has no AVG).  Every rank must issue the
same collectives in the same order, or the run hangs: the lists reduced
are built from the module's structure, never from the data.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

BUCKET_BYTES = 25 * 2 ** 20  # gradient bytes per all-reduce (torch DDP's)


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.rank, ctx.rows = dist.get_rank(group), x.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None


def gather_batch(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (each as many rows) concatenated in rank order on
    the leading axis; differentiable, this rank's input getting its own
    slice of the output's gradient."""
    return _GatherBatch.apply(x, group)


def _mean_(t: torch.Tensor, group=None) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t.div_(dist.get_world_size(group))


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _mean_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return _mean_(grad.clone(memory_format=torch.contiguous_format),
                      ctx.group), None


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks, differentiable: the gradient of
    each rank's input is the mean of every rank's output gradient."""
    return _AllReduceMean.apply(x, group)


def _buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int):
    """Consecutive runs of one dtype, each at most ``bucket_bytes`` (a
    larger tensor alone)."""
    bucket, size = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        if bucket and (t.dtype != bucket[0].dtype
                       or size + nbytes > bucket_bytes):
            yield bucket
            bucket, size = [], 0
        bucket.append(t)
        size += nbytes
    if bucket:
        yield bucket


@torch.no_grad()
def broadcast_state(module: torch.nn.Module,
                    ema: Iterable[torch.Tensor] = (), group=None,
                    bucket_bytes: int = BUCKET_BYTES) -> None:
    """Copy rank 0's parameters, buffers and ``ema`` tensors to every
    rank, a flat bucket at a time."""
    tensors = ([p.data for p in module.parameters()]
               + list(module.buffers()) + [e.data for e in ema])
    src = dist.get_rank(group) == 0
    for bucket in _buckets(tensors, bucket_bytes):
        flat = torch.cat([t.reshape(-1) for t in bucket])
        wire = flat.view(torch.uint8) if flat.dtype == torch.bool else flat
        dist.broadcast(wire, src=0, group=group)
        if not src:
            for t, v in zip(bucket, flat.split([t.numel() for t in bucket])):
                t.copy_(v.view(t.shape))


@torch.no_grad()
def reduce_gradients(params: Iterable[torch.nn.Parameter],
                     bucket_bytes: int = BUCKET_BYTES, group=None) -> None:
    """Replace each trainable parameter's gradient by its mean over the
    ranks, a flat float32 bucket at a time (frozen parameters are left out
    on every rank alike).  A missing gradient counts as zeros, so every
    rank reduces the same buckets, and the parameter gets the mean, as
    JAX gives every parameter a gradient."""
    params = [p for p in params if p.requires_grad]
    for bucket in _buckets(params, bucket_bytes):
        flat = _mean_(torch.cat([
            p.grad.reshape(-1).float() if p.grad is not None
            else torch.zeros(p.numel(), device=p.device) for p in bucket]),
            group)
        views = [v.view(p.shape) for p, v in
                 zip(bucket, flat.split([p.numel() for p in bucket]))]
        have = [(p.grad, v) for p, v in zip(bucket, views)
                if p.grad is not None]
        if have:
            torch._foreach_copy_(*map(list, zip(*have)))
        for p, v in zip(bucket, views):
            if p.grad is None:
                p.grad = v.to(p.dtype)


@torch.no_grad()
def sum_flat(tensors: Sequence[torch.Tensor], group=None,
             bucket_bytes: int = BUCKET_BYTES) -> list[torch.Tensor]:
    """The sum over the ranks of each of ``tensors``, as views of flat
    buckets of at least float32 (one all-reduce a bucket)."""
    out = []
    for bucket in _buckets(tensors, bucket_bytes):
        dt = torch.promote_types(bucket[0].dtype, torch.float32)
        flat = torch.cat([t.reshape(-1).to(dt) for t in bucket])
        dist.all_reduce(flat, group=group)
        out += [v.view(t.shape) for t, v in
                zip(bucket, flat.split([t.numel() for t in bucket]))]
    return out


def reduce_aux(aux: dict, group=None) -> dict:
    """The loss terms' means over the ranks, in one collective; 0-d
    float32 tensors on the terms' device (nothing is read back)."""
    keys = list(aux)
    flat = torch.stack([aux[k].detach().float() for k in keys])
    return dict(zip(keys, _mean_(flat, group).unbind()))


def merge_rows(index: Sequence[int], *cols: Sequence) -> tuple[list, ...]:
    """``(index, *cols)`` with each dataset index once, at its first
    occurrence's values (the shard wrap's and padding's duplicates
    dropped), in dataset-index order."""
    seen: dict[int, tuple] = {}
    for row in zip(index, *cols):
        seen.setdefault(int(row[0]), row[1:])
    order = sorted(seen)
    return (order, *([seen[i][c] for i in order] for c in range(len(cols))))


def gather_rows(index: Sequence[int], *cols: Sequence[float],
                group=None) -> tuple[list, ...]:
    """Every rank's eval rows ``(dataset index, *cols)``, merged by
    :func:`merge_rows`; the same on every rank.  The counts are gathered
    first, then the rows as float64 padded to the largest count (on the
    card for NCCL, in host memory for gloo) and trimmed."""
    world = dist.get_world_size(group)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    n = len(index)
    counts = [torch.zeros(1, dtype=torch.int64, device=dev)
              for _ in range(world)]
    dist.all_gather(counts, torch.tensor([n], device=dev), group=group)
    counts = [int(c) for c in counts]
    local = torch.zeros((1 + len(cols), max(counts)), dtype=torch.float64,
                        device=dev)
    local[:, :n] = torch.from_numpy(
        np.asarray([index, *cols], np.float64).reshape(1 + len(cols), n))
    rows = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(rows, local, group=group)
    got = torch.cat([r[:, :c] for r, c in zip(rows, counts)], 1).cpu().numpy()
    return merge_rows(got[0].astype(np.int64).tolist(),
                      *(c.tolist() for c in got[1:]))
