"""Process groups for data-parallel runs (counterpart of
kvq_tpu/parallel/mesh.py:25-42).

The JAX package lays its devices out in a mesh whose ``data`` axis carries
the batch; here each process drives one device.  In the DDP flavour the
``data`` axis is the default process group of ``torch.distributed``: its
rank is the shard's index (JAX's ``axis_index("data")``), its size the
axis size.  :func:`make_mesh` lays the ranks out as JAX's
``make_mesh(data, fsdp)`` lays out its devices, rank ``r`` at ``(r //
fsdp, r % fsdp)``, and makes the process groups of both axes.
:func:`init_distributed` is the ``jax.distributed.initialize`` analog.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..core.device import resolve_device


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """The number of processes, 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device="cuda") -> torch.device:
    """This rank's device: a bare ``"cuda"`` is ``cuda:LOCAL_RANK``; an
    explicit index (``cuda:0`` for two ranks sharing one card) and the CPU
    stay as given.  Without CUDA a CUDA device raises (``resolve_device``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return dev


def init_distributed(device="cuda", backend: str | None = None,
                     init_method: str | None = None) -> torch.device:
    """Join the process group of ``RANK`` and ``WORLD_SIZE`` (torchrun's
    environment) and return this rank's device.  ``init_method`` defaults
    to ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``); the tests pass a
    ``file://`` path.  ``backend`` defaults to ``nccl`` on a CUDA device
    and ``gloo`` on the CPU; ``gloo`` on CUDA tensors is allowed (NCCL
    refuses two ranks on one card).  NCCL's communicator is made here,
    eagerly, so that a failure raises now; no other backend is tried."""
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the nccl backend needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        device_id=dev if backend == "nccl" else None)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The (data, fsdp) layout of the default group: ``shape`` by axis
    name (JAX's ``mesh.shape``), this rank's index on each axis, and this
    rank's process group along each axis: ``groups["fsdp"]`` holds the
    ``fsdp`` consecutive ranks of its data row, ``groups["data"]`` the
    ranks ``fsdp`` apart that share its fsdp index."""

    shape: dict
    index: dict
    groups: dict


def make_mesh(data: int | None = None, fsdp: int = 1) -> Mesh:
    """The (data, fsdp) mesh over the ranks of the default group (one
    device each): ``data`` defaults to ``world // fsdp``.  Every rank must
    call it, in the same order as its other group calls: each makes every
    subgroup, as ``torch.distributed.new_group`` requires."""
    n = world()
    if data is None:
        data = n // fsdp
    if data * fsdp != n:
        raise ValueError(f"mesh {data}x{fsdp} != {n} ranks")
    r = rank()
    groups = {}
    for d in range(data):  # the fsdp groups: consecutive ranks
        g = dist.new_group([d * fsdp + f for f in range(fsdp)])
        if d == r // fsdp:
            groups["fsdp"] = g
    for f in range(fsdp):  # the data groups: ranks fsdp apart
        g = dist.new_group([d * fsdp + f for d in range(data)])
        if f == r % fsdp:
            groups["data"] = g
    return Mesh(shape={"data": data, "fsdp": fsdp},
                index={"data": r // fsdp, "fsdp": r % fsdp}, groups=groups)


def launch(device="cuda") -> torch.device:
    """The device of an entry point: under torchrun (``WORLD_SIZE`` in the
    environment) the process group is joined first, once; a process that
    joined one already runs on its rank's device."""
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        return init_distributed(device)
    return rank_device(device) if dist.is_initialized() else \
        resolve_device(device)
