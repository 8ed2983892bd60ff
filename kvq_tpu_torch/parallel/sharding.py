"""Batch and parameter sharding (counterpart of kvq_tpu/parallel/sharding.py).

The batch half (:10-92): JAX places one global batch over the mesh
(``shard_batch``); here every process is one device and reads its own part
of the sample list, so a batch's shard is this rank's ``Loader`` shard:
every ``world``-th sample of the list tiled to a multiple of ``world``,
starting at ``rank`` (``data/pipeline.py:Loader``).  Under the (data, fsdp)
layout (``mesh.make_mesh``) the batch is split over both axes jointly, rank
``r`` holding rows ``r*b`` to ``(r+1)*b`` of the global batch, as JAX's
``P(("data", "fsdp"))`` places them.

The parameter half (:21-63): :func:`param_spec` is JAX's size rule, applied
to the JAX shape of each parameter (``core/from_jax.py:jax_axes``), and
:func:`param_shardings` maps the chosen JAX axis to the port's tensor, so
that a parameter is split where JAX splits it: a Linear weight (out, in)
that JAX splits on its output axis is split on axis 0 here.
"""

from __future__ import annotations

from torch import nn

from ..core.from_jax import jax_axes
from .mesh import rank, world

MIN_SIZE = 2 ** 17   # JAX's param_shardings default
MIN_SHARD = 128      # JAX's param_spec default


def loader_shard() -> tuple[int, int]:
    """``(rank, world)``: the ``shard`` argument of this rank's Loaders."""
    return rank(), world()


def param_spec(shape: tuple[int, ...], fsdp_size: int,
               min_size: int = MIN_SIZE,
               min_shard: int = MIN_SHARD) -> int | None:
    """The axis of a JAX array of ``shape`` that the ``fsdp`` axis splits,
    or None (replicated): only an array of at least ``min_size`` elements,
    and only an axis divisible by ``fsdp_size`` that keeps at least
    ``min_shard`` elements a shard; among those the largest, a tie going to
    the last."""
    size = 1
    for d in shape:
        size *= d
    if fsdp_size <= 1 or size < min_size:
        return None
    best = None
    for axis in reversed(range(len(shape))):
        if shape[axis] % fsdp_size or shape[axis] // fsdp_size < min_shard:
            continue
        if best is None or shape[axis] > shape[best]:
            best = axis
    return best


def param_shardings(model: nn.Module, fsdp_size: int,
                    min_size: int = MIN_SIZE) -> dict[str, int | None]:
    """Parameter name -> the port axis that the ``fsdp`` axis splits, or
    None, for every parameter of ``model`` (frozen ones too, as JAX's
    ``param_shardings`` covers every leaf)."""
    out = {}
    for name, p in model.named_parameters():
        axes = jax_axes(model, name)
        axis = param_spec(tuple(p.shape[a] for a in axes), fsdp_size,
                          min_size)
        out[name] = None if axis is None else axes[axis]
    return out
