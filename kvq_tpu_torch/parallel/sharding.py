"""The batch half of kvq_tpu/parallel/sharding.py:10-92.

JAX places one global batch over the mesh (``shard_batch``); here every
process is one device and reads its own part of the sample list, so a
batch's shard is this rank's ``Loader`` shard: every ``world``-th sample of
the list tiled to a multiple of ``world``, starting at ``rank``
(``data/pipeline.py:Loader``).  The parameter specs of the (data, fsdp)
flavour are not ported.
"""

from __future__ import annotations

from .mesh import rank, world


def loader_shard() -> tuple[int, int]:
    """``(rank, world)``: the ``shard`` argument of this rank's Loaders."""
    return rank(), world()
