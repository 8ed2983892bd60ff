"""Data-parallel training and eval over ``torch.distributed`` (counterpart of
kvq_tpu/parallel/): the process group and the (data, fsdp) mesh
(:mod:`.mesh`), each rank's Loader shard and the parameter specs
(:mod:`.sharding`), the collectives of the DDP step and of the gathered
eval (:mod:`.steps`), the (data, fsdp) sharded step (:mod:`.fsdp`) and the
multi-device dry run (:mod:`.dryrun`)."""

from .mesh import (  # noqa: F401
    init_distributed,
    launch,
    make_mesh,
    rank,
    rank_device,
    world,
)
from .sharding import loader_shard  # noqa: F401
