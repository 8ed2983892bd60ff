"""Data-parallel training and eval over ``torch.distributed`` (counterpart of
kvq_tpu/parallel/, its DDP flavour): the process group
(:mod:`.mesh`), each rank's Loader shard (:mod:`.sharding`) and the
collectives of the step and of the gathered eval (:mod:`.steps`)."""

from .mesh import init_distributed, launch, rank, rank_device, world  # noqa: F401
from .sharding import loader_shard  # noqa: F401
