from deadtrees_tpu_torch.parallel.mesh import (
    batch_sharding,
    create_mesh,
    distributed_init,
    replicate,
    replicate_sharding,
    shard_batch,
)

__all__ = [
    "batch_sharding",
    "create_mesh",
    "distributed_init",
    "replicate",
    "replicate_sharding",
    "shard_batch",
]
