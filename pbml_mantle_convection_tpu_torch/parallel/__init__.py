from .mesh import (  # noqa: F401
    DATA_AXIS, batch_sharding, make_mesh, maybe_initialize_distributed,
    replicated_sharding, shard_batch, shard_host_local_batch)
from .sequence import (  # noqa: F401
    physics_attention_ref, physics_attention_sharded)
