from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_shard,
    data_sharding,
    fsdp_sharding,
    local_shard,
    make_mesh,
    make_mesh_2d,
    replicated,
    shard_batch,
    spatial_sharding,
    tp_sharding,
)
from .runtime import RuntimeInfo, initialize_runtime, runtime_from_env, spawn
from .sync import MeshSync
