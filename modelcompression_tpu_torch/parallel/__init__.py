from modelcompression_tpu_torch.core.mesh import MeshConfig, make_mesh
from modelcompression_tpu_torch.parallel.sharding import (
    data_parallel, gather_params, gather_train_state, param_specs,
    place_train_state, replicate, shard_batch, shard_params,
)

__all__ = [
    "MeshConfig", "make_mesh", "data_parallel", "gather_params",
    "gather_train_state", "param_specs", "place_train_state", "replicate",
    "shard_batch", "shard_params",
]
