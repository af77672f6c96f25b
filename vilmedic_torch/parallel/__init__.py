from .mesh import (  # noqa: F401
    broadcast_json,
    gather_arrays,
    gather_string_lists,
    gather_weighted_mean,
    init_distributed,
    local_batch_size,
    process_allgather,
)
from .sharding import param_specs, shard_params  # noqa: F401
