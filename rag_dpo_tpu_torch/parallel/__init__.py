from .mesh import (  # noqa: F401
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_SHARD,
    MeshSpec,
    active_cp_mesh,
    context_parallel,
    create_mesh,
    create_multihost_mesh,
    host_local_rows,
    initialize_multihost,
    is_multihost,
    local_device_count,
    shard_leading_axis,
    replicated,
)
from .collectives import (  # noqa: F401
    merge_sharded_topk,
    sharded_topk,
    sharded_topk_multi,
)
