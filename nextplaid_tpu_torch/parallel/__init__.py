"""Multi-device parallelism: doc-range-sharded search, appends and k-means
over a mesh of devices (and processes, through torch.distributed)."""

from nextplaid_tpu_torch.parallel.mesh import (  # noqa: F401
    DOC_AXIS,
    Mesh,
    init_distributed,
    make_mesh,
)
from nextplaid_tpu_torch.parallel.sharded import (  # noqa: F401
    HostIndexData,
    ShardedGridIndex,
    ShardedIndex,
    lloyd_sharded,
    search_batch_sharded,
    search_batch_sharded_grid,
)
