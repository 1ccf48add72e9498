"""Index layer: build, device container, exact and staged search, update,
delete."""

from nextplaid_tpu_torch.index.build import (  # noqa: F401
    create_index,
    create_index_from_device,
    create_index_streamed,
)
from nextplaid_tpu_torch.index.config import (  # noqa: F401
    IndexConfig,
    Metadata,
    SearchParameters,
)
from nextplaid_tpu_torch.index.container import (  # noqa: F401
    DeviceIndex,
    load_grid_only,
)
from nextplaid_tpu_torch.index.delete import (  # noqa: F401
    delete_from_index,
    delete_with_options,
)
from nextplaid_tpu_torch.index.embeddings import reconstruct_embeddings  # noqa: F401
from nextplaid_tpu_torch.index.search import (  # noqa: F401
    PendingSearch,
    QueryResult,
    search_batch,
    search_batch_async,
    search_one,
)
from nextplaid_tpu_torch.index.update import (  # noqa: F401
    UpdateConfig,
    update_index,
    update_or_create,
    update_or_create_with_metadata,
)
