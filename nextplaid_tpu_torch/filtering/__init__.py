"""Host-side metadata filtering + keyword search (SQLite / FTS5).

Mirrors the reference's `filtering` and `text_search` modules
(next-plaid src/{filtering,text_search}.rs). The device search
pipeline consumes the doc-id subsets produced here as boolean masks.

A copy of `nextplaid_tpu.filtering` (jax-free, but the port imports nothing
of the JAX package); only the imports differ.
"""

from nextplaid_tpu_torch.filtering import text_search  # noqa: F401
from nextplaid_tpu_torch.filtering.conditions import (  # noqa: F401
    is_valid_column_name,
    validate_condition,
)
from nextplaid_tpu_torch.filtering.metadata import (  # noqa: F401
    SUBSET_COLUMN,
    count,
    create,
    delete,
    exists,
    get,
    get_distinct_strings,
    update,
    update_where,
    where_condition,
    where_condition_regexp,
)
