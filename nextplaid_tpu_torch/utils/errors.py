"""Framework error hierarchy (next-plaid src/error.rs:9-66).

A copy of `nextplaid_tpu.utils.errors`: the port imports nothing of the JAX
package, whose `__init__` pulls in jax.
"""


class NextPlaidError(Exception):
    """Base class for all nextplaid_tpu_torch errors."""


class StorageError(NextPlaidError):
    """NPY/JSON serialization or filesystem failures."""


class CodecError(NextPlaidError):
    """Residual codec failures (bad nbits, shape mismatches)."""


class SearchError(NextPlaidError):
    """Staged-search failures."""


class UpdateError(NextPlaidError):
    """Incremental-update failures."""


class DeleteError(NextPlaidError):
    """Delete failures."""


class FilteringError(NextPlaidError):
    """Metadata filtering / condition validation failures."""


class TextSearchError(NextPlaidError):
    """Keyword (FTS) search failures."""


class EncodingError(NextPlaidError):
    """Encoder (ColBERT) failures."""
