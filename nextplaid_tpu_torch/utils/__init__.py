"""Shared utilities: errors, progress reporting, tracing, device selection."""

from nextplaid_tpu_torch.utils.errors import (  # noqa: F401
    CodecError,
    DeleteError,
    EncodingError,
    FilteringError,
    NextPlaidError,
    SearchError,
    StorageError,
    TextSearchError,
    UpdateError,
)
