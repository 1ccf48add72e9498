"""Python SDK + CLI for the nextplaid_tpu_torch REST API (next-plaid's
next-plaid-api/python-sdk; a copy of `nextplaid_tpu.client`, speaking to
either package's server)."""

from nextplaid_tpu_torch.client.async_client import AsyncNextPlaidClient  # noqa: F401
from nextplaid_tpu_torch.client.client import NextPlaidClient  # noqa: F401
from nextplaid_tpu_torch.client.exceptions import (  # noqa: F401
    IndexExistsError,
    IndexNotFoundError,
    NextPlaidClientError,
    ServerError,
    ValidationError,
)
