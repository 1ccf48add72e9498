"""REST API server (aiohttp) on the card — next-plaid-api's surface, as
`nextplaid_tpu.api` serves it."""

from nextplaid_tpu_torch.api.server import build_app, main  # noqa: F401
from nextplaid_tpu_torch.api.state import AppState  # noqa: F401
