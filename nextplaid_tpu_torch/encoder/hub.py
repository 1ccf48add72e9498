"""Model-directory resolution: local paths and Hugging Face hub ids.

A copy of `nextplaid_tpu.encoder.hub` for the port. next-plaid resolves
encoder models the same way in two places: the ORT loader downloads hub
repos to a local cache when the model argument is not an existing directory
(next-plaid-onnx src/lib.rs model bootstrap), and colgrep's
`set-model`/`--model` accept either a path or a hub id
(colgrep/src/commands/config.rs). An existing directory wins; anything else
is treated as a hub repo id and fetched via
`huggingface_hub.snapshot_download` into the standard HF cache, cache first
(so repeated loads are served offline from the cache).

`huggingface_hub` is imported only here, when a hub id is given; without it
(or offline with nothing cached) resolution raises EncodingError, and
`HF_HUB_OFFLINE=1` is honored (cache-only resolution).
"""

from __future__ import annotations

import os
from pathlib import Path

from nextplaid_tpu_torch.utils.errors import EncodingError

# Weight/asset files an encoder load needs; everything else in a repo
# (ONNX blobs, TF checkpoints, READMEs' media) is skipped to keep the
# download minimal — the same file set scripts/export_model.py writes.
_ALLOW_PATTERNS = [
    "*.json",
    "*.safetensors",
    "pytorch_model.bin",
    "tokenizer.model",
    "vocab.txt",
    "merges.txt",
    "1_Dense/*",
]


def resolve_model_dir(model: str | os.PathLike) -> Path:
    """Return a local directory for `model`.

    Existing directories pass through untouched. Otherwise `model` is
    treated as a hub repo id ("lightonai/GTE-ModernColBERT-v1") and
    resolved through the HF cache — a network download on first use,
    cache hits thereafter (including fully offline).
    """
    p = Path(model)
    if p.is_dir():
        return p
    model = str(model)
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise EncodingError(
            f"model '{model}' is not a local directory and huggingface_hub "
            "is unavailable to fetch it from the hub"
        ) from e
    try:
        # Cache-first: even without HF_HUB_OFFLINE set, a complete cached
        # snapshot resolves without touching the network.
        return Path(
            snapshot_download(
                model,
                allow_patterns=_ALLOW_PATTERNS,
                local_files_only=True,
            )
        )
    except Exception:
        pass
    try:
        return Path(
            snapshot_download(model, allow_patterns=_ALLOW_PATTERNS)
        )
    except Exception as e:
        raise EncodingError(
            f"model '{model}' is neither a local directory nor a "
            f"fetchable hub repo (offline? bad id?): {e}"
        ) from e
