"""ColBERT encoder configuration.

A copy of `nextplaid_tpu.encoder.config` for the port. Field-compatible with
next-plaid-onnx's `ColbertConfig` (src/lib.rs:555-697), which is serialized
as `onnx_config.json` in exported model directories: the same file (or a
`colbert_config.json`) configures both stacks identically. Defaults match
lib.rs:617-646.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


@dataclass
class ColbertConfig:
    query_prefix: str = "[Q] "
    document_prefix: str = "[D] "
    query_length: int = 48
    document_length: int = 300
    do_query_expansion: bool = True
    embedding_dim: int = 128
    uses_token_type_ids: bool = True
    mask_token_id: int = 103
    pad_token_id: int = 0
    skiplist_words: List[str] = field(default_factory=list)
    model_type: str = "ColBERT"
    model_name: Optional[str] = None
    attend_to_expansion_tokens: bool = False
    query_prefix_id: Optional[int] = None
    document_prefix_id: Optional[int] = None
    do_lower_case: bool = False

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ColbertConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_file(cls, path) -> "ColbertConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_model_dir(cls, model_dir) -> "ColbertConfig":
        """Load from `onnx_config.json` (reference name) or
        `colbert_config.json` in the model directory; defaults otherwise."""
        model_dir = Path(model_dir)
        for name in ("onnx_config.json", "colbert_config.json"):
            p = model_dir / name
            if p.exists():
                return cls.from_file(p)
        return cls()

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
