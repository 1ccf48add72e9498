"""Semantic code search (reference: colgrep)."""

from nextplaid_tpu_torch.codesearch.embed import (  # noqa: F401
    build_embedding_text,
    normalize_path_for_embedding,
    shorten_path,
)
from nextplaid_tpu_torch.codesearch.indexer import ProjectIndexer  # noqa: F401
from nextplaid_tpu_torch.codesearch.parser import extract_units  # noqa: F401
from nextplaid_tpu_torch.codesearch.searcher import (  # noqa: F401
    Searcher,
    SearchHit,
    SearchOptions,
)
from nextplaid_tpu_torch.codesearch.types import (  # noqa: F401
    CodeUnit,
    UnitType,
    detect_language,
)
