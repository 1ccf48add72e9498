"""API request/response DTOs (pydantic).

Field-compatible with next-plaid's utoipa schemas
(next-plaid-api/src/models.rs) so next-plaid's Python SDK and test
harnesses work against this server unchanged. Embeddings travel as JSON
arrays of arrays OR base64-encoded little-endian f32 + shape
(models.rs:159-213).

A copy of `nextplaid_tpu.api.models` (the port imports nothing of the JAX
package): the wire encodings and the `config.json` schema are the same
bytes, so either server serves the other's index directories.
"""

from __future__ import annotations

import base64
from typing import Any, Dict, List, Literal, Optional, Tuple

import numpy as np
from pydantic import BaseModel, Field

from nextplaid_tpu_torch.utils.errors import NextPlaidError


class ApiModel(BaseModel):
    model_config = {"extra": "ignore"}


# ---------------------------------------------------------------------------
# Embedding transport
# ---------------------------------------------------------------------------


class DocumentEmbeddings(ApiModel):
    embeddings: Optional[List[List[float]]] = None
    embeddings_b64: Optional[str] = None
    shape: Optional[Tuple[int, int]] = None
    # Wire dtype of embeddings_b64 (an extension; absent = float32,
    # the reference wire format). "bfloat16" halves payload bytes and
    # base64/JSON marshalling time; compute paths are bf16/int8 anyway, so
    # the truncation is below scoring precision.
    dtype: Literal["float32", "bfloat16"] = "float32"

    def to_array(self) -> np.ndarray:
        return decode_embeddings(
            self.embeddings, self.embeddings_b64, self.shape, self.dtype
        )


def decode_embeddings(
    embeddings: Optional[List[List[float]]],
    b64: Optional[str],
    shape: Optional[Tuple[int, int]],
    dtype: str = "float32",
) -> np.ndarray:
    """JSON array or base64 LE (f32 | bf16) + shape -> [tokens, dim] f32."""
    if b64 is not None:
        if shape is None:
            raise NextPlaidError("embeddings_b64 requires shape")
        raw = base64.b64decode(b64)
        if dtype == "bfloat16":
            # bf16 = the high 16 bits of f32: widen u16 -> u32<<16, view f32.
            u16 = np.frombuffer(raw, dtype="<u2")
            arr = (
                (u16.astype(np.uint32) << 16).view(np.float32).reshape(shape)
            )
            return np.ascontiguousarray(arr)
        arr = np.frombuffer(raw, dtype="<f4").reshape(shape)
        return np.ascontiguousarray(arr, dtype=np.float32)
    if embeddings is not None:
        return np.asarray(embeddings, dtype=np.float32)
    raise NextPlaidError("Provide either embeddings or embeddings_b64 + shape")


def encode_embeddings_b64(
    arr: np.ndarray, dtype: str = "float32"
) -> Tuple[str, Tuple[int, int]]:
    if dtype == "bfloat16":
        f32 = np.ascontiguousarray(arr, dtype="<f4")
        # Round-to-nearest-even on the dropped mantissa bits (cheap vectorized
        # form: add 0x7FFF + lsb-of-kept before truncating), matching
        # hardware f32->bf16 casts rather than truncation.
        u32 = f32.view(np.uint32)
        rounded = u32 + 0x7FFF + ((u32 >> 16) & 1)
        u16 = (rounded >> 16).astype("<u2")
        return base64.b64encode(u16.tobytes()).decode("ascii"), tuple(arr.shape)
    arr = np.ascontiguousarray(arr, dtype="<f4")
    return base64.b64encode(arr.tobytes()).decode("ascii"), tuple(arr.shape)


# ---------------------------------------------------------------------------
# Index management
# ---------------------------------------------------------------------------


class IndexConfigRequest(ApiModel):
    nbits: Optional[int] = None
    batch_size: Optional[int] = None
    seed: Optional[int] = None
    start_from_scratch: Optional[int] = None
    max_documents: Optional[int] = None
    fts_tokenizer: Optional[str] = None


class CreateIndexRequest(ApiModel):
    name: str
    config: IndexConfigRequest = Field(default_factory=IndexConfigRequest)


class IndexConfigStored(ApiModel):
    nbits: int = 4
    batch_size: int = 50_000
    seed: Optional[int] = 42
    start_from_scratch: int = 999
    max_documents: Optional[int] = None
    fts_tokenizer: str = "unicode61"
    # Extension of next-plaid's schema (which tolerates extra config.json
    # fields): "auto" = DeviceIndex.load + with_token_grid (full serving:
    # staged + exact + O(batch) appends); "grid_only" = load_grid_only
    # (exact-only serving — codes/IVF never on the device; ingest falls back
    # to mutate-on-disk + reload). "sharded" / "sharded_grid" = doc-range
    # shards over the visible cards (ShardedIndex / ShardedGridIndex,
    # parallel/sharded.py; ingest appends in place where it fits).
    # NEXT_PLAID_SERVE_MODE overrides for all indexes.
    serve_mode: str = "auto"


class UpdateIndexConfigRequest(ApiModel):
    max_documents: Optional[int] = None


# ---------------------------------------------------------------------------
# Documents
# ---------------------------------------------------------------------------


class AddDocumentsRequest(ApiModel):
    documents: List[DocumentEmbeddings]
    metadata: List[Dict[str, Any]] = Field(default_factory=list)


class UpdateIndexRequest(ApiModel):
    documents: List[DocumentEmbeddings]
    metadata: List[Dict[str, Any]] = Field(default_factory=list)


class UpdateWithEncodingRequest(ApiModel):
    documents: List[str]
    metadata: List[Dict[str, Any]] = Field(default_factory=list)
    pool_factor: Optional[int] = None


class DeleteDocumentsRequest(ApiModel):
    condition: str
    parameters: List[Any] = Field(default_factory=list)


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


class QueryEmbeddings(ApiModel):
    embeddings: Optional[List[List[float]]] = None
    embeddings_b64: Optional[str] = None
    shape: Optional[Tuple[int, int]] = None
    dtype: Literal["float32", "bfloat16"] = "float32"

    def to_array(self) -> np.ndarray:
        return decode_embeddings(
            self.embeddings, self.embeddings_b64, self.shape, self.dtype
        )


class SearchParamsRequest(ApiModel):
    top_k: Optional[int] = None
    n_ivf_probe: Optional[int] = None
    n_full_scores: Optional[int] = None
    centroid_score_threshold: Optional[float] = None
    # Recall-targeted operating point (an extension): a float target into
    # the measured QPS/recall frontier, or a named preset via `profile`
    # ("latency" | "balanced" | "quality" | "exact").
    target_recall: Optional[float] = None
    profile: Optional[str] = None


class SearchRequest(ApiModel):
    queries: Optional[List[QueryEmbeddings]] = None
    params: SearchParamsRequest = Field(default_factory=SearchParamsRequest)
    subset: Optional[List[int]] = None
    text_query: Optional[List[str]] = None
    alpha: Optional[float] = None
    fusion: Optional[str] = None  # "relative_score" (default) | "rrf"
    filter_condition: Optional[str] = None
    filter_parameters: List[Any] = Field(default_factory=list)


class FilteredSearchRequest(ApiModel):
    queries: List[QueryEmbeddings]
    params: SearchParamsRequest = Field(default_factory=SearchParamsRequest)
    filter_condition: str
    filter_parameters: List[Any] = Field(default_factory=list)


class SearchWithEncodingRequest(ApiModel):
    queries: List[str]
    params: SearchParamsRequest = Field(default_factory=SearchParamsRequest)
    subset: Optional[List[int]] = None
    text_query: Optional[List[str]] = None
    alpha: Optional[float] = None
    fusion: Optional[str] = None


class FilteredSearchWithEncodingRequest(ApiModel):
    queries: List[str]
    params: SearchParamsRequest = Field(default_factory=SearchParamsRequest)
    filter_condition: str
    filter_parameters: List[Any] = Field(default_factory=list)
    text_query: Optional[List[str]] = None
    alpha: Optional[float] = None
    fusion: Optional[str] = None


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------


class CheckMetadataRequest(ApiModel):
    document_ids: List[int]


class GetMetadataRequest(ApiModel):
    document_ids: Optional[List[int]] = None
    condition: Optional[str] = None
    parameters: List[Any] = Field(default_factory=list)
    limit: Optional[int] = None


class QueryMetadataRequest(ApiModel):
    condition: str
    parameters: List[Any] = Field(default_factory=list)


class UpdateMetadataRequest(ApiModel):
    condition: str
    parameters: List[Any] = Field(default_factory=list)
    updates: Dict[str, Any]


# ---------------------------------------------------------------------------
# Encode / rerank
# ---------------------------------------------------------------------------


class EncodeRequest(ApiModel):
    texts: List[str]
    input_type: Literal["query", "document"] = "document"
    pool_factor: Optional[int] = None
    output_format: Literal["json", "base64"] = "json"


class RerankRequest(ApiModel):
    query: Optional[List[List[float]]] = None
    query_b64: Optional[str] = None
    query_shape: Optional[Tuple[int, int]] = None
    documents: List[DocumentEmbeddings] = Field(default_factory=list)

    def query_array(self) -> np.ndarray:
        return decode_embeddings(self.query, self.query_b64, self.query_shape)


class RerankWithEncodingRequest(ApiModel):
    query: str
    documents: List[str]
    pool_factor: Optional[int] = None
