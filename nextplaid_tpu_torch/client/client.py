"""Synchronous Python SDK for the nextplaid_tpu_torch REST API.

Method-compatible with next-plaid's SDK
(next-plaid-api/python-sdk/next_plaid_client/client.py):
health, index CRUD, auto-batched add, delete-by-filter, search (semantic /
keyword / hybrid, filter conditions, subsets), metadata ops, encode, rerank.

Embeddings are sent base64-encoded (LE f32 + shape) by default — smaller and
faster than JSON arrays for multi-vector payloads.
"""

from __future__ import annotations

import base64
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import requests

from nextplaid_tpu_torch.client.exceptions import (
    ConnectionError_,
    raise_for_status,
)

ArrayLike = Union[np.ndarray, Sequence[Sequence[float]]]


def _doc_payload(
    arr: ArrayLike, use_b64: bool = True, wire_dtype: str = "float32"
) -> Dict[str, Any]:
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.float32))
    if a.ndim != 2:
        raise ValueError(f"embeddings must be 2-D [tokens, dim], got {a.shape}")
    if use_b64:
        from nextplaid_tpu_torch.api.models import encode_embeddings_b64

        b64, shape = encode_embeddings_b64(a, wire_dtype)
        out = {"embeddings_b64": b64, "shape": list(shape)}
        if wire_dtype != "float32":
            out["dtype"] = wire_dtype
        return out
    return {"embeddings": a.tolist()}


class NextPlaidClient:
    def __init__(
        self,
        base_url: str = "http://localhost:8080",
        timeout: float = 300.0,
        use_base64: bool = True,
        session: Optional[requests.Session] = None,
        wire_dtype: str = "float32",
    ):
        """wire_dtype="bfloat16" halves base64 payload bytes (high 16 bits
        of f32, round-to-nearest-even) — below bf16/int8 scoring precision,
        so search results are unaffected in practice; keep float32 when
        archiving embeddings through the API."""
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.use_base64 = use_base64
        self.wire_dtype = wire_dtype
        self.session = session or requests.Session()

    # -- plumbing --------------------------------------------------------------

    def _request(self, method: str, path: str, json: Any = None) -> Any:
        try:
            resp = self.session.request(
                method, self.base_url + path, json=json, timeout=self.timeout
            )
        except requests.ConnectionError as e:
            raise ConnectionError_(f"Cannot reach {self.base_url}: {e}") from e
        if resp.status_code >= 400:
            try:
                message = resp.json().get("error", resp.text)
            except Exception:
                message = resp.text
            raise_for_status(resp.status_code, message)
        return resp.json()

    # -- health / index management ----------------------------------------------

    def health(self) -> Dict[str, Any]:
        return self._request("GET", "/health")

    def list_indices(self) -> List[str]:
        return self._request("GET", "/indices")

    def get_index(self, name: str) -> Dict[str, Any]:
        return self._request("GET", f"/indices/{name}")

    def create_index(
        self, name: str, config: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        payload: Dict[str, Any] = {"name": name}
        if config:
            payload["config"] = config
        return self._request("POST", "/indices", json=payload)

    def delete_index(self, name: str) -> Dict[str, Any]:
        return self._request("DELETE", f"/indices/{name}")

    def update_index_config(
        self, name: str, max_documents: Optional[int] = None
    ) -> Dict[str, Any]:
        return self._request(
            "PUT",
            f"/indices/{name}/config",
            json={"max_documents": max_documents},
        )

    # -- documents ---------------------------------------------------------------

    def add(
        self,
        index_name: str,
        documents: Union[Sequence[ArrayLike], Sequence[str]],
        metadata: Optional[Sequence[Dict[str, Any]]] = None,
        batch_size: int = 64,
        pool_factor: Optional[int] = None,
    ) -> Dict[str, Any]:
        """Add documents: arrays go to /update, strings to
        /update_with_encoding (server-side encoding). Auto-batched."""
        if metadata is not None and len(metadata) != len(documents):
            raise ValueError("metadata length must match documents length")
        total_added, last = 0, {}
        for start in range(0, len(documents), batch_size):
            chunk = documents[start : start + batch_size]
            meta_chunk = (
                list(metadata[start : start + batch_size])
                if metadata is not None
                else None
            )
            if chunk and isinstance(chunk[0], str):
                payload: Dict[str, Any] = {"documents": list(chunk)}
                if meta_chunk is not None:
                    payload["metadata"] = meta_chunk
                if pool_factor is not None:
                    payload["pool_factor"] = pool_factor
                last = self._request(
                    "POST",
                    f"/indices/{index_name}/update_with_encoding",
                    json=payload,
                )
            else:
                payload = {
                    "documents": [
                        _doc_payload(d, self.use_base64, self.wire_dtype)
                        for d in chunk
                    ]
                }
                if meta_chunk is not None:
                    payload["metadata"] = meta_chunk
                last = self._request(
                    "POST", f"/indices/{index_name}/update", json=payload
                )
            total_added += len(chunk)
        last["documents_added"] = total_added
        return last

    def delete(
        self,
        index_name: str,
        condition: str,
        parameters: Optional[List[Any]] = None,
        wait: bool = False,
        timeout: float = 60.0,
    ) -> Dict[str, Any]:
        """Delete documents matching a metadata filter condition.

        Asynchronous on the server (202 Accepted; conditions are batched in
        a per-index worker). With ``wait=True``, polls the index until the
        document count stops changing (convenience next-plaid's SDK leaves
        to the caller)."""
        payload: Dict[str, Any] = {"condition": condition}
        if parameters:
            payload["parameters"] = parameters
        before = None
        if wait:
            before = self.get_index(index_name).get("num_documents")
        resp = self._request(
            "DELETE", f"/indices/{index_name}/documents", json=payload
        )
        if not wait:
            return resp
        import time as _time

        # Converged = the count has been STABLE for 1 s after the server's
        # delete-batch window (~2 s DELETE_BATCH_MAX_WAIT) has had a chance
        # to fire. Stability alone (not change-then-stability): a condition
        # matching zero documents never changes the count and must still
        # return promptly, not poll to the timeout.
        t0 = _time.time()
        deadline = t0 + timeout
        last = before
        stable_since = None
        min_elapsed = 2.5  # covers the server's max batching window
        while _time.time() < deadline:
            _time.sleep(0.25)
            now = self.get_index(index_name).get("num_documents")
            if now == last:
                if stable_since is None:
                    stable_since = _time.time()
                elif (
                    _time.time() - stable_since > 1.0
                    and _time.time() - t0 >= min_elapsed
                ):
                    break
            else:
                stable_since = None
            last = now
        resp["num_documents"] = last
        return resp

    # -- search --------------------------------------------------------------------

    def search(
        self,
        index_name: str,
        queries: Union[Sequence[ArrayLike], Sequence[str], None] = None,
        top_k: int = 10,
        params: Optional[Dict[str, Any]] = None,
        text_query: Optional[List[str]] = None,
        alpha: Optional[float] = None,
        fusion: Optional[str] = None,
        filter_condition: Optional[str] = None,
        filter_parameters: Optional[List[Any]] = None,
        subset: Optional[List[int]] = None,
    ) -> Dict[str, Any]:
        params = dict(params or {})
        params.setdefault("top_k", top_k)
        is_text = bool(queries) and isinstance(queries[0], str)

        if queries and not is_text:
            payload: Dict[str, Any] = {
                "queries": [
                    _doc_payload(q, self.use_base64, self.wire_dtype)
                    for q in queries
                ],
                "params": params,
            }
            endpoint = f"/indices/{index_name}/search"
        elif is_text:
            payload = {"queries": list(queries), "params": params}
            if filter_condition:
                payload["filter_condition"] = filter_condition
                if filter_parameters:
                    payload["filter_parameters"] = filter_parameters
                if text_query:
                    payload["text_query"] = text_query
                if alpha is not None:
                    payload["alpha"] = alpha
                if fusion:
                    payload["fusion"] = fusion
                return self._request(
                    "POST",
                    f"/indices/{index_name}/search/filtered_with_encoding",
                    json=payload,
                )
            endpoint = f"/indices/{index_name}/search_with_encoding"
        else:
            payload = {"params": params}
            endpoint = f"/indices/{index_name}/search"

        if text_query:
            payload["text_query"] = text_query
        if alpha is not None:
            payload["alpha"] = alpha
        if fusion:
            payload["fusion"] = fusion
        if filter_condition:
            payload["filter_condition"] = filter_condition
            if filter_parameters:
                payload["filter_parameters"] = filter_parameters
        if subset is not None:
            payload["subset"] = subset
        return self._request("POST", endpoint, json=payload)

    def keyword_search(
        self,
        index_name: str,
        queries: List[str],
        top_k: int = 10,
        filter_condition: Optional[str] = None,
        filter_parameters: Optional[List[Any]] = None,
    ) -> Dict[str, Any]:
        return self.search(
            index_name,
            queries=None,
            top_k=top_k,
            text_query=queries,
            filter_condition=filter_condition,
            filter_parameters=filter_parameters,
        )

    # -- metadata ---------------------------------------------------------------------

    def get_metadata(self, index_name: str) -> Dict[str, Any]:
        return self._request("GET", f"/indices/{index_name}/metadata")

    def get_metadata_count(self, index_name: str) -> Dict[str, Any]:
        return self._request("GET", f"/indices/{index_name}/metadata/count")

    def check_metadata(
        self, index_name: str, document_ids: List[int]
    ) -> Dict[str, Any]:
        return self._request(
            "POST",
            f"/indices/{index_name}/metadata/check",
            json={"document_ids": document_ids},
        )

    def query_metadata(
        self,
        index_name: str,
        condition: str,
        parameters: Optional[List[Any]] = None,
    ) -> Dict[str, Any]:
        payload: Dict[str, Any] = {"condition": condition}
        if parameters:
            payload["parameters"] = parameters
        return self._request(
            "POST", f"/indices/{index_name}/metadata/query", json=payload
        )

    def get_metadata_by_ids(
        self,
        index_name: str,
        document_ids: Optional[List[int]] = None,
        condition: Optional[str] = None,
        parameters: Optional[List[Any]] = None,
        limit: Optional[int] = None,
    ) -> Dict[str, Any]:
        payload: Dict[str, Any] = {}
        if document_ids is not None:
            payload["document_ids"] = document_ids
        if condition is not None:
            payload["condition"] = condition
        if parameters:
            payload["parameters"] = parameters
        if limit is not None:
            payload["limit"] = limit
        return self._request(
            "POST", f"/indices/{index_name}/metadata/get", json=payload
        )

    def update_metadata(
        self,
        index_name: str,
        condition: str,
        updates: Dict[str, Any],
        parameters: Optional[List[Any]] = None,
    ) -> Dict[str, Any]:
        payload: Dict[str, Any] = {"condition": condition, "updates": updates}
        if parameters:
            payload["parameters"] = parameters
        return self._request(
            "POST", f"/indices/{index_name}/metadata/update", json=payload
        )

    def get_distinct_metadata(
        self, index_name: str, column: str
    ) -> List[str]:
        """Distinct string values of a metadata column (next-plaid SDK
        get_distinct_strings)."""
        return self._request(
            "POST",
            f"/indices/{index_name}/metadata/distinct",
            json={"column": column},
        )["values"]

    # -- encode / rerank ------------------------------------------------------------------

    def encode(
        self,
        texts: List[str],
        input_type: str = "document",
        pool_factor: Optional[int] = None,
    ) -> List[np.ndarray]:
        payload: Dict[str, Any] = {
            "texts": texts,
            "input_type": input_type,
            "output_format": "base64",
        }
        if pool_factor is not None:
            payload["pool_factor"] = pool_factor
        data = self._request("POST", "/encode", json=payload)
        out = []
        for b64, shape in zip(data["embeddings_b64"], data["shapes"]):
            arr = np.frombuffer(base64.b64decode(b64), dtype="<f4")
            out.append(arr.reshape(shape).copy())
        return out

    def rerank(
        self,
        query: Union[ArrayLike, str],
        documents: Union[Sequence[ArrayLike], Sequence[str]],
        pool_factor: Optional[int] = None,
    ) -> List[Dict[str, Any]]:
        if isinstance(query, str):
            payload: Dict[str, Any] = {
                "query": query,
                "documents": list(documents),
            }
            if pool_factor is not None:
                payload["pool_factor"] = pool_factor
            return self._request(
                "POST", "/rerank_with_encoding", json=payload
            )["results"]
        payload = {
            **{
                "query_b64": _doc_payload(query)["embeddings_b64"],
                "query_shape": _doc_payload(query)["shape"],
            },
            "documents": [
                _doc_payload(d, self.use_base64, self.wire_dtype)
                for d in documents
            ],
        }
        return self._request("POST", "/rerank", json=payload)["results"]
