"""Async Python SDK (aiohttp) — same surface as NextPlaidClient
(next-plaid python-sdk async_client.py)."""

from __future__ import annotations

import base64
from typing import Any, Dict, List, Optional, Sequence, Union

import aiohttp
import numpy as np

from nextplaid_tpu_torch.client.client import ArrayLike, _doc_payload
from nextplaid_tpu_torch.client.exceptions import (
    ConnectionError_,
    raise_for_status,
)


class AsyncNextPlaidClient:
    def __init__(
        self,
        base_url: str = "http://localhost:8080",
        timeout: float = 300.0,
        use_base64: bool = True,
        wire_dtype: str = "float32",
    ):
        self.base_url = base_url.rstrip("/")
        self.timeout = aiohttp.ClientTimeout(total=timeout)
        self.use_base64 = use_base64
        self.wire_dtype = wire_dtype
        self._session: Optional[aiohttp.ClientSession] = None

    async def __aenter__(self) -> "AsyncNextPlaidClient":
        self._session = aiohttp.ClientSession(timeout=self.timeout)
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def _request(self, method: str, path: str, json: Any = None) -> Any:
        if self._session is None:
            self._session = aiohttp.ClientSession(timeout=self.timeout)
        try:
            async with self._session.request(
                method, self.base_url + path, json=json
            ) as resp:
                if resp.status >= 400:
                    try:
                        message = (await resp.json()).get(
                            "error", await resp.text()
                        )
                    except Exception:
                        message = await resp.text()
                    raise_for_status(resp.status, message)
                return await resp.json()
        except aiohttp.ClientConnectionError as e:
            raise ConnectionError_(f"Cannot reach {self.base_url}: {e}") from e

    # -- surface (mirrors NextPlaidClient) -------------------------------------

    async def health(self) -> Dict[str, Any]:
        return await self._request("GET", "/health")

    async def list_indices(self) -> List[str]:
        return await self._request("GET", "/indices")

    async def get_index(self, name: str) -> Dict[str, Any]:
        return await self._request("GET", f"/indices/{name}")

    async def create_index(
        self, name: str, config: Optional[Dict[str, Any]] = None
    ) -> Dict[str, Any]:
        payload: Dict[str, Any] = {"name": name}
        if config:
            payload["config"] = config
        return await self._request("POST", "/indices", json=payload)

    async def delete_index(self, name: str) -> Dict[str, Any]:
        return await self._request("DELETE", f"/indices/{name}")

    async def add(
        self,
        index_name: str,
        documents: Union[Sequence[ArrayLike], Sequence[str]],
        metadata: Optional[Sequence[Dict[str, Any]]] = None,
        batch_size: int = 64,
        pool_factor: Optional[int] = None,
    ) -> Dict[str, Any]:
        if metadata is not None and len(metadata) != len(documents):
            raise ValueError("metadata length must match documents length")
        total, last = 0, {}
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
                last = await self._request(
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
                last = await self._request(
                    "POST", f"/indices/{index_name}/update", json=payload
                )
            total += len(chunk)
        last["documents_added"] = total
        return last

    async def delete(
        self,
        index_name: str,
        condition: str,
        parameters: Optional[List[Any]] = None,
    ) -> Dict[str, Any]:
        payload: Dict[str, Any] = {"condition": condition}
        if parameters:
            payload["parameters"] = parameters
        return await self._request(
            "DELETE", f"/indices/{index_name}/documents", json=payload
        )

    async def search(
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
        return await self._request("POST", endpoint, json=payload)

    async def update_index_config(
        self, name: str, max_documents: Optional[int] = None
    ) -> Dict[str, Any]:
        return await self._request(
            "PUT",
            f"/indices/{name}/config",
            json={"max_documents": max_documents},
        )

    async def keyword_search(
        self,
        index_name: str,
        queries: List[str],
        top_k: int = 10,
        filter_condition: Optional[str] = None,
        filter_parameters: Optional[List[Any]] = None,
    ) -> Dict[str, Any]:
        return await self.search(
            index_name,
            queries=None,
            top_k=top_k,
            text_query=queries,
            filter_condition=filter_condition,
            filter_parameters=filter_parameters,
        )

    async def get_metadata(self, index_name: str) -> Dict[str, Any]:
        return await self._request("GET", f"/indices/{index_name}/metadata")

    async def get_metadata_count(self, index_name: str) -> Dict[str, Any]:
        return await self._request(
            "GET", f"/indices/{index_name}/metadata/count"
        )

    async def check_metadata(
        self, index_name: str, document_ids: List[int]
    ) -> Dict[str, Any]:
        return await self._request(
            "POST",
            f"/indices/{index_name}/metadata/check",
            json={"document_ids": document_ids},
        )

    async def get_metadata_by_ids(
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
        return await self._request(
            "POST", f"/indices/{index_name}/metadata/get", json=payload
        )

    async def update_metadata(
        self,
        index_name: str,
        condition: str,
        updates: Dict[str, Any],
        parameters: Optional[List[Any]] = None,
    ) -> Dict[str, Any]:
        payload: Dict[str, Any] = {"condition": condition, "updates": updates}
        if parameters:
            payload["parameters"] = parameters
        return await self._request(
            "POST", f"/indices/{index_name}/metadata/update", json=payload
        )

    async def get_distinct_metadata(
        self, index_name: str, column: str
    ) -> List[str]:
        return (
            await self._request(
                "POST",
                f"/indices/{index_name}/metadata/distinct",
                json={"column": column},
            )
        )["values"]

    async def rerank(
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
            return (
                await self._request(
                    "POST", "/rerank_with_encoding", json=payload
                )
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
        return (await self._request("POST", "/rerank", json=payload))["results"]

    async def query_metadata(
        self,
        index_name: str,
        condition: str,
        parameters: Optional[List[Any]] = None,
    ) -> Dict[str, Any]:
        payload: Dict[str, Any] = {"condition": condition}
        if parameters:
            payload["parameters"] = parameters
        return await self._request(
            "POST", f"/indices/{index_name}/metadata/query", json=payload
        )

    async def encode(
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
        data = await self._request("POST", "/encode", json=payload)
        return [
            np.frombuffer(base64.b64decode(b), dtype="<f4")
            .reshape(shape)
            .copy()
            for b, shape in zip(data["embeddings_b64"], data["shapes"])
        ]
