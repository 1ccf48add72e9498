"""REST API server (aiohttp): next-plaid's endpoint surface
(next-plaid-api/src/main.rs:5-32, handlers/*), as `nextplaid_tpu.api.server`
serves it, with the index, the mutations and the encoder on the card.

Endpoints:
  GET  /health, /
  GET  /indices                         list index names
  POST /indices                         create index (writes config.json)
  GET  /indices/{name}                  index info
  DELETE /indices/{name}                delete index
  POST /indices/{name}/documents        add documents (async batched)
  DELETE /indices/{name}/documents      delete by filter (202; batched worker)
  POST /indices/{name}/update           synchronous add (returns when indexed)
  POST /indices/{name}/update_with_encoding
  PUT  /indices/{name}/config
  POST /indices/{name}/search           semantic / keyword / hybrid
  POST /indices/{name}/search/filtered
  POST /indices/{name}/search_with_encoding
  POST /indices/{name}/search/filtered_with_encoding
  GET  /indices/{name}/metadata         all metadata rows
  GET  /indices/{name}/metadata/count
  POST /indices/{name}/metadata/check
  POST /indices/{name}/metadata/query
  POST /indices/{name}/metadata/get
  POST /indices/{name}/metadata/update
  POST /indices/{name}/metadata/distinct
  GET  /swagger-ui                      self-contained interactive docs
  GET  /api-docs/openapi.json
  POST /encode
  POST /rerank
  POST /rerank_with_encoding

Request correlation: an `X-Request-ID` header is honored or generated and
echoed back (next-plaid tracing_middleware.rs:60-90).

Every semantic search of a pinned index goes through a hand-written MaxSim
kernel (bf16 grid in serve_mode "auto", int8 in "grid_only"); on a card the
server builds both kernels before it takes requests.

    python -m nextplaid_tpu_torch.api.server --index-dir ./indices [--device cpu]
"""

from __future__ import annotations

import argparse
import asyncio
import os
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
from aiohttp import web
from pydantic import ValidationError

import torch

from nextplaid_tpu_torch import __version__, filtering
from nextplaid_tpu_torch.api import models as dto
from nextplaid_tpu_torch.api import state as app_state
from nextplaid_tpu_torch.api.state import AppState, search_fn_for
from nextplaid_tpu_torch.filtering import text_search
from nextplaid_tpu_torch.index import SearchParameters
from nextplaid_tpu_torch.index.config import Metadata
from nextplaid_tpu_torch.ops.maxsim import rerank_scores
from nextplaid_tpu_torch.storage.npy import IndexLayout, load_json
from nextplaid_tpu_torch.utils.errors import FilteringError, NextPlaidError

MAX_BODY_BYTES = 100 * 1024 * 1024
DEFAULT_ALPHA = 0.75
MAX_BATCH_TEXTS = int(os.environ.get("MAX_BATCH_TEXTS", "64"))


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


def _state(request: web.Request) -> AppState:
    return request.app["state"]


async def _parse(request: web.Request, model):
    try:
        body = await request.json()
    except Exception:
        raise web.HTTPBadRequest(text='{"error": "invalid JSON body"}',
                                 content_type="application/json")
    try:
        return model(**body)
    except ValidationError as e:
        import json as _json

        raise web.HTTPUnprocessableEntity(
            text=_json.dumps({"error": str(e)}),
            content_type="application/json",
        )


import logging

_log = logging.getLogger("nextplaid_tpu_torch.api")
SLOW_REQUEST_S = 1.0  # next-plaid: >1s search warning (search.rs:256-258)

# next-plaid parity (main.rs:291-505): global concurrency cap + env-gated
# rate limit; health/info/update/encode/delete paths bypass the rate limit.
CONCURRENCY_LIMIT = int(os.environ.get("CONCURRENCY_LIMIT", "100"))
RATE_LIMIT_PER_SECOND = float(os.environ.get("RATE_LIMIT_PER_SECOND", "0"))
RATE_LIMIT_BURST = int(os.environ.get("RATE_LIMIT_BURST", "50"))
_RATE_EXEMPT_PREFIXES = ("/health", "/encode", "/rerank")
_RATE_EXEMPT_SUFFIXES = ("/update", "/update_with_encoding")


class _TokenBucket:
    def __init__(self, rate: float, burst: int):
        self.rate = rate
        self.tokens = float(burst)
        self.burst = float(burst)
        self.last = time.monotonic()

    def try_acquire(self) -> bool:
        now = time.monotonic()
        self.tokens = min(self.burst, self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class _PerClientBuckets:
    """Per-peer token buckets (next-plaid's governor keys per peer IP,
    main.rs:291-505) with idle-bucket eviction so hostile clients can't
    grow the table unboundedly. A single shared bucket would let one
    client starve every other."""

    MAX_IDLE_S = 300.0
    SWEEP_EVERY = 1024

    def __init__(self, rate: float, burst: int):
        self.rate = rate
        self.burst = burst
        self._buckets: Dict[str, _TokenBucket] = {}
        self._ops = 0

    def _peer(self, request: web.Request) -> str:
        # X-Forwarded-For is client-controlled: honoring it from a
        # direct connection lets any client mint fresh buckets per
        # request (bypassing the limit) or drain a victim's bucket by
        # forging their IP. Only trust it when the operator declares a
        # trusted reverse proxy in front (TRUST_PROXY_HEADERS=1).
        if os.environ.get("TRUST_PROXY_HEADERS") == "1":
            fwd = request.headers.get("X-Forwarded-For")
            if fwd:
                return fwd.split(",")[0].strip()
        peername = request.transport.get_extra_info("peername") if request.transport else None
        return peername[0] if peername else "unknown"

    def try_acquire(self, request: web.Request) -> bool:
        key = self._peer(request)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _TokenBucket(self.rate, self.burst)
        self._ops += 1
        if self._ops % self.SWEEP_EVERY == 0:
            now = time.monotonic()
            for k in [
                k
                for k, b in self._buckets.items()
                if now - b.last > self.MAX_IDLE_S
            ]:
                del self._buckets[k]
        return bucket.try_acquire()


@web.middleware
async def limits_middleware(request: web.Request, handler):
    app = request.app
    bucket: Optional[_PerClientBuckets] = app.get("rate_bucket")
    if bucket is not None:
        path = request.path
        exempt = (
            request.method == "GET"
            or path.startswith(_RATE_EXEMPT_PREFIXES)
            or path.endswith(_RATE_EXEMPT_SUFFIXES)
            or (request.method == "DELETE")
        )
        if not exempt and not bucket.try_acquire(request):
            return _json_error(429, "rate limit exceeded")
    sem: asyncio.Semaphore = app["concurrency_sem"]
    async with sem:
        return await handler(request)


# Per-request timeouts (next-plaid main.rs:327-330, 466-469: 30 s for
# health/info, 300 s for the API routes).
HEALTH_TIMEOUT_S = float(os.environ.get("HEALTH_TIMEOUT_SECS", "30"))
REQUEST_TIMEOUT_S = float(os.environ.get("REQUEST_TIMEOUT_SECS", "300"))
_SHORT_TIMEOUT_PREFIXES = ("/health", "/indices",)

_CORS_HEADERS = {
    # Permissive CORS, matching next-plaid's CorsLayer::new()
    # .allow_origin(Any).allow_methods(Any).allow_headers(Any) (main.rs:470).
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "*",
    "Access-Control-Allow-Headers": "*",
}


@web.middleware
async def cors_timeout_middleware(request: web.Request, handler):
    if request.method == "OPTIONS":
        return web.Response(status=204, headers=_CORS_HEADERS)
    timeout = (
        HEALTH_TIMEOUT_S
        if request.method == "GET"
        and request.path.startswith(_SHORT_TIMEOUT_PREFIXES)
        and request.path.count("/") <= 2
        else REQUEST_TIMEOUT_S
    )
    try:
        resp = await asyncio.wait_for(handler(request), timeout=timeout)
    except asyncio.TimeoutError:
        resp = _json_error(408, "request timed out")
    except web.HTTPException as e:
        # 404/405 from routing and handler-raised HTTP errors must carry the
        # CORS headers too (next-plaid's CorsLayer wraps ALL responses) —
        # otherwise cross-origin clients cannot read error responses.
        for k, v in _CORS_HEADERS.items():
            e.headers.setdefault(k, v)
        raise
    for k, v in _CORS_HEADERS.items():
        resp.headers.setdefault(k, v)
    return resp


@web.middleware
async def trace_middleware(request: web.Request, handler):
    trace_id = request.headers.get("X-Request-ID") or str(uuid.uuid4())
    t0 = time.perf_counter()
    try:
        resp = await handler(request)
    except web.HTTPException as e:
        e.headers["X-Request-ID"] = trace_id
        raise
    except FilteringError as e:
        resp = _json_error(400, str(e))
    except (KeyError, FileNotFoundError) as e:
        resp = _json_error(404, f"Index not found: {e}")
    except NextPlaidError as e:
        resp = _json_error(400, str(e))
    except Exception as e:  # pragma: no cover - last resort
        resp = _json_error(500, f"internal error: {e}")
    elapsed = time.perf_counter() - t0
    # Structured per-request event (next-plaid tracing: search.complete /
    # update.batch.complete with stage timings + slow-op warnings).
    level = logging.WARNING if elapsed > SLOW_REQUEST_S else logging.DEBUG
    _log.log(
        level,
        "request.complete method=%s path=%s status=%s elapsed_ms=%.1f "
        "trace_id=%s",
        request.method,
        request.path,
        resp.status,
        elapsed * 1000,
        trace_id,
    )
    resp.headers["X-Request-ID"] = trace_id
    return resp


# ---------------------------------------------------------------------------
# Health / index management
# ---------------------------------------------------------------------------


async def health(request: web.Request) -> web.Response:
    state = _state(request)
    indices = state.list_indices()
    summaries = []
    for name in indices:
        layout = IndexLayout(state.index_path(name))
        try:
            meta = load_json(layout.metadata)
            summaries.append(
                {
                    "name": name,
                    "num_documents": meta.get("num_documents", 0),
                    "num_embeddings": meta.get("num_embeddings", 0),
                    "num_partitions": meta.get("num_partitions", 0),
                }
            )
        except Exception:
            continue
    model_info = None
    if state.encoder is not None:
        cfg = state.encoder.config
        model_info = {
            "name": cfg.model_name,
            "path": "",
            "quantized": False,
            "embedding_dim": cfg.embedding_dim,
            "batch_size": state.encoder.batch_size,
            "num_sessions": 1,
            "query_prefix": cfg.query_prefix,
            "document_prefix": cfg.document_prefix,
            "query_length": cfg.query_length,
            "document_length": cfg.document_length,
            "do_query_expansion": cfg.do_query_expansion,
            "uses_token_type_ids": cfg.uses_token_type_ids,
            "mask_token_id": cfg.mask_token_id,
            "pad_token_id": cfg.pad_token_id,
        }
    try:
        import resource

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        rss = 0
    return web.json_response(
        {
            "status": "ok",
            "version": __version__,
            "loaded_indices": len(indices),
            "index_dir": str(state.index_dir),
            "memory_usage_bytes": rss,
            "indices": summaries,
            "updates": [p.to_dict() for p in state.progress.values()],
            "model": model_info,
        }
    )


async def list_indices(request: web.Request) -> web.Response:
    return web.json_response(_state(request).list_indices())


async def get_index_info(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    layout = IndexLayout(state.index_path(name))
    if not layout.exists():
        if (state.index_path(name) / "config.json").exists():
            # Created but no documents indexed yet.
            cfg = state.get_config(name)
            return web.json_response(
                {
                    "name": name,
                    "num_documents": 0,
                    "num_embeddings": 0,
                    "num_partitions": 0,
                    "avg_doclen": 0.0,
                    "dimension": 0,
                    "has_metadata": False,
                    "metadata_count": None,
                    "max_documents": cfg.max_documents,
                }
            )
        return _json_error(404, f"Index '{name}' not found")

    def read() -> dict:
        meta = Metadata.from_dict(load_json(layout.metadata))
        has_meta = filtering.exists(str(state.index_path(name)))
        return {
            "name": name,
            "num_documents": meta.num_documents,
            "num_embeddings": meta.num_embeddings,
            "num_partitions": meta.num_partitions,
            "avg_doclen": meta.avg_doclen,
            "dimension": meta.embedding_dim,
            "has_metadata": has_meta,
            "metadata_count": filtering.count(str(state.index_path(name)))
            if has_meta
            else None,
            "max_documents": state.get_config(name).max_documents,
        }

    info = read()
    mutation = state.process_lock(name)
    if mutation.locked() and info["metadata_count"] not in (None, info["num_documents"]):
        # Read between a mutation's vector-index write and its metadata
        # write (a delete rewrites metadata.json first): report the state
        # it leaves instead of a pair of counts that never coexist.
        async with mutation:
            info = read()
    return web.json_response(info)


async def create_index(request: web.Request) -> web.Response:
    state = _state(request)
    req = await _parse(request, dto.CreateIndexRequest)
    path = state.index_path(req.name)
    if path.exists():
        return _json_error(409, f"Index '{req.name}' already exists")
    path.mkdir(parents=True)
    stored = dto.IndexConfigStored(
        **{
            k: v
            for k, v in req.config.model_dump().items()
            if v is not None
        }
    )
    state.save_config(req.name, stored)
    return web.json_response(
        {
            "name": req.name,
            "config": stored.model_dump(),
            "message": f"Index '{req.name}' created (awaiting documents)",
        },
        status=201,
    )


async def delete_index(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    deleted = await state.delete_index(name)
    if not deleted:
        return _json_error(404, f"Index '{name}' not found")
    return web.json_response({"deleted": True, "name": name})


async def update_index_config(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    if not state.index_path(name).exists():
        return _json_error(404, f"Index '{name}' not found")
    req = await _parse(request, dto.UpdateIndexConfigRequest)
    cfg = state.get_config(name)
    cfg = cfg.model_copy(update={"max_documents": req.max_documents})
    state.save_config(name, cfg)
    return web.json_response(
        {
            "name": name,
            "config": cfg.model_dump(),
            "message": "Configuration updated",
        }
    )


# ---------------------------------------------------------------------------
# Documents
# ---------------------------------------------------------------------------


def _doc_arrays(documents: List[dto.DocumentEmbeddings]) -> List[np.ndarray]:
    return [d.to_array() for d in documents]


async def add_documents(request: web.Request) -> web.Response:
    """Async batched add: enqueues and waits for the batch to be indexed."""
    state = _state(request)
    name = request.match_info["name"]
    req = await _parse(request, dto.AddDocumentsRequest)
    if req.metadata and len(req.metadata) != len(req.documents):
        return _json_error(
            400, "metadata length must match documents length"
        )
    embeddings = _doc_arrays(req.documents)
    fut = await state.enqueue_add(name, embeddings, req.metadata or None)
    doc_ids = await fut
    layout = IndexLayout(state.index_path(name))
    meta = load_json(layout.metadata)
    return web.json_response(
        {
            "documents_added": len(embeddings),
            "total_documents": meta.get("num_documents", 0),
            "start_id": doc_ids[0] if doc_ids else 0,
        },
        status=202,
    )


async def update_index(request: web.Request) -> web.Response:
    """Synchronous add (next-plaid /update): returns when fully indexed."""
    state = _state(request)
    name = request.match_info["name"]
    req = await _parse(request, dto.UpdateIndexRequest)
    if req.metadata and len(req.metadata) != len(req.documents):
        return _json_error(400, "metadata length must match documents length")
    embeddings = _doc_arrays(req.documents)
    created = not state.index_exists(name)
    fut = await state.enqueue_add(name, embeddings, req.metadata or None)
    await fut
    meta = load_json(IndexLayout(state.index_path(name)).metadata)
    return web.json_response(
        {
            "name": name,
            "created": created,
            "documents_added": len(embeddings),
            "total_documents": meta.get("num_documents", 0),
            "num_embeddings": meta.get("num_embeddings", 0),
            "num_partitions": meta.get("num_partitions", 0),
            "dimension": meta.get("embedding_dim", 0),
        }
    )


async def update_index_with_encoding(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    if state.encoder is None:
        return _json_error(503, "No encoder model loaded")
    req = await _parse(request, dto.UpdateWithEncodingRequest)
    if req.metadata and len(req.metadata) != len(req.documents):
        return _json_error(400, "metadata length must match documents length")
    embeddings = await state.encoder_pool.encode(
        req.documents, "document", req.pool_factor or 1
    )
    created = not state.index_exists(name)
    fut = await state.enqueue_add(name, embeddings, req.metadata or None)
    await fut
    meta = load_json(IndexLayout(state.index_path(name)).metadata)
    return web.json_response(
        {
            "name": name,
            "created": created,
            "documents_added": len(embeddings),
            "total_documents": meta.get("num_documents", 0),
            "num_embeddings": meta.get("num_embeddings", 0),
            "num_partitions": meta.get("num_partitions", 0),
            "dimension": meta.get("embedding_dim", 0),
        }
    )


async def delete_documents(request: web.Request) -> web.Response:
    """Queue a delete-by-condition for batched processing (next-plaid
    documents.rs:1352-1405): conditions coalesce in a per-index worker
    (DELETE_BATCH_MIN_WAIT/MAX_WAIT windows) and are resolved to ids
    sequentially under the index lock. Responds 202 Accepted immediately."""
    state = _state(request)
    name = request.match_info["name"]
    if not state.index_exists(name):
        return _json_error(404, f"Index '{name}' not found")
    req = await _parse(request, dto.DeleteDocumentsRequest)
    if not req.condition:
        return _json_error(400, "Delete condition cannot be empty")
    try:
        state.enqueue_delete(name, req.condition, req.parameters)
    except NextPlaidError as e:
        return _json_error(503, str(e))
    return web.json_response(
        {"status": "queued", "message": "Delete condition queued for batch processing"},
        status=202,
    )


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _search_params(req: dto.SearchParamsRequest) -> SearchParameters:
    kw: Dict[str, Any] = {}
    if req.top_k is not None:
        kw["top_k"] = req.top_k
    if req.n_ivf_probe is not None:
        kw["n_ivf_probe"] = req.n_ivf_probe
    if req.n_full_scores is not None:
        kw["n_full_scores"] = req.n_full_scores
    if req.centroid_score_threshold is not None:
        kw["centroid_score_threshold"] = req.centroid_score_threshold
    if req.profile is not None:
        if req.profile not in SearchParameters.PRESETS:
            from nextplaid_tpu_torch.utils.errors import SearchError

            raise SearchError(  # -> HTTP 400 via trace middleware
                f"unknown profile {req.profile!r}: expected one of "
                f"{sorted(SearchParameters.PRESETS)}"
            )
        kw.setdefault(
            "target_recall", SearchParameters.PRESETS[req.profile]
        )
    if req.target_recall is not None:
        kw["target_recall"] = req.target_recall
    return SearchParameters(**kw)


def _attach_metadata(
    path: str, results: List[dict]
) -> None:
    """Per-result metadata attach (next-plaid search.rs:81, 377)."""
    if not filtering.exists(path):
        for r in results:
            r["metadata"] = [None] * len(r["document_ids"])
        return
    for r in results:
        rows = filtering.get(path, subset=r["document_ids"])
        by_id = {row["_subset_"]: row for row in rows}
        r["metadata"] = [by_id.get(i) for i in r["document_ids"]]


_search_fn_for = search_fn_for


async def _run_search(
    state: AppState,
    name: str,
    query_arrays: Optional[List[np.ndarray]],
    params: SearchParameters,
    subset: Optional[List[int]],
    text_query: Optional[List[str]],
    alpha: Optional[float],
    fusion: Optional[str],
) -> web.Response:
    path = str(state.index_path(name))
    loop = asyncio.get_running_loop()
    alpha = DEFAULT_ALPHA if alpha is None else alpha
    fusion = fusion or "relative_score"
    if fusion not in ("relative_score", "rrf"):
        return _json_error(400, f"Unknown fusion '{fusion}'")

    semantic = None
    if query_arrays:
        index = await state.get_index(name)
        hybrid = bool(text_query)
        fetch_k = params.top_k * 3 if hybrid else params.top_k
        sem_params = (
            SearchParameters(**{**params.to_dict(), "top_k": fetch_k})
            if hybrid
            else params
        )
        if subset is None and app_state.coalesce_eligible(len(query_arrays)):
            # Coalesced path: merge with concurrent requests that share
            # (index, params) into one device dispatch (state.py —
            # default "auto" coalesces only small requests; the measured
            # rationale is on _SEARCH_COALESCE_MODE).
            semantic = await state.enqueue_search(
                name, query_arrays, sem_params
            )
        else:
            search_fn = _search_fn_for(index)
            semantic = await loop.run_in_executor(
                None,
                lambda: search_fn(
                    index, query_arrays, sem_params, subset=subset
                ),
            )

    keyword = None
    if text_query:
        fetch_k = params.top_k * 3 if query_arrays else params.top_k

        def _kw():
            out = []
            for q in text_query:
                sanitized = text_search.sanitize_fts5_query(q)
                if subset is not None:
                    ids, scores = text_search.search_filtered(
                        path, sanitized, fetch_k, subset
                    )
                else:
                    ids, scores = text_search.search(path, sanitized, fetch_k)
                out.append((ids, scores))
            return out

        keyword = await loop.run_in_executor(None, _kw)

    results = []
    if semantic is not None and keyword is not None:
        if len(keyword) not in (1, len(semantic)):
            return _json_error(
                400, "text_query length must be 1 or match queries length"
            )
        for qi, sem in enumerate(semantic):
            kw_ids, kw_scores = keyword[qi if len(keyword) > 1 else 0]
            if fusion == "rrf":
                ids, scores = text_search.fuse_rrf(
                    sem.passage_ids, kw_ids, alpha, params.top_k
                )
            else:
                ids, scores = text_search.fuse_relative_score(
                    sem.passage_ids, sem.scores, kw_ids, kw_scores,
                    alpha, params.top_k,
                )
            results.append(
                {"query_id": qi, "document_ids": ids, "scores": scores}
            )
    elif semantic is not None:
        results = [
            {
                "query_id": qi,
                "document_ids": list(r.passage_ids),
                "scores": [float(s) for s in r.scores],
            }
            for qi, r in enumerate(semantic)
        ]
    elif keyword is not None:
        results = [
            {
                "query_id": qi,
                "document_ids": ids[: params.top_k],
                "scores": scores[: params.top_k],
            }
            for qi, (ids, scores) in enumerate(keyword)
        ]
    else:
        return _json_error(400, "Provide queries and/or text_query")

    await loop.run_in_executor(None, _attach_metadata, path, results)
    return web.json_response(
        {"results": results, "num_queries": len(results)}
    )


async def search(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    if not state.index_exists(name):
        return _json_error(404, f"Index '{name}' not found")
    req = await _parse(request, dto.SearchRequest)
    subset = req.subset
    if req.filter_condition:
        path = str(state.index_path(name))
        subset = filtering.where_condition(
            path, req.filter_condition, req.filter_parameters
        )
    queries = [q.to_array() for q in req.queries] if req.queries else None
    return await _run_search(
        state, name, queries, _search_params(req.params), subset,
        req.text_query, req.alpha, req.fusion,
    )


async def search_filtered(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    if not state.index_exists(name):
        return _json_error(404, f"Index '{name}' not found")
    req = await _parse(request, dto.FilteredSearchRequest)
    path = str(state.index_path(name))
    subset = filtering.where_condition(
        path, req.filter_condition, req.filter_parameters
    )
    queries = [q.to_array() for q in req.queries]
    return await _run_search(
        state, name, queries, _search_params(req.params), subset,
        None, None, None,
    )


async def search_with_encoding(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    if state.encoder is None:
        return _json_error(503, "No encoder model loaded")
    if not state.index_exists(name):
        return _json_error(404, f"Index '{name}' not found")
    req = await _parse(request, dto.SearchWithEncodingRequest)
    queries = await state.encoder_pool.encode(req.queries, "query")
    return await _run_search(
        state, name, queries, _search_params(req.params), req.subset,
        req.text_query, req.alpha, req.fusion,
    )


async def search_filtered_with_encoding(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    if state.encoder is None:
        return _json_error(503, "No encoder model loaded")
    if not state.index_exists(name):
        return _json_error(404, f"Index '{name}' not found")
    req = await _parse(request, dto.FilteredSearchWithEncodingRequest)
    path = str(state.index_path(name))
    subset = filtering.where_condition(
        path, req.filter_condition, req.filter_parameters
    )
    queries = await state.encoder_pool.encode(req.queries, "query")
    return await _run_search(
        state, name, queries, _search_params(req.params), subset,
        req.text_query, req.alpha, req.fusion,
    )


# ---------------------------------------------------------------------------
# Metadata
# ---------------------------------------------------------------------------


async def get_all_metadata(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    path = str(state.index_path(name))
    loop = asyncio.get_running_loop()
    rows = await loop.run_in_executor(None, filtering.get, path)
    return web.json_response({"metadata": rows, "count": len(rows)})


async def get_metadata_count(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    path = str(state.index_path(name))
    count = filtering.count(path)
    return web.json_response(
        {"count": count, "has_metadata": filtering.exists(path)}
    )


async def check_metadata(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    req = await _parse(request, dto.CheckMetadataRequest)
    path = str(state.index_path(name))
    loop = asyncio.get_running_loop()
    rows = await loop.run_in_executor(
        None, lambda: filtering.get(path, subset=req.document_ids)
    )
    existing = {r["_subset_"] for r in rows}
    existing_ids = [i for i in req.document_ids if i in existing]
    missing_ids = [i for i in req.document_ids if i not in existing]
    return web.json_response(
        {
            "existing_ids": existing_ids,
            "missing_ids": missing_ids,
            "existing_count": len(existing_ids),
            "missing_count": len(missing_ids),
        }
    )


async def query_metadata(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    req = await _parse(request, dto.QueryMetadataRequest)
    path = str(state.index_path(name))
    loop = asyncio.get_running_loop()
    ids = await loop.run_in_executor(
        None,
        lambda: filtering.where_condition(path, req.condition, req.parameters),
    )
    return web.json_response({"document_ids": ids, "count": len(ids)})


async def get_metadata(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    req = await _parse(request, dto.GetMetadataRequest)
    path = str(state.index_path(name))
    loop = asyncio.get_running_loop()
    rows = await loop.run_in_executor(
        None,
        lambda: filtering.get(
            path,
            condition=req.condition,
            parameters=req.parameters,
            subset=req.document_ids,
        ),
    )
    if req.limit is not None:
        rows = rows[: req.limit]
    return web.json_response({"metadata": rows, "count": len(rows)})


async def update_metadata(request: web.Request) -> web.Response:
    state = _state(request)
    name = request.match_info["name"]
    req = await _parse(request, dto.UpdateMetadataRequest)
    path = str(state.index_path(name))
    loop = asyncio.get_running_loop()
    updated = await loop.run_in_executor(
        None,
        lambda: filtering.update_where(
            path, req.condition, req.parameters, req.updates
        ),
    )
    return web.json_response({"updated": updated})


# ---------------------------------------------------------------------------
# Encode / rerank
# ---------------------------------------------------------------------------


async def encode(request: web.Request) -> web.Response:
    state = _state(request)
    if state.encoder is None:
        return _json_error(503, "No encoder model loaded")
    req = await _parse(request, dto.EncodeRequest)
    if len(req.texts) > MAX_BATCH_TEXTS:
        return _json_error(
            400, f"Too many texts; max {MAX_BATCH_TEXTS} per request"
        )
    arrays = await state.encoder_pool.encode(
        req.texts, req.input_type, req.pool_factor or 1
    )
    if req.output_format == "base64":
        b64s, shapes = [], []
        for a in arrays:
            b, s = dto.encode_embeddings_b64(a)
            b64s.append(b)
            shapes.append(list(s))
        return web.json_response(
            {
                "embeddings": None,
                "embeddings_b64": b64s,
                "shapes": shapes,
                "num_texts": len(arrays),
            }
        )
    return web.json_response(
        {
            "embeddings": [a.tolist() for a in arrays],
            "embeddings_b64": None,
            "shapes": None,
            "num_texts": len(arrays),
        }
    )


def _rerank_arrays(
    query: np.ndarray, docs: List[np.ndarray], device: torch.device
) -> List[dict]:
    """Exact f32 MaxSim of each doc against the query on `device`, best
    first (`ops.maxsim.rerank_scores`: one batch, one readback)."""
    scores = rerank_scores(query, docs, device).tolist()
    order = sorted(range(len(docs)), key=lambda i: -scores[i])
    return [{"index": i, "score": scores[i]} for i in order]


async def rerank(request: web.Request) -> web.Response:
    req = await _parse(request, dto.RerankRequest)
    query = req.query_array()
    docs = [d.to_array() for d in req.documents]
    loop = asyncio.get_running_loop()
    results = await loop.run_in_executor(
        None, _rerank_arrays, query, docs, _state(request).device
    )
    return web.json_response({"results": results})


async def rerank_with_encoding(request: web.Request) -> web.Response:
    state = _state(request)
    if state.encoder is None:
        return _json_error(503, "No encoder model loaded")
    req = await _parse(request, dto.RerankWithEncodingRequest)
    q = (await state.encoder_pool.encode([req.query], "query"))[0]
    d = await state.encoder_pool.encode(
        req.documents, "document", req.pool_factor or 1
    )
    loop = asyncio.get_running_loop()
    results = await loop.run_in_executor(None, _rerank_arrays, q, d, state.device)
    return web.json_response({"results": results})




async def openapi_spec(request: web.Request) -> web.Response:
    """Machine-readable API description (next-plaid serves utoipa's spec at
    the same path, main.rs swagger-ui)."""
    v = __version__

    def op(summary, body=None):
        out = {"summary": summary, "responses": {"200": {"description": "OK"}}}
        if body:
            out["requestBody"] = {
                "content": {"application/json": {"schema": {"$ref": f"#/components/schemas/{body}"}}}
            }
        return out

    schemas = {
        name: {"type": "object"}
        for name in (
            "CreateIndexRequest", "AddDocumentsRequest", "UpdateIndexRequest",
            "UpdateWithEncodingRequest", "DeleteDocumentsRequest",
            "SearchRequest", "FilteredSearchRequest",
            "SearchWithEncodingRequest", "FilteredSearchWithEncodingRequest",
            "CheckMetadataRequest", "GetMetadataRequest",
            "QueryMetadataRequest", "UpdateMetadataRequest",
            "UpdateIndexConfigRequest", "EncodeRequest", "RerankRequest",
            "RerankWithEncodingRequest",
        )
    }
    spec = {
        "openapi": "3.0.3",
        "info": {"title": "nextplaid_tpu_torch API", "version": v},
        "paths": {
            "/health": {"get": op("Server health + index summaries")},
            "/indices": {
                "get": op("List index names"),
                "post": op("Create an index", "CreateIndexRequest"),
            },
            "/indices/{name}": {
                "get": op("Index info"),
                "delete": op("Delete the index"),
            },
            "/indices/{name}/config": {
                "put": op("Update index config", "UpdateIndexConfigRequest")
            },
            "/indices/{name}/documents": {
                "post": op("Add documents (async batched)", "AddDocumentsRequest"),
                "delete": op(
                    "Queue delete-by-filter (202; batched worker)",
                    "DeleteDocumentsRequest",
                ),
            },
            "/indices/{name}/update": {
                "post": op("Add documents (synchronous)", "UpdateIndexRequest")
            },
            "/indices/{name}/update_with_encoding": {
                "post": op("Add text documents (server-side encoding)", "UpdateWithEncodingRequest")
            },
            "/indices/{name}/search": {
                "post": op("Semantic / keyword / hybrid search", "SearchRequest")
            },
            "/indices/{name}/search/filtered": {
                "post": op("Search with metadata filter", "FilteredSearchRequest")
            },
            "/indices/{name}/search_with_encoding": {
                "post": op("Search text queries (server-side encoding)", "SearchWithEncodingRequest")
            },
            "/indices/{name}/search/filtered_with_encoding": {
                "post": op("Filtered search with encoding", "FilteredSearchWithEncodingRequest")
            },
            "/indices/{name}/metadata": {"get": op("All metadata rows")},
            "/indices/{name}/metadata/count": {"get": op("Metadata row count")},
            "/indices/{name}/metadata/check": {
                "post": op("Check which doc ids have metadata", "CheckMetadataRequest")
            },
            "/indices/{name}/metadata/query": {
                "post": op("Doc ids matching a condition", "QueryMetadataRequest")
            },
            "/indices/{name}/metadata/get": {
                "post": op("Metadata by ids or condition", "GetMetadataRequest")
            },
            "/indices/{name}/metadata/update": {
                "post": op("Update metadata columns", "UpdateMetadataRequest")
            },
            "/indices/{name}/metadata/distinct": {
                "post": op("Distinct string values of a column")
            },
            "/encode": {"post": op("Encode texts to embeddings", "EncodeRequest")},
            "/rerank": {"post": op("Exact MaxSim rerank", "RerankRequest")},
            "/rerank_with_encoding": {
                "post": op("Rerank with server-side encoding", "RerankWithEncodingRequest")
            },
        },
        "components": {"schemas": schemas},
    }
    return web.json_response(spec)


_SWAGGER_HTML = """<!DOCTYPE html>
<html>
<head>
  <meta charset="utf-8">
  <title>nextplaid_tpu_torch API</title>
  <style>
    body { font-family: sans-serif; margin: 2rem; max-width: 60rem; }
    .op { border: 1px solid #ccc; border-radius: 6px; margin: .5rem 0;
          padding: .5rem .8rem; }
    .m { display: inline-block; min-width: 4.5rem; font-weight: bold; }
    .get { color: #1a7f37; } .post { color: #0550ae; }
    .put { color: #9a6700; } .delete { color: #cf222e; }
    code { background: #f5f5f5; padding: 0 .3rem; }
    pre { background: #f8f8f8; padding: .5rem; overflow-x: auto; }
  </style>
</head>
<body>
  <h1>nextplaid_tpu_torch API</h1>
  <p>Interactive spec rendered from
     <a href="/api-docs/openapi.json">/api-docs/openapi.json</a>
     (self-contained; no CDN assets, so it renders offline).</p>
  <div id="ops">loading…</div>
  <script>
    fetch('/api-docs/openapi.json').then(r => r.json()).then(spec => {
      const el = document.getElementById('ops');
      el.innerHTML = '';
      for (const [path, methods] of Object.entries(spec.paths)) {
        for (const [method, op] of Object.entries(methods)) {
          const div = document.createElement('div');
          div.className = 'op';
          let body = '';
          const ref = op.requestBody?.content?.['application/json']
            ?.schema?.['$ref'];
          if (ref) {
            const name = ref.split('/').pop();
            const schema = spec.components.schemas[name];
            body = '<pre>' + name + ' = ' +
              JSON.stringify(schema, null, 1) + '</pre>';
          }
          div.innerHTML = '<span class="m ' + method + '">' +
            method.toUpperCase() + '</span> <code>' + path + '</code> — ' +
            (op.summary || '') + body;
          el.appendChild(div);
        }
      }
    });
  </script>
</body>
</html>"""


async def swagger_ui(request: web.Request) -> web.Response:
    """Interactive API docs (next-plaid serves swagger-ui at /swagger-ui,
    main.rs:426; this build renders the spec with a self-contained page so
    that it needs no CDN assets)."""
    return web.Response(text=_SWAGGER_HTML, content_type="text/html")


async def get_distinct_metadata(request: web.Request) -> web.Response:
    """Distinct string values of a metadata column
    (engine filtering.get_distinct_strings, next-plaid filtering.rs:2078)."""
    state = _state(request)
    name = request.match_info["name"]
    if not state.index_exists(name):
        return _json_error(404, f"Index '{name}' not found")
    body = await request.json()
    column = body.get("column")
    if not column:
        return _json_error(400, "missing 'column'")
    path = str(state.index_path(name))
    loop = asyncio.get_running_loop()
    values = await loop.run_in_executor(
        None, filtering.get_distinct_strings, path, column
    )
    return web.json_response({"column": column, "values": values})


# ---------------------------------------------------------------------------
# App assembly
# ---------------------------------------------------------------------------


def build_app(index_dir: str, encoder=None, device=None) -> web.Application:
    """The server's application over the indexes in `index_dir`, on `device`
    ("cuda" when None, raising without a card)."""
    app = web.Application(
        middlewares=[
            cors_timeout_middleware,
            trace_middleware,
            limits_middleware,
        ],
        client_max_size=MAX_BODY_BYTES,
    )
    app["state"] = state = AppState(index_dir, encoder=encoder, device=device)
    app["concurrency_sem"] = asyncio.Semaphore(CONCURRENCY_LIMIT)
    app["rate_bucket"] = (
        _PerClientBuckets(RATE_LIMIT_PER_SECOND, RATE_LIMIT_BURST)
        if RATE_LIMIT_PER_SECOND > 0
        else None
    )
    r = app.router
    r.add_get("/", health)
    r.add_get("/api-docs/openapi.json", openapi_spec)
    r.add_get("/swagger-ui", swagger_ui)
    r.add_get("/swagger-ui/", swagger_ui)
    r.add_get("/health", health)
    r.add_get("/indices", list_indices)
    r.add_post("/indices", create_index)
    r.add_get("/indices/{name}", get_index_info)
    r.add_delete("/indices/{name}", delete_index)
    r.add_put("/indices/{name}/config", update_index_config)
    r.add_post("/indices/{name}/documents", add_documents)
    r.add_delete("/indices/{name}/documents", delete_documents)
    r.add_post("/indices/{name}/update", update_index)
    r.add_post(
        "/indices/{name}/update_with_encoding", update_index_with_encoding
    )
    r.add_post("/indices/{name}/search", search)
    r.add_post("/indices/{name}/search/filtered", search_filtered)
    r.add_post("/indices/{name}/search_with_encoding", search_with_encoding)
    r.add_post(
        "/indices/{name}/search/filtered_with_encoding",
        search_filtered_with_encoding,
    )
    r.add_get("/indices/{name}/metadata", get_all_metadata)
    r.add_get("/indices/{name}/metadata/count", get_metadata_count)
    r.add_post("/indices/{name}/metadata/check", check_metadata)
    r.add_post("/indices/{name}/metadata/query", query_metadata)
    r.add_post("/indices/{name}/metadata/get", get_metadata)
    r.add_post("/indices/{name}/metadata/update", update_metadata)
    r.add_post("/indices/{name}/metadata/distinct", get_distinct_metadata)
    r.add_post("/encode", encode)
    r.add_post("/rerank", rerank)
    r.add_post("/rerank_with_encoding", rerank_with_encoding)

    if state.device.type == "cuda":
        # Build and load the served kernels (both MaxSim kernels and the
        # staged route's union grid) before the first request: a cold build
        # is tens of seconds of nvcc, which would otherwise land inside the
        # first searches.
        async def _load_kernels(app):
            from nextplaid_tpu_torch.ops import maxsim_kernel

            t0 = time.perf_counter()
            await asyncio.get_running_loop().run_in_executor(
                None, maxsim_kernel.load_kernels
            )
            _log.info("MaxSim kernels loaded in %.1fs", time.perf_counter() - t0)

        app.on_startup.append(_load_kernels)

    # aiohttp keeps every Application it has built middleware for in a
    # module-level cache (web_app._cached_build_middleware, an lru_cache of
    # 1,024 entries), so this app and its state outlive the server: release
    # the state's indexes and encoder when the server stops.
    async def _close_state(app):
        await app["state"].close()

    app.on_cleanup.append(_close_state)

    if encoder is not None and os.environ.get("ENCODE_WARM") == "1":
        # Run every encode batch bucket once before serving traffic, so
        # the first forward of each shape does not pay the card's one-time
        # costs inside a request (encode_pool.warm docstring).
        async def _warm_encode(app):
            state: AppState = app["state"]
            warm_s = await asyncio.get_running_loop().run_in_executor(
                None, state.encoder_pool.warm
            )
            _log.info("encode warm-up done in %.1fs", warm_s)

        app.on_startup.append(_warm_encode)
    return app


def build_parser() -> argparse.ArgumentParser:
    """The server's command line (what the CUDA image's ENTRYPOINT and the
    compose `command` pass)."""
    parser = argparse.ArgumentParser(description="nextplaid_tpu_torch API server")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--index-dir", default="./indices")
    parser.add_argument("--model", default=None, help="encoder model dir")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--query-length", type=int, default=None)
    parser.add_argument("--document-length", type=int, default=None)
    parser.add_argument(
        "--warm-encode", action="store_true",
        help="run every encode batch bucket once at startup "
        "(equivalent to ENCODE_WARM=1; see EncoderPool.warm)",
    )
    parser.add_argument(
        "--device", default=None,
        help="torch device of the indexes and the encoder (default cuda, "
        "which fails without a card; cpu runs the kernels' plain versions)",
    )
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from nextplaid_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.warm_encode:
        os.environ["ENCODE_WARM"] = "1"

    encoder = None
    if args.model:
        from nextplaid_tpu_torch.encoder import Colbert

        encoder = Colbert(
            args.model,
            batch_size=args.batch_size,
            query_length=args.query_length,
            document_length=args.document_length,
            device=device,
        )
    # run_app turns SIGINT and SIGTERM into a graceful shutdown: in-flight
    # requests finish, background workers are cancelled, exit status 0.
    web.run_app(
        build_app(args.index_dir, encoder=encoder, device=device),
        host=args.host,
        port=args.port,
    )


if __name__ == "__main__":
    main()
