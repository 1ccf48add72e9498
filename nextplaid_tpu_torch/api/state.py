"""Server state: index registry with atomic swap, batched ingest workers,
update-progress tracking, per-index persisted config.

Rebuild of next-plaid's AppState + documents batch worker
(next-plaid-api/src/{state.rs,handlers/documents.rs}), as
`nextplaid_tpu.api.state` has it, on the card:

  - readers never block: searches use whatever `DeviceIndex` snapshot is
    registered; writers build the new index then atomically swap the
    pointer (next-plaid state.rs:24-47 ArcSwap semantics — a dict assignment under a
    lock in Python, which readers access without the lock);
  - per-index ingest queue: adds are coalesced into batches of up to
    `MAX_BATCH_DOCUMENTS` docs or `BATCH_WINDOW_MS` of arrivals
    (documents.rs:323-380), then processed in a thread-pool executor: index
    update -> metadata -> FTS -> eviction -> reload + swap;
  - `repair_index_db_sync`: if the vector index and metadata.db disagree on
    the doc count at batch start, the excess rows are healed
    (documents.rs:110);
  - update-progress registry surfaced in /health (state.rs:64-117), entries
    pruned after 10 minutes.

Env knobs (same names as next-plaid's, main.rs/documents.rs):
MAX_BATCH_DOCUMENTS (300), MAX_QUEUED_TASKS_PER_INDEX (10).

Device work (loads, pins, searches, the encoder, update's encode and the
in-place appends) runs on `AppState.device`, "cuda" unless the caller asks
for the CPU. Executor threads keep PyTorch's default stream, so a search, an
append and an encode queue on one stream in the order they are issued: an
older index snapshot reads the grid rows its own count covers while an
append writes rows past them.
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from nextplaid_tpu_torch import filtering
from nextplaid_tpu_torch.api.models import IndexConfigStored
from nextplaid_tpu_torch.filtering import text_search
from nextplaid_tpu_torch.index import DeviceIndex, IndexConfig
from nextplaid_tpu_torch.index.container import pin_settings
from nextplaid_tpu_torch.index.delete import delete_with_options
from nextplaid_tpu_torch.index.update import (
    UpdateConfig,
    update_or_create_with_metadata,
)
from nextplaid_tpu_torch.parallel import (
    HostIndexData,
    ShardedGridIndex,
    ShardedIndex,
    make_mesh,
    search_batch_sharded,
    search_batch_sharded_grid,
)
from nextplaid_tpu_torch.storage.npy import IndexLayout, atomic_write_json, load_json
from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device
from nextplaid_tpu_torch.utils.errors import NextPlaidError

logger = logging.getLogger(__name__)

MAX_BATCH_DOCUMENTS = int(os.environ.get("MAX_BATCH_DOCUMENTS", "300"))
# Cross-request search coalescing: concurrent unfiltered searches that share
# an (index, SearchParameters) key are merged into single device dispatches —
# the query analogue of the ingest worker's add coalescing (documents.rs:
# 323-380 is next-plaid's shape for adds; next-plaid never coalesces searches
# because its CPU engine gains nothing from batch). The policy and its
# defaults are the JAX package's, which measured two regimes that disagree:
# many concurrent 64-query clients did better dispatching per request, many
# concurrent single-query clients (next-plaid's README protocol) did better
# coalesced. "auto" routes by request size: requests with <=
# COALESCE_SMALL_QUERIES queries coalesce, bigger ones dispatch directly.
# "1"/"0" force. The port's own service numbers on the card are in PERF.md.
_SEARCH_COALESCE_MODE = os.environ.get("NEXT_PLAID_SEARCH_COALESCE", "auto")
COALESCE_SMALL_QUERIES = int(
    os.environ.get("NEXT_PLAID_COALESCE_SMALL_QUERIES", "8")
)


def coalesce_eligible(n_queries: int) -> bool:
    if _SEARCH_COALESCE_MODE == "1":
        return True
    if _SEARCH_COALESCE_MODE == "auto":
        return n_queries <= COALESCE_SMALL_QUERIES
    return False


MAX_COALESCED_QUERIES = int(
    os.environ.get("NEXT_PLAID_MAX_COALESCED_QUERIES", "512")
)
# Dispatch window depth: keep several coalesced batches in flight so the
# host marshalling of later batches overlaps device compute of earlier ones
# (the JAX package's default of 6, env-tunable).
SEARCH_DISPATCH_DEPTH = int(
    os.environ.get("NEXT_PLAID_SEARCH_DISPATCH_DEPTH", "6")
)
MAX_QUEUED_TASKS_PER_INDEX = int(
    os.environ.get("MAX_QUEUED_TASKS_PER_INDEX", "10")
)
BATCH_WINDOW_MS = 100
PROGRESS_TTL_S = 600.0
# Delete batching (next-plaid documents.rs:661-703, same env names/defaults):
# wait at least MIN after the first condition, keep collecting until MAX or
# the condition cap, then resolve ids per condition sequentially (id
# shifting) under the per-index lock.
DELETE_BATCH_MIN_WAIT_MS = int(os.environ.get("DELETE_BATCH_MIN_WAIT", "500"))
DELETE_BATCH_MAX_WAIT_MS = int(os.environ.get("DELETE_BATCH_MAX_WAIT", "2000"))
MAX_DELETE_BATCH_CONDITIONS = int(
    os.environ.get("MAX_DELETE_BATCH_CONDITIONS", "200")
)
BATCH_CHANNEL_SIZE = int(os.environ.get("BATCH_CHANNEL_SIZE", "100"))
# Append headroom for served indexes: capacity reserved at load so
# device appends (append_batch) don't immediately pay a capacity-growth
# rebuild. 1.5 = 50% headroom.
SERVE_CAPACITY_FACTOR = float(
    os.environ.get("NEXT_PLAID_SERVE_CAPACITY_FACTOR", "1.5")
)


@dataclass
class UpdateProgress:
    index: str
    status: str = "queued"  # queued | running | completed | failed
    stage: str = "queued"
    queued_documents: Optional[int] = None
    processed_documents: Optional[int] = None
    started_at: float = field(default_factory=time.time)
    updated_at: float = field(default_factory=time.time)
    message: Optional[str] = None
    error: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        iso = lambda t: time.strftime(  # noqa: E731
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(t)
        )
        return {
            "index": self.index,
            "status": self.status,
            "stage": self.stage,
            "queued_documents": self.queued_documents,
            "processed_documents": self.processed_documents,
            "started_at": iso(self.started_at),
            "updated_at": iso(self.updated_at),
            "elapsed_ms": int((self.updated_at - self.started_at) * 1000),
            "message": self.message,
            "error": self.error,
        }


@dataclass
class _PendingAdd:
    embeddings: List[np.ndarray]
    metadata: Optional[List[dict]]
    future: asyncio.Future


@dataclass
class _PendingDelete:
    condition: str
    parameters: List[Any]


@dataclass
class _PendingSearch:
    queries: List[np.ndarray]
    params: Any  # SearchParameters
    future: asyncio.Future


def search_fn_for(index):
    """Dispatch on the served index type: DeviceIndex (serve_mode auto or
    grid_only), ShardedIndex / ShardedGridIndex (serve_mode sharded /
    sharded_grid); all share the (index, queries, params, subset)
    signature."""
    from nextplaid_tpu_torch.index import search_batch

    if isinstance(index, ShardedGridIndex):
        return search_batch_sharded_grid
    if isinstance(index, ShardedIndex):
        return search_batch_sharded
    return search_batch


def _grid_only_dtype(mode: str) -> str:
    """The pinned grid's dtype of the exact-only serve modes (grid_only,
    sharded_grid): NEXT_PLAID_PIN_DTYPE, int8 by default. "auto" has no
    meaning there (there is no unpinned fallback to fall to), so any value
    but bf16 or int8 is int8, said out loud instead of silently quantizing."""
    _, dtype = pin_settings(default_dtype="int8")
    if dtype not in ("bf16", "int8"):
        logger.warning(
            "NEXT_PLAID_PIN_DTYPE=%r is not valid for "
            "serve_mode=%s (bf16|int8); using int8 — "
            "exact scores are int8-quantized",
            dtype,
            mode,
        )
        dtype = "int8"
    return dtype


class AppState:
    def __init__(self, index_dir: str, encoder=None, device: DeviceLike = None):
        # Where indexes load, pin, search and append: "cuda" when None
        # (raising without a card).
        self.device = resolve_device(device)
        self.index_dir = Path(index_dir)
        self.index_dir.mkdir(parents=True, exist_ok=True)
        self.encoder = encoder  # Optional Colbert
        # Worker pool over encoder replicas (next-plaid encode.rs:92-255);
        # size = min(MODEL_POOL_SIZE, visible cards). Lazy start: workers
        # bind to the running event loop on first encode.
        if encoder is not None:
            from nextplaid_tpu_torch.api.encode_pool import EncoderPool

            self.encoder_pool = EncoderPool(encoder)
        else:
            self.encoder_pool = None
        self.started_at = time.time()
        # name -> DeviceIndex; plain dict assignment is atomic in CPython, so
        # readers take snapshots lock-free (the ArcSwap pattern).
        self._indices: Dict[str, DeviceIndex] = {}
        self._load_locks: Dict[str, asyncio.Lock] = {}
        self._ingest_queues: Dict[str, asyncio.Queue] = {}
        self._ingest_workers: Dict[str, asyncio.Task] = {}
        self._worker_locks: Dict[str, asyncio.Lock] = {}
        self._process_locks: Dict[str, asyncio.Lock] = {}
        self._queue_sems: Dict[str, asyncio.Semaphore] = {}
        self._delete_queues: Dict[str, asyncio.Queue] = {}
        self._delete_workers: Dict[str, asyncio.Task] = {}
        self._search_queues: Dict[Any, asyncio.Queue] = {}
        self._search_workers: Dict[Any, asyncio.Task] = {}
        self._config_cache: Dict[str, IndexConfigStored] = {}
        self.progress: Dict[str, UpdateProgress] = {}

    # -- paths / existence ----------------------------------------------------

    def index_path(self, name: str) -> Path:
        if not name or "/" in name or name.startswith("."):
            raise NextPlaidError(f"Invalid index name '{name}'")
        return self.index_dir / name

    def index_exists(self, name: str) -> bool:
        return IndexLayout(self.index_path(name)).exists()

    def list_indices(self) -> List[str]:
        """Built indices plus created-but-empty ones (config.json only)."""
        out = []
        for p in sorted(self.index_dir.iterdir()) if self.index_dir.exists() else []:
            if p.is_dir() and (
                IndexLayout(p).exists() or (p / "config.json").exists()
            ):
                out.append(p.name)
        return out

    # -- config ---------------------------------------------------------------

    def get_config(self, name: str) -> IndexConfigStored:
        if name in self._config_cache:
            return self._config_cache[name]
        path = self.index_path(name) / "config.json"
        if path.exists():
            cfg = IndexConfigStored(**load_json(path))
        else:
            cfg = IndexConfigStored()
        self._config_cache[name] = cfg
        return cfg

    def save_config(self, name: str, cfg: IndexConfigStored) -> None:
        atomic_write_json(
            self.index_path(name) / "config.json", cfg.model_dump()
        )
        self._config_cache[name] = cfg

    # -- registry -------------------------------------------------------------

    async def get_index(self, name: str) -> DeviceIndex:
        index = self._indices.get(name)
        if index is not None:
            return index
        lock = self._load_locks.setdefault(name, asyncio.Lock())
        async with lock:
            index = self._indices.get(name)
            if index is not None:
                return index
            if not self.index_exists(name):
                raise KeyError(name)
            loop = asyncio.get_running_loop()
            index = await loop.run_in_executor(
                None, self._load_index_sync, name
            )
            self._indices[name] = index
            return index

    def _load_index_sync(self, name: str) -> DeviceIndex:
        """Serving load: full index + pinned grid by default; exact-only
        grid streaming when serve_mode (config.json or
        NEXT_PLAID_SERVE_MODE) is "grid_only"; doc-range shards over the
        mesh when it is "sharded" (compressed) or "sharded_grid"."""
        mode = os.environ.get(
            "NEXT_PLAID_SERVE_MODE", self.get_config(name).serve_mode
        )
        if mode not in ("auto", "grid_only", "sharded", "sharded_grid"):
            # Loud, not silent: a typo like "grid-only" falling back to
            # the full load would OOM (or serve unpinned) at exactly the
            # scale grid_only exists for.
            raise ValueError(
                f"unknown serve_mode {mode!r} (config.json or "
                "NEXT_PLAID_SERVE_MODE): expected 'auto', 'grid_only', "
                "'sharded', or 'sharded_grid'"
            )
        if mode in ("sharded", "sharded_grid"):
            # Doc-range shards over the mesh (parallel/sharded.py).
            # Mutations are storage-is-the-truth: ingest appends in place
            # where it can, else invalidates and the next get_index
            # re-shards.
            mesh = self._mesh()
            if mode == "sharded_grid":
                return ShardedGridIndex.shard_grid_only(
                    str(self.index_path(name)), mesh, _grid_only_dtype(mode)
                )
            # Disk -> host -> shards: the corpus never transits a single
            # device. capacity_factor reserves per-shard slack so ingest
            # appends in place.
            return ShardedIndex.shard(
                HostIndexData.load(str(self.index_path(name))), mesh,
                capacity_factor=float(
                    os.environ.get("NEXT_PLAID_SHARD_CAPACITY_FACTOR", "1.5")
                ),
            )
        if mode == "grid_only":
            from nextplaid_tpu_torch.index.container import load_grid_only

            return load_grid_only(
                str(self.index_path(name)), dtype=_grid_only_dtype(mode),
                device=self.device,
            )
        # Pin the decompressed token grid when it fits the device budget:
        # exhaustive search then skips per-batch decompress.
        # grid_aware_capacity: drop the append headroom if it would flip
        # the pinning outcome (bf16 -> int8/unpinned) — precision beats
        # headroom for serving.
        return DeviceIndex.load(
            str(self.index_path(name)),
            capacity_factor=SERVE_CAPACITY_FACTOR,
            grid_aware_capacity=True,
            device=self.device,
        ).with_token_grid()

    def _mesh(self):
        """The mesh of the sharded serve modes: one shard a visible card, or
        one shard on the state's device when that is not a card."""
        if self.device.type == "cuda":
            return make_mesh()
        return make_mesh(devices=[self.device])

    def process_lock(self, name: str) -> asyncio.Lock:
        """The lock an index's ingest and delete batches hold while they
        mutate it."""
        return self._process_locks.setdefault(name, asyncio.Lock())

    def served(self, name: str) -> Optional[DeviceIndex]:
        """The index snapshot searches of `name` use now, if one is loaded."""
        return self._indices.get(name)

    def register(self, name: str, index: DeviceIndex) -> None:
        self._indices[name] = index  # atomic swap; readers never block

    def invalidate(self, name: str) -> None:
        self._indices.pop(name, None)
        self._config_cache.pop(name, None)

    async def close(self) -> None:
        """Stop the background workers and drop what this state holds on the
        device: every loaded index and the encoder. A server's cleanup calls
        this."""
        workers = [*self._ingest_workers.values(), *self._delete_workers.values(),
                   *self._search_workers.values()]
        for task in workers:
            task.cancel()
        await asyncio.gather(*workers, return_exceptions=True)
        if self.encoder_pool is not None:
            await self.encoder_pool.stop()
        self.encoder_pool = self.encoder = None
        self._indices.clear()

    # -- progress -------------------------------------------------------------

    def set_progress(self, name: str, **kw) -> None:
        entry = self.progress.get(name)
        if entry is None or entry.status in ("completed", "failed"):
            entry = UpdateProgress(index=name)
            self.progress[name] = entry
        for k, v in kw.items():
            setattr(entry, k, v)
        entry.updated_at = time.time()
        self._prune_progress()

    def _prune_progress(self) -> None:
        now = time.time()
        for k in [
            k
            for k, v in self.progress.items()
            if v.status in ("completed", "failed")
            and now - v.updated_at > PROGRESS_TTL_S
        ]:
            del self.progress[k]

    # -- ingest pipeline --------------------------------------------------------

    async def enqueue_add(
        self,
        name: str,
        embeddings: List[np.ndarray],
        metadata: Optional[List[dict]],
    ) -> asyncio.Future:
        """Queue documents for batched ingestion; resolves with assigned ids."""
        sem = self._queue_sems.setdefault(
            name, asyncio.Semaphore(MAX_QUEUED_TASKS_PER_INDEX)
        )
        await sem.acquire()
        queue = self._ingest_queues.setdefault(name, asyncio.Queue())
        worker_lock = self._worker_locks.setdefault(name, asyncio.Lock())
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        fut.add_done_callback(lambda _: sem.release())
        async with worker_lock:
            # Enqueue + (re)spawn under one lock: a worker deciding to exit
            # takes the same lock and rechecks the queue, so an item can
            # never land between its timeout and its exit unseen.
            await queue.put(_PendingAdd(embeddings, metadata, fut))
            if (
                name not in self._ingest_workers
                or self._ingest_workers[name].done()
            ):
                self._ingest_workers[name] = asyncio.create_task(
                    self._ingest_worker(name)
                )
        self.set_progress(
            name,
            status="queued",
            stage="queued",
            queued_documents=(self.progress.get(name).queued_documents or 0)
            + len(embeddings)
            if self.progress.get(name)
            else len(embeddings),
        )
        return fut

    async def _ingest_worker(self, name: str) -> None:
        """Coalesce queued adds into batches (documents.rs:344-373)."""
        queue = self._ingest_queues[name]
        worker_lock = self._worker_locks.setdefault(name, asyncio.Lock())
        while True:
            try:
                first = await asyncio.wait_for(queue.get(), timeout=5.0)
            except asyncio.TimeoutError:
                async with worker_lock:
                    if not queue.empty():
                        continue  # an enqueue raced the timeout
                    return  # idle; the next enqueue respawns the worker
            batch = [first]
            total = len(first.embeddings)
            deadline = time.monotonic() + BATCH_WINDOW_MS / 1000
            while total < MAX_BATCH_DOCUMENTS:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = await asyncio.wait_for(queue.get(), timeout=remaining)
                except asyncio.TimeoutError:
                    break
                batch.append(nxt)
                total += len(nxt.embeddings)
            await self._process_batch(name, batch)

    async def _process_batch(self, name: str, batch: List[_PendingAdd]) -> None:
        lock = self.process_lock(name)
        embeddings = [e for item in batch for e in item.embeddings]
        has_meta = any(item.metadata for item in batch)
        metadata: Optional[List[dict]] = None
        if has_meta:
            metadata = []
            for item in batch:
                metadata.extend(
                    item.metadata
                    if item.metadata
                    else [{} for _ in item.embeddings]
                )
        async with lock:
            self.set_progress(
                name, status="running", stage="indexing",
                queued_documents=len(embeddings),
            )
            loop = asyncio.get_running_loop()
            try:
                doc_ids = await loop.run_in_executor(
                    None, self._ingest_sync, name, embeddings, metadata
                )
                self.set_progress(
                    name, status="completed", stage="done",
                    processed_documents=len(embeddings), queued_documents=0,
                )
                offset = 0
                for item in batch:
                    n = len(item.embeddings)
                    if not item.future.done():
                        item.future.set_result(doc_ids[offset : offset + n])
                    offset += n
            except BaseException as e:  # propagate to all waiters
                self.set_progress(
                    name, status="failed", stage="error", error=str(e)
                )
                for item in batch:
                    if not item.future.done():
                        item.future.set_exception(
                            e if len(batch) == 1 else NextPlaidError(str(e))
                        )

    # -- delete pipeline --------------------------------------------------------

    def enqueue_delete(
        self, name: str, condition: str, parameters: List[Any]
    ) -> None:
        """Queue a delete-by-condition for batched processing (next-plaid
        documents.rs:658-860). Raises NextPlaidError when the queue is full
        (the handler maps it to 503). Returns immediately — the caller
        responds 202 Accepted."""
        queue = self._delete_queues.setdefault(
            name, asyncio.Queue(maxsize=BATCH_CHANNEL_SIZE)
        )
        try:
            queue.put_nowait(_PendingDelete(condition, list(parameters)))
        except asyncio.QueueFull:
            raise NextPlaidError(
                f"Delete queue full for index '{name}'. Max "
                f"{BATCH_CHANNEL_SIZE} pending items. Retry later."
            )
        worker = self._delete_workers.get(name)
        if worker is None or worker.done():
            self._delete_workers[name] = asyncio.create_task(
                self._delete_worker(name)
            )

    async def _delete_worker(self, name: str) -> None:
        """Collect delete conditions: wait >= MIN after the first, keep
        collecting until MAX elapsed or the condition cap, then process."""
        queue = self._delete_queues[name]
        while True:
            try:
                first = await asyncio.wait_for(queue.get(), timeout=5.0)
            except asyncio.TimeoutError:
                if not queue.empty():
                    continue
                return  # idle; next enqueue respawns
            batch = [first]
            max_deadline = time.monotonic() + DELETE_BATCH_MAX_WAIT_MS / 1000
            # Quiet-period batching: after each arrival wait up to MIN for
            # the next; an idle MIN window closes the batch early, MAX is
            # the hard cap (documents.rs:658-756 window semantics — the old
            # two-phase loop always blocked until MAX, making MIN dead and
            # adding MAX latency to every single-condition delete).
            while len(batch) < MAX_DELETE_BATCH_CONDITIONS:
                remaining = max_deadline - time.monotonic()
                if remaining <= 0:
                    break
                window = min(DELETE_BATCH_MIN_WAIT_MS / 1000, remaining)
                try:
                    batch.append(
                        await asyncio.wait_for(queue.get(), timeout=window)
                    )
                except asyncio.TimeoutError:
                    break  # quiet for MIN: the batch is done
            await self._process_delete_batch(name, batch)

    async def _process_delete_batch(
        self, name: str, batch: List[_PendingDelete]
    ) -> None:
        lock = self.process_lock(name)
        async with lock:
            loop = asyncio.get_running_loop()
            try:
                deleted = await loop.run_in_executor(
                    None, self._delete_sync, name, batch
                )
                self.set_progress(
                    name,
                    status="completed",
                    stage="delete_done",
                    message=f"deleted {deleted} documents "
                    f"({len(batch)} conditions)",
                )
            except asyncio.CancelledError:
                raise  # shutdown must not be swallowed into a progress entry
            except BaseException as e:
                self.set_progress(
                    name, status="failed", stage="delete_error", error=str(e)
                )
            self.invalidate(name)

    def _delete_sync(self, name: str, batch: List[_PendingDelete]) -> int:
        """Resolve each condition against the CURRENT db state and delete
        sequentially — deletions shift ids, so conditions must be resolved
        after all prior deletions applied (documents.rs:826-860)."""
        path = str(self.index_path(name))
        self.repair_index_db_sync(name)
        total = 0
        for item in batch:
            ids = filtering.where_condition(
                path, item.condition, item.parameters
            )
            if not ids:
                continue
            total += delete_with_options(ids, path)
        return total

    # -- search coalescing -----------------------------------------------------

    async def enqueue_search(self, name: str, queries, params) -> List[Any]:
        """Run a semantic search, coalescing with concurrent requests.

        Requests sharing (index name, SearchParameters) merge into one
        device dispatch of the concatenated query list; each caller gets
        back exactly its slice. Greedy-drain policy: at low load a request
        dispatches alone (zero added latency); under concurrency whatever
        queued during the previous dispatch forms the next batch, so batch
        size adapts to load automatically. Only subset-free searches are
        coalesced (callers handle subset directly).
        """
        key = (name, tuple(sorted(params.to_dict().items())))
        queue = self._search_queues.setdefault(key, asyncio.Queue())
        worker_lock = self._worker_locks.setdefault(
            ("search", key), asyncio.Lock()
        )
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        async with worker_lock:
            # Same enqueue/respawn discipline as the ingest worker: a
            # worker deciding to exit rechecks the queue under this lock.
            await queue.put(_PendingSearch(list(queries), params, fut))
            if (
                key not in self._search_workers
                or self._search_workers[key].done()
            ):
                self._search_workers[key] = asyncio.create_task(
                    self._search_worker(name, key)
                )
        return await fut

    async def _search_worker(self, name: str, key) -> None:
        queue = self._search_queues[key]
        worker_lock = self._worker_locks[("search", key)]
        in_flight: List[asyncio.Task] = []
        while True:
            try:
                first = await asyncio.wait_for(queue.get(), timeout=5.0)
            except asyncio.TimeoutError:
                if in_flight:
                    await asyncio.gather(*in_flight, return_exceptions=True)
                    in_flight = []
                async with worker_lock:
                    if not queue.empty():
                        continue  # an enqueue raced the timeout
                    self._search_workers.pop(key, None)
                    return  # idle; the next enqueue respawns the worker
            batch = [first]
            total = len(first.queries)
            # Greedy drain — no wait window: everything already queued (up
            # to the cap) joins this dispatch; later arrivals form the next.
            while total < MAX_COALESCED_QUERIES and not queue.empty():
                nxt = queue.get_nowait()
                batch.append(nxt)
                total += len(nxt.queries)
            in_flight = [t for t in in_flight if not t.done()]
            while len(in_flight) >= SEARCH_DISPATCH_DEPTH:
                _, pending = await asyncio.wait(
                    in_flight, return_when=asyncio.FIRST_COMPLETED
                )
                in_flight = list(pending)
            in_flight.append(
                asyncio.create_task(self._dispatch_search(name, batch))
            )

    async def _dispatch_search(
        self, name: str, batch: List[_PendingSearch]
    ) -> None:
        loop = asyncio.get_running_loop()
        all_q = [q for item in batch for q in item.queries]
        params = batch[0].params
        try:
            index = await self.get_index(name)
            fn = search_fn_for(index)
            results = await loop.run_in_executor(
                None, lambda: fn(index, all_q, params)
            )
        except BaseException as e:  # noqa: BLE001 — forwarded to callers
            for item in batch:
                if not item.future.done():
                    item.future.set_exception(
                        e if isinstance(e, Exception) else RuntimeError(str(e))
                    )
            if not isinstance(e, Exception):
                raise  # CancelledError etc: also unwind the worker task
            return
        off = 0
        for item in batch:
            n = len(item.queries)
            if not item.future.done():
                item.future.set_result(results[off : off + n])
            off += n

    def _ingest_sync(
        self,
        name: str,
        embeddings: List[np.ndarray],
        metadata: Optional[List[dict]],
    ) -> List[int]:
        from nextplaid_tpu_torch.utils.progress import with_progress

        def forward(stage, processed=None, total=None):
            # Engine stages land in the /health progress registry
            # (next-plaid documents.rs:444-451).
            self.set_progress(
                name, stage=stage,
                processed_documents=processed,
                queued_documents=total,
            )

        with with_progress(forward):
            return self._ingest_sync_inner(name, embeddings, metadata)

    def _ingest_sync_inner(
        self,
        name: str,
        embeddings: List[np.ndarray],
        metadata: Optional[List[dict]],
    ) -> List[int]:
        path = str(self.index_path(name))
        self.repair_index_db_sync(name)
        cfg = self.get_config(name)
        index_config = IndexConfig(
            nbits=cfg.nbits,
            batch_size=cfg.batch_size,
            seed=cfg.seed,
            start_from_scratch=cfg.start_from_scratch,
            fts_tokenizer=cfg.fts_tokenizer,
        )
        update_config = UpdateConfig(
            batch_size=cfg.batch_size,
            seed=cfg.seed if cfg.seed is not None else 42,
            start_from_scratch=cfg.start_from_scratch,
        )
        info: dict = {}
        doc_ids = update_or_create_with_metadata(
            embeddings, path, index_config, update_config, metadata,
            info_out=info, device=self.device,
        )
        evicted = self._evict_oldest(name, cfg)
        appended = self._try_device_append(name, info, evicted)
        if not appended:
            served = self._indices.get(name)
            if served is not None and (
                not isinstance(served, DeviceIndex) or served.grid_only
            ):
                # Grid-only / sharded: invalidate instead of eager reload.
                # An eager reload would build the NEW grid or shards while
                # the old ones are still registered — two near-device-sized
                # residencies can't coexist at the scale these modes
                # target. Dropping the slot frees the old as in-flight
                # searches drain; the next get_index (under its per-index
                # load lock) rebuilds lazily, and coalesced ingest batches
                # pay that load once per quiet period instead of per batch.
                self._indices.pop(name, None)
            else:
                self.register(name, self._load_index_sync(name))
        return doc_ids

    def _try_device_append(
        self, name: str, info: dict, evicted: int
    ) -> bool:
        """Advance the SERVED index in place when the ingest batch was a
        plain buffer-mode append (centroids unchanged): O(batch) device
        work (`DeviceIndex.append_batch` writes into the pinned grid's
        headroom) instead of an O(corpus) reload + re-pin (next-plaid's mmap
        reloads are O(changed), mmap.rs:1081-1300). Falls back to a full
        reload on centroid expansion, scratch rebuilds, eviction, or
        capacity/geometry limits; a failed append is logged with its
        traceback before the reload.
        """
        served = self._indices.get(name)
        encoded = info.get("encoded")
        if (
            served is None
            or evicted
            or info.get("mode") != "buffer"
            or encoded is None
        ):
            return False
        codes, residuals, doclens = encoded
        if isinstance(served, (ShardedIndex, ShardedGridIndex)):
            # Sharded: O(batch) writes into the tail shard's slack (the
            # grid spills into empty successors); the staged index then
            # refreshes one shard's IVF. None falls back to the reload.
            try:
                appended = served.append_batch(codes, residuals, doclens)
                if isinstance(appended, ShardedIndex):
                    appended = appended.refresh_ivf()
            except Exception:
                logger.exception("sharded append failed; falling back to reload")
                return False
            if appended is None:
                return False
            self.register(name, appended)
            return True
        if served.grid_only:
            # Grid-only serving: immutable on the device; mutate on disk +
            # lazy reload.
            return False
        try:
            appended = served.append_batch(codes, residuals, doclens)
        except Exception:
            logger.exception("device append failed; falling back to reload")
            return False
        if appended is None:
            return False
        if appended.token_grid is None:
            # Unpinned serving uses the staged pipeline, which reads the
            # IVF: re-stage it now (O(nnz) h2d — still far below a full
            # reload's codes+residuals+grid traffic). Pinned serving never
            # touches the IVF, so it stays lazily stale.
            appended = appended.refresh_ivf(str(self.index_path(name)))
        self.register(name, appended)
        return True

    def _evict_oldest(self, name: str, cfg: IndexConfigStored) -> int:
        """FIFO eviction beyond max_documents (documents.rs:633). Returns
        the number of evicted documents."""
        if cfg.max_documents is None:
            return 0
        path = str(self.index_path(name))
        layout = IndexLayout(path)
        if not layout.metadata.exists():
            return 0
        meta = load_json(layout.metadata)
        num_docs = int(meta.get("num_documents", 0))
        excess = num_docs - cfg.max_documents
        if excess > 0:
            delete_with_options(list(range(excess)), path)
            return excess
        return 0

    def repair_index_db_sync(self, name: str) -> None:
        """Heal index <-> metadata.db count drift (documents.rs:110): if the
        DB has more rows than the index has documents, drop the tail rows."""
        path = str(self.index_path(name))
        layout = IndexLayout(path)
        if not layout.metadata.exists() or not layout.metadata_db.exists():
            return
        meta = load_json(layout.metadata)
        num_docs = int(meta.get("num_documents", 0))
        db_count = filtering.count(path)
        if db_count > num_docs:
            filtering.delete(path, list(range(num_docs, db_count)))
            text_search.rebuild(path)

    # -- delete ----------------------------------------------------------------

    async def delete_index(self, name: str) -> bool:
        path = self.index_path(name)
        if not path.exists():
            return False
        lock = self.process_lock(name)
        async with lock:
            self.invalidate(name)
            filtering.metadata.invalidate_read_connection(str(path))
            await asyncio.get_running_loop().run_in_executor(
                None, shutil.rmtree, str(path)
            )
        return True
