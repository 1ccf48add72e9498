"""Encode worker pool: N encoder replicas draining one asyncio queue.

next-plaid's counterpart: next-plaid-api/src/handlers/encode.rs:92-255 — an
mpsc queue with N workers, each owning its own ONNX `Colbert` session, so
concurrent encode requests don't serialize on one model.

On the card, replicas differ by where their weights live, not by session.
With one card, one replica is correct (the forwards already serialize on
the device, and a second replica on the same card would only double its
memory); with N cards, replica i's `ColbertModel` is moved to `cuda:i` and
requests round-robin across cards. Pool size = min(MODEL_POOL_SIZE, visible
CUDA devices); a CPU encoder has one replica.

Tokenization and post-processing run inside each worker's thread (via
run_in_executor), off the event loop — so even single-replica pools overlap
host tokenization of request i+1 with device compute of request i (the
encoder itself pipelines batches the same way, encoder/colbert.py). Every
forward runs on its thread's default stream.
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import os
from typing import List, Optional

import numpy as np
import torch


def pool_size_default() -> int:
    return int(os.environ.get("MODEL_POOL_SIZE", "1"))


# Max texts merged into one coalesced encode dispatch (matches the server's
# MAX_BATCH_TEXTS request cap; next-plaid encode.rs MAX_BATCH_TEXTS=64).
_COALESCE_MAX_TEXTS = int(os.environ.get("ENCODE_COALESCE_MAX", "64"))


def make_replicas(encoder, size: Optional[int] = None) -> List:
    """Build up to `size` encoder replicas, one per visible CUDA device.

    Replica 0 is the given encoder unchanged. Replica i > 0 is a shallow
    copy whose `ColbertModel` is a deep copy moved to `cuda:i`, so its
    forwards run on that card.
    """
    n_devices = torch.cuda.device_count() if _is_cuda(encoder) else 1
    size = max(1, min(size or pool_size_default(), n_devices))
    replicas = [encoder]
    for i in range(1, size):
        rep = copy.copy(encoder)
        rep.device = torch.device("cuda", i)
        rep.model = copy.deepcopy(encoder.model).to(rep.device)
        replicas.append(rep)
    return replicas


def _is_cuda(encoder) -> bool:
    device = getattr(encoder, "device", None)
    return isinstance(device, torch.device) and device.type == "cuda"


def _on_device(encoder):
    """Make the encoder's card current for this thread (events and pinned
    copies are queued on the current device's stream)."""
    if _is_cuda(encoder):
        return torch.cuda.device(encoder.device)
    return contextlib.nullcontext()


class EncoderPool:
    """Round-robin encode workers over encoder replicas."""

    def __init__(self, encoder, size: Optional[int] = None):
        self.replicas = make_replicas(encoder, size)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._workers: List[asyncio.Task] = []

    @property
    def size(self) -> int:
        return len(self.replicas)

    def start(self) -> None:
        if self._workers:
            return
        for rep in self.replicas:
            self._workers.append(
                asyncio.get_running_loop().create_task(self._worker(rep))
            )

    async def stop(self) -> None:
        for t in self._workers:
            t.cancel()
        for t in self._workers:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._workers = []

    async def _worker(self, encoder) -> None:
        loop = asyncio.get_running_loop()
        while True:
            first = await self._queue.get()
            batch = [first]
            # Coalesce whatever is already queued into this dispatch: the
            # next-plaid load shape is ONE query per HTTP request with N
            # concurrent workers (its README benchmarks), which would
            # otherwise serialize N single-text forwards through the
            # device queue — each paying full dispatch latency. Merging
            # the backlog into one padded forward costs nothing when
            # requests arrive alone and multiplies throughput when they
            # arrive together. Per-text results are batch-composition
            # independent (attention masks; the API tests assert allclose
            # vs solo encodes).
            n_texts = len(first[0])
            while n_texts < _COALESCE_MAX_TEXTS:
                try:
                    item = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                batch.append(item)
                n_texts += len(item[0])
            groups: dict = {}
            for texts, input_type, pool_factor, fut in batch:
                groups.setdefault((input_type, pool_factor), []).append(
                    (texts, fut)
                )
            for (input_type, pool_factor), items in groups.items():
                live = [(t, f) for t, f in items if not f.cancelled()]
                if not live:
                    continue
                all_texts = [t for ts, _ in live for t in ts]

                def _run(texts=all_texts, input_type=input_type,
                         pool_factor=pool_factor):
                    with _on_device(encoder):
                        if input_type == "query":
                            return encoder.encode_queries(texts)
                        return encoder.encode_documents(
                            texts, pool_factor=pool_factor
                        )

                try:
                    result = await loop.run_in_executor(None, _run)
                    off = 0
                    for ts, f in live:
                        part = result[off : off + len(ts)]
                        off += len(ts)
                        if not f.cancelled():
                            f.set_result(part)
                except Exception as e:  # propagate, keep draining
                    for _, f in live:
                        if not f.cancelled():
                            f.set_exception(e)

    async def encode(
        self,
        texts: List[str],
        input_type: str = "query",
        pool_factor: int = 1,
    ) -> List[np.ndarray]:
        """Queue an encode job and await its result."""
        if not self._workers:
            self.start()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((list(texts), input_type, pool_factor, fut))
        return await fut

    def warm(self) -> float:
        """Run every query-forward batch bucket (and one full document
        batch) once on every replica; returns wall-clock seconds.

        The first forward of each (batch, length) shape pays the card's
        one-time costs (cuBLAS handles and heuristics, the caching
        allocator's first blocks, pinned host buffers): call at startup
        (ENCODE_WARM=1 / --warm-encode) to move them off the serving path.
        """
        import time

        t0 = time.perf_counter()
        for enc in self.replicas:
            with _on_device(enc):
                b = 1
                while b <= min(enc.batch_size, _COALESCE_MAX_TEXTS):
                    enc.encode_queries(["warm up"] * b)
                    b *= 2
                # One full-batch, full-length document forward (the
                # bulk-ingest shape: encode_documents length-sorts then pads
                # per batch).
                filler = "warm " * max(enc.config.document_length, 1)
                enc.encode_documents([filler] * enc.batch_size)
        return time.perf_counter() - t0
