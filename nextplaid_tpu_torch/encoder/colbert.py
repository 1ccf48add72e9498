"""ColBERT text -> multi-vector encoding on the card.

PyTorch counterpart of `nextplaid_tpu.encoder.colbert` (next-plaid-onnx's
`Colbert`, src/lib.rs:730-1624), with the forward of `encoder/model.py`:

  - PyLate-compatible tokenization: text is tokenized WITHOUT the prefix, then
    the prefix token id is inserted after [CLS] (lib.rs:1816-1823), truncation
    keeps the trailing [SEP] (lib.rs:1945-1960);
  - query expansion: queries pad to `query_length` with [MASK] tokens that
    ATTEND (attention=1) and are kept in the output (lib.rs:1925-1942);
  - documents: padding is masked out and skiplist (punctuation) token
    embeddings are dropped from the output (lib.rs:2214-2240);
  - optional hierarchical token pooling (pooling.py).

Shapes are the JAX package's: lengths round up to a multiple of 32 and
batches to a power of two (rows repeated), so both packages run the same
[batch, length] forwards on the same texts.

Forwards are queued on the card's current stream without waiting:
`pipeline_depth` of them are in flight at once, each read back by a
non-blocking copy into pinned host memory and an event, so the host
tokenizes the next batch and filters an earlier one while the card runs.
"""

from __future__ import annotations

import os
from collections import deque
from pathlib import Path
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from nextplaid_tpu_torch.encoder.config import ColbertConfig
from nextplaid_tpu_torch.encoder.model import (
    BackboneConfig,
    ColbertModel,
    init_random_params,
    load_params,
    quantize_dense_params,
)
from nextplaid_tpu_torch.encoder.pooling import pool_document_embeddings
from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device
from nextplaid_tpu_torch.utils.errors import EncodingError

_LENGTH_BUCKET = 32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _batch_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class _Pending:
    """One forward in flight: its output on the host once `event` (None on
    the CPU) has completed, and how many of its rows are real."""

    __slots__ = ("host", "event", "n")

    def __init__(self, host, event, n):
        self.host, self.event, self.n = host, event, n

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host[: self.n].numpy()


class Colbert:
    """ColBERT encoder over the `torch.nn` backbone.

    Parameters
    ----------
    model_dir:
        HF-style model directory (or hub id): `config.json`, weights
        (`model.safetensors` / `pytorch_model.bin`), `tokenizer.json`,
        `1_Dense/` projection, and optionally `onnx_config.json` /
        `colbert_config.json` (next-plaid-onnx's export format).
    config:
        Override the ColBERT behavior config (otherwise read from model_dir).
    params:
        A ColbertModel state_dict (`load_params`, `init_random_params`,
        `params_from_jax`); random weights from seed 0 when None without a
        model_dir.
    batch_size:
        Max device batch per forward.
    quantized:
        INT8 serving mode: backbone dense layers run int8 x int8 with
        dynamically quantized activations, next-plaid-onnx's INT8 sessions;
        weights are converted post-training, the projection stays full
        precision.
    pipeline_depth:
        Forwards kept in flight before the host waits for the oldest.
    device:
        Where the forward runs ("cuda" when None).
    """

    def __init__(
        self,
        model_dir: Optional[str] = None,
        config: Optional[ColbertConfig] = None,
        backbone_config: Optional[BackboneConfig] = None,
        params=None,
        tokenizer=None,
        batch_size: int = 32,
        query_length: Optional[int] = None,
        document_length: Optional[int] = None,
        quantized: bool = False,
        pipeline_depth: int = 4,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if model_dir is not None:
            from nextplaid_tpu_torch.encoder.hub import resolve_model_dir

            model_dir = resolve_model_dir(model_dir)
            self.config = config or ColbertConfig.from_model_dir(model_dir)
            self.backbone_config = backbone_config or BackboneConfig.from_model_dir(
                model_dir
            )
            self.tokenizer = tokenizer or self._load_tokenizer(model_dir)
            if params is None:
                params = load_params(model_dir, self.backbone_config)
        else:
            if config is None or backbone_config is None or tokenizer is None:
                raise EncodingError(
                    "Without model_dir, provide config, backbone_config, "
                    "tokenizer and params"
                )
            self.config = config
            self.backbone_config = backbone_config
            self.tokenizer = tokenizer
            if params is None:
                params = init_random_params(backbone_config)
        if query_length is not None:
            self.config.query_length = query_length
        if document_length is not None:
            self.config.document_length = document_length
        self.backbone_config.projection_dim = self.config.embedding_dim
        self.quantized = quantized
        if quantized:
            params = quantize_dense_params(params)
        self.batch_size = batch_size
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.model = ColbertModel(
            self.backbone_config, quantized=quantized, device=self.device
        )
        self.model.load_state_dict(params)
        self.model.eval()
        self.skiplist_ids = self._build_skiplist()
        self._skiplist_arr = np.asarray(sorted(self.skiplist_ids), np.int64)
        self._query_prefix_id = self._resolve_prefix_id(
            self.config.query_prefix, self.config.query_prefix_id
        )
        self._document_prefix_id = self._resolve_prefix_id(
            self.config.document_prefix, self.config.document_prefix_id
        )

    # -- setup ---------------------------------------------------------------

    @staticmethod
    def _load_tokenizer(model_dir: Path):
        tok_json = model_dir / "tokenizer.json"
        if tok_json.exists():
            from tokenizers import Tokenizer

            return Tokenizer.from_file(str(tok_json))
        raise EncodingError(f"tokenizer.json not found in {model_dir}")

    def _token_to_id(self, token: str) -> Optional[int]:
        fn = getattr(self.tokenizer, "token_to_id", None)
        if fn is not None:
            return fn(token)
        return self.tokenizer.convert_tokens_to_ids(token)  # transformers API

    def _resolve_prefix_id(self, prefix: str, explicit: Optional[int]) -> int:
        if explicit is not None:
            return int(explicit)
        for cand in (prefix, prefix.strip()):
            tid = self._token_to_id(cand)
            if tid is not None and tid >= 0:
                return int(tid)
        # Fall back to the first non-special token of the encoded prefix.
        ids = self._encode_ids(prefix.strip(), add_special_tokens=False)
        if ids:
            return int(ids[0])
        raise EncodingError(f"Prefix token '{prefix}' not found in tokenizer vocabulary")

    def _build_skiplist(self) -> frozenset:
        ids = set()
        for word in self.config.skiplist_words:
            tid = self._token_to_id(word)
            if tid is not None and tid >= 0:
                ids.add(int(tid))
        return frozenset(ids)

    def _encode_ids(self, text: str, add_special_tokens: bool = True) -> List[int]:
        enc = self.tokenizer.encode(text, add_special_tokens=add_special_tokens)
        return list(enc.ids if hasattr(enc, "ids") else enc)

    def _encode_ids_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """Tokenize a batch. `tokenizers.Tokenizer.encode_batch` runs the
        WordPiece loop in parallel Rust threads (next-plaid-onnx gets the
        same from tokenizers-rs, lib.rs:1841); the per-text loop serves
        transformers-style tokenizers and single-core hosts, where the
        thread pool loses to the loop."""
        fn = getattr(self.tokenizer, "encode_batch", None)
        cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else 1
        if fn is not None and cores > 1:
            return [list(e.ids) for e in fn(list(texts))]
        return [self._encode_ids(t) for t in texts]

    # -- tokenization (lib.rs:1841-2100 semantics) ---------------------------

    def _prepare(self, texts: Sequence[str], is_query: bool) -> tuple:
        """Returns (input_ids [B,L], attention [B,L], token_ids per row,
        original_lengths). L is the bucketed batch max length."""
        cfg = self.config
        max_length = cfg.query_length if is_query else cfg.document_length
        prefix_id = self._query_prefix_id if is_query else self._document_prefix_id
        truncate_limit = max(max_length - 1, 0)
        processed = [
            (t.strip().lower() if cfg.do_lower_case else t.strip()) or " "
            for t in texts
        ]
        encodings = self._encode_ids_batch(processed)

        rows: List[List[int]] = []
        for ids in encodings:
            real_len = max(len(ids), 1)
            if real_len > truncate_limit:
                # Keep [CLS], prefix, first truncate_limit-1 content tokens,
                # and the trailing [SEP].
                content = ids[1 : truncate_limit - 1]
                row = [ids[0], prefix_id, *content, ids[real_len - 1]]
            else:
                row = [ids[0], prefix_id, *ids[1:real_len]]
            rows.append(row)

        original_lengths = [len(r) for r in rows]
        if is_query and cfg.do_query_expansion:
            batch_len = max_length
            fill_id, fill_attn = cfg.mask_token_id, 1
        else:
            batch_len = min(_round_up(max(original_lengths), _LENGTH_BUCKET), max_length)
            fill_id, fill_attn = cfg.pad_token_id, 0

        n = len(rows)
        input_ids = np.full((n, batch_len), fill_id, np.int32)
        attention = np.full((n, batch_len), fill_attn, np.int32)
        for i, row in enumerate(rows):
            L = min(len(row), batch_len)
            input_ids[i, :L] = row[:L]
            attention[i, :L] = 1
        return input_ids, attention, rows, original_lengths

    # -- forward -------------------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            # From pinned memory the copy is queued behind the forwards in
            # flight instead of waiting for them.
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _dispatch_batch(self, input_ids: np.ndarray, attention: np.ndarray) -> _Pending:
        """Queue one forward (batch dim bucket-padded by repeating the last
        row) and its readback, without waiting for either."""
        n = len(input_ids)
        b = _batch_bucket(n, self.batch_size)
        if b != n:
            input_ids = np.concatenate([input_ids, np.repeat(input_ids[-1:], b - n, 0)])
            attention = np.concatenate([attention, np.repeat(attention[-1:], b - n, 0)])
        ids, attn = self._to_device(input_ids), self._to_device(attention)
        token_type = (
            torch.zeros_like(ids) if self.backbone_config.model_type != "modernbert" else None
        )
        with torch.inference_mode():
            emb = self.model(ids, attn, token_type)[:n]
        if emb.is_cuda:
            host = torch.empty(emb.shape, dtype=emb.dtype, pin_memory=True)
            host.copy_(emb, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return _Pending(host, event, n)
        return _Pending(emb, None, n)

    def _run_batches(self, input_ids: np.ndarray, attention: np.ndarray) -> np.ndarray:
        """Run every sub-batch (all queued before any is read back); returns
        [N, L, dim] float32."""
        pending = [
            self._dispatch_batch(
                input_ids[s : s + self.batch_size], attention[s : s + self.batch_size]
            )
            for s in range(0, len(input_ids), self.batch_size)
        ]
        outs = [p.result() for p in pending]
        return np.concatenate(outs) if outs else np.zeros((0, 0, 0), np.float32)

    # -- public encode API ----------------------------------------------------

    def encode_queries(self, queries: Sequence[str]) -> List[np.ndarray]:
        """Encode queries; with expansion each output is exactly
        [query_length, dim] including attended [MASK] rows (lib.rs:1501)."""
        if not queries:
            return []
        input_ids, attention, _, lengths = self._prepare(queries, is_query=True)
        emb = self._run_batches(input_ids, attention)
        if self.config.do_query_expansion:
            return [emb[i] for i in range(len(queries))]
        return [emb[i, : lengths[i]] for i in range(len(queries))]

    def encode_documents(
        self,
        documents: Sequence[str],
        pool_factor: int = 1,
        filter_skiplist: bool = True,
    ) -> List[np.ndarray]:
        """Encode documents; padding rows are dropped, skiplist token rows
        filtered (lib.rs:1118), optional hierarchical pooling applied.

        Documents are length-sorted before batching (lib.rs:752-758): each
        forward pads only to its batch's longest member; the original order
        is restored on output. While the card runs the forwards in flight,
        the host tokenizes the next batch and filters the oldest.
        """
        if not documents:
            return []
        order = sorted(range(len(documents)), key=lambda i: len(documents[i]))
        out: List[Optional[np.ndarray]] = [None] * len(documents)
        skip = filter_skiplist and self._skiplist_arr.size > 0

        def postprocess(pending, idxs, rows, lengths):
            emb = pending.result()
            for bi, orig in enumerate(idxs):
                L = min(lengths[bi], emb.shape[1])
                if skip:
                    keep = ~np.isin(np.asarray(rows[bi][:L]), self._skiplist_arr)
                    out[orig] = emb[bi, :L][keep]
                else:
                    out[orig] = emb[bi, :L].copy()

        pending = deque()
        for start in range(0, len(order), self.batch_size):
            idxs = order[start : start + self.batch_size]
            input_ids, attention, rows, lengths = self._prepare(
                [documents[i] for i in idxs], is_query=False
            )
            pending.append((self._dispatch_batch(input_ids, attention), idxs, rows, lengths))
            if len(pending) > self.pipeline_depth:
                postprocess(*pending.popleft())
        while pending:
            postprocess(*pending.popleft())
        if pool_factor > 1:
            return pool_document_embeddings(out, pool_factor)
        return out

    def encode_documents_stream(
        self,
        documents: Iterable[str],
        batch_size: Optional[int] = None,
        pool_factor: int = 1,
    ) -> Iterator[List[np.ndarray]]:
        """Generator over encoded batches (next-plaid-onnx's streaming path,
        lib.rs:1383-1499); keeps host memory bounded for large corpora.

        Each super-chunk of `batch_size * pipeline_depth` documents goes
        through `encode_documents` (so the window of forwards in flight
        fills), then is yielded in `batch_size` slices."""
        batch_size = batch_size or self.batch_size
        chunk = batch_size * self.pipeline_depth
        buf: List[str] = []

        def flush(buf):
            embs = self.encode_documents(buf, pool_factor=pool_factor)
            for s in range(0, len(embs), batch_size):
                yield embs[s : s + batch_size]

        for doc in documents:
            buf.append(doc)
            if len(buf) >= chunk:
                yield from flush(buf)
                buf = []
        if buf:
            yield from flush(buf)

    @property
    def embedding_dim(self) -> int:
        return self.config.embedding_dim
