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

BERT with absolute positions runs the JAX package's shapes: lengths round
up to a multiple of 32 and batches to a power of two (rows repeated), so
both packages run the same [batch, length] forwards on the same texts. The
rotary families (ModernBERT, Jina's XLM-RoBERTa) run packed, as HF
ModernBERT's unpadded path does: a forward's live tokens laid end to end
with their documents' bounds (`ColbertModel.forward_packed`), and forwards
formed by tokens: consecutive texts of the length sort while they hold at
most batch_size x document_length (queries: x query_length) live tokens,
the size of a padded forward at the config's full length.

With tracing on (`utils.trace`), each call records host spans
`encode.prepare` (tokenization and packing), the device span
`encode.forward` of each forward, and its counters `encode.live_tokens`,
`encode.token_slots`, and for a packed forward `encode.attn_pairs_global`
and `encode.attn_pairs_local` (query-key pairs within one document, summed
over the forward's global or local layers, per head) and
`encode.attn_layers_global` (its global layers, one attention launch
each), counted from the layers' own kinds (`BackboneConfig.layer_windows`);
all keyed to the caller's `trace.batch_scope` or a fresh batch id a call.

Forwards are queued on the card's current stream without waiting:
`pipeline_depth` of them are in flight at once, each read back by a
non-blocking copy into pinned host memory and an event, so the host
tokenizes the next batch and filters an earlier one while the card runs.
"""

from __future__ import annotations

import contextlib
import itertools
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
    packed_positions,
    quantize_dense_params,
)
from nextplaid_tpu_torch.encoder.pooling import pool_document_embeddings
from nextplaid_tpu_torch.utils import trace
from nextplaid_tpu_torch.utils.device import DeviceLike, resolve_device
from nextplaid_tpu_torch.utils.errors import EncodingError

_LENGTH_BUCKET = 32


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _token_packs(lengths: Iterable[int], budget: int) -> Iterator[tuple]:
    """(start, end) of consecutive runs of `lengths` that each sum to at
    most `budget` (a longer single length runs alone), greedily. A run is
    yielded as soon as the length after it is drawn, so `lengths` may be
    produced lazily."""
    start = end = held = 0
    for n in lengths:
        if end > start and held + n > budget:
            yield start, end
            start, held = end, 0
        held += n
        end += 1
    if start < end:
        yield start, end


def _batch_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, cap)


class _Pending:
    """One forward in flight: its output on the host once `event` (None on
    the CPU) has completed, and how many of its rows are real; `timing`,
    the forward's CUDA events when traced."""

    __slots__ = ("host", "event", "n", "timing", "batch")

    def __init__(self, host, event, n, timing=None, batch=None):
        self.host, self.event, self.n = host, event, n
        self.timing, self.batch = timing, batch

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        if self.timing is not None:
            trace.device_span("encode.forward", *self.timing, batch=self.batch)
        return self.host[: self.n].numpy()


class _Trace:
    """A call's tracing: off, or on and keyed to one batch id."""

    __slots__ = ("on", "batch")

    def __init__(self):
        self.on = trace.active()
        self.batch = None
        if self.on:
            self.batch = trace.current_batch()
            if self.batch is None:
                self.batch = trace.next_batch()

    def prepare(self):
        return trace.span("encode.prepare", self.batch) if self.on else contextlib.nullcontext()

    def events(self, device):
        """A started pair of timing events on the card, else None."""
        if not self.on or device.type != "cuda":
            return None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        return start, end


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

    def _rows(self, texts: Sequence[str], is_query: bool) -> List[List[int]]:
        """Each text's token ids: [CLS], the prefix, the content and [SEP],
        truncated to the query or document length."""
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
        return rows

    def _prepare(self, texts: Sequence[str], is_query: bool) -> tuple:
        """Returns (input_ids [B,L], attention [B,L], token_ids per row,
        original_lengths). L is the bucketed batch max length."""
        cfg = self.config
        max_length = cfg.query_length if is_query else cfg.document_length
        rows = self._rows(texts, is_query)
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

    @property
    def _packed(self) -> bool:
        """The rotary families run packed forwards; BERT with absolute
        positions runs padded ones."""
        return self.backbone_config.rotary

    def _readback(self, emb: torch.Tensor, n: int, timing, tr: _Trace) -> _Pending:
        """Queue the copy of a forward's first `n` rows to the host."""
        if emb.is_cuda:
            if timing is not None:
                timing[1].record()
            host = torch.empty(emb.shape, dtype=emb.dtype, pin_memory=True)
            host.copy_(emb, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return _Pending(host, event, n, timing, tr.batch)
        return _Pending(emb, None, n)

    def _dispatch_batch(self, input_ids: np.ndarray, attention: np.ndarray,
                        tr: _Trace) -> _Pending:
        """Queue one padded forward (batch dim bucket-padded by repeating
        the last row) and its readback, without waiting for either."""
        n = len(input_ids)
        b = _batch_bucket(n, self.batch_size)
        if b != n:
            input_ids = np.concatenate([input_ids, np.repeat(input_ids[-1:], b - n, 0)])
            attention = np.concatenate([attention, np.repeat(attention[-1:], b - n, 0)])
        if tr.on:
            trace.count("encode.live_tokens", int(attention[:n].sum()), tr.batch)
            trace.count("encode.token_slots", input_ids.size, tr.batch)
        ids, attn = self._to_device(input_ids), self._to_device(attention)
        token_type = torch.zeros_like(ids) if not self._packed else None
        timing = tr.events(self.device)
        with torch.inference_mode():
            emb = self.model(ids, attn, token_type)[:n]
        return self._readback(emb, n, timing, tr)

    def _count_packed(self, lens: np.ndarray, batch) -> None:
        windows = self.backbone_config.layer_windows()
        n_global = sum(w is None for w in windows)
        local = sum(int(np.where(lens <= w + 1, lens * lens, lens * (2 * w + 1) - w * (w + 1)).sum())
                    for w in windows if w is not None)
        n = int(lens.sum())
        trace.count("encode.live_tokens", n, batch)
        trace.count("encode.token_slots", n, batch)
        trace.count("encode.attn_pairs_global", n_global * int((lens * lens).sum()), batch)
        trace.count("encode.attn_pairs_local", local, batch)
        trace.count("encode.attn_layers_global", n_global, batch)

    def _dispatch_packed(self, rows: List[List[int]], tr: _Trace) -> _Pending:
        """Queue one packed forward of `rows` and its readback, without
        waiting for either."""
        with tr.prepare():
            lens = np.fromiter(map(len, rows), np.int64, len(rows))
            n = int(lens.sum())
            flat = np.empty((2, n), np.int64)  # ids, positions: one copy
            flat[0] = np.fromiter(itertools.chain.from_iterable(rows), np.int64, n)
            flat[1] = packed_positions(lens)
            cu = np.zeros(len(rows) + 1, np.int32)
            np.cumsum(lens, out=cu[1:])
            if tr.on:
                self._count_packed(lens, tr.batch)
            ids, cu_t = self._to_device(flat), self._to_device(cu)
        timing = tr.events(self.device)
        with torch.inference_mode():
            emb = self.model.forward_packed(ids[0], ids[1], cu_t)
        return self._readback(emb, n, timing, tr)

    def _run_batches(self, input_ids: np.ndarray, attention: np.ndarray,
                     tr: _Trace) -> np.ndarray:
        """Run every padded sub-batch (all queued before any is read back);
        returns [N, L, dim] float32."""
        pending = [
            self._dispatch_batch(
                input_ids[s : s + self.batch_size], attention[s : s + self.batch_size], tr
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
        cfg, tr = self.config, _Trace()
        if not self._packed:
            with tr.prepare():
                input_ids, attention, _, lengths = self._prepare(queries, is_query=True)
            emb = self._run_batches(input_ids, attention, tr)
            if cfg.do_query_expansion:
                return [emb[i] for i in range(len(queries))]
            return [emb[i, : lengths[i]] for i in range(len(queries))]
        with tr.prepare():
            rows = self._rows(queries, is_query=True)
            if cfg.do_query_expansion:
                rows = [r + [cfg.mask_token_id] * (cfg.query_length - len(r)) for r in rows]
        lens = [len(r) for r in rows]
        pending = [self._dispatch_packed(rows[a:b], tr)
                   for a, b in _token_packs(lens, self.batch_size * cfg.query_length)]
        emb = np.concatenate([p.result() for p in pending])
        return np.split(emb, np.cumsum(lens[:-1]))

    def encode_documents(
        self,
        documents: Sequence[str],
        pool_factor: int = 1,
        filter_skiplist: bool = True,
    ) -> List[np.ndarray]:
        """Encode documents; padding rows are dropped, skiplist token rows
        filtered (lib.rs:1118), optional hierarchical pooling applied.

        Documents are length-sorted before batching (lib.rs:752-758): a
        padded forward pads only to its batch's longest member, a packed
        one takes consecutive documents up to its token budget; the
        original order is restored on output. While the card runs the
        forwards in flight, the host tokenizes the next batch and filters
        the oldest.
        """
        if not documents:
            return []
        order = sorted(range(len(documents)), key=lambda i: len(documents[i]))
        out: List[Optional[np.ndarray]] = [None] * len(documents)
        skip = filter_skiplist and self._skiplist_arr.size > 0
        packed, tr = self._packed, _Trace()
        budget = self.batch_size * self.config.document_length

        def postprocess(pending, idxs, rows):
            emb = pending.result()
            if packed:
                embs = np.split(emb, np.cumsum([len(r) for r in rows[:-1]]))
            else:
                embs = [emb[bi, : min(len(r), emb.shape[1])] for bi, r in enumerate(rows)]
            for orig, row, e in zip(idxs, rows, embs):
                if skip:
                    out[orig] = e[~np.isin(np.asarray(row[: len(e)]), self._skiplist_arr)]
                else:
                    out[orig] = e.copy()

        pending = deque()

        def dispatch(p, idxs, rows):
            pending.append((p, idxs, rows))
            if len(pending) > self.pipeline_depth:
                postprocess(*pending.popleft())

        if not packed:
            for start in range(0, len(order), self.batch_size):
                idxs = order[start : start + self.batch_size]
                with tr.prepare():
                    input_ids, attention, rows, _ = self._prepare(
                        [documents[i] for i in idxs], is_query=False)
                dispatch(self._dispatch_batch(input_ids, attention, tr), idxs, rows)
        else:
            texts_rows: List[List[int]] = []  # in `order`, as far as tokenized

            def lengths():  # a batch_size chunk tokenized at a time, as packs are drawn
                for start in range(0, len(order), self.batch_size):
                    chunk = [documents[i] for i in order[start : start + self.batch_size]]
                    with tr.prepare():
                        texts_rows.extend(self._rows(chunk, is_query=False))
                    yield from map(len, texts_rows[start:])

            for a, b in _token_packs(lengths(), budget):
                dispatch(self._dispatch_packed(texts_rows[a:b], tr), order[a:b], texts_rows[a:b])
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
