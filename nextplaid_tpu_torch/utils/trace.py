"""The port's tracer: host spans, device spans and counters in one bounded
in-memory ring, on the profiler's clock.

Operator note. Tracing is on while any `torch.profiler` session records
(CPU or CUDA activities), and inside `with trace.recording():`; nothing
else turns it on. While it is on, each search batch adds seven records
(eleven on a card's staged route): the host spans of its dispatch and its
read (`search.dispatch`, `.pad`, `.copy`, `.route`; `search.result`,
`.wait`, `.build`, and `.refine` when a grid-only batch owes the host
rerank) and, on the staged route, the CUDA-event times of its first
stages and its union grid build (`staged.select_prune`,
`staged.union_grid`) and the grid's token slots and live tokens
(`staged.union_token_slots`, `staged.union_live_tokens`). A build's
k-means is recorded whether tracing is on or not, flagged `setup`
(`build.kmeans`, once per build). Each call of the ColBERT encoder adds
host spans `encode.prepare`, and for each forward the device span
`encode.forward` and counters `encode.live_tokens`, `encode.token_slots`,
and for a packed forward `encode.attn_pairs_global`,
`encode.attn_pairs_local` and `encode.attn_layers_global`
(`encoder.colbert`), keyed to the batch of the enclosing `batch_scope`:
a rerank request's query and documents share one.
While a profiler records, each host span is also a `record_function`
range, so it lies on the profiler's own timeline beside the device work it
launched; the ring's `perf_counter_ns` times map onto that timeline through
any range opened at a known `perf_counter`.

Cost: off, a span site in the search path is one branch. On, an exact
batch's spans take 52-62 us of host work (156-178 us under a profiler)
on an H100 machine's host, and the staged route adds a CUDA event at each
stage mark and one device sum copied back after the batch's results; the
effect on a whole batch's time there lies within the spread of the
windows that measured it (PERF.md). There is no exporter: records stay
in memory, CAPACITY of them at most, until `records()` reads them;
`clear()` empties the ring and `dropped()` counts what it lost when full.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from collections import deque
from typing import Iterator, List, NamedTuple, Optional

import torch

CAPACITY = 1 << 16


class Record(NamedTuple):
    kind: str  # "span" (host), "device" (CUDA events) or "count"
    name: str
    value: float  # ms for spans; the count for counters
    batch: Optional[int]  # the search batch, None outside one
    start_ns: int  # perf_counter_ns(); a device span or count: when recorded
    end_ns: int
    id: int
    parent: Optional[int]  # the id of the span open around it on its thread
    thread: int
    setup: bool  # a set-up phase, recorded whether tracing is on or not


_ring: deque = deque(maxlen=CAPACITY)
_lock = threading.Lock()
_dropped = 0
_recording = 0
_ids = itertools.count(1)
_batches = itertools.count(1)
_parent: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "nextplaid_trace_parent", default=None
)
_scope: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar(
    "nextplaid_trace_batch", default=None
)


def active() -> bool:
    """True while a torch.profiler session records or inside `recording()`."""
    return _recording > 0 or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Turn tracing on in every thread of the process until the block ends."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def next_batch() -> int:
    """A fresh batch id, for the records of one search batch."""
    return next(_batches)


@contextlib.contextmanager
def batch_scope(batch: Optional[int] = None) -> Iterator[int]:
    """Within the block, `current_batch()` is `batch` (a fresh id when
    None): the calls of one request key their records to it."""
    token = _scope.set(next_batch() if batch is None else batch)
    try:
        yield _scope.get()
    finally:
        _scope.reset(token)


def current_batch() -> Optional[int]:
    """The enclosing `batch_scope`'s batch, or None outside one."""
    return _scope.get()


def _append(rec: Record) -> None:
    global _dropped
    with _lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(rec)


class Open:
    """A span begun and not yet ended."""

    __slots__ = ("name", "batch", "setup", "id", "parent", "start", "rf")


def begin(name: str, batch: Optional[int] = None, setup: bool = False) -> Open:
    """Open a span (end it with `end`); `span` is the block form. The
    caller decides whether to trace: this records unconditionally."""
    o = Open()
    o.name, o.batch, o.setup = name, batch, setup
    o.id, o.parent = next(_ids), _parent.get()
    _parent.set(o.id)
    o.rf = None
    if torch.autograd._profiler_enabled():
        o.rf = torch.profiler.record_function(name)
        o.rf.__enter__()
    o.start = time.perf_counter_ns()
    return o


def end(o: Open) -> None:
    t = time.perf_counter_ns()
    if o.rf is not None:
        o.rf.__exit__(None, None, None)
    _parent.set(o.parent)
    _append(Record("span", o.name, (t - o.start) / 1e6, o.batch, o.start, t,
                   o.id, o.parent, threading.get_ident(), o.setup))


@contextlib.contextmanager
def span(name: str, batch: Optional[int] = None, setup: bool = False) -> Iterator[None]:
    """Record the block as a host span. Per-call sites call it only where
    `active()` said yes; set-up phases pass `setup=True` and call it always."""
    o = begin(name, batch, setup)
    try:
        yield
    finally:
        end(o)


def device_span(name: str, start_event, end_event, batch: Optional[int] = None) -> None:
    """Record the device time between two CUDA events, in ms. Call it once
    both have completed (after the batch's results were copied back), so
    that reading them waits for nothing."""
    t = time.perf_counter_ns()
    _append(Record("device", name, start_event.elapsed_time(end_event), batch, t, t,
                   next(_ids), _parent.get(), threading.get_ident(), False))


def count(name: str, value: float, batch: Optional[int] = None) -> None:
    """Record a counter's value."""
    t = time.perf_counter_ns()
    _append(Record("count", name, float(value), batch, t, t,
                   next(_ids), _parent.get(), threading.get_ident(), False))


def records() -> List[Record]:
    """The ring's records, oldest first."""
    with _lock:
        return list(_ring)


def dropped() -> int:
    """Records the full ring dropped since the last `clear()`."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _ring.clear()
        _dropped = 0
