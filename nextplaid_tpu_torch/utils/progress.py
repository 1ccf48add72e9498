"""Engine progress reporting.

Rebuild of the reference's thread-local update-progress callback
(update.rs:36-71): long-running engine operations (k-means, chunk encode,
centroid expansion) report named stages through a context-local callback;
the API server forwards them into its /health progress registry
(documents.rs:444-451). No-op unless a callback is installed.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Iterator, Optional

ProgressFn = Callable[..., None]  # (stage, processed=None, total=None)

_callback: contextvars.ContextVar[Optional[ProgressFn]] = contextvars.ContextVar(
    "nextplaid_progress", default=None
)


def report(stage: str, processed: Optional[int] = None,
           total: Optional[int] = None) -> None:
    cb = _callback.get()
    if cb is not None:
        try:
            cb(stage, processed=processed, total=total)
        except Exception:  # progress must never break the operation
            pass


@contextlib.contextmanager
def with_progress(callback: ProgressFn) -> Iterator[None]:
    token = _callback.set(callback)
    try:
        yield
    finally:
        _callback.reset(token)
