"""Host-side index persistence: NPY files, atomic writes, cross-process locks.

A copy of `nextplaid_tpu.storage.npy` (the port imports nothing of the JAX
package). Replaces next-plaid's memmap2/fs2 storage layer (src/mmap.rs,
utils.rs:16-60): arrays live in device memory at runtime, so the host layer
only needs (a) the same on-disk
NPY + JSON directory format, (b) atomic tmp+rename writes, and (c) advisory
cross-process locks around mutations. Reads use numpy mmap_mode for zero-copy
staging into device transfers.
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import os
import tempfile
import threading
from pathlib import Path
from typing import Any, Iterator, Optional, Union

import numpy as np

PathLike = Union[str, os.PathLike]


def atomic_write_bytes(path: PathLike, data: bytes) -> None:
    """Write bytes atomically: tmp file in same dir + fsync + rename
    (reference utils.rs:16-60)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_npy(path: PathLike, array: np.ndarray) -> None:
    import io

    buf = io.BytesIO()
    np.save(buf, np.ascontiguousarray(array))
    atomic_write_bytes(path, buf.getvalue())


def atomic_write_json(path: PathLike, obj: Any, indent: int = 2) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=indent).encode())


def load_npy(path: PathLike, mmap: bool = True) -> np.ndarray:
    return np.load(path, mmap_mode="r" if mmap else None)


def load_json(path: PathLike) -> Any:
    with open(path) as f:
        return json.load(f)



class _PathLock:
    """Per-path lock state: an RLock for intra-process (thread) exclusion plus
    a refcounted flock fd for cross-process exclusion."""

    __slots__ = ("rlock", "fd", "count")

    def __init__(self) -> None:
        self.rlock = threading.RLock()
        self.fd = None
        self.count = 0


_LOCKS: dict = {}
_LOCKS_GUARD = threading.Lock()


@contextlib.contextmanager
def file_lock(path: PathLike, exclusive: bool = True) -> Iterator[None]:
    """Advisory cross-process + cross-thread lock (reference `FileLockGuard`,
    mmap.rs:25-57, combined with the per-index in-process mutexes of
    state.rs:15-59).

    Reentrant within a thread: flock() on two separate fds of the same file
    would self-deadlock (e.g. update()'s start-from-scratch path calling
    create_index() on the same index), so nested acquisitions share one fd.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    key = str(path.resolve())
    with _LOCKS_GUARD:
        state = _LOCKS.setdefault(key, _PathLock())

    with state.rlock:  # blocks other threads; reentrant for this thread
        if state.count == 0:
            f = open(path, "a+")
            fcntl.flock(f.fileno(), fcntl.LOCK_EX if exclusive else fcntl.LOCK_SH)
            state.fd = f
        state.count += 1
        try:
            yield
        finally:
            state.count -= 1
            if state.count == 0 and state.fd is not None:
                with contextlib.suppress(OSError):
                    fcntl.flock(state.fd.fileno(), fcntl.LOCK_UN)
                state.fd.close()
                state.fd = None


# ---------------------------------------------------------------------------
# Index directory layout (reference index.rs:373-528 write side)
# ---------------------------------------------------------------------------


class IndexLayout:
    """Paths inside an index directory, byte-compatible with the reference."""

    def __init__(self, root: PathLike):
        self.root = Path(root)

    # codec artifacts
    @property
    def centroids(self) -> Path:
        return self.root / "centroids.npy"

    @property
    def bucket_cutoffs(self) -> Path:
        return self.root / "bucket_cutoffs.npy"

    @property
    def bucket_weights(self) -> Path:
        return self.root / "bucket_weights.npy"

    @property
    def avg_residual(self) -> Path:
        return self.root / "avg_residual.npy"

    @property
    def cluster_threshold(self) -> Path:
        return self.root / "cluster_threshold.npy"

    @property
    def plan(self) -> Path:
        return self.root / "plan.json"

    @property
    def metadata(self) -> Path:
        return self.root / "metadata.json"

    @property
    def ivf(self) -> Path:
        return self.root / "ivf.npy"

    @property
    def ivf_lengths(self) -> Path:
        return self.root / "ivf_lengths.npy"

    @property
    def config(self) -> Path:
        return self.root / "config.json"

    @property
    def streamed_fingerprint(self) -> Path:
        """Config/corpus fingerprint written next to the streamed-build codec
        artifacts; a resume with a different config or corpus is refused
        instead of silently producing a corrupt index."""
        return self.root / "streamed_fingerprint.json"

    # Optional RQ sidecars (the factored centroid structure, ops/rq.py); the
    # flat centroids.npy remains authoritative and reference-compatible.
    @property
    def rq_coarse(self) -> Path:
        return self.root / "rq_coarse.npy"

    @property
    def rq_fine(self) -> Path:
        return self.root / "rq_fine.npy"

    @property
    def metadata_db(self) -> Path:
        return self.root / "metadata.db"

    @property
    def buffer(self) -> Path:
        return self.root / "buffer.npy"

    @property
    def buffer_lengths(self) -> Path:
        return self.root / "buffer_lengths.json"

    @property
    def embeddings(self) -> Path:
        return self.root / "embeddings.npy"

    @property
    def embeddings_lengths(self) -> Path:
        return self.root / "embeddings_lengths.json"

    @property
    def lock(self) -> Path:
        return self.root / ".nextplaid.lock"

    def chunk_codes(self, i: int) -> Path:
        return self.root / f"{i}.codes.npy"

    def chunk_residuals(self, i: int) -> Path:
        return self.root / f"{i}.residuals.npy"

    def chunk_doclens(self, i: int) -> Path:
        return self.root / f"doclens.{i}.json"

    def chunk_metadata(self, i: int) -> Path:
        return self.root / f"{i}.metadata.json"

    def exists(self) -> bool:
        return self.metadata.exists()

    def num_chunks(self) -> Optional[int]:
        if not self.metadata.exists():
            return None
        return int(load_json(self.metadata)["num_chunks"])
